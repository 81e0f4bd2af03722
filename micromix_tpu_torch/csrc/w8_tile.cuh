// The ScaledW8 GEMM tile shared by Kernels B (w8_gemm.cu), F (w8_stack.cu)
// and G (w8_pair.cu): one block of 4 warps computes a BM x 64 tile of
// A (M, K) bf16 . decode(codes (N, K) u8)^T over its share of K, in f32.
//
// Each 128-deep K step loads the A tile and the 64 x 128 code tile into
// registers while the previous step's MMAs run, decodes the codes to exact
// bf16 (bits = (c & 0x7F) << 22 | (c & 0x80) << 24, times 2^(base+126), as
// the TPU kernels do), stores both tiles to shared memory and runs
// mma.sync m16n8k16 bf16 with f32 accumulation.  Rows of A at or beyond M
// and rows of W at or beyond N read as zero.  The kernels differ only in
// where a tile's codes, scale and outputs come from and in the epilogue.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace w8 {

constexpr int BN = 64;
constexpr int BK = 128;
constexpr int PAD = 8;
constexpr int THREADS = 128;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float decode_code(uint32_t c, float scale) {
  const uint32_t bits = ((c & 0x7Fu) << 22) | ((c & 0x80u) << 24);
  return __uint_as_float(bits) * scale;
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc[mt][nt][r]: rows m0 + mt*16 + g (+8 for r >= 2), columns
// n0 + warp*16 + nt*8 + t4*2 (+1 for odd r); see for_each_pair.
template <int BM>
__device__ __forceinline__ void mainloop(const __nv_bfloat16* __restrict__ A,
                                         const uint8_t* __restrict__ W, int M,
                                         int N, int K, int m0, int n0, int kbeg,
                                         int kend, float scale,
                                         float (&acc)[BM / 16][2][4]) {
  constexpr int MT = BM / 16;
  constexpr int A_CHUNKS = BM * BK / 8 / THREADS;   // uint4 = 8 bf16
  constexpr int W_CHUNKS = BN * BK / 16 / THREADS;  // uint4 = 16 codes
  __shared__ __align__(16) __nv_bfloat16 As[BM][BK + PAD];
  __shared__ __align__(16) __nv_bfloat16 Ws[BN][BK + PAD];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;

#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.0f;

  uint4 ra[A_CHUNKS], rw[W_CHUNKS];
  const uint4 zero = make_uint4(0, 0, 0, 0);

  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < A_CHUNKS; ++i) {
      const int idx = tid + i * THREADS;
      const int r = idx / (BK / 8), c = (idx % (BK / 8)) * 8;
      const int m = m0 + r;
      ra[i] = m < M ? *reinterpret_cast<const uint4*>(A + static_cast<size_t>(m) * K + k0 + c)
                    : zero;
    }
#pragma unroll
    for (int i = 0; i < W_CHUNKS; ++i) {
      const int idx = tid + i * THREADS;
      const int r = idx / (BK / 16), c = (idx % (BK / 16)) * 16;
      const int n = n0 + r;
      rw[i] = n < N ? *reinterpret_cast<const uint4*>(W + static_cast<size_t>(n) * K + k0 + c)
                    : zero;
    }
  };

  auto store = [&]() {
#pragma unroll
    for (int i = 0; i < A_CHUNKS; ++i) {
      const int idx = tid + i * THREADS;
      const int r = idx / (BK / 8), c = (idx % (BK / 8)) * 8;
      *reinterpret_cast<uint4*>(&As[r][c]) = ra[i];
    }
#pragma unroll
    for (int i = 0; i < W_CHUNKS; ++i) {
      const int idx = tid + i * THREADS;
      const int r = idx / (BK / 16), c = (idx % (BK / 16)) * 16;
      const uint32_t words[4] = {rw[i].x, rw[i].y, rw[i].z, rw[i].w};
      uint32_t packed[8];
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const uint32_t v = words[w];
        packed[2 * w] = pack_bf16(decode_code(v & 0xFF, scale),
                                  decode_code((v >> 8) & 0xFF, scale));
        packed[2 * w + 1] = pack_bf16(decode_code((v >> 16) & 0xFF, scale),
                                      decode_code(v >> 24, scale));
      }
      *reinterpret_cast<uint4*>(&Ws[r][c]) =
          make_uint4(packed[0], packed[1], packed[2], packed[3]);
      *reinterpret_cast<uint4*>(&Ws[r][c + 8]) =
          make_uint4(packed[4], packed[5], packed[6], packed[7]);
    }
  };

  load(kbeg);
  for (int k0 = kbeg; k0 < kend; k0 += BK) {
    store();
    __syncthreads();
    if (k0 + BK < kend) load(k0 + BK);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const int kc = kk * 16 + t4 * 2;
      uint32_t bfrag[2][2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int nr = warp * 16 + nt * 8 + g;
        bfrag[nt][0] = *reinterpret_cast<const uint32_t*>(&Ws[nr][kc]);
        bfrag[nt][1] = *reinterpret_cast<const uint32_t*>(&Ws[nr][kc + 8]);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int mr = mt * 16 + g;
        uint32_t afrag[4];
        afrag[0] = *reinterpret_cast<const uint32_t*>(&As[mr][kc]);
        afrag[1] = *reinterpret_cast<const uint32_t*>(&As[mr + 8][kc]);
        afrag[2] = *reinterpret_cast<const uint32_t*>(&As[mr][kc + 8]);
        afrag[3] = *reinterpret_cast<const uint32_t*>(&As[mr + 8][kc + 8]);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) mma_bf16(acc[mt][nt], afrag, bfrag[nt]);
      }
    }
    __syncthreads();
  }
}

// Calls f(m, n, c0, c1) for every accumulator pair of the tile: columns n
// and n + 1 of row m (m and n are tile-relative to m0 / n0 as given).
template <int BM, typename F>
__device__ __forceinline__ void for_each_pair(const float (&acc)[BM / 16][2][4],
                                              int m0, int n0, F f) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int mt = 0; mt < BM / 16; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int n = n0 + warp * 16 + nt * 8 + t4 * 2;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = m0 + mt * 16 + g + half * 8;
        f(m, n, acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]);
      }
    }
  }
}

// Tile rows per block: 16 for decode M, 64 above.
inline int block_m(int M) { return M <= 16 ? 16 : 64; }

}  // namespace w8
