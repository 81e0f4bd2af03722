// The 128-row ScaledW8 GEMM tile (Kernel B, w8_gemm.cu, above 64 rows of
// A): one block of 8 warps computes a 128 x 256 tile of
// A (M, K) bf16 . decode(codes (N, K) u8)^T over its share of the K steps,
// in f32.  Beside w8_tile.cuh's 16- and 64-row tile (B at decode M, F, G,
// I), which it does not replace.
//
// Each 64-deep K step: the A tile (bf16, 128 x 64) and the raw code tile
// (u8, 256 x 64, 16 KB) are copied by cp.async into a 4-stage ring; the
// codes are decoded once per block into one of two bf16 tiles.  While the
// 2 x 4 warps (64 x 64 outputs each) run mma.sync m16n8k16 on step t
// (fragments from ldmatrix), they decode step t + 1's codes into the
// other tile and the copies of steps t + 2 and t + 3 are in flight, so the decode's
// integer work overlaps the tensor cores (one block has the SM to itself)
// and a step costs one barrier.  A thread copies the same tile column of
// every 32nd (A) or 64th (codes) row, so a step costs one column offset
// and a pointer step a chunk.  Why 128 x 256 and 64-deep steps: a
// 128 x 128 tile of 64 x 32 warp tiles (128-deep steps) spent 0.19 of its
// 0.29 ms at M=512 N=14336 K=4096 on its copies alone, 3 bytes from L2
// per output and step (scripts/torch_w8_ablation.py, PERF.md); 256 weight
// rows make it 2, 64 x 64 warp tiles halve the ldmatrix traffic per MMA,
// and 64-deep steps let two decoded tiles fit beside the ring.
//
// Decode, exact, two codes a time: the bf16 bits of the unscaled decode
// are (c & 0x7F) << 6 | (c & 0x80) << 8 (the upper half of w8_tile.cuh's
// f32 pattern, whose lower half is zero), and one bf16x2 multiply by the
// scale 2^(base+126) gives the exact product rounded once to bf16, as the
// f32 product rounded to bf16 does.  Each output element sums its 16-deep
// MMAs over K in the order w8_tile.cuh's does, so for the same range of
// K the two tiles give equal bits.

#pragma once

#include "ptx.cuh"

namespace w8w {

constexpr int BM = 128, BN = 256, BK = 64;
constexpr int PAD = 8;                  // bf16 elements of row padding (ldmatrix banks)
constexpr int LD = BK + PAD;
constexpr int WM = 2, WN = 4;           // warps along M and N
constexpr int THREADS = WM * WN * 32;
constexpr int MT = BM / WM / 16;        // m16 tiles a warp
constexpr int NT = BN / WN / 8;         // n8 tiles a warp
constexpr int STAGES = 4;
constexpr int SMEM = STAGES * (BM * LD * 2 + BN * BK) + 2 * BN * LD * 2;

// codes c0, c1 (bits 0-7 and 16-23 of x, the rest zero) -> bf16 pair
__device__ __forceinline__ uint32_t decode2(uint32_t x, __nv_bfloat162 scale2) {
  const uint32_t b = ((x & 0x007F007Fu) << 6) | ((x & 0x00800080u) << 8);
  const __nv_bfloat162 v = __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&b), scale2);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

// acc[mt][nt][r]: see for_each_pair.  smem: SMEM bytes of dynamic shared
// memory.  Runs the 64-deep K steps [tbeg, tend), tbeg < tend.  Rows of A at or
// beyond M and rows of W at or beyond N read as zero.
__device__ __forceinline__ void mainloop(const __nv_bfloat16* __restrict__ A,
                                         const uint8_t* __restrict__ W, int M, int N,
                                         int K, int m0, int n0, int tbeg, int tend,
                                         float scale, uint8_t* smem,
                                         float (&acc)[MT][NT][4]) {
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);            // [STAGES][BM][LD]
  uint8_t* Wr = smem + STAGES * BM * LD * 2;                              // [STAGES][BN][BK]
  __nv_bfloat16* Ws = reinterpret_cast<__nv_bfloat16*>(Wr + STAGES * BN * BK);  // [2][BN][LD]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp / WN, wn = warp % WN;
  const __nv_bfloat162 scale2 = __float2bfloat162_rn(scale);  // a power of two: exact

#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.0f;

  constexpr int AR = THREADS / (BK / 8);   // rows between a thread's A chunks
  constexpr int WR = THREADS / (BK / 16);  // rows between its code chunks
  static_assert(BM % AR == 0 && BN % WR == 0, "whole rounds of copies");
  const int a_r = tid / (BK / 8), a_c = (tid % (BK / 8)) * 8;
  const int w_r = tid / (BK / 16), w_c = (tid % (BK / 16)) * 16;
  const __nv_bfloat16* a_src = A + static_cast<size_t>(m0 + a_r) * K + a_c;
  const uint8_t* w_src = W + static_cast<size_t>(n0 + w_r) * K + w_c;
  const size_t a_step = static_cast<size_t>(AR) * K, w_step = static_cast<size_t>(WR) * K;
  auto load = [&](int t, int slot) {
    const int k0 = t * BK;
    __nv_bfloat16* a_dst = As + slot * BM * LD + a_r * LD + a_c;
#pragma unroll
    for (int i = 0; i < BM / AR; ++i) {
      const bool ok = m0 + a_r + i * AR < M;
      ptx::cp_async16(a_dst + i * AR * LD, ok ? a_src + i * a_step + k0 : A, ok);
    }
    uint8_t* w_dst = Wr + slot * BN * BK + w_r * BK + w_c;
#pragma unroll
    for (int i = 0; i < BN / WR; ++i) {
      const bool ok = n0 + w_r + i * WR < N;
      ptx::cp_async16(w_dst + i * WR * BK, ok ? w_src + i * w_step + k0 : W, ok);
    }
  };

  // chunk j (of DC) of this thread's share of a raw slot -> a Ws tile: 16
  // codes a chunk, BN x BK / 16 chunks a step
  constexpr int DC = BN * (BK / 16) / THREADS;
  auto decode = [&](const uint8_t* raw, __nv_bfloat16* ws, int j) {
    const int i = tid + j * THREADS;
    const int r = i / (BK / 16), c = (i % (BK / 16)) * 16;
    const uint4 codes = *reinterpret_cast<const uint4*>(raw + r * BK + c);
    uint32_t v[8];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t w = word(codes, q);
      v[2 * q] = decode2(__byte_perm(w, 0, 0x4140), scale2);
      v[2 * q + 1] = decode2(__byte_perm(w, 0, 0x4342), scale2);
    }
    uint4* d = reinterpret_cast<uint4*>(ws + r * LD + c);
    d[0] = make_uint4(v[0], v[1], v[2], v[3]);
    d[1] = make_uint4(v[4], v[5], v[6], v[7]);
  };

  // ldmatrix addresses: A rows of the warp's m16 tiles, W rows of its n8
  // tile pairs (b[0], b[1] the first n8 tile, b[2], b[3] the second)
  const int a_row = wm * (BM / WM) + (lane & 15), a_col = (lane >> 4) * 8;
  const int b_row = wn * (BN / WN) + (lane & 7) + ((lane >> 4) << 3);
  const int b_col = ((lane >> 3) & 1) * 8;

  static_assert(BK / 16 % DC == 0, "whole decode chunks a kk");
  // Step t (i = t - tbeg) sits in ring slot i % STAGES and decodes into
  // Ws tile i % 2.  Iteration i: step i + 1 has landed; issue the copies
  // of step i + STAGES - 1 (into the slot of step i - 1, whose MMAs and
  // decode are done); MMAs of step i, interleaved with the decode of step
  // i + 1.  One commit group a step (empty past tend), so that
  // wait<STAGES - 3> leaves exactly the steps after i + 1 in flight.
#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) {
    if (tbeg + j < tend) load(tbeg + j, j);
    ptx::cp_async_commit();
  }
  ptx::cp_async_wait<STAGES - 2>();
  __syncthreads();
#pragma unroll
  for (int j = 0; j < DC; ++j) decode(Wr, Ws, j);
  int slot = 0;
  for (int t = tbeg; t < tend; ++t) {
    const int i = t - tbeg;
    ptx::cp_async_wait<STAGES - 3>();
    __syncthreads();  // step t + 1 landed, step t decoded, step t - 1 done
    const int next = slot == STAGES - 1 ? 0 : slot + 1;
    if (t + STAGES - 1 < tend) load(t + STAGES - 1, slot == 0 ? STAGES - 1 : slot - 1);
    ptx::cp_async_commit();
    const bool more = t + 1 < tend;
    const uint8_t* raw_next = Wr + next * BN * BK;
    __nv_bfloat16* ws_next = Ws + ((i + 1) & 1) * BN * LD;
    const __nv_bfloat16* ws = Ws + (i & 1) * BN * LD;
    const __nv_bfloat16* a_s = As + slot * BM * LD;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      if (more && kk % (BK / 16 / DC) == 0) decode(raw_next, ws_next, kk / (BK / 16 / DC));
      uint32_t bfrag[NT / 2][4];
#pragma unroll
      for (int np = 0; np < NT / 2; ++np)
        ptx::ldmatrix_x4(bfrag[np], ws + (b_row + np * 16) * LD + kk * 16 + b_col);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t afrag[4];
        ptx::ldmatrix_x4(afrag, a_s + (a_row + mt * 16) * LD + kk * 16 + a_col);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          ptx::mma(acc[mt][2 * np], afrag, bfrag[np][0], bfrag[np][1]);
          ptx::mma(acc[mt][2 * np + 1], afrag, bfrag[np][2], bfrag[np][3]);
        }
      }
    }
    slot = next;
  }
}

// Calls f(m, n, c0, c1) for every accumulator pair of the tile: columns n
// and n + 1 of row m (m0 / n0 added to the tile-relative position).
template <typename F>
__device__ __forceinline__ void for_each_pair(const float (&acc)[MT][NT][4], int m0, int n0,
                                              F f) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp / WN, wn = warp % WN;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n = n0 + wn * (BN / WN) + nt * 8 + t4 * 2;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = m0 + wm * (BM / WM) + mt * 16 + g + half * 8;
        f(m, n, acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]);
      }
    }
  }
}

}  // namespace w8w
