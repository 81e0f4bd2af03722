// The decode-row ScaledW8 mainloop of Kernel G (w8_pair.cu): a block of 8
// warps computes, for a strip of ROWS = 32 weight rows, the f32 product
// decode(codes (N, K) u8) . A^T with A (M, K) bf16 at M <= 32 token rows,
// over its share of K.  Beside w8_tile.cuh (Kernels B, F, I, and G above
// the row limit), which it does not replace.
//
// Bound on the H100: bytes.  At M = 8 a code byte meets 8 activations, 16
// operations, against the card's 295 operations a byte; the 8-bit codes
// are the whole stream (o 16.8 MB, 5.0 us; down 58.7 MB, 17.5 us at 3.35
// TB/s).  What the design does about it:
//
// - Weights on the MMA's 16-row side.  mma.sync m16n8k16 takes 16 weight
//   rows as operand A, decoded in registers, and 8 token rows as the n8
//   side (operand B, a token row contiguous in k); M <= 8 is one n8 tile,
//   so no MMA row is empty.  A warp holds two m16 tiles (32 rows) so that
//   each activation fragment serves two MMAs.
// - A permutation of k inside each 64-deep chunk, applied to both
//   operands: thread (g = lane / 4, t4 = lane % 4) takes chunk bytes
//   [16 t4, 16 t4 + 16) of its rows, byte 4 j + q feeding MMA j (j < 4) at
//   k slot 2 t4 + q (q < 2) or 2 t4 + 6 + q (q >= 2), and the 16
//   activations at the same chunk columns of its token rows.  So a thread
//   loads 16 contiguous code bytes a row and 32 contiguous activation
//   bytes a token, and every fragment is whole words of what it loaded.
// - No shared memory in the mainloop: each thread loads its own operands
//   with 16-byte global loads into a ring of registers, 6 chunks deep at
//   M <= 8 (five, 320 code bytes a thread, 80 KB a block, in flight while
//   one is decoded and multiplied), 4 above.  The codes are read once,
//   so their loads carry the streaming hint (evict first: in the L2 they
//   give way before the activations and whatever else the step keeps
//   there) and ask the L2 for 256 bytes, four warps' chunks of a row.  A
//   ring of cp.async copies into shared memory, per thread or line-wide
//   per warp, took 1.5-2.1x as long at any depth (PERF.md).
// - Decode in registers straight into the operands, two codes for three
//   integer operations and one bf16x2 multiply: prmt
//   places code c in bits 0-7 of a 16-bit half and its sign, replicated,
//   in bits 8-15; << 6 and a mask leave (c & 0x80) << 8 | (c & 0x7F) << 6,
//   the upper half of w8_tile.cuh's f32 pattern (whose lower half is
//   zero); the multiply by the scale 2^(base+126) rounds the exact product
//   once to bf16, as w8_tile.cuh's f32 product rounded to bf16 does (the
//   same bits for every code and base, as w8_tile128.cuh's decode).
// - The warps of a block split K (warp w takes chunks w, w + 8, ...), and
//   the block sums their f32 results in warp order in shared memory at
//   the end: a 32-row strip streams its whole K in one block, and N = 4096
//   is 128 blocks, one wave on 132 SMs, with no K split.

#pragma once

#include "ptx.cuh"

namespace w8r {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int CK = 64;            // k a chunk: four 16-deep MMAs
constexpr int MT = 2;             // m16 tiles of weight rows a warp
constexpr int ROWS = 16 * MT;     // weight rows a block
constexpr int MAX_NT = 4;         // n8 tiles of token rows: M <= 32

// chunks a thread holds in registers: 6 at M <= 8, 4 above (registers)
template <int NT>
__host__ __device__ constexpr int stages() { return NT == 1 ? 6 : 4; }

// the two codes of bytes (lo, hi) of w (prmt selector: byte b as 0-7 and
// its sign as 8-15 of each half) -> their bf16 pair times the scale
template <uint32_t SEL>
__device__ __forceinline__ uint32_t decode2(uint32_t w, __nv_bfloat162 scale2) {
  uint32_t x;
  asm("prmt.b32 %0, %1, 0, %2;\n" : "=r"(x) : "r"(w), "n"(SEL));
  x = (x << 6) & 0x9FC09FC0u;
  const __nv_bfloat162 v = __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&x), scale2);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 16 code bytes, read once: the streaming hint (evict first) and a
// 256-byte L2 fetch (the four 64-byte chunks that warps w .. w + 3 read)
__device__ __forceinline__ uint4 load_codes(const uint8_t* p) {
  uint4 v;
  asm("ld.global.cs.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

// acc[mt][nt][r]: weight row n0 + mt * 16 + g (+ 8 for r >= 2), token
// nt * 8 + 2 t4 (+ 1 for odd r), summed over this warp's chunks of
// [cbeg, cend).  Rows of W at or beyond N and token rows at or beyond M
// read as zero.
template <int NT>
__device__ __forceinline__ void mainloop(const __nv_bfloat16* __restrict__ A,
                                         const uint8_t* __restrict__ W, int M, int N,
                                         int K, int n0, int cbeg, int cend, float scale,
                                         float (&acc)[MT][NT][4]) {
  constexpr int STAGES = stages<NT>();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const __nv_bfloat162 scale2 = __float2bfloat162_rn(scale);  // a power of two: exact
  const uint4 zero = make_uint4(0, 0, 0, 0);

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mt][nt][r] = 0.0f;

  // this thread's operands at chunk 0: weight rows n0 + 8 s + g (s < 2
  // MT), token rows 8 nt + g (two 16-byte halves each)
  const uint8_t* wsrc[2 * MT];
  bool wok[2 * MT];
#pragma unroll
  for (int s = 0; s < 2 * MT; ++s) {
    const int n = n0 + 8 * s + g;
    wok[s] = n < N;
    wsrc[s] = W + static_cast<size_t>(wok[s] ? n : 0) * K + 16 * t4;
  }
  const __nv_bfloat16* asrc[NT];
  bool aok[NT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int m = 8 * nt + g;
    aok[nt] = m < M;
    asrc[nt] = A + static_cast<size_t>(aok[nt] ? m : 0) * K + 16 * t4;
  }

  uint4 cw[STAGES][2 * MT], av[STAGES][2 * NT];
  auto load = [&](int st, int c) {   // st: a compile-time stage after unrolling
    const int k0 = c * CK;
#pragma unroll
    for (int s = 0; s < 2 * MT; ++s)
      cw[st][s] = wok[s] ? load_codes(wsrc[s] + k0) : zero;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int q = 0; q < 2; ++q)
        av[st][2 * nt + q] =
            aok[nt] ? __ldg(reinterpret_cast<const uint4*>(asrc[nt] + k0 + 8 * q)) : zero;
  };

  // this warp's chunks: cbeg + warp + i * WARPS, i < count; chunk i in
  // register stage i % STAGES, reloaded with chunk i + STAGES once used
  const int first = cbeg + warp;
  const int count = first < cend ? (cend - first + WARPS - 1) / WARPS : 0;
#pragma unroll
  for (int st = 0; st < STAGES; ++st)
    if (st < count) load(st, first + st * WARPS);
  for (int i0 = 0; i0 < count; i0 += STAGES) {
#pragma unroll
    for (int st = 0; st < STAGES; ++st) {
      const int i = i0 + st;
      if (i >= count) break;
#pragma unroll
      for (int j = 0; j < CK / 16; ++j) {
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const uint32_t lo = word(cw[st][2 * mt], j), hi = word(cw[st][2 * mt + 1], j);
          a[mt][0] = decode2<0x9180>(lo, scale2);   // row g, k slots 2 t4, +1
          a[mt][1] = decode2<0x9180>(hi, scale2);   // row g + 8
          a[mt][2] = decode2<0xB3A2>(lo, scale2);   // row g, k slots 2 t4 + 8, +9
          a[mt][3] = decode2<0xB3A2>(hi, scale2);   // row g + 8
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const uint4& v = av[st][2 * nt + j / 2];
          const uint32_t b0 = word(v, 2 * (j % 2)), b1 = word(v, 2 * (j % 2) + 1);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) ptx::mma(acc[mt][nt], a[mt], b0, b1);
        }
      }
      if (i + STAGES < count) load(st, first + (i + STAGES) * WARPS);
    }
  }
}

// The block's sums: every warp's acc into shared memory, then out(n, m,
// value) for each (weight row n, token m) of the strip with m < M and
// n < N, the warps' partial sums added in warp order.  Consecutive
// threads take consecutive weight rows.
template <int NT, typename F>
__device__ __forceinline__ void block_sums(const float (&acc)[MT][NT][4], int M, int N,
                                           int n0, F out) {
  constexpr int TOK = 8 * NT;
  __shared__ float red[WARPS * TOK * ROWS];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = mt * 16 + g + 8 * (r >> 1), tok = nt * 8 + 2 * t4 + (r & 1);
        red[(warp * TOK + tok) * ROWS + row] = acc[mt][nt][r];
      }
  __syncthreads();
  for (int e = tid; e < TOK * ROWS; e += THREADS) {
    const int row = e % ROWS, tok = e / ROWS;
    if (tok >= M || n0 + row >= N) continue;
    float s = red[e];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) s += red[w * TOK * ROWS + e];
    out(n0 + row, tok, s);
  }
}

}  // namespace w8r
