// The tensor-core flash-attention tile (FlashAttention-2 style) on
// mma.sync m16n8k16 bf16 with f32 accumulation, templated on a padded
// head width DP (64, 128 or 256): a kernel runs a head dim D <= DP with
// dims [D, DP) of Q, K and V zero in shared memory, so the Q K^T sums are
// exact and P.V's padded columns, never stored, are zero.  Kernel E
// (flash_attention.cu) runs it on bf16 K/V tiles; Kernel H
// (paged_prefill.cu) runs it on the chunk's bf16 K/V and on its int4
// history pages unpacked to dims-major tiles.
//
// A block has WARPS warps; warp w owns query rows [16 w, 16 w + 16) of the
// block's tile.  Shared-memory tiles are bf16, row-major, with 8 elements
// of padding a row: the 16-byte pad puts the eight rows an ldmatrix reads
// in distinct banks.  K and V tiles come in two layouts:
//   keys-major  [BK][LD], LD = D + 8: a row per key (E; H's chunk phase);
//   dims-major  [D][LDT], LDT = BK + 8: a row per dim (H's history pages,
//               whose codes are token-minor); the same fragments come
//               from ldmatrix in the opposite mode.
//
//   load_q    the warp's 16 x D query rows into A fragments (unscaled bf16)
//   scores    S (16 x BK) = Q K^T from a K tile, f32 in registers
//   Softmax   the online max / denominator on those registers (quad
//             shuffles) and O += P V from a V tile
//
// Numerics, held to the JAX kernel's f32 arithmetic: bf16 x bf16 products
// are exact in f32, so S differs from (q * scale) . k in f32 only in the
// order of the sums and in where the scale's one rounding falls.  P is not
// rounded to one bf16 before P.V: it is split into PV_TERMS bf16 terms
// (each the bf16 rounding of what the earlier ones left), each of which
// goes through the tensor cores, so every product stays exact and P keeps
// about 8 PV_TERMS bits; and a tile's P.V is summed in a zeroed
// accumulator and added to O in f32 after the tile, since
// the MMA's own accumulation of small terms into a large O is not
// IEEE-exact.  Measured against float64 on the H100 (PERF.md, fault 3.1;
// scripts/torch_flash_precision.py builds the other choices): with two
// terms summed into O, 0.19-0.27% of E's outputs sat one bf16 step off
// the exact value rounded once; three terms alone cured short rows
// (S = 128-512) but not S = 2048 (0.20%); three terms and the tile
// accumulator give 0.02-0.03% at every length, the f32 kernel's level.

#pragma once

#include "ptx.cuh"

namespace fa {

constexpr int PV_TERMS = 3;      // bf16 terms of P

constexpr int BK = 64;           // keys a tile
constexpr int PAD = 8;           // bf16 elements of row padding
constexpr float NEG = -1e30f;    // score of a masked entry, as the JAX kernel

template <int D>
struct Tile {
  static constexpr int LD = D + PAD;   // keys-major rows
};
constexpr int LDT = BK + PAD;          // dims-major rows

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x, y) -> PV_TERMS bf16 pairs: t[0] = (bf16(x), bf16(y)), each next
// term the bf16 rounding of what the earlier ones left (the remainders
// are exact in f32)
__device__ __forceinline__ void split(float x, float y, uint32_t (&t)[PV_TERMS]) {
#pragma unroll
  for (int i = 0; i < PV_TERMS; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    t[i] = bits(h);
    x -= __low2float(h);
    y -= __high2float(h);
  }
}

// Chunk [c, c + 8) of a row of D bf16 (row: its first element, read only
// when ok) into 16 bytes of shared memory at dst, dims at or past D and
// the whole chunk when !ok zero.  Rows of D % 8 == 0 are 16-byte aligned
// and go by cp.async (the caller commits and waits); any other row is
// read an element at a time and stored at once.
__device__ __forceinline__ void load_chunk(__nv_bfloat16* dst, const __nv_bfloat16* row,
                                           int c, int D, bool ok) {
  if ((D & 7) == 0) {
    const bool in = ok && c < D;
    ptx::cp_async16(dst, in ? row + c : row, in);
    return;
  }
  const uint16_t* r = reinterpret_cast<const uint16_t*>(row);
  uint32_t w[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int lo = c + 2 * e;
    const uint32_t a = ok && lo < D ? r[lo] : 0u, b = ok && lo + 1 < D ? r[lo + 1] : 0u;
    w[e] = a | (b << 16);
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
}

// Copy rows [r0, r0 + ROWS) of a (rows, D) bf16 matrix whose row r starts
// at src + r * stride elements into a [ROWS][LD] tile of width DP >= D,
// rows at or beyond `valid` and dims at or past D zero-filled.
template <int DP, int ROWS, int THREADS>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          size_t stride, int r0, int valid, int D) {
  constexpr int CPR = DP / 8;  // 16-byte chunks a row
  for (int i = threadIdx.x; i < ROWS * CPR; i += THREADS) {
    const int r = i / CPR, c = (i % CPR) * 8;
    const bool ok = r0 + r < valid;
    const __nv_bfloat16* s = ok ? src + static_cast<size_t>(r0 + r) * stride : src;
    load_chunk(dst + r * Tile<DP>::LD + c, s, c, D, ok);
  }
}

// The output pair (x, y) of dims dim, dim + 1 into a row of D bf16 at o
// (dims at or past D are padding and not stored).
__device__ __forceinline__ void store_pair(__nv_bfloat16* o, int dim, int D, float x, float y) {
  if ((D & 1) == 0) {
    if (dim < D)
      *reinterpret_cast<__nv_bfloat162*>(o + dim) = __floats2bfloat162_rn(x, y);
    return;
  }
  if (dim < D) o[dim] = __float2bfloat16_rn(x);
  if (dim + 1 < D) o[dim + 1] = __float2bfloat16_rn(y);
}

// ------------------------------------------------------------------ tile

// The warp's A fragments of its 16 query rows: qf[kk] covers dims
// [16 kk, 16 kk + 16).  Qs is the block's [rows][LD] query tile.
template <int D>
__device__ __forceinline__ void load_q(const __nv_bfloat16* Qs, uint32_t (&qf)[D / 16][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const __nv_bfloat16* p = Qs + (warp * 16 + (lane & 15)) * Tile<D>::LD + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) ptx::ldmatrix_x4(qf[kk], p + kk * 16);
}

// s[nt][r]: row g (r < 2) or g + 8 of the warp's rows, key 8 nt + 2 t4
// (+1 for odd r) of the tile, g = lane / 4, t4 = lane % 4.  K tile
// keys-major [BK][LD] (DIMS_MAJOR false) or dims-major [D][LDT].
template <int D, bool DIMS_MAJOR = false>
__device__ __forceinline__ void scores(const uint32_t (&qf)[D / 16][4],
                                       const __nv_bfloat16* Ks, float (&s)[BK / 8][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) s[nt][r] = 0.0f;
  // ldmatrix x4 over keys [16 np, 16 np + 16) and dims [16 kk, 16 kk + 16):
  // b[0], b[1] the fragment of keys 16 np + 0..7, b[2], b[3] of 8..15.
  // Keys-major: matrix j holds keys 16 np + 8 (j / 2), dims 16 kk + 8 (j % 2);
  // dims-major (.trans): dims 16 kk + 8 (j % 2), keys 16 np + 8 (j / 2).
  const __nv_bfloat16* p =
      DIMS_MAJOR ? Ks + ((lane & 7) + ((lane >> 3) & 1) * 8) * LDT + (lane >> 4) * 8
                 : Ks + ((lane & 7) + ((lane >> 4) << 3)) * Tile<D>::LD + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int np = 0; np < BK / 16; ++np) {
      uint32_t b[4];
      if (DIMS_MAJOR)
        ptx::ldmatrix_x4_trans(b, p + kk * 16 * LDT + np * 16);
      else
        ptx::ldmatrix_x4(b, p + np * 16 * Tile<D>::LD + kk * 16);
      ptx::mma(s[2 * np], qf[kk], b[0], b[1]);
      ptx::mma(s[2 * np + 1], qf[kk], b[2], b[3]);
    }
  }
}

// Online softmax state and output accumulator of the warp's 16 rows
// (this thread's rows g and g + 8: index 0 and 1).
template <int D>
struct Softmax {
  float o[D / 8][4];  // o[dt][r]: dim 8 dt + 2 t4 (+1 odd r), row as s
  float m[2], den[2];  // den: this thread's share of the row sum

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
      for (int r = 0; r < 4; ++r) o[dt][r] = 0.0f;
    m[0] = m[1] = NEG;
    den[0] = den[1] = 0.0f;
  }

  // s: scaled and masked scores of one tile -> probabilities e (in
  // place), with m, den and o rescaled as the JAX kernel's body does.
  __device__ __forceinline__ void update(float (&s)[BK / 8][4]) {
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) mx[r >> 1] = fmaxf(mx[r >> 1], s[nt][r]);
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      corr[i] = expf(m[i] - mx[i]);
      m[i] = mx[i];
    }
    float sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        s[nt][r] = expf(s[nt][r] - m[r >> 1]);
        sum[r >> 1] += s[nt][r];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) den[i] = den[i] * corr[i] + sum[i];
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
      for (int r = 0; r < 4; ++r) o[dt][r] *= corr[r >> 1];
  }

  // o += e . V for one tile, e split into PV_TERMS bf16 terms.  The score
  // accumulators of key tiles 2 kk and 2 kk + 1 are the A fragment of
  // keys [16 kk, 16 kk + 16).  V tile keys-major [BK][LD] (DIMS_MAJOR
  // false, ldmatrix.trans) or dims-major [D][LDT] (ldmatrix).
  template <bool DIMS_MAJOR = false>
  __device__ __forceinline__ void pv(const float (&e)[BK / 8][4], const __nv_bfloat16* Vs) {
    const int lane = threadIdx.x & 31;
    uint32_t a[BK / 16][4][PV_TERMS];  // a[kk][j][term]: A register j
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        split(e[2 * kk + (j >> 1)][(j & 1) * 2], e[2 * kk + (j >> 1)][(j & 1) * 2 + 1],
              a[kk][j]);
    // matrix j: keys-major keys 16 kk + 8 (j % 2), dims 16 dp + 8 (j / 2);
    // dims-major dims 16 dp + 8 (j / 2), keys 16 kk + 8 (j % 2)
    const __nv_bfloat16* p =
        DIMS_MAJOR ? Vs + ((lane & 7) + (lane >> 4) * 8) * LDT + ((lane >> 3) & 1) * 8
                   : Vs + (lane & 15) * Tile<D>::LD + (lane >> 4) * 8;
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      float t[2][4] = {};  // this tile's share of o[2 dp], o[2 dp + 1]
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t b[4];  // dims 16 dp + 0..7: b[0], b[1]; + 8..15: b[2], b[3]
        if (DIMS_MAJOR)
          ptx::ldmatrix_x4(b, p + dp * 16 * LDT + kk * 16);
        else
          ptx::ldmatrix_x4_trans(b, p + kk * 16 * Tile<D>::LD + dp * 16);
#pragma unroll
        for (int i = 0; i < PV_TERMS; ++i) {
          const uint32_t ai[4] = {a[kk][0][i], a[kk][1][i], a[kk][2][i], a[kk][3][i]};
          ptx::mma(t[0], ai, b[0], b[1]);
          ptx::mma(t[1], ai, b[2], b[3]);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        o[2 * dp][r] += t[0][r];
        o[2 * dp + 1][r] += t[1][r];
      }
    }
  }

  // The row sums over the quad; then out = o / max(den, 1e-30).
  __device__ __forceinline__ void finish() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      den[i] += __shfl_xor_sync(0xffffffffu, den[i], 1);
      den[i] += __shfl_xor_sync(0xffffffffu, den[i], 2);
      den[i] = fmaxf(den[i], 1e-30f);
    }
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
      for (int r = 0; r < 4; ++r) o[dt][r] /= den[r >> 1];
  }
};

}  // namespace fa
