// The split-plane GEMM tile shared by Kernels K (sp_gemm.cu) and L
// (sp_stack.cu): one block of 4 or 8 warps computes a BM x BN tile of
// A (M, K) . dq(W)^T over its share of the K steps, in f32, where A is a
// bf16 image in device order (L: the site image; K: its activation codes
// decoded to that image first) and W a split-plane MX weight:
//
//   fp4 segment  (N, k4/2) u8, byte j = device column j (low nibble) and
//                k4/2 + j (high nibble), both with scale block j % nb4
//                (nb4 = k4/32; k4/2 = 16 nb4, so the two columns share it);
//   fp6, fp8     (N, kseg) u8, one code a byte (FP4 codes when fp4_only),
//                device column c with scale block c % nb;
//   scales       UE8M0 bytes (N, kseg/32), value 2^(sf-127), byte 0 -> 0.0.
//
// The K axis runs in steps of 128 device columns: a fp4 step covers 64
// packed bytes, i.e. device columns [b0, b0+64) and [k4/2+b0, k4/2+b0+64),
// then the fp6 and fp8 segments 128 columns at a time.  A segment's width
// is a multiple of 32 (an MX block; a tensor-parallel shard's budgets are
// rounded to 32, not 128), so its last step may be partial: the copies
// past the segment's end (past k4/2 packed bytes in the fp4 plane) are
// zero-filled, in the A tile and in the raw weight tile, and those
// columns add exact zeros to the sums.  Where every width is a multiple
// of 128 no step is partial.
//
// Tile: BM = block_m(M) rows of A (16, 64, or 128 for prefill M, so a
// 256-row chunk decodes each weight tile twice, not four times) by BN
// weight rows (64; 128 beside 128 rows of A, so each A tile copied serves
// twice the outputs).  Pipeline: the A tile (bf16) and the weight's raw
// code bytes of the next STAGES - 1 steps are copied by cp.async into a
// ring while step t decodes its BN x 128 weights once into a bf16 tile and
// the warps run mma.sync m16n8k16 on fragments loaded with ldmatrix.
//
// Decode, exact: a fp4 code's bf16 bits come from a table of eight bf16
// bit patterns with prmt (four codes a lookup) and its sign bit; a fp6 or
// fp8 code's from its f32 decode (exact, at most 4 significant bits).
// The scale is applied two values at a time by a bf16x2 multiply by
// 2^(sf-127) (bits sf << 7, byte 0 -> 0.0): where the result is a bf16
// normal, an exact exponent add; elsewhere (byte 0, zero codes, subnormal
// or overflowing results) one correctly rounded product, equal to the
// f32 product code * 2^(sf-127) rounded to bf16, since that f32 product
// is exact for every scale byte the quantizer emits (1..254).  The
// weight's scale bytes for the block's BN rows are staged in shared
// memory once (BN x K/32 bytes, at most 56 KB at K = 14336); 16
// consecutive ones are one vector load where nb is a multiple of 16 (no
// wrap inside).
//
// K's and L's blocks walk the same steps in the same order and mma shapes,
// so their f32 sums for one output element are the same operations: L's
// output on a site image equals K's on the codes that image encodes.

#pragma once

#include "ptx.cuh"

namespace sp {

constexpr int BK = 128;       // device columns a step
constexpr int PAD = 8;        // bf16 elements of row padding (ldmatrix banks)
constexpr int LD = BK + PAD;

// Tile rows per block: 16 for decode M, 64 up to 64 rows, 128 above (a
// prefill chunk's rows decode each weight tile once per 128).
inline int block_m(int M) { return M <= 16 ? 16 : (M <= 64 ? 64 : 128); }

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// Segment widths in device columns (multiples of 32), and the weight's
// grid (fp4_only: FP4 codes in all three segments).
struct Segs {
  int k4, k6, k8;
  int fp4_only;
  __host__ __device__ int k() const { return k4 + k6 + k8; }
  __host__ __device__ int steps() const { return cdiv(k4, BK) + cdiv(k6, BK) + cdiv(k8, BK); }
  __host__ __device__ int nbt() const { return k() / 32; }
};

// One code and one scale array per segment, rows of width kseg (fp4:
// k4/2 packed bytes) and kseg / 32.
struct Operand {
  const uint8_t* c[3];
  const uint8_t* s[3];
};

// The block's tile, BM x BN: up to 64 rows of A against 64 weight rows,
// 4 warps side by side on 16 columns each; at 128 rows, 128 weight rows
// and 2 x 4 warps of 64 x 32 (so each A tile copied serves twice the
// outputs, and 8 warps hide the latency of a block that has its SM to
// itself).  STAGES: the depth of the copy ring (the copies of the next
// STAGES - 1 steps are in flight while a step computes).
template <int BM>
struct Tile {
  static constexpr int BN = BM == 128 ? 128 : 64;
  static constexpr int WN = 4;                     // warps along N
  static constexpr int WM = BM == 128 ? 2 : 1;     // warps along M
  static constexpr int THREADS = WM * WN * 32;
  static constexpr int MT = BM / WM / 16;          // m16 tiles a warp
  static constexpr int NT = BN / WN / 8;           // n8 tiles a warp
  static constexpr int STAGES = BM == 128 ? 2 : (BM == 16 ? 4 : 3);
};

// Shared memory of the tile: the staged scales (rounded up so the tiles
// after them stay 16-byte aligned), the A ring, the raw weight ring and
// the decoded weight tile.
template <int BM>
inline int tile_smem(const Segs& s) {
  using T = Tile<BM>;
  return (T::BN * s.nbt() + 15) / 16 * 16 +
         T::STAGES * (BM * LD * 2 + T::BN * BK) + T::BN * LD * 2;
}

// Step t: its segment, and c0, the packed byte offset b0 (fp4) or the
// column offset in the segment (fp6, fp8).
struct Step {
  int seg, c0;
};

__device__ __forceinline__ Step step_of(const Segs& s, int t) {
  const int t4 = cdiv(s.k4, BK), t6 = cdiv(s.k6, BK);
  if (t < t4) return {0, t * (BK / 2)};
  if (t < t4 + t6) return {1, (t - t4) * BK};
  return {2, (t - t4 - t6) * BK};
}

// Device column (in its segment) of tile column c of a step.
__device__ __forceinline__ int seg_col(const Segs& s, const Step& st, int c) {
  if (st.seg != 0) return st.c0 + c;
  return c < BK / 2 ? st.c0 + c : s.k4 / 2 + st.c0 + (c - BK / 2);
}

__device__ __forceinline__ int seg_width(const Segs& s, int seg) {
  return seg == 0 ? s.k4 : (seg == 1 ? s.k6 : s.k8);
}

__device__ __forceinline__ int seg_offset(const Segs& s, int seg) {
  return seg == 0 ? 0 : (seg == 1 ? s.k4 : s.k4 + s.k6);
}

// p[seg] by selects: a runtime index into a kernel parameter's array
// would copy the array to local memory.
__device__ __forceinline__ const uint8_t* pick(const uint8_t* const (&p)[3], int seg) {
  return seg == 0 ? p[0] : (seg == 1 ? p[1] : p[2]);
}

// ----------------------------------------------------------------- decode

// numerics.decode: sign | exponent | mantissa, subnormal m * 2^(emin-mant)
template <int EB, int MB, int EMIN>
__device__ __forceinline__ float decode_code(uint32_t c) {
  c &= (1u << (1 + EB + MB)) - 1;
  const uint32_t e = (c >> MB) & ((1u << EB) - 1), m = c & ((1u << MB) - 1);
  const float v =
      e == 0 ? static_cast<float>(m) * __uint_as_float(static_cast<uint32_t>(EMIN - MB + 127) << 23)
             : __uint_as_float((static_cast<uint32_t>(static_cast<int>(e) + EMIN - 1 + 127) << 23) |
                               (m << (23 - MB)));
  return (c >> (EB + MB)) ? -v : v;
}

// bf16 bits of a fp6 (fmt 1, e3m2) or fp8 (fmt 2, e4m3fn) code's value
__device__ __forceinline__ uint32_t wide_bits(uint32_t c, int fmt) {
  const float v = fmt == 1 ? decode_code<3, 2, -2>(c) : decode_code<4, 3, -6>(c);
  return __float_as_uint(v) >> 16;  // exact: at most 4 significant bits
}

// The bf16 bits of the e2m1 magnitudes 0, 0.5, 1, 1.5, 2, 3, 4, 6: low
// bytes in LO_*, high bytes in HI_* (entries 0-3 in *_A, 4-7 in *_B).
constexpr uint32_t FP4_LO_A = 0xC0800000u, FP4_LO_B = 0xC0804000u;
constexpr uint32_t FP4_HI_A = 0x3F3F3F00u, FP4_HI_B = 0x40404040u;

// The fp4 codes in the low nibbles of x's four bytes -> their values as
// two bf16 pairs (bytes 0, 1 and bytes 2, 3), unscaled.
__device__ __forceinline__ void fp4x4(uint32_t x, uint32_t& p01, uint32_t& p23) {
  const uint32_t m = x & 0x07070707u;
  const uint32_t sel = __byte_perm(m | (m >> 4), 0, 0x0020);  // nibbles m0 m1 m2 m3
  const uint32_t lo = __byte_perm(FP4_LO_A, FP4_LO_B, sel);
  const uint32_t hi = __byte_perm(FP4_HI_A, FP4_HI_B, sel) | ((x << 4) & 0x80808080u);
  p01 = __byte_perm(lo, hi, 0x5140);
  p23 = __byte_perm(lo, hi, 0x7362);
}

// The scales of bytes 2j and 2j + 1 of the scale word s as a bf16 pair of
// 2^(sf-127) (bits sf << 7; byte 0 gives 0.0 as the f32 decode does).
__device__ __forceinline__ uint32_t scale_pair(uint32_t s, int j) {
  return __byte_perm(s, 0, j == 0 ? 0x1404 : 0x3424) >> 1;
}

__device__ __forceinline__ uint32_t hmul2(uint32_t a, uint32_t b) {
  __nv_bfloat162 r = __hmul2(*reinterpret_cast<__nv_bfloat162*>(&a),
                             *reinterpret_cast<__nv_bfloat162*>(&b));
  return *reinterpret_cast<uint32_t*>(&r);
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

// 16 codes, one a byte (fmt 0: a fp4 code in the low nibble), times their
// 16 scales -> 8 bf16 pairs, in column order.
__device__ __forceinline__ void decode16(const uint4& c, const uint4& s, int fmt,
                                         uint32_t (&out)[8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t cw = word(c, i), sw = word(s, i);
    uint32_t p01, p23;
    if (fmt == 0) {
      fp4x4(cw, p01, p23);
    } else {
      p01 = wide_bits(cw & 0xFF, fmt) | (wide_bits((cw >> 8) & 0xFF, fmt) << 16);
      p23 = wide_bits((cw >> 16) & 0xFF, fmt) | (wide_bits(cw >> 24, fmt) << 16);
    }
    out[2 * i] = hmul2(p01, scale_pair(sw, 0));
    out[2 * i + 1] = hmul2(p23, scale_pair(sw, 1));
  }
}

// 16 packed fp4 bytes -> their low-nibble columns (lo) and high-nibble
// columns (hi), each times the byte's scale.
__device__ __forceinline__ void decode16_packed(const uint4& c, const uint4& s,
                                                uint32_t (&lo)[8], uint32_t (&hi)[8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t cw = word(c, i), sw = word(s, i);
    const uint32_t s01 = scale_pair(sw, 0), s23 = scale_pair(sw, 1);
    uint32_t p01, p23;
    fp4x4(cw, p01, p23);
    lo[2 * i] = hmul2(p01, s01);
    lo[2 * i + 1] = hmul2(p23, s23);
    fp4x4(cw >> 4, p01, p23);
    hi[2 * i] = hmul2(p01, s01);
    hi[2 * i + 1] = hmul2(p23, s23);
  }
}

// Scale bytes sb, sb + 1, ... (mod nb) of a scale row, 16 of them:
// gather16 byte by byte; scales16 as a 16-byte vector load where
// nb % 16 == 0 (then sb % 16 == 0 and the row is 16-byte aligned, as the
// staged rows are), an 8-byte one twice where nb == 8 (then sb % 8 == 0).
__device__ __forceinline__ uint4 gather16(const uint8_t* row, int sb, int nb) {
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    w[j >> 2] |= static_cast<uint32_t>(row[sb]) << (8 * (j & 3));
    if (++sb == nb) sb = 0;
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ uint4 scales16(const uint8_t* row, int sb, int nb) {
  if (nb % 16 == 0) return *reinterpret_cast<const uint4*>(row + sb);
  if (nb == 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(row);
    return make_uint4(v.x, v.y, v.x, v.y);
  }
  return gather16(row, sb, nb);
}

// Stage the scale bytes of weight rows [n0, n0 + BN) (zero beyond N) in
// shared memory, one (BN, nb) row-major block per segment: fp4's at sw,
// fp6's at sw + BN nb4, fp8's after it.  The tile's rows of a scale array
// are one contiguous run of BN nb bytes (a multiple of 256, 16-byte
// aligned when the array is), copied 16 bytes a thread with every load
// of a round in flight at once.  Ends with __syncthreads().
template <int BN, int THREADS>
__device__ __forceinline__ void stage_scales(uint8_t* sw, const Operand& w,
                                             const Segs& s, int N, int n0) {
  constexpr int U = 4;  // 16-byte chunks a thread keeps in flight
  const int rows = max(0, min(BN, N - n0));
  int off = 0;
  for (int seg = 0; seg < 3; ++seg) {
    const int nb = seg_width(s, seg) / 32;
    const int total = BN * nb, valid = rows * nb;
    const uint8_t* src = pick(w.s, seg) + static_cast<size_t>(n0) * nb;
    for (int base = threadIdx.x * 16; base < total; base += THREADS * 16 * U) {
      uint4 v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = base + u * THREADS * 16;
        v[u] = i + 16 <= valid ? *reinterpret_cast<const uint4*>(src + i)
                               : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = base + u * THREADS * 16;
        if (i + 16 <= valid || i >= total) {
          if (i < total) *reinterpret_cast<uint4*>(sw + off + i) = v[u];
        } else {  // the chunk where the rows end: byte by byte
          for (int j = 0; j < 16; ++j) sw[off + i + j] = i + j < valid ? src[i + j] : 0;
        }
      }
    }
    off += total;
  }
  __syncthreads();
}

// ------------------------------------------------------------- mainloop

// acc[mt][nt][r]: see for_each_pair.  A: the bf16 image (M, K), device
// order.  w's arrays start at row 0 of the weight (N rows); the tile is
// rows [n0, n0 + BN).  smem: the block's dynamic shared memory,
// tile_smem<BM>(s) bytes.  Runs steps [tbeg, tend).
template <int BM>
__device__ __forceinline__ void mainloop(const __nv_bfloat16* __restrict__ A, int M, int m0,
                                         const Operand& w, uint8_t* smem, const Segs& s,
                                         int N, int n0, int tbeg, int tend,
                                         float (&acc)[Tile<BM>::MT][Tile<BM>::NT][4]) {
  using W = Tile<BM>;
  constexpr int THREADS = W::THREADS, BN = W::BN;
  const uint8_t* sw = smem;
  uint8_t* tiles = smem + (BN * s.nbt() + 15) / 16 * 16;
  constexpr int NS = W::STAGES;
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(tiles);    // [NS][BM][LD]
  uint8_t* Wr = tiles + NS * BM * LD * 2;                          // [NS][BN][BK]
  __nv_bfloat16* Ws = reinterpret_cast<__nv_bfloat16*>(Wr + NS * BN * BK);  // [BN][LD]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp / W::WN, wn = warp % W::WN;
  const int K = s.k();
  const int nb4 = s.k4 / 32, nb6 = s.k6 / 32, nb8 = s.k8 / 32;

#pragma unroll
  for (int i = 0; i < W::MT; ++i)
#pragma unroll
    for (int j = 0; j < W::NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.0f;

  // step t's A tile (BM rows x 16 chunks of 8 bf16) and raw weight bytes
  // (fp4: 64 rows x 4 chunks of 16 packed bytes; fp6 / fp8: 64 x 8).  A
  // thread copies the same tile column of every AR-th row, so a step
  // costs one column offset and a pointer step a chunk.
  constexpr int AR = THREADS / (BK / 8);
  const int cp_r = tid / (BK / 8), cp_c = (tid % (BK / 8)) * 8;
  const __nv_bfloat16* cp_src = A + static_cast<size_t>(m0 + cp_r) * K;
  const size_t cp_step = static_cast<size_t>(AR) * K;
  auto load = [&](int t, int slot) {
    const Step st = step_of(s, t);
    // the step's columns in its segment's row (fp4: packed bytes of one
    // plane half) end at `width`; chunks past it are zero-filled
    const int width = st.seg == 0 ? s.k4 / 2 : seg_width(s, st.seg);
    const bool a_in = st.c0 + (st.seg == 0 ? cp_c % (BK / 2) : cp_c) < width;
    const __nv_bfloat16* src = cp_src + seg_offset(s, st.seg) + seg_col(s, st, cp_c);
    __nv_bfloat16* a_dst = As + slot * BM * LD + cp_r * LD + cp_c;
#pragma unroll
    for (int i = 0; i < BM / AR; ++i) {
      const bool ok = a_in && m0 + cp_r + i * AR < M;
      ptx::cp_async16(a_dst + i * AR * LD, ok ? src + i * cp_step : A, ok);
    }
    const int per_row = st.seg == 0 ? 4 : 8;  // 16-byte chunks a weight row
    const int wr = THREADS / per_row;          // rows between a thread's chunks
    const int w_r = tid / per_row, w_c = (tid % per_row) * 16;
    const bool w_in = st.c0 + w_c < width;
    const uint8_t* wsrc = pick(w.c, st.seg);
    const uint8_t* wp = wsrc + static_cast<size_t>(n0 + w_r) * width + st.c0 + w_c;
    uint8_t* w_dst = Wr + slot * BN * BK + w_r * BK + w_c;
    for (int r = 0; r < BN; r += wr) {
      const bool ok = w_in && n0 + w_r + r < N;
      ptx::cp_async16(w_dst + r * BK, ok ? wp + static_cast<size_t>(r) * width : wsrc, ok);
    }
  };

  // step t's raw weight bytes in ring slot `slot` -> Ws (bf16)
  auto decode = [&](int t, int slot) {
    const Step st = step_of(s, t);
    const uint8_t* raw = Wr + slot * BN * BK;
    if (st.seg == 0) {
      for (int i = tid; i < BN * 4; i += THREADS) {
        const int r = i / 4, c = (i % 4) * 16;
        const uint4 codes = *reinterpret_cast<const uint4*>(raw + r * BK + c);
        const uint4 sc = scales16(sw + r * nb4, (st.c0 + c) % nb4, nb4);
        uint32_t lo[8], hi[8];
        decode16_packed(codes, sc, lo, hi);
        uint4* dl = reinterpret_cast<uint4*>(Ws + r * LD + c);
        uint4* dh = reinterpret_cast<uint4*>(Ws + r * LD + BK / 2 + c);
        dl[0] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
        dl[1] = make_uint4(lo[4], lo[5], lo[6], lo[7]);
        dh[0] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
        dh[1] = make_uint4(hi[4], hi[5], hi[6], hi[7]);
      }
    } else {
      const int fmt = s.fp4_only ? 0 : st.seg;
      const int nb = st.seg == 1 ? nb6 : nb8;
      const uint8_t* srows = sw + BN * (st.seg == 1 ? nb4 : nb4 + nb6);
      for (int i = tid; i < BN * 8; i += THREADS) {
        const int r = i / 8, c = (i % 8) * 16;
        const uint4 codes = *reinterpret_cast<const uint4*>(raw + r * BK + c);
        const uint4 sc = scales16(srows + r * nb, (st.c0 + c) % nb, nb);
        uint32_t v[8];
        decode16(codes, sc, fmt, v);
        uint4* d = reinterpret_cast<uint4*>(Ws + r * LD + c);
        d[0] = make_uint4(v[0], v[1], v[2], v[3]);
        d[1] = make_uint4(v[4], v[5], v[6], v[7]);
      }
    }
  };

  // ldmatrix addresses: A rows of the warp's m16 tiles, W rows of its
  // n8 tile pairs (b[0], b[1] the first n8 tile, b[2], b[3] the second)
  const int a_row = wm * (BM / W::WM) + (lane & 15), a_col = (lane >> 4) * 8;
  const int b_row = wn * (BN / W::WN) + (lane & 7) + ((lane >> 4) << 3);
  const int b_col = ((lane >> 3) & 1) * 8;

  // one commit group a step (empty past tend), so that wait<NS - 2>
  // leaves exactly the steps after t in flight
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {
    if (tbeg + i < tend) load(tbeg + i, i);
    ptx::cp_async_commit();
  }
  stage_scales<BN, THREADS>(smem, w, s, N, n0);  // while those copies fly
  for (int t = tbeg; t < tend; ++t) {
    const int slot = (t - tbeg) % NS;
    ptx::cp_async_wait<NS - 2>();
    __syncthreads();  // step t landed; every warp is done with step t - 1
    if (t + NS - 1 < tend) load(t + NS - 1, (slot + NS - 1) % NS);
    ptx::cp_async_commit();
    decode(t, slot);
    __syncthreads();
    const __nv_bfloat16* a_s = As + slot * BM * LD;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t bfrag[W::NT / 2][4];
#pragma unroll
      for (int np = 0; np < W::NT / 2; ++np)
        ptx::ldmatrix_x4(bfrag[np], Ws + (b_row + np * 16) * LD + kk * 16 + b_col);
#pragma unroll
      for (int mt = 0; mt < W::MT; ++mt) {
        uint32_t afrag[4];
        ptx::ldmatrix_x4(afrag, a_s + (a_row + mt * 16) * LD + kk * 16 + a_col);
#pragma unroll
        for (int np = 0; np < W::NT / 2; ++np) {
          ptx::mma(acc[mt][2 * np], afrag, bfrag[np][0], bfrag[np][1]);
          ptx::mma(acc[mt][2 * np + 1], afrag, bfrag[np][2], bfrag[np][3]);
        }
      }
    }
  }
}

// Calls f(m, n, c0, c1) for every accumulator pair of the tile: columns n
// and n + 1 of row m (m0 / n0 added to the tile-relative position).
template <int BM, typename F>
__device__ __forceinline__ void for_each_pair(
    const float (&acc)[Tile<BM>::MT][Tile<BM>::NT][4], int m0, int n0, F f) {
  using W = Tile<BM>;
  constexpr int BN = W::BN;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp / W::WN, wn = warp % W::WN;
#pragma unroll
  for (int mt = 0; mt < W::MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < W::NT; ++nt) {
      const int n = n0 + wn * (BN / W::WN) + nt * 8 + t4 * 2;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = m0 + wm * (BM / W::WM) + mt * 16 + g + half * 8;
        f(m, n, acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]);
      }
    }
  }
}

// Dynamic shared memory above the default 48 KB limit needs the kernel's
// attribute raised once.
template <class Kernel>
inline cudaError_t allow_dynamic_smem(Kernel kernel, int bytes, int& allowed) {
  if (bytes <= allowed) return cudaSuccess;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) allowed = bytes;
  return err;
}

}  // namespace sp
