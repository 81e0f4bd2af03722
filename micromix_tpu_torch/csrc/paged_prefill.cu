// Chunked-prefill attention over the paged int4 or int8 history, then
// in-chunk causal.
//
// Replaces micromix_tpu/serve/prefill_attention.py::paged_prefill_attention
// (_prefill_kernel) for bits = 4 and 8.  q (S, H, D) bf16, post-RoPE, at
// positions [start, start + S); the chunk's own exact bf16 K/V (S, Hkv, D);
// the history of the sequence in the JAX package's token-minor pages:
// codes (P, Hkv, DQ, ps) u8 -- int4: DQ = D/2, dim i in the low nibble and
// dim i + D/2 in the high nibble; int8: DQ = D, a byte a dim -- and sz
// (P, Hkv, 2, ps) bf16 [scale, zero] per token, value (c - zero) * scale.
// One online-softmax recurrence in f32 covers the history positions from
// the window floor up to start, masked to kpos < start (and the window),
// then the chunk causally (and the window); q is scaled by 1/sqrt(D), the
// output divides by max(den, 1e-30).  ``start`` is read from device
// memory: the host never waits for it.
//
// Bound on the H100: operations, 4 S (hist + S/2) H D (15.0 GFLOP at
// S = 512, hist = 1536, H = 32, D = 128: 15.2 us at 989 TFLOP/s in bf16).
//
// Design: Kernel E's tensor-core tile (flash_tile.cuh: mma.sync m16n8k16
// bf16, f32 accumulators, ldmatrix, the online softmax on the accumulator
// registers, P split into bf16 terms) for both phases, with GQA batched
// as Kernel C batches it: one block of 4 warps per (q tile, KV head)
// holds 64 query rows, the G = H / Hkv heads of that KV head times 64 / G
// chunk positions, so each K/V tile it loads serves all G heads.
//
// History: 64 positions a tile (two tiles a 128-token page; a 16-token
// page is a quarter of one), their code rows and [scale, zero] bf16
// pairs copied by cp.async into a 2-stage ring (16 bytes a copy when
// ps % 16 == 0, else 4), then unpacked into dims-major bf16 tiles of
// (c - z): an unpacked page is [D][tokens], K^T row-major, which the tile
// reads with the ldmatrix mode opposite to the keys-major chunk tiles.
// The dequantization is factored so that every tensor-core product stays
// exact: kv_quantize rounds and clips the zero point to an integer in
// [0, 2^bits - 1], so c - z is an integer in [-255, 255], exact in bf16's
// 8 significant bits.  int4 unpacks it as the bf16 difference
// (128 + c) - (128 + z) (one prmt and one bf16x2 subtract per two values;
// exact since 128 + c needs at most 8 bits).  int8 cannot (128 + 255
// needs 9): each code byte becomes the f32 2^23 + c by one prmt, minus
// the f32 2^23 + z, both exact, then a cast to bf16 that is exact too.
// K side: S = Q (C - z)^T with unscaled Q, then score column t times the
// token's scale s_t and 1/sqrt(D) in f32.  V side: s_t folds into p_t
// before the P split, then P' (C - z).  The result differs from the JAX
// kernel's ((c - z) s) only in the order of the f32 sums and where the
// scale's rounding falls.  (The alternative, dequantizing to f32 and
// splitting K and V into bf16 hi + lo, doubles the Q K^T products and
// needs twice the shared memory per tile.)
//
// Chunk: the chunk's bf16 K/V rows through the same 2-stage ring as E,
// keys-major.  Masked scores are -1e30 as in the JAX kernel; history
// tokens at or past start, whose codes and scales may be stale, unpack
// with zero point 0 and scale 0, so they add nothing even to a row whose
// scores are all masked so far (p = 1 there until a real score comes).

#include "flash_tile.cuh"

namespace {

using fa::BK;
using fa::LDT;
constexpr int BQ = 64;           // query rows a block (G heads x 64/G positions)
constexpr int WARPS = BQ / 16;
constexpr int THREADS = WARPS * 32;

constexpr int cmax(int a, int b) { return a > b ? a : b; }

// Shared memory, byte offsets.  Phase 2's K/V ring over the whole buffer;
// phase 1's dims-major K and V tiles, the raw ring (codes, then
// [scale, zero] pairs) and the tile's per-token scales, with the query
// tile after them (in registers before phase 2 overwrites it).  The raw
// ring holds DQ code rows of K and of V a stage: at D = 128 and int8,
// 32 KiB of the 86.5 KiB a block takes (the opt-in limit is 227 KiB).
template <int D, int BITS>
struct Smem {
  static constexpr int LD = fa::Tile<D>::LD;
  static constexpr int DQ = BITS == 4 ? D / 2 : D;
  static constexpr int RING = 4 * BK * LD * 2;      // [2][BK][LD] K, then V
  static constexpr int KT = 0;                      // [D][LDT] bf16 (c - z)
  static constexpr int VT = KT + D * LDT * 2;
  static constexpr int RAW = VT + D * LDT * 2;      // [2][2 DQ][BK] u8: K rows, V rows
  static constexpr int SZ = RAW + 2 * 2 * DQ * BK;  // [2][4][BK] bf16: ks, kz, vs, vz
  static constexpr int SC = SZ + 2 * 4 * BK * 2;    // [2][BK] f32: ks / sqrt(D), vs
  static constexpr int Q = SC + 2 * BK * 4;         // [BQ][LD] bf16
  static constexpr int BYTES = cmax(RING, Q + BQ * LD * 2);
};

// Four code nibbles (bytes of nib, each < 16) of tokens j..j+3 -> bf16
// (c - z) at dst, zz the bf16 pairs (128 + z) of those tokens.
__device__ __forceinline__ void unpack4(__nv_bfloat16* dst, uint32_t nib,
                                       const __nv_bfloat162 (&zz)[2]) {
  const uint32_t p01 = __byte_perm(nib, 0x43u, 0x4140);  // bf16 128 + c0, 128 + c1
  const uint32_t p23 = __byte_perm(nib, 0x43u, 0x4342);
  const __nv_bfloat162 d01 = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&p01), zz[0]);
  const __nv_bfloat162 d23 = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&p23), zz[1]);
  *reinterpret_cast<uint2*>(dst) = make_uint2(fa::bits(d01), fa::bits(d23));
}

// Four int8 codes (bytes of w) of tokens j..j+3 -> bf16 (c - z) at dst, zf
// the f32 2^23 + z of those tokens.  Byte k of w becomes the f32 2^23 + c
// (bits 0x4B0000cc); the difference is an integer of at most 8 bits.
__device__ __forceinline__ void unpack8(__nv_bfloat16* dst, uint32_t w,
                                       const float (&zf)[4]) {
  const float d0 = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540)) - zf[0];
  const float d1 = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7541)) - zf[1];
  const float d2 = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7542)) - zf[2];
  const float d3 = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7543)) - zf[3];
  *reinterpret_cast<uint2*>(dst) = make_uint2(fa::bits(__floats2bfloat162_rn(d0, d1)),
                                              fa::bits(__floats2bfloat162_rn(d2, d3)));
}

template <int D, int BITS>
__global__ void __launch_bounds__(THREADS)
prefill_kernel(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ kch,
               const __nv_bfloat16* __restrict__ vch,
               const uint8_t* __restrict__ kc, const uint8_t* __restrict__ vc,
               const __nv_bfloat16* __restrict__ ksz,
               const __nv_bfloat16* __restrict__ vsz,
               const int* __restrict__ table, const int* __restrict__ start_ptr,
               __nv_bfloat16* __restrict__ out, int S, int H, int Hkv, int ps,
               int window, float scale) {
  using L = Smem<D, BITS>;
  constexpr int LD = L::LD, DQ = L::DQ;
  extern __shared__ __align__(16) uint8_t smem[];
  __nv_bfloat16* KT = reinterpret_cast<__nv_bfloat16*>(smem + L::KT);
  __nv_bfloat16* VT = reinterpret_cast<__nv_bfloat16*>(smem + L::VT);
  float* ksc = reinterpret_cast<float*>(smem + L::SC);
  float* vsc = ksc + BK;
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem + L::Q);

  const int G = H / Hkv, RQ = BQ / G;
  const int kvh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * RQ;  // the most keys first
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int start = *start_ptr;

  // block row r: head kvh * G + r / RQ at chunk position q0 + r % RQ; this
  // thread's rows are warp * 16 + g and + 8
  int lp[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) lp[i] = q0 + (warp * 16 + g + 8 * i) % RQ;

  for (int i = tid; i < BQ * (D / 8); i += THREADS) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    const int pos = q0 + r % RQ;
    const bool ok = pos < S;
    const __nv_bfloat16* src =
        ok ? q + (static_cast<size_t>(pos) * H + kvh * G + r / RQ) * D + c : q;
    ptx::cp_async16(Qs + r * LD + c, src, ok);
  }
  ptx::cp_async_commit();

  // ---------------- phase 1: the quantized history ----------------
  // tile t covers history positions [64 t, 64 t + 64); positions at or
  // past start are not read (zero-filled)
  auto load_hist = [&](int t, int stage) {
    uint8_t* raw = smem + L::RAW + stage * 2 * DQ * BK;
    __nv_bfloat16* sz = reinterpret_cast<__nv_bfloat16*>(smem + L::SZ) + stage * 4 * BK;
    const int t0 = t * BK;
    if (ps % 16 == 0) {  // 16 tokens a copy: column tid % 4, rows tid / 4 + 32 i
      const int c = (tid % 4) * 16, pos = t0 + c;
      const bool ok = pos < start;
      const size_t off =
          ok ? (static_cast<size_t>(table[pos / ps]) * Hkv + kvh) * DQ * ps + pos % ps : 0;
      for (int i = tid / 4; i < DQ; i += THREADS / 4) {
        const size_t o = off + static_cast<size_t>(i) * ps;
        ptx::cp_async16(raw + i * BK + c, kc + o, ok);
        ptx::cp_async16(raw + (DQ + i) * BK + c, vc + o, ok);
      }
    } else {  // 4 tokens a copy: column tid % 16, rows tid / 16 + 8 i
      const int c = (tid % 16) * 4, pos = t0 + c;
      const bool ok = pos < start;
      const size_t off =
          ok ? (static_cast<size_t>(table[pos / ps]) * Hkv + kvh) * DQ * ps + pos % ps : 0;
      for (int i = tid / 16; i < DQ; i += THREADS / 16) {
        const size_t o = off + static_cast<size_t>(i) * ps;
        ptx::cp_async_ca<4>(raw + i * BK + c, kc + o, ok);
        ptx::cp_async_ca<4>(raw + (DQ + i) * BK + c, vc + o, ok);
      }
    }
    if (tid < 64) {  // array a = tid / 16 (ks, kz, vs, vz), 4 tokens a copy
      const int a = tid / 16, c = (tid % 16) * 4, pos = t0 + c;
      const bool ok = pos < start;
      const __nv_bfloat16* base = a < 2 ? ksz : vsz;
      const size_t o =
          ok ? ((static_cast<size_t>(table[pos / ps]) * Hkv + kvh) * 2 + (a & 1)) * ps + pos % ps
             : 0;
      ptx::cp_async_ca<8>(sz + a * BK + c, base + o, ok);
    }
  };

  // raw stage -> KT, VT (c - z) and the per-token scales.  Thread: tokens
  // 4 (tid % 16) .. + 3 of code rows tid / 16 + 8 i.
  auto unpack = [&](int t, int stage) {
    const uint8_t* raw = smem + L::RAW + stage * 2 * DQ * BK;
    const __nv_bfloat16* sz = reinterpret_cast<const __nv_bfloat16*>(smem + L::SZ) + stage * 4 * BK;
    const int t0 = t * BK, c = (tid % 16) * 4;
    if constexpr (BITS == 4) {
      __nv_bfloat162 zk[2], zv[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = c + 2 * h;
        const bool ok0 = t0 + j < start, ok1 = t0 + j + 1 < start;
        zk[h] = __floats2bfloat162_rn(128.0f + (ok0 ? __bfloat162float(sz[BK + j]) : 0.0f),
                                      128.0f + (ok1 ? __bfloat162float(sz[BK + j + 1]) : 0.0f));
        zv[h] = __floats2bfloat162_rn(128.0f + (ok0 ? __bfloat162float(sz[3 * BK + j]) : 0.0f),
                                      128.0f + (ok1 ? __bfloat162float(sz[3 * BK + j + 1]) : 0.0f));
      }
#pragma unroll 4
      for (int i = tid / 16; i < DQ; i += THREADS / 16) {
        const uint32_t wk = *reinterpret_cast<const uint32_t*>(raw + i * BK + c);
        const uint32_t wv = *reinterpret_cast<const uint32_t*>(raw + (DQ + i) * BK + c);
        unpack4(KT + i * LDT + c, wk & 0x0F0F0F0Fu, zk);
        unpack4(KT + (i + DQ) * LDT + c, (wk >> 4) & 0x0F0F0F0Fu, zk);
        unpack4(VT + i * LDT + c, wv & 0x0F0F0F0Fu, zv);
        unpack4(VT + (i + DQ) * LDT + c, (wv >> 4) & 0x0F0F0F0Fu, zv);
      }
    } else {
      float zk[4], zv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = t0 + c + j < start;
        zk[j] = 8388608.0f + (ok ? __bfloat162float(sz[BK + c + j]) : 0.0f);
        zv[j] = 8388608.0f + (ok ? __bfloat162float(sz[3 * BK + c + j]) : 0.0f);
      }
#pragma unroll 4
      for (int i = tid / 16; i < DQ; i += THREADS / 16) {
        unpack8(KT + i * LDT + c, *reinterpret_cast<const uint32_t*>(raw + i * BK + c), zk);
        unpack8(VT + i * LDT + c, *reinterpret_cast<const uint32_t*>(raw + (DQ + i) * BK + c),
                zv);
      }
    }
    if (tid < BK) {
      const bool ok = t0 + tid < start;
      ksc[tid] = ok ? __bfloat162float(sz[tid]) * scale : 0.0f;
      vsc[tid] = ok ? __bfloat162float(sz[2 * BK + tid]) : 0.0f;
    }
  };

  const int h_hi = (start + BK - 1) / BK;
  const int h_lo = window > 0 ? max(start + q0 - window + 1, 0) / BK : 0;
  if (h_lo < h_hi) load_hist(h_lo, 0);
  ptx::cp_async_commit();
  ptx::cp_async_wait<1>();  // the query tile
  __syncthreads();
  uint32_t qf[D / 16][4];
  fa::load_q<D>(Qs, qf);

  fa::Softmax<D> sm;
  sm.init();
  for (int t = h_lo; t < h_hi; ++t) {
    const int st = (t - h_lo) & 1;
    if (t + 1 < h_hi) {  // its stage was last read by unpack(t - 1)
      load_hist(t + 1, st ^ 1);
      ptx::cp_async_commit();
      ptx::cp_async_wait<1>();
    } else {
      ptx::cp_async_wait<0>();
    }
    __syncthreads();  // tile t landed; every warp is done with tile t - 1
    unpack(t, st);
    __syncthreads();

    float s[BK / 8][4];
    fa::scores<D, true>(qf, KT, s);
    const int t0 = t * BK;
    const bool edge = t0 + BK > start || (window > 0 && t0 <= start + q0 + RQ - 1 - window);
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int col = nt * 8 + t4 * 2 + (r & 1);
        float x = s[nt][r] * ksc[col];
        if (edge) {
          const int kpos = t0 + col;
          bool allow = kpos < start;
          if (window > 0) allow = allow && kpos > start + lp[r >> 1] - window;
          if (!allow) x = fa::NEG;
        }
        s[nt][r] = x;
      }
    sm.update(s);
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) s[nt][r] *= vsc[nt * 8 + t4 * 2 + (r & 1)];
    sm.template pv<true>(s, VT);
  }

  // ---------------- phase 2: the chunk, causally ----------------
  __syncthreads();  // phase 1's tiles and the query tile become the ring
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);  // [2][BK][LD]
  __nv_bfloat16* Vs = Ks + 2 * BK * LD;                           // [2][BK][LD]
  const size_t kstride = static_cast<size_t>(Hkv) * D;
  auto load_kv = [&](int jk, int stage) {
    fa::load_rows<D, BK, THREADS>(Ks + stage * BK * LD, kch + kvh * D, kstride, jk * BK, S);
    fa::load_rows<D, BK, THREADS>(Vs + stage * BK * LD, vch + kvh * D, kstride, jk * BK, S);
    ptx::cp_async_commit();
  };
  // the block's positions q0 .. q0 + RQ - 1 lie in one 64-key tile
  const int c_hi = (q0 + RQ - 1) / BK + 1;
  const int c_lo = window > 0 ? max(q0 - window + 1, 0) / BK : 0;
  load_kv(c_lo, 0);
  for (int jk = c_lo; jk < c_hi; ++jk) {
    const int st = (jk - c_lo) & 1;
    if (jk + 1 < c_hi) {
      load_kv(jk + 1, st ^ 1);
      ptx::cp_async_wait<1>();
    } else {
      ptx::cp_async_wait<0>();
    }
    __syncthreads();

    float s[BK / 8][4];
    fa::scores<D>(qf, Ks + st * BK * LD, s);
    const int k0 = jk * BK;
    const bool edge = k0 + BK - 1 > q0 || (window > 0 && k0 <= q0 + RQ - 1 - window);
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float x = s[nt][r] * scale;
        if (edge) {
          const int col = k0 + nt * 8 + t4 * 2 + (r & 1), l = lp[r >> 1];
          bool allow = col <= l;
          if (window > 0) allow = allow && col > l - window;
          if (!allow) x = fa::NEG;
        }
        s[nt][r] = x;
      }
    sm.update(s);
    sm.pv(s, Vs + st * BK * LD);
    __syncthreads();
  }

  sm.finish();
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = warp * 16 + g + half * 8, pos = lp[half];
    if (pos >= S) continue;
    __nv_bfloat16* o = out + (static_cast<size_t>(pos) * H + kvh * G + r / RQ) * D + t4 * 2;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(o + dt * 8) =
          __floats2bfloat162_rn(sm.o[dt][2 * half], sm.o[dt][2 * half + 1]);
  }
}

template <int D, int BITS>
int launch(const void* q, const void* kch, const void* vch, const void* kc,
           const void* vc, const void* ksz, const void* vsz, const void* table,
           const void* start, void* out, int S, int H, int Hkv, int ps,
           int window, float scale, cudaStream_t stream) {
  constexpr int smem = Smem<D, BITS>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(prefill_kernel<D, BITS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rq = BQ / (H / Hkv);
  dim3 grid((S + rq - 1) / rq, Hkv);
  prefill_kernel<D, BITS><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(kch),
      static_cast<const __nv_bfloat16*>(vch), static_cast<const uint8_t*>(kc),
      static_cast<const uint8_t*>(vc), static_cast<const __nv_bfloat16*>(ksz),
      static_cast<const __nv_bfloat16*>(vsz), static_cast<const int*>(table),
      static_cast<const int*>(start), static_cast<__nv_bfloat16*>(out), S, H, Hkv,
      ps, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// table: the sequence's page-table row; start: one device int32.  bits is
// 4 or 8, D 64 or 128, H / Hkv divides 64, ps is a multiple of 4; window
// <= 0: none.  Zero points are integers in [0, 2^bits - 1] (kv_quantize
// rounds them).
extern "C" int paged_prefill(const void* q, const void* kch, const void* vch,
                             const void* kc, const void* vc, const void* ksz,
                             const void* vsz, const void* table,
                             const void* start, void* out, int S, int H,
                             int Hkv, int D, int ps, int window, int bits,
                             float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MM_PREFILL(DD, BB)                                                     \
  if (D == DD && bits == BB)                                                   \
    return launch<DD, BB>(q, kch, vch, kc, vc, ksz, vsz, table, start, out, S, \
                          H, Hkv, ps, window, scale, s);
  MM_PREFILL(128, 4)
  MM_PREFILL(64, 4)
  MM_PREFILL(128, 8)
  MM_PREFILL(64, 8)
#undef MM_PREFILL
  return static_cast<int>(cudaErrorInvalidValue);
}
