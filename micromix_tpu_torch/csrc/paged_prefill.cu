// Chunked-prefill attention over the paged int4 history, then in-chunk causal.
//
// Replaces micromix_tpu/serve/prefill_attention.py::paged_prefill_attention
// (_prefill_kernel) for bits = 4.  q (S, H, D) bf16, post-RoPE, at
// positions [start, start + S); the chunk's own exact bf16 K/V (S, Hkv, D);
// the history of the sequence in the JAX package's token-minor pages:
// codes (P, Hkv, D/2, ps) u8, dim i in the low nibble and dim i + D/2 in
// the high nibble, sz (P, Hkv, 2, ps) bf16 [scale, zero] per token, value
// (q - zero) * scale.  One online-softmax recurrence in f32 covers the
// history pages from the window floor to ceil(start / ps), masked to
// kpos < start (and the window), then the chunk causally (and the window);
// q is scaled by 1/sqrt(D), the output divides by max(den, 1e-30).
// ``start`` is read from device memory: the host never waits for it.
//
// Bound on the H100: operations, 4 S (hist + S/2) H D (15.0 GFLOP at
// S = 512, hist = 1536, H = 32, D = 128: 15.2 us at 989 TFLOP/s in bf16).
// Like Kernel E this first kernel does its math on the CUDA cores in f32,
// as the TPU kernel casts its operands, so it runs far below that bound;
// tensor cores are later work.
//
// Design: Kernel E's tile walk, with GQA batched as Kernel C batches it.
// One block of 128 threads per (q tile, KV head) holds 64 query rows: the
// G = H / Hkv heads of that KV head times 64 / G chunk positions, so each
// K/V tile it loads serves all G heads.  History tiles are a page's
// tokens, up to 64 at a time: their int4 codes are staged in shared
// memory as 32-bit words (coalesced reads of the token-minor rows), then
// dequantized with each token's scale and zero into the same f32 K
// (transposed) and V tiles the in-chunk phase fills from the bf16 chunk.
// Each thread scores a 4 x 8 patch; the 8 threads of a row group share the
// online max and denominator through warp shuffles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per block (G heads x 64/G positions)
constexpr int BK = 64;        // tokens per K/V tile
constexpr int RS = BK + 4;    // staged code row stride in bytes (conflict-free)
constexpr int THREADS = 128;
constexpr float NEG = -1e30f;

template <int D>
constexpr int smem_bytes() {
  return (D * BQ + D * BK + BK * D + BK * BQ) * 4 + 2 * (D / 2) * RS + 4 * BK * 4;
}

template <int D>
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
  constexpr int DT = D / 8;   // output dims per thread
  constexpr int DQ = D / 2;   // code rows per page and head
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;               // [D][BQ]
  float* Kt = Qt + D * BQ;        // [D][BK]
  float* Vs = Kt + D * BK;        // [BK][D]
  float* Pt = Vs + BK * D;        // [BK][BQ]
  uint8_t* raw = reinterpret_cast<uint8_t*>(Pt + BK * BQ);   // [2][DQ][RS]
  float* tsz = reinterpret_cast<float*>(raw + 2 * DQ * RS);  // [4][BK]

  const int G = H / Hkv, RQ = BQ / G;
  const int kvh = blockIdx.y;
  const int q0 = blockIdx.x * RQ;       // first chunk position of the block
  const int tid = threadIdx.x, rg = tid / 8, cg = tid % 8;
  const int start = *start_ptr;

  // row r holds head kvh * G + r / RQ at chunk position q0 + r % RQ
  for (int idx = tid; idx < BQ * (D / 8); idx += THREADS) {
    const int r = idx % BQ, c8 = (idx / BQ) * 8;
    const int pos = q0 + r % RQ, h = kvh * G + r / RQ;
    uint4 rq = make_uint4(0, 0, 0, 0);
    if (pos < S)
      rq = *reinterpret_cast<const uint4*>(q + (static_cast<size_t>(pos) * H + h) * D + c8);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&rq);
#pragma unroll
    for (int i = 0; i < 8; ++i) Qt[(c8 + i) * BQ + r] = __bfloat162float(e[i]) * scale;
  }

  int lp[4];                      // chunk-local position of each of my rows
#pragma unroll
  for (int i = 0; i < 4; ++i) lp[i] = q0 + (rg * 4 + i) % RQ;

  float m[4], den[4], acc[4][DT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    den[i] = 0.0f;
#pragma unroll
    for (int d = 0; d < DT; ++d) acc[i][d] = 0.0f;
  }

  // One tile of the recurrence over the K/V now in Kt / Vs.  hist: columns
  // are history positions kbase + j (j < ntok); else chunk positions.
  auto attend = [&](bool hist, int kbase, int ntok) {
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.0f;
    for (int d = 0; d < D; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(&Qt[d * BQ + rg * 4]);
      const float4 k0v = *reinterpret_cast<const float4*>(&Kt[d * BK + cg * 8]);
      const float4 k1v = *reinterpret_cast<const float4*>(&Kt[d * BK + cg * 8 + 4]);
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
      const float ka[8] = {k0v.x, k0v.y, k0v.z, k0v.w, k1v.x, k1v.y, k1v.z, k1v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] += qa[i] * ka[j];
    }

    float corr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int jj = cg * 8 + j;
        const int kpos = kbase + jj;
        bool allow;
        if (hist) {
          allow = jj < ntok && kpos < start;
          if (window > 0) allow = allow && kpos > start + lp[i] - window;
        } else {
          allow = kpos <= lp[i] && kpos < S;
          if (window > 0) allow = allow && kpos > lp[i] - window;
        }
        if (!allow) s[i][j] = NEG;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      corr[i] = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float e = expf(s[i][j] - m_new);
        Pt[(cg * 8 + j) * BQ + rg * 4 + i] = e;
        sum += e;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      den[i] = den[i] * corr[i] + sum;
      m[i] = m_new;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int d = 0; d < DT; ++d) acc[i][d] *= corr[i];
    for (int c = 0; c < BK; ++c) {
      const float4 pv = *reinterpret_cast<const float4*>(&Pt[c * BQ + rg * 4]);
      const float pa[4] = {pv.x, pv.y, pv.z, pv.w};
      float va[DT];
#pragma unroll
      for (int d = 0; d < DT; d += 4) {
        const float4 t = *reinterpret_cast<const float4*>(&Vs[c * D + cg * DT + d]);
        va[d] = t.x; va[d + 1] = t.y; va[d + 2] = t.z; va[d + 3] = t.w;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int d = 0; d < DT; ++d) acc[i][d] += pa[i] * va[d];
    }
  };

  // ---------------- phase 1: the quantized history pages ----------------
  const int hp = (start + ps - 1) / ps;
  const int p0 = window > 0 ? max((start + q0 - window + 1) / ps, 0) : 0;
  const int tile = ps < BK ? ps : BK;
  for (int p = p0; p < hp; ++p) {
    const size_t page = static_cast<size_t>(table[p]) * Hkv + kvh;
    for (int off0 = 0; off0 < ps && p * ps + off0 < start; off0 += tile) {
      const int ntok = min(tile, ps - off0);
      const int nw = ntok / 4;
      __syncthreads();              // the previous tile is fully consumed
      const uint8_t* kp = kc + page * DQ * ps + off0;
      const uint8_t* vp = vc + page * DQ * ps + off0;
      for (int w = tid; w < DQ * nw; w += THREADS) {
        const int i = w / nw, jw = w % nw;
        *reinterpret_cast<uint32_t*>(&raw[i * RS + 4 * jw]) =
            *reinterpret_cast<const uint32_t*>(kp + static_cast<size_t>(i) * ps + 4 * jw);
        *reinterpret_cast<uint32_t*>(&raw[(DQ + i) * RS + 4 * jw]) =
            *reinterpret_cast<const uint32_t*>(vp + static_cast<size_t>(i) * ps + 4 * jw);
      }
      for (int j = tid; j < ntok; j += THREADS) {
        const size_t o = page * 2 * ps + off0 + j;
        tsz[j] = __bfloat162float(ksz[o]);
        tsz[BK + j] = __bfloat162float(ksz[o + ps]);
        tsz[2 * BK + j] = __bfloat162float(vsz[o]);
        tsz[3 * BK + j] = __bfloat162float(vsz[o + ps]);
      }
      __syncthreads();
      // K transposed (token-fast), V row-major (dim-fast)
      for (int idx = tid; idx < DQ * BK; idx += THREADS) {
        const int i = idx / BK, j = idx % BK;
        float lo = 0.0f, hi = 0.0f;
        if (j < ntok) {
          const uint32_t c = raw[i * RS + j];
          lo = (static_cast<float>(c & 0xF) - tsz[BK + j]) * tsz[j];
          hi = (static_cast<float>(c >> 4) - tsz[BK + j]) * tsz[j];
        }
        Kt[i * BK + j] = lo;
        Kt[(i + DQ) * BK + j] = hi;
      }
      for (int idx = tid; idx < DQ * BK; idx += THREADS) {
        const int i = idx % DQ, j = idx / DQ;
        float lo = 0.0f, hi = 0.0f;
        if (j < ntok) {
          const uint32_t c = raw[(DQ + i) * RS + j];
          lo = (static_cast<float>(c & 0xF) - tsz[3 * BK + j]) * tsz[2 * BK + j];
          hi = (static_cast<float>(c >> 4) - tsz[3 * BK + j]) * tsz[2 * BK + j];
        }
        Vs[j * D + i] = lo;
        Vs[j * D + i + DQ] = hi;
      }
      __syncthreads();
      attend(true, p * ps + off0, ntok);
    }
  }

  // ---------------- phase 2: the chunk, causally ----------------
  const int hi_t = (q0 + RQ - 1) / BK + 1;
  const int lo_t = window > 0 ? max((q0 - window + 1) / BK, 0) : 0;
  for (int jk = lo_t; jk < hi_t; ++jk) {
    const int k0 = jk * BK;
    __syncthreads();
    for (int idx = tid; idx < BK * (D / 8); idx += THREADS) {
      const int r = idx % BK, c8 = (idx / BK) * 8;
      const int col = k0 + r;
      uint4 kr = make_uint4(0, 0, 0, 0);
      if (col < S)
        kr = *reinterpret_cast<const uint4*>(kch + (static_cast<size_t>(col) * Hkv + kvh) * D + c8);
      const __nv_bfloat16* ke = reinterpret_cast<const __nv_bfloat16*>(&kr);
#pragma unroll
      for (int i = 0; i < 8; ++i) Kt[(c8 + i) * BK + r] = __bfloat162float(ke[i]);
    }
    for (int idx = tid; idx < BK * (D / 8); idx += THREADS) {
      const int r = idx / (D / 8), c8 = (idx % (D / 8)) * 8;
      const int col = k0 + r;
      uint4 vr = make_uint4(0, 0, 0, 0);
      if (col < S)
        vr = *reinterpret_cast<const uint4*>(vch + (static_cast<size_t>(col) * Hkv + kvh) * D + c8);
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vr);
#pragma unroll
      for (int i = 0; i < 8; ++i) Vs[r * D + c8 + i] = __bfloat162float(ve[i]);
    }
    __syncthreads();
    attend(false, k0, BK);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = rg * 4 + i;
    if (lp[i] >= S) continue;
    const int h = kvh * G + row / RQ;
    __nv_bfloat16* o = out + (static_cast<size_t>(lp[i]) * H + h) * D + cg * DT;
#pragma unroll
    for (int d = 0; d < DT; ++d) o[d] = __float2bfloat16_rn(acc[i][d] / fmaxf(den[i], 1e-30f));
  }
}

template <int D>
int launch(const void* q, const void* kch, const void* vch, const void* kc,
           const void* vc, const void* ksz, const void* vsz, const void* table,
           const void* start, void* out, int S, int H, int Hkv, int ps,
           int window, float scale, cudaStream_t stream) {
  constexpr int smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(prefill_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rq = BQ / (H / Hkv);
  dim3 grid((S + rq - 1) / rq, Hkv);
  prefill_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(kch),
      static_cast<const __nv_bfloat16*>(vch), static_cast<const uint8_t*>(kc),
      static_cast<const uint8_t*>(vc), static_cast<const __nv_bfloat16*>(ksz),
      static_cast<const __nv_bfloat16*>(vsz), static_cast<const int*>(table),
      static_cast<const int*>(start), static_cast<__nv_bfloat16*>(out), S, H, Hkv,
      ps, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// table: the sequence's page-table row; start: one device int32.  D is 64
// or 128, H / Hkv divides 64, ps is a multiple of 4; window <= 0: none.
extern "C" int paged_prefill(const void* q, const void* kch, const void* vch,
                             const void* kc, const void* vc, const void* ksz,
                             const void* vsz, const void* table,
                             const void* start, void* out, int S, int H,
                             int Hkv, int D, int ps, int window, float scale,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return launch<128>(q, kch, vch, kc, vc, ksz, vsz, table, start, out, S, H,
                       Hkv, ps, window, scale, s);
  if (D == 64)
    return launch<64>(q, kch, vch, kc, vc, ksz, vsz, table, start, out, S, H,
                      Hkv, ps, window, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
