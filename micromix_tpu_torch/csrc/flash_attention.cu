// Causal prefill flash attention (GQA, optional sliding window).
//
// Replaces micromix_tpu/kernels/flash_attention.py::flash_attention
// (_flash_kernel).  q (B, S, H, D), k/v (B, S, Hkv, D) bf16 -> (B, S, H, D)
// bf16; query head h reads KV head h / (H / Hkv).  Any D up to 256: the
// kernel is instantiated at a padded width DP of 64, 128 or 256 (the
// least that holds D), dims [D, DP) zero in shared memory, as the JAX
// kernel pads D to its 128-lane tile; 1/sqrt(D) of the true D.
//
// Bound on the H100: operations at prefill lengths (about 2 S^2 D H
// multiply-adds under the causal mask against 2 S D (H + 2 Hkv) bytes):
// the bf16 tensor cores, 989 TFLOP/s.
//
// Design: the tensor-core tile of flash_tile.cuh.  One block of 4 warps
// per (64-row query tile, head, batch), the longest rows first; each warp
// holds its 16 query rows as A fragments.  64-key K/V tiles pass through
// a 2-stage cp.async ring in shared memory, tile t + 1's copy in flight
// while tile t computes; S = Q K^T and O += P V run on mma.sync, P split
// into bf16 terms (fa::PV_TERMS; the JAX kernel multiplies f32
// probabilities by f32 V).  The softmax scale multiplies S in f32.  The
// block loops from the window floor (0 without a window) up to the
// diagonal, masking only the tiles that cross the diagonal or the window
// edge.  A ragged S is masked, not padded: rows beyond S load as zero and
// are not stored.  A row of D % 8 != 0 is not 16-byte aligned: its tiles
// load an element at a time (flash_tile.cuh's load_chunk), not by
// cp.async.  At DP = 256 a K/V stage is 33 KB and the block takes 132 KB
// of shared memory.
// Fully masked entries score -1e30 as in the JAX kernel, and the output
// divides by max(den, 1e-30).

#include "flash_tile.cuh"

namespace {

using fa::BK;
constexpr int BQ = 64;
constexpr int WARPS = BQ / 16;
constexpr int THREADS = WARPS * 32;
static_assert(BQ == BK, "the diagonal tile is the block's own index");

template <int DP>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
             int S, int H, int Hkv, int D, int window, float scale) {
  constexpr int LD = fa::Tile<DP>::LD;
  extern __shared__ __align__(16) __nv_bfloat16 smem[];
  __nv_bfloat16* Ks = smem;              // [2][BK][LD]
  __nv_bfloat16* Vs = Ks + 2 * BK * LD;  // [2][BK][LD]
  __nv_bfloat16* Qs = Vs + BK * LD;      // the query tile, in V's stage 1

  const int iq = gridDim.x - 1 - blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / Hkv);
  const int q0 = iq * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const size_t qstride = static_cast<size_t>(H) * D, kstride = static_cast<size_t>(Hkv) * D;
  const __nv_bfloat16* qb = q + (static_cast<size_t>(b) * S * H + h) * D;
  const __nv_bfloat16* kb = k + (static_cast<size_t>(b) * S * Hkv + kvh) * D;
  const __nv_bfloat16* vb = v + (static_cast<size_t>(b) * S * Hkv + kvh) * D;

  const int hi = iq + 1;  // causal: key tiles up to the diagonal
  const int lo = window > 0 ? max((q0 - window + 1) / BK, 0) : 0;

  auto load_kv = [&](int jk, int stage) {
    fa::load_rows<DP, BK, THREADS>(Ks + stage * BK * LD, kb, kstride, jk * BK, S, D);
    fa::load_rows<DP, BK, THREADS>(Vs + stage * BK * LD, vb, kstride, jk * BK, S, D);
    ptx::cp_async_commit();
  };

  // the query tile and the first K/V tile; the query fragments leave
  // shared memory before tile lo + 1 lands in V's stage 1
  fa::load_rows<DP, BQ, THREADS>(Qs, qb, qstride, q0, S, D);
  load_kv(lo, 0);
  ptx::cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[DP / 16][4];
  fa::load_q<DP>(Qs, qf);
  __syncthreads();

  fa::Softmax<DP> sm;
  sm.init();
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  for (int jk = lo; jk < hi; ++jk) {
    const int st = (jk - lo) & 1;
    if (jk + 1 < hi) {
      load_kv(jk + 1, st ^ 1);
      ptx::cp_async_wait<1>();
    } else {
      ptx::cp_async_wait<0>();
    }
    __syncthreads();

    float s[BK / 8][4];
    fa::scores<DP>(qf, Ks + st * BK * LD, s);
    const int k0 = jk * BK;
    const bool edge = k0 + BK - 1 > q0 || (window > 0 && k0 <= q0 + BQ - 1 - window);
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float x = s[nt][r] * scale;
        if (edge) {
          const int row = row0 + (r >> 1) * 8, col = k0 + nt * 8 + t4 * 2 + (r & 1);
          bool allow = col <= row;
          if (window > 0) allow = allow && col > row - window;
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
    const int row = row0 + half * 8;
    if (row >= S) continue;
    __nv_bfloat16* o = out + (static_cast<size_t>(b) * S + row) * qstride + h * D;
#pragma unroll
    for (int dt = 0; dt < DP / 8; ++dt)
      fa::store_pair(o, dt * 8 + t4 * 2, D, sm.o[dt][2 * half], sm.o[dt][2 * half + 1]);
  }
}

template <int DP>
int launch(const void* q, const void* k, const void* v, void* out, int B, int S,
           int H, int Hkv, int D, int window, float scale, cudaStream_t stream) {
  const int smem = 4 * BK * fa::Tile<DP>::LD * static_cast<int>(sizeof(__nv_bfloat16));
  cudaError_t err = cudaFuncSetAttribute(flash_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_kernel<DP><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), S, H, Hkv,
      D, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// window <= 0: no sliding window.  1 <= D <= 256.
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* out,
                               int B, int S, int H, int Hkv, int D, int window,
                               float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D >= 1 && D <= 64) return launch<64>(q, k, v, out, B, S, H, Hkv, D, window, scale, s);
  if (D > 64 && D <= 128) return launch<128>(q, k, v, out, B, S, H, Hkv, D, window, scale, s);
  if (D > 128 && D <= 256) return launch<256>(q, k, v, out, B, S, H, Hkv, D, window, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
