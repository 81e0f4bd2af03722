// Activation-site fakequant: producer + per-32-block UE8M0 + RNE grid round.
//
// Replaces micromix_tpu/kernels/fakequant.py::fakequant_site_pallas
// (_site_kernel) and the site half of
// micromix_tpu/kernels/mixed_matmul.py::mixed_matmul_w8_site
// (_w8_site_kernel): x (M, K) bf16 -> the bf16 grid image (M, K) in the
// block-interleaved device layout that the ScaledW8 GEMM consumes.  Block
// j of a segment with nb blocks is columns off + j + i*nb, i = 0..31.
//
// Bound on the H100: bytes.  It reads x (and up, or gamma) once and writes
// the image once, 2 + 2 (+ 2 for silu) bytes an element; the producer and
// the block rounding cost some 30-60 operations an element (a silu's
// expf and division the most), so at a few hundred MB a site the
// operations come within a factor of two of the bytes.  At decode rows a
// site is tens of KB and latency bounds it.
//
// Design: grid (M, S), each block of 128 threads takes 32-blocks [b0, b1)
// of its row's K / 32, four threads a 32-block: a warp holds 8
// neighbouring blocks, lane jb + 8 sub members sub + 4 r (r < 8) of block
// jb, so for each r a warp touches four runs of 8 neighbouring columns
// (one 16-byte run, in distinct banks, per sub), and the block max takes
// two shuffles.  The wrapper picks S from M and K alone: from 264 rows
// whole rows (S = 1), below that the row split into blocks of at most 32
// 32-blocks (one pass of the block) over about 264 / M blocks, at least 4
// 32-blocks each (M = 8: 256 blocks for the H100's 132 SMs).  A whole row,
// or a split row whose site gathers (perm) or needs the row moment (rms),
// is staged in shared memory by 16-byte cp.async copies (x, and gamma f32
// for rms or, for whole rows, up for silu), and the gather reads shared
// memory; a split row otherwise reads its members from global memory.  A
// whole row's image goes back through shared memory (in place when there
// is no perm) to 16-byte stores of the row; a split row's threads store
// directly.  The producer is a template parameter, so a thread's 8 loads
// issue together.
// Every block of an rms row computes the row moment from its staged row in
// mx::row_rvar's one fixed order, so all get the same rvar bit for bit,
// and Kernel J (mx_quantize.cu, the same header) too.  With perm_rows > 0,
// row r reads permutation r / perm_rows of a (G, K) array (the MoE experts'
// own sites, all experts' rows in one launch).  The producer and the block
// arithmetic live in mx_site.cuh: the UE8M0 exponent from the f32 bits,
// rintf, IEEE division and sqrtf; built without fast-math, so the plain
// site is bit-exact with the JAX package's.

#include "mx_site.cuh"
#include "ptx.cuh"

namespace {

constexpr int THREADS = 128;

// stage n16 16-byte chunks of src into dst
__device__ __forceinline__ void stage(void* dst, const void* src, int n16) {
  for (int c = threadIdx.x; c < n16; c += THREADS)
    ptx::cp_async16(static_cast<uint8_t*>(dst) + c * 16,
                    static_cast<const uint8_t*>(src) + static_cast<size_t>(c) * 16, true);
}

template <int P, bool WHOLE>
__global__ void __launch_bounds__(THREADS)
site_kernel(const __nv_bfloat16* __restrict__ x, const void* __restrict__ aux,
            const int* __restrict__ perm, __nv_bfloat16* __restrict__ out, int K, int k4,
            int k6, int k8, int perm_rows, float eps, int bpc) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int row = blockIdx.x;
  const int nbk = K / 32;
  const int b0 = blockIdx.y * bpc;
  const int b1 = min(b0 + bpc, nbk);
  const __nv_bfloat16* xr = x + static_cast<size_t>(row) * K;
  const float* gamma = P == 1 ? static_cast<const float*>(aux) : nullptr;
  const __nv_bfloat16* up =
      P == 2 ? static_cast<const __nv_bfloat16*>(aux) + static_cast<size_t>(row) * K : nullptr;
  if (perm != nullptr && perm_rows > 0) perm += static_cast<size_t>(row / perm_rows) * K;
  __nv_bfloat16* orow = out + static_cast<size_t>(row) * K;

  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  uint8_t* free_s = smem + static_cast<size_t>(K) * 2;
  if (WHOLE || P == 1 || perm != nullptr) {
    stage(xs, xr, K / 8);
    xr = xs;
    if (P == 1) {
      stage(free_s, gamma, K / 4);
      gamma = reinterpret_cast<const float*>(free_s);
      free_s += static_cast<size_t>(K) * 4;
    } else if (P == 2 && WHOLE) {
      stage(free_s, up, K / 8);
      up = reinterpret_cast<const __nv_bfloat16*>(free_s);
      free_s += static_cast<size_t>(K) * 2;
    }
    ptx::cp_async_commit();
    ptx::cp_async_wait<0>();
    __syncthreads();
  }
  mx::SiteRow site{xr, gamma, up, perm, P, 0.0f};
  if (P == 1) site.rvar = mx::row_rvar(xr, K, eps);

  // a whole row's image goes to shared memory first: in place when no
  // other column reads x
  __nv_bfloat16* dst = orow;
  if (WHOLE) dst = perm != nullptr ? reinterpret_cast<__nv_bfloat16*>(free_s) : xs;
  // a warp takes 8 neighbouring 32-blocks, 4 threads each: lane jb + 8 sub
  // holds members sub + 4 r (r < 8) of block base + jb
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int jb = lane & 7, sub = lane >> 3;
  for (int base = b0 + warp * 8; base < b1; base += THREADS / 4) {
    const bool ok = base + jb < b1;
    const mx::Block blk = mx::block_of(ok ? base + jb : base, k4, k6, k8);
    const mx::Fmt f = mx::seg_fmt(blk.seg);
    const int c0 = blk.off + blk.j + sub * blk.nb, step = 4 * blk.nb;
    float v[8];
    float amax = 0.0f;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      v[r] = site.template value_of<P>(c0 + r * step);
      amax = fmaxf(amax, fabsf(v[r]));
    }
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 8));
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 16));
    const int e = mx::block_scale_exponent(amax, f.max);
    const float rs = mx::exp2i(-e), sc = mx::exp2i(e);
    if (ok) {
#pragma unroll
      for (int r = 0; r < 8; ++r)
        dst[c0 + r * step] = __float2bfloat16_rn(mx::quantize_to_grid(v[r] * rs, f) * sc);
    }
  }
  if (WHOLE) {
    __syncthreads();
    for (int c = threadIdx.x; c < K / 8; c += THREADS)
      *reinterpret_cast<uint4*>(orow + 8 * c) = *reinterpret_cast<const uint4*>(dst + 8 * c);
  }
}

template <int P, bool WHOLE>
int launch(const void* x, const void* aux, const void* perm, void* out, int M, int K,
           int k4, int k6, int k8, int perm_rows, float eps, int bpc, cudaStream_t stream) {
  size_t smem = 0;
  if (WHOLE || P == 1 || perm != nullptr) {
    smem = static_cast<size_t>(K) * 2;
    if (P == 1) smem += static_cast<size_t>(K) * 4;
    if (P == 2 && WHOLE) smem += static_cast<size_t>(K) * 2;
    if (WHOLE && perm != nullptr) smem += static_cast<size_t>(K) * 2;
  }
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {     // above the default limit: raise it, once a device and size
    static int done[64] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev >= 64 || done[dev] < static_cast<int>(smem)) {
      err = cudaFuncSetAttribute(site_kernel<P, WHOLE>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
      if (dev < 64) done[dev] = static_cast<int>(smem);
    }
  }
  dim3 grid(M, (K / 32 + bpc - 1) / bpc);
  site_kernel<P, WHOLE><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), aux, static_cast<const int*>(perm),
      static_cast<__nv_bfloat16*>(out), K, k4, k6, k8, perm_rows, eps, bpc);
  return static_cast<int>(cudaGetLastError());
}

template <int P>
int launch_p(const void* x, const void* aux, const void* perm, void* out, int M, int K,
             int k4, int k6, int k8, int perm_rows, float eps, int bpc, cudaStream_t stream) {
  if (bpc >= K / 32)
    return launch<P, true>(x, aux, perm, out, M, K, k4, k6, k8, perm_rows, eps, K / 32,
                           stream);
  return launch<P, false>(x, aux, perm, out, M, K, k4, k6, k8, perm_rows, eps, bpc, stream);
}

}  // namespace

// perm_rows: rows per permutation of a (G, K) perm array (M / G); with a
// single (K,) perm it is M.  bpc: 32-blocks a CTA (K / 32: whole rows).
extern "C" int site_fakequant(const void* x, const void* aux, const void* perm,
                              void* out, int M, int K, int k4, int k6, int k8,
                              int producer, int perm_rows, float eps, int bpc,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (producer == 0)
    return launch_p<0>(x, aux, perm, out, M, K, k4, k6, k8, perm_rows, eps, bpc, s);
  if (producer == 1)
    return launch_p<1>(x, aux, perm, out, M, K, k4, k6, k8, perm_rows, eps, bpc, s);
  if (producer == 2)
    return launch_p<2>(x, aux, perm, out, M, K, k4, k6, k8, perm_rows, eps, bpc, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
