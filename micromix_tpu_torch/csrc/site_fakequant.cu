// Activation-site fakequant: producer + per-32-block UE8M0 + RNE grid round.
//
// Replaces micromix_tpu/kernels/fakequant.py::fakequant_site_pallas
// (_site_kernel) and the site half of
// micromix_tpu/kernels/mixed_matmul.py::mixed_matmul_w8_site
// (_w8_site_kernel): x (M, K) bf16 -> the bf16 grid image (M, K) in the
// block-interleaved device layout that the ScaledW8 GEMM consumes.
//
// Bound on the H100: bytes.  It reads x (and up or gamma) once and writes
// the image once, a few dozen operations per element; at M <= 128 it is a
// few MB, so launch latency dominates.
//
// Design: one block per row.  Pass 1 (rms only) reduces the row's sum of
// squares in f32 over the unpermuted row, then rvar = 1 / sqrtf(mean + eps)
// (correctly rounded, as the JAX package's sites use).  Pass 2 gives one
// thread per 32-block: block j of a segment with nb blocks is columns
// j + i*nb, so neighbouring threads read neighbouring addresses.  The
// thread keeps its 32 producer values in registers, takes the abs-max, reads
// the UE8M0 exponent from the f32 bits, scales by 2^-e, rounds
// half-to-even with rintf onto the segment's grid (saturating), scales back
// and stores bf16.  The channel permutation is an indexed load x[perm[c]];
// with perm_rows > 0, row r reads permutation r / perm_rows of a (G, K)
// array (the MoE experts' own sites, all experts' rows in one launch).
// The producer and the block arithmetic live in mx_site.cuh, which the MX
// quantize kernel (mx_quantize.cu) shares.  Built without fast-math: IEEE division, sqrtf and rintf keep the plain
// site bit-exact with the JAX package's.

#include "mx_site.cuh"

namespace {

__global__ void site_kernel(const __nv_bfloat16* __restrict__ x,
                            const void* __restrict__ aux,
                            const int* __restrict__ perm,
                            __nv_bfloat16* __restrict__ out, int K, int k4,
                            int k6, int k8, int producer, int perm_rows,
                            float eps) {
  const int row = blockIdx.x;
  const __nv_bfloat16* xr = x + static_cast<size_t>(row) * K;
  if (perm != nullptr && perm_rows > 0) perm += static_cast<size_t>(row / perm_rows) * K;
  mx::SiteRow site{xr, static_cast<const float*>(aux),
                   static_cast<const __nv_bfloat16*>(aux) + static_cast<size_t>(row) * K,
                   perm, producer, 0.0f};
  if (producer == 1) site.rvar = mx::row_rvar(xr, K, eps);
  __nv_bfloat16* orow = out + static_cast<size_t>(row) * K;

  for (int b = threadIdx.x; b < (k4 + k6 + k8) / 32; b += blockDim.x) {
    const mx::Block blk = mx::block_of(b, k4, k6, k8);
    const mx::Fmt f = mx::seg_fmt(blk.seg);
    float v[32];
    float amax = 0.0f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      v[i] = site.value(blk.off + blk.j + i * blk.nb);
      amax = fmaxf(amax, fabsf(v[i]));
    }
    const int e = mx::block_scale_exponent(amax, f.max);
    const float rs = mx::exp2i(-e), sc = mx::exp2i(e);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      orow[blk.off + blk.j + i * blk.nb] =
          __float2bfloat16_rn(mx::quantize_to_grid(v[i] * rs, f) * sc);
    }
  }
}

}  // namespace

// perm_rows: rows per permutation of a (G, K) perm array (M / G); with a
// single (K,) perm it is M.
extern "C" int site_fakequant(const void* x, const void* aux, const void* perm,
                              void* out, int M, int K, int k4, int k6, int k8,
                              int producer, int perm_rows, float eps,
                              void* stream) {
  const int blocks = K / 32;
  int threads = ((blocks + 31) / 32) * 32;
  if (threads > 512) threads = 512;
  site_kernel<<<M, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), aux, static_cast<const int*>(perm),
      static_cast<__nv_bfloat16*>(out), K, k4, k6, k8, producer, perm_rows, eps);
  return static_cast<int>(cudaGetLastError());
}
