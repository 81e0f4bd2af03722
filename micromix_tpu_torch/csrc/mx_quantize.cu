// Activation MX quantize: producer + per-32-block UE8M0 + RNE grid round +
// encode, to codes and scale bytes.
//
// Replaces micromix_tpu/kernels/quantize.py::quantize_mixed_pallas
// (_quantize_kernel), together with the producers in front of it
// (micromix_tpu/ops/quantize_ops.py: reorder_quantize_x,
// rmsnorm_quantize_x, silu_mul_quantize_x): x (M, K) bf16 -> for each
// segment (MXFP4 | MXFP6 | MXFP8, device layout) codes (M, kseg) u8, fp4
// unpacked one per byte, and UE8M0 bytes (M, kseg / 32) = e + 127.
//
// Bound on the H100: bytes.  It reads x (and up or gamma) once and writes
// one code byte per element plus one scale byte per 32; at decode M that
// is tens of KB, so launch latency dominates.
//
// Design: Kernel A's (site_fakequant.cu), one block per row, one thread per
// 32-block, the producer and the block arithmetic from mx_site.cuh; where A
// writes the scaled grid value, J encodes the grid value (sign from x < 0,
// so a small negative that rounds to zero encodes as -0) and writes the
// scale byte.  Neighbouring threads write neighbouring code bytes.

#include "mx_site.cuh"

namespace {

struct Outs {
  uint8_t* codes[3];
  uint8_t* scales[3];
};

__global__ void mx_quantize_kernel(const __nv_bfloat16* __restrict__ x,
                                   const void* __restrict__ aux,
                                   const int* __restrict__ perm, Outs outs,
                                   int K, int k4, int k6, int k8, int producer,
                                   float eps) {
  const int row = blockIdx.x;
  const __nv_bfloat16* xr = x + static_cast<size_t>(row) * K;
  mx::SiteRow site{xr, static_cast<const float*>(aux),
                   static_cast<const __nv_bfloat16*>(aux) + static_cast<size_t>(row) * K,
                   perm, producer, 0.0f};
  if (producer == 1) site.rvar = mx::row_rvar(xr, K, eps);

  for (int b = threadIdx.x; b < K / 32; b += blockDim.x) {
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
    const float rs = mx::exp2i(-e);
    uint8_t* crow = outs.codes[blk.seg] + static_cast<size_t>(row) * blk.nb * 32;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      crow[blk.j + i * blk.nb] = mx::encode(mx::quantize_to_grid(v[i] * rs, f), f);
    }
    outs.scales[blk.seg][static_cast<size_t>(row) * blk.nb + blk.j] =
        static_cast<uint8_t>(e + 127);
  }
}

}  // namespace

// codes[i] / scales[i]: the segments' (M, kseg) and (M, kseg / 32) u8
// outputs (unused for an empty segment); aux and perm as site_fakequant's.
extern "C" int mx_quantize(const void* x, const void* aux, const void* perm,
                           void* c4, void* c6, void* c8, void* s4, void* s6,
                           void* s8, int M, int K, int k4, int k6, int k8,
                           int producer, float eps, void* stream) {
  Outs outs{{static_cast<uint8_t*>(c4), static_cast<uint8_t*>(c6),
             static_cast<uint8_t*>(c8)},
            {static_cast<uint8_t*>(s4), static_cast<uint8_t*>(s6),
             static_cast<uint8_t*>(s8)}};
  const int blocks = K / 32;
  int threads = ((blocks + 31) / 32) * 32;
  if (threads > 512) threads = 512;
  mx_quantize_kernel<<<M, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), aux, static_cast<const int*>(perm),
      outs, K, k4, k6, k8, producer, eps);
  return static_cast<int>(cudaGetLastError());
}
