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
// Built without fast-math: IEEE division, sqrtf and rintf keep the plain
// site bit-exact with the JAX package's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Fmt {
  float max;
  int emin;
  int mant;
};

__device__ __forceinline__ float exp2i(int e) {
  return __uint_as_float(static_cast<uint32_t>(e + 127) << 23);
}

__device__ __forceinline__ int block_scale_exponent(float maxv, float fmax) {
  if (!(maxv > 0.0f)) return -1;
  uint32_t bits = __float_as_uint(maxv / fmax);
  int e = static_cast<int>((bits >> 23) & 0xFF) - 127 + ((bits & 0x7FFFFF) != 0);
  return min(max(e, -126), 127);
}

__device__ __forceinline__ float quantize_to_grid(float x, Fmt f) {
  float ax = fminf(fabsf(x), f.max);
  int e = static_cast<int>((__float_as_uint(ax) >> 23) & 0xFF) - 127;
  e = max(e, f.emin);
  float ulp = exp2i(e - f.mant);
  float q = rintf(ax / ulp) * ulp;
  return x < 0.0f ? -q : q;
}

// producer: 0 plain, 1 rms (aux = gamma f32 (K,), source order),
// 2 silu (aux = up bf16 (M, K), device order)
__global__ void site_kernel(const __nv_bfloat16* __restrict__ x,
                            const void* __restrict__ aux,
                            const int* __restrict__ perm,
                            __nv_bfloat16* __restrict__ out, int K, int k4,
                            int k6, int k8, int producer, int perm_rows,
                            float eps) {
  const int row = blockIdx.x;
  const __nv_bfloat16* xr = x + static_cast<size_t>(row) * K;
  if (perm != nullptr && perm_rows > 0) perm += static_cast<size_t>(row / perm_rows) * K;
  __shared__ float red[32];
  __shared__ float s_rvar;

  float rvar = 0.0f;
  if (producer == 1) {
    float acc = 0.0f;
    for (int c = threadIdx.x; c < K; c += blockDim.x) {
      float v = __bfloat162float(xr[c]);
      acc += v * v;
    }
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (lane == 0) red[warp] = acc;
    __syncthreads();
    if (threadIdx.x == 0) {
      float total = 0.0f;
      for (int w = 0; w < (blockDim.x + 31) / 32; ++w) total += red[w];
      s_rvar = 1.0f / sqrtf(total / static_cast<float>(K) + eps);
    }
    __syncthreads();
    rvar = s_rvar;
  }

  const int nb4 = k4 / 32, nb6 = k6 / 32, nb8 = k8 / 32;
  const float* gamma = static_cast<const float*>(aux);
  const __nv_bfloat16* up =
      static_cast<const __nv_bfloat16*>(aux) + static_cast<size_t>(row) * K;
  __nv_bfloat16* orow = out + static_cast<size_t>(row) * K;

  for (int b = threadIdx.x; b < nb4 + nb6 + nb8; b += blockDim.x) {
    int off, nb, j;
    Fmt f;
    if (b < nb4) {
      off = 0; nb = nb4; j = b; f = {6.0f, 0, 1};
    } else if (b < nb4 + nb6) {
      off = k4; nb = nb6; j = b - nb4; f = {28.0f, -2, 2};
    } else {
      off = k4 + k6; nb = nb8; j = b - nb4 - nb6; f = {448.0f, -6, 3};
    }
    float v[32];
    float amax = 0.0f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = off + j + i * nb;
      const int src = perm ? perm[c] : c;
      const float xv = __bfloat162float(xr[src]);
      float y;
      if (producer == 1) {
        y = xv * rvar * gamma[src];
      } else if (producer == 2) {
        const float sig = 1.0f / (1.0f + expf(-xv));
        y = xv * sig * __bfloat162float(up[c]);
      } else {
        y = xv;
      }
      v[i] = y;
      amax = fmaxf(amax, fabsf(y));
    }
    const int e = block_scale_exponent(amax, f.max);
    const float rs = exp2i(-e), sc = exp2i(e);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      orow[off + j + i * nb] = __float2bfloat16_rn(quantize_to_grid(v[i] * rs, f) * sc);
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
