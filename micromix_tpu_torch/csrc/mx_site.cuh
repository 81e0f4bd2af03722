// The activation site's arithmetic, shared by the site kernel (Kernel A,
// site_fakequant.cu: the bf16 grid image) and the MX quantize kernel
// (Kernel J, mx_quantize.cu: codes and UE8M0 scale bytes), so that both
// see the same f32 producer values and the same 32-block scales: a J code
// decoded times its scale is A's image element, bit for bit.
//
// Every function mirrors micromix_tpu/mx/numerics.py: the UE8M0 exponent
// from the f32 bits, rintf (round half to even) after an exact scaling by
// a power-of-two ulp (the quotient bit for bit), IEEE division and sqrtf
// (no fast-math).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mx {

struct Fmt {
  float max;
  int emin;
  int mant;
  int ebits;
};

// MXFP4 (e2m1), MXFP6 (e3m2), MXFP8 (e4m3fn): segment 0, 1, 2
__device__ __forceinline__ Fmt seg_fmt(int seg) {
  if (seg == 0) return {6.0f, 0, 1, 2};
  if (seg == 1) return {28.0f, -2, 2, 3};
  return {448.0f, -6, 3, 4};
}

__device__ __forceinline__ float exp2i(int e) {
  return __uint_as_float(static_cast<uint32_t>(e + 127) << 23);
}

__device__ __forceinline__ int block_scale_exponent(float maxv, float fmax) {
  if (!(maxv > 0.0f)) return -1;
  uint32_t bits = __float_as_uint(maxv / fmax);
  int e = static_cast<int>((bits >> 23) & 0xFF) - 127 + ((bits & 0x7FFFFF) != 0);
  return min(max(e, -126), 127);
}

// The sign comes from x < 0, as in the JAX package: -0.0 rounds to +0.0,
// a small negative that rounds to zero keeps its sign (-0.0).
__device__ __forceinline__ float quantize_to_grid(float x, Fmt f) {
  float ax = fminf(fabsf(x), f.max);
  int e = static_cast<int>((__float_as_uint(ax) >> 23) & 0xFF) - 127;
  e = max(e, f.emin);
  // ax / 2^(e - mant) as ax * 2^(mant - e): a power-of-two scale whose
  // exact result is representable (e >= emin), so the product is the
  // IEEE quotient bit for bit, without a division's instruction sequence
  float q = rintf(ax * exp2i(f.mant - e)) * exp2i(e - f.mant);
  return x < 0.0f ? -q : q;
}

// Grid value (from quantize_to_grid) -> code s|e|m, right-aligned.
__device__ __forceinline__ uint8_t encode(float q, Fmt f) {
  const uint32_t sign = __float_as_uint(q) >> 31;
  const float aq = fabsf(q);
  const uint32_t abits = __float_as_uint(aq);
  const int e = static_cast<int>(abits >> 23) - 127;
  const uint32_t mant_mask = (1u << f.mant) - 1;
  uint32_t exp_field, mant_field;
  if (aq < exp2i(f.emin)) {            // subnormal: value = m * 2^(emin - mant)
    exp_field = 0;
    mant_field = static_cast<uint32_t>(static_cast<int>(aq * exp2i(f.mant - f.emin)));
  } else {
    exp_field = static_cast<uint32_t>(e - f.emin + 1);
    mant_field = (abits >> (23 - f.mant)) & mant_mask;
  }
  return static_cast<uint8_t>((sign << (f.ebits + f.mant)) | (exp_field << f.mant) |
                              mant_field);
}

// rms producer's row factor: 1 / sqrtf(mean(x^2) + eps) over the
// unpermuted row xr (global or shared memory), the row moment summed in
// one fixed order whatever the launch: 128 lanes (the block's first four
// warps; a block has at least 128 threads), lane t over columns t, t + 128,
// ... with fmaf, each warp by an xor tree, then the four warps in order.
// So every block of a row in Kernel A's split launch, and Kernel J, get
// the same bits.  Every thread of the block gets it.
__device__ __forceinline__ float row_rvar(const __nv_bfloat16* xr, int K, float eps) {
  __shared__ float red[4];
  __shared__ float s_rvar;
  const int t = threadIdx.x;
  if (t < 128) {
    float acc = 0.0f;
    for (int c = t; c < K; c += 128) {
      const float v = __bfloat162float(xr[c]);
      acc = fmaf(v, v, acc);
    }
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if ((t & 31) == 0) red[t >> 5] = acc;
  }
  __syncthreads();
  if (t == 0) {
    const float total = ((red[0] + red[1]) + red[2]) + red[3];
    s_rvar = 1.0f / sqrtf(total / static_cast<float>(K) + eps);
  }
  __syncthreads();
  return s_rvar;
}

// One site row: producer 0 plain, 1 rms (gamma f32 (K,), source order),
// 2 silu (up: the row of bf16 (M, K), device order); perm (K,) maps device
// column -> source channel (null: none).  xr, gamma and up may point to
// global or shared memory.
struct SiteRow {
  const __nv_bfloat16* xr;
  const float* gamma;
  const __nv_bfloat16* up;
  const int* perm;
  int producer;
  float rvar;

  // producer P known at compile time (Kernel A's instances)
  template <int P>
  __device__ __forceinline__ float value_of(int c) const {
    const int src = perm ? perm[c] : c;
    const float xv = __bfloat162float(xr[src]);
    if (P == 1) return xv * rvar * gamma[src];
    if (P == 2) {
      const float sig = 1.0f / (1.0f + expf(-xv));
      return xv * sig * __bfloat162float(up[c]);
    }
    return xv;
  }

  __device__ __forceinline__ float value(int c) const {
    if (producer == 1) return value_of<1>(c);
    if (producer == 2) return value_of<2>(c);
    return value_of<0>(c);
  }
};

// Block b of the row's K / 32 blocks: its segment, its first device
// column (j + i * nb for member i), its segment's block count and index.
struct Block {
  int seg, off, nb, j;
};

__device__ __forceinline__ Block block_of(int b, int k4, int k6, int k8) {
  const int nb4 = k4 / 32, nb6 = k6 / 32, nb8 = k8 / 32;
  if (b < nb4) return {0, 0, nb4, b};
  if (b < nb4 + nb6) return {1, k4, nb6, b - nb4};
  return {2, k4 + k6, nb8, b - nb4 - nb6};
}

}  // namespace mx
