// Split-plane MX GEMM: Y (M, N) = dq(A codes) . dq(W split-plane)^T.
//
// Replaces micromix_tpu/kernels/mixed_matmul.py::mixed_matmul, its
// split-plane branch (_mixed_matmul_kernel): A an MX activation (codes
// one per byte, fp4 unpacked, each segment in its own grid, UE8M0 scales),
// W a split-plane weight (fp4 packed two per byte; fp6 / fp8 codes, or
// FP4 codes there too when fp4_only).  Both operands decode to exact bf16,
// summed in f32: dequantize_mixed_device of both, then one dot.
//
// Bound on the H100: bytes at decode M (the weight's 0.59 bytes an element
// dominate: 14336 x 4096 is 34.9 MB, 10.4 us at 3.35 TB/s), operations
// only from M in the hundreds (the prefill chunks of 129-511 rows that
// reach it).
//
// Design (simple, not yet tuned): the tile of sp_tile.cuh, a block of 4
// warps on a 64-row strip of W and BM = 16 or 64 rows of A, decoding both
// operands into shared memory at every 128-column step, mma.sync bf16 with
// f32 accumulation.  K is split over gridDim.z as the wrapper asks
// (sp_split_k: a function of M and K only, so that Kernel L, given the
// same M and K, sums every output in the same order); a second kernel
// adds the f32 partials in a fixed order.

#include "sp_tile.cuh"

namespace {

using sp::BN;

template <int BM>
__global__ void __launch_bounds__(sp::THREADS)
sp_gemm_kernel(sp::Operand a, sp::Operand w, sp::Segs s,
               __nv_bfloat16* __restrict__ out, float* __restrict__ partial,
               int M, int N, int t_chunk) {
  extern __shared__ __align__(16) uint8_t sw[];
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int tbeg = blockIdx.z * t_chunk;
  sp::stage_scales(sw, w, s, N, n0);
  sp::CodesA<BM> src{a, M, m0, s};
  float acc[BM / 16][2][4];
  sp::mainloop<BM>(src, w, sw, s, N, n0, tbeg, tbeg + t_chunk, acc);
  w8::for_each_pair<BM>(acc, m0, n0, [&](int m, int n, float c0, float c1) {
    if (m >= M || n >= N) return;
    if (partial == nullptr) {
      *reinterpret_cast<__nv_bfloat162*>(out + static_cast<size_t>(m) * N + n) =
          __floats2bfloat162_rn(c0, c1);
    } else {
      float* p = partial + (static_cast<size_t>(blockIdx.z) * M + m) * N + n;
      *reinterpret_cast<float2*>(p) = make_float2(c0, c1);
    }
  });
}

__global__ void sum_partials(const float* __restrict__ partial,
                             __nv_bfloat16* __restrict__ out, size_t mn,
                             int splits) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float acc = 0.0f;
  for (int z = 0; z < splits; ++z) acc += partial[z * mn + i];
  out[i] = __float2bfloat16_rn(acc);
}

int allowed16 = 0, allowed64 = 0;

}  // namespace

// a / w: 6 pointers each, codes of the fp4, fp6, fp8 segments then their
// scales (A: (M, kseg) codes; W: (N, k4/2) packed, (N, k6), (N, k8));
// partial: f32 (splits, M, N) scratch when splits > 1, else unused.
extern "C" int sp_gemm(const void* const* a, const void* const* w, void* out,
                       void* partial, int M, int N, int k4, int k6, int k8,
                       int fp4_only, int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  sp::Operand ao, wo;
  for (int i = 0; i < 3; ++i) {
    ao.c[i] = static_cast<const uint8_t*>(a[i]);
    ao.s[i] = static_cast<const uint8_t*>(a[3 + i]);
    wo.c[i] = static_cast<const uint8_t*>(w[i]);
    wo.s[i] = static_cast<const uint8_t*>(w[3 + i]);
  }
  const sp::Segs s{k4, k6, k8, fp4_only};
  const int t_chunk = s.steps() / splits;
  const int smem = BN * s.nbt();
  float* p = splits > 1 ? static_cast<float*>(partial) : nullptr;
  auto* Y = static_cast<__nv_bfloat16*>(out);
  cudaError_t err;
  if (w8::block_m(M) == 16) {
    err = sp::allow_dynamic_smem(sp_gemm_kernel<16>, smem, allowed16);
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid((N + BN - 1) / BN, (M + 15) / 16, splits);
    sp_gemm_kernel<16><<<grid, sp::THREADS, smem, st>>>(ao, wo, s, Y, p, M, N, t_chunk);
  } else {
    err = sp::allow_dynamic_smem(sp_gemm_kernel<64>, smem, allowed64);
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid((N + BN - 1) / BN, (M + 63) / 64, splits);
    sp_gemm_kernel<64><<<grid, sp::THREADS, smem, st>>>(ao, wo, s, Y, p, M, N, t_chunk);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const size_t mn = static_cast<size_t>(M) * N;
  sum_partials<<<static_cast<unsigned>((mn + 255) / 256), 256, 0, st>>>(p, Y, mn, splits);
  return static_cast<int>(cudaGetLastError());
}
