// Residual-closing ScaledW8 GEMM, the middle stage of the residual pair.
//
// Replaces micromix_tpu/kernels/mixed_matmul.py::mixed_matmul_w8_pair
// (_w8_pair_kernel) together with the site kernel (site_fakequant.cu) and
// the stacked GEMM (w8_stack.cu) that its wrapper launches before and
// after it:
//
//   A     = site_a(x_a) . decode(Wa)^T                 (o or down proj)
//   h_mid = h_in + A (+ bias_a)                        this kernel
//   Y_b   = fq(rms(h_mid) gamma_b) . decode(W_b,i)^T   (gate|up or q|k|v)
//
// On the TPU one sequential grid runs phase A, closes the residual at the
// boundary step and runs phase B.  On Hopper blocks run in no order, and
// phase B's rms needs the whole row of h_mid, so the dependency goes
// between launches: site A, this kernel, then the site and stack GEMM of
// phase B.  One persistent launch with a grid barrier is later work.
//
// Bound on the H100: bytes, the Wa codes (o: 4096 x 4096 = 16.8 MB, down:
// 4096 x 14336 = 58.7 MB) at decode M; with phase B's codes the pair
// moves 134.2 MB (o -> gate|up, 40.1 us) or 83.9 MB (down -> q|k|v,
// 25.0 us) at 3.35 TB/s.
//
// Design: Kernel B's tile (w8_tile.cuh).  Its last pass closes the
// residual with the rounding points of the unfused chain, so h_mid is bit
// for bit that chain's: the GEMM output rounds to bf16, the bias adds and
// rounds in bf16, the residual closes in bf16.  That pass is the epilogue
// when K is not split, and the fixed-order sum of the f32 partials when
// it is.

#include "w8_tile.cuh"

namespace {

using w8::BN;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// bias may be null
__device__ __forceinline__ __nv_bfloat16 close_residual(
    float acc, __nv_bfloat16 h, const __nv_bfloat16* __restrict__ bias, int n) {
  float a = bf16_round(acc);
  if (bias != nullptr) a = bf16_round(a + __bfloat162float(bias[n]));
  return __float2bfloat16_rn(__bfloat162float(h) + a);
}

template <int BM>
__global__ void __launch_bounds__(w8::THREADS)
w8_residual_kernel(const __nv_bfloat16* __restrict__ A,
                   const uint8_t* __restrict__ W,
                   const __nv_bfloat16* __restrict__ h_in,
                   const __nv_bfloat16* __restrict__ bias,
                   __nv_bfloat16* __restrict__ h_mid, float* __restrict__ partial,
                   int M, int N, int K, float scale, int k_chunk) {
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int kbeg = blockIdx.z * k_chunk;
  float acc[BM / 16][2][4];
  w8::mainloop<BM>(A, W, M, N, K, m0, n0, kbeg, kbeg + k_chunk, scale, acc);
  w8::for_each_pair<BM>(acc, m0, n0, [&](int m, int n, float c0, float c1) {
    if (m >= M || n >= N) return;
    const size_t i = static_cast<size_t>(m) * N + n;
    if (partial == nullptr) {
      h_mid[i] = close_residual(c0, h_in[i], bias, n);
      h_mid[i + 1] = close_residual(c1, h_in[i + 1], bias, n + 1);
    } else {
      float* p = partial + static_cast<size_t>(blockIdx.z) * M * N + i;
      *reinterpret_cast<float2*>(p) = make_float2(c0, c1);
    }
  });
}

__global__ void sum_residual_partials(const float* __restrict__ partial,
                                      const __nv_bfloat16* __restrict__ h_in,
                                      const __nv_bfloat16* __restrict__ bias,
                                      __nv_bfloat16* __restrict__ h_mid, int M,
                                      int N, int splits) {
  const size_t mn = static_cast<size_t>(M) * N;
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float acc = 0.0f;
  for (int z = 0; z < splits; ++z) acc += partial[z * mn + i];
  h_mid[i] = close_residual(acc, h_in[i], bias, static_cast<int>(i % N));
}

}  // namespace

// a: site image (M, K) bf16; codes: Wa (N, K) u8; h_in, h_mid (M, N) bf16;
// bias: (N,) bf16 or null; partial: f32 (splits, M, N) when splits > 1.
extern "C" int w8_residual(const void* a, const void* codes, const void* h_in,
                           const void* bias, void* h_mid, void* partial, int M,
                           int N, int K, float scale, int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int k_chunk = K / splits;
  float* p = splits > 1 ? static_cast<float*>(partial) : nullptr;
  const auto* A = static_cast<const __nv_bfloat16*>(a);
  const auto* W = static_cast<const uint8_t*>(codes);
  const auto* H = static_cast<const __nv_bfloat16*>(h_in);
  const auto* B = static_cast<const __nv_bfloat16*>(bias);
  auto* Y = static_cast<__nv_bfloat16*>(h_mid);
  if (w8::block_m(M) == 16) {
    dim3 grid((N + BN - 1) / BN, (M + 15) / 16, splits);
    w8_residual_kernel<16><<<grid, w8::THREADS, 0, s>>>(A, W, H, B, Y, p, M, N, K,
                                                         scale, k_chunk);
  } else {
    dim3 grid((N + BN - 1) / BN, (M + 63) / 64, splits);
    w8_residual_kernel<64><<<grid, w8::THREADS, 0, s>>>(A, W, H, B, Y, p, M, N, K,
                                                         scale, k_chunk);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const size_t mn = static_cast<size_t>(M) * N;
  sum_residual_partials<<<static_cast<unsigned>((mn + 255) / 256), 256, 0, s>>>(
      p, H, B, Y, M, N, splits);
  return static_cast<int>(cudaGetLastError());
}
