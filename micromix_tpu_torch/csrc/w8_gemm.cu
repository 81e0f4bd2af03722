// ScaledW8 GEMM: Y (M, N) = A (M, K) bf16 . decode(codes (N, K) u8, base)^T.
//
// Replaces micromix_tpu/kernels/mixed_matmul.py::mixed_matmul_w8
// (_w8_kernel) and the GEMM half of mixed_matmul_w8_site.
//
// Bound on the H100: bytes at decode M (the N*K code bytes dominate; at
// M = 8 the product does 16 operations per code byte, far below the ~295
// a bf16 tensor-core product needs to be compute-bound), operations only
// from M in the hundreds.
//
// Design: up to 64 rows of A (decode M), a block of 4 warps owns a
// 64-wide strip of N and BM = 16 or 64 rows and runs the tile of
// w8_tile.cuh over its share of K (register-staged loads, in-kernel exact
// bf16 decode, mma.sync m16n8k16, f32 accumulation).  Above 64 rows (the
// prefill chunks of the single ScaledW8 weights, o and down, from 65 to
// 1023 rows), a block of 8 warps owns a 128 x 256 tile (w8_tile128.cuh:
// 4-stage cp.async ring for the A tile and the raw codes, each code
// decoded once per 128 rows of A instead of once per 64, ldmatrix).  When
// the tiles are too few to fill 132 SMs, K is split over gridDim.z (the
// wrapper's w8_gemm_split): each split writes f32 partials and a second
// kernel sums them in a fixed order and rounds to bf16, so results do not
// depend on scheduling.  Both tiles sum each output element's 16-deep
// MMAs in the same order, so a split of K gives the same bits through
// either.
//
// The output is bf16 (each f32 sum rounded once) or f32 (the sums as they
// are: a tensor-parallel rank's partial, summed over the ranks before its
// one round, as the JAX package's row-parallel projections keep theirs).
// Both are stored by one template, so the bf16 output is the f32 one
// rounded, bit for bit, for the same inputs and split.

#include "w8_tile.cuh"
#include "w8_tile128.cuh"

namespace {

using w8::BN;

__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float c0, float c1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(c0, c1);
}
__device__ __forceinline__ void store_pair(float* p, float c0, float c1) {
  *reinterpret_cast<float2*>(p) = make_float2(c0, c1);
}
__device__ __forceinline__ void store_one(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store_one(float* p, float v) { *p = v; }

template <int BM, typename OutT>
__global__ void __launch_bounds__(w8::THREADS)
w8_gemm_kernel(const __nv_bfloat16* __restrict__ A,
               const uint8_t* __restrict__ W, OutT* __restrict__ out,
               float* __restrict__ partial, int M, int N, int K, float scale,
               int k_chunk) {
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int kbeg = blockIdx.z * k_chunk;
  float acc[BM / 16][2][4];
  w8::mainloop<BM>(A, W, M, N, K, m0, n0, kbeg, kbeg + k_chunk, scale, acc);
  w8::for_each_pair<BM>(acc, m0, n0, [&](int m, int n, float c0, float c1) {
    if (m >= M || n >= N) return;
    if (partial == nullptr) {
      store_pair(out + static_cast<size_t>(m) * N + n, c0, c1);
    } else {
      float* p = partial + (static_cast<size_t>(blockIdx.z) * M + m) * N + n;
      *reinterpret_cast<float2*>(p) = make_float2(c0, c1);
    }
  });
}

template <typename OutT>
__global__ void __launch_bounds__(w8w::THREADS)
w8_gemm128_kernel(const __nv_bfloat16* __restrict__ A,
                  const uint8_t* __restrict__ W, OutT* __restrict__ out,
                  float* __restrict__ partial, int M, int N, int K, float scale,
                  int k_chunk) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int n0 = blockIdx.x * w8w::BN, m0 = blockIdx.y * w8w::BM;
  const int tbeg = blockIdx.z * (k_chunk / w8w::BK);
  float acc[w8w::MT][w8w::NT][4];
  w8w::mainloop(A, W, M, N, K, m0, n0, tbeg, tbeg + k_chunk / w8w::BK, scale, smem, acc);
  w8w::for_each_pair(acc, m0, n0, [&](int m, int n, float c0, float c1) {
    if (m >= M || n >= N) return;
    if (partial == nullptr) {
      store_pair(out + static_cast<size_t>(m) * N + n, c0, c1);
    } else {
      float* p = partial + (static_cast<size_t>(blockIdx.z) * M + m) * N + n;
      *reinterpret_cast<float2*>(p) = make_float2(c0, c1);
    }
  });
}

template <typename OutT>
__global__ void sum_partials(const float* __restrict__ partial,
                             OutT* __restrict__ out, size_t mn, int splits) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float s = 0.0f;
  for (int z = 0; z < splits; ++z) s += partial[z * mn + i];
  store_one(out + i, s);
}

template <typename OutT>
int launch(const __nv_bfloat16* A, const uint8_t* W, OutT* Y, float* p, int M,
           int N, int K, float scale, int splits, cudaStream_t s) {
  const int k_chunk = K / splits;
  if (M > 64) {
    static int allowed = 0;  // dynamic shared memory above 48 KB, raised once
    if (allowed < w8w::SMEM) {
      cudaError_t err = cudaFuncSetAttribute(
          w8_gemm128_kernel<OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize, w8w::SMEM);
      if (err != cudaSuccess) return static_cast<int>(err);
      allowed = w8w::SMEM;
    }
    dim3 grid((N + w8w::BN - 1) / w8w::BN, (M + w8w::BM - 1) / w8w::BM, splits);
    w8_gemm128_kernel<OutT><<<grid, w8w::THREADS, w8w::SMEM, s>>>(A, W, Y, p, M, N, K, scale,
                                                                k_chunk);
  } else if (w8::block_m(M) == 16) {
    dim3 grid((N + BN - 1) / BN, (M + 15) / 16, splits);
    w8_gemm_kernel<16, OutT><<<grid, w8::THREADS, 0, s>>>(A, W, Y, p, M, N, K, scale, k_chunk);
  } else {
    dim3 grid((N + BN - 1) / BN, (M + 63) / 64, splits);
    w8_gemm_kernel<64, OutT><<<grid, w8::THREADS, 0, s>>>(A, W, Y, p, M, N, K, scale, k_chunk);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const size_t mn = static_cast<size_t>(M) * N;
  sum_partials<OutT><<<static_cast<unsigned>((mn + 255) / 256), 256, 0, s>>>(p, Y, mn, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// partial: f32 (splits, M, N) scratch when splits > 1, else unused.  K is
// a multiple of 128 * splits.  out: bf16 (M, N), or f32 when out_f32.
extern "C" int w8_gemm(const void* a, const void* codes, void* out,
                       void* partial, int M, int N, int K, float scale,
                       int splits, int out_f32, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = splits > 1 ? static_cast<float*>(partial) : nullptr;
  const auto* A = static_cast<const __nv_bfloat16*>(a);
  const auto* W = static_cast<const uint8_t*>(codes);
  if (out_f32) return launch(A, W, static_cast<float*>(out), p, M, N, K, scale, splits, s);
  return launch(A, W, static_cast<__nv_bfloat16*>(out), p, M, N, K, scale, splits, s);
}
