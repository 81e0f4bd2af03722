// Kernel G: the residual-closing ScaledW8 GEMM, the middle stage of the
// residual pair, in one launch.
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
// Bound on the H100: bytes, the Wa codes (o: 4096 x 4096 = 16.8 MB, 5.0
// us; down: 4096 x 14336 = 58.7 MB, 17.5 us at 3.35 TB/s) at decode M;
// with phase B's codes the pair moves 134.2 MB (o -> gate|up, 40.1 us) or
// 83.9 MB (down -> q|k|v, 25.0 us).
//
// Two mainloops, chosen by the wrapper's row limit
// (mixed_matmul.W8_RESIDUAL_ROWS_MAX_M, set from the card's timings):
// w8_rows.cuh's decode-row strip up to 32 token rows (the weights on the
// MMA's 16-row side, a register ring of 16-byte loads, no K split at N =
// 4096), and w8_tile.cuh's 16- and 64-row tile above.  Either way the call is one
// launch: without a K split each block closes its outputs itself; with
// one, every block writes its f32 partial to the wrapper's scratch, and
// the last block of a strip or tile, by an atomic ticket (which it resets
// to 0 for the next launch), sums the partials in split order and closes
// them, so the result does not depend on which block ends last.
//
// The close keeps the rounding points of the unfused chain, so h_mid is
// bit for bit that chain's: the GEMM output rounds to bf16, the bias adds
// and rounds in bf16, the residual closes in bf16.

#include "w8_rows.cuh"
#include "w8_tile.cuh"

namespace {

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

struct Close {
  const __nv_bfloat16* h_in;
  const __nv_bfloat16* bias;   // or null
  __nv_bfloat16* h_mid;
  float* partial;              // f32 (splits, M, N) scratch when split
  int* tickets;                // one per strip or tile, zero between launches
  int M, N;

  __device__ __forceinline__ void out(int m, int n, float v) const {
    const size_t i = static_cast<size_t>(m) * N + n;
    h_mid[i] = close_residual(v, h_in[i], bias, n);
  }
  __device__ __forceinline__ void part(int z, int m, int n, float v) const {
    partial[(static_cast<size_t>(z) * M + m) * N + n] = v;
  }
  // after a block's partials are written: whether it is the last of the
  // `count` blocks of ticket t (which it then resets)
  __device__ __forceinline__ bool last(int t, int count) const {
    __shared__ int last_s;
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
      const int k = atomicAdd(tickets + t, 1);
      last_s = k == count - 1;
      if (last_s) tickets[t] = 0;
    }
    __syncthreads();
    if (last_s) __threadfence();
    return last_s;
  }
  // the last block: outputs (m, n .. n + 3) from the splits' partials in
  // order (n % 4 == 0 and N % 8 == 0, so 16-byte loads)
  __device__ __forceinline__ void sum4(int m, int n, int splits) const {
    const size_t mn = static_cast<size_t>(M) * N, i = static_cast<size_t>(m) * N + n;
    float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
    for (int z = 0; z < splits; ++z) {
      const float4 p = __ldcg(reinterpret_cast<const float4*>(partial + z * mn + i));
      s.x += p.x;
      s.y += p.y;
      s.z += p.z;
      s.w += p.w;
    }
    out(m, n, s.x);
    out(m, n + 1, s.y);
    out(m, n + 2, s.z);
    out(m, n + 3, s.w);
  }
};

// grid (strips of w8r::ROWS weight rows, splits); split z takes the
// 64-deep chunks [z, z + 1) * chunks / splits
template <int NT>
__global__ void __launch_bounds__(w8r::THREADS, 1)
w8_residual_rows_kernel(const __nv_bfloat16* __restrict__ A, const uint8_t* __restrict__ W,
                        Close c, int K, float scale) {
  const int n0 = blockIdx.x * w8r::ROWS, splits = gridDim.y, z = blockIdx.y;
  const int chunks = K / w8r::CK;
  float acc[w8r::MT][NT][4];
  w8r::mainloop<NT>(A, W, c.M, c.N, K, n0, z * chunks / splits, (z + 1) * chunks / splits,
                    scale, acc);
  w8r::block_sums<NT>(acc, c.M, c.N, n0, [&](int n, int m, float v) {
    if (splits == 1)
      c.out(m, n, v);
    else
      c.part(z, m, n, v);
  });
  if (splits == 1 || !c.last(blockIdx.x, splits)) return;
  for (int e = threadIdx.x; e < w8r::ROWS / 4 * c.M; e += w8r::THREADS) {
    const int n = n0 + 4 * (e % (w8r::ROWS / 4)), m = e / (w8r::ROWS / 4);
    if (n < c.N) c.sum4(m, n, splits);
  }
}

// grid (N tiles of w8::BN, M tiles of BM, splits)
template <int BM>
__global__ void __launch_bounds__(w8::THREADS)
w8_residual_tile_kernel(const __nv_bfloat16* __restrict__ A, const uint8_t* __restrict__ W,
                        Close c, int K, float scale) {
  const int n0 = blockIdx.x * w8::BN, m0 = blockIdx.y * BM;
  const int splits = gridDim.z, z = blockIdx.z, k_chunk = K / splits;
  float acc[BM / 16][2][4];
  w8::mainloop<BM>(A, W, c.M, c.N, K, m0, n0, z * k_chunk, (z + 1) * k_chunk, scale, acc);
  w8::for_each_pair<BM>(acc, m0, n0, [&](int m, int n, float c0, float c1) {
    if (m >= c.M || n >= c.N) return;
    if (splits == 1) {
      c.out(m, n, c0);
      c.out(m, n + 1, c1);
    } else {
      c.part(z, m, n, c0);
      c.part(z, m, n + 1, c1);
    }
  });
  if (splits == 1 || !c.last(blockIdx.y * gridDim.x + blockIdx.x, splits)) return;
  for (int e = threadIdx.x; e < BM * w8::BN / 4; e += w8::THREADS) {
    const int m = m0 + e / (w8::BN / 4), n = n0 + 4 * (e % (w8::BN / 4));
    if (m < c.M && n < c.N) c.sum4(m, n, splits);
  }
}

template <int NT>
cudaError_t launch_rows(const __nv_bfloat16* A, const uint8_t* W, const Close& c, int K,
                        float scale, int splits, cudaStream_t s) {
  dim3 grid((c.N + w8r::ROWS - 1) / w8r::ROWS, splits);
  w8_residual_rows_kernel<NT><<<grid, w8r::THREADS, 0, s>>>(A, W, c, K, scale);
  return cudaGetLastError();
}

}  // namespace

// Both entries: a: site image (M, K) bf16; codes: Wa (N, K) u8; h_in,
// h_mid (M, N) bf16; bias: (N,) bf16 or null; partial: f32 (splits, M, N)
// scratch and tickets: int32, zero, one per strip (rows) or tile (tile),
// both unused when splits == 1.  K is a multiple of 128 * splits.

// The decode-row strip, M <= 32.
extern "C" int w8_residual_rows(const void* a, const void* codes, const void* h_in,
                                const void* bias, void* h_mid, void* partial, void* tickets,
                                int M, int N, int K, float scale, int splits, void* stream) {
  const Close c{static_cast<const __nv_bfloat16*>(h_in), static_cast<const __nv_bfloat16*>(bias),
                static_cast<__nv_bfloat16*>(h_mid), static_cast<float*>(partial),
                static_cast<int*>(tickets), M, N};
  const auto* A = static_cast<const __nv_bfloat16*>(a);
  const auto* W = static_cast<const uint8_t*>(codes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 8) return static_cast<int>(launch_rows<1>(A, W, c, K, scale, splits, s));
  if (M <= 16) return static_cast<int>(launch_rows<2>(A, W, c, K, scale, splits, s));
  if (M <= 8 * w8r::MAX_NT) return static_cast<int>(launch_rows<4>(A, W, c, K, scale, splits, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// w8_tile.cuh's tile: 16 rows up to M = 16, 64 above.
extern "C" int w8_residual_tile(const void* a, const void* codes, const void* h_in,
                                const void* bias, void* h_mid, void* partial, void* tickets,
                                int M, int N, int K, float scale, int splits, void* stream) {
  const Close c{static_cast<const __nv_bfloat16*>(h_in), static_cast<const __nv_bfloat16*>(bias),
                static_cast<__nv_bfloat16*>(h_mid), static_cast<float*>(partial),
                static_cast<int*>(tickets), M, N};
  const auto* A = static_cast<const __nv_bfloat16*>(a);
  const auto* W = static_cast<const uint8_t*>(codes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w8::block_m(M) == 16) {
    dim3 grid((N + w8::BN - 1) / w8::BN, (M + 15) / 16, splits);
    w8_residual_tile_kernel<16><<<grid, w8::THREADS, 0, s>>>(A, W, c, K, scale);
  } else {
    dim3 grid((N + w8::BN - 1) / w8::BN, (M + 63) / 64, splits);
    w8_residual_tile_kernel<64><<<grid, w8::THREADS, 0, s>>>(A, W, c, K, scale);
  }
  return static_cast<int>(cudaGetLastError());
}
