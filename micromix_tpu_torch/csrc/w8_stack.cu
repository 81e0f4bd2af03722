// Stacked ScaledW8 GEMM: every consumer of one activation site at once.
//
// Replaces micromix_tpu/kernels/mixed_matmul.py::mixed_matmul_w8_stack
// (_w8_stack_kernel), together with the site kernel (site_fakequant.cu)
// that the wrapper launches first: Y_i (M, N_i) = img (M, K) bf16 .
// decode(W_i)^T * 2^(base_i+126) for the sections i of one code array
// (sum padded_i, K) u8 (q|k|v, or gate|up).
//
// Bound on the H100: bytes at decode M.  The stacked codes dominate
// (q|k|v 6144 x 4096 = 25.2 MB, 7.5 us at 3.35 TB/s; gate|up 28672 x 4096
// = 117.4 MB, 35.1 us); at M <= 128 the product does at most 256
// operations per code byte, below the ~295 that would make the bf16
// tensor cores the limit, and from a few hundred rows on (prefill chunks)
// operations.
//
// Design, up to 64 rows (decode M): the tile of w8_tile.cuh (Kernel B's)
// walks 64-row strips of the stacked codes.  Each section is padded to a
// multiple of 64 rows, so a strip lies in one section; the block finds it
// from its strip index, takes that section's scale, and writes only that
// section's output, never its padded rows.  One launch covers every
// section, so the activation image is read from L2 by all strips of the
// site, and q|k|v at M = 8 gets 96 strips where three separate GEMMs got
// 64, 16 and 16.
//
// Above 64 rows (prefill chunks), Kernel B's wide tile (w8_tile128.cuh:
// 128 x 256 outputs per 8-warp block, a 4-stage cp.async ring, each code
// decoded once per 128 rows of A, the decode overlapped with mma.sync)
// runs unchanged.  A 256-row tile could straddle two sections (they are
// padded only to 64 rows), so the wide tiles are numbered per section:
// section i owns ceil(rows_i / 256) tiles from tile0[i] on (a prefix
// table the wrapper computes), and a block runs the mainloop on its
// section's codes with N = rows_i and that section's scale, so rows past
// rows_i read as zero (B's N tail) and are never written.
//
// K is split over gridDim.z when the tiles are too few for 132 SMs; a
// second kernel sums the f32 partials (splits, M, sum padded) in a fixed
// order (deterministic) and routes each column to its section.  The site
// image is made by the site kernel in a launch of its own (the TPU kernel
// keeps it in VMEM): the 32-blocks of the interleaved layout span whole
// segments, so a strip block cannot cheaply own its part of the image.

#include "w8_tile.cuh"
#include "w8_tile128.cuh"

namespace {

using w8::BN;
constexpr int MAX_SEC = 4;

struct Sections {
  int n;
  int start[MAX_SEC];      // first stacked row, a multiple of BN
  int rows[MAX_SEC];       // true rows: the width of the section's output
  int tile0[MAX_SEC + 1];  // first wide tile of each section; tile0[n]: all
  float scale[MAX_SEC];
  __nv_bfloat16* out[MAX_SEC];
};

__device__ __forceinline__ int section_of(const Sections& s, int row) {
  int i = 0;
  while (i + 1 < s.n && row >= s.start[i + 1]) ++i;
  return i;
}

// columns n, n + 1 of row m of section s (n < rows_s): the output, or the
// f32 partial of split z
__device__ __forceinline__ void store_pair(const Sections& sec, int s, float* partial,
                                           int M, int total, int m, int n, float c0,
                                           float c1) {
  if (partial == nullptr) {
    *reinterpret_cast<__nv_bfloat162*>(sec.out[s] + static_cast<size_t>(m) * sec.rows[s] + n) =
        __floats2bfloat162_rn(c0, c1);
  } else {
    float* p = partial + (static_cast<size_t>(blockIdx.z) * M + m) * total + sec.start[s] + n;
    *reinterpret_cast<float2*>(p) = make_float2(c0, c1);
  }
}

template <int BM>
__global__ void __launch_bounds__(w8::THREADS)
w8_stack_kernel(const __nv_bfloat16* __restrict__ A,
                const uint8_t* __restrict__ codes, Sections sec,
                float* __restrict__ partial, int M, int total, int K,
                int k_chunk) {
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int kbeg = blockIdx.z * k_chunk;
  const int s = section_of(sec, n0);
  const int start = sec.start[s], rows = sec.rows[s];
  const int local0 = n0 - start;
  float acc[BM / 16][2][4];
  w8::mainloop<BM>(A, codes + static_cast<size_t>(start) * K, M, rows, K, m0,
                   local0, kbeg, kbeg + k_chunk, sec.scale[s], acc);
  w8::for_each_pair<BM>(acc, m0, local0, [&](int m, int n, float c0, float c1) {
    if (m < M && n < rows) store_pair(sec, s, partial, M, total, m, n, c0, c1);
  });
}

__global__ void __launch_bounds__(w8w::THREADS)
w8_stack128_kernel(const __nv_bfloat16* __restrict__ A,
                   const uint8_t* __restrict__ codes, Sections sec,
                   float* __restrict__ partial, int M, int total, int K,
                   int k_steps) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int tile = blockIdx.x;
  int s = 0;
  while (s + 1 < sec.n && tile >= sec.tile0[s + 1]) ++s;
  const int rows = sec.rows[s];
  const int n0 = (tile - sec.tile0[s]) * w8w::BN, m0 = blockIdx.y * w8w::BM;
  const int tbeg = blockIdx.z * k_steps;
  float acc[w8w::MT][w8w::NT][4];
  w8w::mainloop(A, codes + static_cast<size_t>(sec.start[s]) * K, M, rows, K, m0, n0,
                tbeg, tbeg + k_steps, sec.scale[s], smem, acc);
  w8w::for_each_pair(acc, m0, n0, [&](int m, int n, float c0, float c1) {
    if (m < M && n < rows) store_pair(sec, s, partial, M, total, m, n, c0, c1);
  });
}

__global__ void sum_stack_partials(const float* __restrict__ partial,
                                   Sections sec, int M, int total,
                                   int splits) {
  const size_t mn = static_cast<size_t>(M) * total;
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  const int m = static_cast<int>(i / total), col = static_cast<int>(i % total);
  const int s = section_of(sec, col);
  const int n = col - sec.start[s];
  if (n >= sec.rows[s]) return;                 // padded row: never written
  float acc = 0.0f;
  for (int z = 0; z < splits; ++z) acc += partial[z * mn + i];
  sec.out[s][static_cast<size_t>(m) * sec.rows[s] + n] = __float2bfloat16_rn(acc);
}

}  // namespace

// rows / padded / scales / outs: n_sec host values (n_sec <= 4); padded
// rows are multiples of 64 and rows multiples of 8.  tile0: n_sec + 1
// host values, the prefix of ceil(rows_i / 256) (the wide tiles, used
// above 64 rows).  partial: f32 (splits, M, sum padded) scratch when
// splits > 1, else unused.  K is a multiple of 128 * splits.
extern "C" int w8_stack(const void* a, const void* codes, void* partial,
                        const int* rows, const int* padded, const int* tile0,
                        const float* scales, void* const* outs, int n_sec, int M,
                        int K, int splits, void* stream) {
  if (n_sec < 1 || n_sec > MAX_SEC) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Sections sec{};
  sec.n = n_sec;
  int total = 0;
  for (int i = 0; i < n_sec; ++i) {
    sec.start[i] = total;
    sec.rows[i] = rows[i];
    sec.scale[i] = scales[i];
    sec.out[i] = static_cast<__nv_bfloat16*>(outs[i]);
    total += padded[i];
  }
  for (int i = 0; i <= n_sec; ++i) sec.tile0[i] = tile0[i];
  const int k_chunk = K / splits;
  float* p = splits > 1 ? static_cast<float*>(partial) : nullptr;
  const auto* A = static_cast<const __nv_bfloat16*>(a);
  const auto* W = static_cast<const uint8_t*>(codes);
  if (M > 64) {
    static int allowed = 0;  // dynamic shared memory above 48 KB, raised once
    if (allowed < w8w::SMEM) {
      cudaError_t err = cudaFuncSetAttribute(
          w8_stack128_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, w8w::SMEM);
      if (err != cudaSuccess) return static_cast<int>(err);
      allowed = w8w::SMEM;
    }
    dim3 grid(sec.tile0[n_sec], (M + w8w::BM - 1) / w8w::BM, splits);
    w8_stack128_kernel<<<grid, w8w::THREADS, w8w::SMEM, st>>>(A, W, sec, p, M, total, K,
                                                              k_chunk / w8w::BK);
  } else if (w8::block_m(M) == 16) {
    dim3 grid(total / BN, (M + 15) / 16, splits);
    w8_stack_kernel<16><<<grid, w8::THREADS, 0, st>>>(A, W, sec, p, M, total, K, k_chunk);
  } else {
    dim3 grid(total / BN, (M + 63) / 64, splits);
    w8_stack_kernel<64><<<grid, w8::THREADS, 0, st>>>(A, W, sec, p, M, total, K, k_chunk);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const size_t mn = static_cast<size_t>(M) * total;
  sum_stack_partials<<<static_cast<unsigned>((mn + 255) / 256), 256, 0, st>>>(
      p, sec, M, total, splits);
  return static_cast<int>(cudaGetLastError());
}
