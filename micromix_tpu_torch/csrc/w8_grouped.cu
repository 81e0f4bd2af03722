// Grouped ScaledW8 GEMM: every MoE expert's own weights in one launch.
//
// Replaces micromix_tpu/kernels/mixed_matmul.py::mixed_matmul_w8_grouped
// (_w8_grouped_kernel), together with the site kernel (site_fakequant.cu)
// that the wrapper launches first over all E x C rows (the plain site with
// each expert's own permutation, or the silu site): Y_i[e] (C, N_i) =
// img[e] (C, K) bf16 . decode(W[e]_i)^T * 2^(bases[e][i]+126), for every
// group e (expert) and section i of one code array (E, sum padded_i, K) u8
// (w1|w3, or w2 alone).
//
// Bound on the H100: bytes at decode C.  The experts' codes dominate
// (Mixtral-8x7B w1|w3: 8 x 28672 x 4096 = 939.5 MB, 0.280 ms at
// 3.35 TB/s; w2: 8 x 4096 x 14336 = 469.8 MB, 0.140 ms); at C <= 128 the
// product does at most 256 operations per code byte, below the ~295 that
// would make the bf16 tensor cores the limit.
//
// Design: the tile of w8_tile.cuh (Kernel B's) over a grid of (64-row
// strip, expert x M-tile, split of K).  The TPU kernel walks (expert,
// strip) in order and keeps the expert's site image in VMEM from its first
// strip on; Hopper's blocks run in no order, so, as in Kernel F, the site
// runs as its own launch and every block reads its expert's rows of the
// image from L2.  Sections are padded to a multiple of 64 rows (the JAX
// package pads them to 128-512), so a strip lies in one section; the block
// finds it, takes that expert's scale for it, and writes only that
// section's output, never its padded rows.  K is split over gridDim.z
// with the split that Kernel B takes for one expert's section (C, N_0,
// K), and a second kernel sums the f32 partials in a fixed order: the
// result is then the per-expert loop's (site + B per expert) bit for bit,
// as the TPU kernel is its own per-expert loop's.

#include "w8_tile.cuh"

namespace {

using w8::BN;
constexpr int MAX_SEC = 4;
constexpr int MAX_GROUPS = 64;

struct Groups {
  int n_sec;
  int start[MAX_SEC];   // first stacked row of each section, a multiple of BN
  int rows[MAX_SEC];    // true rows: the width of the section's output
  __nv_bfloat16* out[MAX_SEC];             // (E, C, rows) each
  float scale[MAX_GROUPS * MAX_SEC];       // [group * MAX_SEC + section]
};

__device__ __forceinline__ int section_of(const Groups& g, int row) {
  int i = 0;
  while (i + 1 < g.n_sec && row >= g.start[i + 1]) ++i;
  return i;
}

template <int BM>
__global__ void __launch_bounds__(w8::THREADS)
w8_grouped_kernel(const __nv_bfloat16* __restrict__ A,
                  const uint8_t* __restrict__ codes, Groups grp,
                  float* __restrict__ partial, int E, int C, int total, int K,
                  int k_chunk, int m_tiles) {
  const int e = blockIdx.y / m_tiles;
  const int m0 = (blockIdx.y % m_tiles) * BM;
  const int n0 = blockIdx.x * BN;
  const int kbeg = blockIdx.z * k_chunk;
  const int s = section_of(grp, n0);
  const int start = grp.start[s], rows = grp.rows[s];
  const int local0 = n0 - start;
  float acc[BM / 16][2][4];
  w8::mainloop<BM>(A + static_cast<size_t>(e) * C * K,
                   codes + (static_cast<size_t>(e) * total + start) * K, C, rows,
                   K, m0, local0, kbeg, kbeg + k_chunk,
                   grp.scale[e * MAX_SEC + s], acc);
  __nv_bfloat16* out = grp.out[s] + static_cast<size_t>(e) * C * rows;
  w8::for_each_pair<BM>(acc, m0, local0, [&](int m, int n, float c0, float c1) {
    if (m >= C || n >= rows) return;
    if (partial == nullptr) {
      *reinterpret_cast<__nv_bfloat162*>(out + static_cast<size_t>(m) * rows + n) =
          __floats2bfloat162_rn(c0, c1);
    } else {
      float* p = partial +
                 ((static_cast<size_t>(blockIdx.z) * E + e) * C + m) * total + start + n;
      *reinterpret_cast<float2*>(p) = make_float2(c0, c1);
    }
  });
}

__global__ void sum_grouped_partials(const float* __restrict__ partial,
                                     Groups grp, int E, int C, int total,
                                     int splits) {
  const size_t emn = static_cast<size_t>(E) * C * total;
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= emn) return;
  const size_t em = i / total;                  // e * C + m
  const int col = static_cast<int>(i % total);
  const int s = section_of(grp, col);
  const int n = col - grp.start[s];
  if (n >= grp.rows[s]) return;                 // padded row: never written
  float acc = 0.0f;
  for (int z = 0; z < splits; ++z) acc += partial[z * emn + i];
  grp.out[s][em * grp.rows[s] + n] = __float2bfloat16_rn(acc);
}

}  // namespace

// a: the site image (E, C, K) bf16.  rows / padded: n_sec host values
// (n_sec <= 4; padded rows multiples of 64, rows multiples of 8); scales:
// E * n_sec host values, group-major; outs: n_sec (E, C, rows_i) bf16.
// partial: f32 (splits, E, C, sum padded) scratch when splits > 1.
extern "C" int w8_grouped(const void* a, const void* codes, void* partial,
                          const int* rows, const int* padded,
                          const float* scales, void* const* outs, int n_sec,
                          int E, int C, int K, int splits, void* stream) {
  if (n_sec < 1 || n_sec > MAX_SEC || E < 1 || E > MAX_GROUPS)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Groups grp{};
  grp.n_sec = n_sec;
  int total = 0;
  for (int i = 0; i < n_sec; ++i) {
    grp.start[i] = total;
    grp.rows[i] = rows[i];
    grp.out[i] = static_cast<__nv_bfloat16*>(outs[i]);
    total += padded[i];
  }
  for (int e = 0; e < E; ++e)
    for (int i = 0; i < n_sec; ++i) grp.scale[e * MAX_SEC + i] = scales[e * n_sec + i];
  const int k_chunk = K / splits;
  float* p = splits > 1 ? static_cast<float*>(partial) : nullptr;
  const auto* A = static_cast<const __nv_bfloat16*>(a);
  const auto* W = static_cast<const uint8_t*>(codes);
  if (w8::block_m(C) == 16) {
    const int m_tiles = (C + 15) / 16;
    dim3 grid(total / BN, E * m_tiles, splits);
    w8_grouped_kernel<16><<<grid, w8::THREADS, 0, st>>>(A, W, grp, p, E, C, total,
                                                         K, k_chunk, m_tiles);
  } else {
    const int m_tiles = (C + 63) / 64;
    dim3 grid(total / BN, E * m_tiles, splits);
    w8_grouped_kernel<64><<<grid, w8::THREADS, 0, st>>>(A, W, grp, p, E, C, total,
                                                         K, k_chunk, m_tiles);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const size_t emn = static_cast<size_t>(E) * C * total;
  sum_grouped_partials<<<static_cast<unsigned>((emn + 255) / 256), 256, 0, st>>>(
      p, grp, E, C, total, splits);
  return static_cast<int>(cudaGetLastError());
}
