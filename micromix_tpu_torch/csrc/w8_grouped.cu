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
// would make the bf16 tensor cores the limit; at prefill C (hundreds of
// rows per expert under dense dispatch) operations.
//
// Design: the TPU kernel walks (expert, strip) in order and keeps the
// expert's site image in VMEM from its first strip on; Hopper's blocks
// run in no order, so, as in Kernel F, the site runs as its own launch and
// every block reads its expert's rows of the image from L2.  Up to 64 rows
// per group the tile of w8_tile.cuh (Kernel B's narrow tile) runs over a
// grid of (64-row strip, expert x M-tile, split of K): sections are padded
// to a multiple of 64 rows (the JAX package pads them to 128-512), so a
// strip lies in one section.  Above 64 rows Kernel B's wide tile
// (w8_tile128.cuh, 128 x 256 outputs per 8-warp block, cp.async ring)
// runs over (wide tile, expert x 128-row M-tile, split): the wide tiles
// are numbered per section (section i owns ceil(rows_i / 256) tiles from
// tile0[i] on), so a tile never straddles two sections, reads the rows
// past rows_i as zero and never writes them.  Either way a block takes
// its expert's scale for its section and writes only that section's
// output, never its padded rows.
//
// K is split over gridDim.z with the split that Kernel B takes for one
// expert's section (C, N_0, K), and a second kernel sums the f32 partials
// in B's fixed order (four columns a thread): each expert's result is
// then the per-expert loop's (site + B per expert) bit for bit, as the
// TPU kernel is its own per-expert loop's, since both tiles sum each
// output element's 16-deep MMAs over a range of K in the same order.

#include "w8_tile.cuh"
#include "w8_tile128.cuh"

namespace {

using w8::BN;
constexpr int MAX_SEC = 4;
constexpr int MAX_GROUPS = 64;

struct Groups {
  int n_sec;
  int start[MAX_SEC];      // first stacked row of each section, a multiple of BN
  int rows[MAX_SEC];       // true rows: the width of the section's output
  int tile0[MAX_SEC + 1];  // first wide tile of each section; tile0[n_sec]: all
  __nv_bfloat16* out[MAX_SEC];             // (E, C, rows) each
  float scale[MAX_GROUPS * MAX_SEC];       // [group * MAX_SEC + section]
};

__device__ __forceinline__ int section_of(const Groups& g, int row) {
  int i = 0;
  while (i + 1 < g.n_sec && row >= g.start[i + 1]) ++i;
  return i;
}

// columns n, n + 1 of row m of group e's section s (n < rows_s): the
// output, or the f32 partial of split z
__device__ __forceinline__ void store_pair(const Groups& grp, int s, float* partial, int E,
                                           int C, int total, int e, int m, int n, float c0,
                                           float c1) {
  if (partial == nullptr) {
    __nv_bfloat16* out = grp.out[s] + (static_cast<size_t>(e) * C + m) * grp.rows[s] + n;
    *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(c0, c1);
  } else {
    float* p = partial + ((static_cast<size_t>(blockIdx.z) * E + e) * C + m) * total +
               grp.start[s] + n;
    *reinterpret_cast<float2*>(p) = make_float2(c0, c1);
  }
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
  w8::for_each_pair<BM>(acc, m0, local0, [&](int m, int n, float c0, float c1) {
    if (m < C && n < rows) store_pair(grp, s, partial, E, C, total, e, m, n, c0, c1);
  });
}

__global__ void __launch_bounds__(w8w::THREADS)
w8_grouped128_kernel(const __nv_bfloat16* __restrict__ A,
                     const uint8_t* __restrict__ codes, Groups grp,
                     float* __restrict__ partial, int E, int C, int total, int K,
                     int k_steps, int m_tiles) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int tile = blockIdx.x;
  int s = 0;
  while (s + 1 < grp.n_sec && tile >= grp.tile0[s + 1]) ++s;
  const int rows = grp.rows[s];
  const int e = blockIdx.y / m_tiles;
  const int m0 = (blockIdx.y % m_tiles) * w8w::BM, n0 = (tile - grp.tile0[s]) * w8w::BN;
  const int tbeg = blockIdx.z * k_steps;
  float acc[w8w::MT][w8w::NT][4];
  w8w::mainloop(A + static_cast<size_t>(e) * C * K,
                codes + (static_cast<size_t>(e) * total + grp.start[s]) * K, C, rows, K,
                m0, n0, tbeg, tbeg + k_steps, grp.scale[e * MAX_SEC + s], smem, acc);
  w8w::for_each_pair(acc, m0, n0, [&](int m, int n, float c0, float c1) {
    if (m < C && n < rows) store_pair(grp, s, partial, E, C, total, e, m, n, c0, c1);
  });
}

// Four columns a thread: sections start at multiples of 64 and their rows
// are multiples of 8, so the four lie in one section and are all real or
// all padding.  Each sum is Kernel B's: 0 + split 0 + split 1 + ...
__global__ void sum_grouped_partials(const float* __restrict__ partial,
                                     Groups grp, int E, int C, int total,
                                     int splits) {
  const size_t emn = static_cast<size_t>(E) * C * total;
  const size_t i = (static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x) * 4;
  if (i >= emn) return;
  const size_t em = i / total;                  // e * C + m
  const int col = static_cast<int>(i % total);
  const int s = section_of(grp, col);
  const int n = col - grp.start[s];
  if (n >= grp.rows[s]) return;                 // padded rows: never written
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int z = 0; z < splits; ++z) {
    const float4 p = *reinterpret_cast<const float4*>(partial + z * emn + i);
    acc.x += p.x;
    acc.y += p.y;
    acc.z += p.z;
    acc.w += p.w;
  }
  const __nv_bfloat162 lo = __floats2bfloat162_rn(acc.x, acc.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(acc.z, acc.w);
  uint2 v;
  v.x = *reinterpret_cast<const uint32_t*>(&lo);
  v.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(grp.out[s] + em * grp.rows[s] + n) = v;
}

}  // namespace

// a: the site image (E, C, K) bf16.  rows / padded: n_sec host values
// (n_sec <= 4; padded rows multiples of 64, rows multiples of 8); tile0:
// n_sec + 1 host values, the prefix of ceil(rows_i / 256) (the wide tiles,
// used above 64 rows); scales: E * n_sec host values, group-major; outs:
// n_sec (E, C, rows_i) bf16.  partial: f32 (splits, E, C, sum padded)
// scratch when splits > 1.  K is a multiple of 128 * splits.
extern "C" int w8_grouped(const void* a, const void* codes, void* partial,
                          const int* rows, const int* padded, const int* tile0,
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
  for (int i = 0; i <= n_sec; ++i) grp.tile0[i] = tile0[i];
  for (int e = 0; e < E; ++e)
    for (int i = 0; i < n_sec; ++i) grp.scale[e * MAX_SEC + i] = scales[e * n_sec + i];
  const int k_chunk = K / splits;
  float* p = splits > 1 ? static_cast<float*>(partial) : nullptr;
  const auto* A = static_cast<const __nv_bfloat16*>(a);
  const auto* W = static_cast<const uint8_t*>(codes);
  if (C > 64) {
    static int allowed = 0;  // dynamic shared memory above 48 KB, raised once
    if (allowed < w8w::SMEM) {
      cudaError_t err = cudaFuncSetAttribute(
          w8_grouped128_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, w8w::SMEM);
      if (err != cudaSuccess) return static_cast<int>(err);
      allowed = w8w::SMEM;
    }
    const int m_tiles = (C + w8w::BM - 1) / w8w::BM;
    dim3 grid(grp.tile0[n_sec], E * m_tiles, splits);
    w8_grouped128_kernel<<<grid, w8w::THREADS, w8w::SMEM, st>>>(
        A, W, grp, p, E, C, total, K, k_chunk / w8w::BK, m_tiles);
  } else if (w8::block_m(C) == 16) {
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
  const size_t quads = static_cast<size_t>(E) * C * total / 4;
  sum_grouped_partials<<<static_cast<unsigned>((quads + 255) / 256), 256, 0, st>>>(
      p, grp, E, C, total, splits);
  return static_cast<int>(cudaGetLastError());
}
