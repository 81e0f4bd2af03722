// Stacked split-plane GEMM: every consumer of one activation site at once.
//
// Replaces micromix_tpu/kernels/mixed_matmul.py::mixed_matmul_sp_stack
// (_sp_stack_kernel), together with the site kernel (site_fakequant.cu)
// that the wrapper launches first: Y_i (M, N_i) = img (M, K) bf16 .
// dq(W_i)^T for the sections i of one split-plane SplitPlaneStack (q|k|v,
// gate|up; o and down as single sections), each section's rows padded
// with zero codes and zero scale bytes.
//
// Bound on the H100: bytes at decode M: the stacked codes and scales
// (gate|up 28672 x 4096 at 2432 bytes a row, 69.7 MB, 20.8 us at
// 3.35 TB/s; q|k|v 14.9 MB, 4.5 us).
//
// Design: Kernel F's (w8_stack.cu) section ownership on the tile of
// sp_tile.cuh (BM = 16, 64 or 128 rows, sp::block_m): 64-row strips (128
// beside 128 rows) of the stacked arrays, each section padded to a
// multiple of 128 rows, so a strip lies in one section; the block reads
// its section from the strip index and writes only that section's true
// rows.  A is the site image, read as bf16.  K is split over gridDim.z as
// the wrapper asks (the same split as Kernel K for the same M and K) and
// the partials summed in a fixed order, so each section's output equals
// Kernel K's on the codes the image encodes, bit for bit (the JAX
// package's fakequant-direct equivalence).

#include "sp_tile.cuh"

namespace {

constexpr int MAX_SEC = 4;

struct Sections {
  int n;
  int start[MAX_SEC];   // first stacked row, a multiple of BN
  int rows[MAX_SEC];    // true rows: the width of the section's output
  __nv_bfloat16* out[MAX_SEC];
};

__device__ __forceinline__ int section_of(const Sections& s, int row) {
  int i = 0;
  while (i + 1 < s.n && row >= s.start[i + 1]) ++i;
  return i;
}

// The operand's arrays advanced to stacked row `row`.
__device__ __forceinline__ sp::Operand rows_from(const sp::Operand& w,
                                                 const sp::Segs& s, int row) {
  sp::Operand o;
  for (int seg = 0; seg < 3; ++seg) {
    const int width = sp::seg_width(s, seg);
    o.c[seg] = w.c[seg] + static_cast<size_t>(row) * (seg == 0 ? width / 2 : width);
    o.s[seg] = w.s[seg] + static_cast<size_t>(row) * (width / 32);
  }
  return o;
}

template <int BM>
__global__ void __launch_bounds__(sp::Tile<BM>::THREADS)
sp_stack_kernel(const __nv_bfloat16* __restrict__ A, sp::Operand w, sp::Segs s,
                Sections sec, float* __restrict__ partial, int M, int total,
                int t_chunk) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int n0 = blockIdx.x * sp::Tile<BM>::BN, m0 = blockIdx.y * BM;
  const int tbeg = blockIdx.z * t_chunk;
  const int si = section_of(sec, n0);
  const int start = sec.start[si], rows = sec.rows[si];
  const int local0 = n0 - start;
  const sp::Operand ws = rows_from(w, s, start);
  float acc[sp::Tile<BM>::MT][sp::Tile<BM>::NT][4];
  sp::mainloop<BM>(A, M, m0, ws, smem, s, rows, local0, tbeg, tbeg + t_chunk, acc);
  __nv_bfloat16* out = sec.out[si];
  sp::for_each_pair<BM>(acc, m0, local0, [&](int m, int n, float c0, float c1) {
    if (m >= M || n >= rows) return;
    if (partial == nullptr) {
      *reinterpret_cast<__nv_bfloat162*>(out + static_cast<size_t>(m) * rows + n) =
          __floats2bfloat162_rn(c0, c1);
    } else {
      float* p = partial + (static_cast<size_t>(blockIdx.z) * M + m) * total + start + n;
      *reinterpret_cast<float2*>(p) = make_float2(c0, c1);
    }
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

template <int BM>
cudaError_t launch_stack(const __nv_bfloat16* A, const sp::Operand& w, const sp::Segs& s,
                         const Sections& sec, float* p, int M, int total, int splits,
                         cudaStream_t st) {
  static int allowed = 0;
  const int smem = sp::tile_smem<BM>(s);
  constexpr int BN = sp::Tile<BM>::BN;
  cudaError_t err = sp::allow_dynamic_smem(sp_stack_kernel<BM>, smem, allowed);
  if (err != cudaSuccess) return err;
  dim3 grid(total / BN, (M + BM - 1) / BM, splits);
  sp_stack_kernel<BM><<<grid, sp::Tile<BM>::THREADS, smem, st>>>(A, w, s, sec, p, M, total,
                                                      s.steps() / splits);
  return cudaGetLastError();
}

}  // namespace

// w: 6 pointers, the stacked codes of the fp4 (packed), fp6, fp8 segments
// then their scales; rows / padded / outs: n_sec host values (n_sec <= 4),
// padded rows multiples of 128 (the widest strip) and rows even.  partial: f32
// (splits, M, sum padded) scratch when splits > 1, else unused.
extern "C" int sp_stack(const void* a, const void* const* w, void* partial,
                        const int* rows, const int* padded, void* const* outs,
                        int n_sec, int M, int k4, int k6, int k8, int fp4_only,
                        int splits, void* stream) {
  if (n_sec < 1 || n_sec > MAX_SEC) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Sections sec{};
  sec.n = n_sec;
  int total = 0;
  for (int i = 0; i < n_sec; ++i) {
    sec.start[i] = total;
    sec.rows[i] = rows[i];
    sec.out[i] = static_cast<__nv_bfloat16*>(outs[i]);
    total += padded[i];
  }
  sp::Operand wo;
  for (int i = 0; i < 3; ++i) {
    wo.c[i] = static_cast<const uint8_t*>(w[i]);
    wo.s[i] = static_cast<const uint8_t*>(w[3 + i]);
  }
  const sp::Segs s{k4, k6, k8, fp4_only};
  float* p = splits > 1 ? static_cast<float*>(partial) : nullptr;
  const auto* A = static_cast<const __nv_bfloat16*>(a);
  const int bm = sp::block_m(M);
  cudaError_t err;
  if (bm == 16) err = launch_stack<16>(A, wo, s, sec, p, M, total, splits, st);
  else if (bm == 64) err = launch_stack<64>(A, wo, s, sec, p, M, total, splits, st);
  else err = launch_stack<128>(A, wo, s, sec, p, M, total, splits, st);
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const size_t mn = static_cast<size_t>(M) * total;
  sum_stack_partials<<<static_cast<unsigned>((mn + 255) / 256), 256, 0, st>>>(
      p, sec, M, total, splits);
  return static_cast<int>(cudaGetLastError());
}
