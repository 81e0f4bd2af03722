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
// from M in the hundreds (the prefill chunks of 129-511 rows that reach
// it).
//
// Design: a first launch decodes the activation codes once into their
// bf16 image (M, K) in scratch, so no block decodes A again; then the tile
// of sp_tile.cuh (Kernel L's, on that image): a block of 4 warps on a
// 64-row strip of W and BM = 16 or 64 rows of A, or of 8 warps on 128 x
// 128, the weight decoded with integer ops and a bf16x2 scale multiply at
// every 128-column step, a cp.async ring, mma.sync bf16 with f32
// accumulation.  K is split over gridDim.z as the wrapper asks
// (sp_split_k: a function of M and K only, so that Kernel L, given the
// same M and K, sums every output in the same order); a last kernel adds
// the f32 partials in a fixed order.  The output is bf16 (each sum rounded
// once) or f32 (a tensor-parallel rank's partial, summed over the ranks
// before its one round), stored by one template: the bf16 output is the
// f32 one rounded, bit for bit.

#include "sp_tile.cuh"

namespace {


// The activation codes -> their bf16 image in device order, 16 codes a
// thread (the decode of the weight tile; the activation's scale rows are
// read byte by byte).
__global__ void decode_codes(sp::Operand a, sp::Segs s, __nv_bfloat16* __restrict__ img,
                             int M) {
  const int K = s.k(), chunks = K / 16;
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<size_t>(M) * chunks) return;
  const int m = static_cast<int>(i / chunks), col = static_cast<int>(i % chunks) * 16;
  const int seg = col < s.k4 ? 0 : (col < s.k4 + s.k6 ? 1 : 2);
  const int width = sp::seg_width(s, seg), scol = col - sp::seg_offset(s, seg);
  const int nb = width / 32;
  const uint4 codes = *reinterpret_cast<const uint4*>(sp::pick(a.c, seg) +
                                                      static_cast<size_t>(m) * width + scol);
  const uint4 sc = sp::gather16(sp::pick(a.s, seg) + static_cast<size_t>(m) * nb, scol % nb, nb);
  uint32_t v[8];
  sp::decode16(codes, sc, seg, v);
  uint4* d = reinterpret_cast<uint4*>(img + static_cast<size_t>(m) * K + col);
  d[0] = make_uint4(v[0], v[1], v[2], v[3]);
  d[1] = make_uint4(v[4], v[5], v[6], v[7]);
}

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
__global__ void __launch_bounds__(sp::Tile<BM>::THREADS)
sp_gemm_kernel(const __nv_bfloat16* __restrict__ A, sp::Operand w, sp::Segs s,
               OutT* __restrict__ out, float* __restrict__ partial,
               int M, int N, int t_chunk) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int n0 = blockIdx.x * sp::Tile<BM>::BN, m0 = blockIdx.y * BM;
  const int tbeg = blockIdx.z * t_chunk;
  float acc[sp::Tile<BM>::MT][sp::Tile<BM>::NT][4];
  sp::mainloop<BM>(A, M, m0, w, smem, s, N, n0, tbeg, tbeg + t_chunk, acc);
  sp::for_each_pair<BM>(acc, m0, n0, [&](int m, int n, float c0, float c1) {
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
  float acc = 0.0f;
  for (int z = 0; z < splits; ++z) acc += partial[z * mn + i];
  store_one(out + i, acc);
}

template <int BM, typename OutT>
cudaError_t launch_gemm(const __nv_bfloat16* A, const sp::Operand& w, const sp::Segs& s,
                        OutT* Y, float* p, int M, int N, int splits,
                        cudaStream_t st) {
  static int allowed = 0;
  const int smem = sp::tile_smem<BM>(s);
  constexpr int BN = sp::Tile<BM>::BN;
  cudaError_t err = sp::allow_dynamic_smem(sp_gemm_kernel<BM, OutT>, smem, allowed);
  if (err != cudaSuccess) return err;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  sp_gemm_kernel<BM, OutT><<<grid, sp::Tile<BM>::THREADS, smem, st>>>(A, w, s, Y, p, M, N,
                                                             s.steps() / splits);
  return cudaGetLastError();
}

template <typename OutT>
int run(const __nv_bfloat16* img, const sp::Operand& wo, const sp::Segs& s, OutT* Y,
        float* p, int M, int N, int splits, cudaStream_t st) {
  cudaError_t err;
  const int bm = sp::block_m(M);
  if (bm == 16) err = launch_gemm<16>(img, wo, s, Y, p, M, N, splits, st);
  else if (bm == 64) err = launch_gemm<64>(img, wo, s, Y, p, M, N, splits, st);
  else err = launch_gemm<128>(img, wo, s, Y, p, M, N, splits, st);
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const size_t mn = static_cast<size_t>(M) * N;
  sum_partials<OutT><<<static_cast<unsigned>((mn + 255) / 256), 256, 0, st>>>(p, Y, mn, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a / w: 6 pointers each, codes of the fp4, fp6, fp8 segments then their
// scales (A: (M, kseg) codes; W: (N, k4/2) packed, (N, k6), (N, k8));
// image: bf16 (M, K) scratch for the decoded activation; partial: f32
// (splits, M, N) scratch when splits > 1, else unused; out: bf16 (M, N),
// or f32 when out_f32.
extern "C" int sp_gemm(const void* const* a, const void* const* w, void* image, void* out,
                       void* partial, int M, int N, int k4, int k6, int k8,
                       int fp4_only, int splits, int out_f32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  sp::Operand ao, wo;
  for (int i = 0; i < 3; ++i) {
    ao.c[i] = static_cast<const uint8_t*>(a[i]);
    ao.s[i] = static_cast<const uint8_t*>(a[3 + i]);
    wo.c[i] = static_cast<const uint8_t*>(w[i]);
    wo.s[i] = static_cast<const uint8_t*>(w[3 + i]);
  }
  const sp::Segs s{k4, k6, k8, fp4_only};
  auto* img = static_cast<__nv_bfloat16*>(image);
  const size_t chunks = static_cast<size_t>(M) * (s.k() / 16);
  decode_codes<<<static_cast<unsigned>((chunks + 255) / 256), 256, 0, st>>>(ao, s, img, M);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  float* p = splits > 1 ? static_cast<float*>(partial) : nullptr;
  if (out_f32) return run(img, wo, s, static_cast<float*>(out), p, M, N, splits, st);
  return run(img, wo, s, static_cast<__nv_bfloat16*>(out), p, M, N, splits, st);
}
