// KV-cache append (Kernel D), two entry points.
//
// Replaces micromix_tpu/serve/append_kernel.py::append_kv_kernel
// (_append_kernel) and, with ``append_kv_quant``, the whole jitted program
// around it: micromix_tpu/serve/kv_cache.py::append_kv (kv_quantize of K
// and V, the slot index, the [scale, zero] stacks, the lengths max) and,
// on the decode path, the K-side RoPE the JAX runner fuses in front of it
// (micromix_tpu/serve/runner.py::_rope1).
//
// ``append_kv``: T pre-quantized token columns into their pages.  For each
// token t and KV head h it stores the K and V code rows kq/vq[t, h, :]
// (D/2 bytes for int4) and the [scale, zero] pairs at column off[t] of
// page page_id[t]:
//   k_codes[page_id[t], h, r, off[t]] = kq[t, h, r]   (and v, and the sz arrays)
// One thread per (token, head, row of codes or of sz).
//
// ``append_kv_quant``: the whole append of T tokens, k/v (T, H, D) bf16
// (rows of a token may sit at any token stride; heads and dims dense).
// For each (token, head) row, in f32, as the port's plain version:
//   with RoPE tables cos/sin (T, D) f32, K first becomes
//     kr = bf16(x cos + rot(x) sin),  rot(x) = [-x[D/2:], x[:D/2]],
//     each product rounded on its own (no FMA: __fmul_rn / __fadd_rn);
//   scale = max(gmax - gmin, 1e-5) * f32(1 / qmax)   (XLA's folded / qmax)
//   zero  = clamp(rint(-gmin / scale), 0, qmax)       (+0.0, never -0.0)
//   q     = clamp(rint(x / scale) + zero, 0, qmax)     (IEEE divisions)
// int4 packs dim i in a byte's low nibble and dim i + D/2 in its high one.
// Codes and [bf16(scale), bf16(zero)] go to column pos % ps of page
// page_table[seq, pos / ps]; lengths[seq] = max(lengths[seq], pos + 1) by
// atomicMax.  A row whose sequence, page index or page id lies outside the
// arrays is skipped.
//
// Bound on the H100: bytes (each K/V element is read once and a handful of
// f32 operations touch it; an append at decode moves a few KB, so there
// the launch is the cost).
//
// Design of ``append_kv_quant``.  Grid (ceil(T / 32), H, 2): a block takes
// 32 consecutive tokens of one head, of K or of V; 8 warps, each
// quantizing every 8th token of the block.  A warp holds one row, a lane
// the elements lane + 32 j, so a lane holds both halves of each int4 byte
// (D / 2 is a multiple of 32) and packs it itself; max and min come from
// xor shuffles, exact in any order.  A warp loads all its rows and their
// indices before it computes.  The codes are staged in shared memory in
// the page's own token-minor order (a row of 32 tokens, pitch 36 bytes so
// the warp's byte stores hit distinct banks), then stored: tokens of one
// sequence fill consecutive columns of a page, so a block whose 32 tokens
// form one such run from a 4-aligned column stores each code row as eight
// 4-byte words (one 32-byte sector from an aligned column), and any other
// block one byte per thread with neighbouring threads on neighbouring
// tokens.  Decode (T <= 32) and prefill take the same kernel and one
// launch.  On the H100 no single part of the work dominates
// (scripts/torch_append_ablation.py: loading the page-table entries
// early, one row a warp, multiplies for the divisions and no global
// stores each move a 1024-token append by at most 0.0015 ms).  Tokens
// that share a target can only be ones parked on the engine's scratch
// page, whose contents nothing reads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void append_kernel(uint8_t* __restrict__ kc, uint8_t* __restrict__ vc,
                              uint16_t* __restrict__ ksz, uint16_t* __restrict__ vsz,
                              const int* __restrict__ page_id,
                              const int* __restrict__ off,
                              const uint8_t* __restrict__ kq,
                              const uint8_t* __restrict__ vq,
                              const uint16_t* __restrict__ ksz_new,
                              const uint16_t* __restrict__ vsz_new, int T, int H,
                              int dq, int ps) {
  const int rows = dq + 2;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(T) * H * rows) return;
  const int t = static_cast<int>(i / (H * rows));
  const int rem = static_cast<int>(i % (H * rows));
  const int h = rem / rows, r = rem % rows;
  const size_t page = static_cast<size_t>(page_id[t]) * H + h;
  const int o = off[t];
  if (r < dq) {
    const size_t dst = (page * dq + r) * ps + o;
    const size_t src = (static_cast<size_t>(t) * H + h) * dq + r;
    kc[dst] = kq[src];
    vc[dst] = vq[src];
  } else {
    const int rr = r - dq;
    const size_t dst = (page * 2 + rr) * ps + o;
    const size_t src = (static_cast<size_t>(t) * H + h) * 2 + rr;
    ksz[dst] = ksz_new[src];
    vsz[dst] = vsz_new[src];
  }
}

constexpr int kRunTokens = 32;            // tokens a block takes
constexpr int kWarps = 8;
constexpr int kRowsPerWarp = kRunTokens / kWarps;
constexpr int kPitch = kRunTokens + 4;    // staged code row: 9 words

struct QuantArgs {
  uint8_t* kc;
  uint8_t* vc;
  __nv_bfloat16* ksz;
  __nv_bfloat16* vsz;
  const int* table;
  int* lengths;
  const int* seq_ids;
  const int* positions;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const float* cos;
  const float* sin;
  int T, H, ps, n_pages, max_pages, n_seqs, k_stride, v_stride;
  float recip;
};

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <int BITS, int D>
__global__ void __launch_bounds__(kWarps * 32)
append_quant_kernel(const QuantArgs a) {
  constexpr int NE = D / 32;                // elements a lane holds
  constexpr int DQ = BITS == 4 ? D / 2 : D;
  constexpr float QMAX = BITS == 4 ? 15.f : 255.f;
  __shared__ __align__(16) uint8_t stage[DQ * kPitch];
  __shared__ __nv_bfloat16 sz_s[2][kRunTokens];
  __shared__ int dst_page[kRunTokens], dst_col[kRunTokens];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t0 = blockIdx.x * kRunTokens, h = blockIdx.y;
  const bool is_v = blockIdx.z == 1;
  const bool rope = !is_v && a.cos != nullptr;
  const int n = min(kRunTokens, a.T - t0);

  // every row of this warp in flight at once: the elements, then the slot
  float xs[kRowsPerWarp][NE];
  int seq[kRowsPerWarp], pos[kRowsPerWarp];
#pragma unroll
  for (int u = 0; u < kRowsPerWarp; ++u) {
    const int i = warp + u * kWarps;
    if (i >= n) continue;
    const int t = t0 + i;
    const __nv_bfloat16* x =
        is_v ? a.v + static_cast<size_t>(t) * a.v_stride + h * D
             : a.k + static_cast<size_t>(t) * a.k_stride + h * D;
#pragma unroll
    for (int j = 0; j < NE; ++j) xs[u][j] = __bfloat162float(x[lane + 32 * j]);
    seq[u] = a.seq_ids[t];
    pos[u] = a.positions[t];
  }
#pragma unroll
  for (int u = 0; u < kRowsPerWarp; ++u) {
    const int i = warp + u * kWarps;
    if (i >= n) continue;
    const int t = t0 + i;
    float* x = xs[u];
    if (rope) {
      const float* c = a.cos + static_cast<size_t>(t) * D;
      const float* s = a.sin + static_cast<size_t>(t) * D;
#pragma unroll
      for (int j = 0; j < NE / 2; ++j) {
        const int e = lane + 32 * j, f = e + D / 2;
        const float lo = x[j], hi = x[j + NE / 2];
        x[j] = round_bf16(__fadd_rn(__fmul_rn(lo, c[e]), __fmul_rn(-hi, s[e])));
        x[j + NE / 2] = round_bf16(__fadd_rn(__fmul_rn(hi, c[f]), __fmul_rn(lo, s[f])));
      }
    }
    float mx = x[0], mn = x[0];
#pragma unroll
    for (int j = 1; j < NE; ++j) {
      mx = fmaxf(mx, x[j]);
      mn = fminf(mn, x[j]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, o));
    }
    const float scale = __fmul_rn(fmaxf(__fsub_rn(mx, mn), 1e-5f), a.recip);
    float z = rintf(__fdiv_rn(-mn, scale));
    z = z > 0.f ? fminf(z, QMAX) : 0.f;      // a rounded -0.0 becomes +0.0
    uint8_t q[NE];
#pragma unroll
    for (int j = 0; j < NE; ++j) {
      const float c = __fadd_rn(rintf(__fdiv_rn(x[j], scale)), z);
      q[j] = static_cast<uint8_t>(fminf(fmaxf(c, 0.f), QMAX));
    }
    if constexpr (BITS == 4) {
#pragma unroll
      for (int j = 0; j < NE / 2; ++j)
        stage[(lane + 32 * j) * kPitch + i] =
            static_cast<uint8_t>(q[j] | (q[j + NE / 2] << 4));
    } else {
#pragma unroll
      for (int j = 0; j < NE; ++j) stage[(lane + 32 * j) * kPitch + i] = q[j];
    }
    if (lane == 0) {
      const int sq = seq[u], p = pos[u];
      int page = -1;
      if (sq >= 0 && sq < a.n_seqs && p >= 0 && p / a.ps < a.max_pages) {
        page = a.table[static_cast<size_t>(sq) * a.max_pages + p / a.ps];
        if (page < 0 || page >= a.n_pages) page = -1;
      }
      sz_s[0][i] = __float2bfloat16_rn(scale);
      sz_s[1][i] = __float2bfloat16_rn(z);
      dst_page[i] = page;
      dst_col[i] = page >= 0 ? p % a.ps : 0;
      if (page >= 0 && !is_v && h == 0) atomicMax(a.lengths + sq, p + 1);
    }
  }
  __syncthreads();

  uint8_t* codes = is_v ? a.vc : a.kc;
  __nv_bfloat16* sz = is_v ? a.vsz : a.ksz;
  const int tid = threadIdx.x;
  const int p0 = dst_page[0], c0 = dst_col[0];
  const bool in_run = tid >= kRunTokens ||
                      (dst_page[tid] == p0 && dst_col[tid] == c0 + tid);
  const bool run = __syncthreads_and(in_run && n == kRunTokens && p0 >= 0 &&
                                     (c0 & 3) == 0 && (a.ps & 3) == 0);
  if (run) {
    constexpr int W = kRunTokens / 4;       // 4-byte words a code row
    const size_t base = (static_cast<size_t>(p0) * a.H + h) * DQ;
    for (int idx = tid; idx < DQ * W; idx += blockDim.x) {
      const int r = idx / W, w = idx % W;
      *reinterpret_cast<uint32_t*>(codes + (base + r) * a.ps + c0 + 4 * w) =
          *reinterpret_cast<const uint32_t*>(stage + r * kPitch + 4 * w);
    }
  } else {
    for (int idx = tid; idx < DQ * n; idx += blockDim.x) {
      const int r = idx / n, i = idx % n;
      const int p = dst_page[i];
      if (p >= 0)
        codes[((static_cast<size_t>(p) * a.H + h) * DQ + r) * a.ps + dst_col[i]] =
            stage[r * kPitch + i];
    }
  }
  for (int idx = tid; idx < 2 * n; idx += blockDim.x) {
    const int r = idx / n, i = idx % n;
    const int p = dst_page[i];
    if (p >= 0)
      sz[((static_cast<size_t>(p) * a.H + h) * 2 + r) * a.ps + dst_col[i]] = sz_s[r][i];
  }
}

template <int BITS, int D>
int launch_quant(const QuantArgs& a, cudaStream_t s) {
  const dim3 grid((a.T + kRunTokens - 1) / kRunTokens, a.H, 2);
  append_quant_kernel<BITS, D><<<grid, kWarps * 32, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int append_kv(void* kc, void* vc, void* ksz, void* vsz,
                         const void* page_id, const void* off, const void* kq,
                         const void* vq, const void* ksz_new, const void* vsz_new,
                         int T, int H, int dq, int ps, void* stream) {
  const long long total = static_cast<long long>(T) * H * (dq + 2);
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  append_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(kc), static_cast<uint8_t*>(vc),
      static_cast<uint16_t*>(ksz), static_cast<uint16_t*>(vsz),
      static_cast<const int*>(page_id), static_cast<const int*>(off),
      static_cast<const uint8_t*>(kq), static_cast<const uint8_t*>(vq),
      static_cast<const uint16_t*>(ksz_new), static_cast<const uint16_t*>(vsz_new),
      T, H, dq, ps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int append_kv_quant(void* kc, void* vc, void* ksz, void* vsz,
                               const void* table, void* lengths,
                               const void* seq_ids, const void* positions,
                               const void* k, const void* v, const void* cos,
                               const void* sin, int T, int H, int D, int ps,
                               int n_pages, int max_pages, int n_seqs,
                               int k_stride, int v_stride, int bits, float recip,
                               void* stream) {
  const QuantArgs a{static_cast<uint8_t*>(kc), static_cast<uint8_t*>(vc),
                    static_cast<__nv_bfloat16*>(ksz), static_cast<__nv_bfloat16*>(vsz),
                    static_cast<const int*>(table), static_cast<int*>(lengths),
                    static_cast<const int*>(seq_ids), static_cast<const int*>(positions),
                    static_cast<const __nv_bfloat16*>(k),
                    static_cast<const __nv_bfloat16*>(v),
                    static_cast<const float*>(cos), static_cast<const float*>(sin),
                    T, H, ps, n_pages, max_pages, n_seqs, k_stride, v_stride, recip};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bits == 4 && D == 128) return launch_quant<4, 128>(a, s);
  if (bits == 4 && D == 64) return launch_quant<4, 64>(a, s);
  if (bits == 8 && D == 128) return launch_quant<8, 128>(a, s);
  if (bits == 8 && D == 64) return launch_quant<8, 64>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
