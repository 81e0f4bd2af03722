// Paged decode attention over the quantized KV cache (flash-decoding: the
// page list split over blocks, the tensor cores for both products), with
// q-side RoPE fused.
//
// Replaces micromix_tpu/serve/attention.py::paged_decode_attention
// (_decode_kernel), the whole function: int4 and int8 pages, a sliding
// window, a per-row ``lengths`` override and the (m, den) state.  q (B, H,
// D) bf16, unrotated when positions are given; pages are the JAX package's
// token-minor layout: codes (P, Hkv, dq, ps) u8 (int4: dq = D/2, dim i in
// the low nibble and dim i + D/2 in the high one; int8: dq = D), sz (P,
// Hkv, 2, ps) bf16 holding [scale, zero] per token; value = (c - zero) *
// scale.  Row b attends to positions [lo, n): n is the stored length of
// its sequence or lengths[b]; with a window, lo = positions[b] + 1 - window
// (the query's own position, as the JAX kernel takes it when RoPE is
// fused; the stored length without positions).  Output acc / max(den,
// 1e-30) in bf16, 0 for a row with nothing to attend; the state (m, den)
// is the max score (after q * 1/sqrt(D)) and the denominator, -1e30 and 0
// for such a row.
//
// Bound on the H100: bytes.  Each row reads every K/V code and [scale,
// zero] pair of its attended range once (D/2 + 4 bytes a token, head and
// K or V, for int4) and does about 4 operations per byte.
//
// Design.  Grid (Hkv, B, S): S splits of the page-table row, each of
// ``pps`` pages; the wrapper derives both from B, Hkv and
// max_pages_per_seq alone (never from lengths on the device), so the
// launch shape is fixed for a given cache and batch.  A block whose pages
// lie past the row's last page or wholly below the window floor exits at
// once: every block of the row derives the same range of non-empty splits
// from n, the position and the window, so none writes a neutral partial.
// A block of 4 warps holds the G = H / Hkv <= 8 query heads of its KV
// head: q is rotated in f32 from positions * inv_freq (cosf / sinf),
// scaled by 1/sqrt(D) and split into two bf16 terms (hi + lo, about 16
// bits), kept in registers as MMA fragments.  Pages arrive through a
// 2-stage cp.async ring (K and V codes 16 bytes a copy, rows XOR-swizzled
// by 16-byte chunk, and the [scale, zero] rows); each warp takes 16-token
// slices of the page and runs mma.sync m16n8k16 (bf16, f32 accumulators)
// with the heads as the 8 columns:
//   scores  S^T (16 tokens x 8 heads) = K Q^T, K's dims paired (m, m + D/2)
//           in each k pair, so one int4 code byte is one bf16x2 operand:
//           both nibbles as bf16 (128 + c), minus (128 + z) in bf16x2, the
//           exact integers c - z; then each score times its token's scale
//           in f32;
//   softmax the online max and denominator per head in f32 on the
//           accumulators (warp shuffles), p times V's token scale;
//   P.V     O^T (dims x 8 heads) += (V - z)^T P^T, P split into three bf16
//           terms (as Kernels E and H) and each slice's product added to
//           O in f32; V's A operand is two tokens' codes of one row, a
//           16-bit load.
// A page's per-token scales and zero points go to shared memory once, a
// masked token's (past n, below the floor) as 0, and it takes p = 0.  The
// block reads its page ids once, at the start; registers are capped at 128
// a thread so that 4 blocks share an SM (one wave of the 512-block grid
// at B = 8, 4096 tokens).  The warps' states merge in warp order at the
// end.  Combine: with one
// non-empty split the block writes the output itself; otherwise each
// block writes its f32 (acc, m, den) partial, and the last block of (b,
// kvh) by an atomic ticket (which it resets to 0 for the next launch)
// merges all partials in split order, so the result does not depend on
// which block finishes last.  At most 32 splits a row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ptx.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int HP = 8;                 // heads: the MMA's 8 columns
constexpr int PV_TERMS = 3;           // bf16 terms of P
constexpr int PT_LD = 12;             // row stride of a warp's P^T buffer
constexpr int MAX_SPLITS = 32;        // splits of a row the merge takes
constexpr float NEG = -1e30f;
constexpr float TWO23 = 8388608.0f;   // __uint_as_float(0x4B000000 | c) = 2^23 + c

struct Args {
  const __nv_bfloat16* q;
  const uint8_t* kc;
  const uint8_t* vc;
  const __nv_bfloat16* ksz;
  const __nv_bfloat16* vsz;
  const int* table;
  const int* seq_ids;
  const int* lengths;
  const int* positions;   // null: q is not rotated, the window floor is n
  const float* inv_freq;
  __nv_bfloat16* out;
  float* m_out;           // null: no state
  float* den_out;
  float* part_acc;        // (B, Hkv, S, G, D) f32
  float* part_md;         // (B, Hkv, S, G, 2) f32
  int* tickets;           // (B, Hkv), 0 between launches
  int lengths_per_row;
  int H, Hkv, D, ps, max_pages, pps, window;
  float scale;
};

// Shared memory, byte offsets: the ring (then, after the pages, the
// warps' states), q, the page's per-token scales and zero points, the
// warps' P^T buffers, the block's merged state, the split merge and the
// block's page ids.
struct Smem {
  int stage, ring, qs, tok, pt, st, bytes;
  __host__ __device__ Smem(int bits, int D, int ps, int pps) {
    const int dq = bits == 4 ? D / 2 : D;
    stage = 2 * dq * ps + 8 * ps;
    const int warps_state = WARPS * HP * (D + 2) * 4;
    ring = 2 * stage > warps_state ? 2 * stage : warps_state;
    qs = ring;
    tok = qs + HP * D * 4;
    pt = tok + 4 * ps * 4;
    st = pt + WARPS * 16 * PT_LD * 4;
    bytes = st + (2 * HP + 4) * 4 + 2 * MAX_SPLITS * HP * 4 + pps * 4;
  }
};

__device__ __forceinline__ float code_f(uint32_t c) {   // 2^23 + c, c < 2^23
  return __uint_as_float(0x4B000000u | c);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t hsub(uint32_t a, uint32_t b) {
  const __nv_bfloat162 d = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                   *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&d);
}

template <int BITS, int D>
__global__ void __launch_bounds__(THREADS, 4) decode_kernel(const Args a) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int HALF = D / 2;
  constexpr int DQ = BITS == 4 ? D / 2 : D;
  constexpr int KSTEPS = D / 16;       // 16 k indices a step: 8 dim pairs
  constexpr int MT = D / 16;           // 16-dim tiles of O^T
  const int kvh = blockIdx.x, b = blockIdx.y, split = blockIdx.z, S = gridDim.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int ps = a.ps;
  const int G = a.H / a.Hkv;
  const int nch = ps / 16;             // 16-byte chunks a code row (a power of two)
  const Smem L(BITS, D, ps, a.pps);

  const int seq = a.seq_ids[b];
  const int n = a.lengths[a.lengths_per_row ? b : seq];
  int npages = (n + ps - 1) / ps;
  if (npages > a.max_pages) npages = a.max_pages;
  const int wb = a.positions != nullptr ? a.positions[b] + 1 : n;
  const int lo = a.window > 0 ? wb - a.window : 0;   // first attended position
  const int p0 = lo > 0 ? lo / ps : 0;
  const int s_lo = p0 / a.pps;
  const int s_hi = npages > p0 ? (npages - 1) / a.pps : s_lo - 1;
  const int count = s_hi - s_lo + 1;                  // non-empty splits
  const size_t bk = static_cast<size_t>(b) * a.Hkv + kvh;
  const size_t head0 = static_cast<size_t>(b) * a.H + static_cast<size_t>(kvh) * G;

  if (count <= 0) {                 // nothing to attend: 0, state (-1e30, 0)
    if (split == 0) {
      for (int i = tid; i < G * D; i += THREADS) a.out[head0 * D + i] = __float2bfloat16_rn(0.0f);
      if (a.m_out != nullptr && tid < G) {
        a.m_out[head0 + tid] = NEG;
        a.den_out[head0 + tid] = 0.0f;
      }
    }
    return;
  }
  if (split < s_lo || split > s_hi) return;
  const int pbeg = max(split * a.pps, p0);
  const int pend = min((split + 1) * a.pps, npages);

  float* qs = reinterpret_cast<float*>(smem + L.qs);          // [HP][D]
  float* ksc = reinterpret_cast<float*>(smem + L.tok);        // [ps] K scale
  float* vsc = ksc + ps;                                       // [ps] V scale
  uint32_t* kzz = reinterpret_cast<uint32_t*>(vsc + ps);      // [ps] K zero
  __nv_bfloat16* vzb = reinterpret_cast<__nv_bfloat16*>(kzz + ps);  // [ps] V zero (int4)
  float* vzf = reinterpret_cast<float*>(kzz + ps);            // [ps] V zero (int8)
  float* pt = reinterpret_cast<float*>(smem + L.pt) + warp * 16 * PT_LD;
  float* m_s = reinterpret_cast<float*>(smem + L.st);
  float* den_s = m_s + HP;
  int* last_s = reinterpret_cast<int*>(den_s + HP);
  float* wts = reinterpret_cast<float*>(last_s + 4);
  float* dws = wts + MAX_SPLITS * HP;   // the split merge: [split][head]
  int* pids = reinterpret_cast<int*>(dws + MAX_SPLITS * HP);   // the block's page ids

  const int* trow = a.table + static_cast<size_t>(seq) * a.max_pages;
  for (int i = tid; i < pend - pbeg; i += THREADS) pids[i] = trow[pbeg + i];
  auto stage = [&](int st, int p) {
    const size_t ph = static_cast<size_t>(pids[p - pbeg]) * a.Hkv + kvh;
    const uint8_t* kp = a.kc + ph * DQ * ps;
    const uint8_t* vp = a.vc + ph * DQ * ps;
    uint8_t* kd = smem + st * L.stage;
    for (int c = tid; c < DQ * nch; c += THREADS) {
      const int r = c / nch, cc = c % nch;
      const int dst = r * ps + ((cc ^ (r & (nch - 1))) << 4);
      ptx::cp_async16(kd + dst, kp + static_cast<size_t>(c) * 16, true);
      ptx::cp_async16(kd + DQ * ps + dst, vp + static_cast<size_t>(c) * 16, true);
    }
    uint8_t* sd = kd + 2 * DQ * ps;
    const __nv_bfloat16* ks = a.ksz + ph * 2 * ps;
    const __nv_bfloat16* vs = a.vsz + ph * 2 * ps;
    for (int c = tid; c < ps / 4; c += THREADS) {
      ptx::cp_async16(sd + c * 16, ks + c * 8, true);
      ptx::cp_async16(sd + 4 * ps + c * 16, vs + c * 8, true);
    }
    ptx::cp_async_commit();
  };
  __syncthreads();
  stage(0, pbeg);

  // q rotated and scaled in f32, heads past G zero
  const __nv_bfloat16* qb = a.q + head0 * D;
  if (tid < D) {
    float c = 1.0f, s = 0.0f;
    if (a.positions != nullptr) {
      const float ang = static_cast<float>(a.positions[b]) * a.inv_freq[tid % HALF];
      c = cosf(ang);
      s = sinf(ang);
    }
    for (int h = 0; h < HP; ++h) {
      float v = 0.0f;
      if (h < G) {
        const float x = __bfloat162float(qb[h * D + tid]);
        if (a.positions != nullptr) {
          const float rot = tid < HALF ? -__bfloat162float(qb[h * D + tid + HALF])
                                       : __bfloat162float(qb[h * D + tid - HALF]);
          v = x * c + rot * s;
        } else {
          v = x;
        }
      }
      qs[h * D + tid] = v * a.scale;
    }
  }
  __syncthreads();
  // B fragments of Q^T: k pair 2 t4 (+8) of step kk is dims (m, m + D/2),
  // m = 8 kk + t4 (+4); column (head) g; two bf16 terms
  uint32_t qf[KSTEPS][2][2];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int m = 8 * kk + t4 + 4 * j;
      const float x = qs[g * D + m], y = qs[g * D + m + HALF];
      const __nv_bfloat162 hi = __floats2bfloat162_rn(x, y);
      qf[kk][0][j] = *reinterpret_cast<const uint32_t*>(&hi);
      qf[kk][1][j] = pack_bf16(x - __low2float(hi), y - __high2float(hi));
    }

  // this warp's state: heads 2 t4, 2 t4 + 1; O^T rows 16 mt + g (+8)
  float o[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 4; ++r) o[mt][r] = 0.0f;
  float m_w[2] = {NEG, NEG}, den_w[2] = {0.0f, 0.0f};

  for (int p = pbeg; p < pend; ++p) {
    const int st = (p - pbeg) & 1;
    ptx::cp_async_wait<0>();
    __syncthreads();      // page p landed; page p - 1 and its token arrays done
    if (p + 1 < pend) stage(st ^ 1, p + 1);
    const uint8_t* kp = smem + st * L.stage;
    const uint8_t* vp = kp + DQ * ps;
    if (tid < ps) {       // the page's tokens: scales, zero points; masked: 0
      const __nv_bfloat16* sz = reinterpret_cast<const __nv_bfloat16*>(vp + DQ * ps);
      const int pos = p * ps + tid;
      const bool ok = pos < n && pos >= lo;
      const float kz = ok ? __bfloat162float(sz[ps + tid]) : 0.0f;
      const float vz = ok ? __bfloat162float(sz[3 * ps + tid]) : 0.0f;
      ksc[tid] = ok ? __bfloat162float(sz[tid]) : 0.0f;
      vsc[tid] = ok ? __bfloat162float(sz[2 * ps + tid]) : 0.0f;
      if (BITS == 4) {
        kzz[tid] = pack_bf16(128.0f + kz, 128.0f + kz);
        vzb[tid] = __float2bfloat16_rn(128.0f + vz);
      } else {
        kzz[tid] = __float_as_uint(-(TWO23 + kz));
        vzf[tid] = -(TWO23 + vz);
      }
    }
    __syncthreads();

    for (int sl = warp; sl < nch; sl += WARPS) {   // 16-token slices
      const int t0 = sl * 16 + g, t1 = t0 + 8;    // this thread's score rows
      // ---- scores: S^T = (K - z) Q^T
      float c[4] = {0.0f, 0.0f, 0.0f, 0.0f}, cl[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      const uint32_t z0 = kzz[t0], z1 = kzz[t1];
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        uint32_t af[4];   // (row g, k 2t4..), (row g+8, ..), (row g, k 2t4+8..), (row g+8, ..)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int m = 8 * kk + t4 + 4 * j;
          const int off = ((sl ^ (m & (nch - 1))) << 4) + g;
          if (BITS == 4) {
            const uint32_t b0 = kp[m * ps + off], b1 = kp[m * ps + off + 8];
            af[2 * j] = hsub(0x43004300u | (b0 & 0xFu) | ((b0 & 0xF0u) << 12), z0);
            af[2 * j + 1] = hsub(0x43004300u | (b1 & 0xFu) | ((b1 & 0xF0u) << 12), z1);
          } else {
            const int m2 = m + HALF;
            const int off2 = ((sl ^ (m2 & (nch - 1))) << 4) + g;
            const float zf0 = __uint_as_float(z0), zf1 = __uint_as_float(z1);
            af[2 * j] = pack_bf16(code_f(kp[m * ps + off]) + zf0, code_f(kp[m2 * ps + off2]) + zf0);
            af[2 * j + 1] =
                pack_bf16(code_f(kp[m * ps + off + 8]) + zf1, code_f(kp[m2 * ps + off2 + 8]) + zf1);
          }
        }
        ptx::mma(c, af, qf[kk][0][0], qf[kk][0][1]);    // q's two terms in two
        ptx::mma(cl, af, qf[kk][1][0], qf[kk][1][1]);   // chains, summed after
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) c[r] += cl[r];
      // ---- online softmax: c[0], c[1] token t0, heads 2 t4, 2 t4 + 1; c[2], c[3] token t1
      const int pos0 = p * ps + t0, pos1 = p * ps + t1;
      const bool ok0 = pos0 < n && pos0 >= lo, ok1 = pos1 < n && pos1 >= lo;
      const float s[4] = {c[0] * ksc[t0], c[1] * ksc[t0], c[2] * ksc[t1], c[3] * ksc[t1]};
      float e[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = fmaxf(ok0 ? s[h] : NEG, ok1 ? s[2 + h] : NEG);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
        const float m_new = fmaxf(m_w[h], mx);
        const float corr = expf(m_w[h] - m_new);
        m_w[h] = m_new;
        e[h] = ok0 ? expf(s[h] - m_new) : 0.0f;
        e[2 + h] = ok1 ? expf(s[2 + h] - m_new) : 0.0f;
        den_w[h] = den_w[h] * corr + e[h] + e[2 + h];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          o[mt][h] *= corr;
          o[mt][2 + h] *= corr;
        }
      }
      // ---- P^T to the B layout: rows k = tokens 2 t4 (+1, +8, +9), column g
      pt[g * PT_LD + 2 * t4] = e[0] * vsc[t0];
      pt[g * PT_LD + 2 * t4 + 1] = e[1] * vsc[t0];
      pt[(g + 8) * PT_LD + 2 * t4] = e[2] * vsc[t1];
      pt[(g + 8) * PT_LD + 2 * t4 + 1] = e[3] * vsc[t1];
      __syncwarp();
      uint32_t pb[PV_TERMS][2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float x = pt[(2 * t4 + 8 * j) * PT_LD + g], y = pt[(2 * t4 + 8 * j + 1) * PT_LD + g];
#pragma unroll
        for (int i = 0; i < PV_TERMS; ++i) {
          const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
          pb[i][j] = *reinterpret_cast<const uint32_t*>(&h);
          x -= __low2float(h);
          y -= __high2float(h);
        }
      }
      __syncwarp();
      // ---- P.V: O^T += (V - z)^T P^T; A rows dims 16 mt + g (+8), k tokens
      // sl * 16 + 2 t4 (+1, +8, +9): two tokens of one code row a load
      const int j0 = sl * 16 + 2 * t4;
#pragma unroll
      for (int mt = 0; mt < (BITS == 4 ? MT / 2 : MT); ++mt) {
        uint32_t w[4];   // rows r, r + 8 x tokens j0, j0 + 8
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = 16 * mt + g + 8 * (i & 1);
          const int off = ((sl ^ (r & (nch - 1))) << 4) + 2 * t4 + 8 * (i >> 1);
          w[i] = *reinterpret_cast<const uint16_t*>(vp + r * ps + off);
        }
        if (BITS == 4) {
          const uint32_t vz0 = *reinterpret_cast<const uint32_t*>(vzb + j0);
          const uint32_t vz1 = *reinterpret_cast<const uint32_t*>(vzb + j0 + 8);
          uint32_t al[4], ah[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const uint32_t zz = i < 2 ? vz0 : vz1;
            al[i] = hsub(__byte_perm(w[i] & 0x0F0Fu, 0x43u, 0x4140), zz);
            ah[i] = hsub(__byte_perm((w[i] >> 4) & 0x0F0Fu, 0x43u, 0x4140), zz);
          }
          float tl[4] = {0.0f, 0.0f, 0.0f, 0.0f}, th[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
          for (int i = 0; i < PV_TERMS; ++i) {
            ptx::mma(tl, al, pb[i][0], pb[i][1]);
            ptx::mma(th, ah, pb[i][0], pb[i][1]);
          }
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            o[mt][r] += tl[r];
            o[mt + MT / 2][r] += th[r];
          }
        } else {
          uint32_t av[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int j = j0 + 8 * (i >> 1);
            av[i] = pack_bf16(code_f(w[i] & 0xFFu) + vzf[j], code_f(w[i] >> 8) + vzf[j + 1]);
          }
          float t[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
          for (int i = 0; i < PV_TERMS; ++i) ptx::mma(t, av, pb[i][0], pb[i][1]);
#pragma unroll
          for (int r = 0; r < 4; ++r) o[mt][r] += t[r];
        }
      }
    }
  }
  __syncthreads();        // the ring is free: the warps' states go there

  // the warps' states, merged in warp order: m, den, O^T per head
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    den_w[h] += __shfl_xor_sync(0xffffffffu, den_w[h], 4);
    den_w[h] += __shfl_xor_sync(0xffffffffu, den_w[h], 8);
    den_w[h] += __shfl_xor_sync(0xffffffffu, den_w[h], 16);
  }
  float* ws = reinterpret_cast<float*>(smem) + warp * HP * (D + 2);   // [HP][D + 2]
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      ws[(2 * t4 + (r & 1)) * (D + 2) + 16 * mt + g + 8 * (r >> 1)] = o[mt][r];
  if (g == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      ws[(2 * t4 + h) * (D + 2) + D] = m_w[h];
      ws[(2 * t4 + h) * (D + 2) + D + 1] = den_w[h];
    }
  }
  __syncthreads();
  float acc[HP];
#pragma unroll
  for (int h = 0; h < HP; ++h) acc[h] = 0.0f;
  if (tid < D) {
#pragma unroll
    for (int h = 0; h < HP; ++h) {
      if (h < G) {
        const float* wh = reinterpret_cast<const float*>(smem) + h * (D + 2);
        float mx = NEG;
        for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, wh[w * HP * (D + 2) + D]);
        float den = 0.0f;
        for (int w = 0; w < WARPS; ++w) {
          const float* ww = wh + w * HP * (D + 2);
          const float wt = expf(ww[D] - mx);
          den += ww[D + 1] * wt;
          acc[h] += ww[tid] * wt;
        }
        if (tid == 0) {
          m_s[h] = mx;
          den_s[h] = den;
        }
      }
    }
  }
  __syncthreads();

  if (count == 1) {       // the row's only split: write the result
    if (tid < D) {
#pragma unroll
      for (int h = 0; h < HP; ++h)
        if (h < G)
          a.out[(head0 + h) * D + tid] = __float2bfloat16_rn(acc[h] / fmaxf(den_s[h], 1e-30f));
    }
    if (a.m_out != nullptr && tid < G) {
      a.m_out[head0 + tid] = m_s[tid];
      a.den_out[head0 + tid] = den_s[tid];
    }
    return;
  }

  const size_t slot = bk * S + split;
  if (tid < D) {
#pragma unroll
    for (int h = 0; h < HP; ++h)
      if (h < G) a.part_acc[(slot * G + h) * D + tid] = acc[h];
  }
  if (tid < G) {
    a.part_md[(slot * G + tid) * 2] = m_s[tid];
    a.part_md[(slot * G + tid) * 2 + 1] = den_s[tid];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int t = atomicAdd(a.tickets + bk, 1);
    *last_s = t == count - 1;
    if (t == count - 1) a.tickets[bk] = 0;
  }
  __syncthreads();
  if (!*last_s) return;
  __threadfence();

  // the last block merges the partials in split order: the splits' (m,
  // den) staged in shared memory, the weights exp(m_s - m) by one thread a
  // head, then thread d sums its dim, eight loads in flight
  for (int i = tid; i < count * G; i += THREADS) {
    const size_t o2 = ((bk * S + s_lo + i / G) * G + i % G) * 2;
    wts[i] = __ldcg(a.part_md + o2);
    dws[i] = __ldcg(a.part_md + o2 + 1);
  }
  __syncthreads();
  if (tid < G) {
    float mx = NEG;
    for (int k = 0; k < count; ++k) mx = fmaxf(mx, wts[k * G + tid]);
    float den = 0.0f;
    for (int k = 0; k < count; ++k) {
      const float w = expf(wts[k * G + tid] - mx);
      wts[k * G + tid] = w;
      den += dws[k * G + tid] * w;
    }
    m_s[tid] = mx;
    den_s[tid] = den;
  }
  __syncthreads();
  if (tid < D) {
    const float* pa = a.part_acc + (bk * S + s_lo) * G * D + tid;
    for (int h = 0; h < G; ++h) {
      float ov = 0.0f;
#pragma unroll 8
      for (int k = 0; k < count; ++k)
        ov += __ldcg(pa + (static_cast<size_t>(k) * G + h) * D) * wts[k * G + h];
      a.out[(head0 + h) * D + tid] = __float2bfloat16_rn(ov / fmaxf(den_s[h], 1e-30f));
    }
  }
  if (a.m_out != nullptr && tid < G) {
    a.m_out[head0 + tid] = m_s[tid];
    a.den_out[head0 + tid] = den_s[tid];
  }
}

template <int BITS, int D>
int launch(const Args& a, int B, int splits, cudaStream_t stream) {
  if (splits > MAX_SPLITS || a.H / a.Hkv > HP) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = Smem(BITS, D, a.ps, a.pps).bytes;
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  // raise the kernel's shared memory limit on a device only when a launch
  // needs more than was set there: one driver call, not one a launch
  static int done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64 || done[dev] < smem) {
    err = cudaFuncSetAttribute(decode_kernel<BITS, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) done[dev] = smem;
  }
  dim3 grid(a.Hkv, B, splits);
  decode_kernel<BITS, D><<<grid, THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bits 4 or 8; D 64 or 128; ps in {16, 32, 64, 128}; H / Hkv <= 8;
// splits <= 32; window <= 0: none; positions / inv_freq null: no RoPE;
// lengths_per_row: lengths is (B,) (the override) rather than the cache's
// per-sequence lengths; m_out / den_out null: no state.  Zero points are
// integers (kv_quantize rounds them).  part_acc (B, Hkv, splits, G, D) and
// part_md (B, Hkv, splits, G, 2) f32 scratch; tickets (B, Hkv) int32, zero
// before the launch and left zero after it.
extern "C" int paged_decode(const void* q, const void* kc, const void* vc,
                            const void* ksz, const void* vsz, const void* table,
                            const void* seq_ids, const void* lengths,
                            int lengths_per_row, const void* positions,
                            const void* inv_freq, void* out, void* m_out,
                            void* den_out, void* part_acc, void* part_md,
                            void* tickets, int B, int H, int Hkv, int D, int ps,
                            int max_pages, int bits, int window, int splits,
                            int pps, float scale, void* stream) {
  Args a{static_cast<const __nv_bfloat16*>(q), static_cast<const uint8_t*>(kc),
         static_cast<const uint8_t*>(vc), static_cast<const __nv_bfloat16*>(ksz),
         static_cast<const __nv_bfloat16*>(vsz), static_cast<const int*>(table),
         static_cast<const int*>(seq_ids), static_cast<const int*>(lengths),
         static_cast<const int*>(positions), static_cast<const float*>(inv_freq),
         static_cast<__nv_bfloat16*>(out), static_cast<float*>(m_out),
         static_cast<float*>(den_out), static_cast<float*>(part_acc),
         static_cast<float*>(part_md), static_cast<int*>(tickets), lengths_per_row,
         H, Hkv, D, ps, max_pages, pps, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bits == 4 && D == 128) return launch<4, 128>(a, B, splits, s);
  if (bits == 4 && D == 64) return launch<4, 64>(a, B, splits, s);
  if (bits == 8 && D == 128) return launch<8, 128>(a, B, splits, s);
  if (bits == 8 && D == 64) return launch<8, 64>(a, B, splits, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
