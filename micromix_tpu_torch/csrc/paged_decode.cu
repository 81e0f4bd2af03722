// Paged decode attention over the quantized KV cache (flash-decoding: the
// page list split over blocks, the tensor cores for both products), with
// q-side RoPE fused.
//
// Replaces micromix_tpu/serve/attention.py::paged_decode_attention
// (_decode_kernel), the whole function: int4, int8 and bf16 pages, a
// sliding window, a per-row ``lengths`` override and the (m, den) state.
// q (B, H, D) bf16, unrotated when positions are given; pages are the JAX
// package's token-minor layout: codes (P, Hkv, dq, ps) u8 (int4: dq = D/2,
// dim i in the low nibble and dim i + D/2 in the high one; int8: dq = D),
// sz (P, Hkv, 2, ps) bf16 holding [scale, zero] per token; value = (c -
// zero) * scale.  bf16 pages (bits 16) hold the values, (P, Hkv, D, ps)
// bf16, and their sz pages are not read (nor are they by the JAX kernel).  Row b attends to positions [lo, n): n is the stored length of
// its sequence or lengths[b]; with a window, lo = positions[b] + 1 - window
// (the query's own position, as the JAX kernel takes it when RoPE is
// fused; the stored length without positions).  Output acc / max(den,
// 1e-30) in bf16, 0 for a row with nothing to attend; the state (m, den)
// is the max score (after q * 1/sqrt(D)) and the denominator, -1e30 and 0
// for such a row.
//
// Bound on the H100: bytes.  Each row reads every K/V code and [scale,
// zero] pair of its attended range once (D/2 + 4 bytes a token, head and
// K or V, for int4; 2 D for bf16) and does about 4 operations per byte.
//
// Head dims and groups.  Any even D up to 256: the kernel is instantiated
// at a padded width DP of 64, 128 or 256 (the least that holds D).  A
// stage holds the code rows of DP dims, the rows past the true width
// zeroed once, and the Q fragments of dim pairs (m, m + D/2) with m >=
// D/2 are zero, so the padding adds nothing to a score; O^T's padded rows
// are never stored.  1/sqrt(D), the nibble and RoPE pairs, the page
// strides and the output take the true D.  Any G = H / Hkv up to 64: the
// heads of a KV head go in groups of 8 (the MMA's columns), one block a
// group, each with its own partials and tickets; every group reads the
// same pages (L2 takes most of the repeat).  Where two stages of a page
// do not fit in shared memory (bf16 pages of 128 tokens at DP = 256: 128
// KiB a stage) the ring has one stage, and a page's copy waits for the
// last one's compute.
//
// Page sizes 16, 32, 64 and 128, and every multiple of 128 up to 1024 (the
// JAX kernel's pages on its chip, page_size % 128 == 0).  A page of more
// than 128 tokens is walked as ps / 128 ring stages of 128 tokens each: a
// stage holds the same slice of every code row and of the [scale, zero]
// rows, so a stage, the ring's two stages and the per-token buffers stay
// at their size for 128-token pages, and each stage keeps the 16-byte
// chunk swizzle over a power-of-two row.  Stages wholly below the window
// floor or past the row's length are not loaded.  Pages of up to 128
// tokens are one stage a page, as before, in their own instantiation
// (STAGED false), which compiles to the code of one stage a page.
//
// Design.  Grid (Hkv x head groups, B, S): S splits of the page-table
// row, each of ``pps`` pages; the wrapper derives both from B, the heads
// and max_pages_per_seq alone (never from lengths on the device), so the
// launch shape is fixed for a given cache and batch.  A block whose pages
// lie past the row's last page or wholly below the window floor exits at
// once: every block of the row derives the same range of non-empty splits
// from n, the position and the window, so none writes a neutral partial.
// A block of 4 warps holds up to 8 query heads of its KV head: q is
// rotated in f32 from positions * inv_freq (cosf / sinf), scaled by
// 1/sqrt(D) and split into two bf16 terms (hi + lo, about 16
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
// bf16 pages: a row of a page is 2 ps bytes, swizzled by the same 16-byte
// chunks (8 tokens); the A operands are the values themselves (two dims
// of one token for the scores, two tokens of one dim for P.V, a 32-bit
// load), with every scale 1.
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
// which block finishes last.  At most 32 splits a row.  Registers are
// capped at 128 a thread at DP = 64 and 128; at DP = 256 (O^T and Q's
// fragments alone take 128) at 255, two blocks an SM.

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
  int* tickets;           // (B, Hkv, head groups), 0 between launches
  int lengths_per_row;
  int H, Hkv, D, ps, max_pages, pps, window;
  float scale;
};

constexpr int SMEM_MAX = 227 * 1024;  // the opt-in limit of a block
constexpr int STAGE_TOKENS = 128;     // tokens a ring stage holds at most

// tokens a ring stage holds: the whole page up to 128, else 128
__host__ __device__ __forceinline__ int stage_tokens(int ps) {
  return ps < STAGE_TOKENS ? ps : STAGE_TOKENS;
}

// Shared memory, byte offsets: the ring of ``stages`` stages (then, after
// the pages, the warps' states), q, the stage's per-token scales and zero
// points, the warps' P^T buffers, the block's merged state, the split
// merge and the block's page ids.  D is the padded width DP, ps the tokens
// of a stage (``stage_tokens``).
struct Smem {
  int stage, stages, ring, qs, tok, pt, st, bytes;
  __host__ __device__ Smem(int bits, int D, int ps, int pps) {
    const int dq = bits == 4 ? D / 2 : D;
    const int rb = bits == 16 ? 2 * ps : ps;     // bytes a code row
    stage = 2 * dq * rb + (bits == 16 ? 0 : 8 * ps);
    const int warps_state = WARPS * HP * (D + 2) * 4;
    const int rest = HP * D * 4 + 4 * ps * 4 + WARPS * 16 * PT_LD * 4 + (2 * HP + 4) * 4 +
                     2 * MAX_SPLITS * HP * 4 + pps * 4;
    stages = 2 * stage + rest <= SMEM_MAX ? 2 : 1;
    ring = stages * stage > warps_state ? stages * stage : warps_state;
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

template <int BITS, int DP, bool STAGED>
__global__ void __launch_bounds__(THREADS, DP == 256 ? 2 : 4) decode_kernel(const Args a) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int DQP = BITS == 4 ? DP / 2 : DP;   // code rows a stage holds
  constexpr int KSTEPS = DP / 16;      // 16 k indices a step: 8 dim pairs
  constexpr int MT = DP / 16;          // 16-row tiles of O^T
  const int D = a.D, HALF = D / 2;
  const int DQ = BITS == 4 ? HALF : D; // code rows a page
  const int G = a.H / a.Hkv, NG = (G + HP - 1) / HP;
  const int kvh = blockIdx.x / NG, hg = blockIdx.x % NG;
  const int GB = min(HP, G - hg * HP); // this block's heads
  const int b = blockIdx.y, split = blockIdx.z, S = gridDim.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int PS = a.ps;                 // tokens a page
  const int ps = STAGED ? STAGE_TOKENS : PS;   // tokens a stage
  const int sub = STAGED ? PS / STAGE_TOKENS : 1;   // stages a page
  const int rb = BITS == 16 ? 2 * ps : ps;   // bytes a stage's code row
  const int rbp = sub * rb;            // bytes a page's code row
  const int nch = rb / 16;             // 16-byte chunks a code row (a power of two)
  const int nsl = ps / 16;             // 16-token slices a stage
  const Smem L(BITS, DP, ps, a.pps);

  const int seq = a.seq_ids[b];
  const int n = a.lengths[a.lengths_per_row ? b : seq];
  int npages = (n + PS - 1) / PS;
  if (npages > a.max_pages) npages = a.max_pages;
  const int wb = a.positions != nullptr ? a.positions[b] + 1 : n;
  const int lo = a.window > 0 ? wb - a.window : 0;   // first attended position
  const int p0 = lo > 0 ? lo / PS : 0;
  const int s_lo = p0 / a.pps;
  const int s_hi = npages > p0 ? (npages - 1) / a.pps : s_lo - 1;
  const int count = s_hi - s_lo + 1;                  // non-empty splits
  // the (row, KV head, head group) of this block: its ticket and partials
  const size_t bk = (static_cast<size_t>(b) * a.Hkv + kvh) * NG + hg;
  const size_t head0 = static_cast<size_t>(b) * a.H + static_cast<size_t>(kvh) * G + hg * HP;
  // row R of O^T -> its dim, -1 for a padded row: int4 rows [0, DP/2) are
  // the code rows' low nibbles (dim R), rows [DP/2, DP) their high ones
  // (dim R - DP/2 + D/2)
  auto dim_of = [&](int R) -> int {
    if (BITS == 4) {
      const int r = R < DP / 2 ? R : R - DP / 2;
      return r >= HALF ? -1 : R < DP / 2 ? r : r + HALF;
    }
    return R < D ? R : -1;
  };

  if (count <= 0) {                 // nothing to attend: 0, state (-1e30, 0)
    if (split == 0) {
      for (int i = tid; i < GB * D; i += THREADS) a.out[head0 * D + i] = __float2bfloat16_rn(0.0f);
      if (a.m_out != nullptr && tid < GB) {
        a.m_out[head0 + tid] = NEG;
        a.den_out[head0 + tid] = 0.0f;
      }
    }
    return;
  }
  if (split < s_lo || split > s_hi) return;
  const int pbeg = max(split * a.pps, p0);
  const int pend = min((split + 1) * a.pps, npages);
  // the split's stages: its pages' stages from the one holding the window
  // floor to the one holding the row's last token (its pages' all, one a
  // page, at pages of up to 128 tokens)
  const int qbeg = STAGED ? max(pbeg * sub, lo > 0 ? lo / ps : 0) : pbeg;
  const int qend = STAGED ? min(pend * sub, (n + ps - 1) / ps) : pend;

  float* qs = reinterpret_cast<float*>(smem + L.qs);          // [HP][DP]
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
  // code rows [DQ, DQP) of K and V in every stage: zero for the whole loop
  for (int st = 0; st < L.stages; ++st)
    for (int i = tid * 16; i < 2 * (DQP - DQ) * rb; i += THREADS * 16) {
      const int kv = i / ((DQP - DQ) * rb), rem = i % ((DQP - DQ) * rb);
      *reinterpret_cast<uint4*>(smem + st * L.stage + (kv * DQP + DQ) * rb + rem) =
          make_uint4(0u, 0u, 0u, 0u);
    }
  // stage q (stage q % sub of page q / sub) into ring slot st
  auto stage = [&](int st, int q) {
    const int p = STAGED ? q / sub : q, s0 = STAGED ? q - p * sub : 0;
    const size_t ph = static_cast<size_t>(pids[p - pbeg]) * a.Hkv + kvh;
    const uint8_t* kp = a.kc + ph * DQ * rbp + s0 * rb;
    const uint8_t* vp = a.vc + ph * DQ * rbp + s0 * rb;
    uint8_t* kd = smem + st * L.stage;
    for (int c = tid; c < DQ * nch; c += THREADS) {
      const int r = c / nch, cc = c % nch;
      const int dst = r * rb + ((cc ^ (r & (nch - 1))) << 4);
      const size_t src = STAGED ? static_cast<size_t>(r) * rbp + cc * 16
                                : static_cast<size_t>(c) * 16;
      ptx::cp_async16(kd + dst, kp + src, true);
      ptx::cp_async16(kd + DQP * rb + dst, vp + src, true);
    }
    if (BITS == 16) {       // no [scale, zero] pages
      ptx::cp_async_commit();
      return;
    }
    // the stage's scales, then its zero points: 16 bytes (8 tokens) a copy
    uint8_t* sd = kd + 2 * DQP * ps;
    const __nv_bfloat16* ks = a.ksz + ph * 2 * PS + s0 * ps;
    const __nv_bfloat16* vs = a.vsz + ph * 2 * PS + s0 * ps;
    for (int c = tid; c < ps / 4; c += THREADS) {
      const int src = STAGED ? (c / (ps / 8)) * PS + (c % (ps / 8)) * 8 : c * 8;
      ptx::cp_async16(sd + c * 16, ks + src, true);
      ptx::cp_async16(sd + 4 * ps + c * 16, vs + src, true);
    }
    ptx::cp_async_commit();
  };
  __syncthreads();
  if (qbeg < qend) stage(0, qbeg);

  // q rotated and scaled in f32; heads past GB and dims past D zero
  const __nv_bfloat16* qb = a.q + head0 * D;
  for (int d = tid; d < DP; d += THREADS) {
    float c = 1.0f, s = 0.0f;
    if (a.positions != nullptr && d < D) {
      const float ang = static_cast<float>(a.positions[b]) * a.inv_freq[d % HALF];
      c = cosf(ang);
      s = sinf(ang);
    }
    for (int h = 0; h < HP; ++h) {
      float v = 0.0f;
      if (h < GB && d < D) {
        const float x = __bfloat162float(qb[h * D + d]);
        if (a.positions != nullptr) {
          const float rot = d < HALF ? -__bfloat162float(qb[h * D + d + HALF])
                                     : __bfloat162float(qb[h * D + d - HALF]);
          v = x * c + rot * s;
        } else {
          v = x;
        }
      }
      qs[h * DP + d] = v * a.scale;
    }
  }
  __syncthreads();
  // B fragments of Q^T: k pair 2 t4 (+8) of step kk is dims (m, m + D/2),
  // m = 8 kk + t4 (+4); column (head) g; two bf16 terms; zero for m >= D/2
  uint32_t qf[KSTEPS][2][2];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int m = 8 * kk + t4 + 4 * j;
      const bool in = m < HALF;
      const float x = in ? qs[g * DP + m] : 0.0f, y = in ? qs[g * DP + m + HALF] : 0.0f;
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
  // the k steps and O^T tiles that hold a real dim
  const int ksteps = (HALF + 7) / 8, mts = ((BITS == 4 ? HALF : D) + 15) / 16;

  for (int p = qbeg; p < qend; ++p) {   // p: a stage, ps tokens from p * ps
    const int st = L.stages == 2 ? (p - qbeg) & 1 : 0;
    ptx::cp_async_wait<0>();
    __syncthreads();      // stage p landed; stage p - 1 and its token arrays done
    if (L.stages == 2 && p + 1 < qend) stage(st ^ 1, p + 1);
    const uint8_t* kp = smem + st * L.stage;
    const uint8_t* vp = kp + DQP * rb;
    if (BITS == 16 && tid < ps) {   // the page's tokens: scale 1; masked: 0
      const int pos = p * ps + tid;
      const bool ok = pos < n && pos >= lo;
      ksc[tid] = ok ? 1.0f : 0.0f;
      vsc[tid] = ok ? 1.0f : 0.0f;
    } else if (tid < ps) {  // the page's tokens: scales, zero points; masked: 0
      const __nv_bfloat16* sz = reinterpret_cast<const __nv_bfloat16*>(vp + DQP * ps);
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

    // bf16 value of code row r, token j: chunk j / 8 of the swizzled row
    auto bf16_at = [&](const uint8_t* base, int r, int j) -> const uint8_t* {
      return base + r * rb + ((((j >> 3) ^ (r & (nch - 1)))) << 4) + 2 * (j & 7);
    };
    for (int sl = warp; sl < nsl; sl += WARPS) {   // 16-token slices
      const int t0 = sl * 16 + g, t1 = t0 + 8;    // this thread's score rows
      // ---- scores: S^T = (K - z) Q^T
      float c[4] = {0.0f, 0.0f, 0.0f, 0.0f}, cl[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      const uint32_t z0 = kzz[t0], z1 = kzz[t1];
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        if (kk >= ksteps) break;
        uint32_t af[4];   // (row g, k 2t4..), (row g+8, ..), (row g, k 2t4+8..), (row g+8, ..)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int m = 8 * kk + t4 + 4 * j;
          const int off = ((sl ^ (m & (nch - 1))) << 4) + g;
          if (BITS == 16) {
            const int m2 = m + HALF;
            af[2 * j] = *reinterpret_cast<const uint16_t*>(bf16_at(kp, m, t0)) |
                        (static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(
                             bf16_at(kp, m2, t0))) << 16);
            af[2 * j + 1] = *reinterpret_cast<const uint16_t*>(bf16_at(kp, m, t1)) |
                            (static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(
                                 bf16_at(kp, m2, t1))) << 16);
          } else if (BITS == 4) {
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
      // ---- P.V: O^T += (V - z)^T P^T; A rows 16 mt + g (+8), k tokens
      // sl * 16 + 2 t4 (+1, +8, +9): two tokens of one code row a load
      const int j0 = sl * 16 + 2 * t4;
#pragma unroll
      for (int mt = 0; mt < (BITS == 4 ? MT / 2 : MT); ++mt) {
        if (mt >= mts) break;
        if (BITS == 16) {   // rows r, r + 8 x tokens j0 (+1), j0 + 8 (+9): the values
          uint32_t av[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            av[i] = *reinterpret_cast<const uint32_t*>(
                bf16_at(vp, 16 * mt + g + 8 * (i & 1), j0 + 8 * (i >> 1)));
          float t[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
          for (int i = 0; i < PV_TERMS; ++i) ptx::mma(t, av, pb[i][0], pb[i][1]);
#pragma unroll
          for (int r = 0; r < 4; ++r) o[mt][r] += t[r];
          continue;
        }
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
    if (L.stages == 1 && p + 1 < qend) {   // one stage: the next one after this one
      __syncthreads();
      stage(0, p + 1);
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
  constexpr int WS = DP + 2;   // a head's row of a warp's state: O^T rows, m, den
  float* ws = reinterpret_cast<float*>(smem);   // [WARPS][HP][WS]
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      ws[(warp * HP + 2 * t4 + (r & 1)) * WS + 16 * mt + g + 8 * (r >> 1)] = o[mt][r];
  if (g == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      ws[(warp * HP + 2 * t4 + h) * WS + DP] = m_w[h];
      ws[(warp * HP + 2 * t4 + h) * WS + DP + 1] = den_w[h];
    }
  }
  __syncthreads();
  // per head: the block's max and denominator, and each warp's weight
  // exp(m_w - m) (in wts, free until the split merge)
  if (tid < GB) {
    float mx = NEG;
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, ws[(w * HP + tid) * WS + DP]);
    float den = 0.0f;
    for (int w = 0; w < WARPS; ++w) {
      const float wt = expf(ws[(w * HP + tid) * WS + DP] - mx);
      wts[w * HP + tid] = wt;
      den += ws[(w * HP + tid) * WS + DP + 1] * wt;
    }
    m_s[tid] = mx;
    den_s[tid] = den;
  }
  __syncthreads();
  auto acc_of = [&](int h, int R) {
    float acc = 0.0f;
    for (int w = 0; w < WARPS; ++w) acc += ws[(w * HP + h) * WS + R] * wts[w * HP + h];
    return acc;
  };

  if (count == 1) {       // the row's only split: write the result
    for (int R = tid; R < DP; R += THREADS) {
      const int d = dim_of(R);
      if (d < 0) continue;
      for (int h = 0; h < GB; ++h)
        a.out[(head0 + h) * D + d] = __float2bfloat16_rn(acc_of(h, R) / fmaxf(den_s[h], 1e-30f));
    }
    if (a.m_out != nullptr && tid < GB) {
      a.m_out[head0 + tid] = m_s[tid];
      a.den_out[head0 + tid] = den_s[tid];
    }
    return;
  }

  const size_t slot = bk * S + split;
  for (int R = tid; R < DP; R += THREADS) {
    const int d = dim_of(R);
    if (d < 0) continue;
    for (int h = 0; h < GB; ++h) a.part_acc[(slot * HP + h) * D + d] = acc_of(h, R);
  }
  if (tid < GB) {
    a.part_md[(slot * HP + tid) * 2] = m_s[tid];
    a.part_md[(slot * HP + tid) * 2 + 1] = den_s[tid];
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
  for (int i = tid; i < count * GB; i += THREADS) {
    const size_t o2 = ((bk * S + s_lo + i / GB) * HP + i % GB) * 2;
    wts[i] = __ldcg(a.part_md + o2);
    dws[i] = __ldcg(a.part_md + o2 + 1);
  }
  __syncthreads();
  if (tid < GB) {
    float mx = NEG;
    for (int k = 0; k < count; ++k) mx = fmaxf(mx, wts[k * GB + tid]);
    float den = 0.0f;
    for (int k = 0; k < count; ++k) {
      const float w = expf(wts[k * GB + tid] - mx);
      wts[k * GB + tid] = w;
      den += dws[k * GB + tid] * w;
    }
    m_s[tid] = mx;
    den_s[tid] = den;
  }
  __syncthreads();
  for (int d = tid; d < D; d += THREADS) {
    const float* pa = a.part_acc + (bk * S + s_lo) * HP * D + d;
    for (int h = 0; h < GB; ++h) {
      float ov = 0.0f;
#pragma unroll 8
      for (int k = 0; k < count; ++k)
        ov += __ldcg(pa + (static_cast<size_t>(k) * HP + h) * D) * wts[k * GB + h];
      a.out[(head0 + h) * D + d] = __float2bfloat16_rn(ov / fmaxf(den_s[h], 1e-30f));
    }
  }
  if (a.m_out != nullptr && tid < GB) {
    a.m_out[head0 + tid] = m_s[tid];
    a.den_out[head0 + tid] = den_s[tid];
  }
}

template <int BITS, int DP, bool STAGED>
int launch(const Args& a, int B, int splits, cudaStream_t stream) {
  if (splits > MAX_SPLITS || a.H / a.Hkv > 8 * HP) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = Smem(BITS, DP, stage_tokens(a.ps), a.pps).bytes;
  if (smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  // raise the kernel's shared memory limit on a device only when a launch
  // needs more than was set there: one driver call, not one a launch
  static int done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64 || done[dev] < smem) {
    err = cudaFuncSetAttribute(decode_kernel<BITS, DP, STAGED>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) done[dev] = smem;
  }
  const int ng = (a.H / a.Hkv + HP - 1) / HP;
  dim3 grid(a.Hkv * ng, B, splits);
  decode_kernel<BITS, DP, STAGED><<<grid, THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bits 4, 8 or 16; D even, 2 to 256; ps 16, 32, 64 or a multiple of 128 up
// to 1024; H / Hkv <=
// 64; splits <= 32; window <= 0: none; positions / inv_freq null: no RoPE;
// lengths_per_row: lengths is (B,) (the override) rather than the cache's
// per-sequence lengths; m_out / den_out null: no state.  Zero points are
// integers (kv_quantize rounds them).  With NG = ceil(G / 8) head groups,
// part_acc (B, Hkv, NG, splits, 8, D) and part_md (B, Hkv, NG, splits, 8,
// 2) f32 scratch; tickets (B, Hkv, NG) int32, zero before the launch and
// left zero after it.
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
  if (D < 2 || D > 256 || D % 2) return static_cast<int>(cudaErrorInvalidValue);
  if (ps < 16 || ps > 1024 || (ps <= STAGE_TOKENS ? (ps & (ps - 1)) : ps % STAGE_TOKENS))
    return static_cast<int>(cudaErrorInvalidValue);
  const int dp = D <= 64 ? 64 : D <= 128 ? 128 : 256;
#define MM_DECODE(BB, DD)                                              \
  if (bits == BB && dp == DD)                                          \
    return ps > STAGE_TOKENS ? launch<BB, DD, true>(a, B, splits, s)   \
                             : launch<BB, DD, false>(a, B, splits, s);
  MM_DECODE(4, 64)
  MM_DECODE(4, 128)
  MM_DECODE(4, 256)
  MM_DECODE(8, 64)
  MM_DECODE(8, 128)
  MM_DECODE(8, 256)
  MM_DECODE(16, 64)
  MM_DECODE(16, 128)
  MM_DECODE(16, 256)
#undef MM_DECODE
  return static_cast<int>(cudaErrorInvalidValue);
}
