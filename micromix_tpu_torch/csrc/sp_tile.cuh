// The split-plane GEMM tile shared by Kernels K (sp_gemm.cu) and L
// (sp_stack.cu): one block of 4 warps computes a BM x 64 tile of
// A (M, K) . dq(W)^T over its share of the K steps, in f32, where W is a
// split-plane MX weight:
//
//   fp4 segment  (N, k4/2) u8, byte j = device column j (low nibble) and
//                k4/2 + j (high nibble), both with scale block j % nb4
//                (nb4 = k4/32; k4/2 = 16 nb4, so the two columns share it);
//   fp6, fp8     (N, kseg) u8, one code a byte (FP4 codes when fp4_only),
//                device column c with scale block c % nb;
//   scales       UE8M0 bytes (N, kseg/32), value 2^(sf-127), byte 0 -> 0.0.
//
// The K axis runs in steps of 128 device columns: a fp4 step covers 64
// packed bytes, i.e. device columns [b0, b0+64) and [k4/2+b0, k4/2+b0+64)
// (k4 is a multiple of 128, so k4/2 is one of 64 and a step never splits
// a plane), then the fp6 and fp8 segments 128 columns at a time.  Each
// step decodes the weight codes to exact bf16 (code value times scale in
// f32, as micromix_tpu/mx/numerics.py decode does, then one exact bf16
// rounding), stores the A tile and the decoded W tile to shared memory and
// runs Kernel B's mma.sync m16n8k16 bf16 loop with f32 accumulation.  The
// weight's scale bytes for the block's 64 rows are staged in shared memory
// once (64 x K/32 bytes, at most 28 KB at K = 14336), 16 bytes a load.
//
// K's and L's blocks walk the same steps in the same order and mma shapes,
// so their f32 sums for one output element are the same operations: L's
// output on a site image equals K's on the codes that image encodes.

#pragma once

#include "w8_tile.cuh"

namespace sp {

using w8::BK;
using w8::BN;
using w8::PAD;
using w8::THREADS;

// Segment widths in device columns (multiples of 128), and the weight's
// grid (fp4_only: FP4 codes in all three segments).
struct Segs {
  int k4, k6, k8;
  int fp4_only;
  __host__ __device__ int k() const { return k4 + k6 + k8; }
  __host__ __device__ int steps() const { return k() / BK; }
  __host__ __device__ int nbt() const { return k() / 32; }
};

// One code and one scale array per segment, rows of width kseg (fp4:
// k4/2 packed bytes) and kseg / 32.
struct Operand {
  const uint8_t* c[3];
  const uint8_t* s[3];
};

// Step t: its segment, and c0, the packed byte offset b0 (fp4) or the
// column offset in the segment (fp6, fp8).
struct Step {
  int seg, c0;
};

__device__ __forceinline__ Step step_of(const Segs& s, int t) {
  const int t4 = s.k4 / BK, t6 = s.k6 / BK;
  if (t < t4) return {0, t * (BK / 2)};
  if (t < t4 + t6) return {1, (t - t4) * BK};
  return {2, (t - t4 - t6) * BK};
}

// Device column (in its segment) of tile column c of a step.
__device__ __forceinline__ int seg_col(const Segs& s, const Step& st, int c) {
  if (st.seg != 0) return st.c0 + c;
  return c < BK / 2 ? st.c0 + c : s.k4 / 2 + st.c0 + (c - BK / 2);
}

__device__ __forceinline__ int seg_width(const Segs& s, int seg) {
  return seg == 0 ? s.k4 : (seg == 1 ? s.k6 : s.k8);
}

// p[seg] by selects: a runtime index into a kernel parameter's array
// would copy the array to local memory.
__device__ __forceinline__ const uint8_t* pick(const uint8_t* const (&p)[3], int seg) {
  return seg == 0 ? p[0] : (seg == 1 ? p[1] : p[2]);
}

// numerics.decode: sign | exponent | mantissa, subnormal m * 2^(emin-mant)
template <int EB, int MB, int EMIN>
__device__ __forceinline__ float decode_code(uint32_t c) {
  c &= (1u << (1 + EB + MB)) - 1;
  const uint32_t e = (c >> MB) & ((1u << EB) - 1), m = c & ((1u << MB) - 1);
  const float v =
      e == 0 ? static_cast<float>(m) * __uint_as_float(static_cast<uint32_t>(EMIN - MB + 127) << 23)
             : __uint_as_float((static_cast<uint32_t>(static_cast<int>(e) + EMIN - 1 + 127) << 23) |
                               (m << (23 - MB)));
  return (c >> (EB + MB)) ? -v : v;
}

// fmt: 0 MXFP4 (e2m1), 1 MXFP6 (e3m2), 2 MXFP8 (e4m3fn)
__device__ __forceinline__ float decode_fmt(uint32_t c, int fmt) {
  if (fmt == 0) return decode_code<2, 1, 0>(c);
  if (fmt == 1) return decode_code<3, 2, -2>(c);
  return decode_code<4, 3, -6>(c);
}

__device__ __forceinline__ float ue8m0(uint32_t sf) { return __uint_as_float(sf << 23); }

__device__ __forceinline__ void store16(__nv_bfloat16* dst, const float* v) {
  uint32_t p[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) p[j] = w8::pack_bf16(v[2 * j], v[2 * j + 1]);
  *reinterpret_cast<uint4*>(dst) = make_uint4(p[0], p[1], p[2], p[3]);
  *reinterpret_cast<uint4*>(dst + 8) = make_uint4(p[4], p[5], p[6], p[7]);
}

__device__ __forceinline__ uint32_t byte_of(const uint4& v, int j) {
  const uint32_t w = j < 4 ? v.x : (j < 8 ? v.y : (j < 12 ? v.z : v.w));
  return (w >> (8 * (j & 3))) & 0xFF;
}

// Stage the scale bytes of weight rows [n0, n0 + 64) (zero beyond N) in
// shared memory, one (64, nb) row-major block per segment: fp4's at sw,
// fp6's at sw + 64 nb4, fp8's after it.  The tile's rows of a scale array
// are one contiguous run of 64 nb bytes (a multiple of 256, 16-byte
// aligned when the array is), copied 16 bytes a thread with every load
// of a round in flight at once.  Ends with __syncthreads().
__device__ __forceinline__ void stage_scales(uint8_t* sw, const Operand& w,
                                             const Segs& s, int N, int n0) {
  constexpr int U = 4;  // 16-byte chunks a thread keeps in flight
  const int rows = max(0, min(BN, N - n0));
  int off = 0;
  for (int seg = 0; seg < 3; ++seg) {
    const int nb = seg_width(s, seg) / 32;
    const int total = BN * nb, valid = rows * nb;
    const uint8_t* src = pick(w.s, seg) + static_cast<size_t>(n0) * nb;
    for (int base = threadIdx.x * 16; base < total; base += THREADS * 16 * U) {
      uint4 v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = base + u * THREADS * 16;
        v[u] = i + 16 <= valid ? *reinterpret_cast<const uint4*>(src + i)
                               : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = base + u * THREADS * 16;
        if (i + 16 <= valid || i >= total) {
          if (i < total) *reinterpret_cast<uint4*>(sw + off + i) = v[u];
        } else {  // the chunk where the rows end: byte by byte
          for (int j = 0; j < 16; ++j) sw[off + i + j] = i + j < valid ? src[i + j] : 0;
        }
      }
    }
    off += total;
  }
  __syncthreads();
}

// The A operand of Kernel L: a bf16 site image (M, K), device order.
template <int BM>
struct ImageA {
  static constexpr int CH = BM * BK / 8 / THREADS;  // uint4 = 8 bf16
  const __nv_bfloat16* A;
  int M, K, m0;
  Segs s;
  uint4 ra[CH];

  __device__ __forceinline__ void load(const Step& st) {
    const int seg_off = st.seg == 0 ? 0 : (st.seg == 1 ? s.k4 : s.k4 + s.k6);
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int idx = threadIdx.x + i * THREADS;
      const int r = idx / (BK / 8), c = (idx % (BK / 8)) * 8, m = m0 + r;
      ra[i] = m < M ? *reinterpret_cast<const uint4*>(
                          A + static_cast<size_t>(m) * K + seg_off + seg_col(s, st, c))
                    : make_uint4(0, 0, 0, 0);
    }
  }

  __device__ __forceinline__ void store(__nv_bfloat16 (*As)[BK + PAD], const Step&) {
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int idx = threadIdx.x + i * THREADS;
      *reinterpret_cast<uint4*>(&As[idx / (BK / 8)][(idx % (BK / 8)) * 8]) = ra[i];
    }
  }
};

// The A operand of Kernel K: MX activation codes, one per byte (fp4
// unpacked), each segment in its own grid, times its block's scale.
template <int BM>
struct CodesA {
  static constexpr int CH = BM * BK / 16 / THREADS;  // uint4 = 16 codes
  Operand a;
  int M, m0;
  Segs s;
  uint4 ra[CH];

  __device__ __forceinline__ void load(const Step& st) {
    const int width = seg_width(s, st.seg);
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int idx = threadIdx.x + i * THREADS;
      const int r = idx / (BK / 16), c = (idx % (BK / 16)) * 16, m = m0 + r;
      ra[i] = m < M ? *reinterpret_cast<const uint4*>(
                          pick(a.c, st.seg) + static_cast<size_t>(m) * width + seg_col(s, st, c))
                    : make_uint4(0, 0, 0, 0);
    }
  }

  __device__ __forceinline__ void store(__nv_bfloat16 (*As)[BK + PAD], const Step& st) {
    const int nb = seg_width(s, st.seg) / 32;
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int idx = threadIdx.x + i * THREADS;
      const int r = idx / (BK / 16), c = (idx % (BK / 16)) * 16, m = m0 + r;
      float v[16];
      if (m < M) {
        const uint8_t* srow = pick(a.s, st.seg) + static_cast<size_t>(m) * nb;
        int sb = seg_col(s, st, c) % nb;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          v[j] = decode_fmt(byte_of(ra[i], j), st.seg) * ue8m0(srow[sb]);
          if (++sb == nb) sb = 0;
        }
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j) v[j] = 0.0f;
      }
      store16(&As[r][c], v);
    }
  }
};

// acc[mt][nt][r] as in w8_tile.cuh (w8::for_each_pair reads it).  w's
// arrays start at the tile's row 0 of the weight (N rows); sw holds its
// staged scales.  Runs steps [tbeg, tend).
template <int BM, class ASrc>
__device__ __forceinline__ void mainloop(ASrc& a, const Operand& w, const uint8_t* sw,
                                         const Segs& s, int N, int n0, int tbeg,
                                         int tend, float (&acc)[BM / 16][2][4]) {
  constexpr int MT = BM / 16;
  __shared__ __align__(16) __nv_bfloat16 As[BM][BK + PAD];
  __shared__ __align__(16) __nv_bfloat16 Ws[BN][BK + PAD];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int nb4 = s.k4 / 32, nb6 = s.k6 / 32, nb8 = s.k8 / 32;

#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.0f;

  // fp4 steps: 64 rows x 64 packed bytes (2 uint4 a thread); fp6 / fp8
  // steps: 64 rows x 128 codes (4 uint4 a thread)
  uint4 rw[4];
  auto load_w = [&](const Step& st) {
    const int width = st.seg == 0 ? s.k4 / 2 : seg_width(s, st.seg);
    const int per_row = st.seg == 0 ? 4 : 8;  // uint4 per tile row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (st.seg == 0 && i >= 2) break;
      const int idx = tid + i * THREADS;
      const int r = idx / per_row, c = (idx % per_row) * 16, n = n0 + r;
      rw[i] = n < N ? *reinterpret_cast<const uint4*>(
                          pick(w.c, st.seg) + static_cast<size_t>(n) * width + st.c0 + c)
                    : make_uint4(0, 0, 0, 0);
    }
  };
  auto store_w = [&](const Step& st) {
    if (st.seg == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int idx = tid + i * THREADS;
        const int r = idx / 4, c = (idx % 4) * 16;
        const uint8_t* srow = sw + r * nb4;
        int sb = (st.c0 + c) % nb4;
        float lo[16], hi[16];
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const uint32_t byte = byte_of(rw[i], j);
          const float sc = ue8m0(srow[sb]);
          lo[j] = decode_code<2, 1, 0>(byte & 0xF) * sc;
          hi[j] = decode_code<2, 1, 0>(byte >> 4) * sc;
          if (++sb == nb4) sb = 0;
        }
        store16(&Ws[r][c], lo);
        store16(&Ws[r][BK / 2 + c], hi);
      }
    } else {
      const int fmt = s.fp4_only ? 0 : st.seg;
      const int nb = st.seg == 1 ? nb6 : nb8;
      const int soff = BN * (st.seg == 1 ? nb4 : nb4 + nb6);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int idx = tid + i * THREADS;
        const int r = idx / 8, c = (idx % 8) * 16;
        const uint8_t* srow = sw + soff + r * nb;
        int sb = (st.c0 + c) % nb;
        float v[16];
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          v[j] = decode_fmt(byte_of(rw[i], j), fmt) * ue8m0(srow[sb]);
          if (++sb == nb) sb = 0;
        }
        store16(&Ws[r][c], v);
      }
    }
  };

  if (tbeg < tend) {
    const Step st0 = step_of(s, tbeg);
    a.load(st0);
    load_w(st0);
  }
  for (int t = tbeg; t < tend; ++t) {
    const Step st = step_of(s, t);
    a.store(As, st);
    store_w(st);
    __syncthreads();
    if (t + 1 < tend) {
      const Step nx = step_of(s, t + 1);
      a.load(nx);
      load_w(nx);
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const int kc = kk * 16 + t4 * 2;
      uint32_t bfrag[2][2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int nr = warp * 16 + nt * 8 + g;
        bfrag[nt][0] = *reinterpret_cast<const uint32_t*>(&Ws[nr][kc]);
        bfrag[nt][1] = *reinterpret_cast<const uint32_t*>(&Ws[nr][kc + 8]);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int mr = mt * 16 + g;
        uint32_t afrag[4];
        afrag[0] = *reinterpret_cast<const uint32_t*>(&As[mr][kc]);
        afrag[1] = *reinterpret_cast<const uint32_t*>(&As[mr + 8][kc]);
        afrag[2] = *reinterpret_cast<const uint32_t*>(&As[mr][kc + 8]);
        afrag[3] = *reinterpret_cast<const uint32_t*>(&As[mr + 8][kc + 8]);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) w8::mma_bf16(acc[mt][nt], afrag, bfrag[nt]);
      }
    }
    __syncthreads();
  }
}

// Dynamic shared memory (the staged scales) above the default 48 KB
// limit needs the kernel's attribute raised once.
template <class Kernel>
inline cudaError_t allow_dynamic_smem(Kernel kernel, int bytes, int& allowed) {
  if (bytes <= allowed) return cudaSuccess;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) allowed = bytes;
  return err;
}

}  // namespace sp
