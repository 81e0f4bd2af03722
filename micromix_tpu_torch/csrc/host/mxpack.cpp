// Host-side MX quantization + packing (load-time weight conversion).
//
// Native equivalent of the reference's weight-quantize kernels
// (reorder_quantize_w4 / reorder_quantize_w, mgemm/src/reorder.cu:271-543):
// on TPU, weights are quantized once at model load on the HOST, so the hot
// native code is a multithreaded CPU quantizer rather than a CUDA kernel.
// Numerics are bit-identical to micromix_tpu/mx/numerics.py (tested against
// the NumPy oracle): scale = 2^ceil(log2(absmax / fmt_max)) (exact, via bit
// inspection; 0.5 fallback for zero blocks), saturating round-to-nearest-
// even onto the MX grid, UE8M0 scale bytes, block-interleaved device layout
// (mx/layout.py), split-plane fp4 nibble packing.
//
// The port's own copy of the JAX package's native/mxpack.cpp (the same
// code), built at first use by micromix_tpu_torch/utils/native.py with
// g++ -O3 -std=c++17 -fPIC -shared -pthread into build/host/ (a library
// named by a hash of this source) and loaded via ctypes.

#include <algorithm>
#include <cfenv>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

struct Fmt {
  int mant;      // mantissa bits
  int exp_bits;  // exponent bits
  int emin;      // minimum normal exponent (unbiased)
  float maxv;    // largest finite magnitude
};

// 0 = fp4 (e2m1), 1 = fp6 (e3m2), 2 = fp8 (e4m3fn)
constexpr Fmt kFmts[3] = {
    {1, 2, 0, 6.f},
    {2, 3, -2, 28.f},
    {3, 4, -6, 448.f},
};

inline uint32_t f32_bits(float v) {
  uint32_t b;
  std::memcpy(&b, &v, 4);
  return b;
}

inline int ceil_log2(float v) {  // v > 0, normal float32
  uint32_t b = f32_bits(v);
  int e = int((b >> 23) & 0xFF) - 127;
  return e + ((b & 0x7FFFFF) != 0);
}

inline float exp2i(int e) { return std::ldexp(1.0f, e); }

inline float quantize_to_grid(float x, const Fmt& f) {
  float ax = std::fabs(x);
  ax = std::min(ax, f.maxv);
  int e = int((f32_bits(ax) >> 23) & 0xFF) - 127;
  if (e < f.emin) e = f.emin;
  const float ulp = exp2i(e - f.mant);
  // nearbyint under FE_TONEAREST == round-half-to-even
  const float q = std::nearbyint(ax / ulp) * ulp;
  return std::signbit(x) ? -q : q;
}

inline uint8_t encode(float q, const Fmt& f) {
  const uint32_t bits = f32_bits(q);
  const uint32_t sign = bits >> 31;
  const float aq = std::fabs(q);
  uint32_t exp_field, mant_field;
  if (aq < exp2i(f.emin)) {  // subnormal (or zero)
    exp_field = 0;
    mant_field = uint32_t(aq * exp2i(f.mant - f.emin));
  } else {
    const uint32_t abits = bits & 0x7FFFFFFFu;
    exp_field = uint32_t(int((abits >> 23) & 0xFF) - 127 - f.emin + 1);
    mant_field = (abits >> (23 - f.mant)) & ((1u << f.mant) - 1);
  }
  return uint8_t((sign << (f.exp_bits + f.mant)) | (exp_field << f.mant) |
                 mant_field);
}

void quantize_rows(const float* x, int64_t row0, int64_t row1, int64_t k,
                   const Fmt& f, uint8_t* codes, uint8_t* scales) {
  const int64_t nb = k / 32;
  for (int64_t r = row0; r < row1; ++r) {
    const float* xr = x + r * k;
    uint8_t* cr = codes + r * k;
    uint8_t* sr = scales + r * nb;
    for (int64_t b = 0; b < nb; ++b) {
      float maxv = 0.f;
      for (int i = 0; i < 32; ++i)
        maxv = std::max(maxv, std::fabs(xr[b * 32 + i]));
      int e;
      if (maxv > 0.f) {
        e = std::clamp(ceil_log2(maxv / f.maxv), -126, 127);
      } else {
        e = -1;  // scale 0.5 fallback (reorder.cu:180)
      }
      sr[b] = uint8_t(e + 127);
      const float r_scale = exp2i(-e);
      for (int i = 0; i < 32; ++i) {
        // block-interleaved device layout: physical col = b + i * nb
        cr[b + i * nb] =
            encode(quantize_to_grid(xr[b * 32 + i] * r_scale, f), f);
      }
    }
  }
}

void run_threads(int64_t rows, int n_threads,
                 const std::function<void(int64_t, int64_t)>& fn) {
  n_threads = int(std::max<int64_t>(1, std::min<int64_t>(n_threads, rows)));
  std::vector<std::thread> ts;
  const int64_t chunk = (rows + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    const int64_t r0 = t * chunk;
    const int64_t r1 = std::min(rows, r0 + chunk);
    if (r0 >= r1) break;
    ts.emplace_back(fn, r0, r1);
  }
  for (auto& t : ts) t.join();
}

}  // namespace

extern "C" {

// x: (rows, k) f32 row-major; k % 32 == 0.
// codes out: (rows, k) u8 block-interleaved; scales out: (rows, k/32) u8.
void mx_quantize_interleaved(const float* x, int64_t rows, int64_t k,
                             int fmt, uint8_t* codes, uint8_t* scales,
                             int n_threads) {
  const Fmt& f = kFmts[fmt];
  run_threads(rows, n_threads, [&](int64_t r0, int64_t r1) {
    quantize_rows(x, r0, r1, k, f, codes, scales);
  });
}

// codes: (rows, k) u8 -> packed (rows, k/2) u8, split-plane
// (byte j = codes[j] | codes[j + k/2] << 4).
void mx_pack_fp4(const uint8_t* codes, int64_t rows, int64_t k, uint8_t* out,
                 int n_threads) {
  const int64_t h = k / 2;
  run_threads(rows, n_threads, [&](int64_t r0, int64_t r1) {
    for (int64_t r = r0; r < r1; ++r) {
      const uint8_t* cr = codes + r * k;
      uint8_t* orow = out + r * h;
      for (int64_t j = 0; j < h; ++j)
        orow[j] = uint8_t((cr[j] & 0xF) | ((cr[j + h] & 0xF) << 4));
    }
  });
}

// Fused: quantize (rows, k) f32 into the three MX segments of the MicroMix
// layout.  Segment pointers may be null when the segment width is zero.
// weight_fp4_only != 0 -> all segments on the fp4 grid (reorder.cu:271-432).
// fp4 codes are written split-plane packed ((rows, k4/2)).
void mx_quantize_mixed(const float* x, int64_t rows, int64_t k4, int64_t k6,
                       int64_t k8, int weight_fp4_only, uint8_t* fp4_packed,
                       uint8_t* sf4, uint8_t* fp6, uint8_t* sf6, uint8_t* fp8,
                       uint8_t* sf8, int n_threads) {
  const int64_t k = k4 + k6 + k8;
  std::vector<uint8_t> tmp;
  if (k4) tmp.resize(size_t(rows) * k4);
  run_threads(rows, n_threads, [&](int64_t r0, int64_t r1) {
    for (int64_t r = r0; r < r1; ++r) {
      const float* xr = x + r * k;
      if (k4) {
        quantize_rows(xr, 0, 1, k4, kFmts[0], tmp.data() + r * k4,
                      sf4 + r * (k4 / 32));
        const uint8_t* cr = tmp.data() + r * k4;
        uint8_t* orow = fp4_packed + r * (k4 / 2);
        const int64_t h = k4 / 2;
        for (int64_t j = 0; j < h; ++j)
          orow[j] = uint8_t((cr[j] & 0xF) | ((cr[j + h] & 0xF) << 4));
      }
      if (k6)
        quantize_rows(xr + k4, 0, 1, k6, kFmts[weight_fp4_only ? 0 : 1],
                      fp6 + r * k6, sf6 + r * (k6 / 32));
      if (k8)
        quantize_rows(xr + k4 + k6, 0, 1, k8, kFmts[weight_fp4_only ? 0 : 2],
                      fp8 + r * k8, sf8 + r * (k8 / 32));
    }
  });
}

// Fused: quantize (rows, k4+k6+k8) f32 on the fp4 grid (w4-only weight
// mode) and emit the ScaledW8 per-element layout (mx/scaledw8.py): one u8
// code s|e6|m per element, segments block-interleaved, plus one per-tensor
// base exponent.  Bit-identical to quantize_mixed_host + the Python pack.
// Returns 0 on success; 1 when the scaled-exponent span exceeds the 6-bit
// field or base > 1 (caller falls back to the split-plane layout).
int mx_quantize_scaledw8(const float* x, int64_t rows, int64_t k4,
                         int64_t k6, int64_t k8, uint8_t* codes,
                         int32_t* base_out, int n_threads) {
  const int64_t k = k4 + k6 + k8;
  const Fmt& f4 = kFmts[0];
  std::vector<uint8_t> tmp(size_t(rows) * k);      // fp4 codes, interleaved
  std::vector<uint8_t> scales(size_t(rows) * (k / 32));
  const int64_t seg_off[3] = {0, k4, k4 + k6};
  const int64_t seg_k[3] = {k4, k6, k8};
  const int64_t sf_off[3] = {0, k4 / 32, (k4 + k6) / 32};

  const int nt = int(std::max<int64_t>(
      1, std::min<int64_t>(n_threads, rows)));
  std::vector<int> emins(nt, 1 << 20), emaxs(nt, -(1 << 20));
  std::vector<std::thread> ts;
  const int64_t chunk = (rows + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    const int64_t r0 = t * chunk, r1 = std::min(rows, r0 + chunk);
    if (r0 >= r1) break;
    ts.emplace_back([&, t, r0, r1] {
      int emin = 1 << 20, emax = -(1 << 20);
      for (int64_t r = r0; r < r1; ++r) {
        for (int s = 0; s < 3; ++s) {
          if (!seg_k[s]) continue;
          quantize_rows(x + r * k + seg_off[s], 0, 1, seg_k[s], f4,
                        tmp.data() + r * k + seg_off[s],
                        scales.data() + r * (k / 32) + sf_off[s]);
          const uint8_t* cr = tmp.data() + r * k + seg_off[s];
          const uint8_t* sr = scales.data() + r * (k / 32) + sf_off[s];
          const int64_t nb = seg_k[s] / 32;
          for (int64_t j = 0; j < seg_k[s]; ++j) {
            const uint8_t c = cr[j];
            if (!(c & 7)) continue;  // zero
            const int eb = int(sr[j % nb]) - 127;  // interleaved layout
            const int e4 = (c >> 1) & 3;
            const int E = e4 >= 1 ? eb + e4 - 1 : eb - 1;
            emin = std::min(emin, E);
            emax = std::max(emax, E);
          }
        }
      }
      emins[t] = emin;
      emaxs[t] = emax;
    });
  }
  for (auto& th : ts) th.join();
  int emin = 1 << 20, emax = -(1 << 20);
  for (int t = 0; t < nt; ++t) {
    emin = std::min(emin, emins[t]);
    emax = std::max(emax, emaxs[t]);
  }
  int base = 0;
  if (emin <= emax) {  // any nonzero element
    if (emax - emin > 62) return 1;
    base = emin;
    if (base > 1) return 1;
  }
  *base_out = base;
  run_threads(rows, n_threads, [&](int64_t r0, int64_t r1) {
    for (int64_t r = r0; r < r1; ++r) {
      uint8_t* orow = codes + r * k;
      for (int s = 0; s < 3; ++s) {
        if (!seg_k[s]) continue;
        const uint8_t* cr = tmp.data() + r * k + seg_off[s];
        const uint8_t* sr = scales.data() + r * (k / 32) + sf_off[s];
        const int64_t nb = seg_k[s] / 32;
        uint8_t* orow_s = orow + seg_off[s];
        for (int64_t j = 0; j < seg_k[s]; ++j) {
          const uint8_t c = cr[j];
          if (!(c & 7)) {
            orow_s[j] = 0;
            continue;
          }
          const int eb = int(sr[j % nb]) - 127;
          const int e4 = (c >> 1) & 3;
          const int E = e4 >= 1 ? eb + e4 - 1 : eb - 1;
          const int m = e4 >= 1 ? (c & 1) : 0;
          const int sign = (c >> 3) & 1;
          orow_s[j] = uint8_t((sign << 7) | ((E - base + 1) << 1) | m);
        }
      }
    }
  });
  return 0;
}

}  // extern "C"
