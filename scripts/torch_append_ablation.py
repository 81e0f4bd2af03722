#!/usr/bin/env python3
"""Where Kernel D's whole append spends its time: ``append_kv_quant``
(``csrc/append_kv.cu``) timed whole and with one part of its work cut out
or changed, each variant built from a patched copy of the source.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 scripts/torch_append_ablation.py [--source DIR ...]

Variants: ``whole`` (the source as it is), ``early_lookup`` (each row's
page-table entry loaded by every lane right behind its indices, before
the arithmetic, not by lane 0 after it; same results), ``rows_8`` (8
tokens a block: one row a warp, a 2048-block grid at T=1024; same
results), ``mul_not_div`` (the two IEEE divisions a row and an element become
multiplies: wrong codes, the division's cost cut), ``no_stores`` (the
global stores of codes and pairs behind a condition that is never true;
the staging in shared memory stays) and ``empty`` (the kernel returns at
entry: launch and scheduling alone).  Outputs of the cut variants are
wrong by design; only their time means anything.  Times are medians of
CUDA-event readings with the L2 flushed (``chip_smoke.Timer``) at the
serving shapes of Llama-3.1-8B (Hkv 8, D 128, pages of 128): a decode
append of 8 tokens with RoPE, int4 and int8, and prefill appends of 1024
tokens, 8 sequences x 128 positions from 0 and 2 x 512 from 77, each
beside its bound (bytes over 3.35 TB/s: K, V, the RoPE tables, the
indices and the page-table entries read once, codes and pairs written
once).

``--source DIR`` (repeatable) times another tree's ``csrc`` the same way,
where its text allows each patch.  Prints one line per source and shape;
the copies and libraries go to ``build/ablation_append/`` (gitignored).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402
from micromix_tpu_torch.kernels import build  # noqa: E402
from micromix_tpu_torch.serve.append_kernel import _SIG  # noqa: E402
from micromix_tpu_torch.serve.kv_cache import _F32_RECIP  # noqa: E402

ROWS_8 = ("constexpr int kRunTokens = 32;", "constexpr int kRunTokens = 8;")
# each row's page-table entry loaded by all lanes right after its indices,
# before the arithmetic (the source loads it in lane 0 after)
EARLY_LOOKUP = [
    ("  int seq[kRowsPerWarp], pos[kRowsPerWarp];\n",
     "  int seq[kRowsPerWarp], pos[kRowsPerWarp], tbl[kRowsPerWarp];\n"),
    ("    const int i = warp + u * kWarps;\n    if (i >= n) continue;\n"
     "    const int t = t0 + i;\n    const __nv_bfloat16* x =",
     "    const int i = warp + u * kWarps;\n    seq[u] = pos[u] = -1;\n"
     "    if (i >= n) continue;\n    const int t = t0 + i;\n"
     "    const __nv_bfloat16* x ="),
    ("    pos[u] = a.positions[t];\n  }\n",
     "    pos[u] = a.positions[t];\n  }\n#pragma unroll\n"
     "  for (int u = 0; u < kRowsPerWarp; ++u) {\n"
     "    const int sq = seq[u], p = pos[u];\n    tbl[u] = -1;\n"
     "    if (sq >= 0 && sq < a.n_seqs && p >= 0 && p / a.ps < a.max_pages)\n"
     "      tbl[u] = a.table[static_cast<size_t>(sq) * a.max_pages + p / a.ps];\n"
     "  }\n"),
    ("      int page = -1;\n"
     "      if (sq >= 0 && sq < a.n_seqs && p >= 0 && p / a.ps < a.max_pages) {\n"
     "        page = a.table[static_cast<size_t>(sq) * a.max_pages + p / a.ps];\n"
     "        if (page < 0 || page >= a.n_pages) page = -1;\n      }\n",
     "      const int page = tbl[u] >= 0 && tbl[u] < a.n_pages ? tbl[u] : -1;\n")]
DIVIDE = [("rintf(__fdiv_rn(-mn, scale))", "rintf(__fmul_rn(-mn, scale))"),
          ("rintf(__fdiv_rn(x[j], scale))", "rintf(__fmul_rn(x[j], scale))")]
STORES = [("      *reinterpret_cast<uint32_t*>(codes + (base + r) * a.ps + c0 + 4 * w) =",
           "      if (a.recip < 0.f)\n"
           "      *reinterpret_cast<uint32_t*>(codes + (base + r) * a.ps + c0 + 4 * w) ="),
          ("      if (p >= 0)\n        codes[", "      if (p >= 0 && a.recip < 0.f)\n        codes["),
          ("    if (p >= 0)\n      sz[", "    if (p >= 0 && a.recip < 0.f)\n      sz[")]
EMPTY = ("  const int n = min(kRunTokens, a.T - t0);\n",
         "  const int n = min(kRunTokens, a.T - t0);\n  if (a.recip > 0.f) return;\n")
VARIANTS = {"whole": [], "early_lookup": EARLY_LOOKUP, "rows_8": [ROWS_8],
            "mul_not_div": DIVIDE, "no_stores": STORES, "empty": [EMPTY]}
# (label, bits, sequences, tokens each, first position, RoPE)
SHAPES = (("T=8 int4 rope", 4, 8, 1, None, True),
          ("T=8 int8 rope", 8, 8, 1, None, True),
          ("T=1024 int4 8x128 from 0", 4, 8, 128, 0, False),
          ("T=1024 int4 2x512 from 77", 4, 2, 512, 77, False))


def patch(src_dir: str, out_dir: str, patches) -> None:
    shutil.rmtree(out_dir, ignore_errors=True)
    shutil.copytree(src_dir, out_dir)
    path = os.path.join(out_dir, "append_kv.cu")
    text = open(path).read()
    applied = 0
    for old, new in patches:
        if old in text:
            text = text.replace(old, new)
            applied += 1
    with open(path, "w") as f:
        f.write(text)
    if patches and not applied:
        raise SystemExit(f"{src_dir}: no patch of {out_dir} applies")


def build_variants(src_dir: str, out_dir: str):
    procs = []
    for name, patches in VARIANTS.items():
        d = os.path.join(out_dir, name)
        patch(src_dir, d, patches)
        lib = os.path.join(d, "libappend_kv.so")
        procs.append((name, lib, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", lib,
             os.path.join(d, "append_kv.cu")])))
    fns = {}
    for name, lib, proc in procs:
        if proc.wait() != 0:
            raise SystemExit(f"{name}: nvcc failed")
        fn = ctypes.CDLL(lib).append_kv_quant
        fn.argtypes = _SIG["append_kv_quant"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def inputs(rng, bits, seqs, per_seq, start, rope):
    """A cache, the indices, K and V (column views of a q|k|v output at
    decode), the RoPE tables; and the bound's bytes."""
    import torch
    from micromix_tpu_torch.models.common import rope_inv_freq
    hkv, d, ps = 8, 128, 128
    if start is None:            # decode: one token a sequence, anywhere
        mp = 4
        seq = torch.arange(seqs, device=cs.DEV, dtype=torch.int32)
        pos = torch.from_numpy(rng.integers(0, mp * ps, seqs).astype(np.int32)).to(cs.DEV)
    else:
        mp = -(-(start + per_seq) // ps)
        seq = torch.arange(seqs, device=cs.DEV, dtype=torch.int32).repeat_interleave(per_seq)
        pos = (start + torch.arange(per_seq, device=cs.DEV, dtype=torch.int32)).repeat(seqs)
    t = seq.numel()
    cache = cs._append_cache(rng, bits, seqs, mp)
    qkv = torch.randn(t, 48 * d, device=cs.DEV).to(torch.bfloat16)
    k = qkv[:, 32 * d:40 * d].unflatten(1, (hkv, d))
    v = qkv[:, 40 * d:].unflatten(1, (hkv, d))
    cos = sin = None
    if rope:
        inv = rope_inv_freq(d, 500000.0, cs.LLAMA3_SCALING, device=cs.DEV)
        ang = pos.float()[:, None] * inv[None, :]
        ang = torch.cat([ang, ang], dim=-1)
        cos, sin = torch.cos(ang), torch.sin(ang)
    dq = d // 2 if bits == 4 else d
    slots = len(set((seq.long() * mp + pos.long() // ps).tolist()))
    nbytes = (2 * t * hkv * d * 2 + (2 * t * d * 4 if rope else 0) + 2 * t * 4
              + slots * 4 + seqs * 8 + 2 * t * hkv * (dq + 4))
    return cache, seq, pos, k, v, cos, sin, nbytes


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_append_ablation: no CUDA device", file=sys.stderr)
        return 2
    print(torch.cuda.get_device_name(0), flush=True)
    args = sys.argv[1:]
    sources = [("this tree", str(build.CSRC))]
    sources += [(args[i + 1], args[i + 1]) for i, a in enumerate(args) if a == "--source"]
    root = os.path.join(os.path.dirname(build.BUILD_DIR), "ablation_append")
    libs = {label: build_variants(d, os.path.join(root, f"src{i}"))
            for i, (label, d) in enumerate(sources)}
    timer = cs.Timer()
    rng = np.random.default_rng(0)
    for label, bits, seqs, per_seq, start, rope in SHAPES:
        c, seq, pos, k, v, cos, sin, nbytes = inputs(rng, bits, seqs, per_seq,
                                                     start, rope)
        t, h, d = k.shape
        for src, fns in libs.items():
            row = []
            for name, fn in fns.items():
                def run(fn=fn):
                    build.check(fn(
                        build.ptr(c.k_codes), build.ptr(c.v_codes), build.ptr(c.k_sz),
                        build.ptr(c.v_sz), build.ptr(c.page_table), build.ptr(c.lengths),
                        build.ptr(seq), build.ptr(pos), build.ptr(k), build.ptr(v),
                        build.ptr(cos), build.ptr(sin), t, h, d, c.page_size,
                        c.k_codes.shape[0], c.page_table.shape[1],
                        c.page_table.shape[0], k.stride(0), v.stride(0), bits,
                        _F32_RECIP[bits], build.stream()), "append_kv_quant")
                row.append(f"{name}={timer.ms(run):.4f}")
            print(f"append [{src}] {label} ms: " + " ".join(row)
                  + f" bound={nbytes / cs.PEAK_BYTES_S * 1e3:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
