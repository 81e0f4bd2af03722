#!/usr/bin/env python3
"""Where the paged decode attention kernel's time goes: Kernel C
(``csrc/paged_decode.cu``) timed whole and with one part of its work cut
out, each variant built from a patched copy of the source.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 scripts/torch_decode_ablation.py [--source DIR ...]

Variants: ``whole`` (the source as it is), ``no_scores`` (no Q.K
products: every score 0), ``no_softmax`` (no exponentials: p is the
score, no rescaling), ``no_pv`` (no P.V products),
``no_refill`` (no page copies after a block's first: it computes on a
stale page), ``no_rope`` (no cosf / sinf: q rotated by the angle itself),
``no_merge`` (every block writes its split's result as if it were the
row's only one: no partials, ticket or merge), ``merge32`` (the split
merge with 32 partial loads in flight, not 8) and ``empty`` (a block with
pages returns before it reads them: launch, the range arithmetic and the
empty rows' zeros).  Outputs
of the cut variants are wrong by design; only their time means anything.
Times are medians of CUDA-event readings with the L2 flushed
(``chip_smoke.Timer``), Llama-3.1-8B's attention shapes (H=32, Hkv=8,
D=128, int4 pages of 128 tokens), at the decode rows ``chip_smoke.py``
checks: B=8 at 100-600 tokens, at 2048 and at 4096, B=1 at 8192; each
beside its bound (every code and [scale, zero] pair of the attended
tokens, q and the output once, over 3.35 TB/s).

``--source DIR`` (repeatable) times another tree's ``csrc`` the same way
where its text allows each patch (``whole`` always), for example the
parent commit unpacked by ``git archive`` into ``build/parent``; a kernel
without the split grid is called with its own arguments.  The copies and
libraries go to ``build/ablation_decode/`` (gitignored).
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
from micromix_tpu_torch.serve import attention as att  # noqa: E402

VARIANTS = {
    "whole": [],
    "no_scores": [("      for (int kk = 0; kk < KSTEPS; ++kk) {",
                   "      for (int kk = 0; kk < 0; ++kk) {")],
    "no_softmax": [("        const float corr = expf(m_w[h] - m_new);",
                    "        const float corr = 1.0f;"),
                   ("        e[h] = ok0 ? expf(s[h] - m_new) : 0.0f;\n"
                    "        e[2 + h] = ok1 ? expf(s[2 + h] - m_new) : 0.0f;",
                    "        e[h] = ok0 ? s[h] : 0.0f;\n        e[2 + h] = ok1 ? s[2 + h] : 0.0f;")],
    "no_pv": [("      for (int mt = 0; mt < (BITS == 4 ? MT / 2 : MT); ++mt) {",
               "      for (int mt = 0; mt < 0; ++mt) {")],
    "no_refill": [("    if (p + 1 < pend) stage(st ^ 1, p + 1);", "")],
    "no_rope": [("      c = cosf(ang);\n      s = sinf(ang);", "      c = ang;\n      s = ang;")],
    "no_merge": [("  if (count == 1) {       // the row's only split: write the result",
                  "  if (true) {")],
    "merge32": [("#pragma unroll 8\n      for (int k = 0; k < count; ++k)",
                 "#pragma unroll 32\n      for (int k = 0; k < count; ++k)")],
    "empty": [("  const int pend = min((split + 1) * a.pps, npages);\n",
               "  const int pend = min((split + 1) * a.pps, npages);\n"
               "  if (a.scale > 0.0f) return;\n")],
}
SHAPES = (("B=8 len 100..600", 8, np.linspace(100, 600, 8)),
          ("B=8 len 2048", 8, np.full(8, 2048)),
          ("B=8 len 4096", 8, np.full(8, 4096)),
          ("B=1 len 8192", 1, np.full(1, 8192)))
# the kernel before the split grid: (q, kc, vc, ksz, vsz, table, seq_ids,
# lengths, positions, inv_freq, out, B, H, Hkv, D, ps, max_pages, scale,
# stream)
ONE_BLOCK_SIG = [build.PTR] * 11 + [build.INT] * 6 + [build.FLOAT, build.PTR]


def build_variants(src_dir: str, out_dir: str):
    """{variant: (ctypes function, whether it is the split-grid kernel)}."""
    text = open(os.path.join(src_dir, "paged_decode.cu")).read()
    split = "lengths_per_row" in text
    procs = []
    for name, patches in VARIANTS.items():
        if any(old not in text for old, _ in patches):
            continue
        d = os.path.join(out_dir, name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(src_dir, d)
        src = text
        for old, new in patches:
            src = src.replace(old, new)
        with open(os.path.join(d, "paged_decode.cu"), "w") as f:
            f.write(src)
        lib = os.path.join(d, "libpaged_decode.so")
        procs.append((name, lib, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", lib, os.path.join(d, "paged_decode.cu")])))
    fns = {}
    for name, lib, proc in procs:
        if proc.wait() != 0:
            raise SystemExit(f"{name}: nvcc failed")
        fn = ctypes.CDLL(lib).paged_decode
        fn.argtypes = att._SIG["paged_decode"] if split else ONE_BLOCK_SIG
        fn.restype = ctypes.c_int
        fns[name] = (fn, split)
    return fns


def main() -> int:
    import torch
    from micromix_tpu_torch.models.common import rope_inv_freq
    if not torch.cuda.is_available():
        print("torch_decode_ablation: no CUDA device", file=sys.stderr)
        return 2
    print(torch.cuda.get_device_name(0), flush=True)
    args = sys.argv[1:]
    sources = [("this tree", str(build.CSRC))]
    sources += [(args[i + 1], args[i + 1]) for i, a in enumerate(args) if a == "--source"]
    root = os.path.join(os.path.dirname(build.BUILD_DIR), "ablation_decode")
    libs = {label: build_variants(d, os.path.join(root, f"src{i}"))
            for i, (label, d) in enumerate(sources)}
    timer = cs.Timer()
    rng = np.random.default_rng(0)
    h, hkv, d, ps = 32, 8, 128, 128
    inv = rope_inv_freq(d, 500000.0, cs.LLAMA3_SCALING, device=cs.DEV)
    for label, b, lengths in SHAPES:
        lengths = lengths.astype(np.int32)
        mp = -(-int(lengths.max()) // ps)
        cache = cs._decode_cache(rng, b, mp)
        cache.lengths.copy_(torch.from_numpy(lengths))
        q = torch.randn(b, h, d, device=cs.DEV).to(torch.bfloat16)
        seq = torch.arange(b, device=cs.DEV, dtype=torch.int32)
        pos = torch.from_numpy(lengths - 1).to(cs.DEV)
        out = torch.empty_like(q)
        splits, pps = att.decode_split(b, hkv, mp)
        part_acc = torch.empty(b * hkv * splits * (h // hkv) * d, device=cs.DEV)
        part_md = torch.empty(b * hkv * splits * (h // hkv) * 2, device=cs.DEV)
        tickets = torch.zeros(b * hkv, dtype=torch.int32, device=cs.DEV)
        common = [build.ptr(t) for t in (q, cache.k_codes, cache.v_codes, cache.k_sz,
                                         cache.v_sz, cache.page_table, seq, cache.lengths)]
        nbytes = 2 * b * h * d * 2 + 2 * int(lengths.sum()) * hkv * (d // 2 + 4) + b * mp * 4
        for src, fns in libs.items():
            row = []
            for name, (fn, split) in fns.items():
                if split:
                    call = (*common, 0, build.ptr(pos), build.ptr(inv), build.ptr(out), 0, 0,
                            build.ptr(part_acc), build.ptr(part_md), build.ptr(tickets),
                            b, h, hkv, d, ps, mp, 4, 0, splits, pps, 1.0 / d ** 0.5)
                else:
                    call = (*common, build.ptr(pos), build.ptr(inv), build.ptr(out),
                            b, h, hkv, d, ps, mp, 1.0 / d ** 0.5)

                def run(fn=fn, call=call):
                    build.check(fn(*call, build.stream()), "paged_decode")
                row.append(f"{name}={timer.ms(run):.4f}")
                # a cut variant may leave a ticket raised: the next starts at 0
                tickets.zero_()
            print(f"decode [{src}] {label} ms: " + " ".join(row)
                  + f" bound={nbytes / cs.PEAK_BYTES_S * 1e3:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
