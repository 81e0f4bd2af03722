#!/usr/bin/env python3
"""Kernel C (``csrc/paged_decode.cu``) at each page size, this tree's
against other trees' in one run.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 scripts/torch_decode_pages.py [--source DIR ...] [--rounds N]

Each tree's ``paged_decode.cu`` is built as it is into
``build/decode_pages/`` (gitignored).  The rows: Llama-3.1-8B's attention
(H=32, Hkv=8, D=128) at B=8 over 100-600 tokens on int4, int8 and bf16
pages, and B=1 at 8192 tokens on int4 pages, at page sizes 16, 32, 64
and 128 for every tree, and at 256, 384, 512 and 1024 for the trees that
take them.  Each row is timed ``--rounds`` times (default 2) in turns
over the trees, forward then backward (A, B, B, A), each reading the
median of ``chip_smoke.Timer`` (CUDA events, L2 flushed); the row prints
every reading and each tree's median over its readings, beside the bound
(every attended code and [scale, zero] pair, or bf16 value, q and the
output once, over 3.35 TB/s).  ``--source DIR`` names another tree's
``csrc``, for example the parent commit unpacked by ``git archive`` into
``build/parent``.
"""

from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402
from micromix_tpu_torch.kernels import build  # noqa: E402
from micromix_tpu_torch.serve import attention as att  # noqa: E402

SMALL_PAGES = (16, 32, 64, 128)
LARGE_PAGES = (256, 384, 512, 1024)
ROWS = (("B=8 len 100..600", np.linspace(100, 600, 8), (4, 8, 16)),
        ("B=1 len 8192", np.full(1, 8192), (4,)))


def build_tree(src_dir: str, out_dir: str):
    """-> (the tree's paged_decode, whether it takes pages over 128)."""
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(src_dir, "paged_decode.cu")
    lib = os.path.join(out_dir, "libpaged_decode.so")
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", src_dir, "-o", lib, src],
                   check=True)
    fn = ctypes.CDLL(lib).paged_decode
    fn.argtypes = att._SIG["paged_decode"]
    fn.restype = ctypes.c_int
    return fn, "stage_tokens" in open(src).read()


def main() -> int:
    import torch
    from micromix_tpu_torch.models.common import rope_inv_freq
    if not torch.cuda.is_available():
        print("torch_decode_pages: no CUDA device", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    rounds = int(args[args.index("--rounds") + 1]) if "--rounds" in args else 2
    sources = [("this tree", str(build.CSRC))]
    sources += [(args[i + 1], args[i + 1]) for i, a in enumerate(args) if a == "--source"]
    root = os.path.join(os.path.dirname(build.BUILD_DIR), "decode_pages")
    trees = {label: build_tree(d, os.path.join(root, f"src{i}"))
             for i, (label, d) in enumerate(sources)}
    print(torch.cuda.get_device_name(0), flush=True)
    timer = cs.Timer()
    rng = np.random.default_rng(0)
    h, hkv, d = 32, 8, 128
    inv = rope_inv_freq(d, 500000.0, cs.LLAMA3_SCALING, device=cs.DEV)
    out_rows = []
    for ps in SMALL_PAGES + LARGE_PAGES:
        for label, lengths, widths in ROWS:
            lengths = lengths.astype(np.int32)
            b = len(lengths)
            mp = -(-int(lengths.max()) // ps)
            for bits in widths:
                cache = cs._decode_cache(rng, b, mp, bits, ps=ps, hkv=hkv, d=d)
                cache.lengths.copy_(torch.from_numpy(lengths))
                q = torch.randn(b, h, d, device=cs.DEV).to(torch.bfloat16)
                seq = torch.arange(b, device=cs.DEV, dtype=torch.int32)
                pos = torch.from_numpy(lengths - 1).to(cs.DEV)
                out = torch.empty_like(q)
                splits, pps = att.decode_split(b, hkv, mp)
                part_acc = torch.empty(b * hkv * splits * 8 * d, device=cs.DEV)
                part_md = torch.empty(b * hkv * splits * 8 * 2, device=cs.DEV)
                tickets = torch.zeros(b * hkv, dtype=torch.int32, device=cs.DEV)
                call = (*[build.ptr(t) for t in (q, cache.k_codes, cache.v_codes,
                                                 cache.k_sz, cache.v_sz,
                                                 cache.page_table, seq, cache.lengths)],
                        0, build.ptr(pos), build.ptr(inv), build.ptr(out), 0, 0,
                        build.ptr(part_acc), build.ptr(part_md), build.ptr(tickets),
                        b, h, hkv, d, ps, mp, bits, 0, splits, pps, 1.0 / d ** 0.5)
                nbytes = (2 * b * h * d * 2 + 2 * int(lengths.sum()) * hkv
                          * cs._page_bytes(bits, d) + b * mp * 4)
                takes = [lab for lab, (_, large) in trees.items()
                         if ps <= 128 or large]
                order = (takes + takes[::-1]) * rounds
                readings = {lab: [] for lab in takes}
                outs = {}
                for lab in order:
                    fn = trees[lab][0]

                    def run(fn=fn):
                        build.check(fn(*call, build.stream()), "paged_decode")
                    readings[lab].append(timer.ms(run))
                    outs[lab] = out.clone()
                ref = outs[takes[0]]
                row = dict(ps=ps, shape=label, bits=bits, splits=splits,
                           pages_per_split=pps,
                           bound_ms=nbytes / cs.PEAK_BYTES_S * 1e3,
                           median_ms={lab: statistics.median(r)
                                      for lab, r in readings.items()},
                           readings_ms=readings,
                           equal_to_this_tree={lab: bool(torch.equal(o, ref))
                                               for lab, o in outs.items()})
                out_rows.append(row)
                print(f"decode ps={ps} {label} bits={bits}: " + " ".join(
                    f"[{lab}] median={row['median_ms'][lab]:.4f} readings="
                    + ",".join(f"{x:.4f}" for x in r)
                    for lab, r in readings.items())
                    + f" bound={row['bound_ms']:.4f} splits={splits}x{pps}"
                    + f" equal={row['equal_to_this_tree']}", flush=True)
                del cache
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    with open(os.path.join(cs.OUT_DIR, "decode_pages.json"), "w") as f:
        json.dump(out_rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
