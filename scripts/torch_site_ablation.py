#!/usr/bin/env python3
"""Where the activation site kernel's time goes: Kernel A
(``csrc/site_fakequant.cu``, arithmetic in ``csrc/mx_site.cuh``), timed
whole and with one part of its work cut out, each variant built from a
patched copy of the sources.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 scripts/torch_site_ablation.py [--source DIR ...]

Variants: ``whole`` (the sources as they are), ``identity_gather`` (the
channel permutation read as the identity: no perm load, no scattered
read of x), ``no_producer`` (the rms / silu arithmetic cut: the value is
x as read; the loads, and the rms row moment, stay), ``no_stores`` (the
image's stores, to global or to shared memory, behind a condition that
is never true, so the work before them stays) and ``empty`` (the kernel returns at
entry: launch and scheduling alone).  Outputs of the cut variants are
wrong by design; only their time means anything.  Times are medians of
CUDA-event readings with the L2 flushed (``chip_smoke.Timer``), at the
decode sites of Llama-3.1-8B (rms M=8 K=4096, silu M=8 K=14336), a
128-row plain site with its gather, the rms site of 512- and 4096-token
prefill chunks, and Mixtral-8x7B's prefill sites
(M = E x C = 4096 rows: w1|w3's plain site, one permutation per 512 rows,
and w2's silu site at K=14336), each beside its bound (bytes over 3.35
TB/s: x, up or gamma and the perms read once, the image written once).

``--source DIR`` (repeatable) ablates another tree's ``csrc`` the same
way, where its text allows each patch, for example the parent commit
unpacked by ``git archive`` into ``build/parent``; the call then passes
that tree's own arguments (its kernel may lack the row split).  Prints
one line per source and shape; the copies and libraries go to
``build/ablation_site/`` (gitignored).
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
from micromix_tpu_torch.kernels.fakequant import site_blocks_per_cta  # noqa: E402

GATHER = ("const int src = perm ? perm[c] : c;", "const int src = c;")
# the producer branches as this tree (compile-time P) and the
# single-block-per-row kernel (runtime producer) write them
PRODUCER = [(f"""    if ({p} == 1) return xv * rvar * gamma[src];
    if ({p} == 2) {{
      const float sig = 1.0f / (1.0f + expf(-xv));
      return xv * sig * __bfloat162float(up[c]);
    }}
""", "") for p in ("P", "producer")]
# the image stores of this tree's kernel and of the single-block-per-row one
STORES = [("      *reinterpret_cast<uint4*>(orow + 8 * c) =",
           "      if (eps < 0.0f) *reinterpret_cast<uint4*>(orow + 8 * c) ="),
          ("        dst[c0 + r * step] = __float2bfloat16_rn(",
           "        if (eps < 0.0f) dst[c0 + r * step] = __float2bfloat16_rn("),
          ("      orow[blk.off + blk.j + i * blk.nb] =\n",
           "      if (eps < 0.0f) orow[blk.off + blk.j + i * blk.nb] =\n")]
EMPTY = ("  const int row = blockIdx.x;\n",
         "  const int row = blockIdx.x;\n  if (eps >= 0.0f) return;\n")
VARIANTS = {"whole": [], "identity_gather": [GATHER], "no_producer": PRODUCER,
            "no_stores": STORES, "empty": [EMPTY]}
FILES = ("site_fakequant.cu", "mx_site.cuh")
# (label, producer, M, K, perm groups)
SHAPES = (("rms M=8 K=4096", "rms", 8, 4096, 1),
          ("silu M=8 K=14336", "silu", 8, 14336, 0),
          ("plain M=128 K=4096", "plain", 128, 4096, 1),
          ("rms M=512 K=4096", "rms", 512, 4096, 1),
          ("rms M=4096 K=4096", "rms", 4096, 4096, 1),
          ("w13 plain M=4096 K=4096 perm_rows=512", "plain", 4096, 4096, 8),
          ("w2 silu M=4096 K=14336", "silu", 4096, 14336, 0))
PRODUCERS = {"plain": 0, "rms": 1, "silu": 2}


def patch(src_dir: str, out_dir: str, patches) -> None:
    shutil.rmtree(out_dir, ignore_errors=True)
    shutil.copytree(src_dir, out_dir)
    applied = 0
    for name in FILES:
        path = os.path.join(out_dir, name)
        text = open(path).read()
        for old, new in patches:
            if old in text:
                text = text.replace(old, new)
                applied += 1
        with open(path, "w") as f:
            f.write(text)
    if patches and not applied:
        raise SystemExit(f"{src_dir}: no patch of {out_dir} applies")


def build_variants(src_dir: str, out_dir: str):
    """{variant: (ctypes function, whether it takes the row split, whether
    it takes the block-format array)}."""
    text = open(os.path.join(src_dir, "site_fakequant.cu")).read()
    split = "int bpc" in text
    fmt = "const void* fmt" in text
    procs = []
    for name, patches in VARIANTS.items():
        d = os.path.join(out_dir, name)
        patch(src_dir, d, patches)
        lib = os.path.join(d, "libsite_fakequant.so")
        procs.append((name, lib, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", lib,
             os.path.join(d, "site_fakequant.cu")])))
    fns = {}
    for name, lib, proc in procs:
        if proc.wait() != 0:
            raise SystemExit(f"{name}: nvcc failed")
        fn = ctypes.CDLL(lib).site_fakequant
        fn.argtypes = ([build.PTR] * (4 + fmt) + [build.INT] * 7 + [build.FLOAT]
                       + [build.INT] * split + [build.PTR])
        fn.restype = ctypes.c_int
        fns[name] = (fn, split, fmt)
    return fns


def inputs(rng, producer, m, k, groups):
    import torch
    splits = cs.SPLIT_4096 if k == 4096 else cs.SPLIT_14336
    x = cs._site_input(m, k)
    aux = perm = None
    if producer == "rms":
        aux = (1.0 + 0.1 * torch.randn(k, device=cs.DEV)).contiguous()
    if producer == "silu":
        aux = torch.randn(m, k, device=cs.DEV).to(torch.bfloat16)
    if groups:
        perm = torch.stack([cs._perm(rng, k, splits) for _ in range(groups)])
    nbytes = 2 * m * k * 2 + {"rms": k * 4, "silu": m * k * 2, "plain": 0}[producer]
    nbytes += 0 if perm is None else perm.numel() * 4
    return splits, x, aux, perm, nbytes


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_site_ablation: no CUDA device", file=sys.stderr)
        return 2
    print(torch.cuda.get_device_name(0), flush=True)
    args = sys.argv[1:]
    sources = [("this tree", str(build.CSRC))]
    sources += [(args[i + 1], args[i + 1]) for i, a in enumerate(args) if a == "--source"]
    root = os.path.join(os.path.dirname(build.BUILD_DIR), "ablation_site")
    libs = {label: build_variants(d, os.path.join(root, f"src{i}"))
            for i, (label, d) in enumerate(sources)}
    timer = cs.Timer()
    rng = np.random.default_rng(0)
    for label, producer, m, k, groups in SHAPES:
        splits, x, aux, perm, nbytes = inputs(rng, producer, m, k, groups)
        out = torch.empty_like(x)
        stream = build.stream()
        for src, fns in libs.items():
            row = []
            for name, (fn, split, fmt) in fns.items():
                extra = [site_blocks_per_cta(m, k)] if split else []
                no_fmt = [None] if fmt else []

                def run(fn=fn, extra=extra, no_fmt=no_fmt):
                    build.check(fn(build.ptr(x), build.ptr(aux), build.ptr(perm),
                                   *no_fmt, build.ptr(out), m, k, *splits,
                                   PRODUCERS[producer],
                                   m // max(groups, 1), 1e-5, *extra, stream),
                                "site_fakequant")
                row.append(f"{name}={timer.ms(run):.4f}")
            print(f"site [{src}] {label} ms: " + " ".join(row)
                  + f" bound={nbytes / cs.PEAK_BYTES_S * 1e3:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
