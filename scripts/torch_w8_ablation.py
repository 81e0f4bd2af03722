#!/usr/bin/env python3
"""Where the wide ScaledW8 tile's time goes above 64 rows: Kernel B
(``csrc/w8_gemm.cu`` on the 128-row tile of ``csrc/w8_tile128.cuh``), or
with ``--stack`` / ``--grouped`` Kernels F (``csrc/w8_stack.cu``) and I
(``csrc/w8_grouped.cu``) on the same tile, timed whole and with one part
of its mainloop cut out, each variant built from a patched copy of the
sources.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 scripts/torch_w8_ablation.py [--splits | --stack | --grouped]

Variants: ``base`` (the sources as they are), ``nodecode`` (no code
decode in the loop: the MMAs read a stale tile), ``nomma`` (no
tensor-core product), ``noload`` (no copies after the ring's first
fill), ``nodecode_nomma``, ``empty`` (no decode, MMAs or refill copies:
launch, prologue, epilogue and any pass over the partials); ``stages3`` a
3-stage ring; ``bn128`` the same
loop on 128 x 128 tiles of 64 x 32 warp tiles, 128-deep steps and a
3-stage ring (the tile's first shape), whole
and as ``bn128_nodecode_nomma``.  Outputs of the variants that cut a
part out are wrong by design; only their time means anything.  Beside
them ``matmul``: ``torch.matmul`` of the same activation and the weight
dequantized to bf16 beforehand.  Times
are medians of CUDA-event readings with the L2 flushed
(``chip_smoke.Timer``), at the prefill shapes ``chip_smoke.py`` checks.
Prints one line per shape; the copies and libraries go to
``build/ablation_w8/`` (gitignored).

``--splits`` instead times the sources as they are with every K split
(``d``: each divisor, at most 16, of the 128-deep K steps) at prefill
row counts of o and down, beside the split ``w8_gemm_split`` picks.

``--stack`` times the stacked GEMM alone (``w8_stack_gemm`` on a site
image) at q|k|v and gate|up of Llama-3.1-8B (K=4096) at 128 and 512 rows,
and ``--grouped`` the grouped GEMM alone (``w8_grouped_gemm``) at
Mixtral-8x7B's w1|w3 (K=4096) and w2 (K=14336), 8 experts, 128 rows
each: the variants above from ``base`` to ``empty``, and the base
sources with every K split.
"""

from __future__ import annotations

import ctypes
import importlib
import os
import shutil
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from micromix_tpu_torch.kernels import build  # noqa: E402
from micromix_tpu_torch.kernels.fakequant import fakequant_values  # noqa: E402
from micromix_tpu_torch.mx.scaledw8 import dequantize_scaled_w8  # noqa: E402

mm = importlib.import_module("micromix_tpu_torch.kernels.mixed_matmul")

MMA = ("          ptx::mma(acc[mt][2 * np], afrag, bfrag[np][0], bfrag[np][1]);\n",
       "          ptx::mma(acc[mt][2 * np + 1], afrag, bfrag[np][2], bfrag[np][3]);\n")
DECODE = ("      if (more && kk % (BK / 16 / DC) == 0) "
          "decode(raw_next, ws_next, kk / (BK / 16 / DC));\n")
NARROW = [("constexpr int BM = 128, BN = 256, BK = 64;",
           "constexpr int BM = 128, BN = 128, BK = 128;")]
REFILL = ("    if (t + STAGES - 1 < tend) "
          "load(t + STAGES - 1, slot == 0 ? STAGES - 1 : slot - 1);\n")
STAGES3 = [("constexpr int STAGES = 4;", "constexpr int STAGES = 3;")]
VARIANTS = {
    "base": [],
    "nodecode": [(DECODE, "")],
    "nomma": [(m, "") for m in MMA],
    "noload": [(REFILL, "")],
    "nodecode_nomma": [(DECODE, "")] + [(m, "") for m in MMA],
    "empty": [(DECODE, ""), (REFILL, "")] + [(m, "") for m in MMA],
    "stages3": STAGES3,
    "bn128": NARROW + STAGES3,
    "bn128_nodecode_nomma": NARROW + STAGES3 + [(DECODE, "")] + [(m, "") for m in MMA],
}
SHAPES = ((512, 14336, 4096), (512, 4096, 4096), (512, 4096, 14336),
          (128, 4096, 4096), (1023, 4096, 14336))
# variants of the stack and grouped forms (their tile is B's as it is)
WIDE_VARIANTS = ("base", "nodecode", "nomma", "noload", "nodecode_nomma", "empty")
STACK_SHAPES = (("q|k|v", (4096, 1024, 1024), 128), ("gate|up", (14336, 14336), 128),
                ("q|k|v", (4096, 1024, 1024), 512))
GROUPED_SHAPES = (("w13", (14336, 14336), 4096, 128), ("w2", (4096,), 14336, 128))


def build_variants(out_dir: str, source: str = "w8_gemm", sig=None,
                   names=None) -> dict:
    sig = sig or mm._SIG
    procs = []
    for name, patches in VARIANTS.items():
        if names is not None and name not in names:
            continue
        d = os.path.join(out_dir, name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(build.CSRC, d)
        tile = os.path.join(d, "w8_tile128.cuh")
        src = open(tile).read()
        for old, new in patches:
            if old not in src:
                raise SystemExit(f"{name}: w8_tile128.cuh no longer has {old.strip()!r}")
            src = src.replace(old, new)
        with open(tile, "w") as f:
            f.write(src)
        lib = os.path.join(d, f"lib{source}.so")
        procs.append((name, lib, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", lib, os.path.join(d, f"{source}.cu")])))
    libs = {}
    for name, lib, proc in procs:
        if proc.wait() != 0:
            raise SystemExit(f"{name}: nvcc failed")
        libs[name] = ctypes.CDLL(lib)
        fn = getattr(libs[name], source)
        fn.argtypes = sig[source]
        fn.restype = ctypes.c_int
    return libs


def _every_split(timer, k, fn) -> str:
    """The base sources with every K split (divisors of the 128-deep steps)."""
    pick = mm.w8_gemm_split
    row = []
    try:
        for d in (d for d in range(1, min(k // 128, 16) + 1) if (k // 128) % d == 0):
            mm.w8_gemm_split = lambda *_, d=d: d
            row.append(f"d{d}={timer.ms(fn):.4f}")
    finally:
        mm.w8_gemm_split = pick
    return " ".join(row)


def ablate_wide(timer, grouped: bool) -> None:
    """Kernel F or I alone on a site image, every variant and every split."""
    import torch
    from micromix_tpu_torch.mx.scaledw8 import group_scaled_w8, stack_scaled_w8
    source = "w8_grouped" if grouped else "w8_stack"
    libs = build_variants(os.path.join(os.path.dirname(build.BUILD_DIR), f"ablation_{source}"),
                          source, mm._SIG_GROUPED if grouped else mm._SIG_STACK,
                          WIDE_VARIANTS)
    if grouped:
        cases = []
        for name, ns, k, c in GROUPED_SHAPES:
            splits = cs.SPLIT_4096 if k == 4096 else cs.SPLIT_14336
            gw = group_scaled_w8([[cs._w8_weight(n, k, splits) for _ in range(8)] for n in ns])
            img = fakequant_values(torch.randn(8 * c, k, device=cs.DEV), *splits).reshape(8, c, k)
            cases.append((f"{name} E=8 C={c} K={k}", k, lambda img=img, gw=gw: mm.w8_grouped_gemm(img, gw)))
    else:
        cases = []
        for name, ns, m in STACK_SHAPES:
            st = stack_scaled_w8([cs._w8_weight(n, 4096, cs.SPLIT_4096) for n in ns])
            img = fakequant_values(torch.randn(m, 4096, device=cs.DEV), *cs.SPLIT_4096)
            cases.append((f"{name} M={m} K=4096", 4096, lambda img=img, st=st: mm.w8_stack_gemm(img, st)))
    for label, k, fn in cases:
        row = []
        for name, lib in libs.items():
            build._libs[source] = lib
            row.append(f"{name}={timer.ms(fn):.4f}")
        build._libs[source] = libs["base"]
        print(f"{source} {label} ms: " + " ".join(row), flush=True)
        print(f"{source} {label} splits ms: " + _every_split(timer, k, fn), flush=True)


SPLIT_SHAPES = ((65, 4096, 4096), (128, 4096, 4096), (128, 4096, 14336),
                (129, 4096, 4096), (256, 4096, 4096), (300, 4096, 14336),
                (512, 4096, 4096), (512, 4096, 14336), (512, 14336, 4096),
                (1023, 4096, 4096))


def sweep_splits(timer) -> None:
    import torch
    for m, n, k in SPLIT_SHAPES:
        splits = cs.SPLIT_4096 if k == 4096 else cs.SPLIT_14336
        w = cs._w8_weight(n, k, splits)
        a = fakequant_values(torch.randn(m, k, device=cs.DEV), *splits)
        print(f"M={m} N={n} K={k} picked d{mm.w8_gemm_split(m, n, k)} ms: "
              + _every_split(timer, k, lambda: mm.mixed_matmul_w8(a, w)), flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_w8_ablation: no CUDA device", file=sys.stderr)
        return 2
    print(torch.cuda.get_device_name(0), flush=True)
    if "--splits" in sys.argv[1:]:
        sweep_splits(cs.Timer())
        return 0
    if "--stack" in sys.argv[1:] or "--grouped" in sys.argv[1:]:
        ablate_wide(cs.Timer(), "--grouped" in sys.argv[1:])
        return 0
    libs = build_variants(os.path.join(os.path.dirname(build.BUILD_DIR), "ablation_w8"))
    timer = cs.Timer()
    for m, n, k in SHAPES:
        splits = cs.SPLIT_4096 if k == 4096 else cs.SPLIT_14336
        w = cs._w8_weight(n, k, splits)
        a = fakequant_values(torch.randn(m, k, device=cs.DEV), *splits)
        wd = dequantize_scaled_w8(w, torch.bfloat16)
        row = []
        for name, lib in libs.items():
            build._libs["w8_gemm"] = lib
            row.append(f"{name}={timer.ms(lambda: mm.mixed_matmul_w8(a, w)):.4f}")
        row.append(f"matmul={timer.ms(lambda: torch.matmul(a, wd.t())):.4f}")
        print(f"M={m} N={n} K={k} splits={mm.w8_gemm_split(m, n, k)} ms: "
              + " ".join(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
