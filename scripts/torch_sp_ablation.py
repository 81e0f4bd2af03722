#!/usr/bin/env python3
"""Where Kernel K's time goes: the split-plane GEMM (``csrc/sp_gemm.cu``
on the tile of ``csrc/sp_tile.cuh``) timed whole and with one part of its
mainloop cut out, each variant built from a patched copy of the sources.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 scripts/torch_sp_ablation.py

Variants: ``base`` (the sources as they are), ``nodecode`` (no weight
decode: the MMAs read a stale tile), ``nomma`` (no tensor-core product),
``noload`` (no copies after the ring's first fill), ``nodecode_nomma``,
and ``bn64`` (the 128-row tile on 64 weight rows and 4 x 2 warps, as
before it took 128).  A variant's output is wrong by design; only its
time means anything.  Times are medians of CUDA-event readings with the
L2 flushed (``chip_smoke.Timer``), at the shapes ``chip_smoke.py`` checks
(a 256- and a 128-row prefill chunk's down projection, a decode step's
gate).  Prints one line per shape; the copies and libraries go to
``build/ablation/`` (gitignored).
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
from micromix_tpu_torch.kernels.quantize import quantize_mixed  # noqa: E402

mm = importlib.import_module("micromix_tpu_torch.kernels.mixed_matmul")

MMA = ("          ptx::mma(acc[mt][2 * np], afrag, bfrag[np][0], bfrag[np][1]);\n",
       "          ptx::mma(acc[mt][2 * np + 1], afrag, bfrag[np][2], bfrag[np][3]);\n")
DECODE = "    decode(t, slot);\n"
REFILL = "    if (t + NS - 1 < tend) load(t + NS - 1, (slot + NS - 1) % NS);\n"
VARIANTS = {
    "base": [],
    "nodecode": [(DECODE, "")],
    "nomma": [(m, "") for m in MMA],
    "noload": [(REFILL, "")],
    "nodecode_nomma": [(DECODE, "")] + [(m, "") for m in MMA],
    "bn64": [
        ("  static constexpr int BN = BM == 128 ? 128 : 64;",
         "  static constexpr int BN = 64;"),
        ("  static constexpr int WN = 4; ",
         "  static constexpr int WN = BM == 128 ? 2 : 4; "),
        ("  static constexpr int WM = BM == 128 ? 2 : 1; ",
         "  static constexpr int WM = BM == 128 ? 4 : 1; "),
        ("  static constexpr int STAGES = BM == 128 ? 2 : (BM == 16 ? 4 : 3);",
         "  static constexpr int STAGES = BM == 16 ? 4 : 3;")],
}
SHAPES = ((256, 4096, 14336, cs.SPLIT_14336), (128, 4096, 14336, cs.SPLIT_14336),
          (8, 14336, 4096, cs.SPLIT_4096))


def build_variants(out_dir: str) -> dict:
    procs = []
    for name, patches in VARIANTS.items():
        d = os.path.join(out_dir, name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(build.CSRC, d)
        tile = os.path.join(d, "sp_tile.cuh")
        src = open(tile).read()
        for old, new in patches:
            if old not in src:
                raise SystemExit(f"{name}: sp_tile.cuh no longer has {old.strip()!r}")
            src = src.replace(old, new)
        with open(tile, "w") as f:
            f.write(src)
        lib = os.path.join(d, "libsp_gemm.so")
        procs.append((name, lib, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", lib, os.path.join(d, "sp_gemm.cu")])))
    libs = {}
    for name, lib, proc in procs:
        if proc.wait() != 0:
            raise SystemExit(f"{name}: nvcc failed")
        libs[name] = ctypes.CDLL(lib)
        libs[name].sp_gemm.argtypes = mm._SIG_SP["sp_gemm"]
        libs[name].sp_gemm.restype = ctypes.c_int
    return libs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_sp_ablation: no CUDA device", file=sys.stderr)
        return 2
    print(torch.cuda.get_device_name(0), flush=True)
    libs = build_variants(os.path.join(os.path.dirname(build.BUILD_DIR), "ablation"))
    timer = cs.Timer()
    for m, n, k, splits in SHAPES:
        w = cs._sp_weight(n, k, splits)
        a = quantize_mixed(cs._site_input(m, k), *splits)
        row = []
        for name, lib in libs.items():
            build._libs["sp_gemm"] = lib
            row.append(f"{name}={timer.ms(lambda: mm.mixed_matmul_sp(a, w)):.4f}")
        print(f"M={m} N={n} K={k} ms: " + " ".join(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
