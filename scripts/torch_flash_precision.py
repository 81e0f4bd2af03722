#!/usr/bin/env python3
"""How close Kernel E (``csrc/flash_attention.cu``) comes to exact
attention: its output, and its plain PyTorch version's, against a float64
reference on the same bf16 inputs, at Llama-3.1-8B's attention widths.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 scripts/torch_flash_precision.py [--variants] [--against OTHER_CSRC_DIR]

``--variants`` also builds the kernel from patched copies of the sources
with each other choice of the P.V arithmetic in ``csrc/flash_tile.cuh``
(the kernel: P in three bf16 terms, each tile's P.V summed in a zeroed
accumulator and added to O in f32; ``termsN``: P in N terms summed into O
inside the MMAs; ``terms2_tile_acc``: two terms, the tile accumulator).
``--against`` also
builds ``flash_attention.cu`` from another source directory with the
same C interface (an earlier version of the kernel, e.g. from a
``git archive`` of an older commit).  For each shape it prints one JSON
line: per version the largest error over the largest |reference|
(``max_rel``), the mean absolute error (``mean_abs``), the share of
outputs that differ from the float64 reference rounded once to bf16
(``off_rne``, 0 for an exact kernel) and the kernel's median time
(``ms``, CUDA events, L2 flushed).  Libraries go to
``build/flash_precision/`` (gitignored).

``--simulate`` needs no GPU: on the CPU, in float64, it splits the f32
probabilities of one causal head group (S=512, H=8, D=128) into 1, 2 or 3
bf16 terms and sums P.V exactly, so the terms' own effect on ``off_rne``
shows without any tensor-core rounding.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import os
import shutil
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from chip_smoke import Timer  # noqa: E402
from micromix_tpu_torch.kernels import build  # noqa: E402

# the module, not the function the package exports under the same name
fa = importlib.import_module("micromix_tpu_torch.kernels.flash_attention")

SHAPES = ((1, 128), (8, 128), (1, 512), (1, 2048))   # (B, S); H=32 Hkv=8 D=128
H, HKV, D = 32, 8, 128
# the P.V choices besides the kernel's own, as patches of flash_tile.cuh;
# "terms2" is the kernel before the repair
TERMS = "constexpr int PV_TERMS = 3;"
INTO_O = [("ptx::mma(t[0], ai, b[0], b[1]);", "ptx::mma(o[2 * dp], ai, b[0], b[1]);"),
          ("ptx::mma(t[1], ai, b[2], b[3]);", "ptx::mma(o[2 * dp + 1], ai, b[2], b[3]);")]
VARIANTS = {
    "terms1": [(TERMS, TERMS.replace("3", "1"))] + INTO_O,
    "terms2": [(TERMS, TERMS.replace("3", "2"))] + INTO_O,
    "terms2_tile_acc": [(TERMS, TERMS.replace("3", "2"))],
    "terms3": INTO_O,
}


def start_build(csrc: str, tag: str, patches=()) -> tuple:
    """Start one nvcc of ``flash_attention.cu`` from a copy of ``csrc``
    with ``patches`` applied to its ``flash_tile.cuh``."""
    out_dir = os.path.join(os.path.dirname(build.BUILD_DIR), "flash_precision", tag)
    shutil.rmtree(out_dir, ignore_errors=True)
    shutil.copytree(csrc, out_dir)
    tile = os.path.join(out_dir, "flash_tile.cuh")
    if patches:
        src = open(tile).read()
        for old, new in patches:
            if old not in src:
                raise SystemExit(f"{tag}: flash_tile.cuh no longer has {old!r}")
            src = src.replace(old, new)
        with open(tile, "w") as f:
            f.write(src)
    lib = os.path.join(out_dir, "libflash_attention.so")
    proc = subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-o", lib,
                             os.path.join(out_dir, "flash_attention.cu")])
    return proc, lib


def load(proc, lib: str) -> ctypes.CDLL:
    if proc.wait() != 0:
        raise RuntimeError(f"nvcc failed for {lib}")
    cdll = ctypes.CDLL(lib)
    cdll.flash_attention.argtypes = fa._SIG["flash_attention"]
    cdll.flash_attention.restype = ctypes.c_int
    return cdll


def reference(q, k, v) -> torch.Tensor:
    """Causal GQA attention in float64 on the bf16 inputs."""
    b, s, h, d = q.shape
    g = h // k.shape[2]
    q64, k64, v64 = (x.double() for x in (q, k, v))
    k64 = k64.repeat_interleave(g, dim=2)
    v64 = v64.repeat_interleave(g, dim=2)
    scores = torch.einsum("bshd,bthd->bhst", q64, k64) / d ** 0.5
    mask = fa.causal_mask(s, s, device=q.device)
    probs = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
    return torch.einsum("bhst,bthd->bshd", probs, v64)


def stats(out: torch.Tensor, ref: torch.Tensor) -> dict:
    err = (out.double() - ref).abs()
    return dict(max_rel=float(err.max() / ref.abs().max()),
                mean_abs=float(err.mean()),
                off_rne=float((out != ref.to(torch.bfloat16)).double().mean()))


def simulate() -> None:
    """The P split's own effect, in exact (float64) sums on the CPU."""
    gen = torch.Generator().manual_seed(0)
    s, h = 512, 8
    q, k, v = (torch.randn(1, s, h, D, generator=gen).to(torch.bfloat16)
               for _ in range(3))
    ref = reference(q, k, v)[0]
    scores = torch.einsum("shd,thd->hst", q[0].double(), k[0].double()) / D ** 0.5
    scores = scores.masked_fill(~fa.causal_mask(s, s), float("-inf"))
    e = torch.exp(scores - scores.amax(-1, keepdim=True)).float()
    den = e.sum(-1).transpose(0, 1)[..., None]                  # (S, H, 1) f32
    for terms in (1, 2, 3):
        p, rest = torch.zeros_like(e, dtype=torch.float64), e
        for _ in range(terms):
            t = rest.to(torch.bfloat16).float()
            p, rest = p + t.double(), rest - t
        o = (torch.einsum("hst,thd->shd", p, v[0].double()).float() / den).to(torch.bfloat16)
        print(json.dumps({"simulate": f"S={s} H={h} D={D} P in {terms} bf16 terms, "
                          "exact sums (CPU, float64)", **stats(o, ref)}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", action="store_true",
                    help="also measure the other P.V choices of flash_tile.cuh")
    ap.add_argument("--against", default=None,
                    help="another csrc directory whose flash_attention.cu to measure too")
    ap.add_argument("--simulate", action="store_true",
                    help="the P split's effect in exact sums, on the CPU")
    args = ap.parse_args()
    if args.simulate:
        simulate()
        return 0
    if not torch.cuda.is_available():
        print("torch_flash_precision: no CUDA device", file=sys.stderr)
        return 2
    print(torch.cuda.get_device_name(0), flush=True)
    builds = {"kernel": start_build(str(build.CSRC), "kernel")}
    if args.variants:
        for tag, patches in VARIANTS.items():
            builds[tag] = start_build(str(build.CSRC), tag, patches)
    if args.against:
        builds["against"] = start_build(args.against, "against")
    libs = {name: load(*b) for name, b in builds.items()}
    timer = Timer()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for b, s in SHAPES:
        q, k, v = (torch.randn(b, s, hh, D, device="cuda", generator=gen)
                   .to(torch.bfloat16) for hh in (H, HKV, HKV))
        ref = reference(q, k, v)
        line = {"shape": f"B={b} S={s} H={H} Hkv={HKV} D={D}",
                "plain": stats(fa.flash_attention_plain(q, k, v), ref)}
        for name, lib in libs.items():
            build._libs["flash_attention"] = lib
            line[name] = dict(stats(fa.flash_attention(q, k, v), ref),
                              ms=timer.ms(lambda: fa.flash_attention(q, k, v)))
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
