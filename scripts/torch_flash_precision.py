#!/usr/bin/env python3
"""How close Kernel E (``csrc/flash_attention.cu``) comes to exact
attention: its output, and its plain PyTorch version's, against a float64
reference on the same bf16 inputs, at Llama-3.1-8B's attention widths.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 scripts/torch_flash_precision.py [--against OTHER_CSRC_DIR]

``--against`` also builds ``flash_attention.cu`` from another source
directory with the same C interface (an earlier version of the kernel,
e.g. from a ``git archive`` of an older commit) and measures it on the
same inputs.  For each shape it prints one JSON line: per version the
largest error over the largest |reference| (``max_rel``), the mean
absolute error (``mean_abs``) and the share of outputs that differ from
the float64 reference rounded once to bf16 (``off_rne``, 0 for an
exact kernel).  Libraries go to ``build/flash_precision/`` (gitignored).
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from micromix_tpu_torch.kernels import build  # noqa: E402

# the module, not the function the package exports under the same name
fa = importlib.import_module("micromix_tpu_torch.kernels.flash_attention")

SHAPES = ((1, 128), (8, 128), (1, 2048))   # (B, S); H=32 Hkv=8 D=128
H, HKV, D = 32, 8, 128


def load(csrc: str, tag: str) -> ctypes.CDLL:
    out_dir = os.path.join(os.path.dirname(build.BUILD_DIR), "flash_precision", tag)
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, "libflash_attention.so")
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", lib,
                    os.path.join(csrc, "flash_attention.cu")], check=True)
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--against", default=None,
                    help="another csrc directory whose flash_attention.cu to measure too")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_flash_precision: no CUDA device", file=sys.stderr)
        return 2
    print(torch.cuda.get_device_name(0), flush=True)
    libs = {"kernel": load(str(build.CSRC), "kernel")}
    if args.against:
        libs["against"] = load(args.against, "against")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for b, s in SHAPES:
        q, k, v = (torch.randn(b, s, hh, D, device="cuda", generator=gen)
                   .to(torch.bfloat16) for hh in (H, HKV, HKV))
        ref = reference(q, k, v)
        line = {"shape": f"B={b} S={s} H={H} Hkv={HKV} D={D}",
                "plain": stats(fa.flash_attention_plain(q, k, v), ref)}
        for name, lib in libs.items():
            build._libs["flash_attention"] = lib
            line[name] = stats(fa.flash_attention(q, k, v), ref)
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
