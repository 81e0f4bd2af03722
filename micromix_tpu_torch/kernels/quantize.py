"""Activation MX quantize: a site's producer, then MXFP4/6/8 codes and
UE8M0 scale bytes per 32-block.

Counterpart of ``micromix_tpu/kernels/quantize.py`` (``quantize_mixed_pallas``)
and the producers the JAX package puts in front of it
(``ops/quantize_ops.reorder_/rmsnorm_/silu_mul_quantize_x``).
``quantize_mixed`` runs the CUDA kernel (``csrc/mx_quantize.cu``) on a
CUDA tensor, at every M, and its plain version on a CPU tensor.  The
codes are the split-plane GEMM's activation operand: fp4 unpacked, one
code per byte, device (block-interleaved) column order.

The kernel shares its producer and block arithmetic with the site kernel
(``csrc/mx_site.cuh``), so a code decoded times its block scale is the
site image's element, bit for bit.  The plain version is
``fakequant.site_producer_values`` followed by ``quantize_values``, the
JAX kernel's arithmetic: bit-exact with the JAX package for the plain
producer, and for rms and silu up to the ties that the f32 row-moment sum
order and the sigmoid's last bit can move (see ``kernels/fakequant.py``).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..mx import numerics as nx
from ..mx.formats import BLOCK_SIZE, UE8M0_BIAS
from ..mx.mxtensor import MixedTensor
from . import build
from .fakequant import _PRODUCERS, grid_blocks, site_producer_values

_SIG = {"mx_quantize": [build.PTR] * 9 + [build.INT] * 6
        + [build.FLOAT, build.PTR]}


def quantize_values(y: torch.Tensor, k4: int, k6: int, k8: int) -> MixedTensor:
    """f32 site values (M, K), device layout -> MixedTensor (fp4
    unpacked): the site image's grid values encoded, and the scale bytes."""
    m = y.shape[0]
    segs = iter(grid_blocks(y, k4, k6, k8))
    out = {}
    for name, kseg in (("4", k4), ("6", k6), ("8", k8)):
        if kseg:
            fmt, q, e = next(segs)
            out["fp" + name] = nx.encode(q, fmt).reshape(m, kseg)
            out["sf" + name] = (e + UE8M0_BIAS).to(torch.uint8)
        else:
            out["fp" + name] = out["sf" + name] = torch.zeros(
                (m, 0), dtype=torch.uint8, device=y.device)
    return MixedTensor(**out)


def quantize_mixed_plain(x, k4, k6, k8, *, producer="plain", gamma=None,
                         up=None, perm=None, eps=1e-6) -> MixedTensor:
    aux = gamma if producer == "rms" else up
    return quantize_values(site_producer_values(producer, x, aux, eps, perm),
                           k4, k6, k8)


def quantize_mixed(x: torch.Tensor, k4: int, k6: int, k8: int, *,
                   producer: str = "plain",
                   gamma: Optional[torch.Tensor] = None,
                   up: Optional[torch.Tensor] = None,
                   perm: Optional[torch.Tensor] = None,
                   eps: float = 1e-6) -> MixedTensor:
    """(M, K) bf16 site input(s) -> MixedTensor of codes and scale bytes.

    producer: "plain" (optional ``perm``) | "rms" (``gamma`` (K,) in
    source order, optional ``perm``) | "silu" (x = gate, ``up`` (M, K));
    ``perm`` (K,) int32 maps device position -> source channel.
    """
    m, k = x.shape
    if k != k4 + k6 + k8 or any(s % BLOCK_SIZE for s in (k4, k6, k8)):
        raise ValueError(f"quantize width {k} != {k4}+{k6}+{k8} in 32-blocks")
    if producer == "silu" and perm is not None:
        raise ValueError("the silu site takes no permutation")
    if not x.is_cuda:
        return quantize_mixed_plain(x, k4, k6, k8, producer=producer,
                                    gamma=gamma, up=up, perm=perm, eps=eps)
    aux = None
    if producer == "rms":
        aux = gamma.to(torch.float32).contiguous()
        if aux.shape != (k,):
            raise ValueError(f"gamma shape {tuple(aux.shape)} != ({k},)")
    elif producer == "silu":
        aux = up.contiguous()
        if aux.shape != (m, k) or aux.dtype != torch.bfloat16:
            raise ValueError("up must be (M, K) bf16")
    x = x.contiguous()
    if x.dtype != torch.bfloat16:
        raise ValueError(f"quantize input must be bf16, got {x.dtype}")
    if perm is not None:
        perm = perm.to(device=x.device, dtype=torch.int32).contiguous()
        if perm.shape != (k,):
            raise ValueError(f"perm shape {tuple(perm.shape)} != ({k},)")
    build.require_cuda("mx_quantize", x, aux, perm)

    def u8(cols):
        return torch.empty((m, cols), dtype=torch.uint8, device=x.device)

    out = MixedTensor(fp4=u8(k4), fp6=u8(k6), fp8=u8(k8), sf4=u8(k4 // 32),
                      sf6=u8(k6 // 32), sf8=u8(k8 // 32))
    if m == 0:
        return out
    lib = build.library("mx_quantize", _SIG)
    build.launches["mx_quantize"] += 1
    rc = lib.mx_quantize(build.ptr(x), build.ptr(aux), build.ptr(perm),
                         *[build.ptr(getattr(out, f)) for f in
                           ("fp4", "fp6", "fp8", "sf4", "sf6", "sf8")],
                         m, k, k4, k6, k8, _PRODUCERS[producer], float(eps),
                         build.stream())
    build.check(rc, "mx_quantize")
    return out
