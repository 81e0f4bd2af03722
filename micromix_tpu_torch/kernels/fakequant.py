"""Activation fakequant sites: producer + per-32-block UE8M0 + RNE round.

Counterpart of ``micromix_tpu/kernels/fakequant.py``.  A site turns its
input into the exact bf16 grid image of the quantized activation, which
the ScaledW8 GEMM consumes.  ``fakequant_site`` runs the CUDA kernel
(``csrc/site_fakequant.cu``) on a CUDA tensor, at every M, and its plain
version ``fakequant_site_plain`` on a CPU tensor.

``fakequant_site_blocks`` is the block-format route of the same kernel:
the budgets-as-data sites of the hetero form (``models/hetero.py``), where
each canonical 32-block takes its format from a ``block_fmt`` array
instead of from a segment; its plain version is
``fakequant_site_blocks_plain``.

The plain version follows the JAX package's XLA chain
(``ops/quantize_ops.rmsnorm_fakequant_x`` and its twins) operation by
operation, so plain images are bit-exact.  rms and silu images may still
differ from the JAX package's, and the kernel's from the plain version's,
on a few channels: the order of the f32 row-moment sum and the last bit of
the sigmoid can move a round-half-even tie onto the neighbouring grid step.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..mx import numerics as nx
from ..mx.formats import BLOCK_SIZE, FP4, FP6, FP8
from . import build

_PRODUCERS = {"plain": 0, "rms": 1, "silu": 2}
_SIG = {"site_fakequant": [build.PTR, build.PTR, build.PTR, build.PTR,
                           build.PTR, build.INT, build.INT, build.INT, build.INT,
                           build.INT, build.INT, build.INT, build.FLOAT,
                           build.INT, build.PTR]}
# blocks the kernel's split launch aims at below that many rows: 2 for each
# of the H100's 132 SMs; a split block takes at most SITE_PASS 32-blocks
# (one pass of its 128 threads, 4 a 32-block)
SITE_BLOCKS = 264
SITE_PASS = 32


def site_blocks_per_cta(m: int, k: int) -> int:
    """32-blocks of a row each CTA of the site kernel takes, from M and K
    alone: K / 32 (whole rows) from ``SITE_BLOCKS`` rows, else the row split
    over about ``SITE_BLOCKS`` / M CTAs, at most ``SITE_PASS`` and at least
    4 32-blocks each."""
    nbk = k // BLOCK_SIZE
    if m >= SITE_BLOCKS:
        return nbk
    per = -(-nbk // -(-SITE_BLOCKS // max(m, 1)))
    return max(min(4, nbk), min(SITE_PASS, per))


def site_producer_values(producer: str, x: torch.Tensor,
                         aux: Optional[torch.Tensor], eps: float,
                         perm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (M, K) in source order -> f32 pre-quantize site values in device
    order.  rms: aux = gamma (K,) in source order, the row moment is taken
    over the unpermuted row; silu: x = gate, aux = up, no perm.  A plain
    site's ``perm`` may be (G, K): one gather per group of M // G rows."""
    xf = x.to(torch.float32)
    if perm is not None and perm.dim() == 2:
        g, k = perm.shape
        idx = perm.long()[:, None, :].expand(g, xf.shape[0] // g, k)
        return torch.gather(xf.reshape(g, -1, k), 2, idx).reshape(-1, k)
    if producer == "rms":
        # sum / K as jnp.mean does (torch's mean multiplies by 1/K)
        ms = nx.div((xf * xf).sum(dim=-1, keepdim=True), xf.shape[-1])
        rvar = 1.0 / torch.sqrt(ms + eps)
        g = aux.to(torch.float32)
        if perm is not None:
            xf, g = xf[:, perm], g[perm]
        return xf * rvar * g[None, :]
    if producer == "silu":
        return xf * torch.sigmoid(xf) * aux.to(torch.float32)
    return xf[:, perm] if perm is not None else xf


def grid_blocks(y: torch.Tensor, k4: int, k6: int, k8: int):
    """f32 site values (M, K), device layout -> for each non-empty segment
    (fmt, q (M, 32, nb) grid values, e (M, nb) block scale exponents).

    Block b of a segment holds columns {b + i*nb}: reshaping to
    (M, 32, nb) makes the 32 members of each block one axis.
    """
    off = 0
    for kseg, fmt in ((k4, FP4), (k6, FP6), (k8, FP8)):
        if kseg:
            xb = y[:, off:off + kseg].reshape(-1, BLOCK_SIZE, kseg // BLOCK_SIZE)
            e = nx.block_scale_exponent(xb.abs().amax(dim=-2), fmt)
            yield fmt, nx.quantize_to_grid(xb * nx.exp2i(-e)[:, None, :], fmt), e
        off += kseg


def fakequant_values(y: torch.Tensor, k4: int, k6: int, k8: int) -> torch.Tensor:
    """f32 site values (M, K), device layout -> bf16 grid image."""
    parts = [(q * nx.exp2i(e)[:, None, :]).reshape(q.shape[0], -1)
             for _, q, e in grid_blocks(y, k4, k6, k8)]
    out = parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)
    return out.to(torch.bfloat16)


def fakequant_site_plain(x, k4, k6, k8, *, producer="plain", gamma=None,
                         up=None, perm=None, eps=1e-6) -> torch.Tensor:
    aux = gamma if producer == "rms" else up
    return fakequant_values(site_producer_values(producer, x, aux, eps, perm),
                            k4, k6, k8)


def fakequant_site(x: torch.Tensor, k4: int, k6: int, k8: int, *,
                   producer: str = "plain",
                   gamma: Optional[torch.Tensor] = None,
                   up: Optional[torch.Tensor] = None,
                   perm: Optional[torch.Tensor] = None,
                   eps: float = 1e-6) -> torch.Tensor:
    """(M, K) bf16 site input(s) -> bf16 grid image (M, K), device layout.

    producer: "plain" (optional ``perm``) | "rms" (``gamma`` (K,) f32 in
    source order, optional ``perm``) | "silu" (x = gate, ``up`` (M, K)).
    ``perm`` (K,) int32 maps device position -> source channel; a plain
    site also takes (G, K), one permutation per group of M // G rows (the
    MoE experts' own sites).
    """
    m, k = x.shape
    if k != k4 + k6 + k8 or k % BLOCK_SIZE:
        raise ValueError(f"site width {k} != {k4}+{k6}+{k8}")
    if producer == "silu" and perm is not None:
        raise ValueError("the silu site takes no permutation")
    groups = 1
    if perm is not None and perm.dim() == 2:
        groups = perm.shape[0]
        if producer != "plain" or m % groups or perm.shape[1] != k:
            raise ValueError(f"a per-group perm {tuple(perm.shape)} needs a "
                             f"plain site of M % G == 0 rows, got {producer} "
                             f"({m}, {k})")
    if not x.is_cuda:
        return fakequant_site_plain(x, k4, k6, k8, producer=producer,
                                    gamma=gamma, up=up, perm=perm, eps=eps)
    if perm is not None and perm.shape[-1] != k:
        raise ValueError(f"perm shape {tuple(perm.shape)} != ({k},)")
    return _launch("site_fakequant", x, producer, gamma, up, perm, None,
                   (k4, k6, k8), m // groups, eps)


def _launch(name: str, x, producer, gamma, up, perm, fmt, splits,
            perm_rows: int, eps: float) -> torch.Tensor:
    """One launch of Kernel A on CUDA tensors: the segmented route
    (``fmt`` None, ``splits`` (k4, k6, k8)) or the block-format route
    (``fmt`` (K / 32,)), counted under ``name``."""
    m, k = x.shape
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
        raise ValueError(f"site input must be bf16, got {x.dtype}")
    if perm is not None:
        perm = perm.to(device=x.device, dtype=torch.int32).contiguous()
    if fmt is not None:
        fmt = fmt.to(device=x.device, dtype=torch.int32).contiguous()
    build.require_cuda(name, x, aux, perm, fmt)
    out = torch.empty((m, k), dtype=torch.bfloat16, device=x.device)
    if m == 0:
        return out
    lib = build.library("site_fakequant", _SIG)
    build.launches[name] += 1
    rc = lib.site_fakequant(build.ptr(x), build.ptr(aux), build.ptr(perm),
                            build.ptr(fmt), build.ptr(out), m, k, *splits,
                            _PRODUCERS[producer], perm_rows, float(eps),
                            site_blocks_per_cta(m, k), build.stream())
    build.check(rc, name)
    return out


# block_fmt ids: 0 MXFP4, 1 MXFP6, 2 MXFP8
BLOCK_FORMATS = (FP4, FP6, FP8)


def fakequant_blocks_values(y: torch.Tensor,
                            block_fmt: torch.Tensor) -> torch.Tensor:
    """f32 site values (M, K), canonical order -> bf16 grid image: block b
    (columns 32 b .. 32 b + 31) on the grid of format ``block_fmt[b]``.
    Every format is computed for every block and the block's own kept by
    ``torch.where``, in the JAX package's order (``hetero.fakequant_site``)."""
    m, k = y.shape
    xb = y.reshape(m, k // BLOCK_SIZE, BLOCK_SIZE)
    maxv = xb.abs().amax(dim=-1)
    keep = block_fmt.to(y.device).reshape(1, -1, 1)
    out = None
    for fid, fmt in enumerate(BLOCK_FORMATS):
        e = nx.block_scale_exponent(maxv, fmt)
        vals = nx.quantize_to_grid(xb * nx.exp2i(-e)[..., None], fmt) \
            * nx.exp2i(e)[..., None]
        out = vals if out is None else torch.where(keep == fid, vals, out)
    return out.reshape(m, k).to(torch.bfloat16)


def fakequant_site_blocks_plain(x, block_fmt, *, producer="plain", gamma=None,
                                up=None, perm=None, eps=1e-6) -> torch.Tensor:
    aux = gamma if producer == "rms" else up
    return fakequant_blocks_values(
        site_producer_values(producer, x, aux, eps, perm), block_fmt)


def fakequant_site_blocks(x: torch.Tensor, block_fmt: torch.Tensor, *,
                          producer: str = "plain",
                          gamma: Optional[torch.Tensor] = None,
                          up: Optional[torch.Tensor] = None,
                          perm: Optional[torch.Tensor] = None,
                          eps: float = 1e-6) -> torch.Tensor:
    """(M, K) bf16 site input(s) -> bf16 grid image (M, K), canonical
    column order, each 32-block in the format ``block_fmt`` ((K / 32,)
    int32, 0 fp4, 1 fp6, 2 fp8) gives it.

    The producers are the segmented route's: "plain" (optional ``perm``
    (K,), device column -> source channel), "rms" (``gamma`` (K,) in source
    order, the row normalised before the gather, 1 / sqrt of the row
    moment correctly rounded), "silu" (x = gate, ``up`` (M, K), the f32
    product quantized with no bf16 round).  One launch of Kernel A on a
    CUDA tensor; the plain version on a CPU tensor.
    """
    m, k = x.shape
    if k % BLOCK_SIZE or block_fmt.shape != (k // BLOCK_SIZE,):
        raise ValueError(f"block_fmt {tuple(block_fmt.shape)} for site width {k}")
    if producer == "silu" and perm is not None:
        raise ValueError("the silu site takes no permutation")
    if perm is not None and perm.shape != (k,):
        raise ValueError(f"perm shape {tuple(perm.shape)} != ({k},)")
    if not x.is_cuda:
        return fakequant_site_blocks_plain(x, block_fmt, producer=producer,
                                           gamma=gamma, up=up, perm=perm,
                                           eps=eps)
    return _launch("site_fakequant_blocks", x, producer, gamma, up, perm,
                   block_fmt, (0, 0, 0), m, eps)
