"""Activation quantize ops: the three site producers in front of the
per-32-block MX quantize (codes and scales) or fakequant (the bf16 grid
image).

Counterpart of ``micromix_tpu/ops/quantize_ops.py``
(``activation_quantize``, ``reorder_/rmsnorm_/silu_mul_quantize_x``,
``fakequant_device`` and the ``reorder_/rmsnorm_/silu_mul_fakequant_x``
twins).  The JAX package runs its Pallas quantize and site kernels only at
M <= 128 and XLA chains of the same values above; the port runs its
kernels (``kernels/quantize.quantize_mixed``, Kernel J, and
``kernels/fakequant.fakequant_site``, Kernel A) at every M on the GPU.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..kernels.fakequant import fakequant_site, fakequant_values
from ..kernels.quantize import quantize_mixed
from ..mx.mxtensor import MixedTensor


def _flatten(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1, x.shape[-1])


def fakequant_device(x2d: torch.Tensor, k4: int, k6: int, k8: int) -> torch.Tensor:
    """Device-layout activations (M, K) -> the exact bf16 grid image."""
    return fakequant_values(x2d.to(torch.float32), k4, k6, k8)


def rmsnorm_fakequant_x(x: torch.Tensor, gamma: torch.Tensor,
                        perm: Optional[torch.Tensor], k4: int, k6: int,
                        k8: int, *, eps: float = 1e-6) -> torch.Tensor:
    """rmsnorm(x) * gamma -> channel gather -> fakequant, bf16 (M, K) out."""
    return fakequant_site(_flatten(x), k4, k6, k8, producer="rms",
                          gamma=gamma, perm=perm, eps=eps)


def reorder_fakequant_x(x: torch.Tensor, perm: Optional[torch.Tensor],
                        k4: int, k6: int, k8: int) -> torch.Tensor:
    """Channel gather -> fakequant."""
    return fakequant_site(_flatten(x), k4, k6, k8, perm=perm)


def silu_mul_fakequant_x(gate: torch.Tensor, up: torch.Tensor,
                         k4: int, k6: int, k8: int) -> torch.Tensor:
    """silu(gate) * up -> fakequant, no gather (the down permutation is
    baked into the gate / up weight rows)."""
    return fakequant_site(_flatten(gate), k4, k6, k8, producer="silu",
                          up=_flatten(up))


def activation_quantize(x2d: torch.Tensor, k4: int, k6: int,
                        k8: int) -> MixedTensor:
    """Device-layout activations (M, K) -> MixedTensor (fp4 unpacked)."""
    return quantize_mixed(x2d, k4, k6, k8)


def reorder_quantize_x(x: torch.Tensor, perm: Optional[torch.Tensor],
                       k4: int, k6: int, k8: int) -> MixedTensor:
    """Channel gather -> MX quantize.  x: (..., K)."""
    return quantize_mixed(_flatten(x), k4, k6, k8, perm=perm)


def rmsnorm_quantize_x(x: torch.Tensor, gamma: torch.Tensor,
                       perm: Optional[torch.Tensor], k4: int, k6: int,
                       k8: int, *, eps: float = 1e-6) -> MixedTensor:
    """rmsnorm(x) * gamma -> channel gather -> MX quantize (the row moment
    over the unpermuted row, gamma gathered with it)."""
    return quantize_mixed(_flatten(x), k4, k6, k8, producer="rms",
                          gamma=gamma, perm=perm, eps=eps)


def silu_mul_quantize_x(gate: torch.Tensor, up: torch.Tensor,
                        k4: int, k6: int, k8: int) -> MixedTensor:
    """silu(gate) * up -> MX quantize, no gather (the down permutation is
    baked into the gate / up weight rows)."""
    return quantize_mixed(_flatten(gate), k4, k6, k8, producer="silu",
                          up=_flatten(up))
