"""Model configuration, linear containers, RoPE and the projection sites.

Counterpart of ``micromix_tpu/models/common.py`` for the Llama and
Mixtral paths with ScaledW8 or split-plane weights: ``ModelConfig``,
``DenseLinear`` (the dense model's linears and the MoE router),
``QuantLinear``, ``QuantSite``, ``rmsnorm``, ``quantize_int_group`` (the
KV fake quantization of the accuracy mode), the RoPE helpers (including
llama3 frequency scaling) and the legs of ``project_all``: dense (bf16,
no site), ScaledW8 per consumer, split-plane per
consumer (the MX quantize, then one split-plane GEMM per consumer), a
single split-plane consumer wrapped as a one-section stack, and the
stacked legs of both layouts.  Parameters
are plain dicts of tensors and these small dataclasses; every bf16 rounding
point of the JAX code is kept (rmsnorm output, RoPE output, GEMM outputs,
bf16 residual adds).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple, Union

import torch

from ..kernels.fakequant import fakequant_site
from ..kernels.mixed_matmul import (W8_STACK_MAX_M, mixed_matmul,
                                    mixed_matmul_sp_stack,
                                    mixed_matmul_w8_site,
                                    mixed_matmul_w8_stack)
from ..mx.mxtensor import (MixedTensor, SplitPlaneStack,
                           dequantize_mixed_device, stack_split_plane)
from ..mx.numerics import div
from ..mx.scaledw8 import ScaledW8, ScaledW8Stack, dequantize_stack
from ..ops.quantize_ops import reorder_quantize_x, rmsnorm_quantize_x


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Decoder configuration; the fields of the JAX package's ModelConfig.
    This port runs ``arch="llama"`` and ``arch="mixtral"`` (MoE experts,
    dense or capacity dispatch)."""

    arch: str
    vocab_size: int
    hidden_size: int
    intermediate_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    rope_theta: float = 500000.0
    rms_eps: float = 1e-5
    qkv_bias: bool = False
    tie_embeddings: bool = False
    sliding_window: Optional[int] = None
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_capacity_factor: Optional[float] = None
    max_position_embeddings: int = 32768
    # ("llama3", factor, low_freq_factor, high_freq_factor, orig_max_pos)
    # or ("linear", factor)
    rope_scaling: Optional[Tuple] = None

    def __post_init__(self):
        if self.rope_scaling is not None:
            object.__setattr__(self, "rope_scaling", tuple(self.rope_scaling))

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0


@dataclasses.dataclass
class DenseLinear:
    """bf16 linear: the unquantized input to surgery, and the MoE router,
    which stays bf16."""

    w: torch.Tensor                   # (out_features, in_features)
    bias: Optional[torch.Tensor] = None

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """bf16 product accumulated in f32, plus bias, rounded to bf16 (the
        JAX package computes it outside any kernel)."""
        y = torch.matmul(x.to(torch.float32), self.w.to(torch.float32).t())
        if self.bias is not None:
            y = y + self.bias.to(torch.float32)
        return y.to(torch.bfloat16)


@dataclasses.dataclass
class QuantLinear:
    """MX-quantized linear (ScaledW8, or a split-plane MixedTensor) plus
    optional bf16 bias."""

    w: Union[ScaledW8, MixedTensor]
    bias: Optional[torch.Tensor] = None

    def __call__(self, qx) -> torch.Tensor:
        """qx: a MixedTensor of activation codes, or, for a ScaledW8
        weight, the exact bf16 image of the quantized activation."""
        return add_bias(mixed_matmul(qx, self.w), self.bias)


@dataclasses.dataclass
class QuantSite:
    """One activation-quantization site: segment split and gather.

    ``perm`` (K,) int32 maps device-layout position -> source channel (the
    calibration reorder composed with the per-segment block interleave);
    None means the producer already emits device layout (down input).
    ``benes`` is accepted and ignored: the JAX package's Benes route
    encodes the same permutation for the TPU's lanes, and on the GPU the
    gather is an indexed load of ``perm``.
    """

    k4: int
    k6: int
    k8: int
    perm: Optional[torch.Tensor] = None
    benes: Optional[torch.Tensor] = None

    @property
    def splits(self):
        return (self.k4, self.k6, self.k8)


def add_bias(y: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    return y if bias is None else y + bias


def rmsnorm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    ms = div((xf * xf).sum(dim=-1, keepdim=True), xf.shape[-1])
    return (xf * torch.rsqrt(ms + eps) * g.to(torch.float32)).to(torch.bfloat16)


def quantize_int_group(x: torch.Tensor, nbits: int = 4,
                       group_size: int = 128) -> torch.Tensor:
    """Asymmetric int-group fake quantization (the KV accuracy mode):
    per group a [min, max] uint grid, round half to even, then clamp, then
    dequantize; the result in x's dtype.  ``/ qmax`` is a multiply by the
    f32 reciprocal, as XLA folds it in the JAX package's jitted forward;
    the other divisions are IEEE."""
    xf = x.to(torch.float32).reshape(-1, group_size)
    gmax = xf.amax(dim=-1, keepdim=True)
    gmin = xf.amin(dim=-1, keepdim=True)
    qmax = float(2 ** nbits - 1)
    scales = torch.clamp(gmax - gmin, min=1e-5) * torch.tensor(
        1.0 / qmax, dtype=torch.float32, device=x.device)
    base = torch.clamp(torch.round(-gmin / scales), 0.0, qmax)
    q = torch.clamp(torch.round(xf / scales) + base, 0.0, qmax)
    return ((q - base) * scales).reshape(x.shape).to(x.dtype)


def rope_inv_freq(head_dim: int, theta: float,
                  rope_scaling: Optional[Tuple] = None,
                  device=None) -> torch.Tensor:
    """Per-pair inverse frequencies (head_dim // 2,) f32, with scaling."""
    exps = div(torch.arange(0, head_dim, 2, dtype=torch.float32, device=device),
               head_dim)
    inv = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32, device=device), exps)
    if rope_scaling is None:
        return inv
    kind = rope_scaling[0]
    if kind == "linear":
        return div(inv, float(rope_scaling[1]))
    if kind == "llama3":
        _, factor, low_f, high_f, orig_max = rope_scaling
        factor, low_f, high_f = float(factor), float(low_f), float(high_f)
        orig_max = float(orig_max)

        def over(num: float, den: torch.Tensor) -> torch.Tensor:
            # true f32 division (``float / tensor`` multiplies by 1/den)
            return torch.full_like(den, num) / den

        wavelen = over(2.0 * math.pi, inv)
        low_wl = orig_max / low_f
        high_wl = orig_max / high_f
        smooth = div(over(orig_max, wavelen) - low_f, high_f - low_f)
        smoothed = div((1.0 - smooth) * inv, factor) + smooth * inv
        return torch.where(wavelen < high_wl, inv,
                           torch.where(wavelen > low_wl, div(inv, factor), smoothed))
    raise ValueError(f"unsupported rope_scaling kind {kind!r}")


def rope_angles(positions: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """positions (S,) -> angles (S, head_dim), the halves duplicated."""
    inv = rope_inv_freq(cfg.head_dim, cfg.rope_theta, cfg.rope_scaling,
                        device=positions.device)
    freqs = positions.to(torch.float32)[:, None] * inv[None, :]
    return torch.cat([freqs, freqs], dim=-1)


def rope_table(positions: torch.Tensor, cfg: ModelConfig):
    """positions (S,) -> (cos, sin) each (S, head_dim) f32."""
    ang = rope_angles(positions, cfg)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (..., S, H, D) with tables (S, D); rounds back to x's dtype."""
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    c, s = cos[:, None, :], sin[:, None, :]
    return (x.to(torch.float32) * c + rotated.to(torch.float32) * s).to(x.dtype)


# lm_head rows converted to f32 at a time (bounds the f32 copy: 16384 x 4096
# f32 is 256 MiB, against 2 GiB for the whole 128256-row head)
_LM_HEAD_CHUNK = 16384


def lm_logits(h: torch.Tensor, lm_head: torch.Tensor) -> torch.Tensor:
    """h (..., hidden) bf16 -> f32 logits; f32 accumulation and output, as
    the JAX package's dot with preferred_element_type=f32."""
    hf = h.to(torch.float32)
    return torch.cat([torch.matmul(hf, w.to(torch.float32).t())
                      for w in lm_head.split(_LM_HEAD_CHUNK)], dim=-1)


# Rows up to which a split-plane stack runs the stacked GEMM kernel, and
# batch rows up to which decode pairs its ScaledW8 stacks (the JAX
# package's PALLAS_FAKEQUANT_MAX_M); above, the stack is dequantized and
# multiplied in one dense product, as the JAX package leaves it to XLA.
# A ScaledW8 stack has its own limit, ``W8_STACK_MAX_M``.
STACK_KERNEL_MAX_M = 128


def _site_kw(site: QuantSite, norm_gamma, rms_eps: float) -> dict:
    kw = dict(perm=site.perm)
    if norm_gamma is not None:
        kw.update(producer="rms", gamma=norm_gamma, eps=rms_eps)
    return kw


def _sp_fusable(linears) -> bool:
    """One split-plane consumer whose rows are 128-aligned and fp4
    packed: it wraps into a one-section stack without a copy."""
    if len(linears) != 1 or not isinstance(linears[0].w, MixedTensor):
        return False
    w = linears[0].w
    return (w.fp4_packed or w.k4 == 0) and w.rows % 128 == 0


def project_all(x: torch.Tensor, site: Optional[QuantSite],
                linears: Optional[List[QuantLinear]],
                norm_gamma: Optional[torch.Tensor] = None,
                rms_eps: float = 1e-6,
                stack=None) -> List[torch.Tensor]:
    """[rmsnorm ->] the site's quantize -> every consumer of the site.

    x (..., K) -> [(..., N_i)].  The site runs once and feeds the sibling
    consumers (q/k/v, gate/up): ScaledW8 consumers take its bf16 image,
    split-plane ones its MX codes; a single split-plane consumer (o) runs
    as a one-section stack.  Dense linears take x (rmsnormed when
    ``norm_gamma`` is given) with no site.  ``stack``: the consumers
    row-stacked (``stack_layer_projections``, a ScaledW8Stack or
    SplitPlaneStack); ``linears`` is then ignored and the stacked leg
    runs.
    """
    lead = x.shape[:-1]
    if stack is not None:
        return _project_stack(x, site, stack, norm_gamma, rms_eps, lead)
    if not isinstance(linears[0], QuantLinear):
        # the dense model: [rmsnorm ->] each bf16 linear, no site
        xn = rmsnorm(x, norm_gamma, rms_eps) if norm_gamma is not None else x
        return [lin(xn) for lin in linears]
    x2d = x.reshape(-1, x.shape[-1])
    if linears[0].w.segments() != site.splits:
        raise ValueError(f"site {site.splits} vs weight {linears[0].w.segments()}")
    if all(isinstance(lin.w, ScaledW8) for lin in linears):
        first, rest = linears[0], linears[1:]
        y0, qx = mixed_matmul_w8_site(x2d, first.w, emit_qx=True,
                                      **_site_kw(site, norm_gamma, rms_eps))
        outs = [add_bias(y0, first.bias)] + [lin(qx) for lin in rest]
    elif _sp_fusable(linears):
        st = stack_split_plane([linears[0].w], [linears[0].bias])
        return _project_stack(x, site, st, norm_gamma, rms_eps, lead)
    else:
        if norm_gamma is not None:
            qx = rmsnorm_quantize_x(x2d, norm_gamma, site.perm, *site.splits,
                                    eps=rms_eps)
        else:
            qx = reorder_quantize_x(x2d, site.perm, *site.splits)
        outs = [lin(qx) for lin in linears]
    return [o.reshape(*lead, o.shape[-1]) for o in outs]


def _project_stack(x, site: QuantSite, stack, norm_gamma, rms_eps: float,
                   lead) -> List[torch.Tensor]:
    """project_all's stacked leg: the stacked GEMM at up to
    ``W8_STACK_MAX_M`` (ScaledW8) or ``STACK_KERNEL_MAX_M`` (split-plane)
    rows; above, the site, one dequantized stack and one dense product.
    Biases are added per section afterwards."""
    if stack.segments() != site.splits:
        raise ValueError(f"site {site.splits} vs stack {stack.segments()}")
    split_plane = isinstance(stack, SplitPlaneStack)
    x2d = x.reshape(-1, x.shape[-1])
    kw = _site_kw(site, norm_gamma, rms_eps)
    if x2d.shape[0] <= (STACK_KERNEL_MAX_M if split_plane else W8_STACK_MAX_M):
        fn = mixed_matmul_sp_stack if split_plane else mixed_matmul_w8_stack
        outs = fn(x2d, stack, **kw)
    else:
        outs = stack_dense_apply(fakequant_site(x2d, *stack.segments(), **kw),
                                 stack)
    outs = [add_bias(o, b) for o, b in zip(outs, stack.biases)]
    return [o.reshape(*lead, o.shape[-1]) for o in outs]


def stack_dense_apply(qx: torch.Tensor, stack) -> List[torch.Tensor]:
    """The stacked leg above its kernel's row limit, on the site image qx
    (M, K): the whole stack dequantized and one dense product (bf16 with
    f32 sums on the GPU; on the CPU the f32 product rounded once, the
    plain versions' form), split into its sections."""
    split_plane = isinstance(stack, SplitPlaneStack)

    def dense(dtype):
        return (dequantize_mixed_device(stack.mt, dtype) if split_plane
                else dequantize_stack(stack, dtype))
    if qx.is_cuda:
        y = torch.matmul(qx, dense(torch.bfloat16).t())
    else:
        y = torch.matmul(qx.to(torch.float32),
                         dense(torch.float32).t()).to(torch.bfloat16)
    outs, off = [], 0
    for n, p in zip(stack.sections, stack.padded):
        outs.append(y[:, off:off + n])
        off += p
    return outs
