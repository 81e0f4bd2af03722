"""Model configuration, linear containers, RoPE and the projection sites.

Counterpart of ``micromix_tpu/models/common.py`` for the Llama and
Mixtral paths with ScaledW8 or split-plane weights: ``ModelConfig``,
``DenseLinear`` (the dense model's linears and the MoE router),
``QuantLinear``, ``WeightOnlyLinear`` (MX weights, bf16 activations),
``Int8TurboLinear`` (W8A8 per-channel int8), ``QuantSite``,
``FakeQuantSite`` (the hetero form's budgets-as-data site, see
``models/hetero.py``), ``rmsnorm``, ``quantize_int_group`` (the
KV fake quantization of the accuracy mode), the RoPE helpers (including
llama3 frequency scaling), ``attention`` (the JAX package's XLA
attention, probabilities rounded to bf16) with ``causal_mask`` (offset
for a sequence shard) and ``causal_attention`` (the two together over
one sequence), and the legs of ``project_all``: dense (bf16,
weight-only or int8 linears, no site), hetero (Kernel A's block-format
route, then ScaledW8 per consumer), ScaledW8 per consumer, split-plane per
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

from ..kernels.fakequant import fakequant_site, fakequant_site_blocks
from ..kernels.flash_attention import causal_mask
from ..kernels.mixed_matmul import (W8_STACK_MAX_M, mixed_matmul,
                                    mixed_matmul_sp_stack,
                                    mixed_matmul_w8_site,
                                    mixed_matmul_w8_stack)
from ..mx.mxtensor import (MixedTensor, SplitPlaneStack, dequantize_mixed,
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
class WeightOnlyLinear:
    """Weight-only MX linear (bf16 activations, no calibration): a
    canonical-column-order ScaledW8 (MXFP4) or an MX ``MixedTensor`` (any
    format, its segments interleaved as stored)."""

    w: Union[ScaledW8, MixedTensor]
    bias: Optional[torch.Tensor] = None

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """ScaledW8: the ScaledW8 GEMM (Kernel B) on the bf16 rows, plus
        bias in bf16.  MixedTensor: the weight dequantized in canonical
        order (exact in f32), one f32 product, the bias added before the
        one round to bf16, as the JAX package's ``jnp.dot`` with f32
        output; the same path on every device."""
        lead = x.shape[:-1]
        x2d = x.reshape(-1, x.shape[-1]).to(torch.bfloat16)
        if isinstance(self.w, ScaledW8):
            y = add_bias(mixed_matmul(x2d, self.w), self.bias)
        else:
            y = torch.matmul(x2d.to(torch.float32),
                             dequantize_mixed(self.w, torch.float32).t())
            if self.bias is not None:
                y = y + self.bias.to(torch.float32)
            y = y.to(torch.bfloat16)
        return y.reshape(*lead, y.shape[-1])


# ``max |x| / 127.0`` as the JAX package's jitted programs compute it: XLA
# folds the constant divisor into a multiply by its f32 reciprocal
_INV_127 = 1.0 / 127.0


def int8_matmul(xq: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """xq (M, K) int8 . w (N, K) int8 ^T -> exact int32 (M, N).

    ``torch._int_mm`` (the JAX package leaves the product to XLA).  Its
    CUDA route takes more than 16 rows and K and N multiples of 8, so on
    the card the rows are zero-padded to a multiple of 8, at least 32 (a
    decode step's 8 rows become 32), and the padding cut off after."""
    m, k = xq.shape
    if not xq.is_cuda:
        return torch._int_mm(xq, w.t())
    if k % 8 or w.shape[0] % 8:
        raise ValueError(f"int8 product on the card needs K and N multiples "
                         f"of 8, got K={k} N={w.shape[0]}")
    mp = max(32, -(-m // 8) * 8)
    if mp != m:
        xq = torch.cat([xq, xq.new_zeros((mp - m, k))])
    return torch._int_mm(xq, w.t())[:m]


@dataclasses.dataclass
class Int8TurboLinear:
    """W8A8 linear: symmetric per-output-channel int8 weights (``w`` (N,
    K) int8, ``w_scale`` (N,) f32) and dynamic per-row int8 activations.
    Not MX numerics: the JAX package's out-of-spec speed mode."""

    w: torch.Tensor
    w_scale: torch.Tensor
    bias: Optional[torch.Tensor] = None

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """Each row quantized by its own max / 127 (round half to even,
        clipped to +-127), the exact int32 product, times the row scale,
        then the channel scale, in that order; bias; one round to bf16."""
        lead = x.shape[:-1]
        xf = x.reshape(-1, x.shape[-1]).to(torch.float32)
        sa = xf.abs().amax(dim=-1, keepdim=True) * torch.full(
            (), _INV_127, dtype=torch.float32, device=xf.device)
        sa = torch.clamp(sa, min=1e-12)
        xq = torch.clamp(torch.round(xf / sa), -127, 127).to(torch.int8)
        y = int8_matmul(xq, self.w).to(torch.float32) * sa * self.w_scale
        if self.bias is not None:
            y = y + self.bias.to(torch.float32)
        y = y.to(torch.bfloat16)
        return y.reshape(*lead, y.shape[-1])


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


@dataclasses.dataclass
class FakeQuantSite:
    """The hetero form's activation site (``models/hetero.py``): budgets as
    data.  ``perm`` (K,) int32 maps canonical (saliency-sorted) position ->
    source channel, or None (the down site: gate / up rows carry the
    sort); ``block_fmt`` (K / 32,) int32 gives each canonical 32-block's
    format, 0 MXFP4, 1 MXFP6, 2 MXFP8."""

    perm: Optional[torch.Tensor]
    block_fmt: torch.Tensor


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
    # torch.full, not torch.tensor: a Python number copied to the card by
    # torch.tensor ends in a stream synchronize, once a decode step
    inv = 1.0 / torch.pow(torch.full((), theta, dtype=torch.float32, device=device), exps)
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


# query heads whose f32 scores are formed at a time: bounds the scores and
# probabilities of a long sequence (one head of 2048 x 8192 f32 is 64 MiB)
_ATTN_HEAD_CHUNK = 8
_NEG = -1e30


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
    """q (B, S, H, D), k / v (B, T, Hkv, D), mask (S, T) bool (True =
    attend) -> (B, S, H, D) in v's dtype.

    The JAX package's XLA ``attention`` (TP v1, gather and Ulysses
    sequence parallelism): GQA by repeating the KV heads, f32 scores
    divided by sqrt(D), masked to -1e30, an f32 softmax, the
    probabilities rounded to v's dtype (bf16) before P.V, which sums in
    f32 and rounds once.  Plain PyTorch on every device (no Pallas kernel
    computes it in the JAX package), a few query heads at a time."""
    h, d = q.shape[2], q.shape[3]
    rep = h // k.shape[2]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    scale = torch.full((), math.sqrt(d), dtype=torch.float32, device=q.device)
    keep = mask[None, None]
    outs = []
    for h0 in range(0, h, _ATTN_HEAD_CHUNK):
        hs = slice(h0, h0 + _ATTN_HEAD_CHUNK)
        scores = torch.einsum("bshd,bthd->bhst", q[:, :, hs].to(torch.float32),
                              k[:, :, hs].to(torch.float32)) / scale
        scores = torch.where(keep, scores, _NEG)
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        del scores
        outs.append(torch.einsum("bhst,bthd->bshd", probs.to(torch.float32),
                                 v[:, :, hs].to(torch.float32)).to(v.dtype))
    return torch.cat(outs, dim=2) if len(outs) > 1 else outs[0]


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     sliding_window: Optional[int] = None) -> torch.Tensor:
    """``attention`` under the causal mask of one whole sequence: the JAX
    package's ``forward(use_flash=False)``, as ``forward(attend=)``
    takes it."""
    mask = causal_mask(q.shape[1], k.shape[1], sliding_window,
                       device=q.device)
    return attention(q, k, v, mask)


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
    consumers (q/k/v, gate/up): a ``FakeQuantSite`` (hetero) gives its
    consumers the block-format route's image; ScaledW8 consumers of a
    segmented site take its bf16 image,
    split-plane ones its MX codes; a single split-plane consumer (o) runs
    as a one-section stack.  Dense, weight-only and int8 linears
    take x (rmsnormed when ``norm_gamma`` is given) with no site.  ``stack``: the consumers
    row-stacked (``stack_layer_projections``, a ScaledW8Stack or
    SplitPlaneStack); ``linears`` is then ignored and the stacked leg
    runs.
    """
    lead = x.shape[:-1]
    if stack is not None:
        return _project_stack(x, site, stack, norm_gamma, rms_eps, lead)
    if not isinstance(linears[0], QuantLinear):
        # dense, weight-only or int8 linears: [rmsnorm ->] each, no site
        xn = rmsnorm(x, norm_gamma, rms_eps) if norm_gamma is not None else x
        return [lin(xn) for lin in linears]
    x2d = x.reshape(-1, x.shape[-1])
    if isinstance(site, FakeQuantSite):
        # hetero: one launch of Kernel A's block-format route, whose image
        # every (canonical-order ScaledW8) consumer takes
        kw = {} if norm_gamma is None else dict(producer="rms",
                                                 gamma=norm_gamma, eps=rms_eps)
        qx = fakequant_site_blocks(x2d, site.block_fmt, perm=site.perm, **kw)
        return [lin(qx).reshape(*lead, -1) for lin in linears]
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
