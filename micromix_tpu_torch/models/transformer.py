"""Full-sequence decoder forward for a dense or quantized Llama, or a
quantized Mixtral.

Counterpart of ``micromix_tpu/models/transformer.py`` (``forward``,
``attention_block``, ``mlp_block``, the ScaledW8 and split-plane branches
of ``_down_proj_q``, and the Mixtral ``moe_block`` with dense or capacity
dispatch); quantized layers carry per-consumer q/k/v and gate/up or their
stacks (``qkv_stack``, ``gateup_stack``: ScaledW8Stack or
SplitPlaneStack), and per-expert dicts (``experts``) or, for ScaledW8
experts, their grouped form (``experts_grouped``).  A dense Llama layer
(``DenseLinear``s, no sites) runs its bf16 linears; its calibration taps
(``tap``) see the four site inputs, and ``kv_quant_bits`` fake-quantizes
K and V per head (``quantize_int_group``).  Prefill attention goes through
``flash_attention``: the CUDA kernel on the GPU, its plain f32 version on
the CPU.  The expert-parallel forms and the MoE calibration taps are not
ported.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, Optional

import torch

from ..kernels.fakequant import fakequant_site
from ..kernels.flash_attention import flash_attention
from ..kernels.mixed_matmul import (GROUPED_MAX_C, mixed_matmul,
                                    mixed_matmul_sp_stack,
                                    mixed_matmul_w8_grouped,
                                    mixed_matmul_w8_site, w8_grouped_gemm_plain)
from ..mx.mxtensor import stack_split_plane
from ..mx.scaledw8 import GroupedW8, ScaledW8, dequantize_grouped
from ..ops.quantize_ops import silu_mul_quantize_x
from .common import (STACK_KERNEL_MAX_M, ModelConfig, QuantLinear, QuantSite,
                     _sp_fusable, add_bias, apply_rope, lm_logits, project_all,
                     quantize_int_group, rmsnorm, rope_table)

Params = Dict[str, Any]


def _silu(x: torch.Tensor) -> torch.Tensor:
    xf = x.to(torch.float32)
    return xf * torch.sigmoid(xf)


def attention_block(h: torch.Tensor, p: Params, cfg: ModelConfig,
                    cos: torch.Tensor, sin: torch.Tensor,
                    kv_quant_bits: Optional[int] = None,
                    tap: Optional[Callable] = None) -> torch.Tensor:
    """``tap`` (dense layers): called with the attention and o sites'
    inputs, ("attn_in", rmsnorm(h)) and ("o_in", attention output)."""
    b, s, _ = h.shape
    hd, nh, nkv = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    if tap is not None:
        xn = rmsnorm(h, p["ln1"], cfg.rms_eps)
        tap("attn_in", xn)
        q, k, v = p["q"](xn), p["k"](xn), p["v"](xn)
    else:
        q, k, v = qkv_proj(h, p, cfg)
    q = apply_rope(q.reshape(b, s, nh, hd), cos, sin)
    k = apply_rope(k.reshape(b, s, nkv, hd), cos, sin)
    v = v.reshape(b, s, nkv, hd)
    if kv_quant_bits:
        k = quantize_int_group(k, kv_quant_bits, group_size=hd)
        v = quantize_int_group(v, kv_quant_bits, group_size=hd)
    out = flash_attention(q, k, v, sliding_window=cfg.sliding_window)
    out = out.reshape(b, s, nh * hd)
    if tap is not None:
        tap("o_in", out)
        return p["o"](out)
    (o,) = project_all(out, p.get("o_site"), [p["o"]])
    return o


def qkv_proj(h: torch.Tensor, p: Params, cfg: ModelConfig):
    """ln1 + the attention site -> (q, k, v), (..., N_i) each."""
    stack = p.get("qkv_stack")
    lins = None if stack is not None else [p["q"], p["k"], p["v"]]
    return project_all(h, p.get("attn_site"), lins, p["ln1"], cfg.rms_eps,
                       stack=stack)


def mlp_block(h: torch.Tensor, p: Params, cfg: ModelConfig,
              tap: Optional[Callable] = None) -> torch.Tensor:
    """``tap`` (dense layers): called with ("mlp_in", rmsnorm(h)) and
    ("down_in", silu(gate) * up rounded once to bf16)."""
    if tap is not None:
        xn = rmsnorm(h, p["ln2"], cfg.rms_eps)
        tap("mlp_in", xn)
        gate, up = p["gate"](xn), p["up"](xn)
        act = (_silu(gate) * up.to(torch.float32)).to(torch.bfloat16)
        tap("down_in", act)
        return p["down"](act)
    stack = p.get("gateup_stack")
    lins = None if stack is not None else [p["gate"], p["up"]]
    gate, up = project_all(h, p.get("mlp_site"), lins, p["ln2"], cfg.rms_eps,
                           stack=stack)
    if isinstance(p["down"], QuantLinear):
        return _down_proj_q(gate, up, p["down_site"], p["down"])
    # the dense forward rounds silu(gate) to bf16 before the product
    return p["down"](_silu(gate).to(torch.bfloat16) * up)


def _down_proj_q(g: torch.Tensor, u: torch.Tensor, site: QuantSite,
                 down: QuantLinear) -> torch.Tensor:
    """silu(g) * u -> the silu site -> ``down``; keeps g's leading shape.

    ScaledW8: the site image and the ScaledW8 GEMM, at every M.
    Split-plane, up to ``STACK_KERNEL_MAX_M`` rows with 128-aligned rows:
    the site and the stacked GEMM on a one-section stack (no copy); else
    the MX quantize and ``mixed_matmul`` (the split-plane GEMM below 512
    rows, one dense product from 512)."""
    lead = g.shape[:-1]
    if down.w.segments() != site.splits:
        raise ValueError(f"down site {site.splits} vs weight {down.w.segments()}")
    g2d, u2d = g.reshape(-1, g.shape[-1]), u.reshape(-1, u.shape[-1])
    if isinstance(down.w, ScaledW8):
        y = mixed_matmul_w8_site(g2d, down.w, producer="silu", up=u2d)
    elif _sp_fusable([down]) and g2d.shape[0] <= STACK_KERNEL_MAX_M:
        (y,) = mixed_matmul_sp_stack(g2d, stack_split_plane([down.w]),
                                     producer="silu", up=u2d)
    else:
        y = mixed_matmul(silu_mul_quantize_x(g2d, u2d, *site.splits), down.w)
    y = add_bias(y, down.bias)
    return y.reshape(*lead, y.shape[-1])


def moe_capacity(cfg: ModelConfig, t: int) -> int:
    """Per-expert token capacity for T tokens (8-row aligned, <= T)."""
    ideal = t * cfg.num_experts_per_tok / cfg.num_experts
    c = int(-(-ideal * float(cfg.moe_capacity_factor) // 1))
    return min(t, max(8, (c + 7) // 8 * 8))


def capacity_dispatch(weights: torch.Tensor, capacity: int):
    """Routing weights (T, E) -> (idx (E, C) int32 in [0, T], gate (E, C)).

    Slots go by token order (each expert's cumulative rank): token t takes
    expert e's slot rank(t, e) if below capacity, else it is dropped for
    e.  idx == T marks an empty slot; gathers and scatters use a padded
    T+1 row.  Dropped pairs all write column C, which is cut off.
    """
    t, e = weights.shape
    dev = weights.device
    routed = weights > 0
    pos = torch.cumsum(routed.to(torch.int32), dim=0) - 1          # (T, E)
    keep = routed & (pos < capacity)
    slot = torch.where(keep, pos, torch.full_like(pos, capacity)).reshape(-1)
    t_ids = torch.arange(t, dtype=torch.int32, device=dev)[:, None].expand(t, e)
    e_ids = torch.arange(e, device=dev)[None, :].expand(t, e).reshape(-1)
    idx = torch.full((e, capacity + 1), t, dtype=torch.int32, device=dev)
    idx[e_ids, slot] = t_ids.reshape(-1)
    gate = torch.zeros((e, capacity + 1), dtype=weights.dtype, device=dev)
    gate[e_ids, slot] = torch.where(keep, weights, torch.zeros_like(weights)).reshape(-1)
    return idx[:, :capacity], gate[:, :capacity]


def _expert_out(ep: Params, toks: torch.Tensor) -> torch.Tensor:
    """One expert's FFN on ``toks`` (the per-expert form)."""
    g, u = project_all(toks, ep["site_in"], [ep["w1"], ep["w3"]])
    return _down_proj_q(g, u, ep["site_down"], ep["w2"])


def _grouped_apply(qx: torch.Tensor, gw: GroupedW8) -> List[torch.Tensor]:
    """Per-group products on the site image qx (E, C, K), the twin of the
    grouped GEMM above ``GROUPED_MAX_C`` rows: on the GPU one batched
    product of the image and the dequantized bf16 weights (f32
    accumulation), on the CPU the plain f32 products."""
    if not qx.is_cuda:
        return w8_grouped_gemm_plain(qx, gw)
    y = torch.matmul(qx, dequantize_grouped(gw).transpose(1, 2))
    outs, off = [], 0
    for n, p in zip(gw.sections, gw.padded):
        outs.append(y[:, :, off:off + n])
        off += p
    return outs


def _add_group_bias(y: torch.Tensor, b) -> torch.Tensor:
    return y if b is None else y + b[:, None, :]


def _moe_grouped(xn: torch.Tensor, weights: torch.Tensor, gr: Params,
                 cfg: ModelConfig) -> torch.Tensor:
    """The grouped expert path: gather (capacity) or broadcast (dense) the
    tokens per expert, then two grouped calls, w1|w3 behind each expert's
    own plain site and w2 behind the silu site, then the combine.  f32
    (T, hidden) out.  Up to ``GROUPED_MAX_C`` rows per expert the grouped
    GEMM runs; above, the site and one dequantized batched product."""
    w13, w2 = gr["w13"], gr["w2"]
    e = w13.groups
    t, k = xn.shape
    if cfg.moe_capacity_factor is not None:
        idx, gate = capacity_dispatch(weights, moe_capacity(cfg, t))
        xn_pad = torch.cat([xn, xn.new_zeros((1, k))])
        xg = xn_pad[idx.long()]                          # (E, C, K)
    else:
        idx, gate = None, weights.t()
        xg = xn.expand(e, t, k).contiguous()
    c = xg.shape[1]
    if c <= GROUPED_MAX_C:
        y1, y3 = mixed_matmul_w8_grouped(xg, w13, perm=gr["perm"])
    else:
        qx = fakequant_site(xg.reshape(-1, k), *w13.segments(), perm=gr["perm"])
        y1, y3 = _grouped_apply(qx.reshape(e, c, k), w13)
    y1 = _add_group_bias(y1, w13.biases[0])
    y3 = _add_group_bias(y3, w13.biases[1])
    if c <= GROUPED_MAX_C:
        (out,) = mixed_matmul_w8_grouped(y1, w2, producer="silu", up=y3)
    else:
        inter = y1.shape[-1]
        act = fakequant_site(y1.reshape(-1, inter), *w2.segments(),
                             producer="silu", up=y3.reshape(-1, inter))
        (out,) = _grouped_apply(act.reshape(e, c, inter), w2)
    out = _add_group_bias(out, w2.biases[0])
    contrib = out.to(torch.float32) * gate[:, :, None]
    if idx is None:
        # at most top-k non-zero terms meet in a row and the rest are exact
        # zeros, so the sum's order cannot change it
        return contrib.sum(dim=0)
    out_pad = torch.zeros((t + 1, k), dtype=torch.float32, device=xn.device)
    # on CUDA index_add_ adds with atomics in no fixed order; a real row
    # gets at most top-k non-zero terms onto 0, so the order cannot change
    # the f32 sum
    out_pad.index_add_(0, idx.reshape(-1).long(), contrib.reshape(-1, k))
    return out_pad[:-1]


def _softmax(x: torch.Tensor) -> torch.Tensor:
    """exp(x - max) / sum, the JAX package's form (a true division)."""
    ex = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return ex / ex.sum(dim=-1, keepdim=True)


def route(xn: torch.Tensor, p: Params, cfg: ModelConfig) -> torch.Tensor:
    """Router -> dense routing weights (T, E) f32: the top-k softmax
    probabilities renormalised, zero off the top-k.  Ties go to the lower
    expert index, as jax.lax.top_k breaks them (a stable sort)."""
    probs = _softmax(p["router"](xn).to(torch.float32))
    top_w, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w = top_w[:, :cfg.num_experts_per_tok]
    top_i = top_i[:, :cfg.num_experts_per_tok]
    top_w = top_w / top_w.sum(dim=-1, keepdim=True)
    return torch.zeros_like(probs).scatter_(1, top_i, top_w)


def moe_block(h: torch.Tensor, p: Params, cfg: ModelConfig) -> torch.Tensor:
    """The Mixtral sparse-MoE block: rmsnorm, the bf16 router, top-k
    routing weights, then the experts, grouped (``experts_grouped``) or
    one by one (``experts``), under dense dispatch (every expert on every
    token, mixed by the routing weights) or capacity dispatch
    (``cfg.moe_capacity_factor``)."""
    b, s, k = h.shape
    xn = rmsnorm(h.reshape(-1, k), p["ln2"], cfg.rms_eps)
    weights = route(xn, p, cfg)
    gr = p.get("experts_grouped")
    if gr is not None:
        return _moe_grouped(xn, weights, gr, cfg).to(torch.bfloat16).reshape(b, s, k)
    t = xn.shape[0]
    if cfg.moe_capacity_factor is not None:
        idx, gate = capacity_dispatch(weights, moe_capacity(cfg, t))
        xn_pad = torch.cat([xn, xn.new_zeros((1, k))])
        out_pad = torch.zeros((t + 1, k), dtype=torch.float32, device=h.device)
        for e, ep in enumerate(p["experts"]):
            rows = idx[e].long()
            ye = _expert_out(ep, xn_pad[rows])
            out_pad.index_add_(0, rows, ye.to(torch.float32) * gate[e][:, None])
        return out_pad[:-1].to(torch.bfloat16).reshape(b, s, k)
    out = torch.zeros((t, k), dtype=torch.float32, device=h.device)
    for e, ep in enumerate(p["experts"]):
        out = out + _expert_out(ep, xn).to(torch.float32) * weights[:, e][:, None]
    return out.to(torch.bfloat16).reshape(b, s, k)


def decoder_layer(h, p, cfg, cos, sin, kv_quant_bits=None, tap=None):
    h = h + attention_block(h, p, cfg, cos, sin, kv_quant_bits, tap)
    if cfg.is_moe:
        if tap is not None:
            raise NotImplementedError(
                "the MoE calibration taps are not ported (ROADMAP 1.8)")
        return h + moe_block(h, p, cfg)
    return h + mlp_block(h, p, cfg, tap)


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
            kv_quant_bits: Optional[int] = None,
            tap: Optional[Callable] = None) -> torch.Tensor:
    """tokens (B, S) int -> logits (B, S, vocab) f32, causal.

    ``tap(layer_idx, site_name, x)``: the calibration hook, dense params
    only; ``kv_quant_bits``: fake-quantize K and V per head to that many
    bits (the accuracy mode)."""
    b, s = tokens.shape
    h = params["embed"][tokens].to(torch.bfloat16)
    cos, sin = rope_table(torch.arange(s, device=tokens.device), cfg)
    for i, p in enumerate(params["layers"]):
        layer_tap = None
        if tap is not None:
            layer_tap = functools.partial(tap, i)
        h = decoder_layer(h, p, cfg, cos, sin, kv_quant_bits, layer_tap)
    h = rmsnorm(h, params["final_ln"], cfg.rms_eps)
    return lm_logits(h, params["lm_head"])
