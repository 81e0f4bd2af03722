"""Full-sequence decoder forward for a quantized dense Llama.

Counterpart of ``micromix_tpu/models/transformer.py`` (``forward``,
``attention_block``, ``mlp_block`` and the ScaledW8 branch of
``_down_proj_q``); layers carry per-consumer q/k/v and gate/up or their
stacks (``qkv_stack``, ``gateup_stack``).  Prefill attention goes through
``flash_attention``: the CUDA kernel on the GPU, its plain f32 version on
the CPU.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..kernels.flash_attention import flash_attention
from ..kernels.mixed_matmul import mixed_matmul_w8_site
from .common import (ModelConfig, QuantLinear, QuantSite, add_bias, apply_rope,
                     lm_logits, project_all, rmsnorm, rope_table)

Params = Dict[str, Any]


def attention_block(h: torch.Tensor, p: Params, cfg: ModelConfig,
                    cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    b, s, _ = h.shape
    hd, nh, nkv = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    q, k, v = qkv_proj(h, p, cfg)
    q = apply_rope(q.reshape(b, s, nh, hd), cos, sin)
    k = apply_rope(k.reshape(b, s, nkv, hd), cos, sin)
    out = flash_attention(q, k, v.reshape(b, s, nkv, hd),
                          sliding_window=cfg.sliding_window)
    (o,) = project_all(out.reshape(b, s, nh * hd), p["o_site"], [p["o"]])
    return o


def qkv_proj(h: torch.Tensor, p: Params, cfg: ModelConfig):
    """ln1 + the attention site -> (q, k, v), (..., N_i) each."""
    stack = p.get("qkv_stack")
    lins = None if stack is not None else [p["q"], p["k"], p["v"]]
    return project_all(h, p["attn_site"], lins, p["ln1"], cfg.rms_eps,
                       stack=stack)


def mlp_block(h: torch.Tensor, p: Params, cfg: ModelConfig) -> torch.Tensor:
    stack = p.get("gateup_stack")
    lins = None if stack is not None else [p["gate"], p["up"]]
    gate, up = project_all(h, p["mlp_site"], lins, p["ln2"], cfg.rms_eps,
                           stack=stack)
    return _down_proj_q(gate, up, p["down_site"], p["down"])


def _down_proj_q(g: torch.Tensor, u: torch.Tensor, site: QuantSite,
                 down: QuantLinear) -> torch.Tensor:
    """silu(g) * u -> site fakequant -> ``down`` (ScaledW8); keeps g's
    leading shape."""
    lead = g.shape[:-1]
    if down.w.segments() != site.splits:
        raise ValueError(f"down site {site.splits} vs weight {down.w.segments()}")
    y = mixed_matmul_w8_site(g.reshape(-1, g.shape[-1]), down.w,
                             producer="silu", up=u.reshape(-1, u.shape[-1]))
    y = add_bias(y, down.bias)
    return y.reshape(*lead, y.shape[-1])


def decoder_layer(h, p, cfg, cos, sin):
    h = h + attention_block(h, p, cfg, cos, sin)
    return h + mlp_block(h, p, cfg)


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, S) int -> logits (B, S, vocab) f32, causal."""
    b, s = tokens.shape
    h = params["embed"][tokens].to(torch.bfloat16)
    cos, sin = rope_table(torch.arange(s, device=tokens.device), cfg)
    for p in params["layers"]:
        h = decoder_layer(h, p, cfg, cos, sin)
    h = rmsnorm(h, params["final_ln"], cfg.rms_eps)
    return lm_logits(h, params["lm_head"])
