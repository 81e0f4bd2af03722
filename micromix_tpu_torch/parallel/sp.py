"""Sequence (context) parallelism for a long-context prefill forward.

Counterpart of ``micromix_tpu/parallel/sp.py``: one process per rank of
a "seq" ``RankGroup``; rank r takes tokens [r S / sp, (r + 1) S / sp),
with RoPE at those global positions.  Embedding, norms, every linear
(dense or quantized, through ``project_all``), the MLP and the MoE block
are token-local, so each rank runs the single card's ``decoder_layer``
on its slice with an ``attend`` of its own; only attention talks to the
other ranks.  Three variants:

  * "gather" (the default): one tiled ``all_gather`` of K and of V along
    the sequence, then the local queries against the whole sequence
    under a causal mask offset by the rank's position (``attention``,
    the JAX package's XLA attention);
  * "ring" (``ring=True`` is its alias): f32 online softmax over the K/V
    blocks, rank (my - i) mod sp's block at step i, a ``ppermute`` of K
    and of V to rank r + 1 between steps and none after the last; the
    mask (-1e30) holds causality and the sliding window across the shard
    borders;
  * "ulysses": an ``all_to_all`` from sequence to head sharding (H and
    Hkv divisible by sp), exact ``attention`` over the whole sequence on
    H / sp heads under the whole causal mask, and an ``all_to_all`` back.

Every rank returns its sequence shard of the logits.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from ..models.common import (ModelConfig, attention, causal_mask, lm_logits,
                             rmsnorm, rope_table)
from ..models.transformer import decoder_layer
from .mesh import RankGroup

Params = Dict[str, Any]
VARIANTS = ("gather", "ring", "ulysses")
_NEG = -1e30


def _ring_attention(q, k, v, *, offset: int, group: RankGroup,
                    window: Optional[int]) -> torch.Tensor:
    """Blockwise ring attention; q / k / v (B, s_loc, H | Hkv, D) local
    shards -> (B, s_loc, H, D) in q's dtype.  Each block folds into the
    flash max / denominator recurrence in f32."""
    b, s_loc, h, d = q.shape
    rep = h // k.shape[2]
    sp, my = group.world, group.rank
    ring = [(j, (j + 1) % sp) for j in range(sp)]
    dev = q.device
    qf = q.to(torch.float32) * (1.0 / math.sqrt(d))
    m = torch.full((b, h, s_loc), _NEG, dtype=torch.float32, device=dev)
    den = torch.zeros((b, h, s_loc), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, h, s_loc, d), dtype=torch.float32, device=dev)
    qi = offset + torch.arange(s_loc, device=dev)[:, None]
    k_blk, v_blk = k, v
    for i in range(sp):
        src = (my - i) % sp
        kr, vr = k_blk.to(torch.float32), v_blk.to(torch.float32)
        if rep > 1:
            kr = kr.repeat_interleave(rep, dim=2)
            vr = vr.repeat_interleave(rep, dim=2)
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kr)
        kj = src * s_loc + torch.arange(s_loc, device=dev)[None, :]
        allow = kj <= qi
        if window is not None:
            allow = allow & (kj > qi - window)
        s = torch.where(allow[None, None], s, _NEG)
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp(m - m_new)
        e = torch.exp(s - m_new[..., None])
        del s
        den = den * corr + e.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", e, vr)
        m = m_new
        if i + 1 < sp:
            k_blk = group.ppermute(k_blk, ring)
            v_blk = group.ppermute(v_blk, ring)
    out = acc / torch.clamp(den, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def _ulysses_attention(q, k, v, *, group: RankGroup,
                       window: Optional[int]) -> torch.Tensor:
    """Sequence to head sharding and back around one exact attention."""
    b, s_loc, h, d = q.shape
    sp = group.world
    if h % sp or k.shape[2] % sp:
        raise ValueError(f"ulysses: sp={sp} must divide the heads "
                         f"({h} / {k.shape[2]})")
    qg = group.all_to_all(q, 2, 1)          # (B, S, H / sp, D)
    kg = group.all_to_all(k, 2, 1)
    vg = group.all_to_all(v, 2, 1)
    s_all = s_loc * sp
    out = attention(qg, kg, vg, causal_mask(s_all, s_all, window,
                                            device=q.device))
    return group.all_to_all(out, 1, 2)      # (B, S / sp, H, D)


def _attend(attn: str, group: RankGroup, offset: int, s_global: int):
    """The rank's ``attend(q, k, v, sliding_window)`` for
    ``decoder_layer``: q / k / v its sequence shard."""
    if attn == "ring":
        return lambda q, k, v, window: _ring_attention(
            q, k, v, offset=offset, group=group, window=window)
    if attn == "ulysses":
        return lambda q, k, v, window: _ulysses_attention(
            q, k, v, group=group, window=window)

    def gather(q, k, v, window):
        mask = causal_mask(q.shape[1], s_global, window, offset=offset,
                           device=q.device)
        return attention(q, group.all_gather(k, 1), group.all_gather(v, 1),
                         mask)
    return gather


def sp_forward_local(params: Params, tokens_local: torch.Tensor, *,
                     cfg: ModelConfig, s_global: int, group: RankGroup,
                     attn: str = "gather") -> torch.Tensor:
    """The rank's body: tokens_local (B, S / sp), its shard of a sequence
    of ``s_global`` -> its logits (B, S / sp, V) f32."""
    if attn not in VARIANTS:
        raise ValueError(f"attention variant {attn!r} not in {VARIANTS}")
    b, s_loc = tokens_local.shape
    offset = group.rank * s_loc
    h = params["embed"][tokens_local.long()].to(torch.bfloat16)
    cos, sin = rope_table(offset + torch.arange(s_loc,
                                                device=tokens_local.device),
                          cfg)
    attend = _attend(attn, group, offset, s_global)
    for p in params["layers"]:
        h = decoder_layer(h, p, cfg, cos, sin, attend=attend)
    return lm_logits(rmsnorm(h, params["final_ln"], cfg.rms_eps),
                     params["lm_head"])


def sequence_parallel_forward(params: Params, cfg: ModelConfig,
                              tokens: torch.Tensor, group: RankGroup, *,
                              ring: bool = False,
                              attn: Optional[str] = None) -> torch.Tensor:
    """tokens (B, S), S % sp == 0 -> the rank's logits (B, S / sp, V).
    ``attn``: "gather" (default), "ring" or "ulysses"; ``ring=True`` is
    the JAX package's alias for "ring"."""
    b, s = tokens.shape
    if s % group.world:
        raise ValueError(f"sp={group.world} does not divide length {s}")
    s_loc = s // group.world
    local = tokens[:, group.rank * s_loc:(group.rank + 1) * s_loc]
    return sp_forward_local(params, local, cfg=cfg, s_global=s, group=group,
                            attn=attn or ("ring" if ring else "gather"))


__all__ = ["sequence_parallel_forward", "sp_forward_local", "VARIANTS"]
