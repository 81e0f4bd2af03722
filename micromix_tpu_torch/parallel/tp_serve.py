"""Tensor-parallel serving: one engine a rank, over the rank's shard of
the weights and of the KV heads.

Counterpart of ``micromix_tpu/parallel/tp_serve.py``.  The JAX package
``shard_map``s one engine's step programs over a mesh; here each rank
runs its own ``Engine`` (``make_tp_engine``) whose step programs
(``make_tp_step_fns``) run the layers on the rank's local heads and call
``all_reduce`` for the two row-parallel projections of every layer
(``tp_quant.row_parallel``).  The KV cache holds the rank's KV heads
(nkv / tp), so the attention kernels run unchanged on them and need no
collective.  The logits come out of the sums replicated, and every rank
samples them with a generator seeded alike, so the ranks' host
scheduling (which depends only on the requests and the sampled tokens)
stays in lockstep with no further exchange.

Steps, each the runner's program with the TP layer: ``tp_prefill`` (a
chunk from ``start_pos``, over the local heads' history with
``hist_len``), ``tp_prefill_batch``, ``tp_decode_step`` and
``tp_verify_block`` (the speculative verify: B*S rows of the paged
decode attention with the per-row ``lengths`` override, on local heads).
Speculation keeps the draft and its caches whole on every rank, as the
JAX package replicates them.  Either tree form serves: segmented
(``quantize_model_tp``) or hetero (``quantize_model_tp_hetero``).
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List

import torch

from ..kernels.flash_attention import flash_attention
from ..models.common import (ModelConfig, apply_rope, lm_logits, rmsnorm,
                             rope_angles, rope_inv_freq, rope_table)
from ..serve.attention import paged_decode_attention
from ..serve.engine import Engine, StepFns
from ..serve.kv_cache import PagedKVCache, append_kv
from ..serve.prefill_attention import paged_prefill_attention
from ..serve.runner import decode_multi
from ..serve.speculative import plookup_decode_multi, spec_decode_multi
from .mesh import RankGroup
from .tp_quant import local_config, tp_layer

Params = Dict[str, Any]
Caches = List[PagedKVCache]


def _layers(h, params: Params, caches: Caches, cfg_l: ModelConfig,
            group: RankGroup, attend) -> torch.Tensor:
    """Every layer with ``attend(q, k, v, cache)`` as its attention."""
    for p, cache in zip(params["layers"], caches):
        h = tp_layer(h, p, cfg_l, group,
                     lambda q, k, v, c=cache: attend(q, k, v, c))
    return h


def _logits(params: Params, cfg_l: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    return lm_logits(rmsnorm(h, params["final_ln"], cfg_l.rms_eps),
                     params["lm_head"])


def tp_prefill(params: Params, cfg_l: ModelConfig, caches: Caches,
               tokens: torch.Tensor, seq_id: int, start_pos=0, last_idx=None,
               *, hist_len: int = 0, group: RankGroup):
    """``runner.prefill`` on a rank: tokens (1, S) -> (replicated logits at
    ``last_idx`` (1, V), caches); with ``hist_len`` the chunk also attends
    over its local heads' quantized history."""
    b, s = tokens.shape
    dev = tokens.device
    start = torch.as_tensor(start_pos, dtype=torch.int32).to(dev)
    positions = start + torch.arange(s, dtype=torch.int32, device=dev)
    cos, sin = rope_table(positions, cfg_l)
    h = params["embed"][tokens.long()].to(torch.bfloat16)
    seq_ids = torch.full((s,), seq_id, dtype=torch.int32, device=dev)

    def attend(q, k, v, cache):
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        append_kv(cache, seq_ids, positions, k[0], v[0])
        if hist_len:
            out = paged_prefill_attention(q[0], k[0], v[0], cache, seq_id, start,
                                          sliding_window=cfg_l.sliding_window)[None]
        else:
            out = flash_attention(q, k, v, sliding_window=cfg_l.sliding_window)
        return out.reshape(b, s, -1)

    h = _layers(h, params, caches, cfg_l, group, attend)
    last = s - 1 if last_idx is None else last_idx
    return _logits(params, cfg_l, h[:, last]), caches


def tp_prefill_batch(params: Params, cfg_l: ModelConfig, caches: Caches,
                     tokens: torch.Tensor, seq_ids: torch.Tensor,
                     last_idx: torch.Tensor, *, group: RankGroup):
    """``runner.prefill_batch`` on a rank: B fresh sequences from position
    0; padding rows carry the scratch seq id."""
    b, s = tokens.shape
    dev = tokens.device
    h = params["embed"][tokens.long()].to(torch.bfloat16)
    positions = torch.arange(s, dtype=torch.int32, device=dev)
    cos, sin = rope_table(positions, cfg_l)
    seq_flat = seq_ids.repeat_interleave(s)
    pos_flat = positions.repeat(b)
    nkv, hd = cfg_l.num_kv_heads, cfg_l.head_dim

    def attend(q, k, v, cache):
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        append_kv(cache, seq_flat, pos_flat, k.reshape(b * s, nkv, hd),
                  v.reshape(b * s, nkv, hd))
        return flash_attention(q, k, v, sliding_window=cfg_l.sliding_window
                               ).reshape(b, s, -1)

    h = _layers(h, params, caches, cfg_l, group, attend)
    rows = torch.arange(b, device=dev)
    return _logits(params, cfg_l, h[rows, last_idx.to(dev).long()]), caches


def tp_decode_step(params: Params, cfg_l: ModelConfig, caches: Caches,
                   tokens: torch.Tensor, seq_ids: torch.Tensor,
                   positions: torch.Tensor, *, group: RankGroup):
    """``runner.decode_step`` (its per-site form) on a rank: one token for
    each of B slots over the local KV heads."""
    b = tokens.shape[0]
    h = params["embed"][tokens.long()][:, None, :].to(torch.bfloat16)
    ang = rope_angles(positions, cfg_l)
    cos, sin = torch.cos(ang), torch.sin(ang)
    inv = rope_inv_freq(cfg_l.head_dim, cfg_l.rope_theta, cfg_l.rope_scaling,
                        device=tokens.device)

    def attend(q, k, v, cache):
        # K rotated inside the append, q inside the attention
        append_kv(cache, seq_ids, positions, k[:, 0], v[:, 0], rope=(cos, sin))
        out = paged_decode_attention(q[:, 0], cache, seq_ids,
                                     rope_positions=positions,
                                     rope_inv_freq=inv,
                                     sliding_window=cfg_l.sliding_window)
        return out.reshape(b, 1, -1)

    h = _layers(h, params, caches, cfg_l, group, attend)
    return _logits(params, cfg_l, h[:, 0]), caches


def tp_verify_block(params: Params, cfg_l: ModelConfig, caches: Caches,
                    tokens: torch.Tensor, seq_ids: torch.Tensor,
                    positions: torch.Tensor, *, group: RankGroup):
    """``runner.verify_block`` on a rank: tokens (B, S) from per-slot
    ``positions`` -> (replicated f32 logits (B, S, V), caches), the B*S
    rows attending over the local heads, each up to its own position."""
    b, s = tokens.shape
    dev = tokens.device
    hd, nkv = cfg_l.head_dim, cfg_l.num_kv_heads
    h = params["embed"][tokens.long()].to(torch.bfloat16)
    pos = (positions.to(torch.int32)[:, None]
           + torch.arange(s, dtype=torch.int32, device=dev)[None])
    flat_pos = pos.reshape(-1)
    flat_seq = seq_ids.to(torch.int32).repeat_interleave(s)
    ang = rope_angles(flat_pos, cfg_l)
    rope = (torch.cos(ang), torch.sin(ang))
    inv = rope_inv_freq(hd, cfg_l.rope_theta, cfg_l.rope_scaling, device=dev)
    rows = flat_pos + 1

    def attend(q, k, v, cache):
        append_kv(cache, flat_seq, flat_pos, k.reshape(b * s, nkv, hd),
                  v.reshape(b * s, nkv, hd), rope=rope)
        out = paged_decode_attention(q.reshape(b * s, cfg_l.num_heads, hd),
                                     cache, flat_seq, rope_positions=flat_pos,
                                     rope_inv_freq=inv,
                                     sliding_window=cfg_l.sliding_window,
                                     lengths=rows)
        return out.reshape(b, s, -1)

    h = _layers(h, params, caches, cfg_l, group, attend)
    return _logits(params, cfg_l, h), caches


def make_tp_step_fns(cfg: ModelConfig, group: RankGroup) -> StepFns:
    """The engine's step programs for one rank of a ``group.world``-way
    tensor-parallel run (every member: chunked and batched prefill, the
    draft and prompt-lookup rounds, pipelined decode)."""
    cfg_l = local_config(cfg, group.world)
    step = functools.partial(tp_decode_step, group=group)
    verify = functools.partial(tp_verify_block, group=group)

    def prefill(params, caches, tokens, seq_id, start_pos=0, last_idx=None,
                hist_len=0):
        return tp_prefill(params, cfg_l, caches, tokens, seq_id, start_pos,
                          last_idx, hist_len=hist_len, group=group)

    def spec_multi(dcfg, gamma, n_rounds):
        return lambda tp, dp, tc, dc, *a, **kw: spec_decode_multi(
            tp, dp, cfg_l, dcfg, tc, dc, *a, gamma=gamma, n_rounds=n_rounds,
            verify_fn=verify, **kw)

    def plookup_multi(gamma, n_rounds, ngram):
        return lambda tp, tc, *a, **kw: plookup_decode_multi(
            tp, cfg_l, tc, *a, gamma=gamma, n_rounds=n_rounds, ngram=ngram,
            verify_fn=verify, **kw)

    return StepFns(
        prefill=prefill,
        decode_multi=lambda params, caches, *a, **kw: decode_multi(
            params, cfg_l, caches, *a, step_fn=step, **kw),
        prefill_hist=prefill,
        prefill_batch=lambda params, caches, *a: tp_prefill_batch(
            params, cfg_l, caches, *a, group=group),
        spec_multi=spec_multi, plookup_multi=plookup_multi,
        decode_multi_returns_last=True)


def make_tp_engine(params: Params, cfg: ModelConfig, group: RankGroup,
                   **engine_kw) -> Engine:
    """The rank's ``Engine`` over the rank's own tree (``shard_params_tp``
    of a global tree, or ``quantize_model_tp(..., group=)``); its caches
    hold nkv / tp KV heads, on the group's device unless ``device`` is
    given."""
    tp = group.world
    engine_kw.setdefault("device", group.device)
    return Engine(params, cfg, step_fns=make_tp_step_fns(cfg, group),
                  cache_sharding=lambda n_kv: n_kv // tp, **engine_kw)

__all__ = ["make_tp_engine", "make_tp_step_fns", "tp_prefill",
           "tp_prefill_batch", "tp_decode_step", "tp_verify_block"]
