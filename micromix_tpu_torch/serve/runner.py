"""Cache-aware model execution: prefill and batched decode steps.

Counterpart of ``micromix_tpu/serve/runner.py`` for ScaledW8 and
split-plane weights, per consumer or stacked, dense Llama or Mixtral
(``_mlp`` picks the MoE block):

  * ``prefill`` (one sequence, from ``start_pos``) and ``prefill_batch``
    (several fresh sequences) run the causal forward over the tokens,
    append the quantized K/V to the paged cache and return the logits at
    ``last_idx``; with ``hist_len`` the chunk also attends over the
    sequence's quantized history (``paged_prefill_attention``), without it
    only over itself (``flash_attention``);
  * ``decode_step`` runs one token for every slot.  With stacked ScaledW8
    params (``_can_pair``) each layer is two residual pairs: (o + residual
    + rms + gate|up) and (down + residual + the next layer's rms +
    q|k|v); else the per-site form (always for Mixtral, and for
    split-plane weights, stacked or not);
  * ``decode_multi`` runs ``n_steps`` decode + sample steps as a Python
    loop (the JAX package's lax.scan), with the logit controls and the
    chosen tokens' logprobs when asked;
  * ``prefill_decode`` is the piggybacked step: one slot's prefill chunk,
    its length fix and first-token sample, then a decode chunk;
  * ``verify_block`` scores S tokens of every slot at once (speculative
    verify): the B*S positions run as rows of the paged decode attention,
    each clamped to its own position by the ``lengths`` override.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..kernels.flash_attention import flash_attention
from ..kernels.mixed_matmul import mixed_matmul_w8_pair
from ..models.common import (STACK_KERNEL_MAX_M, ModelConfig, QuantLinear,
                             apply_rope, lm_logits, project_all, rmsnorm,
                             rope_angles, rope_inv_freq, rope_table)
from ..models.transformer import _down_proj_q, mlp_block, moe_block, qkv_proj
from ..mx.scaledw8 import ScaledW8, ScaledW8Stack
from .attention import paged_decode_attention
from .kv_cache import PagedKVCache, append_kv
from .prefill_attention import paged_prefill_attention
from .sampling import (apply_logit_controls, ban_mask, chosen_logprobs,
                       sample_batch, unpack_presence)

Params = Dict[str, Any]
Caches = List[PagedKVCache]


def _qkv(h: torch.Tensor, p: Params, cfg: ModelConfig):
    b, s, _ = h.shape
    q, k, v = qkv_proj(h, p, cfg)
    return (q.reshape(b, s, cfg.num_heads, cfg.head_dim),
            k.reshape(b, s, cfg.num_kv_heads, cfg.head_dim),
            v.reshape(b, s, cfg.num_kv_heads, cfg.head_dim))


def _mlp(h: torch.Tensor, p: Params, cfg: ModelConfig) -> torch.Tensor:
    return moe_block(h, p, cfg) if cfg.is_moe else mlp_block(h, p, cfg)


def _o_proj(attn_out: torch.Tensor, p: Params) -> torch.Tensor:
    (o,) = project_all(attn_out, p.get("o_site"), [p["o"]])
    return o


def _logits_at(h: torch.Tensor, params: Params, cfg: ModelConfig,
               last_idx) -> torch.Tensor:
    """h (B, S, hidden), last_idx (B,) -> f32 logits (B, V) of those rows."""
    rows = torch.arange(h.shape[0], device=h.device)
    h_last = h[rows, torch.as_tensor(last_idx, device=h.device).long()]
    return lm_logits(rmsnorm(h_last, params["final_ln"], cfg.rms_eps),
                     params["lm_head"])


def prefill_batch(params: Params, cfg: ModelConfig, caches: Caches,
                  tokens: torch.Tensor, seq_ids: torch.Tensor,
                  last_idx: torch.Tensor) -> Tuple[torch.Tensor, Caches]:
    """Fresh prefill of B sequences: tokens (B, S) -> (logits (B, V) f32,
    caches).  Every row starts at position 0; ``last_idx`` (B,) picks each
    row's true last prompt position.  Padding rows use the scratch seq id."""
    b, s = tokens.shape
    dev = tokens.device
    h = params["embed"][tokens.long()].to(torch.bfloat16)
    positions = torch.arange(s, dtype=torch.int32, device=dev)
    cos, sin = rope_table(positions, cfg)
    seq_flat = seq_ids.repeat_interleave(s)
    pos_flat = positions.repeat(b)
    nkv, hd = cfg.num_kv_heads, cfg.head_dim
    for p, cache in zip(params["layers"], caches):
        q, k, v = _qkv(h, p, cfg)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        append_kv(cache, seq_flat, pos_flat, k.reshape(b * s, nkv, hd),
                  v.reshape(b * s, nkv, hd))
        out = flash_attention(q, k, v, sliding_window=cfg.sliding_window)
        h = h + _o_proj(out.reshape(b, s, -1), p)
        h = h + _mlp(h, p, cfg)
    return _logits_at(h, params, cfg, last_idx), caches


def prefill(params: Params, cfg: ModelConfig, caches: Caches,
            tokens: torch.Tensor, seq_id: int, start_pos=0,
            last_idx=None, *, hist_len: int = 0) -> Tuple[torch.Tensor, Caches]:
    """tokens (1, S) -> (logits at ``last_idx`` (1, V), caches).

    Appends the new K/V for positions [start_pos, start_pos + S);
    ``last_idx`` (default S-1) is the true last position when the chunk
    is right-padded to a length bucket.  A truthy ``hist_len`` makes this
    a chunk of a CHUNKED prefill: it also attends over the quantized
    history before ``start_pos``, whose length the kernel takes from
    ``start_pos`` (an int or a device int32), so ``hist_len`` is only a
    switch here.  In-chunk attention stays exact bf16.
    """
    b, s = tokens.shape
    if b != 1:
        raise ValueError(f"prefill takes one sequence, got {b}")
    dev = tokens.device
    start = torch.as_tensor(start_pos, dtype=torch.int32).to(dev)
    positions = start + torch.arange(s, dtype=torch.int32, device=dev)
    cos, sin = rope_table(positions, cfg)
    h = params["embed"][tokens.long()].to(torch.bfloat16)
    seq_ids = torch.full((s,), seq_id, dtype=torch.int32, device=dev)
    for p, cache in zip(params["layers"], caches):
        q, k, v = _qkv(h, p, cfg)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        append_kv(cache, seq_ids, positions, k[0], v[0])
        if hist_len:
            out = paged_prefill_attention(q[0], k[0], v[0], cache, seq_id,
                                          start,
                                          sliding_window=cfg.sliding_window)[None]
        else:
            out = flash_attention(q, k, v, sliding_window=cfg.sliding_window)
        h = h + _o_proj(out.reshape(b, s, -1), p)
        h = h + _mlp(h, p, cfg)
    last = [s - 1 if last_idx is None else last_idx]
    return _logits_at(h, params, cfg, last), caches


def _can_pair(params: Params, cfg: ModelConfig, b: int) -> bool:
    """Gate for the residual-pair decode path: every layer carries both
    ScaledW8 stacks, ScaledW8 o and down projections and a down site
    without a gather; dense model, decode-size batch, hidden a multiple
    of 512, and no ``MICROMIX_NO_PAIR``.

    Two conditions of the JAX gate are dropped: its backend test (the
    port runs its own pair kernels on the GPU and their plain versions on
    the CPU) and its Benes-route test (on the GPU a site's permutation is
    an indexed load of ``perm``, so every site is routable)."""
    if (cfg.is_moe or b > STACK_KERNEL_MAX_M
            or os.environ.get("MICROMIX_NO_PAIR")):
        return False
    for p in params["layers"]:
        if not (isinstance(p.get("qkv_stack"), ScaledW8Stack)
                and isinstance(p.get("gateup_stack"), ScaledW8Stack)
                and isinstance(p.get("o"), QuantLinear)
                and isinstance(p["o"].w, ScaledW8)
                and isinstance(p.get("down"), QuantLinear)
                and isinstance(p["down"].w, ScaledW8)
                and p["down_site"].perm is None
                and cfg.hidden_size % 512 == 0):
            return False
    return True


def _stack_biases(outs, stack: ScaledW8Stack):
    return [o if bi is None else o + bi for o, bi in zip(outs, stack.biases)]


def _pair_o_gateup(out2d, h2d, p, cfg):
    """o_proj + residual + rms + gate|up: (h_mid, gate, up)."""
    hm, outs = mixed_matmul_w8_pair(
        out2d, h2d, p["o"].w, p["gateup_stack"], gamma_b=p["ln2"],
        producer_a="plain", perm_a=p["o_site"].perm, bias_a=p["o"].bias,
        perm_b=p["mlp_site"].perm, eps=cfg.rms_eps)
    gate, up = _stack_biases(outs, p["gateup_stack"])
    return hm, gate, up


def _pair_down_qkv(gate, up, h2d, p, pn, cfg):
    """down_proj + residual + the next layer's rms + q|k|v."""
    hm, outs = mixed_matmul_w8_pair(
        gate, h2d, p["down"].w, pn["qkv_stack"], gamma_b=pn["ln1"],
        producer_a="silu", up_a=up, bias_a=p["down"].bias,
        perm_b=pn["attn_site"].perm, eps=cfg.rms_eps)
    return hm, _stack_biases(outs, pn["qkv_stack"])


def decode_step(params: Params, cfg: ModelConfig, caches: Caches,
                tokens: torch.Tensor, seq_ids: torch.Tensor,
                positions: torch.Tensor) -> Tuple[torch.Tensor, Caches]:
    """tokens (B,) -> (logits (B, V) f32, caches).  One step for B slots."""
    h = params["embed"][tokens.long()][:, None, :].to(torch.bfloat16)
    ang = rope_angles(positions, cfg)
    cos, sin = torch.cos(ang), torch.sin(ang)
    inv = rope_inv_freq(cfg.head_dim, cfg.rope_theta, cfg.rope_scaling,
                        device=tokens.device)
    b = tokens.shape[0]
    hd, nh, nkv = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    layers = params["layers"]

    def attend(q, k, v, cache):
        # the cache stores post-RoPE K, rotated inside the append; q is
        # rotated inside the attention, in f32 without the bf16 round
        append_kv(cache, seq_ids, positions, k, v, rope=(cos, sin))
        out = paged_decode_attention(q, cache, seq_ids,
                                     rope_positions=positions,
                                     rope_inv_freq=inv,
                                     sliding_window=cfg.sliding_window)
        return out.reshape(b, nh * hd)

    if _can_pair(params, cfg, b):
        h2d = h[:, 0]
        q3, k3, v3 = _qkv(h, layers[0], cfg)
        q2, k2, v2 = q3[:, 0], k3[:, 0], v3[:, 0]
        for li, (p, cache) in enumerate(zip(layers, caches)):
            out2d = attend(q2, k2, v2, cache)
            h2d, gate, up = _pair_o_gateup(out2d, h2d, p, cfg)
            if li + 1 < len(layers):
                h2d, (qf, kf, vf) = _pair_down_qkv(gate, up, h2d, p,
                                                   layers[li + 1], cfg)
                q2 = qf.reshape(b, nh, hd)
                k2 = kf.reshape(b, nkv, hd)
                v2 = vf.reshape(b, nkv, hd)
            else:
                h2d = h2d + _down_proj_q(gate, up, p["down_site"], p["down"])
        h2d = rmsnorm(h2d, params["final_ln"], cfg.rms_eps)
        return lm_logits(h2d, params["lm_head"]), caches
    for p, cache in zip(layers, caches):
        q, k, v = _qkv(h, p, cfg)                       # (B, 1, H, D)
        out = attend(q[:, 0], k[:, 0], v[:, 0], cache)
        h = h + _o_proj(out[:, None], p)
        h = h + _mlp(h, p, cfg)
    h = rmsnorm(h[:, 0], params["final_ln"], cfg.rms_eps)
    return lm_logits(h, params["lm_head"]), caches


def decode_multi(params: Params, cfg: ModelConfig, caches: Caches,
                 tokens: torch.Tensor, seq_ids: torch.Tensor,
                 positions: torch.Tensor, gen: Optional[torch.Generator],
                 temps: torch.Tensor, top_k: torch.Tensor, top_p: torch.Tensor,
                 controls=None, *, n_steps: int, sample_mode: str = "full",
                 with_logprobs: bool = False, step_fn=None):
    """``n_steps`` decode + sample steps; each step feeds the previous
    step's samples.

    ``controls`` (optional): (presence_bits (B, ceil(V/8)) uint8
    bit-packed, penalties (B,), ban_ids (B, W) int32 -1-padded,
    min_remaining (B,), minp_shift (B,)): the repetition penalty over
    the context's tokens (presence unpacked once, then set on the device
    as tokens are sampled, with no host sync), terminator suppression
    while fewer than ``min_remaining`` tokens have been emitted this
    chunk, and min-p as a log-space offset (-inf = off).
    ``with_logprobs``: also the chosen tokens' RAW log-probabilities
    (log_softmax of the untempered, unpenalized logits), (n_steps, B)
    f32.  ``step_fn``: the decode step (``decode_step``'s signature; a
    tensor-parallel rank's own).

    Returns (tokens (n_steps, B) int32[, logprobs], caches).
    """
    step_fn = step_fn or decode_step
    if controls is not None:
        rows = torch.arange(tokens.shape[0], device=tokens.device)
        presence_bits, penalties, ban_ids, min_remaining, mps = controls
        vocab = params["lm_head"].shape[0]
        presence = unpack_presence(presence_bits, vocab)
        banned = ban_mask(ban_ids, vocab)
    out, lps = [], []
    toks, pos = tokens, positions
    for i in range(n_steps):
        logits, caches = step_fn(params, cfg, caches, toks, seq_ids, pos)
        lg = logits
        if controls is not None:
            suppress = (min_remaining > i)[:, None] & banned
            lg = apply_logit_controls(logits, presence, penalties, suppress,
                                      minp_shift=mps)
        toks = sample_batch(lg, gen, temps, top_k, top_p, mode=sample_mode)
        if controls is not None:
            presence[rows, toks.long()] = True
        if with_logprobs:
            lps.append(chosen_logprobs(logits, toks))
        out.append(toks)
        pos = pos + 1
    if with_logprobs:
        return torch.stack(out), torch.stack(lps), caches
    return torch.stack(out), caches


def prefill_true_len(params: Params, cfg: ModelConfig, caches: Caches,
                     ptokens: torch.Tensor, pseq_id: int, pstart, plast,
                     ptrue_len: int, hist_len: int) -> Tuple[torch.Tensor, Caches]:
    """A piggybacked slot's prefill chunk, then its true length: bucket
    padding over-wrote it -> (logits (1, V), caches)."""
    logits, caches = prefill(params, cfg, caches, ptokens, pseq_id, pstart,
                             plast, hist_len=hist_len)
    for c in caches:
        c.lengths[pseq_id] = ptrue_len
    return logits, caches


def prefill_decode(params: Params, cfg: ModelConfig, caches: Caches,
                   ptokens: torch.Tensor, pseq_id: int, pstart, plast,
                   ptrue_len, ptemp: torch.Tensor, ptop_k: torch.Tensor,
                   ptop_p: torch.Tensor, dtokens: torch.Tensor,
                   dseq_ids: torch.Tensor, dpositions: torch.Tensor,
                   gen: Optional[torch.Generator], temps: torch.Tensor,
                   top_k: torch.Tensor, top_p: torch.Tensor, *, hist_len: int,
                   n_steps: int, sample_mode: str = "full"
                   ) -> Tuple[torch.Tensor, torch.Tensor, Caches]:
    """The piggybacked step: one slot's prefill chunk, then a decode chunk
    for the other slots, in one call.

    The prefill slot and the decode slots are distinct sequences (the
    engine points mid-prefill slots at the scratch row in ``dseq_ids``),
    so the order changes no value against separate calls.  Returns
    (prefill first token (1,) int32, decode tokens (n_steps, B), caches).
    """
    plogits, caches = prefill_true_len(params, cfg, caches, ptokens, pseq_id,
                                       pstart, plast, ptrue_len, hist_len)
    ptok = sample_batch(plogits, gen, ptemp, ptop_k, ptop_p, mode=sample_mode)
    dtoks, caches = decode_multi(params, cfg, caches, dtokens, dseq_ids,
                                 dpositions, gen, temps, top_k, top_p,
                                 n_steps=n_steps, sample_mode=sample_mode)
    return ptok, dtoks, caches


def verify_block(params: Params, cfg: ModelConfig, caches: Caches,
                 tokens: torch.Tensor, seq_ids: torch.Tensor,
                 positions: torch.Tensor) -> Tuple[torch.Tensor, Caches]:
    """Speculative verify: tokens (B, S) starting at per-slot ``positions``
    -> (f32 logits (B, S, V), caches).

    Every layer appends the K/V of all B*S tokens first (K rotated inside
    the append, as the decode step does), then runs the B*S positions as
    rows of the paged decode attention, row (b, j) reading its sequence up
    to its own position through the per-row ``lengths`` override: each row
    sees exactly the quantized history a plain decode step would.  The
    projections run per site at M = B*S (not the residual pairs), as the
    JAX package's ``verify_block`` does.
    """
    b, s = tokens.shape
    dev = tokens.device
    hd, nh, nkv = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    h = params["embed"][tokens.long()].to(torch.bfloat16)
    pos = (positions.to(torch.int32)[:, None]
           + torch.arange(s, dtype=torch.int32, device=dev)[None])
    flat_pos = pos.reshape(-1)
    flat_seq = seq_ids.to(torch.int32).repeat_interleave(s)
    ang = rope_angles(flat_pos, cfg)
    rope = (torch.cos(ang), torch.sin(ang))
    inv = rope_inv_freq(hd, cfg.rope_theta, cfg.rope_scaling, device=dev)
    rows = flat_pos + 1
    for p, cache in zip(params["layers"], caches):
        q, k, v = _qkv(h, p, cfg)                     # (B, S, H, D)
        append_kv(cache, flat_seq, flat_pos, k.reshape(b * s, nkv, hd),
                  v.reshape(b * s, nkv, hd), rope=rope)
        out = paged_decode_attention(q.reshape(b * s, nh, hd), cache,
                                     flat_seq, rope_positions=flat_pos,
                                     rope_inv_freq=inv,
                                     sliding_window=cfg.sliding_window,
                                     lengths=rows)
        h = h + _o_proj(out.reshape(b, s, nh * hd), p)
        h = h + _mlp(h, p, cfg)
    h = rmsnorm(h, params["final_ln"], cfg.rms_eps)
    return lm_logits(h, params["lm_head"]), caches
