"""Speculative decoding: draft-propose / target-verify / accept-rollback.

Counterpart of ``micromix_tpu/serve/speculative.py``:

  * draft model: ``draft_propose`` runs gamma + 1 draft decode steps (step
    0 re-appends ``prev`` at ``positions - 1``, which heals the draft
    cache's one-position hole after a fully accepted round; an append is
    an idempotent overwrite), ``runner.verify_block`` scores the gamma + 1
    positions of every slot in one forward, ``accept_tokens`` applies the
    accept rule, and the rollback only writes per-sequence ``lengths``
    (``_set_lengths``; stale entries are overwritten by later appends);
  * prompt lookup: ``plookup_propose`` proposes the tokens that followed
    the latest earlier occurrence of each slot's trailing n-gram, a
    deterministic draft q = one-hot(proposed) for the same accept rule;
  * ``spec_prefill_decode`` / ``plookup_prefill_decode``: one pending
    slot's prefill chunk (the draft's mirror of it too) rides the call.

The JAX package's ``lax.scan`` loops are Python loops over device
tensors: inside the rounds nothing reads a value back to the host, so the
appends' ``lengths`` maximum (Kernel D's atomicMax on the card) and the
rollback that lowers ``lengths`` run in order on one stream.  Draws come
from a ``torch.Generator``; ``accept_tokens`` takes the uniforms and the
Gumbel noise as arguments when given, so its accept decision and
residual draw are pure functions of them.  With temperature 0 the emitted
stream is the target's greedy decoding, whatever the draft proposes;
with temperature > 0 the rule min(1, p_t / p_d) and the residual
(p_t - p_d)+ preserve the target's distribution token by token.
``greedy=True`` (every row at temperature 0, known on the host) skips the
softmax and the draws, which greedy rows never read.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..models.common import ModelConfig
from .kv_cache import PagedKVCache
from .runner import decode_step, prefill_true_len, verify_block
from .sampling import _categorical, sample_batch

Params = Dict[str, Any]
Caches = List[PagedKVCache]


@dataclasses.dataclass
class SpecState:
    """Per-slot carry between rounds: ``prev`` and ``cur`` are the last
    two emitted tokens, ``cur`` sits at ``positions`` and is the next token
    whose K/V a round appends."""

    prev: torch.Tensor       # (B,) int32, the token at positions - 1
    cur: torch.Tensor        # (B,) int32, the token at positions
    positions: torch.Tensor  # (B,) int32


@dataclasses.dataclass
class PLookupState:
    """Per-slot carry of prompt-lookup rounds: the tail of each slot's
    sequence (prompt + emitted), ``length`` valid entries, with
    ``tokens[length - 1]`` at KV position ``positions``.  The buffer has
    at least n_rounds * (gamma + 1) columns of slack past the lookup
    window for the rounds' appends."""

    tokens: torch.Tensor     # (B, T) int32
    length: torch.Tensor     # (B,) int32
    positions: torch.Tensor  # (B,) int32


def _softmax_t(logits: torch.Tensor, temps: torch.Tensor) -> torch.Tensor:
    """Temperature softmax over the last dim, temps (B,) over the first;
    rows with temp <= 0 give the one-hot argmax (the greedy limit)."""
    shape = (-1,) + (1,) * (logits.dim() - 1)
    t = torch.clamp(temps, min=1e-6).reshape(shape)
    p = torch.softmax(logits.to(torch.float32) / t, dim=-1)
    greedy = F.one_hot(torch.argmax(logits, dim=-1),
                       logits.shape[-1]).to(torch.float32)
    return torch.where((temps <= 0.0).reshape(shape), greedy, p)


def draft_propose(dparams: Params, dcfg: ModelConfig, dcaches: Caches,
                  state: SpecState, seq_ids: torch.Tensor,
                  gen: Optional[torch.Generator], temps: torch.Tensor, *,
                  gamma: int, greedy: bool = False
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor], Caches]:
    """The draft chain: gamma proposals per slot -> (proposed (B, gamma)
    int32, the draft distributions they were drawn from (B, gamma, V) f32,
    None with ``greedy``, caches).  Step 0 re-processes ``prev`` for its
    append alone; steps 1..gamma process cur, d1, ...  Greedy rows
    (temp <= 0) propose the argmax."""
    def step(tok, pos):
        logits, _ = decode_step(dparams, dcfg, dcaches, tok, seq_ids, pos)
        top = torch.argmax(logits, dim=-1).to(torch.int32)
        if greedy:
            return top, None
        probs = _softmax_t(logits, temps)
        drawn = _categorical(torch.log(torch.clamp(probs, min=1e-30)), gen)
        return torch.where(temps <= 0.0, top, drawn.to(torch.int32)), probs

    step(state.prev, state.positions - 1)
    tok, pos = state.cur, state.positions
    toks, probs = [], []
    for _ in range(gamma):
        tok, p = step(tok, pos)
        toks.append(tok)
        probs.append(p)
        pos = pos + 1
    return (torch.stack(toks, dim=1),
            None if greedy else torch.stack(probs, dim=1), dcaches)


def accept_tokens(proposed: torch.Tensor, dprobs: Optional[torch.Tensor],
                  tlogits: torch.Tensor, gen: Optional[torch.Generator],
                  temps: torch.Tensor, *, greedy: bool = False,
                  uniforms: Optional[torch.Tensor] = None,
                  gumbel: Optional[torch.Tensor] = None):
    """The accept rule and the fixup token.

    proposed (B, gamma); dprobs (B, gamma, V) the draft distributions;
    tlogits (B, gamma + 1, V) the target's logits at [cur, d1..d_gamma].
    -> (emitted (B, gamma + 1) int32: the accepted proposals then the
    fixup or bonus token, right-padded with 0; n_emitted (B,) in
    [1, gamma + 1]; the valid mask).

    Greedy rows accept while the proposal is the target's argmax and fix
    up with the argmax; sampled rows accept with probability
    min(1, p_t / p_d) against ``uniforms`` (B, gamma) and draw the fixup
    from the residual (p_t - p_d)+ (p_t alone after a full accept) with
    ``gumbel`` (B, V) noise; both are drawn from ``gen`` when not given.
    ``greedy``: every row is greedy (dprobs may be None)."""
    b, gamma = proposed.shape
    dev = proposed.device
    top = torch.argmax(tlogits, dim=-1).to(torch.int32)          # (B, g+1)
    ok = proposed == top[:, :gamma]
    if not greedy:
        tp = _softmax_t(tlogits, temps)                           # (B, g+1, V)
        idx = proposed.long()[:, :, None]
        tq = tp[:, :gamma].gather(-1, idx)[..., 0]
        dq = dprobs.gather(-1, idx)[..., 0]
        if uniforms is None:
            uniforms = torch.rand((b, gamma), generator=gen, device=dev)
        ok_sampled = uniforms < torch.clamp(tq / torch.clamp(dq, min=1e-30),
                                            max=1.0)
        ok = torch.where((temps <= 0.0)[:, None], ok, ok_sampled)
    a = torch.cumprod(ok.to(torch.int32), dim=-1).sum(dim=-1)    # (B,)
    sel = torch.clamp(a, max=gamma)
    rows = torch.arange(b, device=dev)
    fix = top[rows, sel]
    if not greedy:
        resid = _residual(tp, dprobs, a)
        drawn = _categorical(torch.log(torch.clamp(resid, min=1e-30)), gen,
                             gumbel)
        fix = torch.where(temps <= 0.0, fix, drawn.to(torch.int32))
    ar = torch.arange(gamma + 1, device=dev)
    padded = torch.cat([proposed.to(torch.int32),
                        torch.zeros_like(proposed[:, :1], dtype=torch.int32)],
                       dim=1)
    emitted = torch.where(ar[None] < a[:, None], padded, 0)
    emitted[rows, a] = fix
    n_emitted = (a + 1).to(torch.int32)
    return emitted, n_emitted, ar[None] < n_emitted[:, None]


def _residual(tp: torch.Tensor, dprobs: torch.Tensor,
              a: torch.Tensor) -> torch.Tensor:
    """The fixup distribution (B, V) after ``a`` (B,) accepts: (p_t -
    p_d)+ at the first rejected position, normalized; p_t at the bonus
    position after a full accept.  tp (B, gamma + 1, V), dprobs (B, gamma,
    V)."""
    gamma = dprobs.shape[1]
    rows = torch.arange(a.shape[0], device=a.device)
    sel = torch.clamp(a, max=gamma)
    d_pad = torch.cat([dprobs, torch.zeros_like(dprobs[:, :1])], dim=1)
    resid = tp[rows, sel] - torch.where((a < gamma)[:, None],
                                        d_pad[rows, sel], 0.0)
    resid = torch.clamp(resid, min=0.0)
    return resid / torch.clamp(resid.sum(dim=-1, keepdim=True), min=1e-30)


def _set_lengths(caches: Caches, seq_ids: torch.Tensor,
                 new_len: torch.Tensor) -> Caches:
    """Write per-sequence lengths on every layer's cache (the rollback),
    in place on the caches' stream."""
    idx = seq_ids.long()
    val = new_len.to(torch.int32)
    for c in caches:
        c.lengths.index_put_((idx,), val)
    return caches


def _last_two(emitted: torch.Tensor, n_emitted: torch.Tensor,
              cur: torch.Tensor):
    """(the last emitted token, the one before it or ``cur``) per row."""
    n = n_emitted.long()[:, None]
    last = emitted.gather(1, n - 1)[:, 0]
    before = emitted.gather(1, torch.clamp(n - 2, min=0))[:, 0]
    return last, torch.where(n_emitted > 1, before, cur)


def spec_round(tparams: Params, dparams: Params, cfg: ModelConfig,
               dcfg: ModelConfig, tcaches: Caches, dcaches: Caches,
               state: SpecState, seq_ids: torch.Tensor,
               gen: Optional[torch.Generator], temps: torch.Tensor, *,
               gamma: int, greedy: bool = False, verify_fn=verify_block):
    """One draft + verify + accept round -> (emitted (B, gamma + 1),
    n_emitted (B,), the new state, tcaches, dcaches).  ``verify_fn``: the
    target's verify (``runner.verify_block``'s signature; a tensor-parallel
    rank's own)."""
    proposed, dprobs, dcaches = draft_propose(
        dparams, dcfg, dcaches, state, seq_ids, gen, temps, gamma=gamma,
        greedy=greedy)
    block = torch.cat([state.cur[:, None].to(torch.int32), proposed], dim=1)
    tlogits, tcaches = verify_fn(tparams, cfg, tcaches, block, seq_ids,
                                 state.positions)
    emitted, n_emitted, _ = accept_tokens(proposed, dprobs, tlogits, gen,
                                          temps, greedy=greedy)
    new_pos = state.positions + n_emitted
    # rollback: valid entries cover positions [0, new_pos)
    _set_lengths(tcaches, seq_ids, new_pos)
    _set_lengths(dcaches, seq_ids,
                 torch.minimum(state.positions + gamma, new_pos))
    last, prev = _last_two(emitted, n_emitted, state.cur)
    return (emitted, n_emitted, SpecState(prev=prev, cur=last,
                                          positions=new_pos),
            tcaches, dcaches)


def spec_decode_multi(tparams: Params, dparams: Params, cfg: ModelConfig,
                      dcfg: ModelConfig, tcaches: Caches, dcaches: Caches,
                      state: SpecState, seq_ids: torch.Tensor,
                      gen: Optional[torch.Generator], temps: torch.Tensor, *,
                      gamma: int, n_rounds: int, greedy: bool = False,
                      verify_fn=verify_block):
    """``n_rounds`` rounds -> (emitted (n_rounds, B, gamma + 1), n_emitted
    (n_rounds, B), the final state, tcaches, dcaches); the caller keeps
    each round's first ``n_emitted`` tokens per slot."""
    emitted, n_emitted = [], []
    for _ in range(n_rounds):
        e, n, state, tcaches, dcaches = spec_round(
            tparams, dparams, cfg, dcfg, tcaches, dcaches, state, seq_ids,
            gen, temps, gamma=gamma, greedy=greedy, verify_fn=verify_fn)
        emitted.append(e)
        n_emitted.append(n)
    return (torch.stack(emitted), torch.stack(n_emitted), state, tcaches,
            dcaches)


def plookup_propose(tokens: torch.Tensor, length: torch.Tensor, *,
                    gamma: int, ngram: int) -> torch.Tensor:
    """Latest-match n-gram continuation per row -> proposed (B, gamma)
    int32.  Row b looks for the latest j < length - 1 where the ``ngram``
    tokens ending at j equal its trailing ``ngram`` tokens and proposes
    tokens[j + 1 : j + 1 + gamma], as far as they are valid; without a
    match (or with fewer than ngram + 1 tokens) it proposes copies of its
    current token, which the accept rule rejects (a plain decode step)."""
    b, t = tokens.shape
    dev = tokens.device
    tokens = tokens.to(torch.int32)
    length = length.to(torch.int64)
    idx = torch.arange(t, device=dev)
    suf_idx = torch.clamp(length[:, None] - ngram
                          + torch.arange(ngram, device=dev)[None], 0, t - 1)
    suffix = tokens.gather(1, suf_idx)                      # (B, ngram)
    eq = torch.ones((b, t), dtype=torch.bool, device=dev)
    for d in range(ngram):
        shift = ngram - 1 - d
        shifted = (F.pad(tokens, (shift, 0), value=-1)[:, :t] if shift
                   else tokens)
        eq = eq & (shifted == suffix[:, d:d + 1])
    # not the suffix itself (j = length - 1), nor windows in the invalid tail
    valid = (idx[None] >= ngram - 1) & (idx[None] <= length[:, None] - 2)
    j_sel = torch.where(eq & valid, idx[None], -1).amax(dim=1)
    found = (j_sel >= 0) & (length >= ngram + 1)
    cont = j_sel[:, None] + 1 + torch.arange(gamma, device=dev)[None]
    ok = found[:, None] & (cont <= length[:, None] - 1)
    cur = tokens.gather(1, torch.clamp(length - 1, min=0)[:, None])
    return torch.where(ok, tokens.gather(1, torch.clamp(cont, 0, t - 1)), cur)


def plookup_round(tparams: Params, cfg: ModelConfig, tcaches: Caches,
                  state: PLookupState, seq_ids: torch.Tensor,
                  gen: Optional[torch.Generator], temps: torch.Tensor, *,
                  gamma: int, ngram: int, greedy: bool = False,
                  verify_fn=verify_block):
    """One propose / verify / accept round without a draft model ->
    (emitted (B, gamma + 1), n_emitted (B,), the new state, tcaches)."""
    b, t = state.tokens.shape
    dev = state.tokens.device
    proposed = plookup_propose(state.tokens, state.length, gamma=gamma,
                               ngram=ngram)
    last = torch.clamp(state.length.long() - 1, min=0)[:, None]
    cur = state.tokens.to(torch.int32).gather(1, last)
    block = torch.cat([cur, proposed], dim=1)
    tlogits, tcaches = verify_fn(tparams, cfg, tcaches, block, seq_ids,
                                 state.positions)
    # a deterministic draft: q = one-hot(proposed)
    dprobs = (None if greedy else
              F.one_hot(proposed.long(), tlogits.shape[-1]).to(torch.float32))
    emitted, n_emitted, _ = accept_tokens(proposed, dprobs, tlogits, gen,
                                          temps, greedy=greedy)
    new_pos = state.positions + n_emitted
    _set_lengths(tcaches, seq_ids, new_pos)
    # the emitted tokens into the window; writes past n_emitted or the
    # buffer's end land in a dropped extra column
    ar = torch.arange(gamma + 1, device=dev)
    wid = state.length.long()[:, None] + ar[None]
    keep = (ar[None] < n_emitted[:, None]) & (wid < t)
    wid = torch.where(keep, wid, t)
    tokens = F.pad(state.tokens.to(torch.int32), (0, 1))
    tokens.scatter_(1, wid, emitted)
    length = torch.clamp(state.length + n_emitted, max=t).to(torch.int32)
    return (emitted, n_emitted,
            PLookupState(tokens=tokens[:, :t], length=length,
                         positions=new_pos), tcaches)


def plookup_decode_multi(tparams: Params, cfg: ModelConfig, tcaches: Caches,
                         state: PLookupState, seq_ids: torch.Tensor,
                         gen: Optional[torch.Generator], temps: torch.Tensor,
                         *, gamma: int, ngram: int, n_rounds: int,
                         greedy: bool = False, verify_fn=verify_block):
    """``n_rounds`` prompt-lookup rounds -> (emitted (n_rounds, B,
    gamma + 1), n_emitted (n_rounds, B), the final state, tcaches)."""
    emitted, n_emitted = [], []
    for _ in range(n_rounds):
        e, n, state, tcaches = plookup_round(
            tparams, cfg, tcaches, state, seq_ids, gen, temps, gamma=gamma,
            ngram=ngram, greedy=greedy, verify_fn=verify_fn)
        emitted.append(e)
        n_emitted.append(n)
    return torch.stack(emitted), torch.stack(n_emitted), state, tcaches


def plookup_prefill_decode(tparams: Params, cfg: ModelConfig, tcaches: Caches,
                           ptokens: torch.Tensor, pseq_id: int, pstart, plast,
                           ptrue_len: int, ptemp: torch.Tensor,
                           ptop_k: torch.Tensor, ptop_p: torch.Tensor,
                           state: PLookupState, seq_ids: torch.Tensor,
                           gen: Optional[torch.Generator], temps: torch.Tensor,
                           *, hist_len: int, gamma: int, ngram: int,
                           n_rounds: int, sample_mode: str = "simple",
                           greedy: bool = False):
    """The piggybacked prompt-lookup step: one pending slot's prefill chunk,
    its length fix and first-token sample, then the rounds -> (first token
    (1,) int32, emitted, n_emitted, the final state, tcaches)."""
    plogits, tcaches = prefill_true_len(tparams, cfg, tcaches, ptokens,
                                        pseq_id, pstart, plast, ptrue_len,
                                        hist_len)
    ptok = sample_batch(plogits, gen, ptemp, ptop_k, ptop_p, mode=sample_mode)
    return (ptok,) + plookup_decode_multi(
        tparams, cfg, tcaches, state, seq_ids, gen, temps, gamma=gamma,
        ngram=ngram, n_rounds=n_rounds, greedy=greedy)


def spec_prefill_decode(tparams: Params, dparams: Params, cfg: ModelConfig,
                        dcfg: ModelConfig, tcaches: Caches, dcaches: Caches,
                        ptokens: torch.Tensor, pseq_id: int, pstart, plast,
                        ptrue_len: int, ptemp: torch.Tensor,
                        ptop_k: torch.Tensor, ptop_p: torch.Tensor,
                        state: SpecState, seq_ids: torch.Tensor,
                        gen: Optional[torch.Generator], temps: torch.Tensor,
                        *, hist_len: int, gamma: int, n_rounds: int,
                        sample_mode: str = "simple", greedy: bool = False):
    """The piggybacked speculative step: one pending slot's prefill chunk on
    the target and its mirror on the draft, both length fixes and the
    first-token sample (through the full sampler of ``sample_mode``), then
    the rounds -> (first token (1,) int32, emitted, n_emitted, the final
    state, tcaches, dcaches).  The prefill slot and the decoding slots are
    distinct sequences, so the order changes no value."""
    plogits, tcaches = prefill_true_len(tparams, cfg, tcaches, ptokens,
                                        pseq_id, pstart, plast, ptrue_len,
                                        hist_len)
    _, dcaches = prefill_true_len(dparams, dcfg, dcaches, ptokens, pseq_id,
                                  pstart, plast, ptrue_len, hist_len)
    ptok = sample_batch(plogits, gen, ptemp, ptop_k, ptop_p, mode=sample_mode)
    return (ptok,) + spec_decode_multi(
        tparams, dparams, cfg, dcfg, tcaches, dcaches, state, seq_ids, gen,
        temps, gamma=gamma, n_rounds=n_rounds, greedy=greedy)
