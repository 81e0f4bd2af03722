"""Continuous-batching engine.

Counterpart of ``micromix_tpu/serve/engine.py`` on one GPU, with its
defaults and names: the parameters are stacked at init (q|k|v and gate|up
become ``ScaledW8Stack``s or, for split-plane weights,
``SplitPlaneStack``s, and a Mixtral layer's ScaledW8 experts their
grouped form, unless ``MICROMIX_NO_STACK`` is set), so a dense ScaledW8
model decodes through the residual pairs, a split-plane one through one
stacked split-plane GEMM per site, and a Mixtral through two grouped
expert GEMMs per layer; fixed ``max_seqs`` slots; waiting requests
are admitted into free slots; fresh prompts of at most ``prefill_chunk``
tokens that wait together are prefilled in one call (``prefill_batch``);
a longer or resumed context streams through the cache in chunks of
``prefill_chunk`` tokens, each after the first attending over the
quantized history, one chunk per slot per step; with ``piggyback`` one
pending slot's chunk rides the decode call (``prefill_decode``); every
step runs one ``decode_multi`` chunk for all slots (inactive and
mid-prefill slots point at a scratch row and page 0) and retires requests
at eos, a stop id or ``max_new_tokens``.  When the page pool runs out, a
prefill chunk is requeued, and decode preempts the youngest other
request, which is recomputed from prompt + output when it is admitted
again (and keeps its repetition penalties: presence is taken from
prompt + output).

The request surface is the JAX engine's: the logit controls
(``repetition_penalty``, ``min_new_tokens`` against ``eos_id`` and
``stop_ids``, ``min_p``), ``stop_ids``, chosen-token ``logprobs``, an
``on_token`` stream and ``cancel`` (safe from inside ``on_token``).  A
chunk runs the decode variant its live requests need (controls,
logprobs or neither); a slot that needs controls or logprobs turns
piggyback off for that step, as in the JAX engine.

Speculative decoding, as in the JAX engine: with ``draft_params`` (a
draft model) or ``spec_ngram`` (prompt lookup, no draft) the decode phase
becomes ``spec_rounds`` rounds of propose / verify / accept per call
(``serve/speculative.py``) while every live request is greedy or plain
temperature sampling without controls or logprobs (``_spec_ok``); else
the step runs a normal decode chunk.  Every target prefill call (batched,
chunked, piggybacked) is mirrored into the draft's caches, so the draft
sees the token stream the target saw; with ``piggyback`` one pending
slot's chunk rides the spec call (``spec_prefill_decode``,
``plookup_prefill_decode``) and the plain piggyback stays off.

``prefix_cache=True`` shares KV pages across requests whose contexts
start alike (``serve/prefix_cache.py``): admission attaches the longest
cached page chain and prefills from there over the quantized history,
every prefill chunk registers its full pages, and a finished request
registers its generated tokens' pages too.  In spec mode the draft's
caches mirror the shared pages at the same physical ids.  Without it the
pages come from the native pool (``NativeBlockManager``), as in the JAX
engine.

Pipelined decode, on by default as in the JAX engine (``pipeline=True``;
off under speculation and the prefix cache): a plain decode chunk's
tokens are not fetched when it is dispatched.  The next ``step`` first
dispatches the chunk after it from the in-flight chunk's last tokens,
which stay on the device, and only then waits for the in-flight chunk's
tokens and emits them, so the card runs chunk k + 1 while the host
processes chunk k.  Any scheduling event drains the pipeline and takes the
normal path: a pending prefill, a changed active set or request identity
(a finish, a cancel), controls or logprobs, another sample mode, a page
stall.  A slot that uses up ``max_new_tokens`` inside the in-flight chunk
is pointed at the scratch row in the next one; one that ends at eos or a
stop id decodes one more chunk into pages it still owns, whose tokens are
dropped.  The host never waits for the card in the dispatch: the tokens
come back by a ``non_blocking`` copy into pinned memory and an event, and
every host-to-device copy of the engine goes through pinned memory
without a stream synchronize (``_to_device``).  The sampler's generator
advances as in the unpipelined engine (the same chunks in the same order,
each draw a (B, V) array), so greedy and sampled streams are the same;
as in the JAX engine, a chunk dispatched before an eos is seen still
carries the ended request's sampling mode.

Custom step programs, as in the JAX engine (``step_fns``, a ``StepFns``;
``parallel/tp_serve.py`` and ``parallel/ep_serve.py`` make them for one
rank of a tensor- or expert-parallel run): the parameters are not
stacked, nothing piggybacks, a chunk over history (chunked prefill, a
prefix-cache hit) needs ``prefill_hist`` (without it a prompt is
prefilled in one call up to the largest bucket), batched prefill needs
``prefill_batch``, speculation needs the ``spec_multi`` /
``plookup_multi`` factories (the draft and its caches stay whole on every
rank, its prefill mirror the runner's), and pipelined decode needs
``decode_multi_returns_last``.  ``cache_sharding`` gives a rank's share
of the KV heads: the engine makes its caches with that many heads, and
never the whole cache.

The shell reads the JAX engine's stats: ``prefill_tokens``,
``decode_tokens``, ``preemptions``, ``phase_s`` (with ``"spec"``),
``ttft`` (req_id -> seconds from ``submit`` to the request's first
token), ``spec_proposed``, ``spec_accepted`` and ``prefix_hit_tokens``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import limits
from ..models.common import ModelConfig
from ..models.surgery import stack_layer_projections
from .block_manager import NativeBlockManager
from .kv_cache import make_cache
from .prefix_cache import PrefixBlockManager
from .runner import decode_multi, prefill, prefill_batch, prefill_decode
from .speculative import (PLookupState, SpecState, plookup_decode_multi,
                          plookup_prefill_decode, spec_decode_multi,
                          spec_prefill_decode)
from .sampling import (SamplingParams, apply_logit_controls, ban_mask,
                       chosen_logprobs, minp_shifts, pick_sample_mode,
                       sample_batch, unpack_presence, uses_logit_controls)


@dataclasses.dataclass
class Request:
    req_id: int
    prompt: List[int]
    max_new_tokens: int = 32
    sampling: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    eos_id: Optional[int] = None
    # more terminators (e.g. a chat template's); any match ends the
    # request as eos_id does
    stop_ids: Optional[List[int]] = None
    # streaming: called with each emitted token id as it is produced (a
    # decode chunk delivers up to decode_chunk tokens at once)
    on_token: Optional[Any] = None
    # also return each chosen token's RAW log-probability (log_softmax of
    # the untempered, unpenalized logits) in token_logprobs
    logprobs: bool = False
    # filled by the engine
    output: List[int] = dataclasses.field(default_factory=list)
    token_logprobs: List[float] = dataclasses.field(default_factory=list)
    done: bool = False


def check_card_serves(device: torch.device, cfg: ModelConfig,
                      kv_bits: int,
                      draft_cfg: Optional[ModelConfig] = None,
                      page_size: Optional[int] = None) -> None:
    """Refuse, before any cache is made, what one of the card's attention
    and KV kernels (C, D, E, H) would refuse later, by their shared
    statement (``kernels/limits.py``): a model (the target, or the draft
    of speculative decoding) whose head_dim is odd or over 256 or that
    has more than 64 query heads per KV head, KV pages of other than 4, 8
    or 16 bits, a page size C does not take.  A sliding window runs on the
    card (C, E and H apply it).  The CPU serves what ``make_cache`` makes
    through the plain versions."""
    if device.type != "cuda":
        return
    for name, c in (("model", cfg), ("draft", draft_cfg)):
        if c is None:
            continue
        why = limits.refusal("engine", head_dim=c.head_dim,
                             num_heads=c.num_heads,
                             num_kv_heads=c.num_kv_heads, bits=kv_bits,
                             page_size=page_size)
        if why is not None:
            raise NotImplementedError(
                f"the card does not serve the {name}: {why}; pass "
                "device='cpu' for the plain versions")


@dataclasses.dataclass
class StepFns:
    """The engine's step programs (the JAX engine's ``StepFns``), each
    taking ``runner``'s arguments without the config:

      * ``prefill(params, caches, tokens, seq_id, start_pos, last_idx)``
        and ``decode_multi(params, caches, tokens, seq_ids, positions, gen,
        temps, top_k, top_p, controls, *, n_steps, sample_mode,
        with_logprobs)``, as ``runner.prefill`` (no history) and
        ``runner.decode_multi``;
      * ``prefill_hist``: ``prefill`` with ``hist_len=`` (a chunk over the
        quantized history), enabling chunked prefill and the prefix cache;
      * ``prefill_batch(params, caches, tokens, seq_ids, last_idx)``,
        enabling batched fresh prefill;
      * ``spec_multi(draft_cfg, gamma, n_rounds)`` -> fn(tparams, dparams,
        tcaches, dcaches, state, seq_ids, gen, temps, *, greedy), and
        ``plookup_multi(gamma, n_rounds, ngram)`` -> fn(tparams, tcaches,
        state, seq_ids, gen, temps, *, greedy): speculative rounds, as
        ``speculative.spec_decode_multi`` / ``plookup_decode_multi``;
      * ``decode_multi_returns_last``: ``decode_multi``'s tokens stay on
        the device and its last row feeds the next chunk, enabling
        pipelined decode.
    """

    prefill: Callable
    decode_multi: Callable
    prefill_hist: Optional[Callable] = None
    prefill_batch: Optional[Callable] = None
    spec_multi: Optional[Callable] = None
    plookup_multi: Optional[Callable] = None
    decode_multi_returns_last: bool = False


def _bind(fn: Callable, cfg: ModelConfig) -> Callable:
    return lambda params, caches, *a, **kw: fn(params, cfg, caches, *a, **kw)


def runner_step_fns(cfg: ModelConfig) -> StepFns:
    """The single-card programs: the runner's and ``speculative``'s."""
    def spec_multi(dcfg, gamma, n_rounds):
        return lambda tp, dp, tc, dc, *a, **kw: spec_decode_multi(
            tp, dp, cfg, dcfg, tc, dc, *a, gamma=gamma, n_rounds=n_rounds, **kw)

    def plookup_multi(gamma, n_rounds, ngram):
        return lambda tp, tc, *a, **kw: plookup_decode_multi(
            tp, cfg, tc, *a, gamma=gamma, n_rounds=n_rounds, ngram=ngram, **kw)

    return StepFns(prefill=_bind(prefill, cfg),
                   decode_multi=_bind(decode_multi, cfg),
                   prefill_hist=_bind(prefill, cfg),
                   prefill_batch=_bind(prefill_batch, cfg),
                   spec_multi=spec_multi, plookup_multi=plookup_multi,
                   decode_multi_returns_last=True)


@dataclasses.dataclass
class _Slot:
    req: Optional[Request] = None
    pos: int = 0
    # context tokens not yet prefilled (chunked prefill)
    pending: List[int] = dataclasses.field(default_factory=list)
    # the whole admitted context (prompt + earlier output); the prefix
    # cache keys pages off ctx[:pos]
    ctx: List[int] = dataclasses.field(default_factory=list)

    @property
    def ready(self) -> bool:
        return self.req is not None and not self.pending


class Engine:
    def __init__(self, params: Dict[str, Any], cfg: ModelConfig, *,
                 max_seqs: int = 4, page_size: int = 128,
                 max_pages_per_seq: int = 64, n_pages: Optional[int] = None,
                 kv_bits: int = 4,
                 prefill_buckets=(16, 32, 64, 128, 256, 512, 1024, 2048),
                 decode_chunk: int = 8, prefill_chunk: Optional[int] = None,
                 seed: int = 0, piggyback: bool = True,
                 draft_params: Optional[Dict[str, Any]] = None,
                 draft_cfg: Optional[ModelConfig] = None,
                 spec_gamma: int = 4, spec_rounds: Optional[int] = None,
                 spec_ngram: int = 0, spec_window: int = 256,
                 prefix_cache: bool = False, pipeline: bool = True,
                 step_fns: Optional[StepFns] = None,
                 cache_sharding: Optional[Callable[[int], int]] = None,
                 device=None):
        self.device = resolve_device(device)
        if spec_ngram > 0 and draft_params is not None:
            raise ValueError("spec_ngram and draft_params are mutually "
                             "exclusive speculation modes")
        self.draft_cfg = draft_cfg if draft_cfg is not None else (
            cfg if draft_params is not None else None)
        check_card_serves(self.device, cfg, kv_bits, self.draft_cfg,
                          page_size)
        custom = step_fns is not None
        if not custom and not os.environ.get("MICROMIX_NO_STACK"):
            # one stacked GEMM per site at decode, one wide product at
            # prefill, the experts grouped; MICROMIX_NO_STACK=1 keeps the
            # per-consumer and per-expert form.  Per-expert params are
            # grouped into a second copy here: a full-size Mixtral comes
            # grouped from random_quantized_model instead.  One memo for
            # the target and the draft: a draft that aliases the target's
            # layers shares their stacked dicts instead of a second copy.
            memo: dict = {}
            params = stack_layer_projections(params, memo)
            if draft_params is not None:
                draft_params = stack_layer_projections(draft_params, memo)
        self.params = params
        self.draft_params = draft_params
        self.cfg = cfg
        self.max_seqs = max_seqs
        self.page_size = page_size
        self.buckets = tuple(sorted(prefill_buckets))
        n_pages = n_pages or (max_seqs * max_pages_per_seq + 1)

        def caches(c: ModelConfig, n_kv: int):
            # one extra page-table row: inactive and mid-prefill slots
            # decode against it, so their real pages are never written
            return [make_cache(n_pages, page_size, n_kv, c.head_dim,
                               max_seqs + 1, max_pages_per_seq, bits=kv_bits,
                               device=self.device)
                    for _ in range(c.num_layers)]

        self.caches = caches(cfg, cfg.num_kv_heads if cache_sharding is None
                             else cache_sharding(cfg.num_kv_heads))
        # the draft's caches take every page-table row and length the
        # engine writes into the target's; a rank keeps the whole draft
        self.dcaches = (caches(self.draft_cfg, self.draft_cfg.num_kv_heads)
                        if draft_params is not None else None)
        if custom:
            if prefix_cache and step_fns.prefill_hist is None:
                # a hit prefills from the match point, over history
                raise ValueError("prefix_cache with custom step_fns "
                                 "requires StepFns.prefill_hist")
            if spec_ngram > 0 and step_fns.plookup_multi is None:
                raise ValueError("prompt-lookup speculation with custom "
                                 "step_fns requires StepFns.plookup_multi")
            if draft_params is not None and step_fns.spec_multi is None:
                raise ValueError("speculative decoding with custom step_fns "
                                 "requires StepFns.spec_multi")
        self._sf = step_fns if custom else runner_step_fns(cfg)
        # the draft runs the runner's programs (whole on every rank)
        self._dsf = (runner_step_fns(self.draft_cfg)
                     if draft_params is not None else None)
        self._prefix_cache = prefix_cache
        self.block_manager = (PrefixBlockManager if prefix_cache
                              else NativeBlockManager)(
            n_pages, page_size, max_seqs, max_pages_per_seq)
        self.slots = [_Slot() for _ in range(max_seqs)]
        self.waiting: List[Request] = []
        self.decode_chunk = max(1, decode_chunk)
        self.prefill_chunk = min(prefill_chunk or self.buckets[-1],
                                 self.buckets[-1])
        if self._sf.prefill_hist is None:
            # no chunk over history: each prompt in one call
            self.prefill_chunk = self.buckets[-1]
        # speculation: a draft model, or prompt lookup over each request's
        # own tokens (no draft, no mirror); the plain piggyback runs the
        # target alone, so spec mode has its own fused call instead
        self.spec_gamma = spec_gamma
        self.spec_rounds = spec_rounds or max(
            1, decode_chunk // (spec_gamma + 1))
        self.spec_ngram = spec_ngram
        self.spec_window = spec_window
        self._plookup = spec_ngram > 0
        self._spec_on = self._plookup or draft_params is not None
        self._piggyback_ok = piggyback and not self._spec_on and not custom
        self._spec_piggyback_ok = piggyback and self._spec_on and not custom
        if self._plookup:
            self._plookup_multi = self._sf.plookup_multi(
                spec_gamma, self.spec_rounds, spec_ngram)
        elif draft_params is not None:
            self._spec_multi = self._sf.spec_multi(
                self.draft_cfg, spec_gamma, self.spec_rounds)
        # window columns: the lookup window and slack for the rounds' appends
        self._plookup_T = spec_window + self.spec_rounds * (spec_gamma + 1)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        # pipelined decode (the JAX engine's conditions): the in-flight
        # chunk's record, or None
        self._pipeline_ok = (pipeline and not self._spec_on and not prefix_cache
                             and self._sf.decode_multi_returns_last)
        self._inflight: Optional[Dict[str, Any]] = None
        # stats: host wall seconds and steps per phase ("mixed" is a
        # piggybacked prefill chunk + decode chunk; "spec" counts rounds)
        self.prefill_tokens = 0
        self.decode_tokens = 0
        self.decode_steps = 0
        self.preemptions = 0
        self.phase_s = {"prefill": 0.0, "decode": 0.0, "mixed": 0.0,
                        "spec": 0.0}
        self.phase_steps = {"decode": 0, "mixed": 0, "spec": 0}
        # seconds from submit to each request's first token
        self.ttft: Dict[int, float] = {}
        self._t_submit: Dict[int, float] = {}
        self.prefix_hit_tokens = 0
        self.spec_accepted = 0
        self.spec_proposed = 0

    @contextlib.contextmanager
    def _phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.phase_s[name] += time.perf_counter() - t0

    # ---------------- host-side page tables ----------------

    def _all_caches(self):
        return self.caches + (self.dcaches or [])

    def _to_device(self, a, dtype=None) -> torch.Tensor:
        """A host array on the engine's device, without waiting for the
        card: a copy in pinned memory sent ``non_blocking`` (PyTorch's
        pinned allocator reuses that buffer only after the copy has run),
        where a blocking copy would end in a stream synchronize."""
        t = torch.from_numpy(np.array(a, dtype=dtype))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _set_rows(self, slot_id: int, row: np.ndarray) -> None:
        row_t = self._to_device(row, np.int32)
        for c in self._all_caches():
            c.page_table[slot_id] = row_t

    def _set_lengths(self, slot_ids: List[int], lengths: List[int]) -> None:
        idx = self._to_device(slot_ids, np.int64)
        val = self._to_device(lengths, np.int32)
        for c in self._all_caches():
            c.lengths[idx] = val

    def _ensure_pages(self, slot_id: int, needed_tokens: int) -> None:
        before = self.block_manager.num_pages(slot_id)
        row = self.block_manager.ensure(slot_id, needed_tokens)
        if self.block_manager.num_pages(slot_id) != before:
            self._set_rows(slot_id, row)

    def _register_prefix(self, slot_id: int) -> None:
        """Make the slot's prefilled full pages matchable (prefix cache)."""
        if self._prefix_cache:
            slot = self.slots[slot_id]
            self.block_manager.register_prefix(slot_id, slot.ctx, slot.pos)

    def _release(self, slot_id: int) -> None:
        slot = self.slots[slot_id]
        if self._prefix_cache and slot.req is not None:
            # the generated tokens' pages too, so a follow-up turn whose
            # prompt extends prompt + output hits them; slot.pos counts the
            # tokens whose K/V is written (the last emitted token's is
            # not), and in draft mode one fewer: a fully accepted last
            # round leaves the draft's K/V at pos - 1 unwritten
            covered = slot.pos - (1 if self.dcaches is not None else 0)
            self.block_manager.register_prefix(
                slot_id, slot.req.prompt + slot.req.output, covered)
        self.block_manager.release(slot_id)
        self.slots[slot_id] = _Slot()
        self._set_rows(slot_id, np.zeros((self.caches[0].max_pages_per_seq,),
                                         np.int32))
        self._set_lengths([slot_id], [0])

    # ---------------- scheduling ----------------

    def submit(self, req: Request) -> None:
        self.waiting.append(req)
        self._t_submit[req.req_id] = time.time()

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(f"prompt length {n} exceeds the largest bucket")

    def _preempt(self, slot_id: int) -> None:
        """Evict a running sequence and requeue it at the front; it is
        recomputed from prompt + output when admitted again."""
        req = self.slots[slot_id].req
        self._release(slot_id)
        self.waiting.insert(0, req)
        self.preemptions += 1

    def _admit(self) -> None:
        for slot_id, slot in enumerate(self.slots):
            if slot.req is not None or not self.waiting:
                continue
            req = self.waiting.pop(0)
            # output is non-empty after a preemption: recompute it
            ctx = req.prompt + req.output
            slot.req, slot.pos = req, 0
            slot.pending, slot.ctx = list(ctx), list(ctx)
            if self._prefix_cache:
                matched = self.block_manager.match_and_attach(slot_id, ctx)
                if matched:
                    # the shared pages hold the prefix's K/V: point the
                    # rows (target and draft) at them and prefill the rest
                    # over that history
                    self._set_rows(slot_id,
                                   self.block_manager.table_row(slot_id))
                    self._set_lengths([slot_id], [matched])
                    slot.pos = matched
                    slot.pending = list(ctx[matched:])
                    self.prefix_hit_tokens += matched

    def _sample_rows(self, logits: torch.Tensor, reqs: List[Request]):
        """Sample one token per row (a prefill's first tokens) with the
        rows' controls -> (tokens (B,) np, raw logprobs (B,) np or None)."""
        t, k, p = self._sampling_arrays(reqs)
        mode = pick_sample_mode([r.sampling for r in reqs])
        x = logits
        if uses_logit_controls([r.sampling for r in reqs]):
            bits, pen, ban, mrem, mps = self._controls_arrays(reqs)
            v = logits.shape[1]
            x = apply_logit_controls(
                logits, unpack_presence(bits, v), pen,
                (mrem > 0)[:, None] & ban_mask(ban, v), minp_shift=mps)
        toks = sample_batch(x, self._gen, t, k, p, mode=mode)
        if not any(r.logprobs for r in reqs):
            return toks.cpu().numpy(), None
        return toks.cpu().numpy(), chosen_logprobs(logits, toks).cpu().numpy()

    def _controls_arrays(self, reqs: List[Optional[Request]]):
        """(presence_bits, penalties, ban_ids, min_remaining, minp_shift)
        on the device for the logit-controls stage; row i covers reqs[i]
        (None = neutral).  Presence is taken from prompt + output and
        ships bit-packed (B, ceil(V/8)); ban_ids (B, W) lists every
        terminator (eos_id and stop_ids) to suppress while
        min_new_tokens is unmet, W the widest row, padded with -1."""
        b = len(reqs)
        presence = np.zeros((b, self.cfg.vocab_size), bool)
        pen = np.ones((b,), np.float32)
        mrem = np.zeros((b,), np.int32)
        bans: List[List[int]] = [[] for _ in reqs]
        for i, r in enumerate(reqs):
            if r is None:
                continue
            sp = r.sampling
            pen[i] = sp.repetition_penalty
            if sp.repetition_penalty != 1.0:
                presence[i, np.asarray(r.prompt + r.output, np.int64)] = True
            if sp.min_new_tokens > len(r.output):
                ids = ([r.eos_id] if r.eos_id is not None else []) \
                    + list(r.stop_ids or [])
                if ids:
                    bans[i] = ids
                    mrem[i] = sp.min_new_tokens - len(r.output)
        ban = np.full((b, max(1, max(len(x) for x in bans))), -1, np.int32)
        for i, ids in enumerate(bans):
            ban[i, :len(ids)] = ids
        packed = np.packbits(presence, axis=1, bitorder="little")
        mps = minp_shifts([r.sampling if r is not None else None for r in reqs])
        return tuple(self._to_device(a) for a in (packed, pen, ban, mrem, mps))

    def _sampling_arrays(self, reqs: List[Optional[Request]]):
        sp = [r.sampling if r is not None else SamplingParams() for r in reqs]
        return (self._to_device([s.temperature for s in sp], np.float32),
                self._to_device([s.top_k for s in sp], np.int32),
                self._to_device([s.top_p for s in sp], np.float32))

    def _prefill_batch_pass(self) -> set:
        """Prefill every fresh prompt of at most ``prefill_chunk`` tokens
        in one call when there are at least two; returns the slot ids
        handled.  A slot whose pages do not fit is requeued."""
        fresh = [i for i, s in enumerate(self.slots)
                 if s.req is not None and s.pending and s.pos == 0
                 and len(s.pending) <= self.prefill_chunk]
        if len(fresh) < 2 or self._sf.prefill_batch is None:
            return set()
        bucket = self._bucket(max(len(self.slots[i].pending) for i in fresh))
        ok = []
        for i in fresh:
            try:
                self._ensure_pages(i, bucket)
                ok.append(i)
            except RuntimeError:
                req = self.slots[i].req
                self._release(i)
                self.waiting.insert(0, req)
        if len(ok) < 2:
            return set()
        b = self.max_seqs
        toks = np.zeros((b, bucket), np.int32)
        seqs = np.full((b,), self.max_seqs, np.int32)   # pad rows -> scratch
        last = np.zeros((b,), np.int32)
        for row, i in enumerate(ok):
            chunk = self.slots[i].pending
            toks[row, :len(chunk)] = chunk
            seqs[row] = i
            last[row] = len(chunk) - 1
        args = (self._to_device(toks), self._to_device(seqs),
                self._to_device(last))
        logits, self.caches = self._sf.prefill_batch(self.params, self.caches,
                                                     *args)
        if self.dcaches is not None:
            # the draft's mirror: the same tokens into its caches
            _, self.dcaches = self._dsf.prefill_batch(self.draft_params,
                                                      self.dcaches, *args)
        # bucket padding wrote extra positions: restore the true lengths
        self._set_lengths(ok, [len(self.slots[i].pending) for i in ok])
        firsts, flps = self._sample_rows(logits[:len(ok)],
                                         [self.slots[i].req for i in ok])
        for row, i in enumerate(ok):
            slot = self.slots[i]
            slot.pos = len(slot.pending)
            self.prefill_tokens += slot.pos
            slot.pending = []
            self._register_prefix(i)
            self._emit(i, int(firsts[row]),
                       float(flps[row]) if flps is not None else None)
        return set(ok)

    def _prefill_step(self, slot_id: int) -> bool:
        """Run one prefill chunk for a pending slot.  False on a page
        stall: the slot is released and its request requeued."""
        slot = self.slots[slot_id]
        chunk = slot.pending[:self.prefill_chunk]
        n = len(chunk)
        bucket = self._bucket(n)
        try:
            self._ensure_pages(slot_id, slot.pos + bucket)
        except RuntimeError:
            victims = [j for j, t in enumerate(self.slots)
                       if t.req is not None and j != slot_id]
            if not victims:
                # nobody else holds pages: requeueing would livelock
                raise RuntimeError("KV pool too small for this prompt's prefill")
            req = slot.req
            self._release(slot_id)
            self.waiting.insert(0, req)
            return False
        toks = np.zeros((1, bucket), np.int32)
        toks[0, :n] = chunk
        toks_t = self._to_device(toks)
        args = (toks_t, slot_id, slot.pos, n - 1)
        if slot.pos:
            logits, self.caches = self._sf.prefill_hist(
                self.params, self.caches, *args, hist_len=slot.pos)
        else:
            logits, self.caches = self._sf.prefill(self.params, self.caches,
                                                   *args)
        if self.dcaches is not None:
            # the draft's mirror of this chunk: it sees the token stream,
            # and the chunking, the target saw
            _, self.dcaches = self._dsf.prefill_hist(
                self.draft_params, self.dcaches, *args, hist_len=slot.pos)
        true_len = slot.pos + n
        self._set_lengths([slot_id], [true_len])
        slot.pos = true_len
        slot.pending = slot.pending[n:]
        self.prefill_tokens += n
        self._register_prefix(slot_id)
        if not slot.pending:
            first, lp = self._sample_rows(logits, [slot.req])
            self._emit(slot_id, int(first[0]),
                       float(lp[0]) if lp is not None else None)
        return True

    def _pick_piggy(self, handled: set) -> Optional[int]:
        """One pending slot whose next chunk rides this step's decode call;
        needs another slot already decoding.  Its pages are reserved here;
        if they do not fit, the per-slot prefill path (which owns the
        stall handling) takes the slot."""
        if not any(s.ready for s in self.slots):
            return None
        for i, s in enumerate(self.slots):
            if i in handled or s.req is None or not s.pending:
                continue
            bucket = self._bucket(len(s.pending[:self.prefill_chunk]))
            try:
                self._ensure_pages(i, s.pos + bucket)
            except RuntimeError:
                return None
            return i
        return None

    def _piggy_decode(self, piggy: int, tokens, seq_ids, positions) -> np.ndarray:
        """One call: the piggy slot's prefill chunk + everyone's decode."""
        slot = self.slots[piggy]
        pchunk = slot.pending[:self.prefill_chunk]
        n = len(pchunk)
        hist = slot.pos
        ptoks = np.zeros((1, self._bucket(n)), np.int32)
        ptoks[0, :n] = pchunk
        t, k, p = self._sampling_arrays([s.req for s in self.slots])
        mode = pick_sample_mode([s.req.sampling for s in self.slots
                                 if s.req is not None])
        pt, pk, pp = self._sampling_arrays([slot.req])
        ptok, toks, self.caches = prefill_decode(
            self.params, self.cfg, self.caches, self._to_device(ptoks),
            piggy, hist, n - 1, hist + n, pt, pk, pp,
            self._to_device(tokens), self._to_device(seq_ids),
            self._to_device(positions), self._gen, t, k, p,
            hist_len=hist, n_steps=self.decode_chunk, sample_mode=mode)
        slot.pos = hist + n
        slot.pending = slot.pending[n:]
        self.prefill_tokens += n
        self._register_prefix(piggy)
        if not slot.pending:
            self._emit(piggy, int(ptok[0]))
        return toks.cpu().numpy()

    def _emit(self, slot_id: int, token: int,
              lp: Optional[float] = None) -> None:
        """Note the time to the first token, append the token, then its
        logprob, call ``on_token``, then end the request at eos, a stop id
        or ``max_new_tokens``."""
        req = self.slots[slot_id].req
        self.ttft.setdefault(req.req_id,
                             time.time() - self._t_submit[req.req_id])
        req.output.append(token)
        if req.logprobs and lp is not None:
            req.token_logprobs.append(lp)
        if req.on_token is not None:
            req.on_token(token)
            if self.slots[slot_id].req is not req:
                return      # the callback cancelled it
        if (req.eos_id is not None and token == req.eos_id) or \
                (req.stop_ids is not None and token in req.stop_ids) or \
                len(req.output) >= req.max_new_tokens:
            req.done = True
            self._release(slot_id)

    def cancel(self, req_id: int) -> bool:
        """Abort a request: take it off the queue, or release its slot.

        Tokens emitted so far stay in ``req.output`` and ``req.done`` is
        set.  Safe between steps and from ``on_token``: the chunk being
        applied skips a released slot.  False if the request is unknown
        or already finished."""
        for i, r in enumerate(self.waiting):
            if r.req_id == req_id:
                self.waiting.pop(i)
                r.done = True
                return True
        for slot_id, slot in enumerate(self.slots):
            if slot.req is not None and slot.req.req_id == req_id:
                slot.req.done = True
                self._release(slot_id)
                return True
        return False

    def _apply_chunk(self, toks: np.ndarray, lps: Optional[np.ndarray],
                     active: List[int], reqs: Dict[int, Request]) -> None:
        """Emit one decode chunk.  ``reqs`` (slot -> Request at dispatch)
        drops the rows of slots finished, cancelled or recycled since."""
        for j in range(toks.shape[0]):
            for i in active:
                s = self.slots[i]
                if not s.ready or s.req is not reqs[i]:
                    continue
                s.pos += 1
                self.decode_tokens += 1
                self._emit(i, int(toks[j, i]),
                           float(lps[j, i]) if lps is not None else None)

    # ---------------- pipelined decode ----------------

    def _defer(self, toks_dev: torch.Tensor, **rec) -> None:
        """Keep a dispatched chunk in flight: its tokens (chunk, B) start
        back to the host by a ``non_blocking`` copy into pinned memory,
        with an event behind it; its last step's tokens stay on the device
        to feed the next chunk."""
        if toks_dev.is_cuda:
            host = torch.empty(toks_dev.shape, dtype=toks_dev.dtype,
                               pin_memory=True)
            host.copy_(toks_dev, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        else:
            host, done = toks_dev, None
        self._inflight = dict(rec, toks=host, done=done, last=toks_dev[-1])

    def _process_inflight(self, rec: Dict[str, Any]) -> None:
        """Wait for the in-flight chunk's tokens (its event only: the
        chunk dispatched after it keeps running) and emit them."""
        with self._phase("decode"):
            if rec["done"] is not None:
                rec["done"].synchronize()
            toks = rec["toks"].numpy()
        self._apply_chunk(toks, None, rec["active"], rec["reqs"])

    def _try_pipeline(self) -> bool:
        """Steady state: dispatch the next decode chunk from the in-flight
        chunk's last tokens, then process the in-flight chunk while the
        new one runs.  False (the caller drains and takes the normal path)
        on a scheduling event: a pending prefill, a changed active set or
        request identity (a finish, a cancel), controls or logprobs,
        another sample mode, a page stall.  (Queued arrivals do not stop
        it: ``_admit`` ran, so every slot is taken.)"""
        rec = self._inflight
        if rec is None or not self._pipeline_ok:
            return False
        if any(s.req is not None and s.pending for s in self.slots):
            return False
        live = []
        for i in rec["active"]:
            s = self.slots[i]
            if s.req is None or s.req is not rec["reqs"][i]:
                return False
            live.append(s.req)
        if [i for i, s in enumerate(self.slots) if s.ready] != rec["active"]:
            return False
        if uses_logit_controls([r.sampling for r in live]) \
                or any(r.logprobs for r in live):
            return False
        chunk = self.decode_chunk
        # a slot that uses up max_new_tokens inside the in-flight chunk
        # goes to the scratch row (an eos is seen only when the chunk is
        # processed: that slot decodes one more chunk, whose rows drop)
        live_ids = [i for i in rec["active"]
                    if len(rec["reqs"][i].output) + chunk
                    < rec["reqs"][i].max_new_tokens]
        if not live_ids:
            return False
        # the mode the unpipelined engine would pick after the in-flight
        # chunk retires those slots, so that the generator draws alike
        mode = pick_sample_mode([rec["reqs"][i].sampling for i in live_ids])
        if mode != rec["mode"]:
            return False
        positions = rec["positions"].copy()
        positions[live_ids] += chunk
        for i in live_ids:
            try:
                self._ensure_pages(i, int(positions[i]) + chunk + 1)
            except RuntimeError:
                return False
        with self._phase("decode"):
            self._dispatch(rec, live_ids, positions)
        self._process_inflight(rec)
        return True

    def _dispatch(self, rec: Dict[str, Any], live_ids: List[int],
                  positions: np.ndarray) -> None:
        """Enqueue the chunk after ``rec`` for ``live_ids`` and make it
        the in-flight chunk.  Nothing here waits for the card: the tokens
        are the in-flight chunk's last ones on the device, the seq ids and
        sampling arrays its own (new seq ids and the positions go by
        ``_to_device``)."""
        seq_ids = rec["seq_ids"]
        if live_ids != rec["active"]:
            sid = np.full((self.max_seqs,), self.max_seqs, np.int32)
            sid[live_ids] = live_ids
            seq_ids = self._to_device(sid)
        t, k, p = rec["tkp"]
        chunk = self.decode_chunk
        toks_dev, self.caches = self._sf.decode_multi(
            self.params, self.caches, rec["last"], seq_ids,
            self._to_device(positions), self._gen, t, k, p, None,
            n_steps=chunk, sample_mode=rec["mode"])
        self.decode_steps += chunk
        self.phase_steps["decode"] += chunk
        self._defer(toks_dev, active=live_ids, seq_ids=seq_ids,
                    positions=positions, tkp=rec["tkp"], mode=rec["mode"],
                    reqs={i: rec["reqs"][i] for i in live_ids})

    def step(self) -> bool:
        """Admit, drive pending prefill chunks, run one decode chunk.
        Returns False when there is no work left."""
        self._admit()
        if self._inflight is not None:
            if self._try_pipeline():
                return True
            rec, self._inflight = self._inflight, None
            self._process_inflight(rec)
        with self._phase("prefill"):
            handled = self._prefill_batch_pass()
        # the piggybacked call has no controls stage and no logprobs, so a
        # slot that needs either keeps the separate prefill path
        live_reqs = [s.req for s in self.slots if s.req is not None]
        ctl_live = (uses_logit_controls([r.sampling for r in live_reqs])
                    or any(r.logprobs for r in live_reqs))
        if self._spec_on:
            ready = [i for i, s in enumerate(self.slots) if s.ready]
            piggy = (self._pick_piggy(handled)
                     if self._spec_piggyback_ok and ready and not ctl_live
                     and self._spec_ok(ready) else None)
        else:
            piggy = (self._pick_piggy(handled)
                     if self._piggyback_ok and not ctl_live else None)
        # one prefill chunk per remaining pending slot per step: running
        # sequences wait at most one chunk's latency
        for i, s in enumerate(self.slots):
            if i in handled or i == piggy:
                continue
            if s.req is not None and s.pending:
                with self._phase("prefill"):
                    ok = self._prefill_step(i)
                if not ok:
                    break   # page stall; retry next step
        active = [i for i, s in enumerate(self.slots) if s.ready]
        busy = any(s.req is not None for s in self.slots)
        if not active:
            return busy or bool(self.waiting)
        if self._spec_on:
            if self._spec_ok(active):
                with self._phase("spec"):
                    self._spec_step(active, piggy)
                return True
            if piggy is not None:
                # a request that rules out speculation became ready after
                # the piggy was picked: its chunk takes the plain
                # (draft-mirroring) prefill, not the target-only piggyback
                with self._phase("prefill"):
                    self._prefill_step(piggy)
                piggy = None
        chunk = self.decode_chunk
        tokens = np.zeros((self.max_seqs,), np.int32)
        positions = np.zeros((self.max_seqs,), np.int32)
        seq_ids = np.full((self.max_seqs,), self.max_seqs, np.int32)
        for i, s in enumerate(self.slots):
            if not s.ready:
                continue
            seq_ids[i] = i
            # pages for the whole chunk up front; on exhaustion preempt the
            # youngest other request until the allocation fits
            while True:
                try:
                    self._ensure_pages(i, s.pos + chunk + 1)
                    break
                except RuntimeError:
                    victims = [j for j, t in enumerate(self.slots)
                               if t.req is not None and j != i]
                    if not victims:
                        raise RuntimeError(
                            "KV pool too small for a single sequence")
                    self._preempt(min(
                        victims, key=lambda j: len(self.slots[j].req.output)))
            tokens[i] = s.req.output[-1] if s.req.output else s.req.prompt[-1]
            positions[i] = s.pos
        reqs = {i: self.slots[i].req for i in active}
        lps = None
        self.decode_steps += chunk
        if piggy is not None and self.slots[piggy].pending:
            with self._phase("mixed"):
                toks = self._piggy_decode(piggy, tokens, seq_ids, positions)
            self.phase_steps["mixed"] += chunk
        else:
            t, k, p = self._sampling_arrays([s.req for s in self.slots])
            mode = pick_sample_mode([s.req.sampling for s in self.slots
                                     if s.req is not None])
            # the variant this chunk needs: controls and logprobs of the
            # decoding requests only
            live = [s.req if s.ready else None for s in self.slots]
            ctl = (self._controls_arrays(live)
                   if uses_logit_controls([r.sampling for r in live
                                           if r is not None]) else None)
            need_lp = any(r is not None and r.logprobs for r in live)
            sid_dev = self._to_device(seq_ids)
            with self._phase("decode"):
                out = self._sf.decode_multi(
                    self.params, self.caches,
                    self._to_device(tokens), sid_dev,
                    self._to_device(positions), self._gen, t, k, p,
                    ctl, n_steps=chunk, sample_mode=mode,
                    with_logprobs=need_lp)
                self.caches = out[-1]
                self.phase_steps["decode"] += chunk
                if self._pipeline_ok and ctl is None and not need_lp:
                    # the fetch waits for the next step, which first
                    # dispatches the chunk after this one
                    self._defer(out[0], active=active, seq_ids=sid_dev,
                                positions=positions, tkp=(t, k, p),
                                mode=mode, reqs=reqs)
                    return True
                toks = out[0].cpu().numpy()
                if need_lp:
                    lps = out[1].cpu().numpy()
        self._apply_chunk(toks, lps, active, reqs)
        return True

    # ---------------- speculative decoding ----------------

    def _spec_ok(self, active: List[int]) -> bool:
        """Rounds keep greedy and plain temperature sampling only (the
        accept rule scores the raw target logits): any live top-k, top-p,
        logit-controls or logprobs request takes normal decode chunks."""
        for i in active:
            req = self.slots[i].req
            sp = req.sampling
            if (sp.top_k and sp.top_k > 0) or sp.top_p < 1.0 \
                    or sp.min_p > 0.0 or sp.repetition_penalty != 1.0 \
                    or sp.min_new_tokens > 0 or req.logprobs:
                return False
        return True

    def _plookup_state(self, seq_ids: np.ndarray,
                       positions: np.ndarray) -> PLookupState:
        """Each decoding row's last ``spec_window`` tokens (prompt +
        output), with slack columns for the rounds' appends."""
        toks = np.zeros((self.max_seqs, self._plookup_T), np.int32)
        lens = np.zeros((self.max_seqs,), np.int32)
        for i, s in enumerate(self.slots):
            if seq_ids[i] != i or s.req is None:
                continue
            seq = s.req.prompt + s.req.output
            tail = seq[-min(len(seq), self.spec_window):]
            toks[i, :len(tail)] = tail
            lens[i] = len(tail)
        dev = self.device
        return PLookupState(tokens=torch.from_numpy(toks).to(dev),
                            length=torch.from_numpy(lens).to(dev),
                            positions=torch.from_numpy(positions).to(dev))

    def _spec_step(self, active: List[int], piggy: Optional[int]) -> None:
        """One call of ``spec_rounds`` rounds for every decoding slot; with
        ``piggy``, that pending slot's prefill chunk (and the draft's
        mirror) rides the call.  The emitted tokens and counts are read
        once, after the call."""
        worst = self.spec_rounds * (self.spec_gamma + 1)
        b = self.max_seqs
        prev = np.zeros((b,), np.int32)
        cur = np.zeros((b,), np.int32)
        positions = np.ones((b,), np.int32)
        seq_ids = np.full((b,), b, np.int32)
        for i in list(active):
            s = self.slots[i]
            while True:
                try:
                    self._ensure_pages(i, s.pos + worst + 1)
                    break
                except RuntimeError:
                    victims = [j for j, t in enumerate(self.slots)
                               if t.req is not None and j != i]
                    if not victims:
                        raise RuntimeError(
                            "KV pool too small for a single sequence")
                    self._preempt(min(
                        victims, key=lambda j: len(self.slots[j].req.output)))
                    if self.slots[i].req is None:
                        break
            if not s.ready:
                continue
            seq_ids[i] = i
            cur[i] = s.req.output[-1]
            prev[i] = (s.req.output[-2] if len(s.req.output) >= 2
                       else s.req.prompt[-1])
            positions[i] = s.pos
        temps = np.zeros((b,), np.float32)
        for i, s in enumerate(self.slots):
            if s.req is not None:
                temps[i] = s.req.sampling.temperature
        greedy = bool((temps <= 0.0).all())
        dev = self.device
        t_dev = torch.from_numpy(temps).to(dev)
        sid = torch.from_numpy(seq_ids).to(dev)
        if self._plookup:
            state = self._plookup_state(seq_ids, positions)
        else:
            state = SpecState(prev=torch.from_numpy(prev).to(dev),
                              cur=torch.from_numpy(cur).to(dev),
                              positions=torch.from_numpy(positions).to(dev))
        kw = dict(gamma=self.spec_gamma, n_rounds=self.spec_rounds,
                  greedy=greedy)
        if self._plookup:
            kw["ngram"] = self.spec_ngram
        slot = self.slots[piggy] if piggy is not None else None
        if slot is not None and slot.req is not None and slot.pending:
            pchunk = slot.pending[:self.prefill_chunk]
            n = len(pchunk)
            hist = slot.pos
            ptoks = np.zeros((1, self._bucket(n)), np.int32)
            ptoks[0, :n] = pchunk
            pt, pk, pp = self._sampling_arrays([slot.req])
            pargs = (torch.from_numpy(ptoks).to(dev), piggy, hist, n - 1,
                     hist + n, pt, pk, pp, state, sid, self._gen, t_dev)
            pkw = dict(kw, hist_len=hist,
                       sample_mode=pick_sample_mode([slot.req.sampling]))
            if self._plookup:
                ptok, emitted, n_emitted, _, self.caches = \
                    plookup_prefill_decode(self.params, self.cfg, self.caches,
                                           *pargs, **pkw)
            else:
                ptok, emitted, n_emitted, _, self.caches, self.dcaches = \
                    spec_prefill_decode(self.params, self.draft_params,
                                        self.cfg, self.draft_cfg, self.caches,
                                        self.dcaches, *pargs, **pkw)
            slot.pos = hist + n
            slot.pending = slot.pending[n:]
            self.prefill_tokens += n
            self._register_prefix(piggy)
            if not slot.pending:
                self._emit(piggy, int(ptok[0]))
        elif self._plookup:
            emitted, n_emitted, _, self.caches = self._plookup_multi(
                self.params, self.caches, state, sid, self._gen, t_dev,
                greedy=greedy)
        else:
            emitted, n_emitted, _, self.caches, self.dcaches = \
                self._spec_multi(self.params, self.draft_params, self.caches,
                                 self.dcaches, state, sid, self._gen, t_dev,
                                 greedy=greedy)
        emitted = emitted.cpu().numpy()          # (rounds, B, gamma + 1)
        n_emitted = n_emitted.cpu().numpy()      # (rounds, B)
        self.phase_steps["spec"] += self.spec_rounds
        for r in range(emitted.shape[0]):
            for i in list(active):
                if not self.slots[i].ready:
                    continue
                n = int(n_emitted[r, i])
                self.spec_proposed += self.spec_gamma
                self.spec_accepted += n - 1
                for t in emitted[r, i, :n]:
                    # _emit may release the slot: check the live slot
                    if not self.slots[i].ready:
                        break
                    self.slots[i].pos += 1
                    self.decode_tokens += 1
                    self._emit(i, int(t))
        # the device lengths ran ahead for finished and truncated slots:
        # the slots' own counts hold
        live = [i for i in active if self.slots[i].ready]
        if live:
            self._set_lengths(live, [self.slots[i].pos for i in live])

    def run(self, requests: List[Request]) -> List[Request]:
        for r in requests:
            self.submit(r)
        while self.step():
            pass
        return requests
