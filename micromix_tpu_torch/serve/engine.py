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

The shell reads the JAX engine's stats: ``prefill_tokens``,
``decode_tokens``, ``preemptions``, ``phase_s``, and ``ttft`` (req_id ->
seconds from ``submit`` to the request's first token).
``spec_proposed``, ``spec_accepted`` and ``prefix_hit_tokens`` stay 0.

Not ported: prefix caching (ROADMAP item 6), pipelined decode (item 6)
and speculative decoding (item 7).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models.common import ModelConfig
from ..models.surgery import stack_layer_projections
from .block_manager import BlockManager
from .kv_cache import make_cache
from .runner import decode_multi, prefill, prefill_batch, prefill_decode
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
                      kv_bits: int) -> None:
    """Refuse, before any cache is made, what the card's attention kernels
    cannot serve yet: KV pages of other than 4 or 8 bits (bf16 pages,
    ROADMAP 2b), which Kernels C, D and H do not read.  A sliding window
    runs on the card (Kernels C, E and H apply it).  The CPU serves what
    ``make_cache`` makes through the plain versions."""
    if device.type != "cuda":
        return
    if kv_bits not in (4, 8):
        raise NotImplementedError(
            f"the card serves int4 and int8 KV pages, not kv_bits={kv_bits} "
            "(ROADMAP 2b); pass device='cpu' for the plain versions")


@dataclasses.dataclass
class _Slot:
    req: Optional[Request] = None
    pos: int = 0
    # context tokens not yet prefilled (chunked prefill)
    pending: List[int] = dataclasses.field(default_factory=list)

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
                 seed: int = 0, piggyback: bool = True, device=None):
        self.device = resolve_device(device)
        check_card_serves(self.device, cfg, kv_bits)
        if not os.environ.get("MICROMIX_NO_STACK"):
            # one stacked GEMM per site at decode, one wide product at
            # prefill, the experts grouped; MICROMIX_NO_STACK=1 keeps the
            # per-consumer and per-expert form.  Per-expert params are
            # grouped into a second copy here: a full-size Mixtral comes
            # grouped from random_quantized_model instead.
            params = stack_layer_projections(params)
        self.params = params
        self.cfg = cfg
        self.max_seqs = max_seqs
        self.page_size = page_size
        self.buckets = tuple(sorted(prefill_buckets))
        n_pages = n_pages or (max_seqs * max_pages_per_seq + 1)
        # one extra page-table row: inactive and mid-prefill slots decode
        # against it, so their real pages are never written
        self.caches = [
            make_cache(n_pages, page_size, cfg.num_kv_heads, cfg.head_dim,
                       max_seqs + 1, max_pages_per_seq, bits=kv_bits,
                       device=self.device)
            for _ in range(cfg.num_layers)
        ]
        self.block_manager = BlockManager(n_pages, page_size, max_seqs,
                                          max_pages_per_seq)
        self.slots = [_Slot() for _ in range(max_seqs)]
        self.waiting: List[Request] = []
        self.decode_chunk = max(1, decode_chunk)
        self.prefill_chunk = min(prefill_chunk or self.buckets[-1],
                                 self.buckets[-1])
        self.piggyback = piggyback
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        # stats: host wall seconds and decode steps per phase ("mixed" is
        # a piggybacked prefill chunk + decode chunk)
        self.prefill_tokens = 0
        self.decode_tokens = 0
        self.decode_steps = 0
        self.preemptions = 0
        self.phase_s = {"prefill": 0.0, "decode": 0.0, "mixed": 0.0}
        self.phase_steps = {"decode": 0, "mixed": 0}
        # seconds from submit to each request's first token
        self.ttft: Dict[int, float] = {}
        self._t_submit: Dict[int, float] = {}
        # the JAX engine's counters of what the port does not run yet
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

    def _set_rows(self, slot_id: int, row: np.ndarray) -> None:
        row_t = torch.as_tensor(row, dtype=torch.int32).to(self.device)
        for c in self.caches:
            c.page_table[slot_id] = row_t

    def _set_lengths(self, slot_ids: List[int], lengths: List[int]) -> None:
        idx = torch.as_tensor(slot_ids, dtype=torch.long).to(self.device)
        val = torch.as_tensor(lengths, dtype=torch.int32).to(self.device)
        for c in self.caches:
            c.lengths[idx] = val

    def _ensure_pages(self, slot_id: int, needed_tokens: int) -> None:
        before = self.block_manager.num_pages(slot_id)
        row = self.block_manager.ensure(slot_id, needed_tokens)
        if self.block_manager.num_pages(slot_id) != before:
            self._set_rows(slot_id, row)

    def _release(self, slot_id: int) -> None:
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
        for slot in self.slots:
            if slot.req is None and self.waiting:
                req = self.waiting.pop(0)
                # output is non-empty after a preemption: recompute it
                slot.req, slot.pos = req, 0
                slot.pending = req.prompt + req.output

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
        dev = self.device
        return tuple(torch.from_numpy(a).to(dev)
                     for a in (packed, pen, ban, mrem, mps))

    def _sampling_arrays(self, reqs: List[Optional[Request]]):
        sp = [r.sampling if r is not None else SamplingParams() for r in reqs]
        dev = self.device
        return (torch.tensor([s.temperature for s in sp], dtype=torch.float32, device=dev),
                torch.tensor([s.top_k for s in sp], dtype=torch.int32, device=dev),
                torch.tensor([s.top_p for s in sp], dtype=torch.float32, device=dev))

    def _prefill_batch_pass(self) -> set:
        """Prefill every fresh prompt of at most ``prefill_chunk`` tokens
        in one call when there are at least two; returns the slot ids
        handled.  A slot whose pages do not fit is requeued."""
        fresh = [i for i, s in enumerate(self.slots)
                 if s.req is not None and s.pending and s.pos == 0
                 and len(s.pending) <= self.prefill_chunk]
        if len(fresh) < 2:
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
        dev = self.device
        logits, self.caches = prefill_batch(
            self.params, self.cfg, self.caches,
            torch.as_tensor(toks).to(dev), torch.as_tensor(seqs).to(dev),
            torch.as_tensor(last).to(dev))
        # bucket padding wrote extra positions: restore the true lengths
        self._set_lengths(ok, [len(self.slots[i].pending) for i in ok])
        firsts, flps = self._sample_rows(logits[:len(ok)],
                                         [self.slots[i].req for i in ok])
        for row, i in enumerate(ok):
            slot = self.slots[i]
            slot.pos = len(slot.pending)
            self.prefill_tokens += slot.pos
            slot.pending = []
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
        logits, self.caches = prefill(
            self.params, self.cfg, self.caches,
            torch.as_tensor(toks).to(self.device), slot_id, slot.pos, n - 1,
            hist_len=slot.pos)
        true_len = slot.pos + n
        self._set_lengths([slot_id], [true_len])
        slot.pos = true_len
        slot.pending = slot.pending[n:]
        self.prefill_tokens += n
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
        dev = self.device
        ptok, toks, self.caches = prefill_decode(
            self.params, self.cfg, self.caches, torch.as_tensor(ptoks).to(dev),
            piggy, hist, n - 1, hist + n, pt, pk, pp,
            torch.as_tensor(tokens).to(dev), torch.as_tensor(seq_ids).to(dev),
            torch.as_tensor(positions).to(dev), self._gen, t, k, p,
            hist_len=hist, n_steps=self.decode_chunk, sample_mode=mode)
        slot.pos = hist + n
        slot.pending = slot.pending[n:]
        self.prefill_tokens += n
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

    def step(self) -> bool:
        """Admit, drive pending prefill chunks, run one decode chunk.
        Returns False when there is no work left."""
        self._admit()
        with self._phase("prefill"):
            handled = self._prefill_batch_pass()
        # the piggybacked call has no controls stage and no logprobs, so a
        # slot that needs either keeps the separate prefill path
        live_reqs = [s.req for s in self.slots if s.req is not None]
        ctl_live = (uses_logit_controls([r.sampling for r in live_reqs])
                    or any(r.logprobs for r in live_reqs))
        piggy = (self._pick_piggy(handled)
                 if self.piggyback and not ctl_live else None)
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
        dev = self.device
        reqs = {i: self.slots[i].req for i in active}
        lps = None
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
            with self._phase("decode"):
                out = decode_multi(
                    self.params, self.cfg, self.caches,
                    torch.as_tensor(tokens).to(dev),
                    torch.as_tensor(seq_ids).to(dev),
                    torch.as_tensor(positions).to(dev), self._gen, t, k, p,
                    ctl, n_steps=chunk, sample_mode=mode,
                    with_logprobs=need_lp)
                toks, self.caches = out[0].cpu().numpy(), out[-1]
                if need_lp:
                    lps = out[1].cpu().numpy()
            self.phase_steps["decode"] += chunk
        self.decode_steps += chunk
        self._apply_chunk(toks, lps, active, reqs)
        return True

    def run(self, requests: List[Request]) -> List[Request]:
        for r in requests:
            self.submit(r)
        while self.step():
            pass
        return requests
