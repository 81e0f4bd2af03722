"""Data-parallel serving: R replicas of P ranks behind one router.

Counterpart of the JAX package's multi-replica topology (``docs/dcn.md``:
``serve.router.Router`` over single-chip, ``make_tp_engine`` or
``make_ep_engine`` replicas on disjoint device meshes).  JAX runs that
topology in one process; here a TP or EP engine is one process a rank,
so the router spreads requests over rank groups.

Placement: the world of R x P ranks is laid out as (data=R, axis=P)
(``mesh.axis_groups``), on the world's own axis as ``launch.spawn`` set
it ("model" for TP, "expert" for EP): replica r is global ranks
r P ... (r + 1) P - 1, whose group serves the replica's engine,
``factory(group, r)`` (``make_tp_engine``, ``make_ep_engine``, or a
plain ``Engine`` at P = 1).  Rank g sits on card g when the machine has
R P cards (NCCL inside a replica), and on one card over gloo when it has
one (``mesh.rank_device``, ``mesh.pick_backend``).  At R = 1 the
replica's group is the world.

Every rank makes a ``ReplicaRouter`` (collectively: it makes the
process groups, then the rank's engine).  On global rank 0 it is a
``serve.router.Router`` over one mirror a replica (``engines``), with
the Router's surface and decision rule: ``submit`` picks the replica
with the least outstanding work (``router.outstanding``, the formula of
``Router._load``, as of the last step boundary, plus the requests routed
to it since), ties to the lowest index; ``step``, ``cancel``, ``run``,
``stats``.  The other ranks call ``follow``.

The control channel is a CPU gloo group over the world, whichever
backend the engines use, and one over the replicas' first ranks (R > 1
only).  ``step`` broadcasts each replica's admits
(prompt ids, sampling parameters, stop ids, ``max_new_tokens``,
``req_id``, eos, logprobs) and cancels since the last boundary and the
op; every rank applies its replica's part to its engine and steps it, so
the collectives inside a replica meet and the replicas step at the same
time, each in its own processes.  Each replica's first rank then reports
over the leaders' group (``gather_object``; at R = 1 rank 0 holds the
only report and nothing is gathered): the tokens its engine emitted
in order with their logprobs, the requests it finished, each live
request's outstanding work, its counters and new times to first token.
Rank 0 replays that on its mirror ``Request``s -- ``output``,
``token_logprobs``, ``on_token`` in emission order, then ``done`` --
replica by replica, as ``Router.step`` steps in-process engines in turn.
A cancel on rank 0 ends the mirror at once and reaches the replica at
the next boundary (tokens emitted on the replica meanwhile are dropped).
``heartbeat`` sends op "idle" (no step), so a follower waiting in the
broadcast never meets gloo's 30-minute timeout; ``close`` sends op
"stop", which ends the followers' loops.

A rank that raises or dies makes the run fail: its peers' next
collective raises, and ``launch.spawn`` raises with its traceback and
stops the other ranks.  Nothing falls back to fewer replicas or to the
CPU.  The factory must not make process groups (every rank would have
to enter them).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import torch.distributed as dist

from ..serve.engine import Engine, Request
from ..serve.router import Router, outstanding
from ..serve.sampling import SamplingParams
from .mesh import RankGroup, axis_groups

_FIELDS = ("req_id", "prompt", "max_new_tokens", "eos_id", "stop_ids",
           "logprobs")
_COUNTERS = ("decode_tokens", "prefill_tokens", "preemptions", "spec_proposed",
             "spec_accepted")


def _spec(req: Request) -> Dict[str, Any]:
    spec = {f: getattr(req, f) for f in _FIELDS}
    spec["prompt"] = [int(t) for t in req.prompt]
    spec["sampling"] = dataclasses.asdict(req.sampling)
    return spec


class _Member:
    """One rank's engine and the requests it was handed (copies of rank
    0's, made from the broadcast specs)."""

    def __init__(self, engine: Engine, leader: bool):
        self.engine = engine
        self.leader = leader
        self.requests: Dict[int, Request] = {}
        self._open: Dict[int, Request] = {}     # not yet reported done
        self._events: List[tuple] = []
        self._ttft_sent: set = set()

    def _note(self, req: Request, token) -> None:
        lp = (req.token_logprobs[-1]
              if req.logprobs and len(req.token_logprobs) == len(req.output)
              else None)
        self._events.append((req.req_id, int(token), lp))

    def apply(self, msg: Dict[str, Any], replica: int) -> Optional[Dict]:
        """Admit, cancel, and on op "step" step -> the leader's report."""
        for spec in msg["admits"].get(replica, ()):
            spec = dict(spec)
            req = Request(sampling=SamplingParams(**spec.pop("sampling")),
                          **spec)
            req.on_token = lambda t, r=req: self._note(r, t)
            self.requests[req.req_id] = self._open[req.req_id] = req
            self.engine.submit(req)
        for rid in msg["cancels"].get(replica, ()):
            self.engine.cancel(rid)
        if msg["op"] != "step":
            return None
        t0 = time.perf_counter()
        progressed = self.engine.step()
        step_s = time.perf_counter() - t0
        if not self.leader:
            self._events.clear()
            return None
        eng = self.engine
        done = [rid for rid, r in self._open.items() if r.done]
        for rid in done:
            del self._open[rid]
        ttft = {rid: eng.ttft[rid] for rid, _, _ in self._events
                if rid not in self._ttft_sent and rid in eng.ttft}
        self._ttft_sent.update(ttft)
        report = dict(events=self._events, done=done, work=outstanding(eng),
                      ttft=ttft, progressed=bool(progressed), step_s=step_s,
                      counters={k: getattr(eng, k) for k in _COUNTERS},
                      phase_s=dict(eng.phase_s), phase_steps=dict(eng.phase_steps))
        self._events = []
        return report


class _Replica:
    """Rank 0's mirror of one replica: its live requests (the caller's
    ``Request`` objects), what was routed to it or cancelled since the
    last boundary, and what ``Router.stats`` and
    ``ApiServer._metrics_text`` read, as of the last boundary."""

    def __init__(self):
        self.live: Dict[int, Request] = {}
        self.pending: List[Request] = []
        self.cancels: List[int] = []
        self.work: Dict[int, int] = {}
        self.ttft: Dict[int, float] = {}
        for k in _COUNTERS:
            setattr(self, k, 0)
        self.phase_s: Dict[str, float] = {}
        self.phase_steps: Dict[str, int] = {}
        self.steps = 0
        self.step_s = 0.0           # the leader's host seconds in step()

    def submit(self, req: Request) -> None:
        self.live[req.req_id] = req
        self.pending.append(req)

    def load(self) -> int:
        """``Router._load``'s figure: the work reported at the last
        boundary, and the requests routed here since (queued: prompt +
        new tokens)."""
        return (sum(self.work.values())
                + sum(len(r.prompt) + r.max_new_tokens for r in self.pending))

    def cancel(self, req_id: int) -> bool:
        req = self.live.pop(req_id, None)
        if req is None:
            return False
        req.done = True
        self.work.pop(req_id, None)
        if any(r is req for r in self.pending):
            self.pending = [r for r in self.pending if r is not req]
        else:
            self.cancels.append(req_id)
        return True

    def take(self):
        """-> (the admits' specs, the cancels) since the last boundary."""
        admits = [_spec(r) for r in self.pending]
        cancels, self.pending, self.cancels = self.cancels, [], []
        return admits, cancels

    def absorb(self, rep: Dict[str, Any]) -> None:
        """Replay the leader's report on the mirror requests."""
        for rid, tok, lp in rep["events"]:
            req = self.live.get(rid)
            if req is None:
                continue            # cancelled here since it was sent
            req.output.append(tok)
            if lp is not None:
                req.token_logprobs.append(lp)
            if req.on_token is not None:
                req.on_token(tok)
        for rid in rep["done"]:
            req = self.live.pop(rid, None)
            if req is not None:
                req.done = True
        self.work = {rid: w for rid, w in rep["work"].items()
                     if rid in self.live}
        self.ttft.update(rep["ttft"])
        for k, v in rep["counters"].items():
            setattr(self, k, v)
        self.phase_s, self.phase_steps = rep["phase_s"], rep["phase_steps"]
        self.steps += 1
        self.step_s += rep["step_s"]


class ReplicaRouter(Router):
    """R replicas of ``group.world / R`` ranks; on global rank 0 the
    router over them, on the others ``follow``.  Every rank of
    ``group`` (the world) makes one."""

    def __init__(self, group: RankGroup,
                 factory: Callable[[RankGroup, int], Engine],
                 replicas: int = 1):
        if replicas < 1 or group.world % replicas:
            raise ValueError(f"{replicas} replicas do not divide "
                             f"{group.world} ranks")
        self.group = group
        self.size = group.world // replicas
        self.replica = group.rank // self.size
        # the channel first: the factory may run collectives, never
        # make groups
        self.ctl = dist.new_group(backend="gloo") if group.world > 1 else None
        self.leads = (dist.new_group(list(range(0, group.world, self.size)),
                                     backend="gloo") if replicas > 1 else None)
        local = (group if replicas == 1 else
                 axis_groups(group, data=replicas,
                             **{group.axis: self.size})[group.axis])
        self.local = local
        self.member = _Member(factory(local, self.replica),
                              leader=local.rank == 0)
        self.messages = 0
        self.ticks = 0
        self.tick_s = 0.0           # rank 0's host seconds in step()
        self.ctl_s = 0.0            # of which in the broadcast and gather
        super().__init__([_Replica() for _ in range(replicas)])

    @property
    def engine(self) -> Engine:
        """This rank's engine."""
        return self.member.engine

    # ---------------- the channel ----------------

    def _bcast(self, msg):
        t0 = time.perf_counter()
        box = [msg]
        if self.ctl is not None:
            dist.broadcast_object_list(box, src=0, group=self.ctl)
        self.messages += 1
        self.ctl_s += time.perf_counter() - t0
        return box[0]

    def _gather(self, report) -> List[Any]:
        """The replicas' first ranks: their reports, by replica, on rank 0."""
        t0 = time.perf_counter()
        if self.leads is None:
            out = [report]
        else:
            out = [None] * len(self.engines) if self.group.rank == 0 else None
            dist.gather_object(report, out, dst=0, group=self.leads)
        self.ctl_s += time.perf_counter() - t0
        return out

    def _rank0(self) -> None:
        if self.group.rank != 0:
            raise RuntimeError("only global rank 0 routes; the other ranks "
                               "follow")

    # ---------------- rank 0: the router ----------------

    def _load(self, i: int) -> int:
        return self.engines[i].load()

    def submit(self, req: Request) -> int:
        self._rank0()
        return super().submit(req)

    def cancel(self, req_id: int) -> bool:
        self._rank0()
        return super().cancel(req_id)

    def step(self) -> bool:
        """One boundary: the replicas' admits and cancels out, every
        replica steps, the leaders' reports back onto the mirrors."""
        self._rank0()
        t0 = time.perf_counter()
        msg = {"op": "step", "admits": {}, "cancels": {}}
        for r, rep in enumerate(self.engines):
            admits, cancels = rep.take()
            if admits:
                msg["admits"][r] = admits
            if cancels:
                msg["cancels"][r] = cancels
        self._bcast(msg)
        reports = self._gather(self.member.apply(msg, self.replica))
        progressed = False
        for r, rep in enumerate(self.engines):
            got = reports[r]
            rep.absorb(got)
            progressed = progressed or got["progressed"]
        self.ticks += 1
        self.tick_s += time.perf_counter() - t0
        return progressed

    def heartbeat(self) -> None:
        """Op "idle": the followers wake and wait again (no step)."""
        self._rank0()
        self._bcast({"op": "idle", "admits": {}, "cancels": {}})

    def close(self) -> None:
        """Op "stop": the followers' loops end."""
        self._rank0()
        self._bcast({"op": "stop", "admits": {}, "cancels": {}})

    # ---------------- the other ranks ----------------

    def follow(self) -> None:
        """Receive, apply, step (and report), until rank 0 says stop."""
        if self.group.rank == 0:
            raise RuntimeError("global rank 0 routes; it does not follow")
        while True:
            msg = self._bcast(None)
            report = self.member.apply(msg, self.replica)
            if msg["op"] == "stop":
                return
            if msg["op"] == "step" and self.member.leader:
                self._gather(report)

    # ---------------- every rank ----------------

    def outputs(self) -> Dict[int, List[int]]:
        """Every request this rank's engine served, by id -> its tokens."""
        return {rid: list(r.output)
                for rid, r in sorted(self.member.requests.items())}


__all__ = ["ReplicaRouter"]
