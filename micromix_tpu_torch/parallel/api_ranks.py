"""The HTTP server over tensor- or expert-parallel ranks.

Rank 0 runs the ``ApiServer`` over its own engine (wrapped in a
one-engine ``Router``, as on one card); the other ranks' engines sit
behind no router and follow rank 0 in lockstep.  At each step boundary
of rank 0's scheduler, ``Lockstep.send`` broadcasts what changed since
the last one -- the requests admitted (prompt ids, sampling parameters,
stop ids, ``max_new_tokens``, ``req_id``, eos, logprobs), the cancels,
and whether to step -- and rank 0 then applies the same to its engine.
The followers' loop (``Lockstep.follow``) is receive, apply, step, so
every rank admits, cancels and steps at the same boundaries, and the
collectives inside the engines' steps meet.  A cancel from a client that
went away reaches rank 0's engine only at such a boundary too.

The messages go over a CPU gloo group of their own
(``broadcast_object_list``), whichever backend the engines use.  An idle
server sends a heartbeat (op "idle": no step) every
``serve.api.HEARTBEAT_S`` seconds, so a follower waiting in the
broadcast never meets gloo's 30-minute timeout.  Op "stop" ends the
followers' loops when the server closes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch.distributed as dist

from ..serve.engine import Request
from ..serve.sampling import SamplingParams
from .mesh import RankGroup

_FIELDS = ("req_id", "prompt", "max_new_tokens", "eos_id", "stop_ids",
           "logprobs")


class Lockstep:
    """One rank's end of the lockstep channel.  Every rank of ``group``
    makes one (the channel's gloo group is made collectively)."""

    def __init__(self, group: RankGroup):
        self.group = group
        self.ctl = dist.new_group(backend="gloo") if group.world > 1 else None
        # every request this rank admitted, by id (the ranks' outputs are
        # compared after the server closes)
        self.requests: Dict[int, Request] = {}
        self.messages = 0

    def _bcast(self, msg):
        box = [msg]
        if self.ctl is not None:
            src = 0 if self.group.members is None else self.group.members[0]
            dist.broadcast_object_list(box, src=src, group=self.ctl)
        self.messages += 1
        return box[0]

    def send(self, admits: List[Request], cancels: List[int], op: str) -> None:
        """Rank 0, at a step boundary, before it applies the same."""
        for r in admits:
            self.requests[r.req_id] = r
        self._bcast({"op": op, "cancels": list(cancels),
                     "admits": [dict({f: getattr(r, f) for f in _FIELDS},
                                     sampling=dataclasses.asdict(r.sampling))
                                for r in admits]})

    def follow(self, engine) -> None:
        """Ranks > 0: receive, apply, step, until rank 0 says stop."""
        while True:
            msg = self._bcast(None)
            for spec in msg["admits"]:
                spec = dict(spec)
                req = Request(sampling=SamplingParams(**spec.pop("sampling")),
                              **spec)
                self.requests[req.req_id] = req
                engine.submit(req)
            for rid in msg["cancels"]:
                engine.cancel(rid)
            if msg["op"] == "stop":
                return
            if msg["op"] == "step":
                engine.step()

    def outputs(self) -> Dict[int, List[int]]:
        return {rid: list(r.output) for rid, r in sorted(self.requests.items())}


__all__ = ["Lockstep"]
