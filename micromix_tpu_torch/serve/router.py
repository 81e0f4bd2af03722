"""Multi-replica serving router: data-parallel engines behind one queue.

Counterpart of ``micromix_tpu/serve/router.py``: each replica is its own
``Engine`` (its own KV cache, page pool and params, on its own device or
sharing one), and the router assigns each incoming request to the
replica with the least outstanding work (queued prompt + new tokens, and
the active requests' pending prompt and remaining new tokens).  Replicas
share nothing, so the router is plain Python and can sit behind any RPC
front end; ``ApiServer`` drives one.
"""

from __future__ import annotations

from typing import List, Optional

from .engine import Engine, Request


class Router:
    """Least-outstanding-work request router over Engine replicas."""

    def __init__(self, engines: List[Engine]):
        assert engines, "need at least one engine replica"
        self.engines = engines
        self._assigned = [0] * len(engines)

    def _load(self, i: int) -> int:
        """Outstanding work estimate: queued + active prompt/decode tokens."""
        eng = self.engines[i]
        queued = sum(len(r.prompt) + r.max_new_tokens for r in eng.waiting)
        active = sum(
            len(s.pending) + (s.req.max_new_tokens - len(s.req.output))
            for s in eng.slots if s.req is not None)
        return queued + active

    def submit(self, req: Request) -> int:
        """Route one request; returns the replica index chosen."""
        i = min(range(len(self.engines)), key=self._load)
        self.engines[i].submit(req)
        self._assigned[i] += 1
        return i

    def step(self) -> bool:
        """One scheduling tick across all replicas (parallel on real
        deployments — each engine's step is independent)."""
        progressed = False
        for eng in self.engines:
            if eng.step():
                progressed = True
        return progressed

    def cancel(self, req_id: int) -> bool:
        """Abort a request on whichever replica holds it."""
        return any(eng.cancel(req_id) for eng in self.engines)

    def run(self, requests: List[Request]) -> List[Request]:
        for r in requests:
            self.submit(r)
        while self.step():
            pass
        return requests

    @property
    def stats(self):
        return {
            "assigned": list(self._assigned),
            "decode_tokens": [e.decode_tokens for e in self.engines],
            "prefill_tokens": [e.prefill_tokens for e in self.engines],
            "preemptions": [e.preemptions for e in self.engines],
        }


__all__ = ["Router"]
