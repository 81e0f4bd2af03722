"""The HTTP server over ranks: one replica of tensor- or expert-parallel
ranks, or several (``replicas.ReplicaRouter``).

Global rank 0 runs the ``serve.api.ApiServer`` over its
``ReplicaRouter``, with the constructor it takes over one engine; the
other ranks follow the router's boundaries (``ReplicaRouter.follow``:
receive, apply, step), so every rank of a replica admits, cancels and
steps at the same boundaries and the collectives inside its engine
meet.  A cancel from a client that went away reaches the replica at such
a boundary too.  The idle server's heartbeats and the "stop" at the end
go over the router's channel; ``serve_http`` stops the followers after
the server has closed.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict

from .replicas import ReplicaRouter


def serve_http(router: ReplicaRouter, make_server: Callable[[ReplicaRouter], Any],
               stop: threading.Event,
               on_start: Callable[[Any], None] = None) -> Dict[str, Any]:
    """Rank 0: ``make_server(router)`` (an ``ApiServer``) started,
    ``on_start(server)`` called, until ``stop`` is set; then the server
    closes and the followers stop.  The other ranks follow.  -> the
    rank's requests served and its channel's message count."""
    t0 = time.time()
    if router.group.rank == 0:
        srv = make_server(router)
        srv.start()
        try:
            if on_start is not None:
                on_start(srv)
            while not stop.wait(1.0):
                pass
        finally:
            try:
                srv.close()
            finally:
                router.close()
        requests = srv.requests_total
    else:
        router.follow()
        requests = len(router.member.requests)
    return {"requests": requests, "messages": router.messages,
            "wall_s": round(time.time() - t0, 3)}


__all__ = ["serve_http"]
