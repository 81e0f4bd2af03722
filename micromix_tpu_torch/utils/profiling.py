"""Tracing and timing helpers.

Counterpart of ``micromix_tpu/utils/profiling.py``:

  * ``trace(logdir)``  -- a ``torch.profiler`` trace of the host and, where
                          there is a card, its kernels (CUPTI), written as
                          one Chrome-trace JSON file under ``logdir``
                          (Perfetto, chrome://tracing); the card's
                          kernels appear by their CUDA names
                          (``site_kernel``, ``w8_gemm`` ...);
  * ``annotate(name)`` -- a named range: ``record_function`` in the
                          profiler's trace, and an NVTX range on the card;
  * ``marginal_timer`` -- seconds per call from the difference of two run
                          lengths, which cancels a constant per-run cost.

``hlo_dump_env`` has no counterpart: it sets XLA's dump flags.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Iterator

import torch

__all__ = ["trace", "annotate", "marginal_timer"]


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Profile the body; write ``logdir``/trace_<pid>_<ns>.json on exit."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named range in profiler traces (and NVTX on the card)."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def marginal_timer(fn: Callable[[], object], *, iters: int = 64,
                   reps: int = 3) -> float:
    """Seconds per call of ``fn`` (which must synchronize itself): the best
    of ``reps`` runs of ``iters // 4`` and of ``iters`` calls, and the
    marginal rate between them, after one warm-up call."""

    def run(n: int) -> float:
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            best = min(best, time.perf_counter() - t0)
        return best

    fn()
    lo = max(1, iters // 4)
    t_lo, t_hi = run(lo), run(iters)
    return max((t_hi - t_lo) / (iters - lo), 1e-12)
