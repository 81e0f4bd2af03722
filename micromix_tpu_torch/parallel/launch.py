"""Start the ranks of a tensor- or expert-parallel run.

``spawn(fn, world, *args, device=...)`` starts ``world`` processes with
the ``spawn`` start method, meets them over a ``FileStore`` in a fresh
temporary directory (no network port, no ``torchrun``), initialises the
process group on each with the backend ``mesh.pick_backend`` names, and
calls ``fn(group, *args)`` in each, ``group`` the rank's
``mesh.RankGroup``.  It returns the ranks' results in rank order (each
must pickle: plain Python, numpy, or CPU tensors).  Each child runs one
torch thread on the CPU, so the ranks do not oversubscribe the cores.  A
child that raises, or dies, makes the whole call raise with its
traceback; the other ranks are then stopped.

``fn`` is found in the child by its module and name, so it must live in
a module that a fresh interpreter can import without side effects (the
port, or a helper beside the tests), and that module must not import
``jax``.
"""

from __future__ import annotations

import os
import pickle
import queue
import tempfile
import traceback
from typing import Any, Callable, List

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .mesh import RankGroup, pick_backend, rank_device


def _child(fn: Callable, rank: int, world: int, store_path: str, device: str,
           axis: str, args, results) -> None:
    try:
        torch.set_num_threads(1)
        dev = rank_device(rank, device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        backend = pick_backend(world, dev)
        dist.init_process_group(backend, store=dist.FileStore(store_path, world),
                                rank=rank, world_size=world)
        group = RankGroup(world=world, rank=rank, axis=axis, device=dev,
                          backend=backend)
        # pickled here, by value: tensors shared by file descriptor would
        # be gone with this process
        results.put((rank, True, pickle.dumps(fn(group, *args))))
    except BaseException:
        # the parent raises with this traceback; the rank still fails
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, world: int, *args, device="cuda",
          axis: str = "model", poll_s: float = 1.0) -> List[Any]:
    """Run ``fn(group, *args)`` on ``world`` ranks -> their results."""
    if world < 1:
        raise ValueError(f"world size {world}")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="micromix_ranks_") as d:
        store = os.path.join(d, "store")
        procs = [ctx.Process(target=_child,
                             args=(fn, r, world, store, str(device), axis, args,
                                   results))
                 for r in range(world)]
        for p in procs:
            p.start()
        out: dict = {}
        try:
            while len(out) < world:
                try:
                    rank, ok, val = results.get(timeout=poll_s)
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0) and r not in out]
                    if dead:
                        raise RuntimeError(
                            f"rank {dead[0]} died with exit code "
                            f"{procs[dead[0]].exitcode} before reporting")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of {world} raised:\n{val}")
                out[rank] = pickle.loads(val)
        finally:
            if len(out) < world:
                for p in procs:
                    if p.is_alive():
                        p.terminate()
            for p in procs:
                p.join()
    return [out[r] for r in range(world)]


__all__ = ["spawn"]
