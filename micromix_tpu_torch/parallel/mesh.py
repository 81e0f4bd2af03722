"""A rank group: one process's place in a tensor- or expert-parallel run.

Counterpart of ``micromix_tpu/parallel/mesh.py``.  The JAX package makes
one mesh that a single program is ``shard_map``'d over; the port runs one
process per rank (SPMD over ``torch.distributed``), each with its own
engine over its own shard, and a ``RankGroup`` in place of the mesh axis
that the JAX program names ("model" for tensor parallelism, "expert" for
expert parallelism): the world size, the rank, the axis, the rank's
device and its process group.

The backend follows one rule: NCCL when every rank has a card of its own
(the ranks on CUDA and at least as many cards as ranks); gloo otherwise,
so two ranks that share one card (NCCL refuses that) and ranks on the CPU
run over gloo.  Gloo takes CUDA tensors in ``all_reduce`` and stages them
through host memory, a blocking copy each way.  A backend that fails to
start raises; nothing gives way to another backend or to the CPU.

``all_reduce`` is the only collective the serving paths need: one f32 sum
per row-parallel projection (tensor parallelism) and one per MoE block
(expert parallelism).  The group counts its calls and their host seconds
(``reduces``, ``reduce_s``), so a run can report the collectives a step.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import torch
import torch.distributed as dist

AXES = ("model", "expert")


def pick_backend(world: int, device: torch.device) -> str:
    """"nccl" when each of ``world`` ranks has a card of its own, else
    "gloo"."""
    if device.type == "cuda" and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def rank_device(rank: int, device) -> torch.device:
    """Rank r's device: ``cuda:{r % cards}`` for CUDA, else ``device``."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    return torch.device("cuda", rank % torch.cuda.device_count())


@dataclasses.dataclass
class RankGroup:
    """One rank of a ``world``-way group on ``axis``."""

    world: int
    rank: int
    axis: str
    device: torch.device
    backend: str
    group: Optional[Any] = None      # the process group; None = the world
    reduces: int = 0
    reduce_s: float = 0.0

    def __post_init__(self):
        if self.axis not in AXES:
            raise ValueError(f"axis {self.axis!r} not in {AXES}")

    def all_reduce(self, t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """Reduce ``t`` over the group in place; returns it."""
        t0 = time.perf_counter()
        dist.all_reduce(t, op=op, group=self.group)
        self.reduce_s += time.perf_counter() - t0
        self.reduces += 1
        return t

    def reset_counts(self) -> None:
        self.reduces, self.reduce_s = 0, 0.0


__all__ = ["RankGroup", "pick_backend", "rank_device", "AXES"]
