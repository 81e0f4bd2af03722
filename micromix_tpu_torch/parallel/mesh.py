"""A rank group: one process's place on one axis of a parallel run.

Counterpart of ``micromix_tpu/parallel/mesh.py`` (``make_mesh``) and of
``pp.make_pp_mesh``.  The JAX package makes one mesh that a single
program is ``shard_map``'d over; the port runs one process per rank
(SPMD over ``torch.distributed``), and a ``RankGroup`` stands in for
the mesh axis that the JAX program names: "data" (batch), "expert"
(Mixtral experts), "seq" (sequence parallelism), "model" (tensor
parallelism) and "stage" (pipeline stages).  It holds the world size,
the rank, the axis, the rank's device and its process group.  A 2-D
layout (TP v1's data x model) gives each rank one group per axis
(``axis_groups``), over ``dist.new_group`` subgroups, in JAX's device
order: the last axis varies fastest.

The backend follows one rule: NCCL when every rank has a card of its own
(the ranks on CUDA and at least as many cards as ranks); gloo otherwise,
so two ranks that share one card (NCCL refuses that) and ranks on the CPU
run over gloo.  A backend that fails to start raises; nothing gives way
to another backend or to the CPU.

The collectives, as ``jax.lax`` names them:

  * ``all_reduce(t, op)``           ``psum`` (in place);
  * ``all_gather(t, dim)``          ``all_gather(..., tiled=True)``: the
                                    ranks' tensors concatenated along
                                    ``dim`` in rank order;
  * ``all_to_all(t, split_dim, concat_dim)``  ``all_to_all(...,
                                    tiled=True)``: chunk j of ``t`` along
                                    ``split_dim`` goes to rank j, the
                                    chunks received concatenate along
                                    ``concat_dim`` in rank order;
  * ``ppermute(t, pairs)``          every (src, dst) pair at once through
                                    ``batch_isend_irecv`` (a ring cannot
                                    deadlock); a rank that receives
                                    nothing gets zeros;
  * ``broadcast(t, src)``           rank ``src``'s tensor on every rank.

Gloo takes CUDA tensors only in the ops of ``GLOO_CUDA_OPS``; for the
others (``ppermute``) the group copies a CUDA tensor to the host, runs
the op there and copies the result back (``staged``: the kinds it
staged since ``reset_counts``).  On NCCL every
op runs on the device tensors.  The group counts each kind's calls and
their host seconds (``counts``, ``seconds``), so a run can report its
collectives apart.  A group of one rank needs no process group: every
collective is the identity (a ``ppermute`` pair (0, 0) a copy).
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import math
import time
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

AXES = ("data", "expert", "seq", "model", "stage")
# the collectives gloo runs on CUDA tensors, as
# scripts/torch_gloo_cuda_probe.py finds them on an H100 with torch 2.11:
# all_reduce, broadcast, all_gather and all_to_all_single take them; send
# / recv and batch_isend_irecv (so ppermute) of a CUDA tensor fail (the
# sender's gloo: "writev ... Bad address", its peer: "Connection closed
# by peer"), and the list form of all_to_all is not in its gloo at all.
# The others stage through the host.
GLOO_CUDA_OPS = ("all_reduce", "broadcast", "all_gather", "all_to_all")


def pick_backend(world: int, device: torch.device) -> str:
    """"nccl" when each of ``world`` ranks has a card of its own, else
    "gloo"."""
    if device.type == "cuda" and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def rank_device(rank: int, device) -> torch.device:
    """Rank r's device: ``cuda:{r % cards}`` for CUDA, else ``device``.
    So the ranks of replica r of R replicas of P ranks (global ranks
    r P ... (r + 1) P - 1) sit on cards r P ... when the machine has R P
    cards."""
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
    # the members' global ranks in group order; None = the world's ranks
    members: Optional[Tuple[int, ...]] = None
    counts: Dict[str, int] = dataclasses.field(
        default_factory=collections.Counter)
    seconds: Dict[str, float] = dataclasses.field(
        default_factory=collections.Counter)
    staged: set = dataclasses.field(default_factory=set)

    def __post_init__(self):
        if self.axis not in AXES:
            raise ValueError(f"axis {self.axis!r} not in {AXES}")

    @classmethod
    def single(cls, axis: str, device) -> "RankGroup":
        """A group of one rank (no process group)."""
        return cls(world=1, rank=0, axis=axis, device=torch.device(device),
                   backend="none")

    # ---------------- counts ----------------

    @property
    def reduces(self) -> int:
        return self.counts["all_reduce"]

    @property
    def reduce_s(self) -> float:
        return self.seconds["all_reduce"]

    def reset_counts(self) -> None:
        """Zero the counts, the seconds and the staged kinds."""
        self.counts.clear()
        self.seconds.clear()
        self.staged.clear()

    def _count(self, kind: str, t0: float) -> None:
        self.seconds[kind] += time.perf_counter() - t0
        self.counts[kind] += 1

    def _host(self, kind: str, t: torch.Tensor) -> bool:
        """Whether this op on ``t`` goes through host memory."""
        if self.backend == "gloo" and t.is_cuda and kind not in GLOO_CUDA_OPS:
            self.staged.add(kind)
            return True
        return False

    def _peer(self, r: int) -> int:
        return r if self.members is None else self.members[r]

    # ---------------- collectives ----------------

    def all_reduce(self, t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """Reduce ``t`` over the group in place; returns it."""
        t0 = time.perf_counter()
        if self.world > 1:
            dist.all_reduce(t, op=op, group=self.group)
        self._count("all_reduce", t0)
        return t

    def broadcast(self, t: torch.Tensor, src: int) -> torch.Tensor:
        """Group rank ``src``'s ``t`` on every rank, in place; returns it."""
        t0 = time.perf_counter()
        if self.world > 1:
            dist.broadcast(t, self._peer(src), group=self.group)
        self._count("broadcast", t0)
        return t

    def all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The ranks' ``t`` concatenated along ``dim`` in rank order."""
        t0 = time.perf_counter()
        if self.world == 1:
            out = t
        else:
            host = self._host("all_gather", t)
            x = (t.cpu() if host else t).contiguous()
            parts = [torch.empty_like(x) for _ in range(self.world)]
            dist.all_gather(parts, x, group=self.group)
            out = torch.cat(parts, dim=dim)
            if host:
                out = out.to(t.device)
        self._count("all_gather", t0)
        return out

    def all_to_all(self, t: torch.Tensor, split_dim: int,
                   concat_dim: int) -> torch.Tensor:
        """Chunk j of ``t`` along ``split_dim`` to rank j; the chunks the
        rank receives concatenated along ``concat_dim`` in rank order."""
        if t.shape[split_dim] % self.world:
            raise ValueError(f"all_to_all: {self.world} ranks do not divide "
                             f"dim {split_dim} of {tuple(t.shape)}")
        t0 = time.perf_counter()
        if self.world == 1:
            out = t
        else:
            host = self._host("all_to_all", t)
            # all_to_all_single sends chunk j of dim 0 to rank j
            x = (t.cpu() if host else t).movedim(split_dim, 0).contiguous()
            got = torch.empty_like(x)
            dist.all_to_all_single(got, x, group=self.group)
            out = torch.cat([c.movedim(0, split_dim)
                             for c in got.chunk(self.world, 0)], dim=concat_dim)
            if host:
                out = out.to(t.device)
        self._count("all_to_all", t0)
        return out

    def ppermute(self, t: torch.Tensor,
                 pairs: Sequence[Tuple[int, int]]) -> torch.Tensor:
        """Every (src, dst) pair at once: rank src's ``t`` lands on rank
        dst.  A rank that is no pair's dst gets zeros."""
        srcs = [s for s, d in pairs if d == self.rank]
        dsts = [d for s, d in pairs if s == self.rank]
        if len(srcs) > 1 or len({d for _, d in pairs}) != len(pairs):
            raise ValueError(f"ppermute pairs {list(pairs)} are not a permutation")
        t0 = time.perf_counter()
        if self.world == 1:
            out = t.clone() if srcs else torch.zeros_like(t)
        else:
            host = self._host("ppermute", t)
            x = (t.cpu() if host else t).contiguous()
            recv = torch.empty_like(x) if srcs else None
            ops = [dist.P2POp(dist.isend, x, self._peer(d), self.group)
                   for d in dsts]
            if srcs:
                ops.append(dist.P2POp(dist.irecv, recv, self._peer(srcs[0]),
                                      self.group))
            for req in dist.batch_isend_irecv(ops) if ops else []:
                req.wait()
            if recv is None:
                out = torch.zeros_like(t)
            else:
                out = recv.to(t.device) if host else recv
        self._count("ppermute", t0)
        return out


def axis_groups(group: RankGroup, **shape: int) -> Dict[str, RankGroup]:
    """The world ``group`` laid out as ``shape`` (axis -> size, in order;
    the last axis varies fastest) -> the rank's group on each axis.

    Every rank must call it, with the same shape: each subgroup is made
    by ``dist.new_group``, which all ranks enter for every subgroup, in
    the same order (axis by axis, then the other axes' coordinates in
    ``itertools.product`` order), on the world's backend (the one
    ``pick_backend`` named for it)."""
    axes, sizes = list(shape), list(shape.values())
    if math.prod(sizes) != group.world:
        raise ValueError(f"layout {shape} does not hold {group.world} ranks")
    coords = list(itertools.product(*[range(n) for n in sizes]))
    mine = coords[group.rank]
    out = {}
    for i, axis in enumerate(axes):
        for rest in itertools.product(*[range(n) for j, n in enumerate(sizes)
                                        if j != i]):
            members = tuple(coords.index(rest[:i] + (x,) + rest[i:])
                            for x in range(sizes[i]))
            pg = (dist.new_group(list(members), backend=group.backend)
                  if group.world > 1 else None)
            if group.rank in members:
                out[axis] = RankGroup(
                    world=sizes[i], rank=mine[i], axis=axis,
                    device=group.device, backend=group.backend, group=pg,
                    members=members)
    return out


__all__ = ["RankGroup", "pick_backend", "rank_device", "axis_groups",
           "AXES", "GLOO_CUDA_OPS"]
