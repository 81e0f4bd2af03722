"""Pipeline parallelism: layer stages and microbatch streaming.

Counterpart of ``micromix_tpu/parallel/pp.py``.  The JAX package runs one
SPMD program over a "stage" mesh axis; the port runs one process per
stage with a "stage" ``RankGroup`` and the same GPipe schedule: every
stage runs the tick loop of ``n_micro + n_stages - 1`` ticks; at tick t
one ``ppermute`` hands each stage's last output to the next stage (all
stages at once), stage 0 embeds microbatch t, stage s works on
microbatch t - s, and the last stage keeps microbatch t - (n_stages - 1).
A stage skips the layers on a tick that holds no microbatch of its own
(the JAX program computes them and throws them away); the handoff still
runs every tick.

Stage s stacks its layers [s L / n, (s + 1) L / n) with ``stack_layers``
(the JAX package's leading-L-axis stack, which refuses layers of other
structures or budgets; a data field that differs between layers,
ScaledW8's per-tensor base, stacks as a tuple) and runs them through ``forward``'s own
``decoder_layer``, so the prefill attention is Kernel E on the card (the
JAX package's ``use_flash=None``: its flash kernel off the CPU) and the
plain f32 attention on the CPU.  The last stage's hidden states reach
every rank by one ``broadcast``, and each rank applies the final norm
and the head: every rank returns the same logits.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import torch

from ..models.common import ModelConfig, lm_logits, rmsnorm, rope_table
from ..models.transformer import decoder_layer
from ..mx.scaledw8 import GroupedW8, ScaledW8
from .mesh import RankGroup

Params = Dict[str, Any]
# fields that are data, not structure (the JAX package's pytree data
# fields): they may differ between the layers and stack as ``_Stacked``
_DATA_FIELDS = {(ScaledW8, "base"), (GroupedW8, "bases")}


class _Stacked(tuple):
    """A data field's values, one a layer."""


def _stack(trees: List[Any], where: str, data: bool = False):
    first = trees[0]
    if isinstance(first, torch.Tensor):
        shapes = {(tuple(t.shape), t.dtype) for t in trees}
        if len(shapes) != 1:
            raise ValueError(f"layers differ at {where}: {sorted(shapes)}")
        return torch.stack(trees)
    if any(type(t) is not type(first) for t in trees):
        raise ValueError(f"layers differ at {where}: "
                         f"{sorted({type(t).__name__ for t in trees})}")
    if isinstance(first, dict):
        if any(t.keys() != first.keys() for t in trees):
            raise ValueError(f"layers differ in their keys at {where}")
        return {k: _stack([t[k] for t in trees], f"{where}/{k}") for k in first}
    if data:
        return _Stacked(trees)
    if isinstance(first, (list, tuple)):
        if any(len(t) != len(first) for t in trees):
            raise ValueError(f"layers differ in length at {where}")
        return type(first)(_stack([t[i] for t in trees], f"{where}[{i}]")
                           for i in range(len(first)))
    if dataclasses.is_dataclass(first):
        return type(first)(**{
            f.name: _stack([getattr(t, f.name) for t in trees],
                           f"{where}.{f.name}",
                           (type(first), f.name) in _DATA_FIELDS)
            for f in dataclasses.fields(first)})
    if any(t != first for t in trees):
        raise ValueError(f"layers differ at {where}: "
                         f"{sorted({repr(t) for t in trees})}")
    return first


def stack_layers(layers: List[Params]) -> Params:
    """[layer tree] x L -> one tree with a leading L axis on every tensor.

    Refuses layers whose structures, static fields (the segmented
    budgets) or tensor shapes differ, as the JAX package's stack needs one
    treedef: uniform budgets, or the hetero form, whose budgets are
    data."""
    if not layers:
        raise ValueError("no layers to stack")
    return _stack(list(layers), "layer")


def layer_of(stacked, i: int):
    """Layer ``i`` of a stack (its tensors as views)."""
    if isinstance(stacked, (torch.Tensor, _Stacked)):
        return stacked[i]
    if isinstance(stacked, dict):
        return {k: layer_of(v, i) for k, v in stacked.items()}
    if isinstance(stacked, (list, tuple)):
        return type(stacked)(layer_of(v, i) for v in stacked)
    if dataclasses.is_dataclass(stacked):
        return type(stacked)(**{f.name: layer_of(getattr(stacked, f.name), i)
                                for f in dataclasses.fields(stacked)})
    return stacked


def pipeline_parallel_forward(params: Params, cfg: ModelConfig,
                              tokens: torch.Tensor, group: RankGroup, *,
                              n_micro: int = 2) -> torch.Tensor:
    """tokens (B, S), B % n_micro == 0 -> logits (B, S, V) f32 on every
    rank; ``group`` the "stage" group, whose size divides the layers."""
    n_stages, sid = group.world, group.rank
    if cfg.num_layers % n_stages:
        raise ValueError(f"{n_stages} stages do not divide "
                         f"{cfg.num_layers} layers")
    b, s = tokens.shape
    if b % n_micro:
        raise ValueError(f"n_micro={n_micro} does not divide batch {b}")
    mb = b // n_micro
    per = cfg.num_layers // n_stages
    stacked = stack_layers(params["layers"][sid * per:(sid + 1) * per])
    mine = [layer_of(stacked, i) for i in range(per)]
    dev = tokens.device
    cos, sin = rope_table(torch.arange(s, device=dev), cfg)
    tokens_mb = tokens.reshape(n_micro, mb, s).long()
    fwd = [(i, i + 1) for i in range(n_stages - 1)]
    h_prev = torch.zeros((mb, s, cfg.hidden_size), dtype=torch.bfloat16,
                         device=dev)
    outs = torch.zeros((n_micro, mb, s, cfg.hidden_size), dtype=torch.bfloat16,
                       device=dev)
    for t in range(n_micro + n_stages - 1):
        h_recv = group.ppermute(h_prev, fwd)
        if sid == 0:
            h_in = params["embed"][tokens_mb[min(t, n_micro - 1)]].to(
                torch.bfloat16)
        else:
            h_in = h_recv
        if 0 <= t - sid < n_micro:
            h = h_in
            for p in mine:
                h = decoder_layer(h, p, cfg, cos, sin)
        else:
            h = torch.zeros_like(h_in)           # a bubble tick
        mb_idx = t - (n_stages - 1)
        if sid == n_stages - 1 and mb_idx >= 0:
            outs[mb_idx] = h
        h_prev = h
    group.broadcast(outs, n_stages - 1)
    h = rmsnorm(outs.reshape(b, s, cfg.hidden_size), params["final_ln"],
                cfg.rms_eps)
    return lm_logits(h, params["lm_head"])


__all__ = ["stack_layers", "layer_of", "pipeline_parallel_forward"]
