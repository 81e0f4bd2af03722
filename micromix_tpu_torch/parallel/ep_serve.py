"""Expert-parallel serving: a Mixtral whose experts are split over the
ranks, one engine a rank.

Counterpart of ``micromix_tpu/parallel/ep_serve.py``.  The experts (most
of a Mixtral's weights) are split over ``ep`` ranks; attention, the
router, the embedding, the head and the paged KV cache are whole on
every rank.  Each layer carries its experts grouped
(``experts_grouped_ep``: canonical ScaledW8 experts as two grouped GEMMs,
Kernel I) or stacked (``experts_stacked``: hetero experts, one by one),
and a rank's layer holds its local experts and its ``ep_group``; only
``models.transformer.moe_block`` sees the split (one f32 ``all_reduce``
per MoE block), so the step programs are the runner's own and the ranks
stay in lockstep as in ``tp_serve``.  Uniform per-expert budgets are
needed to group or stack the segmented form.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from ..models.common import ModelConfig, QuantLinear, QuantSite
from ..models.surgery import _group_experts, quantize_model
from ..mx.scaledw8 import GroupedW8, ScaledW8
from ..serve.engine import Engine, StepFns, runner_step_fns
from .mesh import RankGroup
from .moe_ep import stack_hetero_experts

Params = Dict[str, Any]
EXPERT_KEYS = ("experts_grouped_ep", "experts_stacked")


def stack_layer_experts(layer: Params) -> Params:
    """One quantized Mixtral layer -> its expert-parallel form: canonical
    ScaledW8 experts (``QuantSite`` sites) grouped (``experts_grouped_ep``,
    ``surgery._group_experts``), any other uniform-budget experts (the
    hetero form) stacked (``experts_stacked``)."""
    experts = layer["experts"]
    sites = [ep.get("site_in") for ep in experts]
    out = {k: v for k, v in layer.items() if k != "experts"}
    if all(isinstance(s, QuantSite) for s in sites) and all(
            isinstance(ep.get(n), QuantLinear) and isinstance(ep[n].w, ScaledW8)
            for ep in experts for n in ("w1", "w2", "w3")):
        if any(s.splits != sites[0].splits for s in sites):
            raise ValueError("uniform per-expert budgets required to group "
                             f"(got {[s.splits for s in sites]})")
        out["experts_grouped_ep"] = _group_experts(experts)
        return out
    if any(isinstance(s, QuantSite) and s.splits != sites[0].splits
           for s in sites):
        raise ValueError("uniform per-expert budgets required to stack "
                         f"(got {[s.splits for s in sites]})")
    out["experts_stacked"] = stack_hetero_experts(experts)
    return out


def quantize_model_ep(params: Params, cfg: ModelConfig, calibs) -> Params:
    """``surgery.quantize_model``, then each layer's experts grouped or
    stacked (the global tree: every expert)."""
    qm = quantize_model(params, cfg, calibs)
    return {**qm, "layers": [stack_layer_experts(p) for p in qm["layers"]]}


def _slice_grouped(gw: GroupedW8, lo: int, hi: int) -> GroupedW8:
    return GroupedW8(codes=gw.codes[lo:hi].contiguous(), bases=gw.bases[lo:hi],
                     biases=tuple(None if b is None else b[lo:hi].contiguous()
                                  for b in gw.biases),
                     sections=gw.sections, padded=gw.padded,
                     k4=gw.k4, k6=gw.k6, k8=gw.k8)


def _slice_experts(tree, lo: int, hi: int):
    """Experts [lo, hi) of a grouped or stacked tree (a stacked int is a
    tuple; a plain int is shared by every expert)."""
    if isinstance(tree, GroupedW8):
        return _slice_grouped(tree, lo, hi)
    if isinstance(tree, torch.Tensor):
        return tree[lo:hi].contiguous()
    if isinstance(tree, tuple):
        return tree[lo:hi]
    if isinstance(tree, dict):
        return {k: _slice_experts(v, lo, hi) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree):
        return type(tree)(**{f.name: _slice_experts(getattr(tree, f.name), lo, hi)
                             for f in dataclasses.fields(tree)})
    return tree


def shard_params_ep(params: Params, group: RankGroup) -> Params:
    """A global EP tree -> the rank's: its E / ep experts of every layer
    (grouped or stacked), and the layer's ``ep_group``; everything else
    whole."""
    def layer(p):
        out = dict(p)
        for key in EXPERT_KEYS:
            if key in p:
                tree = p[key]
                e = (tree["w13"].groups if key == "experts_grouped_ep"
                     else tree["w2"].w.codes.shape[0])
                if e % group.world:
                    raise ValueError(f"ep={group.world} does not divide "
                                     f"num_experts={e}")
                el = e // group.world
                out[key] = _slice_experts(tree, group.rank * el,
                                          (group.rank + 1) * el)
        out["ep_group"] = group
        return out

    return {**params, "layers": [layer(p) for p in params["layers"]]}


def make_ep_step_fns(cfg: ModelConfig) -> StepFns:
    """The runner's programs (the split lives in ``moe_block``): prefill,
    chunked and batched prefill and pipelined decode; no speculation, as
    in the JAX package."""
    sf = runner_step_fns(cfg)
    sf.spec_multi = sf.plookup_multi = None
    return sf


def make_ep_engine(params: Params, cfg: ModelConfig, group: RankGroup,
                   **engine_kw) -> Engine:
    """The rank's ``Engine`` over ``shard_params_ep`` of a global EP tree;
    the caches whole, on the group's device unless ``device`` is given."""
    if cfg.num_experts % group.world:
        raise ValueError(f"ep={group.world} does not divide "
                         f"num_experts={cfg.num_experts}")
    engine_kw.setdefault("device", group.device)
    return Engine(shard_params_ep(params, group), cfg,
                  step_fns=make_ep_step_fns(cfg), **engine_kw)


__all__ = ["make_ep_engine", "make_ep_step_fns", "quantize_model_ep",
           "stack_layer_experts", "shard_params_ep"]
