"""Expert parallelism for Mixtral: each rank holds E / ep of the experts.

Counterpart of ``micromix_tpu/parallel/moe_ep.py``.  The dense-dispatch
MoE form makes EP one sum: every rank routes all tokens (the router is
tiny and replicated), runs its local experts on the tokens weighted by
their routing weights (capacity dispatch: the same slots on every rank,
each gathering only its experts' rows), and one f32 ``all_reduce`` adds
the ranks' partials.  No token exchange, static shapes.

The experts come stacked (``stack_*_experts``): every tensor of an
expert's tree gains a leading expert dim and every int becomes a tuple
(``stack_tree``; ``models.transformer.index_tree`` reads expert i back),
and a rank's stack holds its local experts only.  These forwards route
with the router's f32 logits (``x . w_router^T`` with f32 sums, no bias),
as the JAX package's do; serving goes through
``models.transformer.moe_block``'s expert-parallel branches instead
(``parallel/ep_serve.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import torch

from ..models.common import DenseLinear, ModelConfig, QuantSite, rmsnorm
from ..models.transformer import (_expert_out, _silu, capacity_dispatch,
                                  index_tree, moe_capacity, routing_weights)
from .mesh import RankGroup


def stack_tree(trees: List[Any]):
    """Same-shaped trees (dicts, dataclasses, tensors, ints, None) -> one
    tree whose tensors are stacked on a new leading dim and whose ints
    are tuples."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(trees)
    if isinstance(first, dict):
        return {k: stack_tree([t[k] for t in trees]) for k in first}
    if dataclasses.is_dataclass(first):
        return type(first)(**{f.name: stack_tree([getattr(t, f.name)
                                                  for t in trees])
                              for f in dataclasses.fields(first)})
    if isinstance(first, (bool, int)):
        return tuple(trees)
    if first is None:
        if any(t is not None for t in trees):
            raise ValueError("experts differ in which fields they carry")
        return None
    raise TypeError(f"cannot stack {type(first).__name__}")


def stack_dense_experts(experts: List[Dict[str, DenseLinear]]) -> Dict[str, torch.Tensor]:
    """[{w1, w3, w2} DenseLinears] -> {name: (E, n, k) bf16}."""
    return {n: torch.stack([ep[n].w for ep in experts]) for n in ("w1", "w3", "w2")}


def stack_quant_experts(experts: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Quantized (segmented) experts of one budget -> the stacked tree:
    w1 / w3 / w2 stacked, the input sites' perms (E, K), the budgets."""
    s_in, s_dn = experts[0]["site_in"], experts[0]["site_down"]
    for ep in experts:
        if (ep["site_in"].splits != s_in.splits
                or ep["site_down"].splits != s_dn.splits):
            raise ValueError("uniform per-expert budgets required to stack")
    out = {n: stack_tree([ep[n] for ep in experts]) for n in ("w1", "w3", "w2")}
    out.update(perm_in=torch.stack([ep["site_in"].perm for ep in experts]),
               splits_in=s_in.splits, splits_down=s_dn.splits)
    return out


def stack_hetero_experts(experts: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Hetero experts (any budget mix: their shapes do not depend on it)
    -> one stacked tree."""
    return stack_tree(experts)


def _weights(x, ln2, router: DenseLinear, cfg: ModelConfig):
    xn = rmsnorm(x, ln2, cfg.rms_eps)
    logits = torch.matmul(xn.to(torch.float32), router.w.to(torch.float32).t())
    return xn, routing_weights(logits, cfg.num_experts_per_tok)


def ep_moe_forward(x: torch.Tensor, ln2: torch.Tensor, router: DenseLinear,
                   stacked: Dict[str, torch.Tensor], cfg: ModelConfig,
                   group: RankGroup) -> torch.Tensor:
    """One dense MoE FFN block on a rank's local experts (``stacked``:
    (E / ep, n, k) bf16 each), summed over the ranks.  x: (T, hidden)."""
    xn, weights = _weights(x, ln2, router, cfg)
    el = stacked["w1"].shape[0]
    e_off = group.rank * el
    xf = xn.to(torch.float32)
    out = torch.zeros((xn.shape[0], stacked["w2"].shape[1]), dtype=torch.float32,
                      device=x.device)
    for i in range(el):
        g = torch.matmul(xf, stacked["w1"][i].to(torch.float32).t())
        u = torch.matmul(xf, stacked["w3"][i].to(torch.float32).t())
        act = (_silu(g) * u).to(torch.bfloat16)
        y = torch.matmul(act.to(torch.float32), stacked["w2"][i].to(torch.float32).t())
        out = out + y * weights[:, e_off + i][:, None]
    return group.all_reduce(out).to(torch.bfloat16)


def _local_experts(x, ln2, router, experts: List[Dict[str, Any]],
                   cfg: ModelConfig, group: RankGroup) -> torch.Tensor:
    """The quantized local experts (each ``_expert_out``) under dense or
    capacity dispatch, summed over the ranks."""
    xn, weights = _weights(x, ln2, router, cfg)
    e_off = group.rank * len(experts)
    t, k = xn.shape
    if cfg.moe_capacity_factor is not None:
        # the routing is replicated, so every rank picks the same slots
        idx, gate = capacity_dispatch(weights, moe_capacity(cfg, t))
        xn_pad = torch.cat([xn, xn.new_zeros((1, k))])
        out = torch.zeros((t + 1, k), dtype=torch.float32, device=x.device)
        for i, ep in enumerate(experts):
            rows = idx[e_off + i].long()
            ye = _expert_out(ep, xn_pad[rows])
            out.index_add_(0, rows, ye.to(torch.float32) * gate[e_off + i][:, None])
        return group.all_reduce(out[:-1].contiguous()).to(torch.bfloat16)
    out = torch.zeros((t, k), dtype=torch.float32, device=x.device)
    for i, ep in enumerate(experts):
        out = out + _expert_out(ep, xn).to(torch.float32) * weights[:, e_off + i][:, None]
    return group.all_reduce(out).to(torch.bfloat16)


def ep_moe_forward_quant(x: torch.Tensor, ln2: torch.Tensor,
                         router: DenseLinear, stacked: Dict[str, Any],
                         cfg: ModelConfig, group: RankGroup) -> torch.Tensor:
    """The quantized (segmented) MoE block on a rank's stacked local
    experts (``stack_quant_experts``): each expert's site, w1 / w3, the
    silu site and w2, weighted f32 sums, one sum over the ranks."""
    el = stacked["perm_in"].shape[0]
    experts = [{"site_in": QuantSite(*stacked["splits_in"],
                                     perm=stacked["perm_in"][i]),
                "site_down": QuantSite(*stacked["splits_down"]),
                **{n: index_tree(stacked[n], i) for n in ("w1", "w3", "w2")}}
               for i in range(el)]
    return _local_experts(x, ln2, router, experts, cfg, group)


def ep_moe_forward_hetero(x: torch.Tensor, ln2: torch.Tensor,
                          router: DenseLinear, stacked: Dict[str, Any],
                          cfg: ModelConfig, group: RankGroup) -> torch.Tensor:
    """The hetero MoE block on a rank's stacked local experts
    (``stack_hetero_experts``): each expert's block-format sites."""
    el = stacked["w2"].w.codes.shape[0]
    return _local_experts(x, ln2, router,
                          [index_tree(stacked, i) for i in range(el)], cfg,
                          group)


__all__ = ["stack_tree", "stack_dense_experts", "stack_quant_experts",
           "stack_hetero_experts", "ep_moe_forward", "ep_moe_forward_quant",
           "ep_moe_forward_hetero"]
