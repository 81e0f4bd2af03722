"""Rank functions for the port's parallel tests (TP v1 and v2, EP, PP,
SP, the collectives).

``micromix_tpu_torch.parallel.spawn`` starts each rank in a fresh
interpreter, which finds its function by module and name; the test
files import JAX, so the functions live here, in a module that imports
only torch and the port.  Each returns plain data (numpy, lists, ints).
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from micromix_tpu_torch.parallel import (axis_groups, make_ep_engine,
                                         make_tp_engine,
                                         pipeline_parallel_forward,
                                         quantize_model_tp,
                                         quantize_model_tp_hetero,
                                         sequence_parallel_forward,
                                         shard_params_tp,
                                         shard_quantized_params,
                                         sharded_forward_tp,
                                         sharded_quantized_forward)
from micromix_tpu_torch.parallel.moe_ep import (ep_moe_forward,
                                                ep_moe_forward_hetero,
                                                ep_moe_forward_quant)
from micromix_tpu_torch.serve.engine import Engine, Request
from micromix_tpu_torch.serve.sampling import SamplingParams


def requests(specs: List[Dict[str, Any]]) -> List[Request]:
    """Request specs (prompt, max_new_tokens, logprobs, eos_id, sampling
    kwargs) -> Requests."""
    out = []
    for i, sp in enumerate(specs):
        sp = dict(sp)
        out.append(Request(req_id=i, prompt=list(sp.pop("prompt")),
                           max_new_tokens=sp.pop("max_new_tokens"),
                           logprobs=sp.pop("logprobs", False),
                           eos_id=sp.pop("eos_id", None),
                           sampling=SamplingParams(**sp)))
    return out


def _served(eng, specs) -> Dict[str, Any]:
    reqs = eng.run(requests(specs))
    return {"tokens": [r.output for r in reqs],
            "logprobs": [r.token_logprobs for r in reqs],
            "steps": eng.decode_steps, "prefill_tokens": eng.prefill_tokens}


def tp_forward(group, params, cfg, tokens: np.ndarray) -> np.ndarray:
    """One rank's ``sharded_forward_tp`` over its slice of a global tree."""
    mine = shard_params_tp(params, group.rank, group.world)
    return sharded_forward_tp(mine, cfg, torch.from_numpy(tokens),
                              group).numpy()


def tp_local_quant(group, dense, cfg, calibs, hetero: bool,
                   weight_fp4_only: bool = True):
    """The rank's tree quantized from its shards alone, and the number of
    reduces it took."""
    if hetero:
        tree = quantize_model_tp_hetero(dense, cfg, calibs, group.world,
                                        group=group)
    else:
        tree = quantize_model_tp(dense, cfg, calibs, group.world,
                                 weight_fp4_only=weight_fp4_only, group=group)
    return tree, group.reduces


def tp_serve(group, params, cfg, runs: List[Dict[str, Any]]):
    """Each run: a TP engine over the rank's slice of ``params``
    (``engine`` kwargs) serving ``specs``; its streams, the rank's cache
    heads, and the reduces it took."""
    params = shard_params_tp(params, group.rank, group.world)
    out = []
    for run in runs:
        group.reset_counts()
        eng = make_tp_engine(params, cfg, group, **run["engine"])
        res = _served(eng, run["specs"])
        res["cache_heads"] = eng.caches[0].n_kv_heads
        res["reduces"] = group.reduces
        out.append(res)
    return out


def single_serve(params, cfg, runs: List[Dict[str, Any]]):
    """The single-card engine on the same runs (for the parent)."""
    return [_served(Engine(params, cfg, device="cpu", **run["engine"]),
                    run["specs"]) for run in runs]


def ep_serve(group, params, cfg, runs: List[Dict[str, Any]]):
    """Each run: an EP engine over the rank's experts of ``params`` (a
    global EP tree), ``cfg`` or the run's own config."""
    out = []
    for run in runs:
        group.reset_counts()
        eng = make_ep_engine(params, run.get("cfg", cfg), group, **run["engine"])
        res = _served(eng, run["specs"])
        res["reduces"] = group.reduces
        out.append(res)
    return out


def ep_forwards(group, cases):
    """Each case (kind, x, ln2, router, global stacked experts, cfg) ->
    the rank's ``ep_moe_forward*`` on its slice of the experts."""
    from micromix_tpu_torch.parallel.ep_serve import _slice_experts
    fns = {"dense": ep_moe_forward, "quant": ep_moe_forward_quant,
           "hetero": ep_moe_forward_hetero}
    out = []
    for kind, x, ln2, router, stacked, cfg in cases:
        el = cfg.num_experts // group.world
        if kind == "dense":
            mine = {k: v[group.rank * el:(group.rank + 1) * el]
                    for k, v in stacked.items()}
        else:
            mine = _slice_experts(
                {k: v for k, v in stacked.items()
                 if k not in ("splits_in", "splits_down")},
                group.rank * el, (group.rank + 1) * el)
            if kind == "quant":
                mine.update(splits_in=stacked["splits_in"],
                            splits_down=stacked["splits_down"])
        out.append(fns[kind](x, ln2, router, mine, cfg, group)
                   .to(torch.float32).numpy())
    return out


def cuda_all_reduce(group) -> Dict[str, Any]:
    """One f32 sum of CUDA tensors over the group."""
    t = torch.tensor([1.0, 2.0, 3.0], device=group.device) * (group.rank + 1)
    group.all_reduce(t)
    return {"sum": t.cpu().tolist(), "backend": group.backend,
            "device": str(t.device)}


def tp_quant_and_forward(group, dense, tree, cfg, calibs, tokens, hetero: bool,
                         weight_fp4_only: bool):
    """The rank's own tree quantized from its shards, the reduces that
    took, and (with ``tokens``) its forward over its slice of ``tree``."""
    local, n_reduce = tp_local_quant(group, dense, cfg, calibs, hetero,
                                     weight_fp4_only)
    logits = None if tokens is None else tp_forward(group, tree, cfg, tokens)
    return local, n_reduce, logits


def spmd_forward(group, params, cfg, tokens: np.ndarray, data: int,
                 model: int) -> np.ndarray:
    """TP v1 on a (data, model) layout: the rank's model shard of the
    global tree, its data shard's logits."""
    groups = axis_groups(group, data=data, model=model)
    mine = shard_quantized_params(params, groups["model"].rank, model)
    return sharded_quantized_forward(mine, cfg, torch.from_numpy(tokens),
                                     groups).numpy()


def pp_forward(group, params, cfg, tokens: np.ndarray,
               n_micro: int) -> np.ndarray:
    """The rank's (replicated) logits of the pipeline over its stages."""
    return pipeline_parallel_forward(params, cfg, torch.from_numpy(tokens),
                                     group, n_micro=n_micro).numpy()


def sp_forwards(group, params, cases) -> List[np.ndarray]:
    """Each case (cfg, tokens, attn) -> the rank's sequence shard of the
    logits."""
    return [sequence_parallel_forward(params, cfg, torch.from_numpy(tokens),
                                      group, attn=attn).numpy()
            for cfg, tokens, attn in cases]


def collectives(group) -> Dict[str, Any]:
    """Each collective on a rank-dependent bf16 and f32 tensor; the 2-D
    layout's groups on 4 ranks; the counts by kind."""
    out = {}
    r, w = group.rank, group.world
    for dt in (torch.bfloat16, torch.float32):
        t = (torch.arange(2 * 4 * w, dtype=torch.float32).reshape(2, 4 * w)
             + 1000 * r).to(dt)
        out[str(dt)] = {
            "all_gather": group.all_gather(t, 1),
            "all_to_all": group.all_to_all(t, 1, 0),
            "ring": group.ppermute(t, [(i, (i + 1) % w) for i in range(w)]),
            "chain": group.ppermute(t, [(i, i + 1) for i in range(w - 1)]),
            "broadcast": group.broadcast(t.clone(), w - 1)}
    out["counts"] = dict(group.counts)
    if w == 4:
        gs = axis_groups(group, data=2, model=2)
        x = torch.tensor([float(r)])
        out["layout"] = {a: (g.rank, g.world, g.all_gather(x, 0).tolist())
                         for a, g in gs.items()}
    return out
