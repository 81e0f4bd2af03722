"""Tensor parallelism v1: column-parallel q/k/v/gate/up, replicated o and
down over all-gathered inputs, the batch over "data".

Counterpart of ``micromix_tpu/parallel/spmd.py`` (the JAX package's
``shard_map`` over a (data, model) mesh): one process per rank, each with
a "data" and a "model" ``RankGroup`` (``mesh.axis_groups``).

  * q/k/v/gate/up (Mixtral's w1/w3 too): weight ROWS sharded over
    "model" -- every field of a split-plane MixedTensor and the ScaledW8
    codes along dim 0, the per-tensor ScaledW8 base whole, a row-sharded
    bias sliced -- so the rank holds its heads and its MLP rows;
  * o/down (and w2, the router): whole on every rank.  The rank's
    attention output (bf16) is all-gathered over "model" and o runs on
    the whole of it; the JAX package keeps silu(gate) * up in f32
    through its gather, so that the down site's quantization decisions
    are the single card's: the port gathers gate and up (bf16, the same
    bytes) and forms the f32 product in the down site's quantize (J's
    silu producer, which takes bf16 inputs), the same values bit for bit;
  * the batch is split over "data"; embedding, norms and the head whole.

Every gather concatenates the ranks' pieces in rank order, which is the
global device-layout order of the rows they came from, so the o and down
sites need no other reordering.  ``tp_validate_config`` is the plan's
check of a configuration (the TP v2 modules use it too).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from ..models.common import (ModelConfig, QuantLinear, apply_rope, attention,
                             causal_mask, lm_logits, rmsnorm, rope_table)
from ..mx.mxtensor import MixedTensor
from ..mx.scaledw8 import ScaledW8
from ..ops.quantize_ops import (reorder_quantize_x, rmsnorm_quantize_x,
                                silu_mul_quantize_x)
from .mesh import RankGroup

Params = Dict[str, Any]
ROW_SHARDED = ("q", "k", "v", "gate", "up", "w1", "w3")
_MX_FIELDS = ("fp4", "fp6", "fp8", "sf4", "sf6", "sf8")


def tp_validate_config(cfg: ModelConfig, tp: int) -> None:
    """ValueError naming the first head count or width ``tp`` does not
    divide (query and KV heads shard whole; the MLP rows shard evenly)."""
    for name in ("num_kv_heads", "num_heads", "intermediate_size"):
        v = getattr(cfg, name)
        if v % tp:
            raise ValueError(f"tp={tp} does not divide {name}={v}")


def _rows(x: torch.Tensor, rank: int, world: int) -> torch.Tensor:
    n = x.shape[0] // world
    return x[rank * n:(rank + 1) * n].contiguous()


def _shard_rows(lin, rank: int, world: int):
    if not isinstance(lin, QuantLinear):
        raise TypeError(f"TP v1 shards quantized linears, not "
                        f"{type(lin).__name__}")
    w = lin.w
    if isinstance(w, ScaledW8):
        w = dataclasses.replace(w, codes=_rows(w.codes, rank, world))
    elif isinstance(w, MixedTensor):
        w = MixedTensor(**{f: _rows(getattr(w, f), rank, world)
                           for f in _MX_FIELDS},
                        fp4_packed=w.fp4_packed, fp4_only=w.fp4_only)
    else:
        raise TypeError(f"no row shard of {type(w).__name__}")
    bias = None if lin.bias is None else _rows(lin.bias, rank, world)
    return QuantLinear(w=w, bias=bias)


def _shard_layer(p: Params, rank: int, world: int) -> Params:
    out = {}
    for k, v in p.items():
        if k in ROW_SHARDED:
            out[k] = _shard_rows(v, rank, world)
        elif k == "experts":
            out[k] = [{ek: (_shard_rows(ev, rank, world) if ek in ROW_SHARDED
                            else ev) for ek, ev in ep.items()} for ep in v]
        else:
            out[k] = v
    return out


def shard_quantized_params(params: Params, rank: int, world: int) -> Params:
    """A quantized (per-consumer) tree -> model rank ``rank``'s of
    ``world``: the row-sharded linears' rows (and biases) sliced, the
    rest whole.  Equal to the JAX package's ``shard_quantized_params``
    device slices."""
    for p in params["layers"]:
        for key in ("qkv_stack", "gateup_stack", "experts_grouped"):
            if key in p:
                raise ValueError(f"TP v1 shards per-consumer layers, not {key}")
    return {**params, "layers": [_shard_layer(p, rank, world)
                                 for p in params["layers"]]}


def _tp_layer(h, p: Params, cfg: ModelConfig, cos, sin, mask,
              model: RankGroup) -> torch.Tensor:
    """One decoder layer on a rank: h (b, s, hidden) whole over "model"."""
    b, s, _ = h.shape
    hd, tp = cfg.head_dim, model.world
    nh_l, nkv_l = cfg.num_heads // tp, cfg.num_kv_heads // tp
    site = p["attn_site"]
    qx = rmsnorm_quantize_x(h, p["ln1"], site.perm, *site.splits,
                            eps=cfg.rms_eps)
    q = apply_rope(p["q"](qx).reshape(b, s, nh_l, hd), cos, sin)
    k = apply_rope(p["k"](qx).reshape(b, s, nkv_l, hd), cos, sin)
    v = p["v"](qx).reshape(b, s, nkv_l, hd)
    out = attention(q, k, v, mask).reshape(b, s, nh_l * hd)
    # the heads gathered, o whole on every rank
    full = model.all_gather(out, dim=2)
    o_site = p["o_site"]
    o = p["o"](reorder_quantize_x(full, o_site.perm, *o_site.splits))
    h = h + o.reshape(b, s, -1)

    msite = p["mlp_site"]
    qm = rmsnorm_quantize_x(h, p["ln2"], msite.perm, *msite.splits,
                            eps=cfg.rms_eps)
    # gate and up gathered, then the f32 silu(gate) * up of the down site
    # (J's silu producer): the product is elementwise, so this is the JAX
    # package's f32 product gathered, bit for bit, and the down site's
    # decisions are the single card's
    gate = model.all_gather(p["gate"](qm), dim=1)
    up = model.all_gather(p["up"](qm), dim=1)
    d = p["down"](silu_mul_quantize_x(gate, up, *p["down_site"].splits))
    return h + d.reshape(b, s, -1)


def sharded_quantized_forward(params: Params, cfg: ModelConfig,
                              tokens: torch.Tensor,
                              groups: Dict[str, RankGroup]) -> torch.Tensor:
    """One rank's full-sequence forward: ``params`` its model shard
    (``shard_quantized_params``), ``tokens`` (B, S) the global batch,
    ``groups`` its "data" and "model" groups -> its data shard's f32
    logits (B / data, S, V).  The caller concatenates the data shards in
    data order."""
    if cfg.is_moe:
        raise ValueError("TP v1 serves dense models; a Mixtral shards its "
                         "experts (parallel.ep_serve)")
    data, model = groups["data"], groups["model"]
    tp_validate_config(cfg, model.world)
    b_all, s = tokens.shape
    if b_all % data.world:
        raise ValueError(f"data={data.world} does not divide batch {b_all}")
    b = b_all // data.world
    tokens = tokens[data.rank * b:(data.rank + 1) * b]
    h = params["embed"][tokens.long()].to(torch.bfloat16)
    cos, sin = rope_table(torch.arange(s, device=tokens.device), cfg)
    mask = causal_mask(s, s, cfg.sliding_window, device=tokens.device)
    for p in params["layers"]:
        h = _tp_layer(h, p, cfg, cos, sin, mask, model)
    return lm_logits(rmsnorm(h, params["final_ln"], cfg.rms_eps),
                     params["lm_head"])


__all__ = ["tp_validate_config", "shard_quantized_params",
           "sharded_quantized_forward", "ROW_SHARDED"]
