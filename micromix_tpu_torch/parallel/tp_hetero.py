"""Tensor parallelism over the hetero (budgets-as-data) form.

Counterpart of ``micromix_tpu/parallel/tp_hetero.py``.  The segmented
plan (``tp_quant.py``) gives every shard the same (k4, k6, k8); in the
hetero form the budgets are data (a format per 32-block), so each o /
down shard keeps its channels' GLOBAL format assignment: shard i's FP6 /
FP8 budget is the count of ITS channels in the global FP6 / FP8 segments,
rounded to the nearest 32 (not k6 / tp rounded down).  The layout is
``tp_quant``'s (column-parallel q/k/v/gate/up, row-parallel o / down with
one f32 sum over the ranks); o / down are ``{"w": ScaledW8, "bias"}``
dicts whose canonical-order codes share one base, encoded over the
concatenation of the shards, and whose sites (``FakeQuantSite``)
concatenate the shards' perms and block formats.

``quantize_model_tp_hetero(..., group=)`` makes one rank's tree from its
shards alone: the shards' exponent range goes round the ranks in one
``all_reduce(MIN)`` and one ``all_reduce(MAX)``, and the codes equal the
global tree's slice.  Sharding (``shard_params_tp_hetero``) and the
forward (``sharded_forward_tp_hetero``) are ``tp_quant``'s, which take
either form.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..models.common import FakeQuantSite, ModelConfig, QuantLinear
from ..models.hetero import _block_fmt, make_fakequant_site
from ..models.surgery import (ATTN_IN, DOWN_IN, MLP_IN, O_IN, LayerCalib,
                              SiteCalibration)
from ..mx import numerics as nx
from ..mx.formats import BLOCK_SIZE, FP4
from ..mx.scaledw8 import ScaledW8, check_base, encode_scaled_values
from .mesh import RankGroup
from .spmd import tp_validate_config
from .tp_quant import (Shards, global_range, shard_params_tp, shard_rows,
                       sharded_forward_tp)

Params = Dict[str, Any]


def _round32_nearest(c: int) -> int:
    return ((c + BLOCK_SIZE // 2) // BLOCK_SIZE) * BLOCK_SIZE


def split_site_calibration_hetero(calib: SiteCalibration, k: int,
                                  tp: int) -> List[SiteCalibration]:
    """Global site calibration -> tp shard-local calibrations with GLOBAL
    budgets: the global order restricted to each shard, and shard i's
    p6 / p8 the count of its channels the global allocation put in FP6 /
    FP8, rounded to the nearest 32."""
    k_l = k // tp
    assert k % tp == 0 and k_l % BLOCK_SIZE == 0, (k, tp)
    k4, k6, _ = calib.splits(k)
    orders: List[List[int]] = [[] for _ in range(tp)]
    c6, c8 = [0] * tp, [0] * tp
    for j, src in enumerate(np.asarray(calib.reorder_index)):
        s = int(src) // k_l
        orders[s].append(int(src) - s * k_l)
        if j >= k4 + k6:
            c8[s] += 1
        elif j >= k4:
            c6[s] += 1
    out = []
    for s in range(tp):
        p8_l = min(_round32_nearest(c8[s]), k_l)
        p6_l = min(_round32_nearest(c6[s]), k_l - p8_l)
        out.append(SiteCalibration(np.asarray(orders[s], np.int32), p6_l, p8_l))
    return out


def _fp4_values(ws: torch.Tensor) -> torch.Tensor:
    """Canonical-order columns -> their exact MXFP4 scaled values."""
    codes, scales = nx.quantize_blocks(ws, FP4)
    return nx.dequantize_blocks(codes, scales, FP4)


def _encode_shards(vals: List[torch.Tensor], shards: Shards, dim: int,
                   k: int) -> ScaledW8:
    """The shards' exact values -> canonical ScaledW8 codes under the base
    of the whole weight (the least exponent over every shard); raises on
    every rank alike when the span overflows."""
    emin, emax = global_range(vals, shards)
    base = emin - 127 if emin <= emax else 0
    check_base(emin, emax, base)
    codes = torch.cat([encode_scaled_values(v, base=base)[0] for v in vals],
                      dim=dim)
    return ScaledW8(codes=codes, base=base, k4=k, k6=0, k8=0)


def column_linear_hetero(w: torch.Tensor, calib: SiteCalibration, bias,
                         shards: Shards, *,
                         row_perm: Optional[np.ndarray] = None) -> QuantLinear:
    """``quantize_linear_hetero`` of the whole (N, K) weight, for the rows
    of ``shards``."""
    k = w.shape[1]
    idx = torch.as_tensor(np.asarray(calib.reorder_index), dtype=torch.long,
                          device=w.device)
    vals = []
    for i in shards.ids:
        rows = torch.as_tensor(shard_rows(w.shape[0], shards.tp, [i], row_perm),
                               dtype=torch.long, device=w.device)
        vals.append(_fp4_values(w[rows].to(torch.float32)[:, idx]))
    b = None
    if bias is not None:
        rows = torch.as_tensor(shard_rows(w.shape[0], shards.tp, shards.ids,
                                          row_perm),
                               dtype=torch.long, device=w.device)
        b = bias[rows].to(torch.bfloat16)
    return QuantLinear(w=_encode_shards(vals, shards, 0, k), bias=b)


def kshard_linear_hetero(w: torch.Tensor, calib: SiteCalibration,
                         shards: Shards, *, bias=None):
    """(N, K) dense -> K-sharded hetero pieces: (ScaledW8 over the shards'
    canonical codes, columns concatenated, one common base; the bf16
    bias; FakeQuantSite of the shards' perms and block formats; every
    shard's local calibration)."""
    n, k = w.shape
    k_l = k // shards.tp
    locals_ = split_site_calibration_hetero(calib, k, shards.tp)
    vals = []
    for i in shards.ids:
        idx = torch.as_tensor(locals_[i].reorder_index, dtype=torch.long,
                              device=w.device)
        vals.append(_fp4_values(w[:, i * k_l:(i + 1) * k_l].to(torch.float32)[:, idx]))
    wq = _encode_shards(vals, shards, 1, k_l)
    perm = np.concatenate([np.asarray(locals_[i].reorder_index, np.int32)
                           for i in shards.ids])
    fmt = torch.cat([_block_fmt(locals_[i], k_l, w.device) for i in shards.ids])
    site = FakeQuantSite(perm=torch.as_tensor(perm, device=w.device),
                         block_fmt=fmt)
    b16 = None if bias is None else bias.to(torch.bfloat16)
    return wq, b16, site, locals_


def quantize_layer_tp_hetero(p: Params, cfg: ModelConfig, calib: LayerCalib,
                             tp: int, *,
                             group: Optional[RankGroup] = None) -> Params:
    """Dense decoder layer -> the hetero TP layer (non-MoE): all shards,
    or with ``group`` the rank's own."""
    shards = Shards(tp, group)
    dev = p["ln1"].device
    hid, inter = cfg.hidden_size, cfg.intermediate_size
    out: Params = {"ln1": p["ln1"], "ln2": p["ln2"]}
    c_attn = calib[ATTN_IN]
    out["attn_site"] = make_fakequant_site(c_attn, hid, dev)
    for name in ("q", "k", "v"):
        out[name] = column_linear_hetero(p[name].w, c_attn, p[name].bias, shards)
    wq, b, site, _ = kshard_linear_hetero(p["o"].w, calib[O_IN], shards,
                                          bias=p["o"].bias)
    out["o"], out["o_site"] = {"w": wq, "bias": b}, site
    c_mlp = calib[MLP_IN]
    out["mlp_site"] = make_fakequant_site(c_mlp, hid, dev)
    wq, b, dsite, dn_locals = kshard_linear_hetero(p["down"].w, calib[DOWN_IN],
                                                   shards, bias=p["down"].bias)
    out["down"] = {"w": wq, "bias": b}
    # gate / up ROWS carry each shard's canonical sort: the down site
    # gathers nothing
    out["down_site"] = FakeQuantSite(perm=None, block_fmt=dsite.block_fmt)
    k_l = inter // tp
    row_perm = np.concatenate([i * k_l + np.asarray(dn_locals[i].reorder_index,
                                                    np.int32)
                               for i in range(tp)])
    for name in ("gate", "up"):
        out[name] = column_linear_hetero(p[name].w, c_mlp, p[name].bias, shards,
                                         row_perm=row_perm)
    return out


def quantize_model_tp_hetero(params: Params, cfg: ModelConfig,
                             calibs: List[LayerCalib], tp: int, *,
                             group: Optional[RankGroup] = None) -> Params:
    """Dense model -> the hetero TP tree (global, or with ``group`` the
    rank's own)."""
    if cfg.is_moe:
        raise ValueError("a MoE model shards its experts (parallel.ep_serve)")
    assert len(calibs) == cfg.num_layers
    tp_validate_config(cfg, tp)
    return {"embed": params["embed"], "final_ln": params["final_ln"],
            "lm_head": params["lm_head"],
            "layers": [quantize_layer_tp_hetero(p, cfg, c, tp, group=group)
                       for p, c in zip(params["layers"], calibs)]}


shard_params_tp_hetero = shard_params_tp
sharded_forward_tp_hetero = sharded_forward_tp


__all__ = ["split_site_calibration_hetero", "quantize_model_tp_hetero",
           "quantize_layer_tp_hetero", "shard_params_tp_hetero",
           "sharded_forward_tp_hetero"]
