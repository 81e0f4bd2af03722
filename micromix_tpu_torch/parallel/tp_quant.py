"""Tensor parallelism v2: K-sharded o / down with an f32 sum over the ranks,
shard-local quantization.

Counterpart of ``micromix_tpu/parallel/tp_quant.py`` (the Megatron
row-parallel plan).  q/k/v/gate/up keep the single-card quantization and
shard their output rows; o and down shard their contraction axis, each
rank quantizes and multiplies only its slice of the activation, and one
f32 ``all_reduce`` per projection takes the place of a gather.  MX scale
blocks (32 channels) and the calibration's channel order must not cross a
shard, so the o / down quantization is shard-local:

  * shard i owns its natural K slice (o: its heads' output channels;
    down: its gate / up rows);
  * the global saliency order restricted to a shard is that shard's local
    order;
  * FP6 / FP8 budgets split evenly over the shards, rounded down to 32,
    so every shard has the same (k4, k6, k8);
  * a ScaledW8 o / down has one base common to all shards (each shard's
    codes decode with the replicated base), or, when that base would
    overflow a shard's 6-bit exponent field, every shard stays
    split-plane;
  * the per-shard down input order is baked into the gate / up ROWS, so
    the down site gathers nothing; the o site's perm is the shard's slice.

``quantize_model_tp`` makes the global tree the JAX package makes (every
shard's arrays concatenated), which ``shard_params_tp(params, rank,
world)`` slices into one rank's tree.  With ``group`` (a
``mesh.RankGroup``) it makes the rank's own tree instead, quantizing only
the rank's shard of every weight: the ranks agree a weight's common base
with one ``all_reduce(MIN)`` and the split-plane fallback with one
``all_reduce(MAX)``, and the bits equal the global tree's slice.

``sharded_forward_tp`` is one rank's full-sequence forward over its tree:
local heads, the row-parallel partials kept in f32 through the sum, the
bias added once after it, one round to bf16.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..kernels.fakequant import fakequant_site_blocks
from ..kernels.flash_attention import flash_attention
from ..kernels.mixed_matmul import mixed_matmul
from ..models.common import (FakeQuantSite, ModelConfig, QuantLinear,
                             QuantSite, apply_rope, lm_logits, project_all,
                             rmsnorm, rope_table)
from ..models.hetero import fakequant_site
from ..models.surgery import (ATTN_IN, DOWN_IN, MLP_IN, O_IN, LayerCalib,
                              SiteCalibration, make_site)
from ..mx import layout as lay
from ..mx.mxtensor import (MixedTensor, dequantize_mixed_device, pack_mixed,
                           quantize_mixed)
from ..mx.scaledw8 import ScaledW8, check_base, exponent_range, pack_scaled_w8
from ..ops.quantize_ops import reorder_quantize_x, silu_mul_quantize_x
from .mesh import RankGroup
from .spmd import tp_validate_config

Params = Dict[str, Any]
_MX_FIELDS = ("fp4", "fp6", "fp8", "sf4", "sf6", "sf8")
COLUMN = ("q", "k", "v", "gate", "up")      # output rows shard
ROW = ("o", "down")                          # contraction columns shard
_BIG = 1 << 20


def _round32(x: int) -> int:
    return (x // 32) * 32


def split_site_calibration(calib: SiteCalibration, k: int,
                           tp: int) -> List[SiteCalibration]:
    """Global site calibration -> tp shard-local calibrations.

    Channel c lives on shard c // (k/tp); the global ascending-saliency
    order restricted to a shard keeps its relative order; budgets are
    per shard, rounded down to the 32-channel MX block."""
    k_l = k // tp
    assert k % tp == 0 and k_l % 32 == 0, (k, tp)
    p6_l = _round32(calib.p6_num // tp)
    p8_l = _round32(calib.p8_num // tp)
    orders: List[List[int]] = [[] for _ in range(tp)]
    for src in np.asarray(calib.reorder_index):
        s = int(src) // k_l
        orders[s].append(int(src) - s * k_l)
    return [SiteCalibration(np.asarray(o, np.int32), p6_l, p8_l)
            for o in orders]


class Shards:
    """The shards one process quantizes: all ``tp`` of them (``group``
    None: the global tree), or its rank's alone (the rank's tree), with
    the reductions over the shards done in Python or by ``all_reduce``."""

    def __init__(self, tp: int, group: Optional[RankGroup] = None):
        if group is not None and group.world != tp:
            raise ValueError(f"group of {group.world} ranks for tp={tp}")
        self.tp, self.group = tp, group

    @property
    def ids(self) -> List[int]:
        return list(range(self.tp)) if self.group is None else [self.group.rank]

    def reduce(self, vals: Sequence[Sequence[int]], op: str) -> List[int]:
        """Elementwise min or max over the shards of ``vals``: one list of
        ints for each shard in ``ids``."""
        if self.group is None:
            fn = min if op == "min" else max
            return [fn(col) for col in zip(*vals)]
        t = torch.tensor(vals[0], dtype=torch.int64, device=self.group.device)
        self.group.all_reduce(t, dist.ReduceOp.MIN if op == "min"
                              else dist.ReduceOp.MAX)
        return [int(x) for x in t.tolist()]


def concat_mixed(ts: List[MixedTensor], dim: int) -> MixedTensor:
    """MixedTensors joined along rows (``dim`` 0) or, field by field, along
    their columns (``dim`` 1: K shards)."""
    if len(ts) == 1:
        return ts[0]
    return MixedTensor(**{f: torch.cat([getattr(t, f) for t in ts], dim=dim)
                          for f in _MX_FIELDS},
                       fp4_packed=ts[0].fp4_packed, fp4_only=ts[0].fp4_only)


def _concat_shard_weights(mixed: List[MixedTensor], shards: Shards):
    """The K shards' MixedTensors -> one weight, columns concatenated.

    The ScaledW8 layout with a base common to all shards (each shard's
    codes decode with the replicated base): the least of the shards' own
    bases; every shard stays split-plane when a shard's own pack or the
    common base overflows its 6-bit field.  The segment statics are the
    LOCAL (k4, k6, k8), which is what a rank's activation checks."""
    if mixed[0].fp4_only:
        fails, bases = [], []
        for t in mixed:
            try:
                bases.append([pack_scaled_w8(t).base])
                fails.append(0)
            except ValueError:
                bases.append([_BIG])
                fails.append(1)
        (base,) = shards.reduce(bases, "min")
        per = []
        for i, t in enumerate(mixed):
            if not fails[i]:
                try:
                    per.append(pack_scaled_w8(t, base=base))
                except ValueError:
                    fails[i] = 1
        (failed,) = shards.reduce([[f] for f in fails], "max")
        if not failed:
            k4, k6, k8 = mixed[0].segments()
            return ScaledW8(codes=torch.cat([p.codes for p in per], dim=1),
                            base=base, k4=k4, k6=k6, k8=k8)
    return concat_mixed(mixed, 1)


def global_range(vals: List[torch.Tensor], shards: Shards):
    """(least, largest) biased exponent of the non-zero values of the
    shards' pieces of one weight: one ``all_reduce(MIN)`` and one
    ``all_reduce(MAX)`` over ranks."""
    rngs = [exponent_range(v) for v in vals]
    (emin,) = shards.reduce([[r[0]] for r in rngs], "min")
    (emax,) = shards.reduce([[r[1]] for r in rngs], "max")
    return emin, emax


def _column_weight(wq: List[MixedTensor], shards: Shards):
    """The row shards of one column-parallel weight (unpacked
    MixedTensors) -> its layout, as the single-card "auto" layout of the
    whole weight: ScaledW8 under the whole weight's base unless its
    exponent span overflows, else split-plane."""
    if wq[0].fp4_only:
        emin, emax = global_range(
            [dequantize_mixed_device(t, torch.float32) for t in wq], shards)
        base = emin - 127 if emin <= emax else 0
        try:
            check_base(emin, emax, base)
        except ValueError:
            pass
        else:
            return _cat_w8([pack_scaled_w8(t, base=base) for t in wq])
    return concat_mixed([pack_mixed(t) for t in wq], 0)


def _cat_w8(ws: List[ScaledW8]) -> ScaledW8:
    return ScaledW8(codes=torch.cat([w.codes for w in ws]), base=ws[0].base,
                    k4=ws[0].k4, k6=ws[0].k6, k8=ws[0].k8)


def shard_rows(n: int, tp: int, ids: Sequence[int],
               row_perm: Optional[np.ndarray] = None) -> np.ndarray:
    """The weight rows of shards ``ids`` (of ``tp``), after ``row_perm``."""
    n_l = n // tp
    rows = np.concatenate([np.arange(i * n_l, (i + 1) * n_l) for i in ids])
    return rows if row_perm is None else np.asarray(row_perm)[rows]


def column_linear(w: torch.Tensor, calib: SiteCalibration, bias, shards: Shards,
                  *, row_perm: Optional[np.ndarray] = None,
                  weight_fp4_only: bool = True) -> QuantLinear:
    """A column-parallel (N, K) dense weight -> the rows of ``shards``,
    quantized as the single-card ``quantize_linear`` quantizes the whole
    weight (rows permuted by ``row_perm``)."""
    k4, k6, k8 = calib.splits(w.shape[1])
    idx = torch.as_tensor(np.asarray(calib.reorder_index), dtype=torch.long,
                          device=w.device)
    wq = []
    for i in shards.ids:
        rows = torch.as_tensor(shard_rows(w.shape[0], shards.tp, [i], row_perm),
                               dtype=torch.long, device=w.device)
        wq.append(quantize_mixed(w[rows].to(torch.float32)[:, idx], k4, k6, k8,
                                 weight_fp4_only=weight_fp4_only))
    b = None
    if bias is not None:
        rows = torch.as_tensor(shard_rows(w.shape[0], shards.tp, shards.ids,
                                          row_perm),
                               dtype=torch.long, device=w.device)
        b = bias[rows].to(torch.bfloat16)
    return QuantLinear(w=_column_weight(wq, shards), bias=b)


def kshard_linear(w: torch.Tensor, calib: SiteCalibration, shards: Shards, *,
                  bias=None, weight_fp4_only: bool = True):
    """Quantize an (N, K) weight shard-locally -> (QuantLinear over the
    shards' columns, concatenated, QuantSite with their concatenated local
    perms, every shard's local calibration)."""
    n, k = w.shape
    tp = shards.tp
    k_l = k // tp
    locals_ = split_site_calibration(calib, k, tp)
    k4_l, k6_l, k8_l = locals_[0].splits(k_l)
    mixed = []
    for i in shards.ids:
        idx = torch.as_tensor(locals_[i].reorder_index, dtype=torch.long,
                              device=w.device)
        ws = w[:, i * k_l:(i + 1) * k_l].to(torch.float32)[:, idx]
        mixed.append(quantize_mixed(ws, k4_l, k6_l, k8_l,
                                    weight_fp4_only=weight_fp4_only,
                                    pack_fp4=True))
    wq = _concat_shard_weights(mixed, shards)
    perms = np.concatenate([
        lay.compose_segmented(locals_[i].reorder_index, k4_l, k6_l, k8_l)
        for i in shards.ids]).astype(np.int32)
    site = QuantSite(k4=k4_l, k6=k6_l, k8=k8_l,
                     perm=torch.as_tensor(perms, device=w.device))
    return (QuantLinear(w=wq, bias=None if bias is None
                        else bias.to(torch.bfloat16)), site, locals_)


def quantize_layer_tp(p: Params, cfg: ModelConfig, calib: LayerCalib, tp: int,
                      *, weight_fp4_only: bool = True,
                      group: Optional[RankGroup] = None) -> Params:
    """Dense decoder layer -> the TP v2 quantized layer (non-MoE): all
    shards, or with ``group`` the rank's own."""
    shards = Shards(tp, group)
    dev = p["ln1"].device
    hid, inter = cfg.hidden_size, cfg.intermediate_size
    out: Params = {"ln1": p["ln1"], "ln2": p["ln2"]}
    c_attn = calib[ATTN_IN]
    out["attn_site"] = make_site(c_attn, hid, dev)
    for name in ("q", "k", "v"):
        out[name] = column_linear(p[name].w, c_attn, p[name].bias, shards,
                                  weight_fp4_only=weight_fp4_only)
    out["o"], out["o_site"], _ = kshard_linear(
        p["o"].w, calib[O_IN], shards, bias=p["o"].bias,
        weight_fp4_only=weight_fp4_only)
    c_mlp = calib[MLP_IN]
    out["mlp_site"] = make_site(c_mlp, hid, dev)
    out["down"], _, dn_locals = kshard_linear(
        p["down"].w, calib[DOWN_IN], shards, bias=p["down"].bias,
        weight_fp4_only=weight_fp4_only)
    k_l = inter // tp
    k4_l, k6_l, k8_l = dn_locals[0].splits(k_l)
    out["down_site"] = QuantSite(k4=k4_l, k6=k6_l, k8=k8_l)
    # the per-shard down input order, baked into the gate / up ROWS
    row_perm = np.concatenate([
        i * k_l + lay.compose_segmented(dn_locals[i].reorder_index,
                                        k4_l, k6_l, k8_l)
        for i in range(tp)]).astype(np.int32)
    for name in ("gate", "up"):
        out[name] = column_linear(p[name].w, c_mlp, p[name].bias, shards,
                                  row_perm=row_perm,
                                  weight_fp4_only=weight_fp4_only)
    return out


def quantize_model_tp(params: Params, cfg: ModelConfig,
                      calibs: List[LayerCalib], tp: int, *,
                      weight_fp4_only: bool = True,
                      group: Optional[RankGroup] = None) -> Params:
    """Dense model -> the TP v2 tree: the global one (every shard's arrays
    concatenated, as the JAX package's), or with ``group`` the rank's own,
    quantized from its shards alone (equal to the global tree's slice)."""
    if cfg.is_moe:
        raise ValueError("a MoE model shards its experts (parallel.ep_serve)")
    assert len(calibs) == cfg.num_layers
    tp_validate_config(cfg, tp)
    return {"embed": params["embed"], "final_ln": params["final_ln"],
            "lm_head": params["lm_head"],
            "layers": [quantize_layer_tp(p, cfg, c, tp,
                                         weight_fp4_only=weight_fp4_only,
                                         group=group)
                       for p, c in zip(params["layers"], calibs)]}


# ----------------------------------------------------------- sharding


def _rows(x: torch.Tensor, rank: int, world: int, dim: int) -> torch.Tensor:
    n = x.shape[dim] // world
    return x.narrow(dim, rank * n, n)


def _shard_weight(w, rank: int, world: int, dim: int):
    """A ScaledW8 or MixedTensor's shard on ``dim`` (0: rows, 1: the
    concatenated K shards, field by field)."""
    if isinstance(w, ScaledW8):
        return ScaledW8(codes=_rows(w.codes, rank, world, dim).contiguous(),
                        base=w.base, k4=w.k4, k6=w.k6, k8=w.k8)
    return MixedTensor(**{f: _rows(getattr(w, f), rank, world, dim).contiguous()
                          for f in _MX_FIELDS},
                       fp4_packed=w.fp4_packed, fp4_only=w.fp4_only)


def _shard_linear(lin, rank: int, world: int, dim: int):
    """QuantLinear (column- or row-parallel) or a hetero ``{"w", "bias"}``
    row-parallel dict -> the rank's; a column bias shards with its rows, a
    row-parallel bias is replicated."""
    if isinstance(lin, dict):
        return {"w": _shard_weight(lin["w"], rank, world, dim),
                "bias": lin["bias"]}
    bias = lin.bias
    if bias is not None and dim == 0:
        bias = _rows(bias, rank, world, 0).contiguous()
    return QuantLinear(w=_shard_weight(lin.w, rank, world, dim), bias=bias)


def _shard_site(site, rank: int, world: int):
    """A row-parallel site: its perm (and hetero ``block_fmt``) sliced."""
    perm = None if site.perm is None else _rows(site.perm, rank, world, 0).contiguous()
    if isinstance(site, FakeQuantSite):
        return FakeQuantSite(perm=perm, block_fmt=_rows(
            site.block_fmt, rank, world, 0).contiguous())
    return QuantSite(k4=site.k4, k6=site.k6, k8=site.k8, perm=perm)


def shard_layer_tp(p: Params, rank: int, world: int) -> Params:
    out = {}
    for k, v in p.items():
        if k in COLUMN:
            out[k] = _shard_linear(v, rank, world, 0)
        elif k in ROW:
            out[k] = _shard_linear(v, rank, world, 1)
        elif k in ("o_site", "down_site") and (
                isinstance(v, FakeQuantSite) or k == "o_site"):
            out[k] = _shard_site(v, rank, world)
        else:
            out[k] = v
    return out


def shard_params_tp(params: Params, rank: int, world: int) -> Params:
    """A global TP tree (segmented or hetero) -> rank ``rank``'s tree:
    q/k/v/gate/up rows and their biases, o/down columns (biases
    replicated), the o site's perm (and the hetero sites' block formats);
    embedding, norms, head and the column-parallel sites replicated."""
    return {**{k: v for k, v in params.items() if k != "layers"},
            "layers": [shard_layer_tp(p, rank, world) for p in params["layers"]]}


# ------------------------------------------------------------ forward


def row_parallel(x2d: torch.Tensor, site, lin, group: RankGroup,
                 up: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The shard-local quantize, the local product as f32 partials, their
    sum over the ranks, the bias once, one round to bf16.

    ``x2d`` (M, K_l), or with ``up`` the gate of silu(gate) * up (the
    down site).  Segmented: the MX quantize (Kernel J; split-plane
    weights take the codes, ScaledW8 ones their decoded image); hetero
    (``FakeQuantSite``, ``{"w", "bias"}``): Kernel A's block-format
    route to the bf16 image."""
    w, bias = ((lin["w"], lin["bias"]) if isinstance(lin, dict)
               else (lin.w, lin.bias))
    if isinstance(site, FakeQuantSite):
        if up is not None:
            qx = fakequant_site_blocks(x2d, site.block_fmt, producer="silu",
                                       up=up)
        else:
            qx = fakequant_site(x2d, site)
    elif up is not None:
        qx = silu_mul_quantize_x(x2d, up, *site.splits)
    else:
        qx = reorder_quantize_x(x2d, site.perm, *site.splits)
    y = group.all_reduce(mixed_matmul(qx, w, out_dtype=torch.float32))
    if bias is not None:
        y = y + bias.to(torch.float32)
    return y.to(torch.bfloat16)


def tp_layer(h: torch.Tensor, p: Params, cfg_l: ModelConfig, group: RankGroup,
             attn_fn) -> torch.Tensor:
    """One decoder layer on a rank: local heads (``cfg_l``'s head counts);
    ``attn_fn(q, k, v)`` -> (B, S, Hl * D)."""
    b, s, _ = h.shape
    hd = cfg_l.head_dim
    q, k, v = project_all(h, p["attn_site"], [p["q"], p["k"], p["v"]],
                          p["ln1"], cfg_l.rms_eps)
    out = attn_fn(q.reshape(b, s, cfg_l.num_heads, hd),
                  k.reshape(b, s, cfg_l.num_kv_heads, hd),
                  v.reshape(b, s, cfg_l.num_kv_heads, hd))
    h = h + row_parallel(out.reshape(b * s, -1), p["o_site"], p["o"],
                         group).reshape(b, s, -1)
    gate, up = project_all(h, p["mlp_site"], [p["gate"], p["up"]], p["ln2"],
                           cfg_l.rms_eps)
    d = row_parallel(gate.reshape(b * s, -1), p["down_site"], p["down"], group,
                     up=up.reshape(b * s, -1))
    return h + d.reshape(b, s, -1)


def local_config(cfg: ModelConfig, tp: int) -> ModelConfig:
    """The rank's view of the model: its share of the heads."""
    tp_validate_config(cfg, tp)
    return dataclasses.replace(cfg, num_heads=cfg.num_heads // tp,
                               num_kv_heads=cfg.num_kv_heads // tp)


def sharded_forward_tp(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                       group: RankGroup) -> torch.Tensor:
    """One rank's causal forward over its tree (``shard_params_tp`` or
    ``quantize_model_tp(group=)``): tokens (B, S) -> replicated f32 logits
    (B, S, V)."""
    cfg_l = local_config(cfg, group.world)
    b, s = tokens.shape
    h = params["embed"][tokens.long()].to(torch.bfloat16)
    cos, sin = rope_table(torch.arange(s, device=tokens.device), cfg_l)

    def attn(q, k, v):
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        return flash_attention(q, k, v, sliding_window=cfg_l.sliding_window
                               ).reshape(b, s, -1)

    for p in params["layers"]:
        h = tp_layer(h, p, cfg_l, group, attn)
    return lm_logits(rmsnorm(h, params["final_ln"], cfg.rms_eps),
                     params["lm_head"])


__all__ = ["split_site_calibration", "quantize_model_tp", "quantize_layer_tp",
           "shard_params_tp", "sharded_forward_tp", "row_parallel", "tp_layer",
           "local_config", "Shards", "column_linear", "kshard_linear",
           "concat_mixed", "global_range", "shard_rows"]
