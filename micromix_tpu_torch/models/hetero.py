"""Budgets-as-data (hetero) quantized layers.

Counterpart of ``micromix_tpu/models/hetero.py``.  Every layer's
calibrated (k4, k6, k8) budgets become data, so every layer has the same
shapes whatever its budgets:

  * weights: MXFP4 ScaledW8 codes in CANONICAL (saliency-sorted) column
    order, one (N, K) uint8 array and a base, segments fixed to (K, 0, 0);
  * activation sites: ``FakeQuantSite`` (perm (K,), block_fmt (K / 32,)),
    quantized straight to the exact bf16 grid image by Kernel A's
    block-format route (``kernels.fakequant.fakequant_site_blocks``): one
    launch a site, where the JAX package computes every format under
    ``jnp.where``.

The rms sites normalise the row in its source order and gather after, as
the JAX package does; the port takes 1 / sqrt of the row moment correctly
rounded (the segmented sites' form), where the JAX package's
``jax.lax.rsqrt`` on the CPU differs from it in the last bit for 29% of
inputs, so rms images may part on a round-half-even tie.  The down site
has no perm (the gate / up rows carry the down sort) and takes
silu(gate) * up in f32, unrounded, into the quantizer.

Codes, bases, perms and ``block_fmt`` are bit-identical to the JAX
package's for the same dense weights and calibration.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..kernels.fakequant import fakequant_site_blocks
from ..mx import numerics as nx
from ..mx.formats import BLOCK_SIZE, FP4
from ..mx.scaledw8 import ScaledW8, encode_scaled_values
from .common import FakeQuantSite, ModelConfig, QuantLinear
from .surgery import ATTN_IN, DOWN_IN, MLP_IN, O_IN, LayerCalib, SiteCalibration


def _block_fmt(calib: SiteCalibration, k: int, device=None) -> torch.Tensor:
    k4, k6, _ = calib.splits(k)
    fmt = np.zeros((k // BLOCK_SIZE,), np.int32)
    fmt[k4 // BLOCK_SIZE:(k4 + k6) // BLOCK_SIZE] = 1
    fmt[(k4 + k6) // BLOCK_SIZE:] = 2
    return torch.as_tensor(fmt, device=device)


def fakequant_site(x: torch.Tensor, site: FakeQuantSite) -> torch.Tensor:
    """x (..., K) -> the exact bf16 grid image, canonical column order."""
    x2d = x.reshape(-1, x.shape[-1])
    return fakequant_site_blocks(x2d, site.block_fmt,
                                 perm=site.perm).reshape(x.shape)


def rmsnorm_fakequant(x: torch.Tensor, gamma: torch.Tensor,
                      site: FakeQuantSite, eps: float) -> torch.Tensor:
    """f32 rmsnorm straight into the grid image, no bf16 round between."""
    x2d = x.reshape(-1, x.shape[-1])
    return fakequant_site_blocks(x2d, site.block_fmt, producer="rms",
                                 gamma=gamma, perm=site.perm,
                                 eps=eps).reshape(x.shape)


def make_fakequant_site(calib: SiteCalibration, k: int,
                        device=None) -> FakeQuantSite:
    return FakeQuantSite(
        perm=torch.as_tensor(np.asarray(calib.reorder_index, np.int32),
                             device=device),
        block_fmt=_block_fmt(calib, k, device))


def quantize_linear_hetero(w: torch.Tensor, calib: SiteCalibration, *,
                           bias: Optional[torch.Tensor] = None,
                           row_perm: Optional[np.ndarray] = None) -> QuantLinear:
    """(N, K) dense -> QuantLinear with a canonical-order ScaledW8 weight:
    MXFP4 over consecutive 32-blocks of the saliency-sorted channels (rows
    permuted by ``row_perm`` when given), segments (K, 0, 0)."""
    k = w.shape[1]
    dev = w.device
    idx = torch.as_tensor(np.asarray(calib.reorder_index), dtype=torch.long,
                          device=dev)
    wp = w.to(torch.float32)[:, idx]
    if row_perm is not None:
        rows = torch.as_tensor(np.asarray(row_perm), dtype=torch.long, device=dev)
        wp = wp[rows]
        if bias is not None:
            bias = bias[rows]
    codes, scales = nx.quantize_blocks(wp, FP4)
    c8, base = encode_scaled_values(nx.dequantize_blocks(codes, scales, FP4))
    return QuantLinear(w=ScaledW8(codes=c8, base=base, k4=k, k6=0, k8=0),
                       bias=None if bias is None else bias.to(torch.bfloat16))


def quantize_layer_hetero(p: Dict[str, Any], cfg: ModelConfig,
                          calib: LayerCalib) -> Dict[str, Any]:
    """Dense decoder layer -> the hetero layer."""
    dev = p["ln1"].device
    hid = cfg.hidden_size
    out: Dict[str, Any] = {"ln1": p["ln1"], "ln2": p["ln2"]}
    c_attn = calib[ATTN_IN]
    out["attn_site"] = make_fakequant_site(c_attn, hid, dev)
    for name in ("q", "k", "v"):
        out[name] = quantize_linear_hetero(p[name].w, c_attn, bias=p[name].bias)
    c_o = calib[O_IN]
    out["o_site"] = make_fakequant_site(c_o, cfg.num_heads * cfg.head_dim, dev)
    out["o"] = quantize_linear_hetero(p["o"].w, c_o, bias=p["o"].bias)
    if cfg.is_moe:
        out["router"] = p["router"]
        out["experts"] = [
            quantize_expert_hetero(ep, cfg, calib[f"expert{e}_{MLP_IN}"],
                                   calib[f"expert{e}_{DOWN_IN}"])
            for e, ep in enumerate(p["experts"])]
        return out
    c_mlp, c_dn = calib[MLP_IN], calib[DOWN_IN]
    out["mlp_site"] = make_fakequant_site(c_mlp, hid, dev)
    # gate / up rows carry the down input's sort: the down site gathers
    # nothing
    rp = np.asarray(c_dn.reorder_index, np.int32)
    out["down_site"] = FakeQuantSite(
        perm=None, block_fmt=_block_fmt(c_dn, cfg.intermediate_size, dev))
    for name in ("gate", "up"):
        out[name] = quantize_linear_hetero(p[name].w, c_mlp, bias=p[name].bias,
                                           row_perm=rp)
    out["down"] = quantize_linear_hetero(p["down"].w, c_dn, bias=p["down"].bias)
    return out


def quantize_expert_hetero(ep: Dict[str, Any], cfg: ModelConfig,
                           c_in: SiteCalibration,
                           c_dn: SiteCalibration) -> Dict[str, Any]:
    """One Mixtral expert -> its hetero form (w1 / w3 rows carry the down
    sort, so ``site_down`` has no perm)."""
    dev = ep["w1"].w.device
    rp = np.asarray(c_dn.reorder_index, np.int32)
    return {
        "site_in": make_fakequant_site(c_in, cfg.hidden_size, dev),
        "site_down": FakeQuantSite(
            perm=None, block_fmt=_block_fmt(c_dn, cfg.intermediate_size, dev)),
        "w1": quantize_linear_hetero(ep["w1"].w, c_in, bias=ep["w1"].bias,
                                     row_perm=rp),
        "w3": quantize_linear_hetero(ep["w3"].w, c_in, bias=ep["w3"].bias,
                                     row_perm=rp),
        "w2": quantize_linear_hetero(ep["w2"].w, c_dn, bias=ep["w2"].bias),
    }


def quantize_model_hetero(params: Dict[str, Any], cfg: ModelConfig,
                          calibs: List[LayerCalib]) -> Dict[str, Any]:
    """Dense model dict -> the hetero model dict (embed / norms / head and
    the MoE router stay bf16)."""
    assert len(calibs) == cfg.num_layers
    return {"embed": params["embed"], "final_ln": params["final_ln"],
            "lm_head": params["lm_head"],
            "layers": [quantize_layer_hetero(p, cfg, c)
                       for p, c in zip(params["layers"], calibs)]}


def budgets(params: Dict[str, Any]) -> set:
    """The distinct (k4, k6, k8) budgets of a hetero model's sites, read
    back from their ``block_fmt``."""
    out = set()
    for p in params["layers"]:
        sites = [v for v in p.values() if isinstance(v, FakeQuantSite)]
        for ep in p.get("experts") or ():
            sites += [v for v in ep.values() if isinstance(v, FakeQuantSite)]
        for s in sites:
            n = torch.bincount(s.block_fmt.long().cpu(), minlength=3) * BLOCK_SIZE
            out.add(tuple(int(v) for v in n))
    return out


__all__ = [
    "FakeQuantSite", "fakequant_site", "rmsnorm_fakequant",
    "make_fakequant_site", "quantize_linear_hetero", "quantize_layer_hetero",
    "quantize_expert_hetero", "quantize_model_hetero", "budgets",
]
