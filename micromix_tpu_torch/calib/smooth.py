"""SmoothQuant-style smoothing, the pass before quantization.

Counterpart of ``micromix_tpu/calib/smooth.py``.  Per layer and group,

    s = clamp(act_absmax^alpha / colmax(|W|)^(1-alpha), min=1e-5)
    ln.g <- ln.g / s ;  W_fc <- W_fc * s  (columns)

for (ln1, [q, k, v]) and (ln2, [gate, up]), or for a Mixtral (ln2,
[router] + every expert's [w1, w3]), in f32, rounded to bf16.
``smooth_quantize_model`` smooths and quantizes one layer at a time and
drops each dense layer as it goes, so a full-size model is never held
dense twice; it equals ``quantize_model(smooth_params(...))``, or with
``hetero=True`` ``quantize_model_hetero(smooth_params(...))``.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch

from ..models.common import DenseLinear, ModelConfig
from ..models.hetero import quantize_layer_hetero
from ..models.surgery import ATTN_IN, MLP_IN, LayerCalib, quantize_layer


def _smooth_group(gamma: torch.Tensor, fcs: List[DenseLinear], act_absmax,
                  alpha: float):
    act = torch.clamp(torch.as_tensor(act_absmax, dtype=torch.float32)
                      .to(gamma.device), min=1e-5)
    wmax = torch.stack([fc.w.to(torch.float32).abs().amax(dim=0)
                        for fc in fcs]).amax(dim=0)
    wmax = torch.clamp(wmax, min=1e-5)
    s = torch.clamp(act ** alpha / wmax ** (1.0 - alpha), min=1e-5)
    new_gamma = (gamma.to(torch.float32) / s).to(gamma.dtype)
    new_fcs = [DenseLinear(w=(fc.w.to(torch.float32) * s[None, :]).to(fc.w.dtype),
                           bias=fc.bias) for fc in fcs]
    return new_gamma, new_fcs


def smooth_layer(p: Dict[str, Any], i: int, cfg: ModelConfig, stats,
                 alpha: float = 0.5) -> Dict[str, Any]:
    """Dense layer ``i`` -> its smoothed copy."""
    q = dict(p)
    g1, (fq, fk, fv) = _smooth_group(
        p["ln1"], [p["q"], p["k"], p["v"]],
        stats[f"layer{i}/{ATTN_IN}"]["absmax"], alpha)
    q.update(ln1=g1, q=fq, k=fk, v=fv)
    if cfg.is_moe:
        fcs = [p["router"]]
        for ep in p["experts"]:
            fcs.extend([ep["w1"], ep["w3"]])
        g2, new = _smooth_group(p["ln2"], fcs,
                                stats[f"layer{i}/{MLP_IN}"]["absmax"], alpha)
        q.update(ln2=g2, router=new[0])
        q["experts"] = [{**ep, "w1": new[1 + 2 * e], "w3": new[2 + 2 * e]}
                        for e, ep in enumerate(p["experts"])]
        return q
    g2, (fg, fu) = _smooth_group(
        p["ln2"], [p["gate"], p["up"]],
        stats[f"layer{i}/{MLP_IN}"]["absmax"], alpha)
    q.update(ln2=g2, gate=fg, up=fu)
    return q


def smooth_params(params: Dict[str, Any], cfg: ModelConfig, stats,
                  alpha: float = 0.5) -> Dict[str, Any]:
    """Dense params -> smoothed dense params (a new tree)."""
    out = dict(params)
    out["layers"] = [smooth_layer(p, i, cfg, stats, alpha)
                     for i, p in enumerate(params["layers"])]
    return out


def smooth_quantize_model(params: Dict[str, Any], cfg: ModelConfig, stats,
                          calibs: List[LayerCalib], alpha: float = 0.5,
                          hetero: bool = False,
                          **quant_kw) -> Dict[str, Any]:
    """Smooth and quantize layer by layer -> quantized params (the hetero
    form with ``hetero``, else ``quantize_layer`` with ``quant_kw``).
    Consumes ``params["layers"]``: each dense layer is dropped once
    quantized."""
    assert len(calibs) == cfg.num_layers
    if hetero and quant_kw:
        raise ValueError(f"the hetero form takes no {sorted(quant_kw)}")
    dense = params["layers"]
    layers = []
    for i, calib in enumerate(calibs):
        p, dense[i] = dense[i], None
        sp = smooth_layer(p, i, cfg, stats, alpha)
        layers.append(quantize_layer_hetero(sp, cfg, calib) if hetero
                      else quantize_layer(sp, cfg, calib, **quant_kw))
        del p, sp
    return {"embed": params["embed"], "final_ln": params["final_ln"],
            "lm_head": params["lm_head"], "layers": layers}
