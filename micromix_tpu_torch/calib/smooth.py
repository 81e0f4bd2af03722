"""SmoothQuant-style smoothing, the pass before quantization.

Counterpart of ``micromix_tpu/calib/smooth.py``.  Per layer and group,

    s = clamp(act_absmax^alpha / colmax(|W|)^(1-alpha), min=1e-5)
    ln.g <- ln.g / s ;  W_fc <- W_fc * s  (columns)

for (ln1, [q, k, v]) and (ln2, [gate, up]), in f32, rounded to bf16.
``smooth_quantize_model`` smooths and quantizes one layer at a time and
drops each dense layer as it goes, so a full-size model is never held
dense twice; it equals ``quantize_model(smooth_params(...))``.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch

from ..models.common import DenseLinear, ModelConfig
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
    """Dense layer ``i`` -> its smoothed copy (dense Llama)."""
    if cfg.is_moe:
        raise NotImplementedError(
            "smoothing a MoE layer needs the MoE calibration taps, which are "
            "not ported (ROADMAP 1.8)")
    q = dict(p)
    g1, (fq, fk, fv) = _smooth_group(
        p["ln1"], [p["q"], p["k"], p["v"]],
        stats[f"layer{i}/{ATTN_IN}"]["absmax"], alpha)
    q.update(ln1=g1, q=fq, k=fk, v=fv)
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
                          **quant_kw) -> Dict[str, Any]:
    """Smooth and quantize layer by layer -> quantized params.  Consumes
    ``params["layers"]``: each dense layer is dropped once quantized."""
    assert len(calibs) == cfg.num_layers
    dense = params["layers"]
    layers = []
    for i, calib in enumerate(calibs):
        p, dense[i] = dense[i], None
        layers.append(quantize_layer(smooth_layer(p, i, cfg, stats, alpha),
                                     cfg, calib, **quant_kw))
        del p
    return {"embed": params["embed"], "final_ln": params["final_ln"],
            "lm_head": params["lm_head"], "layers": layers}
