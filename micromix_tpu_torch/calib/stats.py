"""Streaming activation statistics over a tapped dense forward.

Counterpart of ``micromix_tpu/calib/stats.py``.  Per site and channel:
the saliency (the max over samples of the per-sample channel mean |x|),
the absmax (running max |x|, the SmoothQuant act scales), and the counts
of elements below the per-row thresholds rowmax * (_C4 * lamda) and
rowmax * (_C6 * lamda), as f32 sums of 0/1 (exact up to 2^24 a call).
The accumulators stay on the params' device during the run; the result
is a tree of numpy arrays, as the JAX package's ``device_get`` gives.
A Mixtral's expert sites see only the rows routed to their expert (the
tap's mask), its ``mlp_in`` (the router's and every expert's input, the
smoothing site) every row.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..models.common import ModelConfig
from ..models.surgery import ATTN_IN, DOWN_IN, MLP_IN, O_IN
from ..models.transformer import forward

SiteStats = Dict[str, torch.Tensor]
StatsTree = Dict[str, SiteStats]

_C4 = 448.0 / 6.0 / 2.0 ** 10
_C6 = 448.0 / 28.0 / 2.0 ** 6


def init_stats(k: int, device=None) -> SiteStats:
    z = torch.zeros((), dtype=torch.float32, device=device)
    return {"saliency": torch.zeros(k, dtype=torch.float32, device=device),
            "absmax": torch.zeros(k, dtype=torch.float32, device=device),
            "below4": z, "below6": z.clone(), "total": z.clone()}


def site_sizes(cfg: ModelConfig) -> Dict[str, int]:
    hid = cfg.hidden_size
    sizes = {ATTN_IN: hid, O_IN: cfg.num_heads * cfg.head_dim}
    if cfg.is_moe:
        for e in range(cfg.num_experts):
            sizes[f"expert{e}_{MLP_IN}"] = hid
            sizes[f"expert{e}_{DOWN_IN}"] = cfg.intermediate_size
        sizes[MLP_IN] = hid  # router + experts fan-in (smoothing site)
    else:
        sizes[MLP_IN] = hid
        sizes[DOWN_IN] = cfg.intermediate_size
    return sizes


def init_stats_tree(cfg: ModelConfig, device=None) -> StatsTree:
    return {f"layer{i}/{name}": init_stats(k, device)
            for i in range(cfg.num_layers)
            for name, k in site_sizes(cfg).items()}


def _update_site(acc: SiteStats, x: torch.Tensor, lamda: float,
                 mask: Optional[torch.Tensor] = None) -> SiteStats:
    ax = x.reshape(-1, x.shape[-1]).to(torch.float32).abs()
    if mask is not None:
        m = mask.reshape(-1, 1).to(torch.float32)
    else:
        m = torch.ones((ax.shape[0], 1), dtype=torch.float32, device=ax.device)
    nrows = torch.clamp(m.sum(), min=1.0)
    mean = (ax * m).sum(dim=0) / nrows
    rowmax = ax.amax(dim=-1, keepdim=True)
    below4 = ((ax < rowmax * (_C4 * lamda)).to(torch.float32) * m).sum()
    below6 = ((ax < rowmax * (_C6 * lamda)).to(torch.float32) * m).sum()
    return {
        "saliency": torch.maximum(acc["saliency"], mean),
        "absmax": torch.maximum(acc["absmax"], (ax * m).amax(dim=0)),
        "below4": acc["below4"] + below4,
        "below6": acc["below6"] + below6,
        "total": acc["total"] + m.sum() * ax.shape[-1],
    }


def calibration_step(params, cfg: ModelConfig, tokens: torch.Tensor,
                     accs: StatsTree, lamda: float = 1.0) -> StatsTree:
    """One tapped forward over ``tokens`` (B, S) and the stats update."""
    new = dict(accs)

    def tap(layer_idx, name, x, mask=None):
        key = f"layer{layer_idx}/{name}"
        new[key] = _update_site(new[key], x, lamda, mask)

    forward(params, cfg, tokens, tap=tap)
    return new


def collect_calibration(params, cfg: ModelConfig,
                        token_batches: List[np.ndarray],
                        lamda: float = 1.0) -> Dict[str, Dict[str, np.ndarray]]:
    """Run every calibration sample on the params' device -> the stats
    tree as numpy arrays."""
    dev = params["embed"].device
    accs = init_stats_tree(cfg, dev)
    with torch.inference_mode():
        for toks in token_batches:
            t = torch.as_tensor(np.asarray(toks), dtype=torch.long).to(dev)
            accs = calibration_step(params, cfg, t, accs, lamda)
    return {key: {name: v.cpu().numpy() for name, v in s.items()}
            for key, s in accs.items()}
