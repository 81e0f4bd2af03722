"""Precision allocation: site statistics -> SiteCalibration.

A numpy copy of ``micromix_tpu/calib/allocate.py``: the below-threshold
ratios give the fp6 / fp8 channel counts, rounded UP to multiples of 128,
and the channel order is the ascending saliency sort (outlier channels
last, in the fp8 segment).
"""

from __future__ import annotations

import math
from typing import List

import numpy as np

from ..models.common import ModelConfig
from ..models.surgery import MLP_IN, LayerCalib, SiteCalibration
from .stats import site_sizes


def allocate_site(stats, in_features: int) -> SiteCalibration:
    saliency = np.asarray(stats["saliency"], np.float64)
    order = np.argsort(saliency, kind="stable").astype(np.int32)  # ascending
    total = float(stats["total"])
    if total <= 0:  # no data (e.g. never-routed expert): all-fp8 fallback
        return SiteCalibration(order, 0, in_features)
    p4_ratio = float(stats["below4"]) / total
    p6_ratio = float(stats["below6"]) / total - p4_ratio
    p8_ratio = 1.0 - p4_ratio - p6_ratio
    p6_num = math.ceil(in_features * p6_ratio / 128) * 128
    p8_num = math.ceil(in_features * p8_ratio / 128) * 128
    if p6_num + p8_num > in_features:
        p6_num = in_features - p8_num
    return SiteCalibration(order, p6_num, p8_num)


def average_bits(calibs: List[LayerCalib], cfg: ModelConfig) -> float:
    """Mean bits per activation channel over every site."""
    sizes = site_sizes(cfg)
    bits = 0.0
    n = 0
    for lc in calibs:
        for name, c in lc.items():
            k = sizes[name]
            k4, k6, k8 = c.splits(k)
            bits += 4 * k4 + 6 * k6 + 8 * k8
            n += k
    return bits / n


def stats_to_calibration(stats, cfg: ModelConfig) -> List[LayerCalib]:
    sizes = site_sizes(cfg)
    out: List[LayerCalib] = []
    for i in range(cfg.num_layers):
        lc: LayerCalib = {}
        for name, k in sizes.items():
            if cfg.is_moe and name == MLP_IN:
                continue  # smoothing-only site, not a quantization site
            lc[name] = allocate_site(stats[f"layer{i}/{name}"], k)
        out.append(lc)
    return out
