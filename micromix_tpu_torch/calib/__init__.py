"""Calibration: activation statistics -> per-site precision allocation,
and SmoothQuant-style smoothing (torch counterpart of
``micromix_tpu.calib``; dense models)."""

from .allocate import allocate_site, average_bits, stats_to_calibration
from .artifacts import load_calibration, save_calibration
from .smooth import smooth_params, smooth_quantize_model
from .stats import SiteStats, collect_calibration, init_stats

__all__ = [
    "SiteStats", "init_stats", "collect_calibration",
    "allocate_site", "average_bits", "stats_to_calibration",
    "smooth_params", "smooth_quantize_model",
    "save_calibration", "load_calibration",
]
