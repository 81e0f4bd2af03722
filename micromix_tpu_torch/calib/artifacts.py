"""Calibration artifacts: one ``.npz`` per model.

A numpy copy of ``micromix_tpu/calib/artifacts.py`` with the same keys
(``__num_layers__``, ``idx/<layer>/<site>``, ``p68/<layer>/<site>``,
``absmax/<stat key>``, ``saliency/<stat key>``), so either package loads
the other's file.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np

from ..models.surgery import LayerCalib, SiteCalibration


def save_calibration(path: str, calibs: List[LayerCalib],
                     stats=None) -> None:
    blob: Dict[str, np.ndarray] = {"__num_layers__": np.int64(len(calibs))}
    for i, lc in enumerate(calibs):
        for name, c in lc.items():
            blob[f"idx/{i}/{name}"] = np.asarray(c.reorder_index, np.int32)
            blob[f"p68/{i}/{name}"] = np.asarray([c.p6_num, c.p8_num],
                                                 np.int64)
    if stats is not None:
        for key, s in stats.items():
            blob[f"absmax/{key}"] = np.asarray(s["absmax"], np.float32)
            blob[f"saliency/{key}"] = np.asarray(s["saliency"], np.float32)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, **blob)


def load_calibration(path: str) -> Tuple[List[LayerCalib], Dict]:
    """-> (calibrations, {stat key: absmax})."""
    z = np.load(path)
    n = int(z["__num_layers__"])
    calibs: List[LayerCalib] = [dict() for _ in range(n)]
    absmax = {}
    for key in z.files:
        if key.startswith("idx/"):
            _, i, name = key.split("/", 2)
            p6, p8 = z[f"p68/{i}/{name}"]
            calibs[int(i)][name] = SiteCalibration(z[key], int(p6), int(p8))
        elif key.startswith("absmax/"):
            absmax[key[len("absmax/"):]] = z[key]
    return calibs, absmax
