"""Time the port's weight quantizers on Llama-3.1-8B's weight shapes.

For q (4096 x 4096), gate (14336 x 4096) and down (4096 x 14336), each
with the all-MXFP4 weight grid (ScaledW8) and with MXFP4/6/8 segments
(split-plane), it times ``surgery.quantize_linear`` on a weight held in
host memory through the torch quantizer and through the native host
quantizer (``host=True``, ``utils/native.py``), and, where a card is
present, the torch quantizer on the card (with a synchronize).  Codes,
scales and base must be equal on every route.  Each time is the median
of ``--repeats`` calls after one warm-up call.

    python3 scripts/torch_host_quantize.py [--repeats 3] [--out FILE]

The last line of its output is one JSON object: the threads, the card
(or null) and, per weight and grid, each route's seconds and weights per
second.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

SHAPES = {"q": (4096, 4096), "gate": (14336, 4096), "down": (4096, 14336)}
FIELDS = ("codes", "fp4", "fp6", "fp8", "sf4", "sf6", "sf8")


def _same(a, b) -> bool:
    if type(a) is not type(b) or getattr(a, "base", None) != getattr(b, "base", None):
        return False
    return all(torch.equal(getattr(a, f).cpu(), getattr(b, f).cpu())
               for f in FIELDS if hasattr(a, f))


def _timed(fn, repeats: int, sync=lambda: None):
    out = fn()
    sync()
    secs = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = fn()
        sync()
        secs.append(time.perf_counter() - t0)
    return statistics.median(secs), out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    from micromix_tpu_torch.models.surgery import SiteCalibration, quantize_linear
    card = torch.cuda.is_available()
    gen = torch.Generator().manual_seed(0)
    rows = {}
    for name, (n, k) in SHAPES.items():
        w = (torch.randn(n, k, generator=gen) * 0.02).to(torch.bfloat16)
        cal = SiteCalibration(np.random.default_rng(0).permutation(k).astype(np.int32),
                              256, 256)
        for fp4_only in (True, False):
            grid = "mxfp4 (ScaledW8)" if fp4_only else "mxfp4/6/8 (split-plane)"
            row = {}
            t, ref = _timed(lambda: quantize_linear(w, cal, weight_fp4_only=fp4_only),
                            args.repeats)
            row["torch_cpu_s"] = t
            t, got = _timed(lambda: quantize_linear(w, cal, weight_fp4_only=fp4_only,
                                                    host=True), args.repeats)
            row["native_host_s"] = t
            if not _same(ref.w, got.w):
                print(f"{name} {grid}: host codes differ from torch's", flush=True)
                return 1
            if card:
                wc = w.cuda()
                t, got = _timed(lambda: quantize_linear(wc, cal, weight_fp4_only=fp4_only),
                                args.repeats, torch.cuda.synchronize)
                row["torch_card_s"] = t
                if not _same(ref.w, got.w):
                    print(f"{name} {grid}: card codes differ from the CPU's", flush=True)
                    return 1
            for key in list(row):
                row[key.replace("_s", "_mweights_per_s")] = n * k / row[key] / 1e6
            rows[f"{name} {grid}"] = row
            print(f"{name} ({n} x {k}) {grid}: " + ", ".join(
                f"{key} {v:.4f}" for key, v in row.items() if key.endswith("_s")),
                flush=True)
    result = {"torch_threads": torch.get_num_threads(), "cpus": os.cpu_count(),
              "card": torch.cuda.get_device_name(0) if card else None,
              "rows": rows}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
