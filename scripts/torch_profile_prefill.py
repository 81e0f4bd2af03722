#!/usr/bin/env python3
"""Where the prefill of one long prompt spends its time, on one GPU.

Builds the model of ``chip_smoke.py`` phase 4 (Llama-3.1-8B, ScaledW8;
``--layout splitplane``: phase 6's; ``--model mixtral``: phase 5's
Mixtral-8x7B, dense dispatch, experts grouped layer by layer as they are
made), 32 layers, random weights from seed 0, stacked as the default
engine stacks them, and prefills one
``--prompt``-token prompt (2048: the serving line's time-to-first-token
prompt) in chunks of ``--chunk`` (512: the engine's ``prefill_chunk``):
the first chunk attends with Kernel E, each later one with Kernel H over
the paged int4 history.  After one warm-up prefill it takes the host wall
of ``--reps`` prefills (each ending in a synchronise; the median is
reported) and profiles one with ``torch.profiler``: device busy (the sum
of kernel times on the one stream), the device's idle share, kernel
launches, and the kernels that take the most device time.  Prints one
JSON object and writes it to
``chiprun_out/profile_prefill[_splitplane|_mixtral].json``.

Run from the repository root on the GPU machine:

    python3 scripts/torch_profile_prefill.py [--model llama|mixtral] \
        [--layout auto|splitplane] [--prompt 2048] [--chunk 512] \
        [--layers 32] [--reps 5]
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import statistics
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import SEED, llama31_8b, mixtral_8x7b  # noqa: E402
from micromix_tpu_torch.models.surgery import (  # noqa: E402
    default_calibration, random_quantized_model, stack_layer_projections)
from micromix_tpu_torch.serve.kv_cache import make_cache  # noqa: E402
from micromix_tpu_torch.serve.runner import prefill  # noqa: E402


def prefill_prompt(params, cfg, tokens, chunk: int):
    """The whole prompt in chunks, into fresh caches; returns the logits."""
    ps = 128
    mp = -(-tokens.shape[1] // ps)
    caches = [make_cache(mp + 1, ps, cfg.num_kv_heads, cfg.head_dim, 1, mp,
                         device="cuda") for _ in range(cfg.num_layers)]
    for c in caches:
        c.page_table[0] = torch.arange(1, mp + 1, dtype=torch.int32)
    logits = None
    for start in range(0, tokens.shape[1], chunk):
        logits, caches = prefill(params, cfg, caches, tokens[:, start:start + chunk],
                                 0, start, hist_len=start)
    return logits


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="llama", choices=["llama", "mixtral"])
    ap.add_argument("--layout", default="auto", choices=["auto", "splitplane"])
    ap.add_argument("--prompt", type=int, default=2048)
    ap.add_argument("--chunk", type=int, default=512)
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cfg = (mixtral_8x7b if args.model == "mixtral" else llama31_8b)(args.layers)
    params = stack_layer_projections(random_quantized_model(
        cfg, default_calibration(cfg, p6=256, p8=256, seed=SEED), seed=SEED,
        device="cuda", layout=args.layout))
    rng = np.random.default_rng(SEED)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, args.prompt))).to("cuda")
    prefill_prompt(params, cfg, tokens, args.chunk)        # warm-up
    torch.cuda.synchronize()
    walls = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        prefill_prompt(params, cfg, tokens, args.chunk)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prefill_prompt(params, cfg, tokens, args.chunk)
        torch.cuda.synchronize()
        wall_prof = time.perf_counter() - t0
    per_kernel = collections.Counter()
    launches = collections.Counter()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            per_kernel[e.name] += e.device_time_total
            launches[e.name] += 1
    busy_ms = sum(per_kernel.values()) / 1e3
    out = dict(device=torch.cuda.get_device_name(0), model=args.model,
               layout=args.layout,
               layers=cfg.num_layers, prompt=args.prompt, chunk=args.chunk,
               host_wall_ms=1e3 * statistics.median(walls),
               host_wall_ms_all=[1e3 * w for w in walls],
               host_wall_ms_profiled=1e3 * wall_prof,
               device_busy_ms=busy_ms,
               device_idle_share=1.0 - busy_ms / (1e3 * wall_prof),
               kernel_launches=sum(launches.values()),
               top_kernels=[dict(kernel=name[:80], ms=us / 1e3, launches=launches[name])
                            for name, us in per_kernel.most_common(14)])
    os.makedirs("chiprun_out", exist_ok=True)
    suffix = ("_splitplane" if args.layout == "splitplane" else "") + (
        "_mixtral" if args.model == "mixtral" else "")
    with open(os.path.join("chiprun_out", f"profile_prefill{suffix}.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
