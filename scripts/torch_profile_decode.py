#!/usr/bin/env python3
"""Where a decode step of the PyTorch/CUDA port spends its time, on one GPU.

Builds the model of ``chip_smoke.py`` phase 4 (``--model llama``:
Llama-3.1-8B), phase 6 (``--model llama --layout splitplane``: the same
in the split-plane layout) or phase 5 (``--model mixtral``: Mixtral-8x7B,
experts grouped as the model is made), 32 layers, random weights from
seed 0, K split 3584/256/256; fills 8 slots with 128-token prompts, and
profiles ``--steps`` greedy decode steps (``decode_multi``) with
``torch.profiler``, for each parameter form named by ``--forms``:
"stacked" (the default engine's form: q|k|v and gate|up stacked, with
residual-pair decode for ScaledW8 weights, or q|k|v stacked and the
experts grouped) and "per-consumer" (the form that
``MICROMIX_NO_STACK=1`` keeps; Llama only: a full-depth Mixtral holds
one copy of its experts).  Prints one JSON
object per model: for each form host wall ms per step, device busy ms
per step (sum of kernel times on the one stream), the device's idle
share, CUDA kernel launches per step (all of them, PyTorch's own
included), the kernels that take the most device time, and the PyTorch
operators that take the most host time (their own CPU time).  Also writes
them to ``chiprun_out/profile_decode_<model>[_splitplane].json``.

Run from the repository root on the GPU machine:

    python3 scripts/torch_profile_decode.py [--model llama|mixtral] \
        [--layout auto|splitplane] [--steps 8] [--layers 32] \
        [--forms stacked per-consumer]
"""

from __future__ import annotations

import argparse
import collections
import json
import os
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
from micromix_tpu_torch.serve.runner import decode_multi, prefill_batch  # noqa: E402


def profile_form(params, cfg, steps: int) -> dict:
    dev = "cuda"
    b, s, ps = 8, 128, 128
    mp = -(-(s + 2 * steps + 1) // ps)
    caches = [make_cache(b * mp + 1, ps, cfg.num_kv_heads, cfg.head_dim, b, mp,
                         device=dev) for _ in range(cfg.num_layers)]
    table = torch.arange(1, b * mp + 1, dtype=torch.int32).reshape(b, mp)
    for c in caches:
        c.page_table.copy_(table)
    rng = np.random.default_rng(SEED)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s))).to(dev)
    seq = torch.arange(b, dtype=torch.int32, device=dev)
    logits, caches = prefill_batch(params, cfg, caches, tokens, seq,
                                   torch.full((b,), s - 1, device=dev))
    first = torch.argmax(logits, dim=-1).to(torch.int32)
    zeros = torch.zeros(b, device=dev)
    kw = dict(gen=None, temps=zeros, top_k=zeros.to(torch.int32),
              top_p=torch.ones(b, device=dev), n_steps=steps,
              sample_mode="greedy")
    pos = torch.full((b,), s, dtype=torch.int32, device=dev)
    # warm-up chunk: first launches, allocator growth
    toks, caches = decode_multi(params, cfg, caches, first, seq, pos, **kw)
    torch.cuda.synchronize()
    pos = pos + steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        toks, caches = decode_multi(params, cfg, caches, toks[-1], seq, pos, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per_kernel = collections.Counter()
    launches = collections.Counter()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            per_kernel[e.name] += e.device_time_total
            launches[e.name] += 1
    busy_ms = sum(per_kernel.values()) / 1e3
    wall_ms = wall * 1e3
    top = [dict(kernel=name[:80], ms_per_step=us / 1e3 / steps,
                launches_per_step=launches[name] / steps)
           for name, us in per_kernel.most_common(14)]
    # where the host's time goes: PyTorch operators by their own CPU time
    host = collections.Counter({e.key: e.self_cpu_time_total
                                for e in prof.key_averages()
                                if e.self_cpu_time_total > 0})
    top_host = [dict(op=name[:80], ms_per_step=us / 1e3 / steps)
                for name, us in host.most_common(10)]
    return dict(host_wall_ms_per_step=wall_ms / steps,
                device_busy_ms_per_step=busy_ms / steps,
                device_idle_share=1.0 - busy_ms / wall_ms,
                kernel_launches_per_step=sum(launches.values()) / steps,
                top_kernels=top, top_host_ops=top_host)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="llama", choices=["llama", "mixtral"])
    ap.add_argument("--layout", default="auto", choices=["auto", "splitplane"],
                    help="weight layout (splitplane: Llama only)")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--forms", nargs="+", default=None,
                    choices=["stacked", "per-consumer"],
                    help="default: both for llama, stacked for mixtral")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    forms = args.forms or (["stacked", "per-consumer"] if args.model == "llama"
                           else ["stacked"])
    if args.model == "mixtral" and ("per-consumer" in forms
                                    or args.layout != "auto"):
        ap.error("the Mixtral model is made grouped, ScaledW8: only the "
                 "stacked form and the auto layout")
    cfg = (llama31_8b if args.model == "llama" else mixtral_8x7b)(args.layers)
    params = random_quantized_model(
        cfg, default_calibration(cfg, p6=256, p8=256, seed=SEED), seed=SEED,
        device="cuda", layout=args.layout)
    out = dict(device=torch.cuda.get_device_name(0), model=args.model,
               layout=args.layout, layers=cfg.num_layers, batch=8, context=128,
               steps=args.steps, forms={})
    for form in forms:
        p = stack_layer_projections(params) if form == "stacked" else params
        out["forms"][form] = profile_form(p, cfg, args.steps)
        del p
        torch.cuda.empty_cache()
    os.makedirs("chiprun_out", exist_ok=True)
    suffix = "_splitplane" if args.layout == "splitplane" else ""
    with open(os.path.join("chiprun_out",
                           f"profile_decode_{args.model}{suffix}.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
