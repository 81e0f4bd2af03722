"""Host cost of the engine's two page pools: the native core
(``NativeBlockManager``, the default) against the Python pool
(``BlockManager``).

1. The pools alone: 8 slots, each step the engine's ``_ensure_pages``
   per slot (``num_pages``, ``ensure``, ``num_pages``, the table row when
   a page was added) as 8 sequences grow from 100 tokens by one token a
   step for ``--steps`` steps, then every slot released; host
   microseconds per step, the median of 5 runs.
2. With a card: Llama-3.1-8B widths at ``--layers`` layers (random
   ScaledW8 weights from the seed), the default engine on phase 4's
   traffic (chip_smoke's ``_traffic``), on its native pool and with the
   Python pool put in its place before the run, in turns, three runs
   each: the engine's decode and mixed host ms per step and the run's
   wall seconds; the two pools' greedy tokens must be equal.

    python3 scripts/torch_page_pool.py [--steps 256] [--layers 4] [--out FILE]

The last line of its output is one JSON object with both.
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


def pool_alone(cls, steps: int) -> float:
    """Host microseconds per step of 8 slots' ``_ensure_pages``."""
    pool = cls(8 * 16 + 1, 128, 8, 16)
    t0 = time.perf_counter()
    for step in range(steps):
        for slot in range(8):
            before = pool.num_pages(slot)
            row = pool.ensure(slot, 100 + step + 1)
            if pool.num_pages(slot) != before:
                row.copy()
    for slot in range(8):
        pool.release(slot)
    return (time.perf_counter() - t0) * 1e6 / steps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    from micromix_tpu_torch.serve.block_manager import BlockManager, NativeBlockManager
    out = {"alone_us_per_step": {}}
    for name, cls in (("native", NativeBlockManager), ("python", BlockManager)):
        out["alone_us_per_step"][name] = statistics.median(
            pool_alone(cls, args.steps) for _ in range(5))
    print(f"pools alone, 8 slots: {json.dumps(out['alone_us_per_step'])} "
          "host us per step", flush=True)
    if torch.cuda.is_available():
        import chip_smoke as cs
        from micromix_tpu_torch.kernels import build
        from micromix_tpu_torch.models.surgery import (default_calibration,
                                                       random_quantized_model)
        from micromix_tpu_torch.serve.engine import Engine
        build.build()
        out["card"] = torch.cuda.get_device_name(0)
        cfg = cs.llama31_8b(args.layers)
        params = random_quantized_model(
            cfg, default_calibration(cfg, p6=256, p8=256, seed=cs.SEED),
            seed=cs.SEED, device=cs.DEV)
        runs = {"native": [], "python": []}
        tokens = {}
        for i in range(6):
            name = "native" if i % 2 == 0 else "python"
            reqs = cs._traffic(np.random.default_rng(cs.SEED), cfg.vocab_size)
            eng = Engine(params, cfg, seed=cs.SEED, device=cs.DEV, max_seqs=8,
                         page_size=128, max_pages_per_seq=16, decode_chunk=8,
                         prefill_chunk=512)
            if name == "python":        # the same pool state: nothing taken yet
                bm = eng.block_manager
                eng.block_manager = BlockManager(bm.n_pages, bm.page_size,
                                                 bm.max_seqs, bm.max_pages_per_seq)
            t0 = time.perf_counter()
            eng.run(reqs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if not all(r.done and len(r.output) == r.max_new_tokens for r in reqs):
                print(f"{name} pool: a request did not finish", flush=True)
                return 1
            steps = eng.phase_steps
            runs[name].append({
                "decode_ms_per_step": 1e3 * eng.phase_s["decode"] / steps["decode"],
                "mixed_ms_per_step": 1e3 * eng.phase_s["mixed"] / steps["mixed"],
                "wall_s": wall})
            tokens.setdefault(name, [r.output for r in reqs])
            del eng
        if tokens["native"] != tokens["python"]:
            print("the two pools' greedy tokens differ", flush=True)
            return 1
        out["engine"] = runs
        for name, rs in runs.items():
            print(f"engine, {args.layers} layers, {name} pool: decode ms/step "
                  f"{[round(r['decode_ms_per_step'], 4) for r in rs]}, mixed "
                  f"{[round(r['mixed_ms_per_step'], 4) for r in rs]}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
