"""Run-to-run determinism of the card path under chip_smoke's phases 7 and 11.

Phase 11 holds 2 layers of the hetero form (budgets from phase 7's
calibrations) card against CPU by greedy tokens.  This script asks
whether a difference between two runs of that check can come from the
card, and from which stage:

1. ``--kernels``: chip_smoke's phase-2 kernel checks and phase 14 (a),
   each kernel called twice more on its inputs (``record``'s ``rerun``):
   the results must be equal bit for bit.
2. Phase 7's calibration (``collect_calibration`` and
   ``stats_to_calibration`` over the same four 2048-token windows) of the
   dense Llama-3.1-8B-width model made from the seed, ``--runs`` times:
   every stat of every site and every calibration (reorder, fp6 and fp8
   widths) compared with the first run's.
3. Phase 11's 2-layer hetero ``card_vs_cpu`` on the first run's
   calibrations, ``--runs`` times, and once on each other run's: the
   card's and the CPU's logits of every unit compared by sha256, with each
   run's greedy tokens, logit errors and the last prompt chunk's CPU top
   two and their margin.  A failed check is recorded, not raised.

    python3 scripts/torch_determinism.py [--layers 32] [--runs 3]
        [--kernels] [--out FILE]

The last line of its output is one JSON object with the comparisons.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import chip_smoke as cs  # noqa: E402


def _sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]


def calibrate(layers: int):
    """Phase 7's calibration stage alone: stats and calibrations."""
    from micromix_tpu_torch.calib import collect_calibration, stats_to_calibration
    from micromix_tpu_torch.eval import synthetic_tokens
    cfg = cs.llama31_8b(layers)
    seqlen = cs.P7_SEQLEN
    stream = synthetic_tokens(cfg.vocab_size, cs.P7_CAL * seqlen, seed=cs.SEED)
    windows = [stream[i * seqlen:(i + 1) * seqlen][None, :] for i in range(cs.P7_CAL)]
    params = cs.dense_llama(cfg, cs.SEED, cs.DEV)
    stats = collect_calibration(params, cfg, windows)
    calibs = stats_to_calibration(stats, cfg)
    del params
    torch.cuda.empty_cache()
    return stats, calibs


def stats_diff(a, b) -> list:
    """(site, stat) of every stat not bit-equal between two runs."""
    return [f"{key}/{name}" for key in a for name in a[key]
            if _sha(a[key][name]) != _sha(b[key][name])]


def calib_diff(a, b) -> list:
    """(layer, site, what) of every calibration that differs."""
    out = []
    for i, (la, lb) in enumerate(zip(a, b)):
        for site in la:
            ca, cb = la[site], lb[site]
            if not np.array_equal(ca.reorder_index, cb.reorder_index):
                out.append(f"{i}/{site}/reorder")
            if (ca.p6_num, ca.p8_num) != (cb.p6_num, cb.p8_num):
                out.append(f"{i}/{site}/widths {(ca.p6_num, ca.p8_num)} "
                           f"{(cb.p6_num, cb.p8_num)}")
    return out


def hetero_card_vs_cpu(calibs, failures: list) -> dict:
    """Phase 11's 2-layer hetero check on ``calibs``' first two layers."""
    cfg2 = cs.llama31_8b(2)
    n_before = len(failures)
    r = cs.card_vs_cpu(
        cfg2, 4, ("flash_attention", "paged_prefill", "paged_decode")
        + cs.FORM_KERNELS["hetero"],
        lambda p: type(p["layers"][0]["q"]).__name__ == cs.FORM_LINEAR["hetero"],
        name="llama hetero", prompt_len=200,
        make=lambda: cs.p11_quantize("hetero", cs.dense_llama(cfg2, cs.SEED, cs.DEV),
                                     cfg2, calibs[:2]))
    n_chunks = -(-200 // 128)
    (i1, i2), margin = r["cpu_top2"][n_chunks - 1]
    return dict(tokens=r["tokens"], cpu_tokens=r["cpu_tokens"],
                logit_rel_err=r["logit_rel_err"],
                card_logit_sha256=r["card_logit_sha256"],
                last_chunk_cpu_top2=[i1, i2], last_chunk_margin=margin,
                failed=failures[n_before:])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=cs.P7_LAYERS)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--kernels", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_determinism: no CUDA device", file=sys.stderr)
        return 2
    from micromix_tpu_torch.kernels import build
    failures: list = []
    cs.fail = failures.append          # record a failed check, go on
    print(f"built {len(build.SOURCES)} kernels in {build.build():.1f}s", flush=True)
    out = {"card": torch.cuda.get_device_name(0), "layers": args.layers,
           "runs": args.runs}
    t0 = time.perf_counter()
    if args.kernels:
        rng = np.random.default_rng(cs.SEED)
        results, timer = [], cs.Timer()
        for check in (cs.check_site, cs.check_site_blocks, cs.check_decode,
                      cs.check_append, cs.check_append_quant, cs.check_stack,
                      cs.check_pair, cs.check_prefill, cs.check_grouped,
                      cs.check_quantize, cs.check_sp_stack):
            check(results, timer, rng)
        for check in (cs.check_gemm, cs.check_site_gemm, cs.check_flash,
                      cs.check_sp_gemm):
            check(results, timer)
        cs.phase14a(results, timer, rng)
        del timer
        checked = [r for r in results if "repeat_bit_equal" in r]
        out["kernels"] = {
            "checked": len(checked),
            "differ": [f"{r['kernel']} {r['shape']}" for r in checked
                       if not r["repeat_bit_equal"]],
            "other_failures": list(failures)}
        print(f"kernels: {json.dumps(out['kernels'])}", flush=True)
        failures.clear()
        torch.cuda.empty_cache()
    runs = []
    for i in range(args.runs):
        t = time.perf_counter()
        runs.append(calibrate(args.layers))
        print(f"calibration run {i}: {time.perf_counter() - t:.1f}s", flush=True)
    out["calibration"] = [
        {"stats_differing": stats_diff(runs[0][0], s)[:20],
         "n_stats_differing": len(stats_diff(runs[0][0], s)),
         "calibs_differing": calib_diff(runs[0][1], c)[:20],
         "n_calibs_differing": len(calib_diff(runs[0][1], c))}
        for s, c in runs[1:]]
    print(f"calibration against run 0: {json.dumps(out['calibration'])}", flush=True)
    checks = [("run 0's calibrations", runs[0][1]) for _ in range(args.runs)]
    checks += [(f"run {i}'s calibrations", runs[i][1]) for i in range(1, args.runs)]
    out["hetero"] = []
    for label, calibs in checks:
        r = hetero_card_vs_cpu(calibs, failures)
        r["calibrations"] = label
        out["hetero"].append(r)
        print(f"hetero card vs CPU on {label}: {json.dumps(r)}", flush=True)
    same = out["hetero"][:args.runs]
    out["hetero_card_logits_repeat_equal"] = all(
        r["card_logit_sha256"] == same[0]["card_logit_sha256"] for r in same)
    out["seconds"] = time.perf_counter() - t0
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps({k: v for k, v in out.items() if k != "hetero"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
