"""Two tp=2 replicas behind the router (``parallel.ReplicaRouter``), each
rank on a card of its own over NCCL, beside the same run with every rank
on one card over gloo.

The run is ``chip_smoke.py`` phase 16 (a): Llama-3.1-8B widths at
``chip_smoke.P16_LAYERS`` layers (random weights from the seed, each
replica its own, ``default_calibration(p6=256, p8=256)``), phase 4's
eight requests (six of 96-128 prompt tokens, two of 1200-1500, 32 new),
routed by least outstanding work; each replica's tokens must equal a
lone tp=2 engine's on its requests in the same order, and every rank
must launch the TP path's kernels and no plain version.

  * "nccl": 4 processes, rank r on ``cuda:r`` (``mesh.rank_device``),
    NCCL inside each replica (``mesh.pick_backend``), run only on a
    machine with at least 4 cards;
  * "gloo": 4 processes with ``CUDA_VISIBLE_DEVICES`` set to the first
    card, all on ``cuda:0`` over gloo (host-staged all_reduces).

For each: per replica the engine's decode ms a step, a decode window's
host and device busy ms and all_reduces (and their host ms) a step, rank
0's host ms a tick and the control channel's share, the routed run's
wall seconds, and whether the two layouts' tokens are equal.

    python3 scripts/torch_replicas.py [--out FILE]

The last line of its output is one JSON object with both layouts.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def rank(group, calibs, specs) -> dict:
    import chip_smoke as cs
    from micromix_tpu_torch.parallel import ReplicaRouter, make_tp_engine
    cfg = cs.llama31_8b(cs.P16_LAYERS)
    trees = {}

    def tp_engine(g, r):
        if "tp" not in trees:
            trees["tp"] = cs.p12_tp_model(cfg, calibs, g,
                                          cs.SEED + 16 + r)
        return make_tp_engine(trees["tp"], cfg, g, **cs.P16_ENGINE)

    router = ReplicaRouter(group, tp_engine, cs.P16_REPLICAS)
    out = dict(backend=router.local.backend, device=str(router.local.device),
               members=router.local.members)
    out.update(cs.p16_routed(router, specs, f"replicas over {group.backend}",
                             cs.TP_KERNELS, lambda g: tp_engine(g, None)))
    return out


def layout(calibs, specs) -> dict:
    import chip_smoke as cs
    from micromix_tpu_torch.parallel import spawn
    ranks = spawn(rank, cs.P16_REPLICAS * cs.P16_RANKS, calibs, specs,
                  device="cuda")
    r0 = ranks[0]
    rule = cs.p16_assign(specs, cs.P16_REPLICAS)
    if r0["where"] != rule:
        raise SystemExit(f"assigned {r0['where']}, Router's rule {rule}")
    for i, rep in enumerate(r0["where"]):
        if r0["tokens"][i] != ranks[rep * cs.P16_RANKS]["lone"][i]:
            raise SystemExit(f"request {i}: routed tokens differ from the lone "
                             f"engine's on replica {rep}")
    reps = []
    for rep, m in enumerate(r0["replicas"]):
        lead = ranks[rep * cs.P16_RANKS]
        w = lead["window"]
        reps.append(dict(
            devices=[ranks[g]["device"] for g in lead["members"]],
            engine_decode_ms_per_step=m["decode_ms_per_step"],
            leader_step_ms=m["leader_step_ms"],
            window_host_ms_per_step=w["ms_per_step"],
            window_busy_ms_per_step=w["device_busy_ms_per_step"],
            all_reduces_per_step=w["all_reduces_per_step"],
            all_reduce_ms_per_step=w["all_reduce_ms_per_step"]))
    return dict(backend=r0["backend"], wall_s=r0["wall_s"], ticks=r0["ticks"],
                tick_ms=r0["tick_ms"], ctl_ms=r0["ctl_ms"],
                messages=r0["messages"], assigned=r0["stats"]["assigned"],
                replicas=reps, tokens=r0["tokens"])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join("chiprun_out",
                                                  "torch_replicas.json"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_replicas: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from micromix_tpu_torch.kernels import build
    from micromix_tpu_torch.models.surgery import default_calibration
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    cards = torch.cuda.device_count()
    print(f"{cards} cards: {smi}", flush=True)
    print(f"built in {build.build():.1f}s", flush=True)
    calibs = default_calibration(cs.llama31_8b(cs.P16_LAYERS), p6=256, p8=256,
                                 seed=cs.SEED)
    rng = np.random.default_rng(cs.SEED + 16)
    vocab = cs.llama31_8b(1).vocab_size
    specs = [(r.prompt, r.max_new_tokens) for r in cs._traffic(rng, vocab)]
    world = cs.P16_REPLICAS * cs.P16_RANKS
    out = {"cards": smi, "layers": cs.P16_LAYERS}
    if cards >= world:
        out["nccl"] = layout(calibs, specs)
    else:
        out["nccl"] = f"not run: {cards} card(s), {world} ranks need {world}"
    # every rank on the first card: the children see one card
    os.environ["CUDA_VISIBLE_DEVICES"] = "0"
    out["gloo"] = layout(calibs, specs)
    if isinstance(out["nccl"], dict):
        out["tokens_equal"] = out["nccl"].pop("tokens") == out["gloo"]["tokens"]
    out["gloo"].pop("tokens")
    for name in ("nccl", "gloo"):
        res = out[name]
        if not isinstance(res, dict):
            print(f"{name}: {res}", flush=True)
            continue
        print(f"{name}: assigned {res['assigned']}, routed run {res['wall_s']:.2f}s, "
              f"{res['ticks']} ticks, {res['tick_ms']:.3f} host ms a tick "
              f"({res['ctl_ms']:.3f} the channel)", flush=True)
        for i, rep in enumerate(res["replicas"]):
            print(f"  replica {i} on {rep['devices']}: engine decode "
                  f"{rep['engine_decode_ms_per_step']:.3f} ms/step; window "
                  f"{rep['window_host_ms_per_step']:.3f} host, "
                  f"{rep['window_busy_ms_per_step']:.3f} busy, "
                  f"{rep['all_reduces_per_step']:.1f} all_reduces "
                  f"({rep['all_reduce_ms_per_step']:.3f} ms) a step", flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
