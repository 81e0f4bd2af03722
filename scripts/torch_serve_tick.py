"""Rank 0's host milliseconds a scheduler tick of ``serve --tp 2 --port``
(``chip_smoke.py`` phase 13 (e)'s server path), to compare two trees of
the repo on one card.

Two ranks on one card over gloo, each with its tp=2 shard of Llama-3.1-8B
widths at ``chip_smoke.P8_LAYERS`` layers (random weights from the seed,
``default_calibration(p6=256, p8=256)``), serve through the CLI's rank
server (``cli._serve_http_rank``) with phase 13 (e)'s engine settings
(one slot, 128-token pages, int4 KV, decode chunk 8) and traffic, sent
``ROUNDS`` times (the first warms the engines): eight completions of 8
tokens at once (one streamed) beside a stream whose client goes away
after two events, prompts of 64-128 integer tokens.  A tick is rank 0's router ``step`` plus, on a
tree whose ``ApiServer`` takes ``followers`` (its lockstep channel),
that channel's message before it; the channel's share is timed apart
(a ``ReplicaRouter``'s ``ctl_s``).  Per round: ticks, mean and median
host ms a tick, mean channel ms a tick, and the round's wall seconds;
the completions' texts, which two trees must give alike.

    python3 scripts/torch_serve_tick.py [--tree DIR] [--out FILE]

``--tree`` is the root of the tree whose package and ``chip_smoke.py``
run (default: this script's).  The last line is one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import threading
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
N_NEW = 8
ROUNDS = 3


def _instrument(ticks: list) -> None:
    """Time rank 0's ticks: (wall time, host s, channel s) each."""
    from micromix_tpu_torch.serve import api
    init = api.ApiServer.__init__

    def patched(self, *a, **k):
        init(self, *a, **k)
        router, step, sent = self.router, self.router.step, [0.0]

        def timed_step():
            c0 = getattr(router, "ctl_s", 0.0)
            t0 = time.perf_counter()
            out = step()
            dt = time.perf_counter() - t0
            ch = getattr(router, "ctl_s", 0.0) - c0 + sent[0]
            ticks.append((time.time(), dt + sent[0], ch))
            sent[0] = 0.0
            return out

        router.step = timed_step
        follow = getattr(self, "followers", None)
        if follow is not None:

            def timed_send(admits, cancels, op):
                t0 = time.perf_counter()
                follow(admits, cancels, op)
                if op == "step":
                    sent[0] += time.perf_counter() - t0

            self.followers = timed_send

    api.ApiServer.__init__ = patched


def rank(group, calibs, port: int, stop) -> dict:
    import argparse as ap
    import chip_smoke as cs
    from micromix_tpu_torch import cli
    from micromix_tpu_torch.parallel import make_tp_engine
    cfg = cs.llama31_8b(cs.P8_LAYERS)
    tree = cs.p12_tp_model(cfg, calibs, group, cs.SEED)
    eng = make_tp_engine(tree, cfg, group, max_seqs=1, page_size=128,
                         kv_bits=4, decode_chunk=8, device=group.device)
    ticks: list = []
    if group.rank == 0:
        _instrument(ticks)
    group.reset_counts()
    outs, stats = cli._serve_http_rank(
        group, eng, ap.Namespace(model="llama31_8b", port=port),
        cs.IntTokenizer(), stop)
    return dict(ticks=ticks, stats=stats, outputs=outs)


def _round(cs, port: int, prompts) -> list:
    from concurrent.futures import ThreadPoolExecutor

    def one(i):
        body = {"prompt": prompts[i], "max_tokens": N_NEW}
        if i != 1:
            return json.loads(cs._http(port, "/v1/completions", body)[1]
                              )["choices"][0]["text"]
        raw = cs._http(port, "/v1/completions", dict(body, stream=True))[1]
        ev = [ln[6:] for ln in raw.splitlines() if ln.startswith("data: ")]
        return "".join(json.loads(e)["choices"][0]["text"] for e in ev[:-1])

    with ThreadPoolExecutor(9) as ex:
        cut = ex.submit(cs._cut_stream, port, prompts[8])
        texts = list(ex.map(one, range(8)))
        cut.result()
    return texts


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--out", default=os.path.join("chiprun_out",
                                                  "torch_serve_tick.json"))
    args = ap.parse_args()
    # the ranks inherit this path (spawn hands sys.path to its children)
    sys.path.insert(0, os.path.abspath(args.tree))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_serve_tick: no CUDA device", file=sys.stderr)
        return 2
    import torch.multiprocessing as mp
    import chip_smoke as cs
    from micromix_tpu_torch.kernels import build
    from micromix_tpu_torch.models.surgery import default_calibration
    from micromix_tpu_torch.parallel import spawn
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"tree {os.path.abspath(args.tree)}; {smi}", flush=True)
    print(f"built in {build.build():.1f}s", flush=True)
    cfg = cs.llama31_8b(cs.P8_LAYERS)
    calibs = default_calibration(cfg, p6=256, p8=256, seed=cs.SEED)
    rng = np.random.default_rng(cs.SEED + 13)
    tk = cs.IntTokenizer()
    prompts = [tk.decode(rng.integers(0, cfg.vocab_size,
                                      int(rng.integers(64, 129))))
               for _ in range(9)]
    # every rank on the first card, over gloo, as in phase 13 (e)
    os.environ["CUDA_VISIBLE_DEVICES"] = "0"
    port, stop, res = cs._free_port(), mp.get_context("spawn").Event(), {}

    def serve():
        try:
            res["ranks"] = spawn(rank, 2, calibs, port, stop, device="cuda")
        except BaseException as e:      # noqa: BLE001 (raised below)
            res["error"] = e

    th = threading.Thread(target=serve)
    th.start()
    windows, texts = [], []
    try:
        t0 = time.perf_counter()
        while True:
            try:
                if cs._http(port, "/health")[0] == 200:
                    break
            except OSError:
                pass
            if not th.is_alive() or time.perf_counter() - t0 > 600:
                raise SystemExit(f"the server did not come up: {res}")
            time.sleep(0.5)
        for _ in range(ROUNDS):
            w0 = time.time()
            texts.append(_round(cs, port, prompts))
            windows.append((w0, time.time()))
    finally:
        stop.set()
        th.join(600)
    if "error" in res:
        raise res["error"]
    r0 = res["ranks"][0]
    if res["ranks"][1]["outputs"] != r0["outputs"]:
        raise SystemExit("rank 1 emitted other tokens than rank 0")
    if any(t != texts[0] for t in texts):
        raise SystemExit("the rounds' completions differ")
    rounds = []
    for w0, w1 in windows:
        mine = [(s, c) for t, s, c in r0["ticks"] if w0 <= t <= w1]
        host = [1e3 * s for s, _ in mine]
        rounds.append(dict(
            ticks=len(mine), wall_s=w1 - w0,
            host_ms_per_tick=statistics.fmean(host),
            host_ms_median=statistics.median(host),
            channel_ms_per_tick=statistics.fmean(1e3 * c for _, c in mine)))
        print(f"  {rounds[-1]}", flush=True)
    out = dict(tree=os.path.abspath(args.tree), card=smi, rounds=rounds,
               stats=r0["stats"], texts=texts[0])
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
