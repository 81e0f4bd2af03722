"""Rank functions for the port's parallel tests (TP v1 and v2, EP, PP,
SP, the collectives, replicas behind the router).

``micromix_tpu_torch.parallel.spawn`` starts each rank in a fresh
interpreter, which finds its function by module and name; the test
files import JAX, so the functions live here, in a module that imports
only torch and the port.  Each returns plain data (numpy, lists, ints).
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List

import numpy as np
import torch
import torch.distributed as dist

from micromix_tpu_torch.parallel import (ReplicaRouter, axis_groups,
                                         make_ep_engine,
                                         make_tp_engine,
                                         pipeline_parallel_forward,
                                         quantize_model_tp,
                                         quantize_model_tp_hetero,
                                         sequence_parallel_forward,
                                         serve_http,
                                         shard_params_tp,
                                         shard_quantized_params,
                                         sharded_forward_tp,
                                         sharded_quantized_forward)
from micromix_tpu_torch.parallel.moe_ep import (ep_moe_forward,
                                                ep_moe_forward_hetero,
                                                ep_moe_forward_quant)
from micromix_tpu_torch.serve.engine import Engine, Request
from micromix_tpu_torch.serve.sampling import SamplingParams


def requests(specs: List[Dict[str, Any]]) -> List[Request]:
    """Request specs (prompt, max_new_tokens, logprobs, eos_id, sampling
    kwargs) -> Requests."""
    out = []
    for i, sp in enumerate(specs):
        sp = dict(sp)
        out.append(Request(req_id=i, prompt=list(sp.pop("prompt")),
                           max_new_tokens=sp.pop("max_new_tokens"),
                           logprobs=sp.pop("logprobs", False),
                           eos_id=sp.pop("eos_id", None),
                           sampling=SamplingParams(**sp)))
    return out


def _served(eng, specs) -> Dict[str, Any]:
    reqs = eng.run(requests(specs))
    return {"tokens": [r.output for r in reqs],
            "logprobs": [r.token_logprobs for r in reqs],
            "steps": eng.decode_steps, "prefill_tokens": eng.prefill_tokens}


def tp_forward(group, params, cfg, tokens: np.ndarray) -> np.ndarray:
    """One rank's ``sharded_forward_tp`` over its slice of a global tree."""
    mine = shard_params_tp(params, group.rank, group.world)
    return sharded_forward_tp(mine, cfg, torch.from_numpy(tokens),
                              group).numpy()


def tp_local_quant(group, dense, cfg, calibs, hetero: bool,
                   weight_fp4_only: bool = True):
    """The rank's tree quantized from its shards alone, and the number of
    reduces it took."""
    if hetero:
        tree = quantize_model_tp_hetero(dense, cfg, calibs, group.world,
                                        group=group)
    else:
        tree = quantize_model_tp(dense, cfg, calibs, group.world,
                                 weight_fp4_only=weight_fp4_only, group=group)
    return tree, group.reduces


def tp_serve(group, params, cfg, runs: List[Dict[str, Any]]):
    """Each run: a TP engine over the rank's slice of ``params``
    (``engine`` kwargs) serving ``specs``; its streams, the rank's cache
    heads, and the reduces it took."""
    params = shard_params_tp(params, group.rank, group.world)
    out = []
    for run in runs:
        group.reset_counts()
        eng = make_tp_engine(params, cfg, group, **run["engine"])
        res = _served(eng, run["specs"])
        res["cache_heads"] = eng.caches[0].n_kv_heads
        res["reduces"] = group.reduces
        out.append(res)
    return out


def single_serve(params, cfg, runs: List[Dict[str, Any]]):
    """The single-card engine on the same runs (for the parent)."""
    return [_served(Engine(params, cfg, device="cpu", **run["engine"]),
                    run["specs"]) for run in runs]


def ep_serve(group, params, cfg, runs: List[Dict[str, Any]]):
    """Each run: an EP engine over the rank's experts of ``params`` (a
    global EP tree), ``cfg`` or the run's own config."""
    out = []
    for run in runs:
        group.reset_counts()
        eng = make_ep_engine(params, run.get("cfg", cfg), group, **run["engine"])
        res = _served(eng, run["specs"])
        res["reduces"] = group.reduces
        out.append(res)
    return out


def ep_forwards(group, cases):
    """Each case (kind, x, ln2, router, global stacked experts, cfg) ->
    the rank's ``ep_moe_forward*`` on its slice of the experts."""
    from micromix_tpu_torch.parallel.ep_serve import _slice_experts
    fns = {"dense": ep_moe_forward, "quant": ep_moe_forward_quant,
           "hetero": ep_moe_forward_hetero}
    out = []
    for kind, x, ln2, router, stacked, cfg in cases:
        el = cfg.num_experts // group.world
        if kind == "dense":
            mine = {k: v[group.rank * el:(group.rank + 1) * el]
                    for k, v in stacked.items()}
        else:
            mine = _slice_experts(
                {k: v for k, v in stacked.items()
                 if k not in ("splits_in", "splits_down")},
                group.rank * el, (group.rank + 1) * el)
            if kind == "quant":
                mine.update(splits_in=stacked["splits_in"],
                            splits_down=stacked["splits_down"])
        out.append(fns[kind](x, ln2, router, mine, cfg, group)
                   .to(torch.float32).numpy())
    return out


def cuda_all_reduce(group) -> Dict[str, Any]:
    """One f32 sum of CUDA tensors over the group."""
    t = torch.tensor([1.0, 2.0, 3.0], device=group.device) * (group.rank + 1)
    group.all_reduce(t)
    return {"sum": t.cpu().tolist(), "backend": group.backend,
            "device": str(t.device)}


def tp_quant_and_forward(group, dense, tree, cfg, calibs, tokens, hetero: bool,
                         weight_fp4_only: bool):
    """The rank's own tree quantized from its shards, the reduces that
    took, and (with ``tokens``) its forward over its slice of ``tree``."""
    local, n_reduce = tp_local_quant(group, dense, cfg, calibs, hetero,
                                     weight_fp4_only)
    logits = None if tokens is None else tp_forward(group, tree, cfg, tokens)
    return local, n_reduce, logits


def spmd_forward(group, params, cfg, tokens: np.ndarray, data: int,
                 model: int) -> np.ndarray:
    """TP v1 on a (data, model) layout: the rank's model shard of the
    global tree, its data shard's logits."""
    groups = axis_groups(group, data=data, model=model)
    mine = shard_quantized_params(params, groups["model"].rank, model)
    return sharded_quantized_forward(mine, cfg, torch.from_numpy(tokens),
                                     groups).numpy()


def pp_forward(group, params, cfg, tokens: np.ndarray,
               n_micro: int) -> np.ndarray:
    """The rank's (replicated) logits of the pipeline over its stages."""
    return pipeline_parallel_forward(params, cfg, torch.from_numpy(tokens),
                                     group, n_micro=n_micro).numpy()


def sp_forwards(group, params, cases) -> List[np.ndarray]:
    """Each case (cfg, tokens, attn) -> the rank's sequence shard of the
    logits."""
    return [sequence_parallel_forward(params, cfg, torch.from_numpy(tokens),
                                      group, attn=attn).numpy()
            for cfg, tokens, attn in cases]


def collectives(group) -> Dict[str, Any]:
    """Each collective on a rank-dependent bf16 and f32 tensor; the 2-D
    layout's groups on 4 ranks; the counts by kind."""
    out = {}
    r, w = group.rank, group.world
    for dt in (torch.bfloat16, torch.float32):
        t = (torch.arange(2 * 4 * w, dtype=torch.float32).reshape(2, 4 * w)
             + 1000 * r).to(dt)
        out[str(dt)] = {
            "all_gather": group.all_gather(t, 1),
            "all_to_all": group.all_to_all(t, 1, 0),
            "ring": group.ppermute(t, [(i, (i + 1) % w) for i in range(w)]),
            "chain": group.ppermute(t, [(i, i + 1) for i in range(w - 1)]),
            "broadcast": group.broadcast(t.clone(), w - 1)}
    out["counts"] = dict(group.counts)
    if w == 4:
        gs = axis_groups(group, data=2, model=2)
        x = torch.tensor([float(r)])
        out["layout"] = {a: (g.rank, g.world, g.all_gather(x, 0).tolist())
                         for a, g in gs.items()}
    return out


# ---------------- replicas behind the router ----------------

def replica_engine(kind: str, trees, cfg, engine_kw, fail_rank=None):
    """The factory of replica r's engine over ``trees[r]``: a TP engine
    over the rank's slice ("tp"), an EP engine ("ep"), or a plain
    ``Engine`` ("single", one rank a replica).  On global rank
    ``fail_rank`` the engine's second step raises."""
    def make(group, r):
        if kind == "tp":
            eng = make_tp_engine(shard_params_tp(trees[r], group.rank,
                                                 group.world),
                                 cfg, group, **engine_kw)
        elif kind == "ep":
            eng = make_ep_engine(trees[r], cfg, group, **engine_kw)
        else:
            eng = Engine(trees[r], cfg, device=group.device, **engine_kw)
        if fail_rank is not None and dist.get_rank() == fail_rank:
            step, n = eng.step, [0]

            def failing():
                n[0] += 1
                if n[0] == 2:
                    raise RuntimeError("a step failed on this rank")
                return step()
            eng.step = failing
        return eng
    return make


def drive(router, reqs, cancel=None):
    """Submit every request, then step until no work is left; with
    ``cancel`` = (steps, req_id), cancel that request after that many
    steps.  -> the replica each request went to, and (req_id, token) in
    ``on_token`` order."""
    order = []
    for q in reqs:
        q.on_token = lambda t, rid=q.req_id: order.append((rid, int(t)))
    where = [router.submit(q) for q in reqs]
    steps = 0
    while router.step():
        steps += 1
        if cancel is not None and steps == cancel[0]:
            assert router.cancel(cancel[1])
    return where, order


def _placement(router) -> Dict[str, Any]:
    loc = router.local
    return {"outputs": router.outputs(), "replica": router.replica,
            "local": [loc.rank, loc.world], "members": loc.members,
            "backend": loc.backend, "device": str(loc.device),
            "subgroup_backend": (None if loc.group is None
                                 else dist.get_backend(loc.group))}


def replica_serve(group, kind: str, trees, cfg, engine_kw, specs,
                  replicas: int, cancel=None, fail_rank=None):
    """R replicas of world / R ranks; rank 0 drives ``specs`` through the
    ``ReplicaRouter`` (``drive``), the others follow.  -> every rank: its
    engine's outputs by id and its placement; rank 0 also the mirrors'
    tokens, logprobs and done flags, the replica of each request, the
    ``on_token`` order, the stats and the messages sent."""
    router = ReplicaRouter(group, replica_engine(kind, trees, cfg, engine_kw,
                                                 fail_rank), replicas)
    out = {}
    if group.rank == 0:
        reqs = requests(specs)
        where, order = drive(router, reqs, cancel)
        router.close()
        out.update(tokens=[r.output for r in reqs],
                   logprobs=[r.token_logprobs for r in reqs],
                   done=[r.done for r in reqs], where=where, order=order,
                   stats=router.stats, messages=router.messages)
    else:
        router.follow()
    out.update(_placement(router))
    return out


def _post(port: int, path: str, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, r.read().decode()


def _cut_stream(port: int, prompt: str, n_read: int = 2) -> int:
    """A streamed completion whose client goes away after ``n_read``
    events -> the events read."""
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", "/v1/completions", json.dumps(
        {"prompt": prompt, "max_tokens": 64, "stream": True}),
        {"Content-Type": "application/json"})
    resp = conn.getresponse()
    got = 0
    while got < n_read:
        if resp.fp.readline().decode().startswith("data: "):
            got += 1
    conn.close()
    return got


def replica_http(group, kind: str, trees, cfg, engine_kw, replicas: int,
                 prompts, new: int, heartbeat_s: float):
    """The ApiServer over R replicas on rank 0 (``serve_http``): the
    prompts (token ids as words) as completions at once, the second one
    streamed, beside a stream whose client goes away; then, once idle for
    a few heartbeats, /metrics and the router's stats read together.
    -> every rank: its engine's outputs by id and counters; rank 0 also
    the completions' token ids, the metrics lines and the stats."""
    from micromix_tpu_torch.serve import ApiServer, api
    api.HEARTBEAT_S = heartbeat_s
    router = ReplicaRouter(group, replica_engine(kind, trees, cfg, engine_kw),
                           replicas)
    stop, got = threading.Event(), {}

    def ids(text):
        return [int(w) for w in text.split()]

    def one(i):
        text = " ".join(str(t) for t in prompts[i])
        if i == 1:
            _, raw = _post(srv_port[0], "/v1/completions",
                           {"prompt": text, "max_tokens": new, "stream": True})
            ev = [ln[6:] for ln in raw.splitlines() if ln.startswith("data: ")]
            assert ev[-1] == "[DONE]"
            return ids("".join(json.loads(e)["choices"][0]["text"]
                               for e in ev[:-1]))
        _, body = _post(srv_port[0], "/v1/completions",
                        {"prompt": text, "max_tokens": new})
        return ids(json.loads(body)["choices"][0]["text"])

    srv_port = [None]

    def client(srv):
        try:
            srv_port[0] = srv.port
            with ThreadPoolExecutor(len(prompts) + 1) as ex:
                cut = ex.submit(_cut_stream, srv.port,
                                " ".join(str(t) for t in prompts[0]))
                got["texts"] = list(ex.map(one, range(len(prompts))))
                got["cut_read"] = cut.result()
            time.sleep(4 * heartbeat_s)
            _, metrics = _post(srv.port, "/metrics")
            with srv._lock:
                got["stats"] = router.stats
            got["metrics"] = dict(ln.split(" ", 1)
                                  for ln in metrics.strip().splitlines())
        finally:
            stop.set()

    st = serve_http(router, lambda rt: ApiServer(
        rt, ids, lambda t: " ".join(str(x) for x in t)), stop, on_start=client)
    eng = router.engine
    out = dict(_placement(router), served=st,
               counters={"decode_tokens": eng.decode_tokens,
                         "prefill_tokens": eng.prefill_tokens})
    out.update(got)
    return out
