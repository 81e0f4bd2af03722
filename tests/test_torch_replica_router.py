"""The port's router over replicas of ranks (``parallel/replicas.py``,
``parallel/api_ranks.serve_http``), on gloo ranks on the CPU, held
against the port alone (``test_torch_replicas.py`` holds it against the
JAX package's ``Router`` over TP engines):

* R=2 x P=1 (plain engines, one rank each) against the in-process
  ``Router`` over two engines on the same trees: the same replica for
  each request, the same tokens, logprobs, stats and ``on_token`` order
  on rank 0, with a cancel after two steps of a request on replica 1;
* R=2 x tp=2 and R=2 x ep=2 (4 ranks): each replica's tokens equal to a
  lone tp=2 / ep=2 engine that runs the same requests in the same order;
  the ranks of a replica emit the same tokens; replica r is global ranks
  2r, 2r+1, on subgroups of the backend ``pick_backend`` names;
* the ``ApiServer`` over R=2 x tp=2: completions (one streamed, beside a
  stream whose client goes away) equal to a lone engine's run of each
  prompt (one slot a replica and the same tree in both, so a request
  decodes alone wherever it lands, as in a lone tp=2 engine's run of it), ``/metrics`` equal to the summed
  ``stats`` and to the leaders' own counters, heartbeats while idle;
* a rank whose step raises makes ``spawn`` raise, with no hang; a router
  that raises ends the ``ApiServer``'s scheduler (503, ``close`` raises),
  and every waiter queued by then is released.

Tolerances: none; tokens, logprobs and counts are exact.
"""

import dataclasses

import numpy as np
import pytest

import torch_ranks
from port_threads import one_torch_thread  # noqa: F401 (autouse)

from micromix_tpu_torch.models import surgery as tsurg
from micromix_tpu_torch.models.common import ModelConfig
from micromix_tpu_torch.parallel import (quantize_model_ep, quantize_model_tp,
                                         spawn)
from micromix_tpu_torch.serve import Engine, Router

CFG = ModelConfig(arch="llama", vocab_size=256, hidden_size=256,
                  intermediate_size=256, num_layers=1, num_heads=4,
                  num_kv_heads=2, head_dim=64, rope_theta=10000.0,
                  rms_eps=1e-6)
MOE = dataclasses.replace(CFG, arch="mixtral", num_experts=4,
                          num_experts_per_tok=2)
ENGINE = dict(max_seqs=2, page_size=16, max_pages_per_seq=8,
              prefill_buckets=(16,), decode_chunk=2)


def _trees(kind, cfg, seeds):
    """One global quantized tree a replica ("single": the one-card form,
    "tp" / "ep": the TP / EP form for 2 ranks), each from its own seed."""
    quant = {"single": tsurg.quantize_model, "ep": quantize_model_ep,
             "tp": lambda d, c, cal: quantize_model_tp(d, c, cal, 2)}[kind]
    return [quant(tsurg.random_dense_params(cfg, seed=s, device="cpu"), cfg,
                  tsurg.default_calibration(cfg)) for s in seeds]


def _specs(n=6, seed=5, **kw):
    """``__graft_entry__``'s uneven requests: prompt 5 + i tokens,
    3 + (i % 3) new."""
    rng = np.random.default_rng(seed)
    return [dict(prompt=rng.integers(0, CFG.vocab_size, 5 + i).tolist(),
                 max_new_tokens=3 + (i % 3), **kw) for i in range(n)]


def _check_replicas(ranks, replicas, size):
    """Placement and lockstep: replica r is global ranks r*size..., each
    rank's subgroup on the world's backend, the ranks of a replica
    emitting the same tokens."""
    for g, r in enumerate(ranks):
        assert r["replica"] == g // size
        assert r["local"] == [g % size, size]
        if replicas > 1:
            rep = g // size
            assert r["members"] == tuple(range(rep * size, (rep + 1) * size))
            assert r["subgroup_backend"] == r["backend"] == "gloo"
        assert r["outputs"] == ranks[g - g % size]["outputs"]


def test_single_rank_replicas_equal_the_in_process_router():
    trees = _trees("single", CFG, (20, 21))
    specs = _specs(logprobs=True)
    cancel = (2, 5)
    ranks = spawn(torch_ranks.replica_serve, 2, "single", trees, CFG, ENGINE,
                  specs, 2, cancel, device="cpu")
    _check_replicas(ranks, 2, 1)
    router = Router([Engine(t, CFG, device="cpu", **ENGINE) for t in trees])
    reqs = torch_ranks.requests(specs)
    where, order = torch_ranks.drive(router, reqs, cancel)
    got = ranks[0]
    assert where[cancel[1]] == 1 and got["where"] == where
    assert got["tokens"] == [r.output for r in reqs]
    assert got["logprobs"] == [r.token_logprobs for r in reqs]
    assert got["done"] == [True] * len(reqs)
    assert got["order"] == order
    assert got["stats"] == router.stats
    # the cancelled request stopped on its replica at the next boundary
    assert len(reqs[cancel[1]].output) < reqs[cancel[1]].max_new_tokens
    assert ranks[1]["outputs"][cancel[1]][:len(reqs[cancel[1]].output)] \
        == reqs[cancel[1]].output


@pytest.mark.parametrize("kind", ["tp", "ep"])
def test_multi_rank_replicas_equal_lone_engines(kind):
    cfg = CFG if kind == "tp" else MOE
    trees = _trees(kind, cfg, (20, 21))
    specs = _specs()
    ranks = spawn(torch_ranks.replica_serve, 4, kind, trees, cfg, ENGINE,
                  specs, 2, device="cpu")
    _check_replicas(ranks, 2, 2)
    where = ranks[0]["where"]
    assert sorted(set(where)) == [0, 1]
    # the host's rule: least queued work, ties to the lowest index (every
    # request is submitted before the first step)
    loads, rule = [0, 0], []
    for s in specs:
        rule.append(loads.index(min(loads)))
        loads[rule[-1]] += len(s["prompt"]) + s["max_new_tokens"]
    assert where == rule
    fn = torch_ranks.tp_serve if kind == "tp" else torch_ranks.ep_serve
    for rep in (0, 1):
        mine = [i for i, w in enumerate(where) if w == rep]
        lone = spawn(fn, 2, trees[rep], cfg,
                     [dict(engine=ENGINE, specs=[specs[i] for i in mine])],
                     device="cpu", axis="expert" if kind == "ep" else "model")
        assert [ranks[0]["tokens"][i] for i in mine] == lone[0][0]["tokens"]
        assert [ranks[2 * rep]["outputs"][i] for i in mine] \
            == lone[0][0]["tokens"]


def test_api_server_over_replicas():
    tree = _trees("tp", CFG, (22,))[0]
    prompts = [s["prompt"] for s in _specs(5, seed=9)]
    new = 6
    kw = dict(ENGINE, max_seqs=1)
    ranks = spawn(torch_ranks.replica_http, 4, "tp", [tree, tree], CFG, kw, 2,
                  prompts, new, 0.2, device="cpu")
    _check_replicas(ranks, 2, 2)
    lone = spawn(torch_ranks.tp_serve, 2, tree, CFG,
                 [dict(engine=kw, specs=[dict(prompt=p, max_new_tokens=new)])
                  for p in prompts], device="cpu")
    ref = [run["tokens"][0] for run in lone[0]]
    got = ranks[0]
    assert got["texts"] == ref and got["cut_read"] == 2
    m, st = got["metrics"], got["stats"]
    assert int(m["micromix_requests_total"]) == len(prompts) + 1
    assert int(m["micromix_decode_tokens_total"]) == sum(st["decode_tokens"])
    assert int(m["micromix_prefill_tokens_total"]) == sum(st["prefill_tokens"])
    assert int(m["micromix_ttft_seconds_count"]) == len(prompts) + 1
    for key in ("decode_tokens", "prefill_tokens"):
        assert st[key] == [ranks[0]["counters"][key], ranks[2]["counters"][key]]
    assert sum(st["assigned"]) == len(prompts) + 1
    # the stream whose client went away was cancelled on its replica
    assert sum(len(o) for r in (0, 2) for o in ranks[r]["outputs"].values()) \
        < (len(prompts) + 1) * 64
    assert got["served"]["requests"] == len(prompts) + 1
    # steps, the stop and a few idle heartbeats
    assert all(r["served"]["messages"] == got["served"]["messages"]
               for r in ranks)


def test_a_failing_rank_fails_the_run():
    trees = _trees("tp", CFG, (20, 21))
    with pytest.raises(RuntimeError, match="rank [0-3] of 4 raised"):
        spawn(torch_ranks.replica_serve, 4, "tp", trees, CFG, ENGINE,
              _specs(), 2, None, 3, device="cpu")


def test_api_server_fails_when_its_router_fails():
    """A router call that raises (a rank died) ends the scheduler: the
    waiting completion gets 503 and ``close`` raises the error."""
    import json
    import urllib.error
    import urllib.request
    from micromix_tpu_torch.serve import ApiServer

    class Broken(Router):
        def step(self):
            raise RuntimeError("a rank died")

    tree = _trees("single", CFG, (20,))[0]
    srv = ApiServer(Broken([Engine(tree, CFG, device="cpu", **ENGINE)]),
                    lambda s: [int(w) for w in s.split()],
                    lambda ids: " ".join(map(str, ids)))
    srv.start()
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}/v1/completions",
        data=json.dumps({"prompt": "1 2 3", "max_tokens": 2}).encode(),
        headers={"Content-Type": "application/json"})
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(req, timeout=60)
    assert err.value.code == 503
    with pytest.raises(RuntimeError, match="scheduler failed"):
        srv.close()


def test_a_failed_server_releases_every_queued_waiter():
    """Once the scheduler has failed, ``submit`` releases its own waiter
    and any other handler's still queued (one that checked ``error``
    before the scheduler set it), streamed ones with their sentinel."""
    from micromix_tpu_torch.serve import ApiServer

    tree = _trees("single", CFG, (20,))[0]
    srv = ApiServer(Router([Engine(tree, CFG, device="cpu", **ENGINE)]),
                    lambda s: [int(w) for w in s.split()],
                    lambda ids: " ".join(map(str, ids)))
    try:
        body = {"prompt": "1 2 3", "max_tokens": 2}
        other = srv._build_request(dict(body, stream=True), streaming=True)
        srv._submit_q.put(other)
        srv.error = RuntimeError("a rank died")
        mine = srv._build_request(body, streaming=False)
        srv.submit(mine)
        assert mine.done.is_set() and other.done.is_set()
        assert other.tokens.get_nowait() is None
        assert srv._submit_q.empty()
    finally:
        srv._httpd.server_close()
