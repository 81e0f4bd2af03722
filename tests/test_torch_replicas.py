"""Port parity: the router over replicas of tensor-parallel ranks
(``parallel/replicas.py``) against the JAX package's ``Router`` over two
``make_tp_engine`` replicas on disjoint meshes (conftest's CPU devices
[0:2] and [2:4]), as ``__graft_entry__.dryrun_multichip`` builds them:
one replica a seed, ``quantize_model_tp`` calibrated with p6 = p8 = 64
(mixed budgets), the same global trees fed to the port through
``convert.from_jax_params``; the port runs R=2 replicas of tp=2 on 4 gloo
ranks.  Six uneven requests (prompt 5 + i tokens, 3 + (i % 3) new) over
two slots a replica: least-load assignment, queues, draining.

JAX's step programs are pointed at their TPU branches (flash and paged
prefill kernels in interpret mode) and take tests/jax_rounding.py's
barriers, as in ``test_torch_tp_serve.py``.

Tolerances: none; ``assigned`` and every request's tokens are equal.
"""

import types

import numpy as np

import jax

import torch_ranks
from jax_rounding import jax_rounds_bf16  # noqa: F401 (fixture)
from port_threads import one_torch_thread  # noqa: F401 (autouse)

from micromix_tpu.models import common as jcommon
from micromix_tpu.models import surgery as jsurg
from micromix_tpu.ops import quantize_ops as jqops
from micromix_tpu.parallel import make_mesh
from micromix_tpu.parallel import tp_quant as jtpq
from micromix_tpu.parallel import tp_serve as jtps
from micromix_tpu.serve import Request as JRequest
from micromix_tpu.serve.router import Router as JRouter
from micromix_tpu_torch.convert import from_jax_params
from micromix_tpu_torch.models.common import ModelConfig
from micromix_tpu_torch.parallel import spawn

TP, REPLICAS = 2, 2
CFG = dict(arch="llama", vocab_size=256, hidden_size=256,
           intermediate_size=256, num_layers=1, num_heads=4, num_kv_heads=2,
           head_dim=64, rope_theta=10000.0, rms_eps=1e-6)
ENGINE = dict(max_seqs=2, page_size=16, max_pages_per_seq=8,
              prefill_buckets=(16,), decode_chunk=2)


def test_tp_replicas_match_jax_router(monkeypatch, jax_rounds_bf16):  # noqa: F811
    proxy = types.ModuleType("jax_on_tpu")
    proxy.__getattr__ = lambda name: getattr(jax, name)
    proxy.default_backend = lambda: "tpu"
    monkeypatch.setattr(jtps, "jax", proxy)
    bar = jax.lax.optimization_barrier
    quant, norm = jqops.rmsnorm_quantize_x, jcommon.rmsnorm
    monkeypatch.setattr(jtps, "rmsnorm_quantize_x",
                        lambda x, *a, **kw: quant(bar(x), *a, **kw))
    monkeypatch.setattr(jtps, "rmsnorm", lambda x, g, eps: norm(bar(x), g, eps))

    jcfg, tcfg = jcommon.ModelConfig(**CFG), ModelConfig(**CFG)
    calibs = jsurg.default_calibration(jcfg, p6=64, p8=64, seed=31)
    jtrees = [jtpq.quantize_model_tp(jsurg.random_dense_params(jcfg, seed=20 + r),
                                     jcfg, calibs, TP) for r in range(REPLICAS)]
    devices = jax.devices()
    engines = []
    for r, jtree in enumerate(jtrees):
        mesh = make_mesh(data=1, model=TP,
                         devices=devices[r * TP:(r + 1) * TP])
        engines.append(jtps.make_tp_engine(jtree, jcfg, mesh, **ENGINE))
    # placement: each replica's weights live only on its own mesh
    for r, eng in enumerate(engines):
        leaf = jax.tree_util.tree_leaves(eng.params)[0]
        assert set(leaf.devices()) <= set(devices[r * TP:(r + 1) * TP])
    rng = np.random.default_rng(5)
    specs = [dict(prompt=rng.integers(0, CFG["vocab_size"], 5 + i).tolist(),
                  max_new_tokens=3 + (i % 3)) for i in range(6)]
    router = JRouter(engines)
    reqs = router.run([JRequest(req_id=i, prompt=list(s["prompt"]),
                                max_new_tokens=s["max_new_tokens"])
                       for i, s in enumerate(specs)])
    assert all(r.done and len(r.output) == r.max_new_tokens for r in reqs)

    trees = [from_jax_params(jax.tree.map(np.asarray, t), tcfg, device="cpu")
             for t in jtrees]
    ranks = spawn(torch_ranks.replica_serve, REPLICAS * TP, "tp", trees, tcfg,
                  ENGINE, specs, REPLICAS, device="cpu")
    got = ranks[0]
    assert [got["where"].count(r) for r in range(REPLICAS)] \
        == router.stats["assigned"]
    assert got["stats"]["assigned"] == router.stats["assigned"]
    assert got["tokens"] == [r.output for r in reqs]
    for g, r in enumerate(ranks):
        assert r["replica"] == g // TP and r["outputs"] == ranks[g - g % TP]["outputs"]
