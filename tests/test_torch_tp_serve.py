"""Port parity: tensor-parallel serving (``parallel/tp_serve.py``, the
engine's ``step_fns`` / ``cache_sharding``) on 2 gloo ranks on the CPU.

* The 2-rank TP engine's greedy tokens against the JAX package's
  ``make_tp_engine`` on conftest's 8 CPU devices (a mesh of 2), on the
  same global tree (JAX's ``quantize_model_tp``, converted), with mixed
  budgets: two short prompts prefilled together (``prefill_batch``) and a
  long one in chunks over the paged history (``prefill_hist``).  The JAX
  step programs are pointed at their TPU branches (flash and paged
  prefill kernels in interpret mode), as the port's prefill runs Kernels
  E's and H's plain versions; its rms sites and final norm take
  tests/jax_rounding.py's barriers.
* At identity calibration with k4-only budgets the shard-local and the
  single-card quantizations are the same weights, segmented and hetero
  alike: the TP engine against the port's single-card engine with a
  repetition penalty, sampling and logprobs, then with prompt-lookup and
  with draft speculation (the draft whole on every rank); the hetero TP
  engine against the single-card hetero engine (the hetero TP forward is
  held against JAX's in tests/test_torch_tp_quant.py).
* Every run: the ranks' token streams equal; a rank's cache holds
  nkv / tp KV heads; two all_reduces a layer and step.

Tolerances: greedy tokens and the ranks' streams equal; logprobs against
the single-card engine within 1e-5 (an f32 sum split over two ranks).
"""

import types

import numpy as np
import pytest

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
from micromix_tpu_torch.convert import from_jax_params
from micromix_tpu_torch.models import surgery as tsurg
from micromix_tpu_torch.models.common import ModelConfig
from micromix_tpu_torch.models.hetero import quantize_model_hetero
from micromix_tpu_torch.parallel import (quantize_model_tp,
                                         quantize_model_tp_hetero, spawn)

TP = 2
# one layer, one weight shape, and prompts that need one chunk over
# history: each JAX step program (unrolled over the layers, one a history
# length) and each weight shape of its eager quantizers compiles for
# seconds to tens of seconds here; the engines held against the single
# card take GQA (two query heads a KV head on each rank)
CFG = dict(arch="llama", vocab_size=256, hidden_size=256,
           intermediate_size=256, num_layers=1, num_heads=4, num_kv_heads=4,
           head_dim=64, rope_theta=10000.0, rms_eps=1e-6)
GQA = dict(CFG, num_layers=2, num_kv_heads=2)
ENGINE = dict(max_seqs=4, page_size=16, max_pages_per_seq=8,
              prefill_buckets=(16, 32), prefill_chunk=16, decode_chunk=2)


def _prompts(seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG["vocab_size"], n).tolist() for n in (9, 14, 27)]


@pytest.fixture
def jax_tp_engine(monkeypatch, jax_rounds_bf16):  # noqa: F811
    """JAX's TP step programs on their TPU branches (the Pallas flash and
    paged prefill kernels, interpret mode on the CPU), with bf16 barriers
    on their rms sites' and final norm's inputs."""
    proxy = types.ModuleType("jax_on_tpu")
    proxy.__getattr__ = lambda name: getattr(jax, name)
    proxy.default_backend = lambda: "tpu"
    monkeypatch.setattr(jtps, "jax", proxy)
    bar = jax.lax.optimization_barrier
    quant, norm = jqops.rmsnorm_quantize_x, jcommon.rmsnorm
    monkeypatch.setattr(jtps, "rmsnorm_quantize_x",
                        lambda x, *a, **kw: quant(bar(x), *a, **kw))
    monkeypatch.setattr(jtps, "rmsnorm", lambda x, g, eps: norm(bar(x), g, eps))

    def run(jtree, jcfg, prompts, new):
        mesh = make_mesh(data=1, model=TP, devices=jax.devices()[:TP])
        eng = jtps.make_tp_engine(jtree, jcfg, mesh, **ENGINE)
        reqs = [JRequest(req_id=i, prompt=list(p), max_new_tokens=new)
                for i, p in enumerate(prompts)]
        return [r.output for r in eng.run(reqs)]
    return run


def test_tp_engine_matches_jax(jax_tp_engine):
    jcfg = jcommon.ModelConfig(**CFG)
    tcfg = ModelConfig(**CFG)
    dense = jsurg.random_dense_params(jcfg, seed=31)
    calibs = jsurg.default_calibration(jcfg, p6=64, p8=64, seed=31)
    jtree = jtpq.quantize_model_tp(dense, jcfg, calibs, TP)
    tree = from_jax_params(jax.tree.map(np.asarray, jtree), tcfg, device="cpu")
    prompts = _prompts()
    ref = jax_tp_engine(jtree, jcfg, prompts, 6)
    specs = [dict(prompt=p, max_new_tokens=6) for p in prompts]
    ranks = spawn(torch_ranks.tp_serve, TP, tree, tcfg,
                  [dict(engine=ENGINE, specs=specs)], device="cpu")
    for r in ranks:
        assert r[0]["tokens"] == ranks[0][0]["tokens"]
        assert r[0]["cache_heads"] == CFG["num_kv_heads"] // TP
    assert ranks[0][0]["tokens"] == ref


def _single_card_runs(hetero: bool, runs_fn):
    """The TP engine (2 ranks) and the single-card engine on one dense GQA
    model at identity calibration with k4-only budgets -> (ranks' results,
    the single card's)."""
    cfg = ModelConfig(**GQA)
    dense = tsurg.random_dense_params(cfg, seed=33, device="cpu")
    calibs = tsurg.default_calibration(cfg)
    if hetero:
        tree = quantize_model_tp_hetero(dense, cfg, calibs, TP)
        single = quantize_model_hetero(dense, cfg, calibs)
    else:
        tree = quantize_model_tp(dense, cfg, calibs, TP)
        single = tsurg.quantize_model(dense, cfg, calibs)
    runs = runs_fn(cfg, single)
    ranks = spawn(torch_ranks.tp_serve, TP, tree, cfg, runs, device="cpu")
    ref = torch_ranks.single_serve(single, cfg, runs)
    for i in range(len(runs)):
        for r in ranks:
            assert r[i]["tokens"] == ranks[0][i]["tokens"], i
            assert r[i]["cache_heads"] == GQA["num_kv_heads"] // TP
        assert ranks[0][i]["tokens"] == ref[i]["tokens"], i
    return ranks, ref


def test_hetero_tp_engine_at_identity_equals_the_single_card():
    prompts = _prompts(9)
    specs = [dict(prompt=p, max_new_tokens=6) for p in prompts]
    ranks, _ = _single_card_runs(True, lambda cfg, single: [
        dict(engine=ENGINE, specs=specs)])
    assert ranks[0][0]["reduces"] >= 2 * GQA["num_layers"] * ranks[0][0]["steps"]


def test_tp_engine_at_identity_equals_the_single_card():
    """Identity calibration, k4-only: the TP engine's tokens and logprobs
    equal the single-card engine's, with the request surface, chunked and
    batched prefill, prompt lookup and a draft model."""
    prompts = _prompts(8)
    specs = [dict(prompt=p, max_new_tokens=6) for p in prompts]
    surface = [dict(specs[0], repetition_penalty=1.3, logprobs=True),
               dict(specs[1], temperature=0.8, top_k=20), specs[2]]
    spec_kw = dict(max_seqs=4, page_size=16, max_pages_per_seq=8,
                   prefill_buckets=(16, 32, 64))
    ranks, ref = _single_card_runs(False, lambda cfg, single: [
        dict(engine=dict(ENGINE, seed=3), specs=surface),
        dict(engine=dict(spec_kw, spec_ngram=2), specs=specs),
        dict(engine=dict(spec_kw, draft_params=single, draft_cfg=cfg),
             specs=specs)])
    np.testing.assert_allclose(ranks[0][0]["logprobs"][0], ref[0]["logprobs"][0],
                               atol=1e-5)
    # two row-parallel sums a layer and decode step
    assert ranks[0][0]["reduces"] >= 2 * GQA["num_layers"] * ranks[0][0]["steps"]
