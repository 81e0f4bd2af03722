"""Port parity: expert-parallel serving (``parallel/moe_ep.py``,
``parallel/ep_serve.py``, ``moe_block``'s expert-parallel branches) on 2
gloo ranks on the CPU, against the JAX package on conftest's 8 CPU
devices (a mesh of 2).

* The 2-rank EP engine's greedy tokens against JAX's ``make_ep_engine``
  on the same tree (JAX's ``quantize_model_ep``, converted: its
  ``experts_grouped_ep``), under dense and under capacity dispatch, with
  batched prefill and a prompt in chunks over the paged history.  JAX's
  runner is pointed at its TPU branches (flash and paged prefill kernels
  in interpret mode) and takes tests/jax_rounding.py's barriers.
* ``ep_moe_forward``, ``_quant`` and ``_hetero`` on 2 ranks against JAX's
  on the mesh: dense experts, segmented experts of one budget, hetero
  experts of four budgets.
* ``stack_layer_experts`` groups canonical ScaledW8 experts
  (``experts_grouped_ep``) and stacks hetero ones (``experts_stacked``);
  the EP engine on the stacked hetero experts equals the single-card
  hetero engine on the same weights (the same weights and sites; only
  the f32 expert sum is split over the ranks).
* Every run: the ranks' token streams equal; one all_reduce a MoE block.

Tolerances: greedy tokens equal; the MoE blocks' outputs within 2% of
max |ref| (bf16 outputs of f32 sums in another order, and the rms of the
routed input, whose rsqrt's last bit differs between XLA and the port).
"""

import dataclasses
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import torch_ranks
from jax_rounding import jax_rounds_bf16  # noqa: F401 (fixture)
from port_threads import one_torch_thread  # noqa: F401 (autouse)

from micromix_tpu.models import common as jcommon
from micromix_tpu.models import hetero as jhet
from micromix_tpu.models import surgery as jsurg
from micromix_tpu.parallel import ep_serve as jeps
from micromix_tpu.parallel import make_mesh
from micromix_tpu.parallel import moe_ep as jmoe
from micromix_tpu.serve import Request as JRequest
from micromix_tpu.serve import runner as jrunner
from micromix_tpu_torch.convert import from_jax_params
from micromix_tpu_torch.models import hetero as thet
from micromix_tpu_torch.models import surgery as tsurg
from micromix_tpu_torch.models.common import ModelConfig
from micromix_tpu_torch.parallel import (spawn, stack_dense_experts,
                                         stack_hetero_experts,
                                         stack_layer_experts,
                                         stack_quant_experts)

EP = 2
CFG = dict(arch="mixtral", vocab_size=256, hidden_size=256,
           intermediate_size=256, num_layers=1, num_heads=4, num_kv_heads=4,
           head_dim=64, rope_theta=10000.0, rms_eps=1e-6, num_experts=4,
           num_experts_per_tok=2)
ENGINE = dict(max_seqs=4, page_size=16, max_pages_per_seq=8,
              prefill_buckets=(16, 32), prefill_chunk=16, decode_chunk=2)
# hetero experts' (p6, p8): four budgets
HETERO_BUDGETS = ((0, 0), (64, 0), (0, 64), (64, 64))


def _prompts(seed=11):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG["vocab_size"], n).tolist() for n in (9, 14, 27)]


@pytest.fixture
def jax_tpu_runner(monkeypatch, jax_rounds_bf16):  # noqa: F811
    proxy = types.ModuleType("jax_on_tpu")
    proxy.__getattr__ = lambda name: getattr(jax, name)
    proxy.default_backend = lambda: "tpu"
    monkeypatch.setattr(jrunner, "jax", proxy)
    monkeypatch.setattr(jrunner, "_can_pair", lambda *a: False)


@pytest.mark.parametrize("capacity", [None, 1.5], ids=["dense", "capacity"])
def test_ep_engine_matches_jax(jax_tpu_runner, capacity):
    jcfg = jcommon.ModelConfig(**dict(CFG, moe_capacity_factor=capacity))
    tcfg = ModelConfig(**dict(CFG, moe_capacity_factor=capacity))
    dense = jsurg.random_dense_params(jcfg, seed=41)
    calibs = jsurg.default_calibration(jcfg, p6=64, p8=64, seed=41)
    jtree = jeps.quantize_model_ep(dense, jcfg, calibs)
    tree = from_jax_params(jax.tree.map(np.asarray, jtree), tcfg, device="cpu")
    assert "experts_grouped_ep" in tree["layers"][0]
    prompts = _prompts()
    mesh = make_mesh(expert=EP, devices=jax.devices()[:EP])
    eng = jeps.make_ep_engine(jtree, jcfg, mesh, **ENGINE)
    ref = [r.output for r in eng.run(
        [JRequest(req_id=i, prompt=list(p), max_new_tokens=6)
         for i, p in enumerate(prompts)])]
    specs = [dict(prompt=p, max_new_tokens=6) for p in prompts]
    ranks = spawn(torch_ranks.ep_serve, EP, tree, tcfg,
                  [dict(engine=ENGINE, specs=specs)], device="cpu",
                  axis="expert")
    assert ranks[0][0]["tokens"] == ranks[1][0]["tokens"]
    assert ranks[0][0]["tokens"] == ref


def _close(got, ref):
    ref = np.asarray(ref, np.float32)
    err = np.abs(got - ref).max()
    assert err <= 0.02 * np.abs(ref).max(), (err, np.abs(ref).max())


def _jitted(fn, jcfg, mesh):
    """JAX's ep_moe_forward* under one jit (op by op, its shard_map runs
    each expert's ops eagerly: minutes here); the budgets of a segmented
    stack stay static."""
    def run(x, ln2, router_w, stacked):
        statics = {k: v for k, v in stacked.items() if k.startswith("splits")}
        arrays = {k: v for k, v in stacked.items() if k not in statics}
        f = jax.jit(lambda x, ln2, rw, arr: fn(
            x, ln2, jcommon.DenseLinear(w=rw), {**arr, **statics}, jcfg, mesh))
        return f(x, ln2, router_w, arrays)
    return run


def test_ep_moe_forwards_match_jax(rng):
    """The three stacked forms' MoE blocks, experts split over 2 ranks."""
    jcfg = jcommon.ModelConfig(**CFG)
    tcfg = ModelConfig(**CFG)
    jd = jsurg.random_dense_params(jcfg, seed=43)
    td = tsurg.random_dense_params(tcfg, seed=43, device="cpu")
    jq = jsurg.quantize_model(jd, jcfg, jsurg.default_calibration(
        jcfg, p6=64, p8=64, seed=43))
    tq = tsurg.quantize_model(td, tcfg, tsurg.default_calibration(
        tcfg, p6=64, p8=64, seed=43))
    jcal = jsurg.default_calibration(jcfg, seed=44)
    tcal = tsurg.default_calibration(tcfg, seed=44)
    for e, (p6, p8) in enumerate(HETERO_BUDGETS):
        for cal in (jcal, tcal):
            for site in ("mlp_in", "down_in"):
                c = cal[0][f"expert{e}_{site}"]
                cal[0][f"expert{e}_{site}"] = dataclasses.replace(
                    c, p6_num=p6, p8_num=p8)
    jh = jhet.quantize_model_hetero(jd, jcfg, jcal)
    th = thet.quantize_model_hetero(td, tcfg, tcal)
    x = rng.normal(0, 1, (8, CFG["hidden_size"])).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = torch.from_numpy(np.asarray(jx.astype(jnp.float32))).to(torch.bfloat16)
    mesh = make_mesh(expert=EP, devices=jax.devices()[:EP])
    refs, cases = [], []
    for kind, jl, tl, jstack, tstack, jfn in (
            ("dense", jd, td, jmoe.stack_dense_experts, stack_dense_experts,
             jmoe.ep_moe_forward),
            ("quant", jq, tq, jmoe.stack_quant_experts, stack_quant_experts,
             jmoe.ep_moe_forward_quant),
            ("hetero", jh, th, jmoe.stack_hetero_experts, stack_hetero_experts,
             jmoe.ep_moe_forward_hetero)):
        jlayer, tlayer = jl["layers"][0], tl["layers"][0]
        refs.append(_jitted(jfn, jcfg, mesh)(jx, jlayer["ln2"],
                                             jlayer["router"].w,
                                             jstack(jlayer["experts"])))
        cases.append((kind, tx, tlayer["ln2"], tlayer["router"],
                      tstack(tlayer["experts"]), tcfg))
    ranks = spawn(torch_ranks.ep_forwards, EP, cases, device="cpu",
                  axis="expert")
    for i, ref in enumerate(refs):
        assert np.array_equal(ranks[0][i], ranks[1][i])
        _close(ranks[0][i], ref)


def test_stacked_hetero_experts_serve_as_the_single_card():
    """Canonical ScaledW8 experts group, hetero ones stack; the EP engine
    over stacked hetero experts of four budgets (dense and capacity
    dispatch) equals the single-card hetero engine."""
    cfg = ModelConfig(**dict(CFG, num_layers=2, num_kv_heads=2))
    dense = tsurg.random_dense_params(cfg, seed=45, device="cpu")
    cal = tsurg.default_calibration(cfg, seed=45)
    for layer in cal:
        for e, (p6, p8) in enumerate(HETERO_BUDGETS):
            for site in ("mlp_in", "down_in"):
                c = layer[f"expert{e}_{site}"]
                layer[f"expert{e}_{site}"] = dataclasses.replace(
                    c, p6_num=p6, p8_num=p8)
    seg = tsurg.quantize_model(dense, cfg, tsurg.default_calibration(
        cfg, p6=64, p8=64, seed=45))
    assert "experts_grouped_ep" in stack_layer_experts(seg["layers"][0])
    het = thet.quantize_model_hetero(dense, cfg, cal)
    layers = [stack_layer_experts(p) for p in het["layers"]]
    assert all("experts_stacked" in p and "experts" not in p for p in layers)
    tree = dict(het, layers=layers)
    specs = [dict(prompt=p, max_new_tokens=6) for p in _prompts(12)]
    ccfg = dataclasses.replace(cfg, moe_capacity_factor=1.5)
    runs = [dict(engine=ENGINE, specs=specs),
            dict(cfg=ccfg, engine=ENGINE, specs=specs)]
    ranks = spawn(torch_ranks.ep_serve, EP, tree, cfg, runs, device="cpu",
                  axis="expert")
    ref = (torch_ranks.single_serve(het, cfg, runs[:1])
           + torch_ranks.single_serve(het, ccfg, runs[1:]))
    for i in range(len(runs)):
        assert ranks[0][i]["tokens"] == ranks[1][i]["tokens"], i
        assert ranks[0][i]["tokens"] == ref[i]["tokens"], i
        # one sum a MoE block: every layer of every step at least
        assert ranks[0][i]["reduces"] >= cfg.num_layers * ranks[0][i]["steps"]
