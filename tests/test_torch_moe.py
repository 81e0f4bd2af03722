"""Port parity for the Mixtral path: ``GroupedW8`` and its grouping, the
grouped expert GEMM (Kernel I's function), capacity dispatch, the MoE
block (grouped and per-expert, dense and capacity dispatch), Mixtral
surgery and conversion, and prefill + greedy decode through the runner,
held against the JAX package on the CPU at small widths (hidden 256,
intermediate 512, 4 experts, top-2).

The JAX grouped kernel runs in interpret mode, as its own tests run it;
the port's wrappers get CPU tensors and run their plain versions.

Tolerances:
  * grouped codes, bases, padding, site permutations, routing slots and
    gates, dense weights: bit-exact (integer and copy arithmetic, the same
    f32 operations);
  * grouped GEMM outputs behind a plain site: the images are bit-exact,
    the products the same exact bf16 operands summed in f32 in another
    order, one bf16 rounding: |diff| <= 2^-7 |ref| + 2^-8 max|ref|;
  * behind the silu site: the images within the RNE tie band (at most 1
    element in 1000, one grid step of its 32-block: the sigmoid's last
    bit), the outputs then as the JAX package's band for a flipped tie
    (rtol 0.05, atol 1.0, median |diff| <= 0.25);
  * the port's grouped form against its own per-expert loop: bit-exact
    (the same plain products; the combine adds at most top-k non-zero
    terms onto zeros, in any order the same f32 sum);
  * moe_block against the JAX moe_block: measured bit-exact at these
    sizes; held to the GEMM band above (its last step is a bf16 rounding
    of f32 sums taken in another order);
  * prefill + greedy decode: equal greedy tokens.
"""

import dataclasses
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from port_threads import one_torch_thread  # noqa: F401 (autouse)

from micromix_tpu.kernels.fakequant import fakequant_site_pallas
from micromix_tpu.kernels.mixed_matmul import \
    mixed_matmul_w8_grouped as j_grouped
from micromix_tpu.models import ModelConfig as JModelConfig
from micromix_tpu.models import surgery as jsurg
from micromix_tpu.models import transformer as jtr
from micromix_tpu.mx import layout as jlay
from micromix_tpu.mx.scaledw8 import ScaledW8 as JScaledW8
from micromix_tpu.mx.scaledw8 import group_scaled_w8 as j_group_w8
from micromix_tpu.ops.quantize_ops import fakequant_device as j_fakequant_device
from micromix_tpu.serve import kv_cache as jkv
from micromix_tpu.serve import runner as jrunner
from micromix_tpu_torch.convert import from_jax_params, grouped_from_jax
from micromix_tpu_torch.kernels.fakequant import fakequant_site
from micromix_tpu_torch.kernels.mixed_matmul import (
    mixed_matmul_w8_grouped, mixed_matmul_w8_grouped_plain,
    mixed_matmul_w8_site, w8_grouped_gemm)
from micromix_tpu_torch.models import surgery as tsurg
from micromix_tpu_torch.models import transformer as ttr
from micromix_tpu_torch.models.common import DenseLinear, ModelConfig
from micromix_tpu_torch.mx.mxtensor import quantize_mixed
from micromix_tpu_torch.mx.scaledw8 import (dequantize_grouped, group_scaled_w8,
                                            grouped_section, pack_scaled_w8)
from micromix_tpu_torch.serve import kv_cache as tkv
from micromix_tpu_torch.serve import runner as trunner

K4, K6, K8 = 256, 128, 128
K = K4 + K6 + K8


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.array(jnp.asarray(a).astype(jnp.float32))


def _bf16_pair(x: np.ndarray):
    j = jnp.asarray(x, jnp.bfloat16)
    return j, torch.from_numpy(_f32(j)).to(torch.bfloat16)


def _assert_gemm_close(got, ref):
    np.testing.assert_allclose(got, ref, rtol=2.0 ** -7,
                               atol=2.0 ** -8 * float(np.abs(ref).max()))


def _assert_tie_band(got, ref, splits):
    diff = got != ref
    assert diff.mean() <= 1e-3, f"{int(diff.sum())} of {diff.size} differ"
    off = 0
    for kseg, mant in zip(splits, (1, 2, 3)):
        g = got[:, off:off + kseg].reshape(got.shape[0], 32, -1)
        r = ref[:, off:off + kseg].reshape(ref.shape[0], 32, -1)
        bmax = np.maximum(np.abs(g).max(axis=1), np.abs(r).max(axis=1))
        step = np.exp2(np.floor(np.log2(np.maximum(bmax, 1e-30))) - mant)
        assert (np.abs(g - r) <= step[:, None, :]).all()
        off += kseg


def _mixtral_cfg(**kw):
    base = dict(arch="mixtral", vocab_size=256, hidden_size=256,
                intermediate_size=512, num_layers=1, num_heads=4,
                num_kv_heads=2, head_dim=64, rope_theta=1e6, rms_eps=1e-5,
                num_experts=4, num_experts_per_tok=2)
    base.update(kw)
    jcfg = JModelConfig(**base)
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


def _quantized(jcfg, seed=1):
    return jsurg.quantize_model(
        jsurg.random_dense_params(jcfg, seed=seed), jcfg,
        jsurg.default_calibration(jcfg, p6=64, p8=64, seed=seed), host=True)


def _grouped_weights(rng, e, ns, k=K, splits=(K4, K6, K8)):
    """[section][expert] random weights as a JAX GroupedW8 and the port's
    per-section lists of ScaledW8 (made by the port's quantizer, whose
    codes equal the JAX package's: tests/test_torch_model.py)."""
    jstacked, tsecs = [], []
    for n in ns:
        tws = [pack_scaled_w8(quantize_mixed(
            torch.from_numpy(rng.normal(0, 0.3, (n, k)).astype(np.float32)),
            *splits, weight_fp4_only=True)) for _ in range(e)]
        jstacked.append(JScaledW8(
            codes=jnp.asarray(np.stack([w.codes.numpy() for w in tws])),
            base=jnp.asarray([w.base for w in tws], jnp.int32),
            k4=splits[0], k6=splits[1], k8=splits[2]))
        tsecs.append(tws)
    return j_group_w8(jstacked), tsecs


def test_group_scaled_w8_bit_exact(rng):
    """Codes, bases, sections, padding (sections of 200 and 120 rows: the
    strip falls to 128 and both pad) and the whole-group decode."""
    jgw, tsecs = _grouped_weights(rng, 3, (200, 120))
    tgw = group_scaled_w8(tsecs)
    assert tgw.sections == tuple(jgw.sections) == (200, 120)
    assert tgw.padded == tuple(jgw.padded) == (256, 128)
    np.testing.assert_array_equal(tgw.codes.numpy(), np.asarray(jgw.codes))
    assert np.array_equal(np.array(tgw.bases), np.asarray(jgw.bases))
    carried = grouped_from_jax(jax.tree.map(np.asarray, jgw), "cpu")
    assert torch.equal(carried.codes, tgw.codes) and carried.bases == tgw.bases
    np.testing.assert_array_equal(
        _f32(dequantize_grouped(tgw)), _f32(jtr._grouped_weights_bf16(jgw)))
    assert torch.equal(grouped_section(tgw, 2, 1).codes, tsecs[1][2].codes)


@pytest.mark.parametrize("producer", ["plain", "silu"])
def test_grouped_plain_matches_pallas(rng, producer):
    """mixed_matmul_w8_grouped (the plain version, on CPU tensors) against
    the JAX grouped kernel in interpret mode, 3 experts of 5 rows (ragged);
    plain: sections 256|128 behind each expert's own permutation, silu: one
    section of 256 behind the silu site.  Also against the port's own
    per-expert loop of mixed_matmul_w8_site, bit for bit."""
    e, c = 3, 5
    ns = (256, 128) if producer == "plain" else (256,)
    jgw, tsecs = _grouped_weights(rng, e, ns)
    tgw = group_scaled_w8(tsecs)
    jx, tx = _bf16_pair(rng.normal(0, 1, (e, c, K)).astype(np.float32))
    jkw, tkw = {}, {}
    if producer == "plain":
        perm = np.stack([jlay.compose_segmented(
            rng.permutation(K).astype(np.int32), K4, K6, K8) for _ in range(e)])
        jx = jnp.stack([jnp.take(jx[i], jnp.asarray(perm[i]), axis=1)
                        for i in range(e)])
        tkw["perm"] = torch.from_numpy(perm)
    else:
        ju, tu = _bf16_pair(rng.normal(0, 0.25, (e, c, K)).astype(np.float32))
        jkw = dict(producer="silu", up=ju)
        tkw = dict(producer="silu", up=tu)
    ref = [_f32(r) for r in j_grouped(jx, jgw, interpret=True, **jkw)]
    got = [_f32(g) for g in mixed_matmul_w8_grouped(tx, tgw, **tkw)]
    assert [g.shape for g in got] == [(e, c, n) for n in ns]
    plain = mixed_matmul_w8_grouped_plain(tx, tgw, **tkw)
    for g, p in zip(got, plain):
        np.testing.assert_array_equal(g, _f32(p))
    # the per-expert images: plain bit-exact, silu within the tie band
    for i in range(e):
        if producer == "plain":
            jimg = _f32(j_fakequant_device(jx[i].astype(jnp.float32), K4, K6, K8))
            timg = _f32(fakequant_site(tx[i], K4, K6, K8, perm=tkw["perm"][i]))
            np.testing.assert_array_equal(timg, jimg)
        else:
            jimg = _f32(fakequant_site_pallas(jx[i], K4, K6, K8, producer="silu",
                                              up=jkw["up"][i], interpret=True))
            timg = _f32(fakequant_site(tx[i], K4, K6, K8, producer="silu",
                                       up=tkw["up"][i]))
            _assert_tie_band(timg, jimg, (K4, K6, K8))
        # on the JAX image the grouped GEMM is within the GEMM band
        on_img = w8_grouped_gemm(
            torch.from_numpy(np.repeat(jimg[None], e, 0)).to(torch.bfloat16), tgw)
        for si, r in enumerate(ref):
            _assert_gemm_close(_f32(on_img[si][i]), r[i])
        # the port's grouped call is its per-expert loop, bit for bit
        skw = ({"perm": tkw["perm"][i]} if producer == "plain"
               else dict(producer="silu", up=tkw["up"][i]))
        for si in range(len(ns)):
            want = mixed_matmul_w8_site(tx[i], tsecs[si][i], **skw)
            np.testing.assert_array_equal(got[si][i], _f32(want))
    for g, r in zip(got, ref):
        if producer == "plain":
            _assert_gemm_close(g, r)
        else:
            np.testing.assert_allclose(g, r, rtol=0.05, atol=1.0)
            assert np.median(np.abs(g - r)) <= 0.25


@pytest.mark.parametrize("t,factor", [(12, 2.0), (40, 1.0), (7, 1.5), (64, 1.25)])
def test_capacity_dispatch_matches_jax(t, factor):
    """Slots and gates from top-2 routing weights with drops (tokens beyond
    an expert's capacity) and the capacity itself."""
    jcfg, tcfg = _mixtral_cfg(moe_capacity_factor=factor)
    rng = np.random.default_rng(t)
    e = jcfg.num_experts
    probs = rng.dirichlet(np.ones(e), t).astype(np.float32)
    top = np.argsort(-probs, axis=1, kind="stable")[:, :2]
    w = np.zeros_like(probs)
    np.put_along_axis(w, top, np.take_along_axis(probs, top, 1), 1)
    cap = ttr.moe_capacity(tcfg, t)
    assert cap == jtr.moe_capacity(jcfg, t)
    jidx, jgate = jtr.capacity_dispatch(jnp.asarray(w), cap)
    tidx, tgate = ttr.capacity_dispatch(torch.from_numpy(w), cap)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(tgate.numpy(), np.asarray(jgate))


def test_router_ties_go_to_the_lower_expert():
    """Equal router probabilities: jax.lax.top_k's order (lower index)."""
    _, tcfg = _mixtral_cfg()
    p = {"router": DenseLinear(w=torch.zeros(4, 256, dtype=torch.bfloat16))}
    weights = ttr.route(torch.ones(3, 256, dtype=torch.bfloat16), p, tcfg)
    np.testing.assert_array_equal(weights.numpy(),
                                  np.tile([[0.5, 0.5, 0.0, 0.0]], (3, 1)))


@pytest.fixture(scope="module")
def mixtral_layers():
    """{capacity: (jcfg, tcfg, JAX per-expert, JAX grouped, port
    per-expert, port grouped)} for one-layer models."""
    out = {}
    for cap in (None, 2.0):
        jcfg, tcfg = _mixtral_cfg(moe_capacity_factor=cap)
        jq = _quantized(jcfg)
        jg = jsurg.stack_layer_projections(jq)
        tq = from_jax_params(jax.tree.map(np.asarray, jq), tcfg, device="cpu")
        out[cap] = (jcfg, tcfg, jq, jg, tq, tsurg.stack_layer_projections(tq))
    return out


@pytest.mark.parametrize("t", [12, 136])
@pytest.mark.parametrize("cap", [None, 2.0])
def test_moe_block_matches_jax(mixtral_layers, cap, t):
    """moe_block, per-expert and grouped, against the JAX moe_block on the
    converted parameters; 12 tokens run the JAX package's grouped kernel,
    136 its dequantize-then-product branch (over 128 rows per expert; the
    port's limits: tests/test_torch_routes.py)."""
    jcfg, tcfg, jq, jg, tq, tg = mixtral_layers[cap]
    assert "experts_grouped" in tg["layers"][0] and "experts" not in tg["layers"][0]
    jx, tx = _bf16_pair(np.random.default_rng(t).normal(0, 1, (1, t, 256)).astype(np.float32))
    outs = {}
    for name, jp, tp in (("per-expert", jq, tq), ("grouped", jg, tg)):
        ref = _f32(jax.jit(lambda h, p: jtr.moe_block(h, p, jcfg))(jx, jp["layers"][0]))
        outs[name] = ttr.moe_block(tx, tp["layers"][0], tcfg)
        got = _f32(outs[name])
        assert got.shape == ref.shape == (1, t, 256)
        _assert_gemm_close(got, ref)
    assert torch.equal(outs["grouped"], outs["per-expert"])


def test_quantized_mixtral_params_bit_exact():
    """One seed through both packages: dense draws (router and experts),
    quantize_model (codes, bases, site permutations), and the grouped
    form of stack_layer_projections; conversion gives the same."""
    jcfg, tcfg = _mixtral_cfg(num_layers=2)
    jd = jsurg.random_dense_params(jcfg, seed=2)
    td = tsurg.random_dense_params(tcfg, seed=2, device="cpu")
    for jl, tl in zip(jd["layers"], td["layers"]):
        np.testing.assert_array_equal(_f32(tl["router"].w), _f32(jl["router"].w))
        for je, te in zip(jl["experts"], tl["experts"]):
            for n in ("w1", "w3", "w2"):
                np.testing.assert_array_equal(_f32(te[n].w), _f32(je[n].w))
    jc = jsurg.default_calibration(jcfg, p6=64, p8=64, seed=2)
    tc = tsurg.default_calibration(tcfg, p6=64, p8=64, seed=2)
    assert all(list(a) == list(b) for a, b in zip(jc, tc))
    jq = jsurg.quantize_model(jd, jcfg, jc, host=True)
    tq = tsurg.quantize_model(td, tcfg, tc)
    for jl, tl in zip(jq["layers"], tq["layers"]):
        for je, te in zip(jl["experts"], tl["experts"]):
            for n in ("w1", "w3", "w2"):
                np.testing.assert_array_equal(te[n].w.codes.numpy(),
                                              np.asarray(je[n].w.codes))
                assert te[n].w.base == int(np.asarray(je[n].w.base).reshape(-1)[0])
            np.testing.assert_array_equal(te["site_in"].perm.numpy(),
                                          np.asarray(je["site_in"].perm))
            assert te["site_down"].perm is None and te["site_down"].splits == (384, 64, 64)
    jg = jsurg.stack_layer_projections(jq)
    tg = tsurg.stack_layer_projections(tq)
    conv = from_jax_params(jax.tree.map(np.asarray, jg), tcfg, device="cpu")
    for jl, tl, cl in zip(jg["layers"], tg["layers"], conv["layers"]):
        jgr, tgr, cgr = jl["experts_grouped"], tl["experts_grouped"], cl["experts_grouped"]
        for key in ("w13", "w2"):
            np.testing.assert_array_equal(tgr[key].codes.numpy(), np.asarray(jgr[key].codes))
            assert tgr[key].bases == cgr[key].bases
            assert tgr[key].padded == tuple(jgr[key].padded)
        np.testing.assert_array_equal(tgr["perm"].numpy(), np.asarray(jgr["perm"]))
        assert torch.equal(cgr["perm"], tgr["perm"])
        assert tgr["site_in"].splits == (128, 64, 64)
        assert torch.equal(cl["router"].w, tl["router"].w)


def test_random_quantized_model_groups_layer_by_layer():
    """A Mixtral built on the device comes grouped, one layer at a time;
    the engine's stacking keeps the grouped form and stacks q|k|v; the
    per-expert form on request."""
    _, tcfg = _mixtral_cfg(num_layers=2)
    calib = tsurg.default_calibration(tcfg, p6=64, p8=64, seed=0)
    g = tsurg.random_quantized_model(tcfg, calib, seed=0, device="cpu")
    per = tsurg.random_quantized_model(tcfg, calib, seed=0, device="cpu",
                                       group_experts=False)
    for gl, pl in zip(g["layers"], per["layers"]):
        assert "experts" not in gl and len(pl["experts"]) == 4
        regrouped = tsurg._group_experts(pl["experts"])
        assert torch.equal(regrouped["w13"].codes, gl["experts_grouped"]["w13"].codes)
        assert regrouped["w2"].bases == gl["experts_grouped"]["w2"].bases
    s = tsurg.stack_layer_projections(g)
    assert s["layers"][0]["experts_grouped"] is g["layers"][0]["experts_grouped"]
    assert "qkv_stack" in s["layers"][0] and "q" not in s["layers"][0]


@pytest.fixture
def jax_tpu_runner(monkeypatch):
    """The JAX runner's TPU branches (flash prefill), as in
    tests/test_torch_prefill.py."""
    proxy = types.ModuleType("jax_on_tpu")
    proxy.__getattr__ = lambda name: getattr(jax, name)
    proxy.default_backend = lambda: "tpu"
    monkeypatch.setattr(jrunner, "jax", proxy)


def test_tiny_mixtral_prefill_and_decode_match_jax(jax_tpu_runner):
    """A 2-layer tiny Mixtral, the engine's grouped form on both sides: a
    20-token prompt prefilled (flash), then 4 greedy decode steps."""
    jcfg, tcfg = _mixtral_cfg(num_layers=2)
    jg = jsurg.stack_layer_projections(_quantized(jcfg, seed=4))
    tg = from_jax_params(jax.tree.map(np.asarray, jg), tcfg, device="cpu")
    ps, mp = 16, 3
    prompt = np.random.default_rng(4).integers(0, jcfg.vocab_size, (1, 20)).astype(np.int32)
    nkv, hd = jcfg.num_kv_heads, jcfg.head_dim
    row = np.array([2, 1, 3], np.int32)
    jc = [dataclasses.replace(jkv.make_cache(4, ps, nkv, hd, 1, mp),
                              page_table=jnp.asarray(row[None]))
          for _ in range(jcfg.num_layers)]
    tc = [tkv.make_cache(4, ps, nkv, hd, 1, mp, device="cpu") for _ in range(jcfg.num_layers)]
    for c in tc:
        c.page_table[0] = torch.from_numpy(row)
    jlog, jc = jax.jit(lambda p, c, t: jrunner.prefill(
        p, jcfg, c, t, jnp.int32(0), jnp.int32(0)))(jg, jc, jnp.asarray(prompt))
    tlog, tc = trunner.prefill(tg, tcfg, tc, torch.from_numpy(prompt), 0, 0)
    jc = [dataclasses.replace(c, lengths=c.lengths.at[0].set(20)) for c in jc]
    for c in tc:
        c.lengths[0] = 20
    first = int(np.argmax(np.asarray(jlog)[0]))
    assert int(torch.argmax(tlog[0])) == first
    z = np.zeros((1,), np.float32)
    jtoks, _ = jax.jit(lambda p, c: jrunner.decode_multi(
        p, jcfg, c, jnp.asarray([first], jnp.int32), jnp.asarray([0], jnp.int32),
        jnp.asarray([20], jnp.int32), jax.random.PRNGKey(0), jnp.asarray(z),
        jnp.zeros((1,), jnp.int32), jnp.ones((1,), jnp.float32), n_steps=4,
        sample_mode="greedy"))(jg, jc)
    ttoks, _ = trunner.decode_multi(
        tg, tcfg, tc, torch.tensor([first]), torch.tensor([0]), torch.tensor([20]),
        None, torch.from_numpy(z), torch.zeros(1, dtype=torch.int32),
        torch.ones(1), n_steps=4, sample_mode="greedy")
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
