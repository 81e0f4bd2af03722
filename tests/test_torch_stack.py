"""Port parity for the stacked serving path: the stacked GEMM (Kernel F's
function), the residual pair (Kernel G's function), engine-init stacking,
the conversion of stacked JAX params, and the paired decode step, held
against the JAX package on the CPU.

The JAX side runs its Pallas kernels in interpret mode, as its own tests
do (kept to a few small calls: interpret mode takes tens of seconds per
pair call); the port's wrappers get CPU tensors and run their plain
versions.

Tolerances:
  * plain-site stack outputs: the same exact bf16 operands, f32 sums in
    another order, one bf16 rounding: |diff| <= 2^-7 |ref| + 2^-8 max|ref|;
  * rms-site images: at most 1 element in 1000 one grid step of its
    32-block away (the f32 row-moment sum order can move a round-half-even
    tie); the GEMMs on one image then agree as above, and whole outputs
    within the JAX package's own band for a flipped tie (rtol 0.05,
    atol 1.0, median |diff| <= 0.25; tests/test_mixed_matmul_kernel.py
    test_pair_kernel_matches_unfused_chain);
  * the pair's h_mid: bit-exact (its rounding points are the unfused
    chain's, on exact grid-valued products);
  * paired decode logits against JAX's stacked, unpaired decode: the JAX
    package's pair-vs-unfused band (rtol 0.1, atol 1.0, median |diff| <
    0.1; test_decode_step_paired_matches_unfused), and equal greedy tokens.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from __graft_entry__ import _llama_cfg
from micromix_tpu.kernels.fakequant import fakequant_site_pallas
from micromix_tpu.kernels.mixed_matmul import mixed_matmul_w8_pair as j_pair
from micromix_tpu.kernels.mixed_matmul import mixed_matmul_w8_stack as j_stack
from micromix_tpu.models import surgery as jsurg
from micromix_tpu.mx import layout as jlay
from micromix_tpu.mx.mxtensor import quantize_mixed as j_quantize_mixed
from micromix_tpu.mx.scaledw8 import pack_scaled_w8 as j_pack_w8
from micromix_tpu.mx.scaledw8 import stack_scaled_w8 as j_stack_w8
from micromix_tpu.serve import kv_cache as jkv
from micromix_tpu.serve import runner as jrunner
from micromix_tpu_torch.convert import from_jax_params, stack_from_jax
from micromix_tpu_torch.kernels.fakequant import fakequant_site
from micromix_tpu_torch.kernels.mixed_matmul import (
    mixed_matmul_w8_pair, mixed_matmul_w8_stack, w8_stack_gemm)
from micromix_tpu_torch.models import surgery as tsurg
from micromix_tpu_torch.models.common import ModelConfig
from micromix_tpu_torch.mx.scaledw8 import (
    STACK_STRIP, ScaledW8, dequantize_scaled_w8,
    dequantize_stack, section_weight, stack_scaled_w8)
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


def _assert_tie_band(got, ref, k4=K4, k6=K6, k8=K8):
    diff = got != ref
    assert diff.mean() <= 1e-3, f"{int(diff.sum())} of {diff.size} differ"
    off = 0
    for kseg, mant in ((k4, 1), (k6, 2), (k8, 3)):
        g = got[:, off:off + kseg].reshape(got.shape[0], 32, -1)
        r = ref[:, off:off + kseg].reshape(ref.shape[0], 32, -1)
        bmax = np.maximum(np.abs(g).max(axis=1), np.abs(r).max(axis=1))
        step = np.exp2(np.floor(np.log2(np.maximum(bmax, 1e-30))) - mant)
        assert (np.abs(g - r) <= step[:, None, :]).all()
        off += kseg


def _assert_pair_band(got, ref):
    np.testing.assert_allclose(got, ref, rtol=0.05, atol=1.0)
    assert np.median(np.abs(got - ref)) <= 0.25


def _w8(rng, n, k=K, k4=K4, k6=K6, k8=K8):
    """One random weight as a JAX and a port ScaledW8."""
    w = rng.normal(0, 0.3, (n, k)).astype(np.float32)
    jw = j_pack_w8(j_quantize_mixed(jnp.asarray(w), k4, k6, k8,
                                    weight_fp4_only=True, pack_fp4=True))
    tw = ScaledW8(codes=torch.from_numpy(np.array(jw.codes)),
                  base=int(np.asarray(jw.base).reshape(-1)[0]),
                  k4=k4, k6=k6, k8=k8)
    return jw, tw


@pytest.mark.parametrize("producer", ["plain", "rms"])
def test_stack_matches_pallas(rng, producer):
    """Port stack (own padding to 64 rows, and the JAX stack carried over
    with its own padding) against mixed_matmul_w8_stack(interpret=True);
    sections of 256, 120 and 128 rows (one not a strip multiple)."""
    ns = (256, 120, 128)
    pairs = [_w8(rng, n) for n in ns]
    jst = j_stack_w8([p[0] for p in pairs])
    tst = stack_scaled_w8([p[1] for p in pairs])
    assert tst.padded == (256, 128, 128) and tst.sections == ns
    x = rng.normal(0, 1, (5, K)).astype(np.float32)
    x[:, rng.choice(K, 6, replace=False)] *= 30.0
    jx, tx = _bf16_pair(x)
    perm = jlay.compose_segmented(rng.permutation(K).astype(np.int32), K4, K6, K8)
    jxg = jnp.take(jx, jnp.asarray(perm), axis=1)
    jkw, tkw = {}, {"perm": torch.from_numpy(perm)}
    if producer == "rms":
        gamma = rng.normal(1, 0.1, (K,)).astype(np.float32)
        jkw = dict(producer="rms", gamma=jnp.asarray(gamma[perm]), eps=1e-5)
        tkw.update(producer="rms", gamma=torch.from_numpy(gamma), eps=1e-5)
    ref = [_f32(r) for r in j_stack(jxg, jst, interpret=True, **jkw)]
    jimg = _f32(fakequant_site_pallas(jxg, K4, K6, K8, interpret=True, **jkw))
    for st in (tst, stack_from_jax(jax.tree.map(np.asarray, jst), "cpu")):
        got = [_f32(g) for g in mixed_matmul_w8_stack(tx, st, **tkw)]
        assert [g.shape for g in got] == [(5, n) for n in ns]
        # the GEMM half on the JAX image isolates it from tie flips
        on_img = w8_stack_gemm(torch.from_numpy(jimg).to(torch.bfloat16), st)
        for g, r in zip(on_img, ref):
            _assert_gemm_close(_f32(g), r)
        for g, r in zip(got, ref):
            if producer == "plain":
                _assert_gemm_close(g, r)
            else:
                _assert_pair_band(g, r)
    if producer == "rms":
        _assert_tie_band(_f32(fakequant_site(tx, K4, K6, K8, **tkw)), jimg)


@pytest.mark.parametrize("case", ["o_gateup", "down_qkv"])
def test_pair_matches_pallas(rng, case):
    """mixed_matmul_w8_pair: a plain site with a gather (o -> gate|up) and
    a silu site (down -> q|k|v, bias), each against the JAX pair kernel in
    interpret mode.  Phase B's site is unpermuted here (its gather runs in
    test_stack_matches_pallas); the JAX side gets x_a pre-gathered."""
    k = 512
    k_a = 512 if case == "o_gateup" else 1024
    ka = (k_a - 256, 128, 128)
    jwa, twa = _w8(rng, k, k_a, *ka)
    ns = (256, 256) if case == "o_gateup" else (384, 128)
    pairs = [_w8(rng, n, k) for n in ns]
    jst = j_stack_w8([p[0] for p in pairs])
    tst = stack_scaled_w8([p[1] for p in pairs])
    m = 5
    jxa, txa = _bf16_pair(rng.normal(0, 1, (m, k_a)).astype(np.float32))
    jh, th = _bf16_pair(rng.normal(0, 1, (m, k)).astype(np.float32))
    gamma = rng.normal(1, 0.1, (k,)).astype(np.float32)
    jkw = dict(gamma_b=jnp.asarray(gamma), eps=1e-5)
    tkw = dict(gamma_b=torch.from_numpy(gamma), eps=1e-5)
    if case == "o_gateup":
        perm = jlay.compose_segmented(rng.permutation(k_a).astype(np.int32), *ka)
        jxa = jnp.take(jxa, jnp.asarray(perm), axis=1)
        tkw["perm_a"] = torch.from_numpy(perm)
    else:
        ju, tu = _bf16_pair(rng.normal(0, 0.25, (m, k_a)).astype(np.float32))
        jb, tb = _bf16_pair(rng.normal(0, 0.1, (k,)).astype(np.float32))
        jkw.update(producer_a="silu", up_a=ju, bias_a=jb)
        tkw.update(producer_a="silu", up_a=tu, bias_a=tb)
    jhm, jouts = j_pair(jxa, jh, jwa, jst, interpret=True, **jkw)
    thm, touts = mixed_matmul_w8_pair(txa, th, twa, tst, **tkw)
    np.testing.assert_array_equal(_f32(thm), _f32(jhm))
    assert [tuple(o.shape) for o in touts] == [(m, n) for n in ns]
    for g, r in zip(touts, jouts):
        _assert_pair_band(_f32(g), _f32(r))


def test_stack_layer_projections_and_both_conversion_routes():
    """The port's own stacking of per-consumer params and the conversion
    of a JAX-stacked pytree give the same per-section outputs; stacking
    removes the per-weight entries, keeps aliased layers shared, and
    leaves experts it cannot group as they are."""
    jcfg = _llama_cfg(num_layers=1)
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    jq = jsurg.quantize_model(jsurg.random_dense_params(jcfg, seed=3), jcfg,
                              jsurg.default_calibration(jcfg, p6=128, p8=128,
                                                        seed=3), host=True)
    per = from_jax_params(jax.tree.map(np.asarray, jq), tcfg, device="cpu")
    per["layers"].append(per["layers"][0])                  # an alias
    mine = tsurg.stack_layer_projections(per)
    assert mine["layers"][0] is mine["layers"][1]
    carried = from_jax_params(
        jax.tree.map(np.asarray, jsurg.stack_layer_projections(jq)), tcfg,
        device="cpu")
    for key, names in (("qkv_stack", "qkv"), ("gateup_stack", ("gate", "up"))):
        a, b = mine["layers"][0][key], carried["layers"][0][key]
        assert all(n not in mine["layers"][0] for n in names)
        assert a.sections == b.sections and a.bases == b.bases
        assert all(p % STACK_STRIP == 0 for p in a.padded)
        for i, n in enumerate(names):
            ref = dequantize_scaled_w8(per["layers"][0][n].w, torch.float32)
            np.testing.assert_array_equal(
                _f32(dequantize_scaled_w8(section_weight(a, i), torch.float32)),
                _f32(ref))
        off = sum(a.padded[:1])
        np.testing.assert_array_equal(
            _f32(dequantize_stack(a)[off:off + a.sections[1]]),
            _f32(dequantize_stack(b)[sum(b.padded[:1]):][:b.sections[1]]))
        qx = torch.from_numpy(np.random.default_rng(0).normal(
            0, 1, (3, jcfg.hidden_size)).astype(np.float32)).to(torch.bfloat16)
        for ya, yb in zip(w8_stack_gemm(qx, a), w8_stack_gemm(qx, b)):
            np.testing.assert_array_equal(_f32(ya), _f32(yb))
    # experts that are not all ScaledW8 keep their per-expert form (a
    # Mixtral's are grouped: tests/test_torch_moe.py)
    odd = {"layers": [{"experts": [{}]}]}
    assert tsurg.stack_layer_projections(odd)["layers"][0] == {"experts": [{}]}


@pytest.mark.parametrize("pair", [True, False])
def test_paired_decode_step_matches_jax_stacked_decode(monkeypatch, pair):
    """Two decode steps of the port's paired path (or, under
    MICROMIX_NO_PAIR=1, its stacked per-site path) against the JAX
    package's stacked decode step on its CPU path; the same caches,
    prefilled with the same random history."""
    if not pair:
        monkeypatch.setenv("MICROMIX_NO_PAIR", "1")
    jcfg = _llama_cfg()
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    jq = jsurg.stack_layer_projections(jsurg.quantize_model(
        jsurg.random_dense_params(jcfg, seed=1), jcfg,
        jsurg.default_calibration(jcfg, p6=128, p8=128, seed=1), host=True))
    tq = from_jax_params(jax.tree.map(np.asarray, jq), tcfg, device="cpu")
    b, ps, mp = 3, 16, 4
    assert trunner._can_pair(tq, tcfg, b) == pair
    rng = np.random.default_rng(7)
    nkv, hd = jcfg.num_kv_heads, jcfg.head_dim
    hist = np.array([5, 20, 33], np.int32)
    table = np.arange(1, b * mp + 1, dtype=np.int32).reshape(b, mp)
    jc, tc = [], []
    for _ in range(jcfg.num_layers):
        c = dataclasses.replace(jkv.make_cache(b * mp + 1, ps, nkv, hd, b, mp),
                                page_table=jnp.asarray(table))
        seq = np.repeat(np.arange(b, dtype=np.int32), hist.max())
        pos = np.tile(np.arange(hist.max(), dtype=np.int32), b)
        keep = pos < np.repeat(hist, hist.max())
        kv = rng.normal(0, 1, (2, int(keep.sum()), nkv, hd)).astype(np.float32)
        c = jax.jit(jkv.append_kv)(c, jnp.asarray(seq[keep]),
                                   jnp.asarray(pos[keep]),
                                   jnp.asarray(kv[0], jnp.bfloat16),
                                   jnp.asarray(kv[1], jnp.bfloat16))
        jc.append(c)
        t = tkv.make_cache(b * mp + 1, ps, nkv, hd, b, mp, device="cpu")
        for name in ("k_codes", "v_codes", "k_sz", "v_sz", "page_table",
                     "lengths"):
            getattr(t, name).copy_(torch.from_numpy(_f32(getattr(c, name))))
        tc.append(t)
    toks = rng.integers(0, jcfg.vocab_size, b).astype(np.int32)
    seq = np.arange(b, dtype=np.int32)
    jstep = jax.jit(lambda p, c, t, s, q: jrunner.decode_step(p, jcfg, c, t, s, q))
    for step in range(2):
        pos = hist + step
        jlog, jc = jstep(jq, jc, jnp.asarray(toks), jnp.asarray(seq),
                         jnp.asarray(pos))
        tlog, tc = trunner.decode_step(tq, tcfg, tc, torch.from_numpy(toks),
                                       torch.from_numpy(seq),
                                       torch.from_numpy(pos))
        g, r = _f32(tlog), _f32(jlog)
        np.testing.assert_allclose(g, r, rtol=0.1, atol=1.0)
        assert np.median(np.abs(g - r)) < 0.1
        toks = r.argmax(-1).astype(np.int32)
        np.testing.assert_array_equal(g.argmax(-1), toks)


@pytest.mark.parametrize("m", [5, 130, 513])
def test_project_all_stack_equals_per_consumer(rng, m):
    """project_all's stacked leg (the stacked GEMM's plain version up to
    ``W8_STACK_MAX_M`` rows, one dequantized stack and product above)
    gives the per-consumer leg's bits, biases included, on the CPU's plain
    versions."""
    from micromix_tpu_torch.models.common import (QuantLinear, QuantSite,
                                                  project_all)
    from micromix_tpu_torch.mx.mxtensor import quantize_mixed
    from micromix_tpu_torch.mx.scaledw8 import pack_scaled_w8
    ns = (256, 128, 128)
    lins = [QuantLinear(w=pack_scaled_w8(quantize_mixed(
        torch.from_numpy(rng.normal(0, 0.3, (n, K)).astype(np.float32)),
        K4, K6, K8, weight_fp4_only=True)),
                        bias=_bf16_pair(rng.normal(0, 1, (n,)).astype(
                            np.float32))[1]) for n in ns]
    st = stack_scaled_w8([lin.w for lin in lins], [lin.bias for lin in lins])
    perm = jlay.compose_segmented(rng.permutation(K).astype(np.int32), K4, K6, K8)
    site = QuantSite(K4, K6, K8, perm=torch.from_numpy(perm))
    gamma = _bf16_pair(rng.normal(1, 0.1, (K,)).astype(np.float32))[1]
    x = _bf16_pair(rng.normal(0, 1, (m, 1, K)).astype(np.float32))[1]
    ref = project_all(x, site, lins, gamma, 1e-5)
    got = project_all(x, site, None, gamma, 1e-5, stack=st)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert torch.equal(g, r)
