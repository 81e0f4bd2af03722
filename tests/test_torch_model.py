"""Port parity: model surgery, parameter conversion and the quantized
forward on the ``__graft_entry__.entry()`` configuration (hidden 512,
2 layers, GQA 8/4, vocab 512, K split 256/128/128).

Tolerances:
  * dense weights, ScaledW8 codes and base, site permutations: bit-exact;
  * forward logits: see ``test_forward_logits_match_jax``.
"""

import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from __graft_entry__ import _llama_cfg
from micromix_tpu.models import forward as j_forward
from micromix_tpu.models import surgery as jsurg
from micromix_tpu_torch.convert import from_jax_params, to_tensor
from micromix_tpu_torch.models import common as tcommon
from micromix_tpu_torch.models import surgery as tsurg
from micromix_tpu_torch.models.common import ModelConfig
from micromix_tpu_torch.models.transformer import forward as t_forward

SEED = 0
LINEARS = ("q", "k", "v", "o", "gate", "up", "down")
SITES = ("attn_site", "o_site", "mlp_site", "down_site")


def _cfgs():
    jcfg = _llama_cfg()
    import dataclasses
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


@pytest.fixture(scope="module")
def models():
    """(jcfg, tcfg, JAX quantized params, port quantized params)."""
    jcfg, tcfg = _cfgs()
    # host=True: the JAX package's numpy quantize path, bit-identical to
    # its device path (tests/test_scaledw8.py) without ~600 per-op XLA
    # compiles
    jparams = jsurg.quantize_model(
        jsurg.random_dense_params(jcfg, seed=SEED), jcfg,
        jsurg.default_calibration(jcfg, p6=128, p8=128, seed=SEED), host=True)
    tparams = tsurg.quantize_model(
        tsurg.random_dense_params(tcfg, seed=SEED, device="cpu"), tcfg,
        tsurg.default_calibration(tcfg, p6=128, p8=128, seed=SEED))
    return jcfg, tcfg, jparams, tparams


def _np(t):
    return t.to(torch.float32).numpy() if t.dtype == torch.bfloat16 \
        else t.numpy()


def test_random_dense_params_bit_exact():
    jcfg, tcfg = _cfgs()
    jp = jsurg.random_dense_params(jcfg, seed=3)
    tp = tsurg.random_dense_params(tcfg, seed=3, device="cpu")
    for name in ("embed", "lm_head", "final_ln"):
        np.testing.assert_array_equal(
            _np(tp[name]), np.asarray(jp[name].astype(jnp.float32)))
    for jl, tl in zip(jp["layers"], tp["layers"]):
        for name in LINEARS:
            np.testing.assert_array_equal(
                _np(tl[name].w), np.asarray(jl[name].w.astype(jnp.float32)))


def test_quantize_model_codes_base_and_sites_bit_exact(models):
    _, _, jparams, tparams = models
    for jl, tl in zip(jparams["layers"], tparams["layers"]):
        for name in LINEARS:
            jw, tw = jl[name].w, tl[name].w
            np.testing.assert_array_equal(_np(tw.codes), np.asarray(jw.codes),
                                          err_msg=name)
            assert tw.base == int(np.asarray(jw.base).reshape(-1)[0]), name
            assert tw.segments() == jw.segments(), name
        for name in SITES:
            js, ts = jl[name], tl[name]
            assert ts.splits == js.splits, name
            if js.perm is None:
                assert ts.perm is None, name
            else:
                np.testing.assert_array_equal(_np(ts.perm),
                                              np.asarray(js.perm), err_msg=name)


def test_from_jax_params_equals_port_surgery(models):
    _, tcfg, jparams, tparams = models
    conv = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                           device="cpu")
    for name in ("embed", "lm_head", "final_ln"):
        assert torch.equal(conv[name], tparams[name]), name
    for cl, tl in zip(conv["layers"], tparams["layers"]):
        for name in LINEARS:
            assert torch.equal(cl[name].w.codes, tl[name].w.codes), name
            assert cl[name].w.base == tl[name].w.base, name
        for name in SITES:
            a, b = cl[name].perm, tl[name].perm
            assert (a is None and b is None) or torch.equal(a, b), name
    # ScaledW8 and split-plane stacks come over (tests/test_torch_stack.py,
    # tests/test_torch_splitplane.py); a container of neither kind raises
    tree = jax.tree.map(np.asarray, jparams)
    tree["layers"] = [dict(tree["layers"][0],
                           qkv_stack=types.SimpleNamespace(biases=(None,)))]
    with pytest.raises(NotImplementedError):
        from_jax_params(tree, tcfg, device="cpu")


def test_to_tensor_reads_bf16_bits():
    a = np.asarray(jnp.asarray([1.5, -2.25, 3e-3], jnp.bfloat16))
    t = to_tensor(a, "cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), a.astype(np.float32))


def test_rope_inv_freq_llama3_matches_jax():
    from micromix_tpu.models.common import rope_inv_freq as j_inv
    scaling = ("llama3", 8.0, 1.0, 4.0, 8192)
    for hd, theta, sc in ((128, 500000.0, scaling), (64, 10000.0, None),
                          (64, 10000.0, ("linear", 4.0))):
        np.testing.assert_array_equal(
            tcommon.rope_inv_freq(hd, theta, sc).numpy(),
            np.asarray(j_inv(hd, theta, sc)))


def test_forward_logits_match_jax(models):
    """Same converted bf16 parameters and tokens through both forwards,
    the JAX one with its prefill flash kernel (interpret mode), as it runs
    on the TPU.  Both round activations to bf16 at the same points; what
    differs is f32 sum order: one-ulp flips in GEMM outputs, which an fp4
    site can turn into a one-grid-step change.  Measured 0.35% of the
    logit range over 2 layers; the bound is 2%, and the argmax tokens
    must agree."""
    jcfg, tcfg, jparams, _ = models
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, (1, 32))
    ref = np.asarray(jax.jit(lambda p, t: j_forward(p, jcfg, t, use_flash=True))(
        jparams, jnp.asarray(tokens, jnp.int32)))
    got = t_forward(tparams, tcfg, torch.from_numpy(tokens)).numpy()
    assert got.shape == ref.shape == (1, 32, jcfg.vocab_size)
    assert np.isfinite(got).all()
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err < 0.02
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))
