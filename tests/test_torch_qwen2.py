"""Qwen2 in the port, held against the JAX package on the CPU: q/k/v
biases and a GQA group of 7 (14 query heads over 2 KV heads), at
Qwen2-0.5B's widths (hidden 896, head_dim 64, intermediate 4864,
rope_theta 1e6) cut to 2 layers and a 256-token vocabulary.

Both packages get the same parameters: the JAX package's quantized model
(all-MXFP4 sites, ``default_calibration(seed=1)``, so that GEMM sums are
exact in f32 and greedy paths cannot part on near ties) through
``convert.from_jax_params``.  The JAX runner is pointed at its TPU
branches (its flash kernel for a fresh prefill, with the window), as
tests/test_torch_prefill.py does; both sides decode per site (hidden 896
is no multiple of 512, so neither pairs).

Tolerances: forward logits within 2% of their range (the bound of
tests/test_torch_model.py: f32 sums in another order, one bf16 rounding
at the same points) with equal argmax tokens; engines: equal greedy
tokens.
"""

import dataclasses
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from port_threads import one_torch_thread  # noqa: F401 (autouse)

from micromix_tpu.models import ModelConfig as JModelConfig
from micromix_tpu.models import forward as j_forward
from micromix_tpu.models import surgery as jsurg
from micromix_tpu.serve import engine as jengine
from micromix_tpu.serve import runner as jrunner
from micromix_tpu_torch.convert import from_jax_params
from micromix_tpu_torch.models.common import ModelConfig
from micromix_tpu_torch.models.transformer import forward as t_forward
from micromix_tpu_torch.serve import engine as tengine

QWEN2 = dict(arch="qwen2", vocab_size=256, hidden_size=896,
             intermediate_size=4864, num_layers=2, num_heads=14,
             num_kv_heads=2, head_dim=64, rope_theta=1e6, rms_eps=1e-6,
             qkv_bias=True)
ENGINE = dict(max_seqs=2, page_size=16, max_pages_per_seq=4,
              prefill_buckets=(16,), decode_chunk=4, seed=0)


@pytest.fixture(scope="module")
def qwen2():
    jcfg = JModelConfig(**QWEN2)
    jparams = jsurg.quantize_model(
        jsurg.random_dense_params(jcfg, seed=3), jcfg,
        jsurg.default_calibration(jcfg, seed=1), host=True)
    assert jparams["layers"][0]["q"].bias is not None
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams),
                              ModelConfig(**QWEN2), device="cpu")
    return jcfg, jparams, tparams


@pytest.fixture
def jax_tpu_runner(monkeypatch):
    proxy = types.ModuleType("jax_on_tpu")
    proxy.__getattr__ = lambda name: getattr(jax, name)
    proxy.default_backend = lambda: "tpu"
    monkeypatch.setattr(jrunner, "jax", proxy)
    monkeypatch.setattr(jrunner, "_can_pair", lambda *a: False)


def _prompts(n, seed=11):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, QWEN2["vocab_size"], 10 + 3 * i).tolist()
            for i in range(n)]


def test_qwen2_forward_matches_jax(qwen2):
    """The full-sequence forward (32 tokens) against the JAX package's
    with its flash kernel: logits within 2% of their range (measured
    0.31% of 2.09), argmax tokens equal."""
    jcfg, jparams, tparams = qwen2
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, (1, 32))
    ref = np.asarray(jax.jit(lambda p, t: j_forward(p, jcfg, t, use_flash=True))(
        jparams, jnp.asarray(tokens, jnp.int32)))
    got = t_forward(tparams, ModelConfig(**QWEN2), torch.from_numpy(tokens)).numpy()
    assert got.shape == ref.shape == (1, 32, jcfg.vocab_size)
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() / np.abs(ref).max() < 0.02
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))


@pytest.mark.parametrize("window", [None, 12])
def test_qwen2_engine_matches_jax(qwen2, jax_tpu_runner, window):
    """The port's default engine (stacked q|k|v with its biases, gate|up,
    pipelined decode) against the JAX engine's defaults: three requests
    over two slots, 8 new tokens each, with and without a 12-token sliding
    window (prompts of 10-16 tokens, so decode crosses it).  Greedy
    tokens equal."""
    jcfg, jparams, tparams = qwen2
    jcfg = dataclasses.replace(jcfg, sliding_window=window)
    tcfg = ModelConfig(**dict(QWEN2, sliding_window=window))
    prompts = _prompts(3)
    jreqs = jengine.Engine(jparams, jcfg, **ENGINE).run(
        [jengine.Request(i, p, max_new_tokens=8) for i, p in enumerate(prompts)])
    teng = tengine.Engine(tparams, tcfg, device="cpu", **ENGINE)
    treqs = teng.run([tengine.Request(i, p, max_new_tokens=8)
                      for i, p in enumerate(prompts)])
    assert "qkv_stack" in teng.params["layers"][0]
    for jr, tr in zip(jreqs, treqs):
        assert tr.done and len(tr.output) == 8
        assert tr.output == jr.output


def test_qwen2_stacking_preserves_generations(qwen2, monkeypatch):
    """The engine's stacking at init (q|k|v with the Qwen2 biases,
    gate|up) does not change greedy generations against the per-consumer
    form (``MICROMIX_NO_STACK``), as tests/test_engine.py holds the JAX
    engine; the input params stay unstacked."""
    _, _, tparams = qwen2
    cfg = ModelConfig(**QWEN2)

    def run():
        eng = tengine.Engine(tparams, cfg, device="cpu", **ENGINE)
        reqs = eng.run([tengine.Request(i, p, max_new_tokens=8)
                        for i, p in enumerate(_prompts(2, seed=9))])
        return eng, [r.output for r in reqs]

    eng, stacked = run()
    assert "qkv_stack" in eng.params["layers"][0]
    assert "qkv_stack" not in tparams["layers"][0]
    monkeypatch.setenv("MICROMIX_NO_STACK", "1")
    eng, per_consumer = run()
    assert "qkv_stack" not in eng.params["layers"][0]
    assert stacked == per_consumer
