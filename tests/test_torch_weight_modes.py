"""Port parity: weight-only MX (``WeightOnlyLinear``,
``quantize_model_weight_only``) and W8A8 int8 (``Int8TurboLinear``,
``quantize_model_int8_turbo``) against the JAX package on the CPU.

* Weight-only MXFP4 (canonical ScaledW8), MXFP6 and MXFP8 (MixedTensor)
  codes and scales, and the int8 codes and ``w_scale``: bit-exact.
* ``Int8TurboLinear``'s output: bit-exact against ``jax.jit`` of the JAX
  linear (XLA folds ``/ 127.0`` into a multiply by its f32 reciprocal
  under jit, which the port follows; the int32 product is exact).
* The engine's greedy tokens for weight-only MXFP4 and MXFP8 and for
  int8: equal to the JAX engine's (a Llama at hidden 128, 2 layers), the
  JAX package held to its program's bf16 rounding points
  (``jax_rounds_bf16``, tests/jax_rounding.py: its CPU backend skips the
  round of an rmsnorm output widened again inside ``Int8TurboLinear``,
  and of a residual sum into ``rmsnorm``; with them skipped the int8
  model's logits part by 2% of the range, the MXFP8 model's greedy path
  at its 7th token).
"""

import numpy as np

import jax
import jax.numpy as jnp
import torch

from jax_rounding import jax_rounds_bf16  # noqa: F401 (fixture)
from port_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_checkpoint import _assert_port_trees_equal

from micromix_tpu.models import common as jcommon
from micromix_tpu.models import surgery as jsurg
from micromix_tpu.serve import engine as jengine
from micromix_tpu_torch.convert import from_jax_params
from micromix_tpu_torch.models import surgery as tsurg
from micromix_tpu_torch.models.common import Int8TurboLinear, ModelConfig
from micromix_tpu_torch.serve import engine as tengine

CFG = dict(arch="llama", vocab_size=256, hidden_size=128,
           intermediate_size=128, num_layers=2, num_heads=4, num_kv_heads=2,
           head_dim=32, rope_theta=10000.0, rms_eps=1e-6)


def _models(jcfg, tcfg, seed=6):
    """{mode: (JAX params, port params)} for every weight mode, each made
    by its own package from the same seeded dense weights."""
    jp = jsurg.random_dense_params(jcfg, seed=seed)
    tp = tsurg.random_dense_params(tcfg, seed=seed, device="cpu")
    out = {fmt: (jsurg.quantize_model_weight_only(jp, jcfg, fmt),
                 tsurg.quantize_model_weight_only(tp, tcfg, fmt))
           for fmt in ("mxfp4", "mxfp6", "mxfp8")}
    out["int8"] = (jsurg.quantize_model_int8_turbo(jp, jcfg),
                   tsurg.quantize_model_int8_turbo(tp, tcfg))
    return out


def test_weight_modes_bit_exact():
    """Every mode's quantized tree equals the JAX package's carried
    across (codes, scales, bases, int8 weights and scales)."""
    jcfg, tcfg = jcommon.ModelConfig(**CFG), ModelConfig(**CFG)
    for mode, (jq, tq) in _models(jcfg, tcfg).items():
        _assert_port_trees_equal(
            tq, from_jax_params(jax.tree.map(np.asarray, jq), tcfg, device="cpu"))
        lin = tq["layers"][0]["q"]
        assert type(lin).__name__ == ("Int8TurboLinear" if mode == "int8"
                                      else "WeightOnlyLinear"), mode


def test_int8_turbo_linear_matches_jitted_jax():
    """Rows with a zero row, a bias, 3-D input: bit-exact outputs."""
    rng = np.random.default_rng(1)
    w = rng.integers(-127, 128, (96, 256)).astype(np.int8)
    s = rng.uniform(1e-3, 2e-2, 96).astype(np.float32)
    b = jnp.asarray(rng.normal(0, 0.1, 96), jnp.bfloat16)
    x = rng.normal(0, 2.0, (2, 9, 256))
    x[0, 3] = 0.0
    xj = jnp.asarray(x, jnp.bfloat16)
    jlin = jcommon.Int8TurboLinear(w=jnp.asarray(w), w_scale=jnp.asarray(s), bias=b)
    ref = np.asarray(jax.jit(lambda lin, v: lin(v))(jlin, xj).astype(jnp.float32))
    tlin = Int8TurboLinear(
        w=torch.from_numpy(w), w_scale=torch.from_numpy(s),
        bias=torch.from_numpy(np.asarray(b.astype(jnp.float32))).to(torch.bfloat16))
    got = tlin(torch.from_numpy(np.asarray(xj.astype(jnp.float32))).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16 and got.shape == (2, 9, 96)
    np.testing.assert_array_equal(got.to(torch.float32).numpy(), ref)


def test_weight_mode_engines_match_jax(jax_rounds_bf16):  # noqa: F811
    """Weight-only MXFP4 and MXFP8 and int8: four greedy requests over two
    slots through the JAX engine and the port's; tokens equal."""
    jcfg, tcfg = jcommon.ModelConfig(**CFG), ModelConfig(**CFG)
    jp = jsurg.random_dense_params(jcfg, seed=6)
    tp = tsurg.random_dense_params(tcfg, seed=6, device="cpu")
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, 256, n).tolist() for n in (9, 14, 6, 11)]
    new = [6, 5, 7, 4]
    kw = dict(max_seqs=2, page_size=16, max_pages_per_seq=8,
              prefill_buckets=(16,), decode_chunk=4, seed=0)
    for mode in ("mxfp4", "mxfp8", "int8"):
        if mode == "int8":
            jq = jsurg.quantize_model_int8_turbo(jp, jcfg)
            tq = tsurg.quantize_model_int8_turbo(tp, tcfg)
        else:
            jq = jsurg.quantize_model_weight_only(jp, jcfg, mode)
            tq = tsurg.quantize_model_weight_only(tp, tcfg, mode)
        jreqs = jengine.Engine(jq, jcfg, piggyback=False, **kw).run(
            [jengine.Request(i, p, max_new_tokens=n)
             for i, (p, n) in enumerate(zip(prompts, new))])
        treqs = [tengine.Request(i, p, max_new_tokens=n)
                 for i, (p, n) in enumerate(zip(prompts, new))]
        tengine.Engine(tq, tcfg, device="cpu", **kw).run(treqs)
        for jr, tr, n in zip(jreqs, treqs, new):
            assert tr.done and len(tr.output) == n
            assert tr.output == jr.output, (mode, tr.output, jr.output)
