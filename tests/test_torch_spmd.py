"""Port parity: tensor parallelism v1 (``parallel/spmd.py``) on CPU gloo
ranks.

JAX's ``sharded_quantized_forward`` is not called here: its shard-mapped
program costs minutes on this CPU (``tests/test_parallel.py``'s two TP
tests take 360-381 s; one call at (data=1, model=2) had not returned
after 190 s), which the suite's clock does not have.  So the port is held
to what JAX's TP v1 is held to in its own test, the single device:

* ``shard_quantized_params``: each rank's tree bit-exact against the
  per-device slices of JAX's ``shard_quantized_params`` (``device_put``
  with ``NamedSharding``, read back from ``addressable_shards``) at
  (data=1, model=2): q/k/v/gate/up rows and the q/k/v biases sliced,
  the ScaledW8 base, o, down, norms, embedding and head whole.
* ``sharded_quantized_forward`` at (data=1, model=2) and (data=2,
  model=2), the data shards concatenated, against JAX's single-device
  ``forward`` (XLA attention on the CPU: probabilities rounded to bf16,
  the attention TP v1 runs) within JAX's own TP v1 band
  (tests/test_parallel.py:47-51: rtol = atol = 2e-2, correlation
  > 0.999), and bit-equal to the port's single-rank
  ``forward(attend=causal_attention)`` (the same rounding points, and on
  the CPU the same sums: the gathers only concatenate).
* Split-plane weights (port-quantized, no JAX): the 2-rank forward
  bit-equal to the port's single-rank ``forward(attend=causal_attention)``;
  a MoE config and a batch the data ranks do not divide are refused.

The model is tests/test_parallel.py's (hidden 256, 4 heads of 64, 2
layers, FP8 budget 128) with q/k/v biases, quantized once by JAX in a
module fixture and carried across by ``convert.from_jax_params``.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import torch_ranks
from jax_rounding import jax_rounds_bf16  # noqa: F401 (fixture)
from port_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_checkpoint import _assert_port_trees_equal

from micromix_tpu.models import ModelConfig as JConfig
from micromix_tpu.models import default_calibration as j_default
from micromix_tpu.models import forward as j_forward
from micromix_tpu.models import quantize_model as j_quantize
from micromix_tpu.models import random_dense_params as j_dense
from micromix_tpu.parallel import make_mesh
from micromix_tpu.parallel import shard_quantized_params as j_shard
from micromix_tpu_torch.convert import from_jax_params
from micromix_tpu_torch.models import surgery as tsurg
from micromix_tpu_torch.models.common import ModelConfig, causal_attention
from micromix_tpu_torch.models.transformer import forward
from micromix_tpu_torch.parallel import (RankGroup, shard_quantized_params,
                                         sharded_quantized_forward, spawn)

CFG = dict(arch="llama", vocab_size=256, hidden_size=256,
           intermediate_size=512, num_layers=2, num_heads=4, num_kv_heads=4,
           head_dim=64, rope_theta=10000.0, rms_eps=1e-6, qkv_bias=True)


@pytest.fixture(scope="module")
def model():
    """(JAX config, port config, JAX quantized tree, the port's)."""
    jcfg, tcfg = JConfig(**CFG), ModelConfig(**CFG)
    jq = j_quantize(j_dense(jcfg, seed=11), jcfg,
                    j_default(jcfg, p6=0, p8=128, seed=3))
    tq = from_jax_params(jax.tree.map(np.asarray, jq), tcfg, device="cpu")
    return jcfg, tcfg, jq, tq


def test_shards_equal_jax_device_slices(model):
    jcfg, tcfg, jq, tq = model
    mesh = make_mesh(data=1, model=2, devices=jax.devices()[:2])
    sharded = j_shard(jq, mesh)
    for r in range(2):
        dev = mesh.devices[0, 0, 0, r]
        mine = jax.tree.map(lambda x: np.asarray(next(
            s.data for s in x.addressable_shards if s.device == dev)), sharded)
        got = shard_quantized_params(tq, r, 2)
        _assert_port_trees_equal(got, from_jax_params(mine, tcfg, device="cpu"))
        layer = got["layers"][0]
        assert layer["q"].w.codes.shape[0] == CFG["num_heads"] * 64 // 2
        assert layer["k"].bias.shape[0] == CFG["num_kv_heads"] * 64 // 2
        assert layer["o"].w.codes.shape == tq["layers"][0]["o"].w.codes.shape


def test_forward_matches_jax_single_device(model, jax_rounds_bf16):  # noqa: F811
    jcfg, tcfg, jq, tq = model
    tokens = np.random.default_rng(5).integers(0, CFG["vocab_size"], (4, 16))
    want = np.asarray(j_forward(jq, jcfg, jnp.asarray(tokens, jnp.int32)),
                      np.float32)
    single = forward(tq, tcfg, torch.from_numpy(tokens),
                     attend=causal_attention).numpy()
    for data, model_ in ((1, 2), (2, 2)):
        ranks = spawn(torch_ranks.spmd_forward, data * model_, tq, tcfg,
                      tokens, data, model_, device="cpu")
        # the model ranks of a data shard agree; data shards in data order
        for d in range(data):
            for m in range(1, model_):
                np.testing.assert_array_equal(ranks[d * model_ + m],
                                              ranks[d * model_])
        got = np.concatenate([ranks[d * model_] for d in range(data)])
        np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)
        assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.999
        np.testing.assert_array_equal(got, single)


def test_split_plane_forward_and_refusals():
    cfg = ModelConfig(**dict(CFG, qkv_bias=False))
    tq = tsurg.quantize_model(tsurg.random_dense_params(cfg, seed=2, device="cpu"),
                              cfg, tsurg.default_calibration(cfg, p6=64, p8=64,
                                                             seed=2),
                              weight_fp4_only=False)
    assert type(tq["layers"][0]["q"].w).__name__ == "MixedTensor"
    tokens = np.random.default_rng(6).integers(0, CFG["vocab_size"], (2, 16))
    ranks = spawn(torch_ranks.spmd_forward, 2, tq, cfg, tokens, 1, 2,
                  device="cpu")
    single = forward(tq, cfg, torch.from_numpy(tokens),
                     attend=causal_attention).numpy()
    np.testing.assert_array_equal(ranks[0], single)
    np.testing.assert_array_equal(ranks[1], single)
    one = {a: RankGroup.single(a, "cpu") for a in ("data", "model")}
    with pytest.raises(ValueError, match="experts"):
        sharded_quantized_forward(tq, dataclasses.replace(
            cfg, arch="mixtral", num_experts=4, num_experts_per_tok=2),
            torch.from_numpy(tokens), one)
    two = dict(one, data=RankGroup(world=3, rank=0, axis="data",
                                   device=torch.device("cpu"), backend="gloo"))
    with pytest.raises(ValueError, match="does not divide batch"):
        sharded_quantized_forward(tq, cfg, torch.from_numpy(tokens), two)
