"""Port parity: quantized checkpoints (``micromix_tpu_torch.models.
checkpoint``) in the JAX package's on-disk format, both ways.

A checkpoint the JAX package's ``save_params`` wrote of a tiny quantized
model (a ScaledW8 Llama, a split-plane Llama, a Mixtral) loads in the
port equal, bit for bit, to ``convert.from_jax_params`` of the same tree,
and the port's ``forward`` gives the same logits on both, exactly (they
are the same tensors).  The port's ``save_params`` of that model loads in
the JAX package with every array equal to the original tree's
(``QuantSite.benes`` is written as none: the port gathers by ``perm``).
Dense trees round-trip in both directions.  Tolerances: none.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from port_threads import one_torch_thread  # noqa: F401 (autouse)

from micromix_tpu.models import checkpoint as jck
from micromix_tpu.models import common as jcommon
from micromix_tpu.models import surgery as jsurg
from micromix_tpu_torch.convert import from_jax_params
from micromix_tpu_torch.models import checkpoint as tck
from micromix_tpu_torch.models import surgery as tsurg
from micromix_tpu_torch.models.common import ModelConfig
from micromix_tpu_torch.models.transformer import forward

BASE = dict(arch="llama", vocab_size=128, hidden_size=256,
            intermediate_size=384, num_layers=2, num_heads=4, num_kv_heads=2,
            head_dim=64, rope_theta=10000.0, rms_eps=1e-5,
            rope_scaling=("llama3", 8.0, 1.0, 4.0, 8192))
MODELS = {
    "scaledw8_llama": (BASE, "auto"),
    "splitplane_llama": (dict(BASE, num_layers=1), "splitplane"),
    "mixtral": (dict(BASE, arch="mixtral", num_layers=1, num_experts=4,
                     num_experts_per_tok=2, rope_scaling=None), "auto"),
}


def _flat(tree):
    """Leaves of a port tree in a fixed order: (path, tensor or scalar)."""
    out = []

    def walk(x, path):
        if isinstance(x, dict):
            for k in sorted(x):
                walk(x[k], f"{path}.{k}")
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                walk(v, f"{path}.{i}")
        elif dataclasses.is_dataclass(x):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name), f"{path}.{f.name}")
        else:
            out.append((path, x))
    walk(tree, "")
    return out


def _assert_port_trees_equal(a, b):
    fa, fb = _flat(a), _flat(b)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (path, x), (_, y) in zip(fa, fb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.shape == y.shape, path
            assert torch.equal(x.view(torch.uint8) if x.dtype == torch.bfloat16
                               else x, y.view(torch.uint8)
                               if y.dtype == torch.bfloat16 else y), path
        else:
            assert x == y, path


def _np_bits(x):
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _assert_jax_trees_equal(a, b):
    la, ta = jax.tree_util.tree_flatten(a)
    lb, tb = jax.tree_util.tree_flatten(b)
    assert ta == tb
    for x, y in zip(la, lb):
        assert np.asarray(x).dtype == np.asarray(y).dtype
        np.testing.assert_array_equal(_np_bits(x), _np_bits(y))


def _without_benes(tree):
    """The JAX tree with every QuantSite's Benes route dropped."""
    return jax.tree_util.tree_map(
        lambda n: dataclasses.replace(n, benes=None)
        if isinstance(n, jcommon.QuantSite) else n, tree,
        is_leaf=lambda n: isinstance(n, jcommon.QuantSite))


@pytest.mark.parametrize("name", list(MODELS))
def test_checkpoints_cross_packages(tmp_path, name):
    base, layout = MODELS[name]
    jcfg, tcfg = jcommon.ModelConfig(**base), ModelConfig(**base)
    # host=True: the JAX package's numpy quantize path, bit-identical to its
    # device path, without per-op compiles
    jq = jsurg.quantize_model(
        jsurg.random_dense_params(jcfg, seed=4), jcfg,
        jsurg.default_calibration(jcfg, p6=64, p8=64, seed=4), host=True,
        layout=layout)
    jdir = str(tmp_path / "jax")
    jck.save_params(jdir, jq, jcfg, meta={"note": name})
    got, cfg, meta = tck.load_params(jdir, device="cpu")
    assert cfg == tcfg and meta == {"note": name}
    ref = from_jax_params(jax.tree.map(np.asarray, jq), tcfg, device="cpu")
    _assert_port_trees_equal(got, ref)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, tcfg.vocab_size, (1, 8)))
    with torch.inference_mode():
        assert torch.equal(forward(got, tcfg, toks), forward(ref, tcfg, toks))

    tdir = str(tmp_path / "port")
    tck.save_params(tdir, got, tcfg, meta={"note": name})
    back, cfg2, meta2 = jck.load_params(tdir)
    assert cfg2 == jcfg and meta2 == {"note": name}
    _assert_jax_trees_equal(back, _without_benes(jq))
    with open(os.path.join(tdir, "manifest.json")) as f:
        base_leaf = json.load(f)["tree"]["items"]["layers"]["items"][0]["items"]
    w = next(v for v in base_leaf.values() if v["kind"] == "QuantLinear")
    if layout == "auto":
        assert w["fields"]["w"]["fields"]["base"]["dtype"] == "int32"


def test_dense_round_trip(tmp_path):
    """A dense Mixtral tree (DenseLinear leaves) both ways: the port's own
    round trip, JAX's save loaded by the port, the port's loaded by JAX."""
    base = MODELS["mixtral"][0]
    jcfg, tcfg = jcommon.ModelConfig(**base), ModelConfig(**base)
    tp = tsurg.random_dense_params(tcfg, seed=1, device="cpu")
    jp = jsurg.random_dense_params(jcfg, seed=1)
    tck.save_params(str(tmp_path / "t"), tp, tcfg)
    got, cfg, _ = tck.load_params(str(tmp_path / "t"), device="cpu")
    assert cfg == tcfg
    _assert_port_trees_equal(got, tp)
    jck.save_params(str(tmp_path / "j"), jp, jcfg)
    got_j, _, _ = tck.load_params(str(tmp_path / "j"), device="cpu")
    _assert_port_trees_equal(got_j, tp)
    back, cfg_j, _ = jck.load_params(str(tmp_path / "t"))
    assert cfg_j == jcfg
    _assert_jax_trees_equal(back, jp)


@pytest.mark.parametrize("kind", ["Int8TurboLinear", "WeightOnlyLinear",
                                  "FakeQuantSite", "orbax"])
def test_unported_nodes_raise(tmp_path, kind):
    """The JAX package's containers without a port counterpart, and its
    orbax checkpoints, raise NotImplementedError naming their item."""
    arr = {"kind": "array", "key": "a0", "dtype": "int32", "path": "params.w"}
    tree = {"kind": "dict", "items": {"x": {
        "kind": kind, "fields": {"w": arr}, "statics": {}}}}
    manifest = {"format_version": 1, "tree": tree, "config": None, "meta": {}}
    if kind == "orbax":
        manifest.update(tree=arr, array_container="orbax")
    os.makedirs(tmp_path / "ck")
    np.savez(tmp_path / "ck" / "arrays.npz", a0=np.zeros(3, np.int32))
    with open(tmp_path / "ck" / "manifest.json", "w") as f:
        json.dump(manifest, f)
    with pytest.raises(NotImplementedError,
                       match="orbax" if kind == "orbax" else "ROADMAP item 8"):
        tck.load_params(str(tmp_path / "ck"), device="cpu")


def test_stacked_params_are_refused(tmp_path):
    """The engine's stacked containers have no node in the format (nor in
    the JAX package's): saving them raises."""
    cfg = ModelConfig(**MODELS["scaledw8_llama"][0])
    q = tsurg.quantize_model(tsurg.random_dense_params(cfg, seed=2, device="cpu"),
                             cfg, tsurg.default_calibration(cfg, p6=64, p8=64))
    with pytest.raises(NotImplementedError, match="stack"):
        tck.save_params(str(tmp_path / "s"), tsurg.stack_layer_projections(q), cfg)
