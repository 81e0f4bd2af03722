"""Port parity: the HF checkpoint loader (``micromix_tpu_torch.models.
loader``) and its safetensors reader (``models.safetensors_io``) against
the JAX package's loader and the ``safetensors`` package.

Tolerances: none.  The reader returns the bytes the ``safetensors``
package returns, bit for bit; the loaded trees equal the JAX loader's bit
for bit (compared as int16 views of the bf16 values), since both round
the file's values to bf16 once, to nearest even; ``config_from_hf`` gives
equal fields.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

import jax
import torch

from port_threads import one_torch_thread  # noqa: F401 (autouse)
from test_hf_fixture import (LLAMA31_CONFIG, QWEN2_CONFIG,
                             _write_sharded_checkpoint)

from micromix_tpu.models import loader as jloader
from micromix_tpu.models import surgery as jsurg
from micromix_tpu_torch.models import loader as tloader
from micromix_tpu_torch.models import safetensors_io

MIXTRAL_CONFIG = {
    "architectures": ["MixtralForCausalLM"], "model_type": "mixtral",
    "hidden_size": 128, "intermediate_size": 256, "num_attention_heads": 4,
    "num_hidden_layers": 1, "num_key_value_heads": 2, "rms_norm_eps": 1e-5,
    "rope_theta": 1e6, "num_local_experts": 4, "num_experts_per_tok": 2,
    "sliding_window": None, "vocab_size": 128, "max_position_embeddings": 32768,
    "tie_word_embeddings": False,
}
CONFIGS = {"llama31": LLAMA31_CONFIG, "qwen2": QWEN2_CONFIG,
           "mixtral": MIXTRAL_CONFIG}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_config_from_hf_matches_jax(name):
    j = jloader.config_from_hf(CONFIGS[name])
    t = tloader.config_from_hf(CONFIGS[name])
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert [f.name for f in dataclasses.fields(t)] == \
        [f.name for f in dataclasses.fields(j)]
    if name == "llama31":
        assert t.rope_scaling == ("llama3", 8.0, 1.0, 4.0, 8192)
        assert t.tie_embeddings
    if name == "qwen2":
        assert t.qkv_bias and t.sliding_window == 64


def test_config_refuses_unknown_rope_scaling():
    bad = dict(LLAMA31_CONFIG, rope_scaling={"rope_type": "yarn", "factor": 4.0})
    with pytest.raises(ValueError, match="yarn"):
        tloader.config_from_hf(bad)
    linear = dict(LLAMA31_CONFIG, rope_scaling={"type": "linear", "factor": 2.0})
    assert tloader.config_from_hf(linear).rope_scaling == ("linear", 2.0) == \
        jloader.config_from_hf(linear).rope_scaling


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32,
                                   torch.float16, torch.int64, torch.uint8,
                                   torch.float8_e4m3fn])
def test_reader_matches_safetensors_package(tmp_path, dtype):
    """Files the ``safetensors`` package wrote (odd shapes, so later
    tensors start at offsets that are not multiples of their width, a
    0-d and an empty tensor, metadata) read back bit for bit."""
    from safetensors.torch import load_file, save_file
    g = torch.Generator().manual_seed(3)
    tensors = {}
    for i, shape in enumerate([(3, 5), (7,), (), (0, 4), (2, 3, 9)]):
        x = torch.randn(shape, generator=g) * 50
        tensors[f"t{i}"] = x.to(dtype) if dtype.is_floating_point else \
            x.abs().to(dtype)
    tensors["u8"] = torch.arange(13, dtype=torch.uint8)    # mixed widths
    path = str(tmp_path / "x.safetensors")
    save_file(tensors, path, metadata={"format": "pt"})
    ref = load_file(path)
    f = safetensors_io.SafetensorsFile(path)
    assert sorted(f.keys()) == sorted(ref) and f.metadata == {"format": "pt"}
    for k, r in ref.items():
        got = f.get_tensor(k)
        assert got.dtype == r.dtype and got.shape == r.shape
        assert torch.equal(got.reshape(-1).view(torch.uint8),
                           r.reshape(-1).view(torch.uint8)), k


def _bits(x):
    """bf16 values (a JAX array or a tensor) -> their int16 patterns."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy()
    return np.asarray(x).view(np.int16)


def _assert_trees_equal(t, j):
    jl, _ = jax.tree_util.tree_flatten(j)
    tl = []

    def walk(x):
        if isinstance(x, dict):
            for k in x:
                walk(x[k])
        elif isinstance(x, list):
            for v in x:
                walk(v)
        elif isinstance(x, tloader.DenseLinear):
            walk(x.w)
            if x.bias is not None:
                walk(x.bias)
        else:
            tl.append(x)
    walk({k: t[k] for k in sorted(t)})     # JAX flattens dicts key-sorted
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        assert a.dtype == torch.bfloat16 and a.shape == tuple(b.shape)
        np.testing.assert_array_equal(_bits(a), _bits(b))


def _sorted_layers(p):
    """The dense tree with its layer dicts' keys in JAX's flatten order."""
    out = {k: p[k] for k in p}
    out["layers"] = [{k: lay[k] for k in sorted(lay)} for lay in p["layers"]]
    for lay in out["layers"]:
        if "experts" in lay:
            lay["experts"] = [{k: e[k] for k in sorted(e)} for e in lay["experts"]]
    return out


@pytest.mark.parametrize("case", ["llama31_sharded_tied", "qwen2_bias",
                                  "missing_shard", "stray_files",
                                  "mixtral_single_file"])
def test_hf_fixtures_match_jax_loader(tmp_path, case):
    """The HF checkpoint fixtures of tests/test_hf_fixture.py (sharded
    Llama 3.1 with tied embeddings and no lm_head, Qwen2 with q/k/v bias,
    a missing shard, a stray consolidated file beside the index), and a
    one-file Mixtral: the port's tree equals the JAX loader's."""
    hf = {"llama31_sharded_tied": LLAMA31_CONFIG,
          "mixtral_single_file": MIXTRAL_CONFIG}.get(case, QWEN2_CONFIG)
    jcfg = jloader.config_from_hf(hf)
    tensors = jloader.export_dense_params(
        jsurg.random_dense_params(jcfg, seed=50), jcfg)
    ckpt = str(tmp_path / case)
    if case == "llama31_sharded_tied":
        del tensors["lm_head.weight"]
    if case == "mixtral_single_file":
        # f32 values off the bf16 grid: both loaders round them once, RNE
        from safetensors.numpy import save_file
        rng = np.random.default_rng(5)
        os.makedirs(ckpt)
        save_file({k: (np.asarray(v, np.float32)
                       * (1 + 1e-3 * rng.standard_normal(v.shape))
                       ).astype(np.float32) for k, v in tensors.items()},
                  os.path.join(ckpt, "model.safetensors"))
        with open(os.path.join(ckpt, "config.json"), "w") as f:
            json.dump(hf, f)
    else:
        _write_sharded_checkpoint(ckpt, tensors, hf,
                                  n_shards=3 if case.startswith("llama") else 2)
    if case == "missing_shard":
        os.remove(os.path.join(ckpt, "model-00002-of-00002.safetensors"))
        for load in (jloader.load_dense_params,
                     lambda d: tloader.load_dense_params(d, device="cpu")):
            with pytest.raises(FileNotFoundError):
                load(ckpt)
        return
    if case == "stray_files":
        from safetensors.numpy import save_file
        bad = {"model.norm.weight":
               np.zeros_like(tensors["model.norm.weight"]) + 99.0}
        save_file(bad, os.path.join(ckpt, "consolidated.safetensors"))
    ref = jloader.load_dense_params(ckpt)
    got = tloader.load_dense_params(ckpt, device="cpu")
    _assert_trees_equal(_sorted_layers(got), ref)
    if case == "llama31_sharded_tied":
        assert got["lm_head"] is got["embed"]
    if case == "stray_files":
        np.testing.assert_array_equal(_bits(got["final_ln"]),
                                      _bits(tensors["model.norm.weight"]))


def test_export_and_in_memory_tensors_round_trip():
    """``export_dense_params`` names every tensor as the JAX package does,
    and ``load_dense_params(tensors=...)`` of the export (numpy bf16 from
    the JAX package, or the port's own tensors) gives the tree back."""
    cfg = tloader.config_from_hf(QWEN2_CONFIG)
    jcfg = jloader.config_from_hf(QWEN2_CONFIG)
    jp = jsurg.random_dense_params(jcfg, seed=9)
    jt = jloader.export_dense_params(jp, jcfg)
    from_np = tloader.load_dense_params(None, cfg, tensors=jt, device="cpu")
    _assert_trees_equal(_sorted_layers(from_np), jp)
    tt = tloader.export_dense_params(from_np, cfg)
    assert sorted(tt) == sorted(jt)
    for k in jt:
        np.testing.assert_array_equal(_bits(tt[k]), _bits(jt[k]))
    again = tloader.load_dense_params(None, cfg, tensors=tt, device="cpu")
    _assert_trees_equal(_sorted_layers(again), jp)
