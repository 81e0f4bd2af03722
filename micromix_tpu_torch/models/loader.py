"""HF checkpoint loader: config.json + safetensors -> dense parameters.

Counterpart of ``micromix_tpu/models/loader.py``: reads a local HF
checkpoint directory (one file, or shards named by
``model.safetensors.index.json``) with ``safetensors_io`` and maps the
Llama, Qwen2 (q/k/v bias) and Mixtral names into the layout of
``random_dense_params``, so ``calib/``, ``smooth_quantize_model`` and
``quantize_model`` take the result unchanged.  Every tensor is cast to
bf16 with round-to-nearest-even, as ``jnp.asarray(x, bfloat16)`` does,
on the target device.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..device import resolve_device
from .common import DenseLinear, ModelConfig
from .safetensors_io import SafetensorsFile


def config_from_hf(d: Dict[str, Any]) -> ModelConfig:
    mt = d.get("model_type", "llama")
    arch = {"llama": "llama", "qwen2": "qwen2", "mixtral": "mixtral"}.get(mt)
    if arch is None:
        raise ValueError(f"unsupported model_type {mt!r}")
    heads = d["num_attention_heads"]
    head_dim = d.get("head_dim") or d["hidden_size"] // heads
    return ModelConfig(
        arch=arch,
        vocab_size=d["vocab_size"],
        hidden_size=d["hidden_size"],
        intermediate_size=d["intermediate_size"],
        num_layers=d["num_hidden_layers"],
        num_heads=heads,
        num_kv_heads=d.get("num_key_value_heads", heads),
        head_dim=head_dim,
        rope_theta=d.get("rope_theta", 10000.0),
        rms_eps=d.get("rms_norm_eps", 1e-6),
        qkv_bias=(arch == "qwen2"),
        tie_embeddings=d.get("tie_word_embeddings", False),
        sliding_window=(d.get("sliding_window")
                        if d.get("use_sliding_window", False) else None),
        num_experts=d.get("num_local_experts", 0),
        num_experts_per_tok=d.get("num_experts_per_tok", 0),
        max_position_embeddings=d.get("max_position_embeddings", 32768),
        rope_scaling=_parse_rope_scaling(d.get("rope_scaling")),
    )


def _parse_rope_scaling(rs):
    """HF config rope_scaling dict -> ModelConfig tuple (or None)."""
    if not rs:
        return None
    kind = rs.get("rope_type") or rs.get("type")
    if kind in (None, "default"):
        return None
    if kind == "linear":
        return ("linear", float(rs["factor"]))
    if kind == "llama3":
        return ("llama3", float(rs["factor"]),
                float(rs["low_freq_factor"]), float(rs["high_freq_factor"]),
                int(rs["original_max_position_embeddings"]))
    raise ValueError(f"unsupported rope_scaling type {kind!r}")


def _open_safetensors(ckpt_dir: str) -> Dict[str, SafetensorsFile]:
    """tensor name -> the file that holds it.  With an index.json only the
    shards it names are read (a missing one raises); stray *.safetensors
    beside them (a consolidated duplicate) are ignored."""
    idx_path = os.path.join(ckpt_dir, "model.safetensors.index.json")
    if os.path.exists(idx_path):
        with open(idx_path) as f:
            weight_map = json.load(f)["weight_map"]
        files: Dict[str, SafetensorsFile] = {}
        index = {}
        for key, fname in weight_map.items():
            if fname not in files:
                path = os.path.join(ckpt_dir, fname)
                if not os.path.exists(path):
                    raise FileNotFoundError(
                        f"index.json references missing shard {fname}")
                files[fname] = SafetensorsFile(path)
            index[key] = files[fname]
        return index
    paths = sorted(glob.glob(os.path.join(ckpt_dir, "*.safetensors")))
    if not paths:
        raise FileNotFoundError(f"no *.safetensors under {ckpt_dir}")
    index = {}
    for p in paths:
        h = SafetensorsFile(p)
        for key in h.keys():
            index[key] = h
    return index


def _as_tensor(x) -> torch.Tensor:
    """A tensor, or a numpy array (a bf16 one from ml_dtypes included)."""
    if isinstance(x, torch.Tensor):
        return x
    a = np.ascontiguousarray(x)
    if not a.flags.writeable:
        a = a.copy()
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


class _TensorSource:
    """A safetensors directory or an in-memory dict of tensors or arrays;
    ``get`` returns the tensor on ``device`` cast to ``dtype``."""

    def __init__(self, ckpt_dir: Optional[str], tensors, dtype, device):
        self._dict = tensors
        self._index = _open_safetensors(ckpt_dir) if tensors is None else None
        self.dtype, self.device = dtype, device

    def get(self, name: str) -> torch.Tensor:
        if self._dict is not None:
            t = _as_tensor(self._dict[name]).to(self.device)
        else:
            t = self._index[name].get_tensor(name, self.device)
        return t.to(self.dtype)

    def has(self, name: str) -> bool:
        return name in (self._dict if self._dict is not None else self._index)


def _lin(src: _TensorSource, prefix: str) -> DenseLinear:
    b = src.get(prefix + ".bias") if src.has(prefix + ".bias") else None
    return DenseLinear(w=src.get(prefix + ".weight"), bias=b)


def load_dense_params(ckpt_dir: Optional[str],
                      cfg: Optional[ModelConfig] = None,
                      tensors: Optional[Dict[str, Any]] = None,
                      dtype=torch.bfloat16, device=None) -> Dict[str, Any]:
    """Load a Llama / Qwen2 / Mixtral HF checkpoint into the dense layout
    on ``device`` (default the GPU).  ``tensors`` (HF name -> tensor or
    numpy array) stands in for the directory's files."""
    device = resolve_device(device)
    if cfg is None:
        with open(os.path.join(ckpt_dir, "config.json")) as f:
            cfg = config_from_hf(json.load(f))
    src = _TensorSource(ckpt_dir, tensors, dtype, device)

    layers: List[Dict[str, Any]] = []
    for i in range(cfg.num_layers):
        pre = f"model.layers.{i}"
        p: Dict[str, Any] = {
            "ln1": src.get(f"{pre}.input_layernorm.weight"),
            "ln2": src.get(f"{pre}.post_attention_layernorm.weight"),
            "q": _lin(src, f"{pre}.self_attn.q_proj"),
            "k": _lin(src, f"{pre}.self_attn.k_proj"),
            "v": _lin(src, f"{pre}.self_attn.v_proj"),
            "o": _lin(src, f"{pre}.self_attn.o_proj"),
        }
        if cfg.is_moe:
            moe = f"{pre}.block_sparse_moe"
            p["router"] = _lin(src, f"{moe}.gate")
            p["experts"] = [{w: _lin(src, f"{moe}.experts.{e}.{w}")
                             for w in ("w1", "w3", "w2")}
                            for e in range(cfg.num_experts)]
        else:
            p["gate"] = _lin(src, f"{pre}.mlp.gate_proj")
            p["up"] = _lin(src, f"{pre}.mlp.up_proj")
            p["down"] = _lin(src, f"{pre}.mlp.down_proj")
        layers.append(p)

    embed = src.get("model.embed_tokens.weight")
    if cfg.tie_embeddings or not src.has("lm_head.weight"):
        lm_head = embed
    else:
        lm_head = src.get("lm_head.weight")
    return {"embed": embed, "final_ln": src.get("model.norm.weight"),
            "lm_head": lm_head, "layers": layers}


def export_dense_params(params: Dict[str, Any],
                        cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """Inverse mapping (the dense layout -> HF names), for tests and
    round trips."""
    out: Dict[str, torch.Tensor] = {
        "model.embed_tokens.weight": params["embed"],
        "model.norm.weight": params["final_ln"],
        "lm_head.weight": params["lm_head"],
    }

    def put(prefix, lin: DenseLinear):
        out[prefix + ".weight"] = lin.w
        if lin.bias is not None:
            out[prefix + ".bias"] = lin.bias

    for i, p in enumerate(params["layers"]):
        pre = f"model.layers.{i}"
        out[f"{pre}.input_layernorm.weight"] = p["ln1"]
        out[f"{pre}.post_attention_layernorm.weight"] = p["ln2"]
        for n, hf in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                      ("o", "o_proj")):
            put(f"{pre}.self_attn.{hf}", p[n])
        if "experts" in p:
            put(f"{pre}.block_sparse_moe.gate", p["router"])
            for e, ep in enumerate(p["experts"]):
                for w in ("w1", "w3", "w2"):
                    put(f"{pre}.block_sparse_moe.experts.{e}.{w}", ep[w])
        else:
            for n in ("gate", "up", "down"):
                put(f"{pre}.mlp.{n}_proj", p[n])
    return out


__all__ = ["config_from_hf", "load_dense_params", "export_dense_params"]
