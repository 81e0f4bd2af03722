"""Quantized-checkpoint serialization: bake once, serve many times.

Counterpart of ``micromix_tpu/models/checkpoint.py`` in the same on-disk
format, so a checkpoint baked by either package loads in the other:

    <path>/manifest.json   format_version 1, tree, config, meta
    <path>/arrays.npz      every array leaf (bf16 stored as a uint16 view,
                           float8_e4m3fn as a uint8 view)

Node kinds: dict / list / tuple / None / array and the containers
``MixedTensor``, ``ScaledW8`` (its ``base`` written as the (1, 1) int32
array the JAX package keeps), ``QuantLinear``, ``DenseLinear`` and
``QuantSite`` (``benes`` written as none: the port gathers by ``perm``).
A quantized tree loads through ``convert.from_jax_params``, which reads
containers by attribute name; a dense tree comes back in the layout of
``random_dense_params``.  The JAX package's ``Int8TurboLinear``,
``WeightOnlyLinear`` and ``FakeQuantSite`` have no counterpart in the port
yet (ROADMAP item 8), nor do its orbax checkpoints
(``save_params_async`` / ``load_params_async``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import types
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..mx.mxtensor import MixedTensor
from ..mx.scaledw8 import ScaledW8
from .common import DenseLinear, ModelConfig, QuantLinear, QuantSite

FORMAT_VERSION = 1

# name -> (class, array/data fields, static fields), as the JAX package has
# them.  Statics go into the manifest, not the npz.
_NODE_TYPES = {
    "MixedTensor": (MixedTensor, ("fp4", "fp6", "fp8", "sf4", "sf6", "sf8"),
                    ("fp4_packed", "fp4_only")),
    "ScaledW8": (ScaledW8, ("codes", "base"), ("k4", "k6", "k8")),
    "QuantLinear": (QuantLinear, ("w", "bias"), ()),
    "DenseLinear": (DenseLinear, ("w", "bias"), ()),
    "QuantSite": (QuantSite, ("perm", "benes"), ("k4", "k6", "k8")),
}
_BY_CLASS = {cls: name for name, (cls, _, _) in _NODE_TYPES.items()}
_NOT_PORTED = ("Int8TurboLinear", "WeightOnlyLinear", "FakeQuantSite")

# dtypes numpy cannot save, as same-width integer views
_VIEW_AS = {"bfloat16": (torch.bfloat16, torch.int16, np.uint16),
            "float8_e4m3fn": (torch.float8_e4m3fn, torch.uint8, np.uint8)}


def _to_numpy(x) -> Tuple[np.ndarray, str]:
    """A leaf -> (the array to store, the dtype name the manifest gives)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        for name, (dt, view, np_view) in _VIEW_AS.items():
            if x.dtype == dt:
                return x.contiguous().view(view).numpy().view(np_view), name
        return x.numpy(), x.numpy().dtype.name
    a = np.asarray(x)
    return a, a.dtype.name


def _static(v):
    return v if isinstance(v, bool) else int(v)


def _encode(node: Any, arrays: Dict[str, np.ndarray], prefix: str):
    if node is None:
        return {"kind": "none"}
    name = _BY_CLASS.get(type(node))
    if name is not None:
        _, fields, statics = _NODE_TYPES[name]
        enc = {}
        for f in fields:
            v = getattr(node, f)
            if name == "ScaledW8" and f == "base":
                v = np.full((1, 1), v, np.int32)
            if name == "QuantSite" and f == "benes":
                v = None
            enc[f] = _encode(v, arrays, f"{prefix}.{f}")
        return {"kind": name, "fields": enc,
                "statics": {s: _static(getattr(node, s)) for s in statics}}
    if isinstance(node, dict):
        return {"kind": "dict",
                "items": {k: _encode(v, arrays, f"{prefix}.{k}")
                          for k, v in node.items()}}
    if isinstance(node, (list, tuple)):
        return {"kind": "list" if isinstance(node, list) else "tuple",
                "items": [_encode(v, arrays, f"{prefix}.{i}")
                          for i, v in enumerate(node)]}
    if dataclasses.is_dataclass(node):
        raise NotImplementedError(
            f"no checkpoint node for {type(node).__name__}: save the params "
            "before the engine stacks them (as quantize_model returns them)")
    a, dtype = _to_numpy(node)
    key = f"a{len(arrays)}"
    arrays[key] = a
    return {"kind": "array", "key": key, "dtype": dtype, "path": prefix}


def _decode(spec: Dict[str, Any], arrays, kinds: set) -> Any:
    """The manifest's tree -> CPU tensors, containers as attribute objects
    (``kinds`` collects the container kinds met)."""
    kind = spec["kind"]
    if kind == "none":
        return None
    if kind == "array":
        a = np.ascontiguousarray(arrays[spec["key"]])
        if spec["dtype"] in _VIEW_AS:
            dt, view, _ = _VIEW_AS[spec["dtype"]]
            return torch.from_numpy(a).view(view).view(dt)
        return torch.from_numpy(a)
    if kind == "dict":
        return {k: _decode(v, arrays, kinds) for k, v in spec["items"].items()}
    if kind in ("list", "tuple"):
        items = [_decode(v, arrays, kinds) for v in spec["items"]]
        return items if kind == "list" else tuple(items)
    if kind in _NOT_PORTED:
        raise NotImplementedError(
            f"checkpoint node {kind}: the port has no such container yet "
            "(ROADMAP item 8)")
    if kind not in _NODE_TYPES:
        raise ValueError(f"unknown checkpoint node kind {kind!r}")
    kinds.add(kind)
    kw = {f: _decode(s, arrays, kinds) for f, s in spec["fields"].items()}
    kw.update(spec["statics"])
    return types.SimpleNamespace(**kw)


def _dense(node: Any, device) -> Any:
    """A decoded dense tree -> tensors on ``device``, DenseLinear nodes."""
    if isinstance(node, torch.Tensor):
        return node.to(device)
    if isinstance(node, types.SimpleNamespace):
        return DenseLinear(w=_dense(node.w, device), bias=_dense(node.bias, device))
    if isinstance(node, dict):
        return {k: _dense(v, device) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_dense(v, device) for v in node)
    return node


def save_params(path: str, params: Any, cfg: Optional[ModelConfig] = None,
                meta: Optional[Dict[str, Any]] = None) -> None:
    """Serialize a (quantized or dense) parameter tree to ``path``/."""
    os.makedirs(path, exist_ok=True)
    arrays: Dict[str, np.ndarray] = {}
    tree = _encode(params, arrays, "params")
    manifest = {
        "format_version": FORMAT_VERSION,
        "tree": tree,
        "config": dataclasses.asdict(cfg) if cfg is not None else None,
        "meta": meta or {},
    }
    np.savez(os.path.join(path, "arrays.npz"), **arrays)
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f)


def load_params(path: str, device=None) -> Tuple[Any, Optional[ModelConfig],
                                                 Dict[str, Any]]:
    """Inverse of save_params: -> (params on ``device``, config | None,
    meta).  A quantized tree comes back as ``convert.from_jax_params``
    makes it from the JAX package's tree."""
    from ..convert import from_jax_params
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    if manifest["format_version"] != FORMAT_VERSION:
        raise ValueError(
            f"unsupported checkpoint version {manifest['format_version']}")
    if manifest.get("array_container", "npz") != "npz":
        raise NotImplementedError(
            "orbax checkpoints (save_params_async) are not ported")
    cfg = (ModelConfig(**manifest["config"])
           if manifest["config"] is not None else None)
    kinds: set = set()
    with np.load(os.path.join(path, "arrays.npz")) as arrays:
        tree = _decode(manifest["tree"], arrays, kinds)
    if kinds - {"DenseLinear"}:
        params = from_jax_params(tree, cfg, device)
    else:
        params = _dense(tree, resolve_device(device))
    return params, cfg, manifest["meta"]


__all__ = ["save_params", "load_params", "FORMAT_VERSION"]
