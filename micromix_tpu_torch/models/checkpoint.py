"""Quantized-checkpoint serialization: bake once, serve many times.

Counterpart of ``micromix_tpu/models/checkpoint.py`` in the same on-disk
format, so a checkpoint baked by either package loads in the other:

    <path>/manifest.json   format_version 1, tree, config, meta
    <path>/arrays.npz      every array leaf (bf16 stored as a uint16 view,
                           float8_e4m3fn as a uint8 view)

Node kinds: dict / list / tuple / None / array and the containers
``MixedTensor``, ``ScaledW8`` (its ``base`` written as the (1, 1) int32
array the JAX package keeps), ``QuantLinear``, ``WeightOnlyLinear``,
``Int8TurboLinear``, ``DenseLinear``, ``QuantSite`` (``benes`` written as
none: the port gathers by ``perm``) and ``FakeQuantSite``.
A quantized tree loads through ``convert.from_jax_params``, which reads
containers by attribute name (and the node's kind where names are
shared); a dense tree comes back in the layout of
``random_dense_params``.

The JAX package's ``save_params_async`` writes its arrays through Orbax
(``array_container: orbax``): ``<path>/arrays_ocp``, an OCDBT key-value
store holding one zarr array per key of the manifest.  ``load_params``
(and ``load_params_async``, the JAX package's name) read that container
with ``tensorstore`` alone (zarr arrays in an ``ocdbt`` key-value
store), importing no JAX and no Orbax; without ``tensorstore`` they
raise.  The port's ``save_params_async`` writes the npz container on a
background thread instead (the machine with the card has no Orbax), so
the JAX package's ``load_params`` reads what it writes.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import types
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..mx.mxtensor import MixedTensor
from ..mx.scaledw8 import ScaledW8
from .common import (DenseLinear, FakeQuantSite, Int8TurboLinear, ModelConfig,
                     QuantLinear, QuantSite, WeightOnlyLinear)

FORMAT_VERSION = 1

# name -> (class, array/data fields, static fields), as the JAX package has
# them.  Statics go into the manifest, not the npz.
_NODE_TYPES = {
    "MixedTensor": (MixedTensor, ("fp4", "fp6", "fp8", "sf4", "sf6", "sf8"),
                    ("fp4_packed", "fp4_only")),
    "ScaledW8": (ScaledW8, ("codes", "base"), ("k4", "k6", "k8")),
    "QuantLinear": (QuantLinear, ("w", "bias"), ()),
    "Int8TurboLinear": (Int8TurboLinear, ("w", "w_scale", "bias"), ()),
    "WeightOnlyLinear": (WeightOnlyLinear, ("w", "bias"), ()),
    "DenseLinear": (DenseLinear, ("w", "bias"), ()),
    "QuantSite": (QuantSite, ("perm", "benes"), ("k4", "k6", "k8")),
    "FakeQuantSite": (FakeQuantSite, ("perm", "block_fmt"), ()),
}
_BY_CLASS = {cls: name for name, (cls, _, _) in _NODE_TYPES.items()}

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
    that carry their ``kind`` (``kinds`` collects the container kinds
    met)."""
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
    if kind not in _NODE_TYPES:
        raise ValueError(f"unknown checkpoint node kind {kind!r}")
    kinds.add(kind)
    kw = {f: _decode(s, arrays, kinds) for f, s in spec["fields"].items()}
    kw.update(spec["statics"])
    return types.SimpleNamespace(kind=kind, **kw)


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


def _manifest(params: Any, cfg: Optional[ModelConfig],
              meta: Optional[Dict[str, Any]]):
    """-> (the manifest, its arrays as host numpy arrays)."""
    arrays: Dict[str, np.ndarray] = {}
    tree = _encode(params, arrays, "params")
    return {
        "format_version": FORMAT_VERSION,
        "tree": tree,
        "config": dataclasses.asdict(cfg) if cfg is not None else None,
        "meta": meta or {},
    }, arrays


def _write(path: str, manifest: Dict[str, Any], arrays) -> None:
    np.savez(os.path.join(path, "arrays.npz"), **arrays)
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f)


def save_params(path: str, params: Any, cfg: Optional[ModelConfig] = None,
                meta: Optional[Dict[str, Any]] = None) -> None:
    """Serialize a (quantized or dense) parameter tree to ``path``/."""
    os.makedirs(path, exist_ok=True)
    _write(path, *_manifest(params, cfg, meta))


class AsyncSave:
    """The handle ``save_params_async`` returns: the write runs on a
    background thread; ``wait_until_finished()`` joins it and raises what
    it raised (as the JAX package's Orbax ``AsyncCheckpointer``)."""

    def __init__(self, fn):
        self._error: Optional[BaseException] = None

        def run():
            try:
                fn()
            except Exception as e:  # raised by wait_until_finished
                self._error = e

        self._thread = threading.Thread(target=run, daemon=False)
        self._thread.start()

    def wait_until_finished(self) -> None:
        self._thread.join()
        if self._error is not None:
            raise self._error


def save_params_async(path: str, params: Any,
                      cfg: Optional[ModelConfig] = None,
                      meta: Optional[Dict[str, Any]] = None) -> AsyncSave:
    """``save_params`` with the file writes on a background thread: the
    tree is copied to host arrays before this returns (the caller may
    change or free its tensors at once), then ``arrays.npz`` and, last,
    ``manifest.json`` are written.  The container is npz, not the JAX
    package's Orbax one: the JAX package's ``load_params`` reads it."""
    os.makedirs(path, exist_ok=True)
    manifest, arrays = _manifest(params, cfg, meta)
    return AsyncSave(lambda: _write(path, manifest, arrays))


def _array_keys(spec: Dict[str, Any]):
    """The npz / Orbax keys of a manifest tree's arrays."""
    if spec["kind"] == "array":
        yield spec["key"]
        return
    children = spec.get("items", spec.get("fields", ()))
    for child in (children.values() if isinstance(children, dict) else children):
        yield from _array_keys(child)


def _read_orbax(path: str, manifest: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Every array of an Orbax container (``<path>/arrays_ocp``) by its
    manifest key, through tensorstore alone: zarr arrays in the OCDBT
    key-value store, one path a key.  bf16 arrays come back as their uint16
    bits (the JAX package writes them as such a view; an ml_dtypes
    bfloat16 is viewed so too)."""
    try:
        import tensorstore as ts
    except ImportError as e:
        raise ImportError(
            "reading an Orbax checkpoint (array_container: orbax) needs the "
            "tensorstore package, which is not installed here") from e
    base = "file://" + os.path.join(os.path.abspath(path), "arrays_ocp")
    ctx = ts.Context()
    arrays = {}
    for key in _array_keys(manifest["tree"]):
        a = ts.open({"driver": "zarr", "kvstore": {"driver": "ocdbt",
                                                   "base": base, "path": key}},
                    open=True, context=ctx).result().read().result()
        if a.dtype.name == "bfloat16":
            a = a.view(np.uint16)
        arrays[key] = a
    return arrays


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
    container = manifest.get("array_container", "npz")
    if container not in ("npz", "orbax"):
        raise ValueError(f"unknown array container {container!r}")
    cfg = (ModelConfig(**manifest["config"])
           if manifest["config"] is not None else None)
    kinds: set = set()
    if container == "orbax":
        tree = _decode(manifest["tree"], _read_orbax(path, manifest), kinds)
    else:
        with np.load(os.path.join(path, "arrays.npz")) as arrays:
            tree = _decode(manifest["tree"], arrays, kinds)
    if kinds - {"DenseLinear"}:
        params = from_jax_params(tree, cfg, device)
    else:
        params = _dense(tree, resolve_device(device))
    return params, cfg, manifest["meta"]


def load_params_async(path: str, device=None
                      ) -> Tuple[Any, Optional[ModelConfig], Dict[str, Any]]:
    """The JAX package's name for reading a ``save_params_async``
    checkpoint: ``load_params``, which reads either container."""
    return load_params(path, device)


__all__ = ["save_params", "load_params", "save_params_async",
           "load_params_async", "AsyncSave", "FORMAT_VERSION"]
