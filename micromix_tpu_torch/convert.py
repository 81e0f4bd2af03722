"""Carry the JAX package's quantized parameters over to the port.

``from_jax_params`` takes the JAX package's quantized Llama or Mixtral
pytree with its leaves already turned into numpy arrays (``jax.tree.map
(np.asarray, params)``) and returns the port's parameter dict.  It reads
the containers by attribute name only (``w.codes``, ``w.base``,
``w.fp4`` ..., ``site.perm``), so it needs neither ``jax`` nor
``micromix_tpu``; ``models.checkpoint.load_params`` hands it the JAX
package's on-disk trees with CPU tensors for leaves.  Weights come over
as ScaledW8 or as split-plane ``MixedTensor`` (``fp4_packed`` and
``fp4_only`` kept).
The Benes routes are dropped: they encode the same permutation as
``perm`` for the TPU's lanes.  A pytree that the JAX package's
``stack_layer_projections`` has stacked carries ``qkv_stack`` /
``gateup_stack`` (ScaledW8Stack or SplitPlaneStack) in place of q/k/v
and gate/up, and
``experts_grouped`` (two GroupedW8 and the (E, K) site permutations) in
place of ``experts``; they come over as the port's containers with their
own padding.  A Mixtral router comes over as a bf16 ``DenseLinear``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .device import resolve_device
from .models.common import DenseLinear, ModelConfig, QuantLinear, QuantSite
from .mx.mxtensor import MixedTensor, SplitPlaneStack
from .mx.scaledw8 import GroupedW8, ScaledW8, ScaledW8Stack

_SITES = ("attn_site", "o_site", "mlp_site", "down_site")
_LINEARS = ("q", "k", "v", "o", "gate", "up", "down")
_STACKS = ("qkv_stack", "gateup_stack")


def to_tensor(a, device) -> torch.Tensor:
    """numpy array (bf16 from ml_dtypes included) or tensor -> tensor on
    ``device``."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def mixed_from_jax(t, device) -> MixedTensor:
    """A JAX MixedTensor (numpy leaves) -> the port's."""
    return MixedTensor(
        **{f: to_tensor(np.asarray(getattr(t, f), np.uint8), device)
           for f in ("fp4", "fp6", "fp8", "sf4", "sf6", "sf8")},
        fp4_packed=bool(t.fp4_packed), fp4_only=bool(t.fp4_only))


def weight_from_jax(w, device):
    """A JAX ScaledW8 or split-plane MixedTensor (numpy leaves) -> the
    port's."""
    if hasattr(w, "codes") and hasattr(w, "base"):
        return ScaledW8(codes=to_tensor(w.codes, device),
                        base=int(np.asarray(w.base).reshape(-1)[0]),
                        k4=w.k4, k6=w.k6, k8=w.k8)
    if hasattr(w, "fp4") and hasattr(w, "fp4_packed"):
        return mixed_from_jax(w, device)
    raise NotImplementedError(f"no port of weights of type {type(w).__name__}")


def stack_from_jax(st, device):
    """A JAX ScaledW8Stack or SplitPlaneStack (numpy leaves) -> the
    port's, padding kept."""
    split_plane = hasattr(st, "mt")
    if not split_plane and not all(hasattr(st, a)
                                   for a in ("codes", "bases", "padded")):
        raise NotImplementedError(
            f"no port of stacks of type {type(st).__name__}")
    biases = tuple(None if b is None else to_tensor(b, device)
                   for b in st.biases)
    if split_plane:
        return SplitPlaneStack(mt=mixed_from_jax(st.mt, device), biases=biases,
                               sections=tuple(st.sections),
                               padded=tuple(st.padded))
    return ScaledW8Stack(
        codes=to_tensor(st.codes, device),
        bases=tuple(int(b) for b in np.asarray(st.bases).reshape(-1)),
        biases=tuple(None if b is None else to_tensor(b, device)
                     for b in st.biases),
        sections=tuple(st.sections), padded=tuple(st.padded),
        k4=st.k4, k6=st.k6, k8=st.k8)


def grouped_from_jax(gw, device) -> GroupedW8:
    """A JAX GroupedW8 (numpy leaves) -> the port's, padding kept."""
    bases = np.asarray(gw.bases).reshape(np.asarray(gw.codes).shape[0], -1)
    return GroupedW8(
        codes=to_tensor(gw.codes, device),
        bases=tuple(tuple(int(b) for b in row) for row in bases),
        biases=tuple(None if b is None else to_tensor(b, device)
                     for b in gw.biases),
        sections=tuple(gw.sections), padded=tuple(gw.padded),
        k4=gw.k4, k6=gw.k6, k8=gw.k8)


def from_jax_params(np_tree: Dict[str, Any], cfg: ModelConfig,
                    device=None) -> Dict[str, Any]:
    """JAX quantized params (numpy leaves) -> the port's params on ``device``."""
    dev = resolve_device(device)

    def lin(q) -> QuantLinear:
        return QuantLinear(w=weight_from_jax(q.w, dev), bias=None
                           if q.bias is None else to_tensor(q.bias, dev))

    def site(s) -> QuantSite:
        perm = None if s.perm is None else to_tensor(
            np.asarray(s.perm, np.int32), dev)
        return QuantSite(k4=s.k4, k6=s.k6, k8=s.k8, perm=perm)

    def expert(ep) -> Dict[str, Any]:
        return {"site_in": site(ep["site_in"]), "site_down": site(ep["site_down"]),
                **{n: lin(ep[n]) for n in ("w1", "w3", "w2")}}

    def grouped(gr) -> Dict[str, Any]:
        return {"w13": grouped_from_jax(gr["w13"], dev),
                "w2": grouped_from_jax(gr["w2"], dev),
                "perm": None if gr["perm"] is None else to_tensor(
                    np.asarray(gr["perm"], np.int32), dev),
                "site_in": site(gr["site_in"]),
                "site_down": site(gr["site_down"])}

    layers = []
    for p in np_tree["layers"]:
        out = {"ln1": to_tensor(p["ln1"], dev), "ln2": to_tensor(p["ln2"], dev)}
        out.update({n: site(p[n]) for n in _SITES if n in p})
        out.update({n: lin(p[n]) for n in _LINEARS if n in p})
        out.update({n: stack_from_jax(p[n], dev) for n in _STACKS if n in p})
        if "router" in p:
            r = p["router"]
            out["router"] = DenseLinear(
                w=to_tensor(r.w, dev),
                bias=None if r.bias is None else to_tensor(r.bias, dev))
        if "experts" in p:
            out["experts"] = [expert(ep) for ep in p["experts"]]
        if "experts_grouped" in p:
            out["experts_grouped"] = grouped(p["experts_grouped"])
        layers.append(out)
    return {"embed": to_tensor(np_tree["embed"], dev),
            "final_ln": to_tensor(np_tree["final_ln"], dev),
            "lm_head": to_tensor(np_tree["lm_head"], dev),
            "layers": layers}
