"""Carry the JAX package's quantized parameters over to the port.

``from_jax_params`` takes the JAX package's quantized dense-Llama pytree
with its leaves already turned into numpy arrays (``jax.tree.map
(np.asarray, params)``) and returns the port's parameter dict.  It reads
the containers by attribute name only (``w.codes``, ``w.base``,
``site.perm`` ...), so it needs neither ``jax`` nor ``micromix_tpu``.
The Benes routes are dropped: they encode the same permutation as
``perm`` for the TPU's lanes.  A pytree that the JAX package's
``stack_layer_projections`` has stacked carries ``qkv_stack`` /
``gateup_stack`` (ScaledW8Stack) in place of q/k/v and gate/up; they come
over as the port's ``ScaledW8Stack`` with their own padding.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .device import resolve_device
from .models.common import ModelConfig, QuantLinear, QuantSite
from .mx.scaledw8 import ScaledW8, ScaledW8Stack

_SITES = ("attn_site", "o_site", "mlp_site", "down_site")
_LINEARS = ("q", "k", "v", "o", "gate", "up", "down")
_STACKS = ("qkv_stack", "gateup_stack")


def to_tensor(a, device) -> torch.Tensor:
    """numpy array (bf16 from ml_dtypes included) -> tensor on ``device``."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def stack_from_jax(st, device) -> ScaledW8Stack:
    """A JAX ScaledW8Stack (numpy leaves) -> the port's, padding kept."""
    if not all(hasattr(st, a) for a in ("codes", "bases", "padded")):
        raise NotImplementedError(
            f"only ScaledW8 stacks are ported, got {type(st).__name__}")
    return ScaledW8Stack(
        codes=to_tensor(st.codes, device),
        bases=tuple(int(b) for b in np.asarray(st.bases).reshape(-1)),
        biases=tuple(None if b is None else to_tensor(b, device)
                     for b in st.biases),
        sections=tuple(st.sections), padded=tuple(st.padded),
        k4=st.k4, k6=st.k6, k8=st.k8)


def from_jax_params(np_tree: Dict[str, Any], cfg: ModelConfig,
                    device=None) -> Dict[str, Any]:
    """JAX quantized params (numpy leaves) -> the port's params on ``device``."""
    if cfg.is_moe:
        raise NotImplementedError("only dense Llama parameters are ported")
    dev = resolve_device(device)

    def lin(q) -> QuantLinear:
        w = q.w
        if not hasattr(w, "codes") or not hasattr(w, "base"):
            raise NotImplementedError(
                f"only ScaledW8 weights are ported, got {type(w).__name__}")
        sw = ScaledW8(codes=to_tensor(w.codes, dev),
                      base=int(np.asarray(w.base).reshape(-1)[0]),
                      k4=w.k4, k6=w.k6, k8=w.k8)
        return QuantLinear(w=sw, bias=None if q.bias is None
                           else to_tensor(q.bias, dev))

    def site(s) -> QuantSite:
        perm = None if s.perm is None else to_tensor(
            np.asarray(s.perm, np.int32), dev)
        return QuantSite(k4=s.k4, k6=s.k6, k8=s.k8, perm=perm)

    layers = []
    for p in np_tree["layers"]:
        out = {"ln1": to_tensor(p["ln1"], dev), "ln2": to_tensor(p["ln2"], dev)}
        out.update({n: site(p[n]) for n in _SITES})
        out.update({n: lin(p[n]) for n in _LINEARS if n in p})
        out.update({n: stack_from_jax(p[n], dev) for n in _STACKS if n in p})
        layers.append(out)
    return {"embed": to_tensor(np_tree["embed"], dev),
            "final_ln": to_tensor(np_tree["final_ln"], dev),
            "lm_head": to_tensor(np_tree["lm_head"], dev),
            "layers": layers}
