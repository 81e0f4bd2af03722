"""Model surgery: dense bf16 parameters -> MX-quantized parameters.

Counterpart of ``micromix_tpu/models/surgery.py`` for Llama and Mixtral:
each linear's input channels are permuted by its site's calibration
reorder and the weight is quantized per 32-block, MXFP4 in every segment
(``weight_fp4_only``, the default) or MXFP4/6/8 by segment.  The weight
layout (``layout``): "auto" packs fp4-only weights as ScaledW8 (one byte
a weight) and keeps the others split-plane, as it keeps a weight whose
scaled-exponent span exceeds 62; "splitplane" keeps every weight as a
split-plane ``MixedTensor`` (fp4 packed two to a byte: about 0.59 bytes a
weight, the capacity-first choice).  The down-proj channel permutation
is baked into the gate / up (an expert's w1 / w3) weight rows, so the
silu site needs no gather.  The MoE router stays bf16.  Codes, scales and
base are bit-identical to the JAX package's for the same dense weights.

``quantize_model_weight_only`` (MX weights, bf16 activations, no
calibration) and ``quantize_model_int8_turbo`` (W8A8 per-channel int8)
turn every decoder linear into a ``WeightOnlyLinear`` or an
``Int8TurboLinear``, with no sites; ``models/hetero.py`` holds the
budgets-as-data form.

``stack_layer_projections`` is the serving engine's init transform: each
site's consumers (q|k|v, gate|up) become one ``ScaledW8Stack`` or
``SplitPlaneStack``, and a layer's ScaledW8 experts one grouped form
(``GroupedW8`` w1|w3 and w2).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..mx import layout as lay
from ..mx.mxtensor import (MixedTensor, dequantize_mixed, pack_mixed,
                           quantize_mixed, stack_split_plane)
from ..mx.numerics import div
from ..mx.scaledw8 import (ScaledW8, encode_scaled_values, group_scaled_w8,
                           pack_scaled_w8, stack_scaled_w8)
from .common import (DenseLinear, Int8TurboLinear, ModelConfig, QuantLinear,
                     QuantSite, WeightOnlyLinear)

ATTN_IN = "attn_in"    # -> q, k, v
O_IN = "o_in"          # -> o
MLP_IN = "mlp_in"      # -> gate, up
DOWN_IN = "down_in"    # -> down


@dataclasses.dataclass
class SiteCalibration:
    """reorder_index: (K,) original channel per sorted position; p6/p8: the
    fp6 / fp8 segment widths (multiples of 128)."""

    reorder_index: np.ndarray
    p6_num: int
    p8_num: int

    def splits(self, k: int) -> Tuple[int, int, int]:
        k4 = k - self.p6_num - self.p8_num
        assert 0 <= k4 <= k, (k, self.p6_num, self.p8_num)
        return (k4, self.p6_num, self.p8_num)


LayerCalib = Dict[str, SiteCalibration]


def identity_calibration(k: int, p6: int = 0, p8: int = 0) -> SiteCalibration:
    """A site's calibration in channel order with the given budgets."""
    return SiteCalibration(np.arange(k, dtype=np.int32), int(p6), int(p8))


def make_site(calib: SiteCalibration, k: int, device=None) -> QuantSite:
    k4, k6, k8 = calib.splits(k)
    perm = lay.compose_segmented(calib.reorder_index, k4, k6, k8)
    return QuantSite(k4=k4, k6=k6, k8=k8,
                     perm=torch.as_tensor(perm, dtype=torch.int32, device=device))


LAYOUTS = ("auto", "splitplane")


def _weight_layout(wq: MixedTensor, layout: str):
    """An unpacked MixedTensor -> the layout's weight: "auto" packs an
    fp4-only weight as ScaledW8 unless its scaled-exponent span exceeds 62
    (then, like every other weight, it stays split-plane, fp4 packed)."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout {layout!r} not in {LAYOUTS}")
    if layout == "auto" and wq.fp4_only:
        try:
            return pack_scaled_w8(wq)
        except ValueError:
            pass
    return pack_mixed(wq)


def _quantize_host(wp: torch.Tensor, k4: int, k6: int, k8: int,
                   weight_fp4_only: bool, layout: str):
    """A permuted f32 weight in host memory, quantized by the native
    library (``utils.native``, multithreaded C++, bit for bit
    ``quantize_mixed``): ScaledW8 from the fused quantize + pack where
    "auto" takes an fp4-only weight and its exponents fit, else the
    unpacked-layout MixedTensor (fp4 packed) for ``_weight_layout``."""
    from ..utils.native import quantize_mixed_host, quantize_scaledw8_host
    x = wp.numpy()
    if layout == "auto" and weight_fp4_only:
        got = quantize_scaledw8_host(x, k4, k6, k8)
        if got is not None:
            return ScaledW8(codes=torch.from_numpy(got[0]), base=got[1],
                            k4=k4, k6=k6, k8=k8)
    segs = quantize_mixed_host(x, k4, k6, k8, weight_fp4_only=weight_fp4_only)
    return MixedTensor(**{f: torch.from_numpy(segs[f])
                          for f in ("fp4", "fp6", "fp8", "sf4", "sf6", "sf8")},
                       fp4_packed=bool(k4), fp4_only=weight_fp4_only)


def quantize_linear(w: torch.Tensor, calib: SiteCalibration,
                    bias: Optional[torch.Tensor] = None, *,
                    row_perm: Optional[np.ndarray] = None,
                    weight_fp4_only: bool = True,
                    layout: str = "auto", host: bool = False) -> QuantLinear:
    """w (N, K) dense -> QuantLinear (input channels permuted by the
    calibration, rows by ``row_perm`` when given, and a bias with them),
    ScaledW8 or split-plane as ``layout`` and ``weight_fp4_only`` give.
    ``host=True`` quantizes a weight held in host memory with the native
    library (``_quantize_host``), bit for bit as ``quantize_mixed`` does;
    the shell's ``quantize`` on the CPU takes it."""
    if host and w.device.type != "cpu":
        raise ValueError("host=True quantizes weights held in host memory, "
                         f"not on {w.device}")
    k4, k6, k8 = calib.splits(w.shape[1])
    idx = torch.as_tensor(np.asarray(calib.reorder_index), dtype=torch.long,
                          device=w.device)
    wp = w[:, idx]
    if row_perm is not None:
        rows = torch.as_tensor(np.asarray(row_perm), dtype=torch.long,
                               device=w.device)
        wp = wp[rows]
        if bias is not None:
            bias = bias[rows]
    wp = wp.to(torch.float32)
    wq = (_quantize_host(wp, k4, k6, k8, weight_fp4_only, layout) if host
          else quantize_mixed(wp, k4, k6, k8, weight_fp4_only=weight_fp4_only))
    return QuantLinear(w=wq if isinstance(wq, ScaledW8) else _weight_layout(wq, layout),
                       bias=None if bias is None else bias.to(torch.bfloat16))


def _down_row_perm(calib: SiteCalibration, k: int) -> np.ndarray:
    """Row permutation for gate/up so the silu output is in device layout."""
    return lay.compose_segmented(calib.reorder_index, *calib.splits(k))


def quantize_layer(p: Dict[str, Any], cfg: ModelConfig, calib: LayerCalib, *,
                   weight_fp4_only: bool = True,
                   layout: str = "auto", host: bool = False) -> Dict[str, Any]:
    """One dense decoder-layer dict -> quantized layer dict (``host``: see
    ``quantize_linear``)."""
    ql = functools.partial(quantize_linear, weight_fp4_only=weight_fp4_only,
                           layout=layout, host=host)
    dev = p["ln1"].device
    hid, inter = cfg.hidden_size, cfg.intermediate_size
    out: Dict[str, Any] = {"ln1": p["ln1"], "ln2": p["ln2"]}
    c_attn = calib[ATTN_IN]
    out["attn_site"] = make_site(c_attn, hid, dev)
    for name in ("q", "k", "v"):
        out[name] = ql(p[name].w, c_attn, p[name].bias)
    c_o = calib[O_IN]
    out["o_site"] = make_site(c_o, cfg.num_heads * cfg.head_dim, dev)
    out["o"] = ql(p["o"].w, c_o, p["o"].bias)
    if cfg.is_moe:
        out["router"] = p["router"]
        experts = []
        for e, ep in enumerate(p["experts"]):
            c_in = calib[f"expert{e}_{MLP_IN}"]
            c_dn = calib[f"expert{e}_{DOWN_IN}"]
            rp = _down_row_perm(c_dn, inter)
            experts.append({
                "site_in": make_site(c_in, hid, dev),
                "site_down": QuantSite(*c_dn.splits(inter)),
                "w1": ql(ep["w1"].w, c_in, ep["w1"].bias, row_perm=rp),
                "w3": ql(ep["w3"].w, c_in, ep["w3"].bias, row_perm=rp),
                "w2": ql(ep["w2"].w, c_dn, ep["w2"].bias),
            })
        out["experts"] = experts
        return out
    c_mlp, c_dn = calib[MLP_IN], calib[DOWN_IN]
    out["mlp_site"] = make_site(c_mlp, hid, dev)
    out["down_site"] = QuantSite(*c_dn.splits(inter))
    rp = _down_row_perm(c_dn, inter)
    for name in ("gate", "up"):
        out[name] = ql(p[name].w, c_mlp, p[name].bias, row_perm=rp)
    out["down"] = ql(p["down"].w, c_dn, p["down"].bias)
    return out


def quantize_model(params: Dict[str, Any], cfg: ModelConfig,
                   calibs: List[LayerCalib], *, weight_fp4_only: bool = True,
                   layout: str = "auto", host: bool = False) -> Dict[str, Any]:
    """Dense model dict -> quantized model dict (embed / norms / head stay
    bf16).  Each layer is quantized on the device its weights lie on, with
    ``host=True`` (weights in host memory) by the native library."""
    assert len(calibs) == cfg.num_layers
    return {
        "embed": params["embed"],
        "final_ln": params["final_ln"],
        "lm_head": params["lm_head"],
        "layers": [quantize_layer(p, cfg, c, weight_fp4_only=weight_fp4_only,
                                  layout=layout, host=host)
                   for p, c in zip(params["layers"], calibs)],
    }


def _convert_linears(params: Dict[str, Any], cfg: ModelConfig,
                     conv) -> Dict[str, Any]:
    """Every decoder linear through ``conv`` (the MoE router, embeddings,
    norms and head stay bf16); no sites."""

    def layer(p):
        out = {"ln1": p["ln1"], "ln2": p["ln2"]}
        for name in ("q", "k", "v", "o"):
            out[name] = conv(p[name])
        if cfg.is_moe:
            out["router"] = p["router"]
            out["experts"] = [{n: conv(ep[n]) for n in ("w1", "w3", "w2")}
                              for ep in p["experts"]]
        else:
            for name in ("gate", "up", "down"):
                out[name] = conv(p[name])
        return out

    return {"embed": params["embed"], "final_ln": params["final_ln"],
            "lm_head": params["lm_head"],
            "layers": [layer(p) for p in params["layers"]]}


WEIGHT_ONLY_FORMATS = {"mxfp4": lambda k: (k, 0, 0),
                       "mxfp6": lambda k: (0, k, 0),
                       "mxfp8": lambda k: (0, 0, k)}


def quantize_model_weight_only(params: Dict[str, Any], cfg: ModelConfig,
                               fmt: str = "mxfp8") -> Dict[str, Any]:
    """Weight-only MX quantization: every decoder linear a
    ``WeightOnlyLinear`` with the whole K axis in one MX format, in its
    own column order (no calibration, no reorder).  MXFP4 is a
    canonical-order ScaledW8 (Kernel B runs it), MXFP6 and MXFP8 a
    ``MixedTensor``."""
    if fmt not in WEIGHT_ONLY_FORMATS:
        raise ValueError(f"weight-only format {fmt!r} not in "
                         f"{tuple(WEIGHT_ONLY_FORMATS)}")
    budget = WEIGHT_ONLY_FORMATS[fmt]

    def conv(lin):
        k = lin.w.shape[1]
        wq = quantize_mixed(lin.w.to(torch.float32), *budget(k),
                            weight_fp4_only=False)
        if fmt == "mxfp4":
            codes, base = encode_scaled_values(dequantize_mixed(wq))
            wq = ScaledW8(codes=codes, base=base, k4=k, k6=0, k8=0)
        return WeightOnlyLinear(w=wq, bias=None if lin.bias is None
                                else lin.bias.to(torch.bfloat16))

    return _convert_linears(params, cfg, conv)


def quantize_model_int8_turbo(params: Dict[str, Any],
                              cfg: ModelConfig) -> Dict[str, Any]:
    """Every decoder linear -> ``Int8TurboLinear``: symmetric
    per-output-channel int8 weights, scale max |w| / 127 (true divisions,
    round half to even, clipped to +-127), as the JAX package computes
    them in f32 numpy."""

    def conv(lin):
        w = lin.w.to(torch.float32)
        s = div(torch.clamp(w.abs().amax(dim=1), min=1e-12), 127.0)
        q = torch.clamp(torch.round(w / s[:, None]), -127, 127).to(torch.int8)
        return Int8TurboLinear(w=q, w_scale=s, bias=None if lin.bias is None
                               else lin.bias.to(torch.bfloat16))

    return _convert_linears(params, cfg, conv)


_STACKS = (("qkv_stack", ("q", "k", "v"), "attn_site"),
           ("gateup_stack", ("gate", "up"), "mlp_site"))


def _stacker(p, names, site_key):
    """The stack builder for a site's consumers: ``stack_scaled_w8`` when
    all are ScaledW8, ``stack_split_plane`` when all are split-plane with
    the fp4 segment packed, else None."""
    if not isinstance(p.get(site_key), QuantSite) or not all(
            isinstance(p.get(n), QuantLinear) for n in names):
        return None
    ws = [p[n].w for n in names]
    if all(isinstance(w, ScaledW8) for w in ws):
        return stack_scaled_w8
    if all(isinstance(w, MixedTensor) and (w.fp4_packed or w.k4 == 0)
           for w in ws):
        return stack_split_plane
    return None


def stack_layer_projections(params: Dict[str, Any],
                            memo: Optional[dict] = None) -> Dict[str, Any]:
    """Per layer, replace the q/k/v and gate/up QuantLinears with one
    row-stacked ``ScaledW8Stack`` or ``SplitPlaneStack`` each
    (``qkv_stack``, ``gateup_stack``), so decode runs each site's
    consumers as one stacked GEMM and prefill as one wide product, with
    the same values; and a layer's per-expert ScaledW8 dicts with their
    grouped form (``experts_grouped``, see ``_group_experts``), so the
    experts run as two grouped GEMMs.

    The per-weight entries are removed: the stack is the only copy.
    Aliased layer dicts map to one stacked dict through ``memo`` (pass one
    memo across params that share layers).  Layers whose consumers mix
    layouts, and experts that are not all ScaledW8 or differ in their site
    budgets, keep them; a layer already grouped
    (``random_quantized_model``) keeps its ``experts_grouped``.
    """
    if memo is None:
        memo = {}

    def one(p):
        key = id(p)
        if key in memo:
            return memo[key]
        q = dict(p)
        for stack_key, names, site_key in _STACKS:
            mk = _stacker(p, names, site_key)
            if mk is not None:
                q[stack_key] = mk([p[n].w for n in names],
                                  [p[n].bias for n in names])
                for n in names:
                    del q[n]
        experts = p.get("experts")
        if experts and all(_groupable(ep) for ep in experts) and len({
                               (ep["site_in"].splits, ep["site_down"].splits)
                               for ep in experts}) == 1:
            q["experts_grouped"] = _group_experts(experts)
            del q["experts"]
        memo[key] = q
        return q

    out = dict(params)
    out["layers"] = [one(p) for p in params["layers"]]
    return out


def _groupable(ep) -> bool:
    """Experts are grouped only when ScaledW8, as in the JAX package."""
    return _stacker(ep, ("w1", "w3", "w2"), "site_in") is stack_scaled_w8


def _group_experts(experts: List[Dict[str, Any]]) -> Dict[str, Any]:
    """[per-expert quantized dicts] -> the grouped serving form: every
    expert's w1|w3 (and w2) codes in one ``GroupedW8`` each, and the
    experts' site permutations as one (E, K) tensor, so ``moe_block`` runs
    the whole expert loop as two grouped GEMMs."""

    def stackb(name):
        bs = [ep[name].bias for ep in experts]
        if all(b is None for b in bs):
            return None
        return torch.stack(bs)

    sites = [ep["site_in"] for ep in experts]
    perm = (torch.stack([s.perm for s in sites])
            if all(s.perm is not None for s in sites) else None)
    return {
        "w13": group_scaled_w8([[ep["w1"].w for ep in experts],
                                [ep["w3"].w for ep in experts]],
                               [stackb("w1"), stackb("w3")]),
        "w2": group_scaled_w8([[ep["w2"].w for ep in experts]], [stackb("w2")]),
        "perm": perm,
        "site_in": QuantSite(*sites[0].splits),
        "site_down": QuantSite(*experts[0]["site_down"].splits),
    }


def default_calibration(cfg: ModelConfig, p6: int = 0, p8: int = 0,
                        seed: Optional[int] = None) -> List[LayerCalib]:
    """Identity (or seeded-random) calibration; the same numpy draws as the
    JAX package's, so one seed gives both packages the same sites."""
    hid, inter = cfg.hidden_size, cfg.intermediate_size
    odim = cfg.num_heads * cfg.head_dim
    rng = np.random.default_rng(seed) if seed is not None else None

    def mk(k):
        idx = (rng.permutation(k).astype(np.int32) if rng is not None
               else np.arange(k, dtype=np.int32))
        return SiteCalibration(idx, p6, p8)

    out = []
    for _ in range(cfg.num_layers):
        c: LayerCalib = {ATTN_IN: mk(hid), O_IN: mk(odim)}
        if cfg.is_moe:
            for e in range(cfg.num_experts):
                c[f"expert{e}_{MLP_IN}"] = mk(hid)
                c[f"expert{e}_{DOWN_IN}"] = mk(inter)
        else:
            c[MLP_IN] = mk(hid)
            c[DOWN_IN] = mk(inter)
        out.append(c)
    return out


def _bf16(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(a).to(device=device, dtype=torch.bfloat16)


def random_dense_params(cfg: ModelConfig, seed: int = 0,
                        device=None) -> Dict[str, Any]:
    """Seeded dense Llama or Mixtral parameters: the same numpy draws, in
    the same order, as the JAX package's random_dense_params (test
    sizes)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    hid, inter = cfg.hidden_size, cfg.intermediate_size
    odim = cfg.num_heads * cfg.head_dim
    kvdim = cfg.num_kv_heads * cfg.head_dim

    def lin(n, k, bias=False):
        w = _bf16(rng.normal(0, 1.0 / np.sqrt(k), (n, k)), device)
        b = _bf16(rng.normal(0, 0.01, (n,)), device) if bias else None
        return DenseLinear(w=w, bias=b)

    def layer():
        p = {
            "ln1": torch.ones(hid, dtype=torch.bfloat16, device=device),
            "ln2": torch.ones(hid, dtype=torch.bfloat16, device=device),
            "q": lin(odim, hid, cfg.qkv_bias),
            "k": lin(kvdim, hid, cfg.qkv_bias),
            "v": lin(kvdim, hid, cfg.qkv_bias),
            "o": lin(hid, odim),
        }
        if cfg.is_moe:
            p["router"] = lin(cfg.num_experts, hid)
            p["experts"] = [{"w1": lin(inter, hid), "w3": lin(inter, hid),
                             "w2": lin(hid, inter)}
                            for _ in range(cfg.num_experts)]
        else:
            p["gate"] = lin(inter, hid)
            p["up"] = lin(inter, hid)
            p["down"] = lin(hid, inter)
        return p

    # draw order as in the JAX package: embed, lm_head, then the layers
    embed = _bf16(rng.normal(0, 0.02, (cfg.vocab_size, hid)), device)
    head = embed if cfg.tie_embeddings else _bf16(
        rng.normal(0, 0.02, (cfg.vocab_size, hid)), device)
    layers = [layer() for _ in range(cfg.num_layers)]
    return {"embed": embed, "final_ln": torch.ones(hid, dtype=torch.bfloat16,
                                                   device=device),
            "lm_head": head, "layers": layers}


def random_quantized_model(cfg: ModelConfig, calibs: List[LayerCalib], *,
                           seed: int = 0, device=None,
                           group_experts: bool = True,
                           weight_fp4_only: bool = True,
                           layout: str = "auto") -> Dict[str, Any]:
    """Full-size random model made on ``device``: each layer's dense
    weights are drawn there (torch.Generator, N(0, 1/sqrt(K)) like
    random_dense_params, and with ``cfg.qkv_bias`` the q/k/v biases from
    N(0, 0.01) as there), quantized (``layout``, ``weight_fp4_only`` as in
    ``quantize_linear``) and freed before the next layer, so peak memory
    is one dense layer plus the codes.  A Mixtral layer's ScaledW8 experts
    are grouped at once (``group_experts``, the engine's serving form,
    which ``stack_layer_projections`` keeps) and the per-expert codes
    freed, so the model never holds two copies of its experts;
    ``group_experts=False`` keeps the per-expert form."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    hid, inter = cfg.hidden_size, cfg.intermediate_size
    odim = cfg.num_heads * cfg.head_dim
    kvdim = cfg.num_kv_heads * cfg.head_dim

    def normal(shape, std):
        t = torch.empty(shape, dtype=torch.float32, device=device)
        return t.normal_(0.0, std, generator=gen).to(torch.bfloat16)

    def lin(n, k, bias=False):
        return DenseLinear(w=normal((n, k), 1.0 / np.sqrt(k)),
                           bias=normal((n,), 0.01) if bias else None)

    layers = []
    for calib in calibs:
        ones = torch.ones(hid, dtype=torch.bfloat16, device=device)
        dense = {"ln1": ones, "ln2": ones.clone(),
                 "q": lin(odim, hid, cfg.qkv_bias),
                 "k": lin(kvdim, hid, cfg.qkv_bias),
                 "v": lin(kvdim, hid, cfg.qkv_bias), "o": lin(hid, odim)}
        if cfg.is_moe:
            dense["router"] = lin(cfg.num_experts, hid)
            dense["experts"] = [{"w1": lin(inter, hid), "w3": lin(inter, hid),
                                 "w2": lin(hid, inter)}
                                for _ in range(cfg.num_experts)]
        else:
            dense.update(gate=lin(inter, hid), up=lin(inter, hid),
                         down=lin(hid, inter))
        layer = quantize_layer(dense, cfg, calib,
                               weight_fp4_only=weight_fp4_only, layout=layout)
        del dense
        if cfg.is_moe and group_experts and all(
                _groupable(ep) for ep in layer["experts"]):
            layer["experts_grouped"] = _group_experts(layer.pop("experts"))
        layers.append(layer)
    return {"embed": normal((cfg.vocab_size, hid), 0.02),
            "final_ln": torch.ones(hid, dtype=torch.bfloat16, device=device),
            "lm_head": normal((cfg.vocab_size, hid), 0.02),
            "layers": layers}
