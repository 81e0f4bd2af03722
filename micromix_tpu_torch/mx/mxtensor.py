"""Segment-quantized MX tensors and the split-plane weight stack.

Counterpart of ``micromix_tpu/mx/mxtensor.py``: ``MixedTensor`` (the
fp4 segment unpacked, one code per byte, or split-plane packed, two per
byte, as weights keep it), ``quantize_mixed`` (including the all-MXFP4
weight mode and the fp4 packing), ``dequantize_mixed`` (canonical column
order) and ``dequantize_mixed_device`` (device order), and
``SplitPlaneStack``, the consumers of one activation site row-stacked for
the split-plane stacked GEMM.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from . import layout as lay
from . import numerics as nx
from .formats import FP4, FP6, FP8, UE8M0_BIAS

_FIELDS = ("fp4", "fp6", "fp8", "sf4", "sf6", "sf8")


@dataclasses.dataclass(frozen=True)
class MixedTensor:
    """One (rows, K) matrix quantized into up to three K-segments, each
    block-interleaved (device column c belongs to scale block c % nb)."""

    fp4: torch.Tensor  # (rows, k4) u8 codes, or (rows, k4 // 2) if fp4_packed
    fp6: torch.Tensor  # (rows, k6) u8
    fp8: torch.Tensor  # (rows, k8) u8
    sf4: torch.Tensor  # (rows, k4 // 32) u8 UE8M0
    sf6: torch.Tensor
    sf8: torch.Tensor
    # True -> byte j holds device columns j (low nibble) and k4/2 + j (high)
    fp4_packed: bool = False
    # True -> every segment uses the MXFP4 grid (the weight mode)
    fp4_only: bool = False

    @property
    def rows(self) -> int:
        return self.fp4.shape[0]

    @property
    def k4(self) -> int:
        return self.fp4.shape[1] * (2 if self.fp4_packed else 1)

    @property
    def k(self) -> int:
        return sum(self.segments())

    def segments(self) -> Tuple[int, int, int]:
        return (self.k4, self.fp6.shape[1], self.fp8.shape[1])

    def formats(self):
        """The element format of each segment's codes."""
        return (FP4, FP4 if self.fp4_only else FP6,
                FP4 if self.fp4_only else FP8)


def quantize_mixed(x: torch.Tensor, k4: int, k6: int, k8: int,
                   weight_fp4_only: bool = False,
                   pack_fp4: bool = False) -> MixedTensor:
    """Quantize an already-permuted (rows, K) matrix into a MixedTensor.
    ``pack_fp4`` stores the fp4 segment split-plane packed (weights)."""
    assert x.ndim == 2 and x.shape[-1] == k4 + k6 + k8, (x.shape, k4, k6, k8)
    rows = x.shape[0]
    x = x.to(torch.float32)

    def seg(lo, hi, fmt):
        if hi == lo:
            empty = torch.zeros((rows, 0), dtype=torch.uint8, device=x.device)
            return empty, empty
        codes, scales = nx.quantize_blocks(x[:, lo:hi], fmt)
        return lay.interleave(codes), scales

    c4, s4 = seg(0, k4, FP4)
    c6, s6 = seg(k4, k4 + k6, FP4 if weight_fp4_only else FP6)
    c8, s8 = seg(k4 + k6, k4 + k6 + k8, FP4 if weight_fp4_only else FP8)
    packed = bool(pack_fp4 and k4)
    if packed:
        c4 = nx.pack_fp4(c4)
    return MixedTensor(fp4=c4, fp6=c6, fp8=c8, sf4=s4, sf6=s6, sf8=s8,
                       fp4_packed=packed, fp4_only=weight_fp4_only)


def pack_mixed(t: MixedTensor) -> MixedTensor:
    """The same tensor with its fp4 segment split-plane packed."""
    if t.fp4_packed or not t.k4:
        return t
    return dataclasses.replace(t, fp4=nx.pack_fp4(t.fp4), fp4_packed=True)


def _codes(t: MixedTensor):
    """(codes unpacked, scales, format) per non-empty segment."""
    out = []
    for i, (codes, sf, fmt) in enumerate(zip(
            (t.fp4, t.fp6, t.fp8), (t.sf4, t.sf6, t.sf8), t.formats())):
        if i == 0 and t.fp4_packed:
            codes = nx.unpack_fp4(codes)
        if codes.shape[1]:
            out.append((codes, sf, fmt))
    return out


def _dequantize(t: MixedTensor, dtype, canonical: bool) -> torch.Tensor:
    """Each code looked up in its format's table of ``decode`` values (one
    gather, bit-identical to the arithmetic decode) and times its block's
    2^(sf - 127) in f32 (exact: an MX value has at most 4 significant
    bits), then cast to ``dtype``.  ``canonical``: the codes are
    de-interleaved as bytes first, so block b is columns 32b..32b+31;
    else device column c of a segment with nb blocks is element
    (c // nb, c % nb) of the row seen as (K / nb, nb).  Zero codes with
    zero scale bytes (padding rows) decode to exactly 0.0."""
    parts = []
    for codes, sf, fmt in _codes(t):
        rows, kseg = codes.shape
        nb = sf.shape[1]
        if canonical:
            codes = lay.deinterleave(codes)
        vals = nx.decode_table(fmt, codes.device)[codes.to(torch.int32)]
        scale = nx.exp2i(sf.to(torch.int32) - UE8M0_BIAS)
        vals = (vals.reshape(rows, nb, -1) * scale[:, :, None] if canonical
                else vals.reshape(rows, -1, nb) * scale[:, None, :])
        parts.append(vals.reshape(rows, kseg).to(dtype))
    if not parts:
        return torch.zeros((t.rows, 0), dtype=dtype, device=t.fp4.device)
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)


def dequantize_mixed(t: MixedTensor, dtype=torch.float32) -> torch.Tensor:
    """MixedTensor -> dense (rows, K) in *canonical* column order (each
    segment de-interleaved): what the weight-only linears multiply, and
    the values comparisons with unquantized ones take."""
    return _dequantize(t, dtype, canonical=True)


def dequantize_mixed_device(t: MixedTensor,
                            dtype=torch.bfloat16) -> torch.Tensor:
    """MixedTensor -> dense (rows, K) in device (block-interleaved) order:
    the exact operand the GEMMs multiply."""
    return _dequantize(t, dtype, canonical=False)


@dataclasses.dataclass(frozen=True)
class SplitPlaneStack:
    """Several same-budget split-plane weights row-stacked: one
    MixedTensor ``mt`` whose section i holds ``sections[i]`` true rows
    padded with zero codes and zero scale bytes (they decode to exactly
    0.0 and are never written to an output) to ``padded[i]``, a multiple
    of the strip width (at least 128).  ``biases``: per-section optional
    bf16 rows, added by the caller."""

    mt: MixedTensor
    biases: Tuple[Optional[torch.Tensor], ...]
    sections: Tuple[int, ...]
    padded: Tuple[int, ...]

    @property
    def k(self) -> int:
        return self.mt.k

    @property
    def n_sections(self) -> int:
        return len(self.sections)

    def segments(self) -> Tuple[int, int, int]:
        return self.mt.segments()


def stack_strip(ns: Sequence[int]) -> int:
    """The JAX package's stack strip width: the widest of 512/256/128 that
    divides every 128-aligned section row count."""
    bn = 512
    while bn > 128 and any((-(-n // 128) * 128) % bn for n in ns):
        bn //= 2
    return bn


def stack_split_plane(ws: Sequence[MixedTensor],
                      biases: Optional[Sequence] = None) -> SplitPlaneStack:
    """[MixedTensor (N_i, K) split-plane weights] -> SplitPlaneStack, with
    the JAX package's padding.  A one-time copy at engine init; a single
    weight whose rows are already strip-aligned costs no copy (the o and
    down projections are wrapped so on every call)."""
    ws = list(ws)
    segs = ws[0].segments()
    flags = (ws[0].fp4_packed, ws[0].fp4_only)
    if any(w.segments() != segs or (w.fp4_packed, w.fp4_only) != flags
           for w in ws[1:]):
        raise ValueError("stacked weights must share segments and flags")
    if biases is None:
        biases = (None,) * len(ws)
    ns = [w.rows for w in ws]
    bn = stack_strip(ns)
    padded = tuple(-(-n // bn) * bn for n in ns)

    def cat(field):
        parts = [getattr(w, field) for w in ws]
        parts = [torch.nn.functional.pad(a, (0, 0, 0, p - a.shape[0]))
                 if p != a.shape[0] else a for a, p in zip(parts, padded)]
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    mt = MixedTensor(**{f: cat(f) for f in _FIELDS}, fp4_packed=flags[0],
                     fp4_only=flags[1])
    return SplitPlaneStack(mt=mt, biases=tuple(biases), sections=tuple(ns),
                           padded=padded)


def section_mixed(st: SplitPlaneStack, i: int) -> MixedTensor:
    """Section ``i`` of a stack as a MixedTensor (views of its true rows)."""
    off = sum(st.padded[:i])
    n = st.sections[i]
    return dataclasses.replace(
        st.mt, **{f: getattr(st.mt, f)[off:off + n] for f in _FIELDS})

