"""ScaledW8: one byte per scaled fp4 weight element.

Counterpart of ``micromix_tpu/mx/scaledw8.py``.  An MXFP4 element times
its UE8M0 block scale is ``(-1)^s (1 + m/2) 2^E``, so the scaled value is
stored directly::

    code = s<<7 | e6<<1 | m        e6 = E - base + 1 in [1, 63]
    code = 0                       for +/-0

with one per-tensor ``base`` exponent.  Decoding is three integer ops and a
power-of-two multiply, and gives the exact bf16 operand the GEMM needs.

``ScaledW8Stack`` holds the consumers of one activation site (q|k|v, or
gate|up) row-stacked in one code array, each section padded with zero
codes to a multiple of the stacked GEMM's 64-row strip.  ``GroupedW8``
holds such a stack for every group of a grouped GEMM (the MoE experts'
w1|w3, or their w2), padded as the JAX package pads it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from .mxtensor import MixedTensor, dequantize_mixed_device

_I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class ScaledW8:
    """Scaled-fp4 weight codes for one (N, K) weight matrix.

    codes: (N, K) uint8, columns in the block-interleaved device order of
      the matching activation site.
    base: the per-tensor exponent offset (a Python int; <= 1).
    k4/k6/k8: the activation segment budgets this weight was packed for.
    """

    codes: torch.Tensor
    base: int
    k4: int = 0
    k6: int = 0
    k8: int = 0

    @property
    def rows(self) -> int:
        return self.codes.shape[0]

    @property
    def k(self) -> int:
        return self.codes.shape[1]

    def segments(self) -> Tuple[int, int, int]:
        return (self.k4, self.k6, self.k8)


def pack_scaled_w8(t: MixedTensor, base: Optional[int] = None) -> ScaledW8:
    """All-MXFP4 MixedTensor -> ScaledW8; raises ValueError when the
    scaled-exponent spread exceeds the 6-bit field (over 62).  ``base``
    overrides the per-tensor exponent offset: the shards of one weight
    that must decode with one common base (``parallel/tp_quant.py``)."""
    assert t.fp4_only or t.segments()[1:] == (0, 0), \
        "ScaledW8 requires fp4-only weights (1 mantissa bit)"
    codes, base = encode_scaled_values(
        dequantize_mixed_device(t, dtype=torch.float32), base=base)
    k4, k6, k8 = t.segments()
    return ScaledW8(codes=codes, base=base, k4=k4, k6=k6, k8=k8)


def exponent_range(vals: torch.Tensor) -> Tuple[int, int]:
    """(least, largest) biased f32 exponent of the non-zero values; (0xFF,
    0) when all are zero.  A weight split in shards has the range of the
    least and largest of its shards' (``parallel/tp_quant.py``)."""
    expf = (vals.to(torch.float32).view(_I32) >> 23) & 0xFF
    nonzero = vals != 0.0
    return (int(torch.where(nonzero, expf, 0xFF).min()),
            int(torch.where(nonzero, expf, 0).max()))


def check_base(emin: int, emax: int, base: int) -> None:
    """ValueError unless every non-zero exponent in [emin, emax] maps into
    the 6-bit field under ``base`` and 2^(base+126) stays a normal f32."""
    if emin <= emax and not (emin - 127 - base + 1 >= 1
                             and emax - 127 - base + 1 <= 63):
        raise ValueError(f"scaled-weight exponents [{emin}, {emax}] under "
                         f"base {base}: the span {emax - emin} exceeds 62 "
                         "or the base is above the least")
    if base > 1:
        # the decode rescales by 2^(base+126), which must stay normal
        raise ValueError(f"scaled-weight base exponent {base} > 1")


def encode_scaled_values(vals: torch.Tensor, base: Optional[int] = None):
    """Exact scaled values (one mantissa bit) -> (u8 codes, int base).
    The base is the least exponent's unless ``base`` is given."""
    bits = vals.to(torch.float32).view(_I32)
    expf = (bits >> 23) & 0xFF            # biased f32 exponent
    mant = (bits >> 22) & 1               # fp4 has one mantissa bit
    sign = (bits >> 31) & 1
    nonzero = vals != 0.0
    emin, emax = exponent_range(vals)
    if base is None:
        base = emin - 127 if emin <= emax else 0
    check_base(emin, emax, base)
    e6 = torch.clamp(expf - 127 - base + 1, 1, 63)
    code = (sign << 7) | (e6 << 1) | mant
    code = torch.where(nonzero, code, torch.zeros_like(code))
    return code.to(torch.uint8), base


def pack_scaled_w8_host(segs, k4: int, k6: int, k8: int) -> ScaledW8:
    """NumPy pack, on the host: ``utils.native.quantize_mixed_host``'s
    segments (numpy, the fp4 segment split-plane packed, every segment
    block-interleaved, the all-MXFP4 grid) -> ScaledW8 with CPU codes.
    The JAX package's ``pack_scaled_w8_host``: small-integer arithmetic
    end to end, no float values.  Per element, with fp4 code c = s|e4|m
    and block scale exponent eb = sf - 127:

      e4 >= 1 (normal)          E = eb + e4 - 1, mantissa bit m
      e4 == 0, m == 1 (0.5)     E = eb - 1,      mantissa bit 0
      c & 7 == 0                zero

    E biased (+127) as the f32-bit path has it.  Raises ValueError when
    the exponent span exceeds 62 or the base is above 1."""
    import numpy as np

    def seg_fields(packed, codes, sf, kseg):
        if not kseg:
            return None
        if packed is not None:
            codes = np.concatenate([packed & np.uint8(0xF),
                                    (packed >> 4) & np.uint8(0xF)], axis=-1)
        c = codes.astype(np.int16)
        sign = (c >> 3) & 1
        e4 = (c >> 1) & 3
        m = c & 1
        nonzero = (c & 7) != 0
        eb = np.tile(sf.astype(np.int16) - 127, (1, kseg // sf.shape[-1]))
        expf = np.where(e4 >= 1, eb + e4 - 1, eb - 1) + 127
        mant = np.where(e4 >= 1, m, 0)
        return sign, expf, mant, nonzero

    parts = [p for p in (
        seg_fields(segs["fp4"] if k4 else None, None, segs["sf4"], k4),
        seg_fields(None, segs["fp6"], segs["sf6"], k6),
        seg_fields(None, segs["fp8"], segs["sf8"], k8)) if p is not None]
    sign, expf, mant, nonzero = (
        np.concatenate([p[i] for p in parts], axis=-1) for i in range(4))
    if nonzero.any():
        live = expf[nonzero]
        emin, emax = int(live.min()), int(live.max())
        base = emin - 127
        if emax - emin > 62:
            raise ValueError(f"scaled-weight exponent span {emax - emin} exceeds 62")
        if base > 1:
            raise ValueError(f"scaled-weight base exponent {base} > 1")
    else:
        base = 0
    e6 = np.clip(expf - 127 - base + 1, 1, 63).astype(np.int16)
    code = np.where(nonzero, (sign << 7) | (e6 << 1) | mant, 0).astype(np.uint8)
    return ScaledW8(codes=torch.from_numpy(code), base=int(base),
                    k4=k4, k6=k6, k8=k8)


def decode_table(base: int, device=None) -> torch.Tensor:
    """The value of each of the 256 codes for one base, f32: the sign bit,
    then ``(c & 0x7F) << 22`` rescaled by 2^(base+126); code 0 is +0."""
    c = torch.arange(256, dtype=_I32, device=device)
    t = c & 0x7F
    vals = ((t << 22) + ((base + 126) << 23)).view(torch.float32)
    vals = torch.where((c & 0x80) != 0, -vals, vals)
    return torch.where(t == 0, torch.zeros_like(vals), vals)


def dequantize_scaled_w8(w: ScaledW8, dtype=torch.bfloat16) -> torch.Tensor:
    """Whole-tensor decode: codes -> exact scaled values (N, K), one table
    lookup per code (a gather reads and writes each element once, where
    the arithmetic takes half a dozen passes)."""
    table = decode_table(w.base, w.codes.device).to(dtype)
    return torch.nn.functional.embedding(w.codes.to(_I32),
                                         table[:, None]).squeeze(-1)


# rows of the stacked GEMM's strip (csrc/w8_stack.cu): every section is
# padded to a multiple of it
STACK_STRIP = 64


@dataclasses.dataclass(frozen=True)
class ScaledW8Stack:
    """Several same-K ScaledW8 weights stacked row-wise into one code array.

    codes: (sum padded_i, K) uint8; section i's rows padded to
      ``padded[i]`` with zero codes (they decode to exactly 0.0 and are
      never written to an output).
    bases: per-section exponent offsets (Python ints).
    biases: per-section optional (sections[i],) bf16 rows, added by the
      caller after the product.
    sections / padded: true and padded row counts per section.
    k4/k6/k8: the shared activation segment budgets.
    """

    codes: torch.Tensor
    bases: Tuple[int, ...]
    biases: Tuple[Optional[torch.Tensor], ...]
    sections: Tuple[int, ...]
    padded: Tuple[int, ...]
    k4: int = 0
    k6: int = 0
    k8: int = 0

    @property
    def k(self) -> int:
        return self.codes.shape[1]

    @property
    def n_sections(self) -> int:
        return len(self.sections)

    def segments(self) -> Tuple[int, int, int]:
        return (self.k4, self.k6, self.k8)


def stack_scaled_w8(ws: Sequence[ScaledW8],
                    biases: Optional[Sequence] = None) -> ScaledW8Stack:
    """[ScaledW8, ...] (same K and segment budgets) -> ScaledW8Stack.

    A one-time copy at model-build or engine-init time, never per step.
    """
    ws = list(ws)
    if len(ws) < 2:
        raise ValueError("a stack holds at least two weights")
    k, segs = ws[0].k, ws[0].segments()
    if any(w.k != k or w.segments() != segs for w in ws[1:]):
        raise ValueError("stacked weights must share K and segment budgets")
    if biases is None:
        biases = (None,) * len(ws)
    padded = tuple(-(-w.rows // STACK_STRIP) * STACK_STRIP for w in ws)
    parts = [torch.nn.functional.pad(w.codes, (0, 0, 0, p - w.rows))
             if p != w.rows else w.codes for w, p in zip(ws, padded)]
    return ScaledW8Stack(
        codes=torch.cat(parts, dim=0), bases=tuple(w.base for w in ws),
        biases=tuple(biases), sections=tuple(w.rows for w in ws),
        padded=padded, k4=segs[0], k6=segs[1], k8=segs[2])


def section_weight(st: ScaledW8Stack, i: int) -> ScaledW8:
    """Section ``i`` of a stack as a ScaledW8 (a view of its true rows)."""
    off = sum(st.padded[:i])
    return ScaledW8(codes=st.codes[off:off + st.sections[i]], base=st.bases[i],
                    k4=st.k4, k6=st.k6, k8=st.k8)


def dequantize_stack(st: ScaledW8Stack, dtype=torch.bfloat16) -> torch.Tensor:
    """Whole-stack decode, rows in padded stacked order (prefill path)."""
    parts, off = [], 0
    for base, p in zip(st.bases, st.padded):
        parts.append(dequantize_scaled_w8(
            ScaledW8(codes=st.codes[off:off + p], base=base), dtype))
        off += p
    return torch.cat(parts)


@dataclasses.dataclass(frozen=True)
class GroupedW8:
    """Per-group stacked ScaledW8 weights: one (E, sum padded_i, K) code
    array for E groups (MoE experts), each group's rows holding its own
    consumers' sections (w1|w3, or w2 alone), for the grouped GEMM
    (``kernels/mixed_matmul.mixed_matmul_w8_grouped``).

    codes: (E, sum padded_i, K) uint8, padded rows zero.
    bases: (E, n_sections) per-group, per-section exponent offsets
      (Python ints, ``bases[e][i]``).
    biases: per-section optional (E, N_i) bf16 rows.
    """

    codes: torch.Tensor
    bases: Tuple[Tuple[int, ...], ...]
    biases: Tuple[Optional[torch.Tensor], ...]
    sections: Tuple[int, ...]
    padded: Tuple[int, ...]
    k4: int = 0
    k6: int = 0
    k8: int = 0

    @property
    def k(self) -> int:
        return self.codes.shape[2]

    @property
    def groups(self) -> int:
        return self.codes.shape[0]

    @property
    def n_sections(self) -> int:
        return len(self.sections)

    def segments(self) -> Tuple[int, int, int]:
        return (self.k4, self.k6, self.k8)


def group_strip(ns: Sequence[int]) -> int:
    """The JAX package's grouped strip width: the widest of 512/256/128
    that divides every 128-aligned section row count."""
    bn = 512
    while bn > 128 and any((-(-n // 128) * 128) % bn for n in ns):
        bn //= 2
    return bn


def group_scaled_w8(sections: Sequence[Sequence[ScaledW8]],
                    biases: Optional[Sequence] = None) -> GroupedW8:
    """``sections[i][e]``: the ScaledW8 of consumer i in group e (all of
    one K and segment budgets) -> GroupedW8, each section padded with zero
    rows to a multiple of ``group_strip`` (the JAX package's padding).

    A one-time copy at model-build or engine-init time, never per step.
    """
    sections = [list(ws) for ws in sections]
    eg = len(sections[0])
    first = sections[0][0]
    k, segs = first.k, first.segments()
    for ws in sections:
        if len(ws) != eg or any(w.k != k or w.segments() != segs for w in ws):
            raise ValueError("grouped weights must share groups, K and "
                             "segment budgets")
        if any(w.rows != ws[0].rows for w in ws):
            raise ValueError("a section has one row count in every group")
    ns = [ws[0].rows for ws in sections]
    bn = group_strip(ns)
    padded = tuple(-(-n // bn) * bn for n in ns)
    codes = torch.zeros((eg, sum(padded), k), dtype=torch.uint8,
                        device=first.codes.device)
    off = 0
    for ws, n, p in zip(sections, ns, padded):
        for e, w in enumerate(ws):
            codes[e, off:off + n].copy_(w.codes)
        off += p
    if biases is None:
        biases = (None,) * len(sections)
    return GroupedW8(
        codes=codes,
        bases=tuple(tuple(ws[e].base for ws in sections) for e in range(eg)),
        biases=tuple(biases), sections=tuple(ns), padded=padded,
        k4=segs[0], k6=segs[1], k8=segs[2])


def grouped_section(gw: GroupedW8, e: int, i: int) -> ScaledW8:
    """Group ``e``'s section ``i`` as a ScaledW8 (a view of its true rows)."""
    off = sum(gw.padded[:i])
    return ScaledW8(codes=gw.codes[e, off:off + gw.sections[i]],
                    base=gw.bases[e][i], k4=gw.k4, k6=gw.k6, k8=gw.k8)


def dequantize_grouped(gw: GroupedW8, dtype=torch.bfloat16) -> torch.Tensor:
    """Whole-group decode to the exact values, (E, sum padded_i, K), rows
    in padded stacked order (the prefill path's operand).  Decoded one
    (group, section) at a time into the output, so the int32 temporaries
    stay one section's size."""
    out = torch.zeros(gw.codes.shape, dtype=dtype, device=gw.codes.device)
    for e in range(gw.groups):
        off = 0
        for i, (n, p) in enumerate(zip(gw.sections, gw.padded)):
            out[e, off:off + n] = dequantize_scaled_w8(grouped_section(gw, e, i),
                                                       dtype)
            off += p
    return out
