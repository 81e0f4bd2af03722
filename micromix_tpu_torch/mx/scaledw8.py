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
codes to a multiple of the stacked GEMM's 64-row strip.
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


def pack_scaled_w8(t: MixedTensor) -> ScaledW8:
    """All-MXFP4 MixedTensor -> ScaledW8; raises ValueError when the
    scaled-exponent spread exceeds the 6-bit field (over 62)."""
    assert t.fp4_only or t.segments()[1:] == (0, 0), \
        "ScaledW8 requires fp4-only weights (1 mantissa bit)"
    codes, base = encode_scaled_values(
        dequantize_mixed_device(t, dtype=torch.float32))
    k4, k6, k8 = t.segments()
    return ScaledW8(codes=codes, base=base, k4=k4, k6=k6, k8=k8)


def encode_scaled_values(vals: torch.Tensor):
    """Exact scaled values (one mantissa bit) -> (u8 codes, int base)."""
    bits = vals.to(torch.float32).view(_I32)
    expf = (bits >> 23) & 0xFF            # biased f32 exponent
    mant = (bits >> 22) & 1               # fp4 has one mantissa bit
    sign = (bits >> 31) & 1
    nonzero = vals != 0.0
    base = 0
    if bool(nonzero.any()):
        emax = int(torch.where(nonzero, expf, 0).max())
        emin = int(torch.where(nonzero, expf, 0xFF).min())
        base = emin - 127
        if emax - emin > 62:
            raise ValueError(
                f"scaled-weight exponent span {emax - emin} exceeds 62")
        if base > 1:
            # the decode rescales by 2^(base+126), which must stay normal
            raise ValueError(f"scaled-weight base exponent {base} > 1")
    e6 = torch.clamp(expf - 127 - base + 1, 1, 63)
    code = (sign << 7) | (e6 << 1) | mant
    code = torch.where(nonzero, code, torch.zeros_like(code))
    return code.to(torch.uint8), base


def dequantize_scaled_w8(w: ScaledW8, dtype=torch.bfloat16) -> torch.Tensor:
    """Whole-tensor decode: codes -> exact scaled values (N, K)."""
    c = w.codes.to(_I32)
    t = c & 0x7F
    vals = ((t << 22) + ((w.base + 126) << 23)).view(torch.float32)
    vals = torch.where((c & 0x80) != 0, -vals, vals)
    vals = torch.where(t == 0, torch.zeros_like(vals), vals)
    return vals.to(dtype)


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
