"""MX quantization numerics on torch tensors.

Counterpart of ``micromix_tpu/mx/numerics.py``.  Every function works by
explicit float32 bit construction, so its values are bit-identical to the
JAX package's on any device: the UE8M0 exponent is read from the f32 bits
(no ``log2``), and rounding onto a grid is round-half-to-even
(``torch.round``) after an exact division by a power of two.

Bit fields are handled in int32: ``Tensor.view(torch.int32)`` reinterprets
f32 bits, and every value that is shifted right here is non-negative or
masked afterwards, so the arithmetic shift behaves like the JAX package's
uint32 shift.
"""

from __future__ import annotations

import functools

import torch

from .formats import BLOCK_SIZE, FP4, FormatInfo, UE8M0_BIAS

_F32 = torch.float32
_I32 = torch.int32


def div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c correctly rounded on every device.  ``x / c`` with a Python
    number multiplies by the f32 reciprocal of ``c`` on CUDA, which is not
    the quotient the JAX package computes."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def exp2i(e: torch.Tensor) -> torch.Tensor:
    """2.0**e for int e in [-126, 127], exact, via float32 bit construction."""
    return ((e.to(_I32) + 127) << 23).view(_F32)


def ceil_log2(v: torch.Tensor) -> torch.Tensor:
    """Exact ceil(log2(v)) for positive float32 v (int32 result)."""
    bits = v.to(_F32).view(_I32)
    e = ((bits >> 23) & 0xFF) - 127
    return e + ((bits & 0x7FFFFF) != 0).to(_I32)


def block_scale_exponent(maxv: torch.Tensor, fmt: FormatInfo) -> torch.Tensor:
    """UE8M0 unbiased scale exponent: ceil(log2(maxv / fmt.max)); -1 if 0."""
    maxv = maxv.to(_F32)
    pos = maxv > 0
    safe = torch.where(pos, maxv, torch.ones_like(maxv))
    e = ceil_log2(div(safe, fmt.max))
    e = torch.where(pos, e, torch.full_like(e, -1))
    return e.clamp(-126, 127)


def quantize_to_grid(x: torch.Tensor, fmt: FormatInfo) -> torch.Tensor:
    """Saturating round-half-to-even of x onto the format grid (f32 out)."""
    x = x.to(_F32)
    ax = torch.clamp(x.abs(), max=fmt.max)
    e = ((ax.view(_I32) >> 23) & 0xFF) - 127
    e = torch.clamp(e, min=fmt.emin)
    ulp = exp2i(e - fmt.mant_bits)
    q = torch.round(ax / ulp) * ulp
    return torch.where(x < 0, -q, q)


def encode(q: torch.Tensor, fmt: FormatInfo) -> torch.Tensor:
    """Grid values (f32, from quantize_to_grid) -> uint8 codes s|e|m."""
    q = q.to(_F32)
    sign = (q.view(_I32) >> 31) & 1
    aq = q.abs()
    abits = aq.view(_I32)
    e = ((abits >> 23) & 0xFF) - 127
    normal_mant = (abits >> (23 - fmt.mant_bits)) & ((1 << fmt.mant_bits) - 1)
    normal_exp = e - fmt.emin + 1
    sub_mant = (aq * 2.0 ** (fmt.mant_bits - fmt.emin)).to(_I32)
    is_sub = aq < 2.0 ** fmt.emin
    exp_field = torch.where(is_sub, torch.zeros_like(normal_exp), normal_exp)
    mant_field = torch.where(is_sub, sub_mant, normal_mant)
    code = ((sign << (fmt.exp_bits + fmt.mant_bits))
            | (exp_field << fmt.mant_bits) | mant_field)
    return code.to(torch.uint8)


def decode(codes: torch.Tensor, fmt: FormatInfo) -> torch.Tensor:
    """uint8 codes -> float32 grid values (inverse of encode)."""
    c = codes.to(_I32) & ((1 << fmt.code_bits) - 1)
    mb, eb = fmt.mant_bits, fmt.exp_bits
    sign = (c >> (eb + mb)) & 1
    e = (c >> mb) & ((1 << eb) - 1)
    m = c & ((1 << mb) - 1)
    normal = (((e + fmt.emin - 1 + 127) << 23) | (m << (23 - mb))).view(_F32)
    sub = m.to(_F32) * fmt.min_subnormal
    val = torch.where(e == 0, sub, normal)
    return torch.where(sign == 1, -val, val)


def quantize_blocks(x: torch.Tensor, fmt: FormatInfo):
    """x (..., K), K % 32 == 0 -> (codes u8 (..., K), scales u8 (..., K//32))."""
    assert x.shape[-1] % BLOCK_SIZE == 0, x.shape
    nblk = x.shape[-1] // BLOCK_SIZE
    xb = x.to(_F32).reshape(*x.shape[:-1], nblk, BLOCK_SIZE)
    e = block_scale_exponent(xb.abs().amax(dim=-1), fmt)
    q = quantize_to_grid(xb * exp2i(-e)[..., None], fmt)
    codes = encode(q, fmt).reshape(x.shape)
    return codes, (e + UE8M0_BIAS).to(torch.uint8)


def dequantize_blocks(codes: torch.Tensor, scales: torch.Tensor,
                      fmt: FormatInfo) -> torch.Tensor:
    """codes (..., K) u8 in canonical order, scales (..., K//32) -> f32."""
    vals = decode(codes, fmt)
    vb = vals.reshape(*vals.shape[:-1], scales.shape[-1], BLOCK_SIZE)
    scale = exp2i(scales.to(_I32) - UE8M0_BIAS)
    return (vb * scale[..., None]).reshape(vals.shape)


def fakequant_blocks(x: torch.Tensor, fmt: FormatInfo) -> torch.Tensor:
    """x -> its MX image (quantize then dequantize each 32-block), in
    x's dtype."""
    codes, scales = quantize_blocks(x, fmt)
    return dequantize_blocks(codes, scales, fmt).to(x.dtype)


@functools.lru_cache(maxsize=None)
def decode_table(fmt: FormatInfo, device=None) -> torch.Tensor:
    """The f32 value of each of the 256 byte codes (``decode`` of each),
    made once per (format, device): the weight-only linears look their
    codes up in it on every call.  Read only."""
    return decode(torch.arange(256, dtype=_I32, device=device), fmt)


# fp4 split-plane packing: byte j holds device column j in its low nibble
# and column j + K/2 in its high nibble, so each nibble plane is a
# contiguous half of the row, and both use the same scale row (column c
# belongs to scale block c % nb, and K/2 = 16 nb).


def pack_fp4(codes: torch.Tensor) -> torch.Tensor:
    """uint8 fp4 codes (..., K) -> split-plane packed uint8 (..., K//2)."""
    h = codes.shape[-1] // 2
    return (codes[..., :h] & 0xF) | ((codes[..., h:] & 0xF) << 4)


def unpack_fp4(packed: torch.Tensor) -> torch.Tensor:
    """Split-plane packed uint8 (..., K//2) -> uint8 fp4 codes (..., K)."""
    return torch.cat([packed & 0xF, packed >> 4], dim=-1)


def decode_packed_fp4(packed: torch.Tensor, dtype=_F32) -> torch.Tensor:
    """Packed fp4 (..., K//2) -> the values without their scales (..., K)."""
    return decode(unpack_fp4(packed), FP4).to(dtype)
