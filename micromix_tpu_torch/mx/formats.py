"""OCP Microscaling (MX) element format definitions.

Counterpart of ``micromix_tpu/mx/formats.py``: MXFP4 (e2m1), MXFP6 (e3m2)
and MXFP8 (e4m3fn) element grids, each with one shared UE8M0 power-of-two
scale per 32-element block.  Pure metadata, no torch import.
"""

from __future__ import annotations

import dataclasses

BLOCK_SIZE = 32  # MX spec: 32 elements share one UE8M0 scale.

# Channel-segment alignment: calibration rounds p6_num / p8_num up to
# multiples of 128.
SEGMENT_ALIGN = 128


@dataclasses.dataclass(frozen=True)
class FormatInfo:
    """Static description of one MX element format."""

    name: str
    bits: int
    exp_bits: int
    mant_bits: int
    emin: int       # minimum normal exponent (unbiased)
    emax: int
    max: float      # largest finite magnitude

    @property
    def code_bits(self) -> int:
        return 1 + self.exp_bits + self.mant_bits

    @property
    def min_subnormal(self) -> float:
        return 2.0 ** (self.emin - self.mant_bits)


FP4 = FormatInfo(name="fp4", bits=4, exp_bits=2, mant_bits=1, emin=0, emax=2, max=6.0)
FP6 = FormatInfo(name="fp6", bits=6, exp_bits=3, mant_bits=2, emin=-2, emax=4, max=28.0)
FP8 = FormatInfo(name="fp8", bits=8, exp_bits=4, mant_bits=3, emin=-6, emax=8, max=448.0)

# UE8M0 scale byte = unbiased exponent + 127.
UE8M0_BIAS = 127

FORMATS = {f.name: f for f in (FP4, FP6, FP8)}
