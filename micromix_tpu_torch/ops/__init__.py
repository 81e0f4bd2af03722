"""Activation quantization ops (torch counterpart of ``micromix_tpu.ops``)."""

from .quantize_ops import (activation_quantize, fakequant_device,
                           reorder_fakequant_x, reorder_quantize_x,
                           rmsnorm_fakequant_x, rmsnorm_quantize_x,
                           silu_mul_fakequant_x, silu_mul_quantize_x)

from ..kernels.mixed_matmul import mixed_matmul
# the JAX package's name for Kernel J's wrapper (activation -> MX codes)
from ..kernels.quantize import quantize_mixed as quantize_mixed_pallas

__all__ = ["fakequant_device", "reorder_fakequant_x", "rmsnorm_fakequant_x",
           "silu_mul_fakequant_x", "activation_quantize",
           "reorder_quantize_x", "rmsnorm_quantize_x", "silu_mul_quantize_x",
           "mixed_matmul", "quantize_mixed_pallas"]
