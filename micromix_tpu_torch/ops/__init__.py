"""Activation quantization ops (torch counterpart of ``micromix_tpu.ops``)."""

from .quantize_ops import (activation_quantize, fakequant_device,
                           reorder_fakequant_x, reorder_quantize_x,
                           rmsnorm_fakequant_x, rmsnorm_quantize_x,
                           silu_mul_fakequant_x, silu_mul_quantize_x)

__all__ = ["fakequant_device", "reorder_fakequant_x", "rmsnorm_fakequant_x",
           "silu_mul_fakequant_x", "activation_quantize",
           "reorder_quantize_x", "rmsnorm_quantize_x", "silu_mul_quantize_x"]
