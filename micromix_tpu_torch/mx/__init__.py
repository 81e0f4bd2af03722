"""MX numerics, layout and weight containers (torch counterpart of
``micromix_tpu.mx``)."""

from .formats import BLOCK_SIZE, FP4, FP6, FP8, FormatInfo
from .mxtensor import (MixedTensor, SplitPlaneStack, dequantize_mixed,
                       dequantize_mixed_device, quantize_mixed,
                       stack_split_plane)
from .scaledw8 import (GroupedW8, ScaledW8, ScaledW8Stack, dequantize_grouped,
                       dequantize_scaled_w8, dequantize_stack,
                       encode_scaled_values, group_scaled_w8, pack_scaled_w8,
                       stack_scaled_w8)

__all__ = [
    "BLOCK_SIZE", "FP4", "FP6", "FP8", "FormatInfo",
    "MixedTensor", "quantize_mixed", "dequantize_mixed",
    "dequantize_mixed_device", "SplitPlaneStack", "stack_split_plane",
    "ScaledW8", "pack_scaled_w8", "encode_scaled_values",
    "dequantize_scaled_w8", "ScaledW8Stack", "stack_scaled_w8",
    "dequantize_stack", "GroupedW8", "group_scaled_w8", "dequantize_grouped",
]
