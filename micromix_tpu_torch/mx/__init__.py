"""MX numerics, layout and weight containers (torch counterpart of
``micromix_tpu.mx``)."""

from .formats import BLOCK_SIZE, FORMATS, FP4, FP6, FP8, SEGMENT_ALIGN, FormatInfo
from .mxtensor import (MixedTensor, SplitPlaneStack, dequantize_mixed,
                       dequantize_mixed_device, quantize_mixed,
                       stack_split_plane)
from .scaledw8 import (GroupedW8, ScaledW8, ScaledW8Stack, dequantize_grouped,
                       dequantize_scaled_w8, dequantize_stack,
                       encode_scaled_values, group_scaled_w8, pack_scaled_w8,
                       stack_scaled_w8)
from .numerics import (block_scale_exponent, ceil_log2, decode,
                       decode_packed_fp4, dequantize_blocks, encode, exp2i,
                       fakequant_blocks, pack_fp4, quantize_blocks,
                       quantize_to_grid, unpack_fp4)

__all__ = [
    "BLOCK_SIZE", "SEGMENT_ALIGN", "FP4", "FP6", "FP8", "FORMATS", "FormatInfo",
    "quantize_blocks", "dequantize_blocks", "fakequant_blocks",
    "quantize_to_grid", "encode", "decode", "pack_fp4", "unpack_fp4",
    "decode_packed_fp4", "exp2i", "ceil_log2", "block_scale_exponent",
    "mixed_matmul_xla",
    "MixedTensor", "quantize_mixed", "dequantize_mixed",
    "dequantize_mixed_device", "SplitPlaneStack", "stack_split_plane",
    "ScaledW8", "pack_scaled_w8", "encode_scaled_values",
    "dequantize_scaled_w8", "ScaledW8Stack", "stack_scaled_w8",
    "dequantize_stack", "GroupedW8", "group_scaled_w8", "dequantize_grouped",
]


def __getattr__(name):
    """``mixed_matmul_xla``: the JAX package's name for the split-plane
    GEMM's plain version (dq(A) . dq(W)^T in f32), looked up on first use
    since ``kernels/`` imports this package."""
    if name == "mixed_matmul_xla":
        from ..kernels.mixed_matmul import mixed_matmul_sp_plain
        return mixed_matmul_sp_plain
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
