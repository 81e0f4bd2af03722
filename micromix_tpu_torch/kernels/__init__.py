"""Hand-written CUDA kernels and their plain PyTorch versions (torch
counterpart of ``micromix_tpu.kernels``)."""

from .build import launches, reset_launches
from .fakequant import (fakequant_site, fakequant_site_blocks,
                        fakequant_site_blocks_plain, fakequant_site_plain)
from .flash_attention import (flash_attention, flash_attention_hsd,
                              flash_attention_plain)
from .mixed_matmul import (mixed_matmul, mixed_matmul_sp, mixed_matmul_sp_stack,
                           mixed_matmul_w8, mixed_matmul_w8_grouped,
                           mixed_matmul_w8_pair, mixed_matmul_w8_plain,
                           mixed_matmul_w8_site, mixed_matmul_w8_stack)
from .quantize import quantize_mixed, quantize_mixed_plain

__all__ = [
    "launches", "reset_launches",
    "fakequant_site", "fakequant_site_plain", "fakequant_site_blocks",
    "fakequant_site_blocks_plain",
    "flash_attention", "flash_attention_hsd", "flash_attention_plain",
    "mixed_matmul", "mixed_matmul_w8", "mixed_matmul_w8_plain",
    "mixed_matmul_w8_site", "mixed_matmul_w8_stack", "mixed_matmul_w8_pair",
    "mixed_matmul_w8_grouped",
    "mixed_matmul_sp", "mixed_matmul_sp_stack", "quantize_mixed",
    "quantize_mixed_plain",
]
