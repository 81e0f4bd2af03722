"""Utilities (torch counterpart of ``micromix_tpu.utils``): the native
host quantizers, profiling."""

from .native import native_available, quantize_mixed_host
from .profiling import annotate, marginal_timer, trace

__all__ = ["native_available", "quantize_mixed_host",
           "trace", "annotate", "marginal_timer"]
