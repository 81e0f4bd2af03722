"""Utilities (torch counterpart of ``micromix_tpu.utils``): profiling."""

from .profiling import annotate, marginal_timer, trace

__all__ = ["trace", "annotate", "marginal_timer"]
