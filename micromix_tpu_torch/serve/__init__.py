"""Serving: paged int4 / int8 KV cache, runner, sampling, the engine, the
router and the HTTP API (torch counterpart of ``micromix_tpu.serve``)."""

from .engine import Engine, Request
from .sampling import SAMPLE_MODES, SamplingParams, sample, sample_batch
from .router import Router
from .api import ApiServer

__all__ = ["Engine", "Request", "SAMPLE_MODES", "SamplingParams",
           "sample", "sample_batch", "Router", "ApiServer"]
