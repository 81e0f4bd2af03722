"""Serving: paged int4 / int8 KV cache, runner, sampling, the engine, the
router and the HTTP API (torch counterpart of ``micromix_tpu.serve``)."""

from .attention import paged_decode_attention
# the JAX package's name for Kernel C's plain version (its dense-gather
# reference), and for the page dequantize
from .attention import paged_decode_attention_plain as paged_decode_attention_xla
from .engine import Engine, Request
from .kv_cache import PagedKVCache, kv_quantize
from .kv_cache import kv_dequantize_page as kv_dequantize
from .sampling import SAMPLE_MODES, SamplingParams, sample, sample_batch
from .router import Router
from .api import ApiServer

__all__ = ["Engine", "Request", "SAMPLE_MODES", "SamplingParams",
           "sample", "sample_batch", "Router", "ApiServer", "PagedKVCache",
           "kv_quantize", "kv_dequantize", "paged_decode_attention",
           "paged_decode_attention_xla"]
