"""Evaluation: perplexity and the offline dataset loaders (torch
counterpart of ``micromix_tpu.eval``)."""

from .datasets import get_loaders, get_textfile, synthetic_tokens
from .ppl import eval_ppl, windowed_nll

__all__ = ["eval_ppl", "windowed_nll", "get_loaders", "get_textfile",
           "synthetic_tokens"]
