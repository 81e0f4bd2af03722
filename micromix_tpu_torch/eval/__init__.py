"""Evaluation: perplexity, the lm-eval adapter and the dataset loaders
(torch counterpart of ``micromix_tpu.eval``)."""

from .datasets import get_loaders, get_textfile, synthetic_tokens
from .lm_eval_adapter import Scorer, make_lm_eval_model, run_lm_eval
from .ppl import eval_ppl, windowed_nll

__all__ = ["eval_ppl", "windowed_nll", "get_loaders", "get_textfile",
           "synthetic_tokens", "Scorer", "make_lm_eval_model", "run_lm_eval"]
