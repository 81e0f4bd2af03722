"""Perplexity over a token stream.

Counterpart of ``micromix_tpu/eval/ppl.py``: the stream is cut into
``seqlen`` windows, each window runs the causal forward, and the
perplexity is exp(summed next-token NLL / scored tokens).  Windows run on
the params' device.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

from ..models.common import ModelConfig
from ..models.transformer import forward


def windowed_nll(params, cfg: ModelConfig, window: torch.Tensor,
                 kv_quant_bits: Optional[int] = None) -> torch.Tensor:
    """window (B, S) -> summed next-token NLL over (B, S-1) positions, f32."""
    logits = forward(params, cfg, window, kv_quant_bits=kv_quant_bits)
    logp = torch.log_softmax(logits[:, :-1].to(torch.float32), dim=-1)
    del logits
    tgt = window[:, 1:].long()
    return -logp.gather(-1, tgt[..., None])[..., 0].sum()


def eval_ppl(params, cfg: ModelConfig, token_stream: np.ndarray, *,
             seqlen: int = 2048, batch: int = 1,
             kv_quant_bits: Optional[int] = None,
             progress: Optional[Callable[[int, int], None]] = None) -> float:
    """token_stream: 1-D test-set token ids."""
    tokens = np.asarray(token_stream).reshape(-1)
    nwin = len(tokens) // seqlen
    if nwin == 0:
        raise ValueError(f"token stream of {len(tokens)} is shorter than "
                         f"one window of {seqlen}")
    tokens = tokens[: nwin * seqlen].reshape(nwin, seqlen)
    dev = params["embed"].device
    total = 0.0
    count = 0
    i = 0
    with torch.inference_mode():
        while i < nwin:
            w = torch.as_tensor(tokens[i: i + batch], dtype=torch.long).to(dev)
            b = w.shape[0]
            total += float(windowed_nll(params, cfg, w, kv_quant_bits))
            count += b * (seqlen - 1)
            i += b
            if progress is not None:
                progress(i, nwin)
    return math.exp(total / count)
