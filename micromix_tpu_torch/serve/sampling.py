"""Token sampling: greedy / temperature / top-k / top-p (nucleus), and
the logit controls (repetition penalty, terminator suppression, min-p).

Counterpart of ``micromix_tpu/serve/sampling.py`` (``SamplingParams``,
``uses_logit_controls``, ``minp_shifts``, ``unpack_presence``,
``ban_mask``, ``apply_logit_controls``, ``sample`` (one
``SamplingParams`` for every row), ``SAMPLE_MODES``, ``sample_batch``,
``pick_sample_mode``).  Randomness comes from a ``torch.Generator``, so
sampled (non-greedy) tokens differ from the JAX package's for the same
seed, unless the caller hands in the Gumbel noise (``gumbel=``); greedy
rows and the controlled logits are identical.  The controls are plain PyTorch ops over (B, V), as the JAX
package computes them outside any kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..mx.numerics import div

SAMPLE_MODES = ("greedy", "simple", "topk", "full")
_TOPK_WIDTH = 128


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0        # 0 -> greedy
    top_k: int = 0                  # 0 -> disabled
    top_p: float = 1.0              # 1 -> disabled
    min_p: float = 0.0              # 0 -> disabled (keep p >= min_p*pmax)
    repetition_penalty: float = 1.0  # 1 -> disabled (HF rule)
    min_new_tokens: int = 0          # suppress terminators until emitted


def uses_logit_controls(sampling_params) -> bool:
    """True if any request needs the logit-controls stage.  Min-p rides
    it: on raw logits p >= min_p * pmax is x >= xmax + T * ln(min_p), a
    per-row offset."""
    return any(p is not None and (p.repetition_penalty != 1.0
                                  or p.min_new_tokens > 0
                                  or p.min_p > 0.0)
               for p in sampling_params)


def minp_shifts(params) -> np.ndarray:
    """Per-row min-p offsets (B,) f32: T * ln(min_p) in float64, then f32;
    -inf disables the filter, and a greedy row (T <= 0) takes 0.0, which
    keeps exactly the argmax."""
    out = np.full((len(params),), -np.inf, np.float32)
    for i, p in enumerate(params):
        if p is not None and p.min_p > 0.0:
            out[i] = (p.temperature * float(np.log(min(p.min_p, 1.0)))
                      if p.temperature > 0.0 else 0.0)
    return out


def unpack_presence(packed: torch.Tensor, v: int) -> torch.Tensor:
    """Bit-packed (B, ceil(V/8)) uint8 (little bit order, np.packbits)
    -> (B, V) bool."""
    idx = torch.arange(v, device=packed.device)
    return ((packed[:, idx // 8] >> (idx % 8).to(torch.uint8)) & 1).to(torch.bool)


def ban_mask(ban_ids: torch.Tensor, v: int) -> torch.Tensor:
    """(B, W) int32 token ids (-1 padding) -> (B, V) bool, True at every
    listed terminator (eos_id and stop_ids)."""
    vocab = torch.arange(v, device=ban_ids.device)
    return (vocab[None, :, None] == ban_ids[:, None, :]).any(dim=-1)


def apply_logit_controls(logits: torch.Tensor, presence: torch.Tensor,
                         penalties: torch.Tensor, suppress: torch.Tensor,
                         minp_shift: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """(B, V) logits -> f32 controlled logits, in the JAX package's order:
    the repetition penalty on present tokens (x / p where x > 0, else
    x * p; p == 1 leaves the row), then the suppression (-inf), then
    min-p over the penalized logits (keep x >= xmax + shift)."""
    x = logits.to(torch.float32)
    p = penalties[:, None]
    pen = torch.where(x > 0, x / p, x * p)
    x = torch.where(presence & (p != 1.0), pen, x)
    x = x.masked_fill(suppress, -torch.inf)
    if minp_shift is not None:
        thresh = x.amax(dim=-1, keepdim=True) + minp_shift[:, None]
        x = x.masked_fill(x < thresh, -torch.inf)
    return x


def chosen_logprobs(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """(B, V) raw logits, (B,) chosen ids -> (B,) f32 log-probabilities:
    log_softmax of the untempered, unpenalized logits (OpenAI's
    definition)."""
    rows = torch.arange(logits.shape[0], device=logits.device)
    return torch.log_softmax(logits.to(torch.float32), dim=-1)[rows, tokens.long()]


def _categorical(x: torch.Tensor, gen: Optional[torch.Generator],
                 gumbel: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One draw per row from softmax(x) (Gumbel-max; -inf rows excluded).
    ``gumbel``: the noise to add instead of drawing it from ``gen``."""
    if gumbel is None:
        u = torch.rand(x.shape, generator=gen, device=x.device,
                       dtype=torch.float32)
        gumbel = -torch.log(-torch.log(u.clamp(min=torch.finfo(torch.float32).tiny)))
    return torch.argmax(x + gumbel, dim=-1)


def sample(logits: torch.Tensor, gen: Optional[torch.Generator] = None,
           params: SamplingParams = SamplingParams(),
           gumbel: Optional[torch.Tensor] = None) -> torch.Tensor:
    """logits (B, V) -> token ids (B,) int32 under one ``params``: argmax
    at temperature 0; else logits / T, the top-k and top-p filters (the
    smallest set whose cumulative probability reaches top_p, at least one
    token), and one Gumbel-max draw (from ``gen``, or ``gumbel``)."""
    if params.temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    x = div(logits.to(torch.float32), params.temperature)
    if params.top_k and params.top_k > 0:
        kth = torch.topk(x, params.top_k, dim=-1).values[..., -1:]
        x = torch.where(x < kth, -torch.inf, x)
    if params.top_p < 1.0:
        sorted_x = torch.sort(x, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_x, dim=-1), dim=-1)
        # an index past the end (rounding) masks nothing, as JAX's gather
        # of a filled out-of-bounds value does
        idx = (cum < params.top_p).sum(dim=-1, keepdim=True)
        cutoff = sorted_x.gather(-1, idx.clamp(max=x.shape[-1] - 1))
        x = torch.where(x < cutoff, -torch.inf, x)
    return _categorical(x, gen, gumbel).to(torch.int32)


def sample_batch(logits: torch.Tensor, gen: Optional[torch.Generator],
                 temperature: torch.Tensor, top_k: torch.Tensor,
                 top_p: torch.Tensor, *, mode: str = "full") -> torch.Tensor:
    """Per-row sampling: logits (B, V); temperature/top_k/top_p (B,).
    top_k <= 0 and top_p >= 1 disable a filter; temperature <= 0 is greedy.
    ``mode`` picks the cheapest computation that covers the rows."""
    assert mode in SAMPLE_MODES, mode
    x = logits.to(torch.float32)
    v = x.shape[-1]
    t = torch.clamp(temperature, min=1e-6)[:, None]
    greedy = torch.argmax(x, dim=-1)
    if mode == "greedy":
        return greedy.to(torch.int32)
    is_greedy = temperature <= 0.0
    if mode == "simple":
        drawn = _categorical(x / t, gen)
        return torch.where(is_greedy, greedy, drawn).to(torch.int32)
    if mode == "topk":
        kmax = min(_TOPK_WIDTH, v)
        vals = torch.topk(x, kmax, dim=-1).values                # descending
        k_idx = torch.clamp(torch.where(top_k > 0, top_k, kmax) - 1, 0, kmax - 1)
        kth = vals.gather(-1, k_idx[:, None].long())
        kth = torch.where(top_k[:, None] > 0, kth, torch.full_like(kth, -torch.inf))
        xm = torch.where(x < kth, torch.full_like(x, -torch.inf), x)
        drawn = _categorical(xm / t, gen)
        return torch.where(is_greedy, greedy, drawn).to(torch.int32)
    # full: stable ascending sort reversed, as jnp.argsort(...)[:, ::-1]
    order = torch.flip(torch.argsort(x, dim=-1, stable=True), dims=[-1])
    sx = x.gather(-1, order)
    rank = torch.arange(v, device=x.device)[None, :]
    keep = rank < torch.where(top_k > 0, top_k, v)[:, None]
    cum = torch.cumsum(torch.softmax(sx / t, dim=-1), dim=-1)
    cutoff = (cum < top_p[:, None]).sum(dim=-1, keepdim=True)
    keep = keep & (rank <= cutoff)
    masked = torch.where(keep, sx / t, torch.full_like(sx, -torch.inf))
    drawn = order.gather(-1, _categorical(masked, gen)[:, None])[:, 0]
    return torch.where(is_greedy, order[:, 0], drawn).to(torch.int32)


def pick_sample_mode(sampling_params) -> str:
    """Cheapest sample_batch mode covering the given SamplingParams."""
    ps = [p for p in sampling_params if p is not None]
    if any(p.top_p < 1.0 or p.top_k > _TOPK_WIDTH for p in ps):
        return "full"
    if any(p.top_k > 0 for p in ps):
        return "topk"
    if all(p.temperature <= 0.0 for p in ps):
        return "greedy"
    return "simple"
