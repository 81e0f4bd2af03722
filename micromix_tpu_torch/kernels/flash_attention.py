"""Causal prefill flash attention (GQA, optional sliding window).

Counterpart of ``micromix_tpu/kernels/flash_attention.py``:
``flash_attention`` runs the CUDA kernel (``csrc/flash_attention.cu``) on
CUDA tensors and its plain version on CPU tensors.  Both keep the JAX
kernel's f32 arithmetic (exact bf16 products, f32 sums, probabilities
carried to about 24 bits into P.V) and round the output to bf16.
``flash_attention_hsd`` is the single-sequence (H, S, D) entry point.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import build, limits

_NEG = -1e30
_SIG = {"flash_attention": [build.PTR, build.PTR, build.PTR, build.PTR,
                            build.INT, build.INT, build.INT, build.INT,
                            build.INT, build.INT, build.FLOAT, build.PTR]}


def causal_mask(s_q: int, s_k: int, sliding_window: Optional[int] = None,
                offset: int = 0, device=None) -> torch.Tensor:
    """(s_q, s_k) bool, True = attend: query i, at position i + ``offset``,
    sees keys j <= i + offset (and, with a window, j > i + offset -
    window)."""
    qi = torch.arange(s_q, device=device)[:, None] + offset
    kj = torch.arange(s_k, device=device)[None, :]
    m = kj <= qi
    if sliding_window is not None:
        m = m & (kj > qi - sliding_window)
    return m


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          sliding_window: Optional[int] = None) -> torch.Tensor:
    """Dense f32 causal attention: the kernel's function without tiling."""
    b, s, h, d = q.shape
    g = h // k.shape[2]
    qf = q.to(torch.float32) * (1.0 / d ** 0.5)
    kf = k.to(torch.float32).repeat_interleave(g, dim=2)
    vf = v.to(torch.float32).repeat_interleave(g, dim=2)
    scores = torch.einsum("bshd,bthd->bhst", qf, kf)
    mask = causal_mask(s, s, sliding_window, device=q.device)
    scores = scores.masked_fill(~mask, _NEG)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhst,bthd->bshd", probs, vf).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    sliding_window: Optional[int] = None) -> torch.Tensor:
    """q (B, S, H, D), k/v (B, S, Hkv, D) bf16 -> (B, S, H, D) bf16."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    if k.shape != (b, s, hkv, d) or v.shape != k.shape or h % hkv:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, sliding_window)
    limits.check("flash", head_dim=d, num_heads=h, num_kv_heads=hkv)
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise ValueError("flash_attention takes bf16 q, k, v")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    build.require_cuda("flash_attention", q, k, v)
    out = torch.empty_like(q)
    if b * s == 0:
        return out
    lib = build.library("flash_attention", _SIG)
    build.launches["flash_attention"] += 1
    rc = lib.flash_attention(build.ptr(q), build.ptr(k), build.ptr(v),
                             build.ptr(out), b, s, h, hkv, d,
                             sliding_window or 0, 1.0 / d ** 0.5,
                             build.stream())
    build.check(rc, "flash_attention")
    return out


def flash_attention_hsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        sliding_window: Optional[int] = None) -> torch.Tensor:
    """Single-sequence form: q (H, S, D), k/v (Hkv, S, D) -> (H, S, D)."""
    return flash_attention(q.transpose(0, 1)[None], k.transpose(0, 1)[None],
                           v.transpose(0, 1)[None],
                           sliding_window=sliding_window)[0].transpose(0, 1)
