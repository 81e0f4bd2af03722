"""Paged chunked-prefill attention: quantized history + in-chunk causal.

Counterpart of ``micromix_tpu/serve/prefill_attention.py``.
``paged_prefill_attention`` launches ``csrc/paged_prefill.cu`` on CUDA
tensors (int4, int8 or bf16 pages, any GQA group up to 8) and its plain
version on CPU tensors.  The plain
version computes what the TPU kernel computes: probabilities in f32, the
history read from the quantized pages and the chunk from its exact bf16
K/V.  (The JAX runner's CPU branch, ``gather_kv`` plus XLA attention,
rounds the probabilities to bf16 instead.)  The kernel unpacks the
history as exact bf16 ``(c - z)``, so it needs the integer zero points in
[0, 2^bits - 1] that ``kv_quantize`` makes.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from ..kernels import build, limits
from ..kernels.flash_attention import causal_mask
from .kv_cache import PagedKVCache, kv_dequantize_page

_NEG = -1e30
_SIG = {"paged_prefill": [build.PTR] * 10 + [build.INT] * 7
        + [build.FLOAT, build.PTR]}


def _start_tensor(start_pos, device) -> torch.Tensor:
    """start as one int32 on ``device`` (no host read of a device value)."""
    return torch.as_tensor(start_pos, dtype=torch.int32).reshape(1).to(device)


def paged_prefill_attention_plain(q: torch.Tensor, k_chunk: torch.Tensor,
                                  v_chunk: torch.Tensor, cache: PagedKVCache,
                                  seq_id: int, start_pos,
                                  sliding_window: Optional[int] = None
                                  ) -> torch.Tensor:
    """Every page of the sequence's table dequantized, masked to
    kpos < start (and the window), joined with the chunk's causal mask,
    one f32 softmax with the kernel's -1e30 fill and 1e-30 floor."""
    s, h, d = q.shape
    hkv = k_chunk.shape[1]
    g = h // hkv
    ps, mp = cache.page_size, cache.max_pages_per_seq
    pages = cache.page_table[seq_id].long()
    t = mp * ps

    def history(codes, sz):
        x = kv_dequantize_page(codes[pages], sz[pages], cache.bits)
        return x.permute(0, 3, 1, 2).reshape(t, hkv, d)

    start = _start_tensor(start_pos, q.device)
    kpos = torch.arange(t, device=q.device)
    qpos = start + torch.arange(s, device=q.device)
    hist_ok = (kpos[None, :] < start).expand(s, t)
    if sliding_window is not None:
        hist_ok = hist_ok & (kpos[None, :] > qpos[:, None] - sliding_window)
    keep = (kpos < start)[:, None, None]
    k_all = torch.cat([torch.where(keep, history(cache.k_codes, cache.k_sz), 0.0),
                       k_chunk.to(torch.float32)])
    v_all = torch.cat([torch.where(keep, history(cache.v_codes, cache.v_sz), 0.0),
                       v_chunk.to(torch.float32)])
    allow = torch.cat([hist_ok, causal_mask(s, s, sliding_window, device=q.device)], 1)
    qf = q.to(torch.float32).reshape(s, hkv, g, d) * (1.0 / d ** 0.5)
    scores = torch.einsum("skgd,tkd->kgst", qf, k_all)
    scores = scores.masked_fill(~allow, _NEG)
    e = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    den = e.sum(dim=-1, keepdim=True)
    out = torch.einsum("kgst,tkd->kgsd", e, v_all) / den.clamp_min(1e-30)
    return out.permute(2, 0, 1, 3).reshape(s, h, d).to(torch.bfloat16)


def paged_prefill_attention(q: torch.Tensor, k_chunk: torch.Tensor,
                            v_chunk: torch.Tensor, cache: PagedKVCache,
                            seq_id: int, start_pos: Union[int, torch.Tensor], *,
                            sliding_window: Optional[int] = None
                            ) -> torch.Tensor:
    """q (S, H, D) post-RoPE at positions [start_pos, start_pos + S);
    k_chunk / v_chunk (S, Hkv, D) the chunk's own post-RoPE K/V, exact
    bf16; ``cache`` holds the quantized history of row ``seq_id`` of its
    page table (positions < start_pos).  Returns (S, H, D) bf16."""
    s, h, d = q.shape
    hkv = k_chunk.shape[1]
    if k_chunk.shape != (s, hkv, d) or v_chunk.shape != k_chunk.shape or h % hkv:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k_chunk.shape)} "
                         f"v {tuple(v_chunk.shape)}")
    if not q.is_cuda:
        return paged_prefill_attention_plain(q, k_chunk, v_chunk, cache, seq_id,
                                             start_pos, sliding_window)
    ps = cache.page_size
    limits.check("prefill", head_dim=d, num_heads=h, num_kv_heads=hkv,
                 bits=cache.bits, page_size=ps)
    if not (q.dtype == k_chunk.dtype == v_chunk.dtype == torch.bfloat16):
        raise ValueError("paged_prefill_attention takes bf16 q, k, v")
    if not 0 <= seq_id < cache.page_table.shape[0]:
        raise ValueError(f"seq_id {seq_id} outside the page table")
    q, k_chunk, v_chunk = q.contiguous(), k_chunk.contiguous(), v_chunk.contiguous()
    start = _start_tensor(start_pos, q.device)
    build.require_cuda("paged_prefill_attention", q, k_chunk, v_chunk,
                       cache.k_codes, cache.v_codes, cache.k_sz, cache.v_sz,
                       cache.page_table, start)
    out = torch.empty_like(q)
    if s == 0:
        return out
    table = cache.page_table[seq_id]          # a view: row of the table
    lib = build.library("paged_prefill", _SIG)
    build.launches["paged_prefill"] += 1
    build.page_launches[("paged_prefill", cache.bits)] += 1
    rc = lib.paged_prefill(
        build.ptr(q), build.ptr(k_chunk), build.ptr(v_chunk),
        build.ptr(cache.k_codes), build.ptr(cache.v_codes),
        build.ptr(cache.k_sz), build.ptr(cache.v_sz), build.ptr(table),
        build.ptr(start), build.ptr(out), s, h, hkv, d, ps,
        sliding_window or 0, cache.bits, 1.0 / d ** 0.5, build.stream())
    build.check(rc, "paged_prefill")
    return out
