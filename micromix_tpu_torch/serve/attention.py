"""Paged decode attention over the quantized KV cache.

Counterpart of ``micromix_tpu/serve/attention.py``.  ``paged_decode_attention``
launches ``csrc/paged_decode.cu`` on CUDA tensors and runs its plain
version on CPU tensors; both compute the whole of the JAX package's
function: int4, int8 and bf16 pages, q-side RoPE fused, a sliding window, a
per-row ``lengths`` override and the flash state ``(m, den)``.  The plain
version is the JAX package's dense-gather reference
(``paged_decode_attention_xla``) with the same fused f32 q rotation the
kernels apply first, and the Pallas kernel's window floor and empty rows.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..kernels import build, limits
from .kv_cache import PagedKVCache, kv_dequantize_page

_NEG = -1e30
_SIG = {"paged_decode": [build.PTR] * 8 + [build.INT] + [build.PTR] * 8
        + [build.INT] * 10 + [build.FLOAT, build.PTR]}
# blocks the split-KV grid aims at: 4 for each of the H100's 132 SMs;
# at most DECODE_MAX_SPLITS splits a row (the kernel's merge)
DECODE_BLOCKS = 528
DECODE_MAX_SPLITS = 32
# per device and stream: the kernel's tickets and its f32 partials
_scratch: Dict[Tuple[torch.device, int], Dict[str, torch.Tensor]] = {}


def rotate_q(q: torch.Tensor, positions: torch.Tensor,
             inv_freq: torch.Tensor) -> torch.Tensor:
    """q (B, H, D) -> f32 q rotated by positions * inv_freq (no bf16 round)."""
    inv = torch.cat([inv_freq, inv_freq]).to(torch.float32)
    ang = positions.to(torch.float32)[:, None] * inv[None, :]
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    qf = q.to(torch.float32)
    half = q.shape[-1] // 2
    rot = torch.cat([-qf[..., half:], qf[..., :half]], dim=-1)
    return qf * cos + rot * sin


def decode_split(b: int, groups: int, max_pages: int) -> Tuple[int, int]:
    """(splits, pages per split) of the kernel's grid (groups, B, splits),
    ``groups`` the KV heads times their head groups of 8: from the batch,
    the heads and ``max_pages_per_seq`` only, never from lengths on the
    device, so one cache and batch always launch the same grid."""
    pps = max(1, -(-max_pages * b * groups // DECODE_BLOCKS),
              -(-max_pages // DECODE_MAX_SPLITS))
    return -(-max_pages // pps), pps


def paged_decode_attention_plain(q: torch.Tensor, cache: PagedKVCache,
                                 seq_ids: torch.Tensor,
                                 sliding_window: Optional[int] = None,
                                 rope_positions: Optional[torch.Tensor] = None,
                                 rope_inv_freq: Optional[torch.Tensor] = None,
                                 lengths: Optional[torch.Tensor] = None,
                                 with_state: bool = False):
    """q (B, H, D) -> (B, H, D) bf16 (and with ``with_state`` the f32 (m,
    den), each (B, H)) by dequantizing every page of each row's table and
    one masked softmax in f32.  Row b attends to positions [lo, n): n is
    ``lengths[b]`` or its sequence's stored length; with a window, lo =
    ``rope_positions[b] + 1 - sliding_window`` (the query's position, as
    the JAX Pallas kernel takes it with fused RoPE), or n - window without
    positions.  A row with no position to attend gives 0 and the state
    (-1e30, 0), as the kernels do."""
    b, h, d = q.shape
    hkv, g = cache.n_kv_heads, h // cache.n_kv_heads
    mp, ps = cache.max_pages_per_seq, cache.page_size
    seq = seq_ids.long()
    pages = cache.page_table[seq].long()                      # (B, MP)
    k = kv_dequantize_page(cache.k_codes[pages], cache.k_sz[pages], cache.bits)
    v = kv_dequantize_page(cache.v_codes[pages], cache.v_sz[pages], cache.bits)
    t = mp * ps
    k = k.permute(0, 1, 4, 2, 3).reshape(b, t, hkv, d)
    v = v.permute(0, 1, 4, 2, 3).reshape(b, t, hkv, d)
    qf = (q.to(torch.float32) if rope_positions is None
          else rotate_q(q, rope_positions, rope_inv_freq))
    qf = qf * (1.0 / d ** 0.5)
    scores = torch.einsum("bkgd,btkd->bkgt", qf.reshape(b, hkv, g, d), k)
    n = (cache.lengths[seq] if lengths is None else lengths).long()[:, None]
    pos = torch.arange(t, device=q.device)[None, :]
    valid = pos < n
    if sliding_window is not None:
        wb = n if rope_positions is None else rope_positions.long()[:, None] + 1
        valid = valid & (pos >= wb - sliding_window)
    valid = valid[:, None, None, :]
    scores = scores.masked_fill(~valid, _NEG)
    m = scores.amax(dim=-1, keepdim=True)                     # -1e30: nothing valid
    e = torch.exp(scores - m) * valid
    den = e.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgt,btkd->bkgd", e, v) / den.clamp_min(1e-30)
    out = out.reshape(b, h, d).to(torch.bfloat16)
    if with_state:
        return out, m.reshape(b, h), den.reshape(b, h)
    return out


def _scratch_buffers(device: torch.device, n_tickets: int, n_acc: int,
                     n_md: int) -> Dict[str, torch.Tensor]:
    """The kernel's (B, Hkv, head groups) tickets (zero before every
    launch and left zero by it) and its f32 partials, one set per device
    and stream, grown as needed: launches on one stream run in order, so
    every call there can share them."""
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    bufs = _scratch.setdefault(key, {})
    for name, n, dtype in (("tickets", n_tickets, torch.int32),
                           ("acc", n_acc, torch.float32),
                           ("md", n_md, torch.float32)):
        if name not in bufs or bufs[name].numel() < n:
            bufs[name] = (torch.zeros if name == "tickets" else torch.empty)(
                max(n, 1024), dtype=dtype, device=device)
    return bufs


def paged_decode_attention(q: torch.Tensor, cache: PagedKVCache,
                           seq_ids: torch.Tensor, *,
                           rope_positions: Optional[torch.Tensor] = None,
                           rope_inv_freq: Optional[torch.Tensor] = None,
                           sliding_window: Optional[int] = None,
                           with_state: bool = False,
                           lengths: Optional[torch.Tensor] = None):
    """q (B, H, D) -> (B, H, D) bf16, and with ``with_state`` also (m, den),
    each (B, H) f32: the max score (after q * 1/sqrt(D)) and the softmax
    denominator of the paged part, for merging with tokens not in pages.
    Row b attends to the first ``cache.lengths[seq_ids[b]]`` tokens of its
    sequence, or the first ``lengths[b]`` (the override speculative verify
    uses: rows of one sequence at successive positions); with
    ``rope_positions`` (B,) and ``rope_inv_freq`` (D/2,) q is rotated in
    f32 and a ``sliding_window`` is counted back from the query position
    (see ``paged_decode_attention_plain``)."""
    b, h, d = q.shape
    if not q.is_cuda:
        return paged_decode_attention_plain(q, cache, seq_ids, sliding_window,
                                            rope_positions, rope_inv_freq,
                                            lengths, with_state)
    hkv, ps = cache.n_kv_heads, cache.page_size
    limits.check("decode", head_dim=d, num_heads=h, num_kv_heads=hkv,
                 bits=cache.bits, page_size=ps)
    if sliding_window is not None and sliding_window < 1:
        raise ValueError(f"sliding_window {sliding_window} < 1")
    if (rope_positions is None) != (rope_inv_freq is None):
        raise ValueError("rope_positions and rope_inv_freq go together")
    q = q.contiguous()
    if q.dtype != torch.bfloat16:
        raise ValueError("paged_decode_attention takes bf16 q")
    seq_ids = seq_ids.to(torch.int32).contiguous()
    positions = inv = None
    if rope_positions is not None:
        positions = rope_positions.to(torch.int32).contiguous()
        inv = rope_inv_freq.to(torch.float32).contiguous()
    rows = cache.lengths
    if lengths is not None:
        rows = lengths.to(device=q.device, dtype=torch.int32).contiguous()
        if rows.shape != (b,):
            raise ValueError(f"lengths shape {tuple(rows.shape)} != ({b},)")
    build.require_cuda("paged_decode_attention", q, cache.k_codes, cache.v_codes,
                       cache.k_sz, cache.v_sz, cache.page_table, rows,
                       seq_ids, positions, inv)
    out = torch.empty_like(q)
    m = den = None
    if with_state:
        m = torch.empty((b, h), dtype=torch.float32, device=q.device)
        den = torch.empty((b, h), dtype=torch.float32, device=q.device)
    if b == 0:
        return (out, m, den) if with_state else out
    mp = cache.max_pages_per_seq
    # the kernel's blocks: ceil(G / 8) head groups of each KV head
    groups = hkv * -(-(h // hkv) // 8)
    splits, pps = decode_split(b, groups, mp)
    bufs = _scratch_buffers(q.device, b * groups, b * groups * splits * 8 * d,
                            b * groups * splits * 8 * 2)
    lib = build.library("paged_decode", _SIG)
    build.launches["paged_decode"] += 1
    build.page_launches[("paged_decode", cache.bits)] += 1
    build.row_launches[("paged_decode" if lengths is None
                        else "paged_decode_lengths", b)] += 1
    rc = lib.paged_decode(
        build.ptr(q), build.ptr(cache.k_codes), build.ptr(cache.v_codes),
        build.ptr(cache.k_sz), build.ptr(cache.v_sz),
        build.ptr(cache.page_table), build.ptr(seq_ids), build.ptr(rows),
        int(lengths is not None), build.ptr(positions), build.ptr(inv),
        build.ptr(out), build.ptr(m), build.ptr(den), build.ptr(bufs["acc"]),
        build.ptr(bufs["md"]), build.ptr(bufs["tickets"]), b, h, hkv, d, ps, mp,
        cache.bits, sliding_window or 0, splits, pps, 1.0 / d ** 0.5,
        build.stream())
    build.check(rc, "paged_decode")
    return (out, m, den) if with_state else out
