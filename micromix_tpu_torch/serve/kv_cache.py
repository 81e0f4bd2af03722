"""Quantized paged KV cache in the JAX package's token-minor layout.

Counterpart of ``micromix_tpu/serve/kv_cache.py``.  Per layer:

  * codes: (n_pages, n_kv_heads, dq, page_size) uint8, dq = D/2 for int4
    (low nibble = dim i, high nibble = dim i + D/2) or D for int8;
  * sz: (n_pages, n_kv_heads, 2, page_size) bf16, [scale, zero] per
    (token, head): an asymmetric uint grid over head_dim, round-half-even;
  * page_table (max_seqs, max_pages_per_seq) int32; lengths (max_seqs,).

Unlike the JAX package's functional updates, ``append_kv`` writes the page
arrays and lengths in place (one copy of the cache in device memory) and
returns the same cache object.  Decode attention on the GPU takes int4
pages only; int8 / bf16 pages are plain-version only.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..device import resolve_device
from .append_kernel import append_kv_kernel

# 1 / (2^bits - 1) rounded to f32, as XLA's constant folding computes it
_F32_RECIP = {b: float(np.float32(1.0) / np.float32(2 ** b - 1)) for b in (4, 8)}


@dataclasses.dataclass
class PagedKVCache:
    k_codes: torch.Tensor   # (P, Hkv, dq, ps) uint8
    v_codes: torch.Tensor
    k_sz: torch.Tensor      # (P, Hkv, 2, ps) bf16: [scale, zero]
    v_sz: torch.Tensor
    page_table: torch.Tensor  # (S, max_pages) int32
    lengths: torch.Tensor     # (S,) int32
    bits: int = 4

    @property
    def page_size(self) -> int:
        return self.k_codes.shape[3]

    @property
    def head_dim(self) -> int:
        d = self.k_codes.shape[2]
        return d * 2 if self.bits == 4 else d

    @property
    def n_kv_heads(self) -> int:
        return self.k_codes.shape[1]

    @property
    def max_pages_per_seq(self) -> int:
        return self.page_table.shape[1]


def make_cache(n_pages: int, page_size: int, n_kv: int, head_dim: int,
               max_seqs: int, max_pages_per_seq: int, bits: int = 4,
               device=None) -> PagedKVCache:
    """An empty cache on ``device`` (default the GPU; raises without one)."""
    if bits not in (4, 8):
        raise ValueError(f"kv bits {bits}: the port keeps int4 / int8 pages")
    device = resolve_device(device)
    dq = head_dim // 2 if bits == 4 else head_dim

    def z8():
        return torch.zeros((n_pages, n_kv, dq, page_size), dtype=torch.uint8,
                           device=device)

    def zs():
        return torch.zeros((n_pages, n_kv, 2, page_size), dtype=torch.bfloat16,
                           device=device)

    return PagedKVCache(
        k_codes=z8(), v_codes=z8(), k_sz=zs(), v_sz=zs(),
        page_table=torch.zeros((max_seqs, max_pages_per_seq), dtype=torch.int32,
                               device=device),
        lengths=torch.zeros((max_seqs,), dtype=torch.int32, device=device),
        bits=bits)


def kv_quantize(x: torch.Tensor, bits: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (..., D) -> (codes u8 (..., dq), scale bf16 (...), zero bf16 (...))."""
    xf = x.to(torch.float32)
    gmax = xf.amax(dim=-1, keepdim=True)
    gmin = xf.amin(dim=-1, keepdim=True)
    qmax = float(2 ** bits - 1)
    # the JAX package's serving program (every runner step is jitted) has
    # XLA fold ``/ qmax`` into a multiply by the f32 reciprocal; the port
    # computes that same product
    scale = torch.clamp(gmax - gmin, min=1e-5) * _F32_RECIP[bits]
    zero = torch.clamp(torch.round(-gmin / scale), 0.0, qmax)
    q = torch.clamp(torch.round(xf / scale) + zero, 0.0, qmax).to(torch.uint8)
    if bits == 4:
        d = x.shape[-1] // 2
        q = q[..., :d] | (q[..., d:] << 4)
    return q, scale[..., 0].to(torch.bfloat16), zero[..., 0].to(torch.bfloat16)


def kv_dequantize_page(codes: torch.Tensor, sz: torch.Tensor, bits: int,
                       dtype=torch.float32) -> torch.Tensor:
    """codes (..., dq, ps) + sz (..., 2, ps) -> values (..., D, ps); bf16
    pages (bits 16) hold the values themselves."""
    if bits == 16:
        return codes.to(dtype)
    if bits == 4:
        q = torch.cat([codes & 0xF, codes >> 4], dim=-2)
    else:
        q = codes
    scale = sz[..., 0:1, :].to(torch.float32)
    zero = sz[..., 1:2, :].to(torch.float32)
    return ((q.to(torch.float32) - zero) * scale).to(dtype)


def append_kv(cache: PagedKVCache, seq_ids: torch.Tensor,
              positions: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor) -> PagedKVCache:
    """Write T tokens in place.  seq_ids/positions (T,), k/v (T, Hkv, D).

    The page-table rows for these positions must already be populated;
    lengths become max(length, position + 1) per sequence.
    """
    kq, ks, kz = kv_quantize(k, cache.bits)
    vq, vs, vz = kv_quantize(v, cache.bits)
    positions = positions.to(torch.long)
    seq_ids = seq_ids.to(torch.long)
    page_id = cache.page_table[seq_ids, positions // cache.page_size]
    off = (positions % cache.page_size).to(torch.int32)
    append_kv_kernel(cache.k_codes, cache.v_codes, cache.k_sz, cache.v_sz,
                     page_id, off, kq, vq, torch.stack([ks, kz], dim=-1),
                     torch.stack([vs, vz], dim=-1))
    cache.lengths.scatter_reduce_(0, seq_ids, (positions + 1).to(torch.int32),
                                  reduce="amax")
    return cache


def gather_kv(cache: PagedKVCache, seq_id: int, max_len: int,
              dtype=torch.bfloat16) -> Tuple[torch.Tensor, torch.Tensor]:
    """One sequence's KV, dequantized to (max_len, Hkv, D)."""
    ps = cache.page_size
    n_pages = max_len // ps
    pages = cache.page_table[seq_id, :n_pages].long()

    def one(codes, sz):
        x = kv_dequantize_page(codes[pages], sz[pages], cache.bits, dtype)
        return x.permute(0, 3, 1, 2).reshape(n_pages * ps, cache.n_kv_heads,
                                             cache.head_dim)

    return one(cache.k_codes, cache.k_sz), one(cache.v_codes, cache.v_sz)
