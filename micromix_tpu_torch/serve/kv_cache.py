"""Quantized (or bf16) paged KV cache in the JAX package's token-minor
layout.

Counterpart of ``micromix_tpu/serve/kv_cache.py``.  Per layer:

  * codes: (n_pages, n_kv_heads, dq, page_size) uint8, dq = D/2 for int4
    (low nibble = dim i, high nibble = dim i + D/2) or D for int8; bf16
    pages (``bits=16``) hold the values themselves, (n_pages, n_kv_heads,
    D, page_size) bf16;
  * sz: (n_pages, n_kv_heads, 2, page_size) bf16, [scale, zero] per
    (token, head): an asymmetric uint grid over head_dim, round-half-even
    ([1, 0] for bf16 pages, which no attention reads);
  * page_table (max_seqs, max_pages_per_seq) int32; lengths (max_seqs,).

Unlike the JAX package's functional updates, ``append_kv`` writes the page
arrays and lengths in place (one copy of the cache in device memory) and
returns the same cache object.  On the card it is one launch of Kernel D
(``append_kernel.append_kv_quant``), K's RoPE included when the decode
step hands it the tables; ``append_kv_plain`` is its plain version.
Decode and prefill attention on the GPU take all three page widths.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from .append_kernel import append_kv_plain as store_plain
from .append_kernel import append_kv_quant

# 1 / (2^bits - 1) rounded to f32, as XLA's constant folding computes it
_F32_RECIP = {b: float(np.float32(1.0) / np.float32(2 ** b - 1)) for b in (4, 8)}


@dataclasses.dataclass
class PagedKVCache:
    k_codes: torch.Tensor   # (P, Hkv, dq, ps) uint8, or (P, Hkv, D, ps) bf16
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
    if bits not in (4, 8, 16):
        raise ValueError(f"kv bits {bits}: the pages are int4, int8 or bf16")
    device = resolve_device(device)
    dq = head_dim // 2 if bits == 4 else head_dim
    dt = torch.bfloat16 if bits == 16 else torch.uint8

    def z8():
        return torch.zeros((n_pages, n_kv, dq, page_size), dtype=dt,
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
    """x (..., D) -> (codes u8 (..., dq), scale bf16 (...), zero bf16 (...));
    bits 16 is the identity: the bf16 values, scale 1 and zero 0."""
    if bits == 16:
        ones = torch.ones(x.shape[:-1], dtype=torch.bfloat16, device=x.device)
        return x.to(torch.bfloat16), ones, torch.zeros_like(ones)
    xf = x.to(torch.float32)
    gmax = xf.amax(dim=-1, keepdim=True)
    gmin = xf.amin(dim=-1, keepdim=True)
    qmax = float(2 ** bits - 1)
    # the JAX package's serving program (every runner step is jitted) has
    # XLA fold ``/ qmax`` into a multiply by the f32 reciprocal; the port
    # computes that same product
    scale = torch.clamp(gmax - gmin, min=1e-5) * _F32_RECIP[bits]
    # + 0.0: a row above zero rounds -gmin / scale to -0.0, which clamp
    # keeps; XLA's max, as the JAX package's jitted program has it, gives +0.0
    zero = torch.clamp(torch.round(-gmin / scale), 0.0, qmax) + 0.0
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


def rope_rows(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (T, H, D) with per-row angle tables (T, D); rounds to x's dtype.
    Counterpart of ``micromix_tpu/serve/runner.py::_rope1``: each product
    rounded to f32 on its own, then the sum (the JAX CPU program contracts
    ``x * cos + ...`` into an FMA; ROADMAP 3.2)."""
    half = x.shape[-1] // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return (x.to(torch.float32) * cos[:, None, :]
            + rot.to(torch.float32) * sin[:, None, :]).to(x.dtype)


def append_kv_plain(cache: PagedKVCache, seq_ids: torch.Tensor,
                    positions: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    rope=None) -> PagedKVCache:
    """The plain version of ``append_kv``: ``rope_rows`` of K when ``rope``
    is given, ``kv_quantize`` of K and V, the slot index, one indexed
    store per page array and the ``lengths`` max."""
    if rope is not None:
        k = rope_rows(k, *rope)
    kq, ks, kz = kv_quantize(k, cache.bits)
    vq, vs, vz = kv_quantize(v, cache.bits)
    positions = positions.to(torch.long)
    seq_ids = seq_ids.to(torch.long)
    page_id = cache.page_table[seq_ids, positions // cache.page_size]
    off = positions % cache.page_size
    store_plain(cache.k_codes, cache.v_codes, cache.k_sz, cache.v_sz,
                page_id, off, kq, vq, torch.stack([ks, kz], dim=-1),
                torch.stack([vs, vz], dim=-1))
    cache.lengths.scatter_reduce_(0, seq_ids, (positions + 1).to(torch.int32),
                                  reduce="amax")
    return cache


def _check_slots(cache: PagedKVCache, seq_ids: torch.Tensor,
                 positions: torch.Tensor) -> None:
    """On CPU tensors: every token has a sequence row, a page-table column
    and a page id inside the arrays (the kernel skips such a token; reading
    device indices here would wait for the card)."""
    s, mp = cache.page_table.shape
    seq, pos = seq_ids.long(), positions.long()
    if bool(((seq < 0) | (seq >= s) | (pos < 0)
             | (pos // cache.page_size >= mp)).any()):
        raise ValueError("append_kv: a token's sequence or page lies outside "
                         f"the page table {(s, mp)}")
    pages = cache.page_table[seq, pos // cache.page_size]
    if bool(((pages < 0) | (pages >= cache.k_codes.shape[0])).any()):
        raise ValueError("append_kv: a token's page id lies outside the "
                         f"{cache.k_codes.shape[0]} pages")


def append_kv(cache: PagedKVCache, seq_ids: torch.Tensor,
              positions: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
              ) -> PagedKVCache:
    """Write T tokens in place.  seq_ids/positions (T,), k/v (T, Hkv, D)
    bf16; ``rope`` = (cos, sin), each (T, D) f32, rotates K first (the
    decode step's K, as the JAX runner rotates it before its append).

    The page-table rows for these positions must already be populated;
    lengths become max(length, position + 1) per sequence.  On CUDA
    tensors one launch of Kernel D, which takes int32 seq_ids and
    positions and raises on inputs it cannot take; on CPU tensors the
    plain version, which raises for a token outside the page table.
    """
    if k.dtype != torch.bfloat16 or v.dtype != torch.bfloat16:
        raise ValueError(f"append_kv: k/v {k.dtype}, {v.dtype}: takes bf16")
    t = k.shape[0]
    if (k.shape != (t, cache.n_kv_heads, cache.head_dim) or v.shape != k.shape
            or seq_ids.shape != (t,) or positions.shape != (t,)):
        raise ValueError(f"append_kv shapes: k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}, seq_ids {tuple(seq_ids.shape)}, "
                         f"positions {tuple(positions.shape)} for "
                         f"{cache.n_kv_heads} heads of {cache.head_dim}")
    if rope is not None and any(a.dtype != torch.float32 or a.shape != (t, k.shape[2])
                                for a in rope):
        raise ValueError("append_kv: RoPE tables must be f32 (T, D)")
    if not cache.k_codes.is_cuda:
        _check_slots(cache, seq_ids, positions)
        return append_kv_plain(cache, seq_ids, positions, k, v, rope)
    cos, sin = rope if rope is not None else (None, None)
    append_kv_quant(cache.k_codes, cache.v_codes, cache.k_sz, cache.v_sz,
                    cache.page_table, cache.lengths, seq_ids, positions, k, v,
                    cache.bits, _F32_RECIP.get(cache.bits, 0.0), cos, sin)
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
