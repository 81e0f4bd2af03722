"""What the card's attention and KV-cache kernels take.

One statement shared by the wrappers of Kernels E (``flash_attention``),
C (``paged_decode_attention``), H (``paged_prefill_attention``) and D
(``append_kv_quant``), and by the engine's refusal before it makes any
cache (``serve.engine.check_card_serves``), so that the engine refuses
exactly what one of its kernels would refuse later:

  * head_dim up to 256 (``MAX_HEAD_DIM``; Gemma's heads, the widest of
    any public decoder): the kernels template their tiles on a padded
    width of 64, 128 or 256 and zero the dims past the true one, as the
    JAX kernel pads D to its 128-lane tile.  E takes any D from 1; C, D
    and H take even D only, since their int4 pages pair dims i and
    i + D/2 in one byte and RoPE pairs the same dims;
  * at most 64 query heads per KV head for C (blocks of 8 heads, the
    MMA's 8 columns, ceil(G / 8) of them a KV head) and H (a 64-row block
    holds G x floor(64 / G) rows: at G = 64 one position); E takes any
    group;
  * KV pages of 4, 8 or 16 bits (int4, int8, bf16) for C, D and H;
  * page sizes 16, 32, 64, and every multiple of 128 up to 1024 for C
    (``decode_page_size_ok``: a ring stage holds at most 128 tokens of a
    page as whole 16-byte chunks of each row, swizzled by a power of two;
    the JAX kernel's pages on its chip are multiples of 128), any
    multiple of 4 for H (its smallest page copy is 4 tokens); the engine
    runs both.
"""

from __future__ import annotations

from typing import Optional

MAX_HEAD_DIM = 256
MAX_GROUP = 64
KV_BITS = (4, 8, 16)
DECODE_STAGE_TOKENS = 128     # tokens of a page one ring stage of C holds
DECODE_MAX_PAGE = 1024
KERNELS = ("flash", "decode", "prefill", "append", "engine")


def decode_page_size_ok(page_size: int) -> bool:
    """C's page sizes: 16, 32, 64, or a multiple of 128 up to 1024."""
    if page_size <= DECODE_STAGE_TOKENS:
        return page_size in (16, 32, 64, 128)
    return (page_size % DECODE_STAGE_TOKENS == 0
            and page_size <= DECODE_MAX_PAGE)


def refusal(kernel: str, *, head_dim: int, num_heads: Optional[int] = None,
            num_kv_heads: Optional[int] = None, bits: Optional[int] = None,
            page_size: Optional[int] = None) -> Optional[str]:
    """Why ``kernel`` (one of ``KERNELS``; "engine" is C, D, E and H
    together) cannot take these shapes on the card, or None.  Arguments
    left None are not checked."""
    if kernel not in KERNELS:
        raise ValueError(f"unknown kernel {kernel!r}")
    why = []
    if not 1 <= head_dim <= MAX_HEAD_DIM:
        why.append(f"head_dim {head_dim} (takes 1 to {MAX_HEAD_DIM})")
    elif kernel != "flash" and head_dim % 2:
        why.append(f"odd head_dim {head_dim} (pairs dims i, i + D/2)")
    if num_heads is not None:
        if num_kv_heads < 1 or num_heads % num_kv_heads:
            why.append(f"{num_heads} query heads over {num_kv_heads} KV heads")
        elif kernel != "flash" and num_heads // num_kv_heads > MAX_GROUP:
            why.append(f"{num_heads // num_kv_heads} query heads per KV head "
                       f"(takes at most {MAX_GROUP})")
    if bits is not None and kernel != "flash" and bits not in KV_BITS:
        why.append(f"{bits}-bit KV pages (takes {KV_BITS})")
    if page_size is not None and kernel in ("decode", "prefill", "engine"):
        ok = (page_size % 4 == 0 if kernel == "prefill"
              else decode_page_size_ok(page_size))
        if page_size < 1 or not ok:
            why.append(f"page_size {page_size} (takes "
                       + ("a multiple of 4" if kernel == "prefill"
                          else "16, 32, 64 or a multiple of 128 up to "
                          f"{DECODE_MAX_PAGE}") + ")")
    return "; ".join(why) or None


def check(kernel: str, **shapes) -> None:
    """``refusal`` as a ValueError."""
    why = refusal(kernel, **shapes)
    if why is not None:
        raise ValueError(f"the card's {kernel} kernel does not take {why}")
