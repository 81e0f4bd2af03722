"""KV page pool and per-slot page tables (host side).

Counterpart of ``micromix_tpu/serve/block_manager.py``.  Two pools with
one surface: ``BlockManager``, pure Python (the prefix cache's base,
whose shared pages break the native pool's single-owner invariant), and
``NativeBlockManager`` over the native core, the port's own copy of
``kvpool.cpp`` (``csrc/host/kvpool.cpp``, built at first use by
``utils/native.py``, which raises if it does not build), the engine's
default as the JAX engine's.  Both: page 0 is the reserved scratch page,
freed pages are reused last-in first-out, ``ensure`` extends a slot
all-or-nothing, raising RuntimeError on pool exhaustion or the
per-sequence cap without changing any state, and a slot outside
[0, max_seqs) raises IndexError.
"""

from __future__ import annotations

import ctypes
from typing import List

import numpy as np


def _check_pool(n_pages: int, page_size: int) -> None:
    if n_pages < 2 or page_size < 1:
        raise ValueError("need at least 2 pages of size >= 1")


def _check_slot(slot: int, max_seqs: int) -> None:
    if not 0 <= slot < max_seqs:
        raise IndexError(f"slot {slot} not in [0, {max_seqs})")


class BlockManager:
    """Page allocator for ``max_seqs`` slots over ``n_pages`` pages."""

    is_native = False

    def __init__(self, n_pages: int, page_size: int, max_seqs: int,
                 max_pages_per_seq: int):
        _check_pool(n_pages, page_size)
        self.n_pages = n_pages
        self.page_size = page_size
        self.max_seqs = max_seqs
        self.max_pages_per_seq = max_pages_per_seq
        self._free: List[int] = list(range(n_pages - 1, 0, -1))
        self._pages: List[List[int]] = [[] for _ in range(max_seqs)]

    @property
    def num_free(self) -> int:
        return len(self._free)

    def num_pages(self, slot: int) -> int:
        _check_slot(slot, self.max_seqs)
        return len(self._pages[slot])

    def ensure(self, slot: int, tokens: int) -> np.ndarray:
        """Grow ``slot`` to cover ``tokens`` tokens; return its table row.
        Raises RuntimeError on exhaustion or the per-sequence cap."""
        _check_slot(slot, self.max_seqs)
        need = -(-tokens // self.page_size)
        pages = self._pages[slot]
        if need > self.max_pages_per_seq or need - len(pages) > len(self._free):
            raise RuntimeError("KV page pool exhausted")
        while len(pages) < need:
            pages.append(self._free.pop())
        return self.table_row(slot)

    def release(self, slot: int) -> None:
        _check_slot(slot, self.max_seqs)
        self._free.extend(self._pages[slot])
        self._pages[slot] = []

    def table_row(self, slot: int) -> np.ndarray:
        """(max_pages_per_seq,) int32, padded with scratch page 0."""
        _check_slot(slot, self.max_seqs)
        out = np.zeros((self.max_pages_per_seq,), np.int32)
        pages = self._pages[slot]
        out[:len(pages)] = pages
        return out


def _kvpool() -> ctypes.CDLL:
    from ..utils.native import host_library
    lib = host_library("kvpool")
    i64, vp = ctypes.c_int64, ctypes.c_void_p
    lib.kvpool_create.argtypes = [i64, i64, i64, i64]
    lib.kvpool_create.restype = vp
    lib.kvpool_destroy.argtypes = [vp]
    lib.kvpool_destroy.restype = None
    lib.kvpool_ensure.argtypes = [vp, i64, i64]
    lib.kvpool_ensure.restype = i64
    lib.kvpool_release.argtypes = [vp, i64]
    lib.kvpool_release.restype = None
    lib.kvpool_free_count.argtypes = [vp]
    lib.kvpool_free_count.restype = i64
    lib.kvpool_pages.argtypes = [vp, i64, ctypes.POINTER(ctypes.c_int32)]
    lib.kvpool_pages.restype = i64
    return lib


def native_kvpool_available() -> bool:
    """Whether the native core builds and loads here."""
    try:
        _kvpool()
    except RuntimeError:
        return False
    return True


class NativeBlockManager:
    """``BlockManager``'s surface and semantics over the native core.  The
    page counts are kept here too (only ``ensure`` and ``release`` change
    them), and the table row is read through one buffer: one native call
    an ``ensure``, ``release`` or ``table_row``."""

    is_native = True

    def __init__(self, n_pages: int, page_size: int, max_seqs: int,
                 max_pages_per_seq: int):
        _check_pool(n_pages, page_size)
        self.n_pages = n_pages
        self.page_size = page_size
        self.max_seqs = max_seqs
        self.max_pages_per_seq = max_pages_per_seq
        self._lib = _kvpool()
        self._h = self._lib.kvpool_create(n_pages, page_size, max_seqs,
                                          max_pages_per_seq)
        if not self._h:
            raise RuntimeError("kvpool_create failed")
        self._row = (ctypes.c_int32 * max_pages_per_seq)()
        self._table = np.ctypeslib.as_array(self._row)
        self._count = [0] * max_seqs

    @property
    def num_free(self) -> int:
        return int(self._lib.kvpool_free_count(self._h))

    def num_pages(self, slot: int) -> int:
        _check_slot(slot, self.max_seqs)
        return self._count[slot]

    def ensure(self, slot: int, tokens: int) -> np.ndarray:
        """Grow ``slot`` to cover ``tokens`` tokens; return its table row.
        Raises RuntimeError on exhaustion or the per-sequence cap."""
        _check_slot(slot, self.max_seqs)
        n = self._lib.kvpool_ensure(self._h, slot, tokens)
        if n < 0:
            raise RuntimeError("KV page pool exhausted")
        self._count[slot] = n
        return self.table_row(slot)

    def release(self, slot: int) -> None:
        _check_slot(slot, self.max_seqs)
        self._lib.kvpool_release(self._h, slot)
        self._count[slot] = 0

    def table_row(self, slot: int) -> np.ndarray:
        """(max_pages_per_seq,) int32, padded with scratch page 0."""
        _check_slot(slot, self.max_seqs)
        self._lib.kvpool_pages(self._h, slot, self._row)
        return self._table.copy()

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.kvpool_destroy(h)


__all__ = ["BlockManager", "NativeBlockManager", "native_kvpool_available"]
