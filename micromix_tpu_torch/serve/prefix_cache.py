"""Automatic prefix caching: shared KV pages for common prompt prefixes.

Counterpart of ``micromix_tpu/serve/prefix_cache.py``, host code over
numpy.  A cached page's identity is its chain key ``(parent page id,
the page's token bytes)``: the parent's physical id pins the whole
prefix, so no hashing is needed and keys cannot collide while the parent
stays registered (the first writer wins; a duplicate concurrent prefill
keeps the holder's page).  Reference counts track how many slot rows
hold a page; a registered page nobody holds is evictable, stays
matchable, and is reclaimed least recently released first when the pool
runs short.  Evicting a page unregisters its children too: the ones a
slot still holds stay valid but stop being matchable, and return to the
free list on release.

A hit attends to the QUANTIZED cached prefix, as every chunk of a
chunked prefill and every decode step does, where a cold single-shot
prefill attends to its own chunk's exact bf16 K/V; the engine keeps the
feature opt-in (``Engine(prefix_cache=True)``, ``serve --prefix-cache``).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Sequence, Set, Tuple

import numpy as np

from .block_manager import BlockManager

Key = Tuple[int, bytes]


class PrefixBlockManager(BlockManager):
    """``BlockManager`` with content-addressed page sharing and LRU
    eviction."""

    def __init__(self, n_pages: int, page_size: int, max_seqs: int,
                 max_pages_per_seq: int):
        super().__init__(n_pages, page_size, max_seqs, max_pages_per_seq)
        self._map: Dict[Key, int] = {}
        self._meta: Dict[int, Key] = {}           # page -> its map key
        self._children: Dict[int, Set[int]] = {}  # page -> child pages
        self._ref: Dict[int, int] = {}            # page -> slot rows holding it
        self._evictable: "OrderedDict[int, None]" = OrderedDict()

    def _chunk_key(self, parent: int, tokens: Sequence[int], i: int) -> Key:
        chunk = tokens[i * self.page_size:(i + 1) * self.page_size]
        return (parent, np.asarray(chunk, np.int32).tobytes())

    def _unregister(self, page: int) -> None:
        """Drop ``page`` from the match map and orphan its children."""
        key = self._meta.pop(page, None)
        if key is not None and self._map.get(key) == page:
            del self._map[key]
        for child in self._children.pop(page, set()):
            if child in self._meta:
                self._unregister(child)
                # an orphan nobody holds is free at once
                if child in self._evictable:
                    del self._evictable[child]
                    self._free.append(child)

    def _reclaim(self, n: int) -> bool:
        """Evict cached pages, least recently released first, until ``n``
        pages are free."""
        while len(self._free) < n and self._evictable:
            page, _ = self._evictable.popitem(last=False)
            self._unregister(page)
            self._free.append(page)
        return len(self._free) >= n

    @property
    def num_free(self) -> int:
        # evictable pages are reclaimable on demand
        return len(self._free) + len(self._evictable)

    def ensure(self, slot: int, tokens: int) -> np.ndarray:
        need = -(-tokens // self.page_size)
        pages = self._pages[slot]
        grow = need - len(pages)
        if need > self.max_pages_per_seq or \
                (grow > 0 and not self._reclaim(grow)):
            raise RuntimeError("KV page pool exhausted")
        while len(pages) < need:
            p = self._free.pop()
            self._ref[p] = self._ref.get(p, 0) + 1
            pages.append(p)
        return self.table_row(slot)

    def release(self, slot: int) -> None:
        for p in self._pages[slot]:
            self._ref[p] = self._ref.get(p, 1) - 1
            if self._ref[p] > 0:
                continue
            del self._ref[p]
            if p in self._meta:
                self._evictable[p] = None   # matchable until pressure
            else:
                self._free.append(p)
        self._pages[slot] = []

    def match_and_attach(self, slot: int, tokens: Sequence[int]) -> int:
        """Attach the longest cached page chain that matches ``tokens`` to
        ``slot`` (which holds no page yet) -> the tokens covered, a whole
        number of pages; the last context token always stays unmatched, so
        a prefill still gives the next token's logits."""
        if self._pages[slot]:
            raise ValueError(f"slot {slot} already holds pages")
        limit = min((len(tokens) - 1) // self.page_size,
                    self.max_pages_per_seq)
        chain: List[int] = []
        parent = -1
        for i in range(limit):
            page = self._map.get(self._chunk_key(parent, tokens, i))
            if page is None:
                break
            chain.append(page)
            parent = page
        for p in chain:
            self._ref[p] = self._ref.get(p, 0) + 1
            self._evictable.pop(p, None)
        self._pages[slot] = chain
        return len(chain) * self.page_size

    def register_prefix(self, slot: int, tokens: Sequence[int],
                        covered: int) -> None:
        """Make the slot's full pages over ``tokens[:covered]`` matchable.
        Idempotent; a page whose chain key another page already holds (a
        duplicate concurrent prefill) stays unregistered and returns to
        the free list on release."""
        pages = self._pages[slot]
        full = min(covered // self.page_size, len(pages))
        parent = -1
        for i in range(full):
            page = pages[i]
            if page in self._meta:          # already registered
                parent = page
                continue
            key = self._chunk_key(parent, tokens, i)
            holder = self._map.get(key)
            if holder is not None:          # the same content: keep the holder
                parent = holder
                continue
            self._map[key] = page
            self._meta[page] = key
            if parent >= 0:
                self._children.setdefault(parent, set()).add(page)
            parent = page
