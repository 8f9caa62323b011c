"""Paged KV-cache allocator (vLLM-style), host-side control plane.

The serving engine's dense per-slot cache is fine for a demo; at
production batch sizes the KV pool must be **paged**: fixed-size blocks,
per-sequence page tables, copy-free prefix sharing (the BASS router's
``prefix_hash`` locality is exactly a shared page run), and O(1)
alloc/free so continuous batching never compacts memory.

This module is the allocator + page-table bookkeeping (pure Python, unit
tested); ``gather_pages`` shows the device-side read: a page-table gather
that materializes a sequence's K/V view for attention.  A paged
flash-decode kernel could read the same layout block by block (block size
== page size) without materializing anything.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np


class OutOfPages(RuntimeError):
    pass


@dataclass
class SeqPages:
    seq_id: int
    pages: List[int] = field(default_factory=list)   # page ids, in order
    length: int = 0                                   # tokens written
    shared_prefix: int = 0                            # leading *shared* pages


class PagedKVCache:
    """Fixed-pool page allocator with refcounted prefix sharing.

    Pages are ``page_size`` tokens; a sequence owns a list of pages; a
    shared prefix is a run of pages with refcount > 1 (copy-on-write on
    first divergent append).
    """

    def __init__(self, n_pages: int, page_size: int):
        self.n_pages = n_pages
        self.page_size = page_size
        self._free: List[int] = list(range(n_pages))
        self._ref = np.zeros(n_pages, dtype=np.int32)
        self._seqs: Dict[int, SeqPages] = {}
        self._prefix_index: Dict[int, Tuple[int, ...]] = {}  # hash -> pages

    # -- stats ---------------------------------------------------------------
    @property
    def free_pages(self) -> int:
        return len(self._free)

    def utilization(self) -> float:
        return 1.0 - self.free_pages / self.n_pages

    # -- allocation -----------------------------------------------------------
    def _alloc_page(self) -> int:
        if not self._free:
            raise OutOfPages(f"pool exhausted ({self.n_pages} pages)")
        p = self._free.pop()
        self._ref[p] = 1
        return p

    def register_prefix(self, prefix_hash: int, seq_id: int, n_tokens: int) -> None:
        """Publish the first ``n_tokens`` of ``seq_id`` as a shareable prefix."""
        sp = self._seqs[seq_id]
        n_pages = n_tokens // self.page_size         # only whole pages share
        self._prefix_index[prefix_hash] = tuple(sp.pages[:n_pages])

    def allocate(
        self, seq_id: int, n_tokens: int, prefix_hash: Optional[int] = None
    ) -> SeqPages:
        """Reserve pages for a sequence of ``n_tokens`` prompt tokens,
        reusing a published prefix when available (zero-copy)."""
        if seq_id in self._seqs:
            raise ValueError(f"seq {seq_id} already allocated")
        sp = SeqPages(seq_id)
        shared = self._prefix_index.get(prefix_hash) if prefix_hash is not None else None
        remaining = n_tokens
        if shared:
            usable = min(len(shared), n_tokens // self.page_size)
            for p in shared[:usable]:
                self._ref[p] += 1
                sp.pages.append(p)
            sp.shared_prefix = usable
            remaining = n_tokens - usable * self.page_size
        n_new = -(-remaining // self.page_size) if remaining else 0
        try:
            for _ in range(n_new):
                sp.pages.append(self._alloc_page())
        except OutOfPages:
            self._release_pages(sp.pages[sp.shared_prefix:])
            for p in sp.pages[: sp.shared_prefix]:
                self._ref[p] -= 1
            raise
        sp.length = n_tokens
        self._seqs[seq_id] = sp
        return sp

    def append_token(self, seq_id: int) -> int:
        """Account one decoded token; may allocate (or copy-on-write) a page.

        → the page id the token lands in."""
        sp = self._seqs[seq_id]
        page_idx = sp.length // self.page_size
        if page_idx >= len(sp.pages):
            sp.pages.append(self._alloc_page())
        else:
            p = sp.pages[page_idx]
            if self._ref[p] > 1:                      # copy-on-write
                q = self._alloc_page()
                self._ref[p] -= 1
                sp.pages[page_idx] = q
        sp.length += 1
        return sp.pages[page_idx]

    def free(self, seq_id: int) -> None:
        sp = self._seqs.pop(seq_id)
        self._release_pages(sp.pages)

    def _release_pages(self, pages: List[int]) -> None:
        for p in pages:
            self._ref[p] -= 1
            if self._ref[p] <= 0:
                self._ref[p] = 0
                self._free.append(p)

    def page_table(self, seq_id: int, max_pages: int) -> np.ndarray:
        """Padded int32 page table for the device-side gather."""
        sp = self._seqs[seq_id]
        out = np.full(max_pages, -1, dtype=np.int32)
        out[: len(sp.pages)] = sp.pages
        return out


def gather_pages(pool, page_table):
    """Device-side read: pool [P, page, heads, hd] + table [n] → a
    sequence's contiguous KV view [n·page, heads, hd] (invalid pages → 0).
    ``pool`` is a torch tensor; ``page_table`` a torch or numpy int array."""
    import torch

    table = torch.as_tensor(page_table, device=pool.device)
    pages = pool[table.clamp(min=0).long()]            # [n, page, heads, hd]
    mask = (table >= 0)[:, None, None, None]
    pages = torch.where(mask, pages, torch.zeros((), dtype=pool.dtype, device=pool.device))
    n, ps = pages.shape[0], pages.shape[1]
    return pages.reshape(n * ps, *pages.shape[2:])
