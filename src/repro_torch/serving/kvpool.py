"""Paged KV-cache pool for the port: fixed-size pages, block tables.

Counterpart of ``repro.serving.kvpool`` (see its docstring for the design):
one device pool of ``num_pages`` pages per layer reusing the model's cache
pytree (batch axis = pages, capacity = page size), a host-side allocator,
and per-request block tables. Page 0 is the trash page: block-table padding
for unused entries and empty slots points at it, so writes from masked-out
lanes land somewhere harmless. ``PagePool`` is a verbatim copy.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from repro_torch.configs import base as cfgbase
from repro_torch.models import transformer as tfm

TRASH_PAGE = 0


class PagePool:
    """Host-side page allocator over the device pool's first axis.

    All-or-nothing allocation; freeing is idempotent-unsafe by design (a page
    must be owned by exactly one of: free list, radix tree, a live request).
    """

    def __init__(self, num_pages: int, *, reserved: int = 1):
        if num_pages <= reserved:
            raise ValueError(f"num_pages={num_pages} <= reserved={reserved}")
        self.num_pages = num_pages
        self.reserved = reserved
        # LIFO free list, low pages first out (stable for tests); the
        # companion set makes the double-free check O(1)
        self._free: List[int] = list(range(num_pages - 1, reserved - 1, -1))
        self._free_set = set(self._free)
        self.peak_in_use = 0
        self.injector = None        # chaos hook (serving/faults.FaultInjector)

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_in_use(self) -> int:
        return self.num_pages - self.reserved - len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """n pages or None (never a partial allocation)."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > 0 and self.injector is not None and self.injector.take("pool.alloc"):
            return None             # injected exhaustion: the caller's normal
                                    # evict-then-retry / backoff path handles it
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        self._free_set.difference_update(pages)
        self.peak_in_use = max(self.peak_in_use, self.num_in_use)
        return pages

    def free(self, pages: List[int]):
        if len(set(pages)) != len(pages):
            raise ValueError(f"duplicate pages in free: {pages}")
        for p in pages:
            if not (self.reserved <= p < self.num_pages):
                raise ValueError(f"free of invalid page {p}")
            if p in self._free_set:
                raise ValueError(f"double free of page {p}")
        self._free.extend(pages)
        self._free_set.update(pages)


def init_paged_cache(cfg, num_pages: int, page_size: int, device):
    """The paged pool: the model's cache pytree with the batch axis
    re-purposed as the page axis and capacity as the page size."""
    return tfm.init_cache(cfg, num_pages, page_size, device)


def supports_paged(cfg) -> tuple:
    """(ok, reason): paged mode needs every layer to be full (non-windowed)
    attention — KV of a position then depends only on the token prefix, so
    pages are shareable across requests."""
    bad = [k for k in cfg.layer_kinds if k not in (cfgbase.ATTN, cfgbase.ATTN_MOE)]
    if bad:
        return False, f"non-attention layers {sorted(set(bad))} keep per-slot state"
    if cfg.sliding_window is not None:
        return False, "sliding-window attention: ring cache is not page-shareable"
    return True, ""


def block_table_array(rows: List[List[int]], width: int, device):
    """Pad per-slot page lists to a rectangular [B, width] int32 device
    tensor (unused entries point at the trash page)."""
    padded = [list(r[:width]) + [TRASH_PAGE] * (width - len(r)) for r in rows]
    return torch.tensor(padded, dtype=torch.int32, device=device)
