"""Shared KV page pool: host-side page-table allocator for the serve engine.

A copy of the JAX package's ``serve/pages.py`` (host-side numpy, no JAX).

The paged KV layout replaces each slot's dense ``max_len`` cache row with a
pool of fixed-size pages (``[num_pages, page_size, heads, dim]`` K/V arrays
per layer, see ``models/lm.init_paged_cache``) plus a per-slot page table
mapping virtual position ``s`` to pool page ``table[slot, s // page_size]``.
Serve cache memory then scales with *live tokens* (pages actually backing
admitted requests) instead of ``num_slots * max_len``.

This module is the host side: ``PageAllocator`` owns the free list and the
``[num_slots, pages_per_slot]`` table (numpy; mirrored to the device cache
by the engine after every allocate/free). Unallocated table entries hold the
``num_pages`` sentinel — device code drops writes through them (OOB scatter)
and clamps reads (the gathered rows are masked by ``valid_len`` anyway), so
a freed slot that keeps decoding (finished slots ride along in the decode
chunk) can never corrupt a page that was handed to a new request.

Pages are REFCOUNTED so the radix prefix cache (serve/prefix_cache.py) can
alias one filled page into many slots: ``allocate``/``alias`` set fresh
pages to refcount 1, ``alias``/``incref`` bump shared ones, and ``free``/
``decref`` release — a page returns to the free list only when its refcount
reaches 0. Aliased pages are read-only by contract: the engine never
scatters through a table entry below a slot's private ``start`` offset
(lm.insert_slots_paged ``starts=``), and the first partially-filled page is
copied-on-write before any suffix write.

Exhaustion is not an error at admission time: the engine admits as many
requests as the pool can back and leaves the rest queued (admission
backpressure) — pages free as residents finish. A single request that could
never fit (needs more pages than the whole pool) raises ``PoolExhausted``
with the sizing math spelled out. Double frees are hard errors: freeing a
slot that holds no pages or decref'ing a page below zero would silently
corrupt the free list (the same page handed out twice), so both raise with
the offending slot/page id.
"""
from __future__ import annotations

import numpy as np


def pages_for(tokens: int, page_size: int) -> int:
    """Number of pages backing ``tokens`` cache positions."""
    return -(-int(tokens) // int(page_size))


def default_num_pages(num_slots: int, max_len: int, page_size: int) -> int:
    """Full-capacity pool: every slot can hold ``max_len`` tokens (the dense
    footprint). Real deployments size below this and lean on backpressure."""
    return num_slots * pages_for(max_len, page_size)


class PoolExhausted(RuntimeError):
    """A single request can never fit in the pool (vs transient pressure,
    which the engine handles by queueing)."""


class PageAllocator:
    """Free-list allocator over ``num_pages`` refcounted pages with per-slot
    tables.

    ``table``: [num_slots, pages_per_slot] i32, entry == ``num_pages`` means
    unallocated (the device-side OOB sentinel). ``refcount``: [num_pages]
    i32, 0 for pages on the free list. All methods are host-side and
    O(pages touched); the engine mirrors ``table`` into the device cache
    after every change.
    """

    def __init__(self, num_pages: int, num_slots: int, pages_per_slot: int):
        if num_pages < 1:
            raise ValueError(f"num_pages must be >= 1, got {num_pages}")
        self.num_pages = int(num_pages)
        self.num_slots = int(num_slots)
        self.pages_per_slot = int(pages_per_slot)
        self.table = np.full((num_slots, pages_per_slot), num_pages,
                             np.int32)
        self._free = list(range(num_pages - 1, -1, -1))  # pop() -> page 0 first
        self._used = np.zeros((num_slots,), np.int32)
        self.refcount = np.zeros((num_pages,), np.int32)
        self.peak_live = 0

    # ------------------------------------------------------------- queries

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def live_pages(self) -> int:
        return self.num_pages - len(self._free)

    def utilization(self) -> float:
        return self.live_pages / self.num_pages

    def can_allocate(self, n_pages: int) -> bool:
        return n_pages <= len(self._free)

    # ----------------------------------------------------------- lifecycle

    def _check_fit(self, slot: int, total: int, n_fresh: int) -> None:
        if self._used[slot]:
            raise RuntimeError(f"slot {slot} already holds "
                               f"{self._used[slot]} pages (free it first)")
        if total > self.pages_per_slot:
            raise PoolExhausted(
                f"request needs {total} pages but a slot maps at most "
                f"{self.pages_per_slot} (pages_per_slot = ceil(max_len / "
                f"page_size)); shrink the request or raise max_len")
        if total > self.num_pages:
            raise PoolExhausted(
                f"request needs {total} pages but the whole pool has "
                f"{self.num_pages}; grow num_pages (or page_size) — "
                f"backpressure cannot help, no amount of waiting frees "
                f"enough")
        if n_fresh > len(self._free):
            raise RuntimeError(
                f"pool pressure: need {n_fresh} fresh pages, "
                f"{len(self._free)} free — the engine should have deferred "
                f"this admission (can_allocate was false)")

    def allocate(self, slot: int, n_pages: int) -> None:
        """Back ``slot`` with ``n_pages`` fresh pages (refcount 1 each). The
        caller checks ``can_allocate`` first (transient pressure =
        backpressure, not an error); an impossible request raises
        ``PoolExhausted``."""
        self.alias(slot, (), n_pages)

    def alias(self, slot: int, shared_pages, n_fresh: int) -> None:
        """Back ``slot`` with ``shared_pages`` (already-filled prefix pages,
        incref'd — read-only by contract) followed by ``n_fresh`` fresh
        pages. The prefix cache's longest-match pages land at the head of
        the table row, so virtual positions [0, len(shared)*page_size) read
        the cached KV without a copy."""
        shared = [int(p) for p in shared_pages]
        self._check_fit(slot, len(shared) + n_fresh, n_fresh)
        for i, p in enumerate(shared):
            self.incref(p)
            self.table[slot, i] = p
        for i in range(n_fresh):
            self.table[slot, len(shared) + i] = self._free.pop()
        fresh = self.table[slot, len(shared):len(shared) + n_fresh]
        self.refcount[fresh] = 1
        self._used[slot] = len(shared) + n_fresh
        self.peak_live = max(self.peak_live, self.live_pages)

    def incref(self, page: int) -> None:
        """Add a reference to a live page (an aliasing slot or the prefix
        tree). Incref'ing a free page would resurrect a page the allocator
        may hand out again — raise instead."""
        page = int(page)
        if self.refcount[page] < 1:
            raise RuntimeError(
                f"page {page}: incref on a free page (refcount 0) — it may "
                f"already back another slot; alias only live pages")
        self.refcount[page] += 1

    def decref(self, page: int) -> None:
        """Drop a reference; the page returns to the free list only at
        refcount 0. Decref below zero means a double free — raise with the
        page id instead of silently corrupting the free list."""
        page = int(page)
        if self.refcount[page] < 1:
            raise RuntimeError(
                f"page {page}: decref below zero (double free) — the page "
                f"is already on the free list")
        self.refcount[page] -= 1
        if self.refcount[page] == 0:
            self._free.append(page)

    def free(self, slot: int) -> None:
        """Decref ``slot``'s pages (shared prefix pages stay live for their
        other holders) and sentinel its table row (freed-slot decode writes
        must drop, see module docstring). Freeing a slot that holds no
        pages is a double free — raise with the slot id."""
        n = int(self._used[slot])
        if n == 0:
            raise RuntimeError(
                f"slot {slot}: double free (slot holds no pages)")
        for i in range(n):
            self.decref(int(self.table[slot, i]))
        self.table[slot, :] = self.num_pages
        self._used[slot] = 0

    def resize_slots(self, num_slots: int,
                     pages_per_slot: int) -> "PageAllocator":
        """Rebuild the slot tables for a new engine geometry, preserving
        page refcounts and the free list. Used when a ``PrefixStore``
        hands this allocator to a new engine: the radix tree's references
        (pages with no slot holder) carry over untouched, while the slot
        side — necessarily empty at handoff — is rebuilt at the adopting
        engine's ``num_slots``/``pages_per_slot``. Refuses to resize while
        any slot still holds pages."""
        if self._used.any():
            held = [int(s) for s in np.nonzero(self._used)[0]]
            raise RuntimeError(
                f"resize_slots with live slots {held}: free every slot "
                f"before handing the allocator to a new engine")
        self.num_slots = int(num_slots)
        self.pages_per_slot = int(pages_per_slot)
        self.table = np.full((self.num_slots, self.pages_per_slot),
                             self.num_pages, np.int32)
        self._used = np.zeros((self.num_slots,), np.int32)
        return self

    def stats(self) -> dict:
        return {"num_pages": self.num_pages,
                "live_pages": self.live_pages,
                "free_pages": self.free_pages,
                "peak_live_pages": self.peak_live,
                "high_water_pages": self.peak_live,
                "utilization": self.utilization()}
