"""Radix prefix cache: host-side tree over page-granular token prefixes.

A copy of the JAX package's ``serve/prefix_cache.py`` (host-side numpy, no
JAX).

Maps ``tokens[:n*page_size]`` -> the pool pages that already hold those
positions' KV, so admission can alias the longest cached prefix read-only
into a new slot's page table and prefill only the uncached suffix. Nodes
are page-granular — one node per full page of tokens, keyed by that page's
token tuple — because KV pages are the unit of sharing: a partial-page
match cannot be aliased (the page would be written through by the suffix
scatter), so matches are always page-aligned by construction.

Ownership: the tree holds exactly one allocator reference per node (taken
via ``incref`` at insert, released via ``decref`` at eviction), so a cached
page survives its inserting slot's ``free`` and returns to the free list
only when no slot aliases it AND the tree has evicted it. Eviction is
LRU over leaf nodes only (evicting an interior node would dangle the
deeper cached prefixes), triggered by the ``capacity_pages`` cap at insert
time and by the engine under pool pressure (reclaim before preempting).

Insertion dedups: an existing node keeps its page (first writer wins) and
the duplicate page is simply not referenced — it returns to the pool with
its slot. All methods are host-side, O(pages touched) for match/insert and
O(nodes) for an eviction scan (fine at serve-engine scale).
"""
from __future__ import annotations

import numpy as np


class _Node:
    __slots__ = ("key", "page", "children", "parent", "stamp")

    def __init__(self, key, page, parent, stamp):
        self.key = key          # tuple of page_size tokens
        self.page = int(page)   # pool page id holding this page's KV
        self.children = {}      # token tuple -> _Node
        self.parent = parent    # _Node | None (root child)
        self.stamp = stamp      # LRU clock at last touch


class PrefixCache:
    """Page-granular radix tree with an LRU page cap (see module docstring).

    ``incref``/``decref`` are the allocator's refcount hooks; the tree never
    touches the free list directly.
    """

    def __init__(self, page_size: int, capacity_pages: int, incref, decref):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if capacity_pages < 0:
            raise ValueError(
                f"capacity_pages must be >= 0, got {capacity_pages}")
        self.page_size = int(page_size)
        self.capacity = int(capacity_pages)
        self._incref, self._decref = incref, decref
        self._children: dict = {}   # root's children
        self._clock = 0
        self._pages = 0

    def __len__(self) -> int:
        return self._pages

    @property
    def cached_pages(self) -> int:
        return self._pages

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _page_key(self, tokens, i: int) -> tuple:
        ps = self.page_size
        return tuple(int(t) for t in tokens[i * ps:(i + 1) * ps])

    # -------------------------------------------------------------- lookup

    def match(self, tokens, touch: bool = True) -> list[int]:
        """Longest cached prefix of ``tokens``: page ids backing
        ``tokens[:n*page_size]`` with ``n`` maximal. Touches the matched
        chain's LRU stamps unless ``touch=False`` (a pure probe — the
        prefix-aware admission policy scans the queue without distorting
        the LRU order it is scheduling around). The caller must pin the
        returned pages (incref or alias) before anything that can evict."""
        tokens = np.asarray(tokens)
        stamp = self._tick() if touch else None
        out: list[int] = []
        children = self._children
        for i in range(len(tokens) // self.page_size):
            node = children.get(self._page_key(tokens, i))
            if node is None:
                break
            if touch:
                node.stamp = stamp
            out.append(node.page)
            children = node.children
        return out

    def lru_pages(self, n: int) -> set[int]:
        """Page ids of the ``n`` least-recently-used LEAF nodes — the
        eviction frontier: the next ``n`` calls to ``evict(1)`` would take
        exactly these (ties broken arbitrarily). Read-only; O(nodes)."""
        leaves: list[_Node] = []
        stack = list(self._children.values())
        while stack:
            node = stack.pop()
            if node.children:
                stack.extend(node.children.values())
            else:
                leaves.append(node)
        leaves.sort(key=lambda nd: nd.stamp)
        return {leaf.page for leaf in leaves[:n]}

    # -------------------------------------------------------------- insert

    def insert(self, tokens, pages) -> int:
        """Insert the full-page prefixes of ``tokens``: ``pages[i]`` holds
        the KV for ``tokens[i*page_size:(i+1)*page_size]`` and must be live
        (refcount >= 1 — typically still held by the completing slot).
        Existing nodes keep their page (dedup); each NEW node increfs its
        page. Returns the number of new nodes; may evict LRU leaves to stay
        under the capacity cap."""
        tokens = np.asarray(tokens)
        n = min(len(tokens) // self.page_size, len(pages))
        stamp = self._tick()
        children, parent = self._children, None
        new = 0
        for i in range(n):
            key = self._page_key(tokens, i)
            node = children.get(key)
            if node is None:
                node = _Node(key, pages[i], parent, stamp)
                self._incref(node.page)
                children[key] = node
                self._pages += 1
                new += 1
            node.stamp = stamp
            parent, children = node, node.children
        if self._pages > self.capacity:
            self.evict(self._pages - self.capacity)
        return new

    # ------------------------------------------------------------ eviction

    def _lru_leaf(self) -> _Node | None:
        best = None
        stack = list(self._children.values())
        while stack:
            node = stack.pop()
            if node.children:
                stack.extend(node.children.values())
            elif best is None or node.stamp < best.stamp:
                best = node
        return best

    def evict(self, n_pages: int) -> list[int]:
        """Evict up to ``n_pages`` least-recently-used LEAF nodes, decref'ing
        each page — a page whose only reference was the tree returns to the
        free list; one still aliased by a resident stays live until that
        slot frees. Returns the evicted page ids."""
        evicted: list[int] = []
        while len(evicted) < n_pages:
            leaf = self._lru_leaf()
            if leaf is None:
                break
            siblings = (leaf.parent.children if leaf.parent is not None
                        else self._children)
            del siblings[leaf.key]
            self._pages -= 1
            self._decref(leaf.page)
            evicted.append(leaf.page)
        return evicted

    # ------------------------------------------------------------- testing

    def snapshot(self) -> dict[tuple, int]:
        """{full token prefix tuple -> page id} for every node (tests and
        debugging; O(total cached tokens))."""
        out: dict[tuple, int] = {}
        stack = [((), node) for node in self._children.values()]
        while stack:
            prefix, node = stack.pop()
            prefix = prefix + node.key
            out[prefix] = node.page
            stack.extend((prefix, c) for c in node.children.values())
        return out
