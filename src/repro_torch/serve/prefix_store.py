"""``PrefixStore`` — server-level persistence for the radix prefix cache
(port of the JAX package's ``serve/prefix_store.py`` over torch tensors).

A ``ServeEngine`` owns its KV page pool, page allocator, and radix tree;
without a store they die with the engine, so repeated engine instances
over the SAME params (eval sweeps building one engine per call, a
relaunched server, per-wave engines in a benchmark) re-prefill prefixes
they already computed. The store keeps ``{k/v pools, PageAllocator,
PrefixCache}`` alive between engines: ``ServeEngine.close()`` hands its
live tree pages over (the tree's one-ref-per-node refcount contract moves
wholesale — no page is freed or copied), and the next engine constructed
with the same store, params, and pool geometry adopts them instead of
initializing cold, so its first admissions alias warm pages
(``stats["prefix_hits"] > 0`` from request one).

Keying: entries are keyed by the model config, a cheap content
fingerprint of the params (tree structure + leaf shapes/dtypes + CRC32 of
64-value samples of the two leading leaves), the pool geometry
(``page_size``/``num_pages`` — pools of a different shape cannot be
adopted) and the params' device (pools live beside them). Each entry
additionally holds a weakref to one of the original params' tensors:
cached KV is only valid for the exact tensors it was computed from, and
the fingerprint samples rather than hashes every byte, so if the original
params have been freed the entry is dropped instead of trusting a partial
digest. The fingerprint copies its samples to the host (a sync), which
the engine does at construction and at ``close()`` only. ``take`` pops
(single ownership — two live engines over the same params never share one
mutable allocator); ``put`` overwrites (last close wins).
"""
from __future__ import annotations

import weakref
import zlib

import torch


def _flatten(tree, path=()):
    """(structure string, leaves) of a nested dict of tensors, keys in
    sorted order."""
    if isinstance(tree, dict):
        parts, leaves = [], []
        for k in sorted(tree):
            s, ls = _flatten(tree[k], path + (k,))
            parts.append(f"{k}:{s}")
            leaves += ls
        return "{" + ",".join(parts) + "}", leaves
    return "*", [tree]


def params_fingerprint(params) -> int:
    """Cheap content fingerprint of a params tree: CRC32 over the tree
    structure, every leaf's shape/dtype, and a 64-value sample of the two
    leading leaves (enough to tell checkpoints apart without hashing
    gigabytes; the store's weakref covers in-place reuse of the tensors)."""
    structure, leaves = _flatten(params)
    h = zlib.crc32(structure.encode())
    for leaf in leaves:
        h = zlib.crc32(
            f"{tuple(getattr(leaf, 'shape', ()))}:{getattr(leaf, 'dtype', '')}"
            .encode(), h)
    for leaf in leaves[:2]:
        sample = leaf.reshape(-1)[:64]
        if isinstance(sample, torch.Tensor):
            sample = (sample.detach().to("cpu").contiguous()
                      .view(torch.uint8).numpy())
        h = zlib.crc32(sample.tobytes(), h)
    return h


def _device_of(params) -> str:
    for leaf in _flatten(params)[1]:
        if isinstance(leaf, torch.Tensor):
            return str(leaf.device)
    return ""


def _anchor(params):
    """A weakref to a leaf of ``params`` (None if none supports weakrefs —
    the store then keys on the fingerprint alone)."""
    for leaf in _flatten(params)[1]:
        try:
            return weakref.ref(leaf)
        except TypeError:
            continue
    return None


class PrefixStore:
    """Cross-engine radix-tree store (see module docstring). One instance
    per server process (or per eval sweep); share it by passing the same
    object as ``ServeConfig.prefix_store`` to every engine."""

    def __init__(self):
        self._entries: dict[tuple, tuple] = {}
        self.stats = {"puts": 0, "adoptions": 0, "misses": 0, "expired": 0}

    def __len__(self) -> int:
        return len(self._entries)

    @staticmethod
    def key_for(cfg, params, *, page_size: int, num_pages: int) -> tuple:
        return (cfg, params_fingerprint(params), int(page_size),
                int(num_pages), _device_of(params))

    def put(self, key: tuple, params, state: dict) -> None:
        """Deposit an engine's live prefix state: ``state`` carries the
        ``k``/``v`` device pools, the ``PageAllocator`` (all slot rows
        free — only tree references remain), and the ``PrefixCache``."""
        self._entries[key] = (_anchor(params), state)
        self.stats["puts"] += 1

    def take(self, key: tuple) -> dict | None:
        """Pop the entry for ``key`` (single ownership). Returns None on a
        miss or when the original params have been garbage-collected (the
        cached KV can no longer be tied to live tensors)."""
        item = self._entries.pop(key, None)
        if item is None:
            self.stats["misses"] += 1
            return None
        anchor, state = item
        if anchor is not None and anchor() is None:
            self.stats["expired"] += 1
            return None
        self.stats["adoptions"] += 1
        return state

    def cached_pages(self) -> int:
        """Total radix-tree pages currently parked in the store."""
        return sum(len(state["tree"]) for _, state in self._entries.values())
