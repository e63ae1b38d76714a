"""BlockPartition: the paper's "block" taxonomy over the parameter tree
(port of the dense-family part of the JAX package's ``core/partition.py``).

A block is (paper §3.1) one transformer block, the embedding table, the
final norm, or the untied LM head. The stacked ``layers`` group (leading
axis = #layers) maps to consecutive block ids, so a selection is a runtime
mask vector and a block's rows are rows of the stacked leaves.

Leaves are visited in sorted key order, as ``jax.tree.leaves`` visits a
dict, so sums over leaves add in the reference's order.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops


@dataclass(frozen=True)
class Group:
    key: str        # top-level key in the params dict
    start: int      # first block id
    length: int     # number of blocks in the group
    stacked: bool   # True -> every leaf has leading axis == length


@dataclass(frozen=True)
class BlockPartition:
    groups: tuple[Group, ...]
    num_blocks: int

    def group(self, key: str) -> Group:
        for g in self.groups:
            if g.key == key:
                return g
        raise KeyError(key)

    @property
    def block_names(self) -> list[str]:
        names = []
        for g in self.groups:
            if g.length == 1:
                names.append(g.key)
            else:
                names.extend(f"{g.key}[{i}]" for i in range(g.length))
        return names


def leaves(tree) -> list[torch.Tensor]:
    """The tensors of a nested dict, in sorted key order (jax.tree.leaves)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in leaves(tree[k])]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of one or more nested dicts of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def _group_order(cfg: ModelConfig) -> list[tuple[str, int, bool]]:
    """(key, length, stacked) in canonical block order, dense family."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family={cfg.family!r} is not ported yet (ROADMAP Queue A, "
            f"'Other families')")
    out = [("embed", 1, False), ("layers", cfg.num_layers, True),
           ("final_norm", 1, False)]
    if not cfg.tie_embeddings:
        out.append(("lm_head", 1, False))
    return out


def build_partition(cfg: ModelConfig) -> BlockPartition:
    groups, start = [], 0
    for key, length, stacked in _group_order(cfg):
        groups.append(Group(key, start, length, stacked))
        start += length
    return BlockPartition(tuple(groups), start)


# ------------------------------------------------------------------ norms


def block_grad_norms(partition: BlockPartition,
                     grads: dict) -> torch.Tensor:
    """Per-block gradient L2 norm (paper Alg. 1 lines 1-6): sum of squares
    over every leaf of each block, sqrt at the end. Stacked leaves of ndim
    >= 2 go through ``ops.block_grad_sq_norms`` (the kernel on the card);
    the unstacked groups are one sum each. Returns [num_blocks] f32."""
    parts = []
    for g in partition.groups:
        sub = leaves(grads[g.key])
        if g.stacked:
            acc = None
            for leaf in sub:
                if leaf.ndim >= 2:
                    s = ops.block_grad_sq_norms(leaf)
                else:
                    s = leaf.float() * leaf.float()
                acc = s if acc is None else acc + s
            parts.append(acc)
        else:
            s = None
            for x in sub:
                t = x.float().square().sum()
                s = t if s is None else s + t
            parts.append(s.reshape(1))
    return torch.sqrt(torch.cat(parts))


# ------------------------------------------------------------------ masks


def leaf_masks(partition: BlockPartition, params: dict,
               mask: torch.Tensor) -> dict:
    """Per-leaf selection masks matching the params structure: a [L] vector
    for each stacked leaf (one entry per row), a 0-d tensor for the others.
    ``mask``: [num_blocks] (bool or 0/1)."""
    m = mask.float()
    out = {}
    for g in partition.groups:
        seg = (m[g.start:g.start + g.length] if g.stacked
               else m[g.start])
        out[g.key] = tree_map(lambda _, s=seg: s, params[g.key])
    return out


def layer_masks_dict(partition: BlockPartition, mask: torch.Tensor) -> dict:
    """Per-group mask vectors of the body groups, for the model's
    gate_weight_grads hook: {"layers": [L]}."""
    return {g.key: mask[g.start:g.start + g.length].float()
            for g in partition.groups
            if g.key not in ("embed", "final_norm", "lm_head")}


# ------------------------------------------------------------------ slots
#
# A stacked group's banked moments live in a [cap, ...] bank whose row s
# holds the moments of local block ``slots[s]`` (``slots[s] == length``:
# a free slot).


def scatter_rows(leaf: torch.Tensor, slots: torch.Tensor,
                 rows: torch.Tensor) -> torch.Tensor:
    """Write ``rows`` [n, ...] into the stacked leaf [L, ...] at ``slots``
    [n], in place; out-of-range entries are dropped, so free-slot sentinels
    never land. Returns ``leaf``."""
    idx = slots.long()
    valid = idx < leaf.shape[0]
    leaf[idx[valid]] = rows[valid].to(leaf.dtype)
    return leaf


def params_per_block(partition: BlockPartition, params: dict) -> np.ndarray:
    """Static count of parameters per block (for the §3.3 memory model)."""
    counts = np.zeros((partition.num_blocks,), np.int64)
    for g in partition.groups:
        for leaf in leaves(params[g.key]):
            shape = leaf.shape
            if g.stacked:
                counts[g.start:g.start + g.length] += int(np.prod(shape[1:]))
            else:
                counts[g.start] += int(np.prod(shape))
    return counts
