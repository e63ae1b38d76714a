"""Block-masked AdamW — the paper's "custom AdamW" (Alg. 1 lines 9-13);
port of the JAX package's ``core/masked_adamw.py``, dense and banked
residency.

Selected blocks take a standard AdamW step (moments + weight decay);
unselected blocks keep parameters AND moments bit-identical. Bias
correction uses per-block step counts. Moments are in
``OptimizerConfig.moment_dtype`` (f32, or bf16 to halve their bytes)
whatever the parameter dtype; the arithmetic is f32 either way, and bf16
moments are rounded (to nearest even) only when stored, as the reference's
XLA path does.

The update is IN PLACE on the parameters and moments (the reference returns
new arrays): the stacked leaves go through ``ops.masked_adamw`` (the kernel
on the card), the unstacked ones (embedding, final norm, untied head)
through ``_adamw_rows`` in plain torch, as the reference computes them in
XLA outside its kernel.

Banked residency (paper §3.3, the second half of this module): the card
holds the moments of the selected blocks only, in compact [cap]-slot banks
over a full store (``core/offload.py``). A selection-change boundary moves
evicted blocks' bank rows to the store and admitted blocks' store rows into
free bank slots; ``banked_update`` then steps the bank rows in place, the
stacked leaves through ``ops.banked_masked_adamw``. Given the same (grads,
mask, lr) sequence it gives the dense ``update``'s bits, so the dense layout
stays the oracle. The boundary's copies run on the current CUDA stream,
asynchronous where the store is pinned: ``core/swap.py`` moves them to a
copy stream and orders them with events.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import OptimizerConfig
from repro_torch.core import offload
from repro_torch.core.partition import (BlockPartition, leaf_masks, leaves,
                                        scatter_rows, tree_map)
from repro_torch.kernels import ops


def init_opt_state(partition: BlockPartition, params: dict,
                   moment_dtype: torch.dtype = torch.float32) -> dict:
    """Zero moments in ``moment_dtype`` congruent with ``params`` and zero
    f32 per-block counts, on the device of the parameters."""
    dev = leaves(params)[0].device

    def zeros(x):
        return torch.zeros(x.shape, dtype=moment_dtype, device=dev)
    return {
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "counts": torch.zeros(partition.num_blocks, device=dev),
    }


def global_grad_norm(grads) -> torch.Tensor:
    sq = None
    for g in leaves(grads):
        t = g.float().square().sum()
        sq = t if sq is None else sq + t
    return torch.sqrt(sq)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled by min(1, max_norm / (norm + 1e-9)) in f32 and cast
    back, the global norm)."""
    norm = global_grad_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


def _adamw_rows(cfg: OptimizerConfig, p, g, m, v, sel, cnt, lr):
    """The masked-AdamW formula on one unstacked leaf, in plain torch (0-d
    ``sel`` and ``cnt``); writes p, m and v in place (``copy_`` rounds the
    f32 m and v to the moment dtype)."""
    gf = g.float()
    mf, vf = m.float(), v.float()
    m2 = torch.where(sel > 0, cfg.b1 * mf + (1 - cfg.b1) * gf, mf)
    v2 = torch.where(sel > 0, cfg.b2 * vf + (1 - cfg.b2) * gf * gf, vf)
    c = torch.clamp(cnt, min=1.0)
    mhat = m2 / (1 - cfg.b1 ** c)
    vhat = v2 / (1 - cfg.b2 ** c)
    pf = p.float()
    step = lr * (mhat / (torch.sqrt(vhat) + cfg.eps)
                 + cfg.weight_decay * pf)
    p.copy_(torch.where(sel > 0, pf - step, pf))
    m.copy_(m2)
    v.copy_(v2)


@torch.no_grad()
def update(cfg: OptimizerConfig, partition: BlockPartition, params: dict,
           grads: dict, opt_state: dict, mask: torch.Tensor, lr: float):
    """One masked step, in place. mask: [num_blocks]; lr: the scheduled
    rate (a Python float). Returns (params, opt_state), the same tensors."""
    counts = opt_state["counts"]
    counts += mask.float()
    masks = leaf_masks(partition, params, mask)
    counts_b = leaf_masks(partition, params, counts)

    def upd(p, g, m, v, sel, cnt):
        if sel.ndim == 1:   # a stacked leaf: one mask entry per row
            ops.masked_adamw(p, g, m, v, sel, cnt, lr, cfg.b1, cfg.b2,
                             cfg.eps, cfg.weight_decay)
        else:
            _adamw_rows(cfg, p, g, m, v, sel, cnt, lr)
        return p

    tree_map(upd, params, grads, opt_state["m"], opt_state["v"], masks,
             counts_b)
    return params, opt_state


# ---------------------------------------------------- banked residency (§3.3)


def bank_capacity(group, k_slots: int) -> int:
    """Bank slots a stacked group needs: selection places at most
    ``k_slots`` blocks anywhere, and at most ``group.length`` of them
    here."""
    return max(1, min(group.length, k_slots))


def init_banked_opt_state(partition: BlockPartition, params: dict,
                          k_slots: int, store_policy: str = "host",
                          moment_dtype: torch.dtype = torch.float32) -> dict:
    """Compact banked optimizer state, on the device of ``params``:

      banks[key] — per group: ``m``/``v`` trees with leading axis ``cap =
                   bank_capacity`` (stacked groups) or the full leaf shape
                   (unstacked, cap 1), and ``slots`` [cap] int32, the local
                   block each slot holds (``group.length`` = free).
      slot_map   — [num_blocks] int32 numpy, block id -> slot in its
                   group's bank (-1 = in the store only). It lives on the
                   host and drives the boundary.
      counts     — per-block bias-correction step counts, as in the dense
                   layout.
      store      — the full store (``offload.init_full_store``).

    Banks and store hold ``moment_dtype``.

    Nothing is resident at first; the first boundary admits the first
    selection's zero rows from the store."""
    dev = leaves(params)[0].device
    banks = {}
    for g in partition.groups:
        cap = bank_capacity(g, k_slots) if g.stacked else 1

        def zeros(x, cap=cap, stacked=g.stacked):
            shape = (cap,) + tuple(x.shape[1:]) if stacked else x.shape
            return torch.zeros(shape, dtype=moment_dtype, device=dev)
        banks[g.key] = {
            "m": tree_map(zeros, params[g.key]),
            "v": tree_map(zeros, params[g.key]),
            "slots": torch.full((cap,), g.length, dtype=torch.int32,
                                device=dev),
        }
    return {
        "banks": banks,
        "slot_map": np.full((partition.num_blocks,), -1, np.int32),
        "counts": torch.zeros(partition.num_blocks, device=dev),
        "store": offload.init_full_store(partition, params, store_policy,
                                         moment_dtype),
    }


@dataclasses.dataclass(frozen=True)
class GroupSwapPlan:
    """One group's slice of a selection-change boundary: which local blocks
    leave the bank (``ev_*``) and which enter (``ad_*``), with the slot each
    leaves or receives. Pure data from (slot_map, mask) alone, so a plan
    made for a predicted mask says nothing about bank or store contents."""
    key: str
    start: int
    length: int
    stacked: bool
    ev_blocks: np.ndarray  # local block ids leaving the bank
    ev_slots: np.ndarray   # the bank rows they occupied
    ad_blocks: np.ndarray  # local block ids entering the bank
    ad_slots: np.ndarray   # the (free) bank rows they receive


def plan_swap(partition: BlockPartition, slot_map, mask,
              caps: dict) -> list[GroupSwapPlan]:
    """Evict/admit plan for one boundary. ``mask``: host bool [num_blocks];
    ``caps``: per-group bank capacity. Groups whose residency already
    matches the mask are left out (an unchanged selection plans to an empty
    list). Raises on a group's bank overflow."""
    mask = np.asarray(mask).astype(bool)
    slot_map = np.asarray(slot_map, np.int32)
    plans = []
    for g in partition.groups:
        lo = slice(g.start, g.start + g.length)
        gmask, gslots = mask[lo], slot_map[lo]
        resident = gslots >= 0
        ev_blocks = np.nonzero(resident & ~gmask)[0]
        ad_blocks = np.nonzero(gmask & ~resident)[0]
        if not len(ev_blocks) and not len(ad_blocks):
            continue
        cap = caps[g.key]
        occupied = np.zeros((cap,), bool)
        occupied[gslots[np.nonzero(resident & gmask)[0]]] = True
        free = np.nonzero(~occupied)[0]
        if len(ad_blocks) > len(free):
            raise RuntimeError(
                f"bank overflow in group {g.key!r}: {len(ad_blocks)} "
                f"admissions for {len(free)} free slots (capacity {cap}); "
                f"the selection selected more blocks than the configured "
                f"slot capacity")
        plans.append(GroupSwapPlan(
            key=g.key, start=g.start, length=g.length, stacked=g.stacked,
            ev_blocks=ev_blocks, ev_slots=gslots[ev_blocks],
            ad_blocks=ad_blocks, ad_slots=free[:len(ad_blocks)]))
    return plans


def bank_caps(banks: dict) -> dict:
    """{group key: bank slot capacity} for ``plan_swap``."""
    return {k: int(b["slots"].shape[0]) for k, b in banks.items()}


def _moment_leaves(group_tree: dict) -> list:
    """A group's bank or store leaves, m leaves then v leaves."""
    return leaves(group_tree["m"]) + leaves(group_tree["v"])


def _moment_pairs(banks: dict, store: dict, key: str):
    """(bank leaf, store leaf) pairs of one group."""
    return list(zip(_moment_leaves(banks[key]), _moment_leaves(store[key])))


def prefetch_admissions(plans: list, banks: dict, store: dict) -> dict:
    """Copy admitted blocks' store rows towards the banks, on the current
    stream. A stacked group's rows go into new staging tensors on the
    banks' device, ``{key: [rows per (bank, store) pair]}``, which
    ``commit_swap`` writes into the bank slots. An unstacked group's single
    block goes straight into its bank: its bank is free while the block is
    not resident. Reads only non-resident blocks' store rows, which no step
    changes while they are not resident."""
    staged = {}
    for plan in plans:
        if not len(plan.ad_blocks):
            continue
        pairs = _moment_pairs(banks, store, plan.key)
        if not plan.stacked:
            for bank_leaf, store_leaf in pairs:
                bank_leaf.copy_(store_leaf, non_blocking=True)
            continue
        rows = []
        for bank_leaf, store_leaf in pairs:
            out = torch.empty((len(plan.ad_blocks),) + bank_leaf.shape[1:],
                              dtype=bank_leaf.dtype, device=bank_leaf.device)
            offload.store_read_rows(store_leaf, plan.ad_blocks, out)
            rows.append(out)
        staged[plan.key] = rows
    return staged


def writeback_evictions(plans: list, banks: dict, store: dict) -> None:
    """Copy evicted blocks' bank rows into their store rows, on the current
    stream (asynchronous into a pinned store). Admitted and evicted blocks
    of one boundary are disjoint, so this commutes with
    ``prefetch_admissions``."""
    for plan in plans:
        if not len(plan.ev_blocks):
            continue
        for bank_leaf, store_leaf in _moment_pairs(banks, store, plan.key):
            if plan.stacked:
                offload.store_write_rows(
                    store_leaf, plan.ev_blocks,
                    [bank_leaf[int(s)] for s in plan.ev_slots])
            else:
                offload.store_write_leaf(store_leaf, bank_leaf)


def _host_slots(plan: GroupSwapPlan, slot_map: np.ndarray,
                cap: int) -> np.ndarray:
    """A group's ``slots`` vector, from the host ``slot_map``."""
    slots = np.full((cap,), plan.length, np.int32)
    local = slot_map[plan.start:plan.start + plan.length]
    held = np.nonzero(local >= 0)[0]
    slots[local[held]] = held
    return slots


def commit_swap(plans: list, banks: dict, slot_map, staged: dict):
    """Apply a planned boundary on the current stream: write the staged
    admissions into their bank slots, free the evicted slots, update each
    bank's ``slots`` and the ``slot_map``. The banks change in place; the
    caller has ordered the current stream after the boundary's copies.
    Returns the new ``slot_map``."""
    slot_map = np.array(slot_map, np.int32)
    for plan in plans:
        bank = banks[plan.key]
        on_card = bank["slots"].device.type == "cuda"
        if plan.stacked and len(plan.ad_blocks):
            for bank_leaf, rows in zip(_moment_leaves(bank),
                                       staged[plan.key]):
                if on_card:   # staging may come from the copy stream's pool
                    rows.record_stream(torch.cuda.current_stream())
                for j, s in enumerate(plan.ad_slots):
                    bank_leaf[int(s)].copy_(rows[j])
        slot_map[plan.start + plan.ev_blocks] = -1
        slot_map[plan.start + plan.ad_blocks] = plan.ad_slots
        slots = torch.from_numpy(
            _host_slots(plan, slot_map, bank["slots"].shape[0]))
        # a pinned source keeps the upload asynchronous
        bank["slots"].copy_(slots.pin_memory() if on_card else slots,
                            non_blocking=True)
    return slot_map


def swap_banked(partition: BlockPartition, banks: dict, store: dict,
                slot_map, mask):
    """The synchronous selection-change boundary, on the current stream:
    ``plan_swap`` -> ``prefetch_admissions`` -> ``writeback_evictions`` ->
    ``commit_swap``. Retained blocks keep their slots, so an unchanged
    selection is a no-op. ``mask``: host bool [num_blocks]. Banks and store
    change in place; returns the new ``slot_map``."""
    plans = plan_swap(partition, slot_map, mask, bank_caps(banks))
    if not plans:
        return np.array(slot_map, np.int32)
    staged = prefetch_admissions(plans, banks, store)
    writeback_evictions(plans, banks, store)
    return commit_swap(plans, banks, slot_map, staged)


@torch.no_grad()
def banked_update(cfg: OptimizerConfig, partition: BlockPartition,
                  params: dict, grads: dict, banks: dict,
                  counts: torch.Tensor, mask: torch.Tensor, lr: float):
    """One masked AdamW step on the banks, in place. Assumes residency ==
    selection (the boundary ran), so every selected block's moments sit in
    a bank row. The row arithmetic is the dense ``update``'s; blocks in the
    store only keep their params (and store moments) bit for bit. Returns
    (params, banks, counts), the same tensors."""
    counts += mask.float()
    for g in partition.groups:
        bank = banks[g.key]
        slots = bank["slots"]
        if g.stacked:
            held = slots.long()
            valid = held < g.length
            gids = g.start + torch.clamp(held, max=g.length - 1)
            sel = torch.where(valid, mask[gids].float(), 0.0)
            cnt = counts[gids]

            def upd(p, gr, m, v, sel=sel, cnt=cnt, slots=slots):
                ops.banked_masked_adamw(p, gr, m, v, slots, sel, cnt, lr,
                                        cfg.b1, cfg.b2, cfg.eps,
                                        cfg.weight_decay)
        else:
            sel = torch.where(slots[0] < g.length,
                              mask[g.start].float(), 0.0)
            cnt = counts[g.start]

            def upd(p, gr, m, v, sel=sel, cnt=cnt):
                _adamw_rows(cfg, p, gr, m, v, sel, cnt, lr)
        tree_map(upd, params[g.key], grads[g.key], bank["m"], bank["v"])
    return params, banks, counts


def materialize_moments(partition: BlockPartition, opt: dict):
    """Full m/v trees (CPU tensors) from banks + store. Waits for the card
    first: the boundary's copies into a pinned store are asynchronous. For
    tests and reporting; training never needs the dense view."""
    if opt["counts"].device.type == "cuda":
        torch.cuda.synchronize(opt["counts"].device)
    out = {"m": {}, "v": {}}
    for g in partition.groups:
        bank = opt["banks"][g.key]
        slots = bank["slots"].cpu()
        for mom in ("m", "v"):
            def one(store_leaf, bank_leaf):
                full = store_leaf.cpu().clone()
                if g.stacked:
                    scatter_rows(full, slots, bank_leaf.cpu())
                elif int(slots[0]) == 0:
                    full.copy_(bank_leaf.cpu())
                return full
            out[mom][g.key] = tree_map(one, opt["store"][g.key][mom],
                                       bank[mom])
    return out["m"], out["v"]
