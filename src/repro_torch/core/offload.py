"""Where the full moment store of the banked residency lives (paper §3.3);
port of the banked-store half of the JAX package's ``core/offload.py``.

Under ``moment_residency="banked"`` the card holds only compact [k]-slot
moment banks (``masked_adamw.init_banked_opt_state``); this module owns the
full-shape f32 store behind them. ``offload`` picks its place:

  "host" — CPU tensors in host RAM, the paper's design. When the banks live
           on the card the store is *pinned*, so a block's moments go
           straight over PCIe with asynchronous copies: a stacked store leaf
           [L, ...] holds block i as its contiguous row i.
  "none" — tensors on the device of the banks (no memory saving; the
           reference keeps it for testing).

The reference's ``"zero1"`` store is sharded over a data-parallel mesh,
which the port has not got (ROADMAP Queue A item 11). Its
``ensure_store_residency`` re-places a store after a checkpoint restore and
comes with checkpoints (item 3).

``optimizer_memory_report`` is the §3.3 model (Mem = 2 * P_selected * B);
``resident_opt_bytes`` measures an actual optimizer state, device against
host bytes.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.partition import (BlockPartition, leaves,
                                        params_per_block, tree_map)

STORE_POLICIES = ("host", "none")


def init_full_store(partition: BlockPartition, params: dict,
                    policy: str = "host") -> dict:
    """Zero f32 m/v store congruent with ``params``: ``{group key: {"m":
    tree, "v": tree}}``, placed per ``policy`` (see the module
    docstring)."""
    if policy == "zero1":
        raise NotImplementedError(
            "offload='zero1' (a store sharded over a data-parallel mesh) is "
            "not ported yet (ROADMAP Queue A item 11, 'Distributed')")
    if policy not in STORE_POLICIES:
        raise ValueError(f"unknown store policy {policy!r}; expected one of "
                         f"{STORE_POLICIES}")
    dev = leaves(params)[0].device
    if policy == "host":
        pin = dev.type == "cuda"

        def zeros(x):
            return torch.zeros(x.shape, pin_memory=pin)
    else:
        def zeros(x):
            return torch.zeros(x.shape, device=dev)
    return {g.key: {"m": tree_map(zeros, params[g.key]),
                    "v": tree_map(zeros, params[g.key])}
            for g in partition.groups}


def store_read_rows(leaf: torch.Tensor, blocks, out: torch.Tensor) -> None:
    """Copy the store rows ``blocks`` (host ints) of a stacked leaf into
    ``out`` [len(blocks), ...], on the current stream; asynchronous from a
    pinned store."""
    for j, b in enumerate(blocks):
        out[j].copy_(leaf[int(b)], non_blocking=True)


def store_write_rows(leaf: torch.Tensor, blocks, rows) -> None:
    """Write ``rows`` (one [...] row per block) into the store rows
    ``blocks`` of a stacked leaf, in place, on the current stream;
    asynchronous into a pinned store, so a host read of the store
    synchronises first."""
    for j, b in enumerate(blocks):
        leaf[int(b)].copy_(rows[j], non_blocking=True)


def store_write_leaf(leaf: torch.Tensor, value: torch.Tensor) -> None:
    """Unstacked-group variant: the whole leaf is one block's moments."""
    leaf.copy_(value, non_blocking=True)


def resident_opt_bytes(opt_state: dict) -> dict:
    """Measured bytes of an optimizer state by where they live: ``device``
    counts the tensors on the training device (that of ``counts``),
    ``host`` the rest — a store in host RAM when training on the card, and
    the numpy ``slot_map``. (On a CPU run the training device is the host,
    so only the slot_map counts as host.)"""
    train_dev = opt_state["counts"].device
    dev = host = 0

    def visit(x):
        nonlocal dev, host
        if isinstance(x, dict):
            for v in x.values():
                visit(v)
        elif isinstance(x, torch.Tensor):
            n = x.numel() * x.element_size()
            if x.device == train_dev:
                dev += n
            else:
                host += n
        elif isinstance(x, np.ndarray):
            host += x.nbytes
    visit(opt_state)
    return {"device": dev, "host": host}


@dataclass(frozen=True)
class MemoryReport:
    """Paper §3.3 deterministic optimizer-memory model, plus (when an actual
    optimizer state is supplied) the measured device/host bytes."""
    p_total: int
    p_selected: int
    bytes_per_param: int
    mem_full: int
    mem_selective: int
    mem_saved: int
    pct_reduction: float
    mem_measured_device: int = -1   # -1 = not measured
    mem_measured_host: int = -1


def optimizer_memory_report(partition: BlockPartition, params: dict,
                            k_percent: float, bytes_per_param: int = 4,
                            opt_state=None) -> MemoryReport:
    """Mem_selective = 2 * P_selected * B with P_selected = the k% largest
    blocks (the worst case). Pass ``state["opt"]`` as ``opt_state`` to fill
    the measured columns."""
    counts = params_per_block(partition, params)
    p_total = int(counts.sum())
    k = max(1, int(round(partition.num_blocks * k_percent / 100.0)))
    p_sel = int(np.sort(counts)[::-1][:k].sum())
    mem_full = 2 * p_total * bytes_per_param
    mem_sel = 2 * p_sel * bytes_per_param
    measured = (resident_opt_bytes(opt_state) if opt_state is not None
                else {"device": -1, "host": -1})
    return MemoryReport(
        p_total=p_total, p_selected=p_sel, bytes_per_param=bytes_per_param,
        mem_full=mem_full, mem_selective=mem_sel, mem_saved=mem_full - mem_sel,
        pct_reduction=(1 - p_sel / p_total) * 100.0,
        mem_measured_device=measured["device"],
        mem_measured_host=measured["host"])
