"""Where the full moment store of the banked residency lives (paper §3.3);
port of the banked-store half of the JAX package's ``core/offload.py``.

Under ``moment_residency="banked"`` the card holds only compact [k]-slot
moment banks (``masked_adamw.init_banked_opt_state``); this module owns the
full-shape store behind them, in the moment dtype (f32 or bf16). ``offload``
picks its place:

  "host" — CPU tensors in host RAM, the paper's design. When the banks live
           on the card the store is *pinned*, so a block's moments go
           straight over PCIe with asynchronous copies: a stacked store leaf
           [L, ...] holds block i as its contiguous row i.
  "none" — tensors on the device of the banks (no memory saving; the
           reference keeps it for testing).

The reference's ``"zero1"`` store is sharded over a data-parallel mesh,
which the port has not got (ROADMAP Queue A item 11).
``ensure_store_residency`` re-places a store after a checkpoint restore.

``optimizer_memory_report`` is the §3.3 model (Mem = 2 * P_selected * B);
``resident_opt_bytes`` measures an actual optimizer state, device against
host bytes.
"""
from __future__ import annotations

import math
import mmap
import weakref
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.partition import (BlockPartition, leaves,
                                        params_per_block, tree_map)

STORE_POLICIES = ("host", "none")


def init_full_store(partition: BlockPartition, params: dict,
                    policy: str = "host",
                    moment_dtype: torch.dtype = torch.float32) -> dict:
    """Zero m/v store in ``moment_dtype`` congruent with ``params``:
    ``{group key: {"m": tree, "v": tree}}``, placed per ``policy`` (see the
    module docstring)."""
    if policy == "zero1":
        raise NotImplementedError(
            "offload='zero1' (a store sharded over a data-parallel mesh) is "
            "not ported yet (ROADMAP Queue A item 11, 'Distributed')")
    if policy not in STORE_POLICIES:
        raise ValueError(f"unknown store policy {policy!r}; expected one of "
                         f"{STORE_POLICIES}")
    dev = leaves(params)[0].device
    if policy == "host":
        def zeros(x):
            if dev.type == "cuda":
                return pinned_zeros(x.shape, moment_dtype)
            return torch.zeros(x.shape, dtype=moment_dtype)
    else:
        def zeros(x):
            return torch.zeros(x.shape, dtype=moment_dtype, device=dev)
    return {g.key: {"m": tree_map(zeros, params[g.key]),
                    "v": tree_map(zeros, params[g.key])}
            for g in partition.groups}


def pinned_zeros(shape, dtype: torch.dtype) -> torch.Tensor:
    """A zero CPU tensor page-locked in place: an anonymous mapping of its
    exact size, its pages faulted in by the kernel at once
    (``MAP_POPULATE``) and registered with ``cudaHostRegister``, so copies
    to and from the card are asynchronous; unregistered, then unmapped,
    when the last view has gone. PyTorch's caching pinned allocator
    (``torch.zeros(..., pin_memory=True)``) rounds each block up to a power
    of two and keeps freed blocks for reuse: yi-9b's 35.3 GB bf16 store
    would pin ~61 GB there, and a store that a run dropped would stay
    pinned. On the host of an NVIDIA H100 80GB HBM3 (700 W) machine 8 GiB
    took 2.1 s this way, 6.0 s when numpy's zeros (pages faulted one by
    one) were registered."""
    nbytes = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
    m = mmap.mmap(-1, max(nbytes, 1), flags=mmap.MAP_PRIVATE
                  | mmap.MAP_ANONYMOUS | getattr(mmap, "MAP_POPULATE", 0))
    buf = np.frombuffer(m, np.uint8)
    cudart = torch.cuda.cudart()
    torch.cuda.check_error(cudart.cudaHostRegister(buf.ctypes.data,
                                                   buf.nbytes, 0))
    # runs as the array is freed, before it lets go of the mapping
    weakref.finalize(buf, cudart.cudaHostUnregister, buf.ctypes.data)
    return torch.from_numpy(buf)[:nbytes].view(dtype).view(tuple(shape))


def ensure_store_residency(store: dict, policy: str, device) -> dict:
    """Re-place a full store on its configured side, after a checkpoint
    restore has brought every leaf to host RAM: ``"host"`` keeps CPU
    tensors, pinned (``pinned_zeros``) when ``device`` (that of the banks)
    is the card, so the boundary's copies stay asynchronous; ``"none"``
    moves them to ``device``. A leaf already in place is kept as it is."""
    if policy not in STORE_POLICIES:
        raise ValueError(f"unknown store policy {policy!r}; expected one of "
                         f"{STORE_POLICIES}")
    dev = torch.device(device)

    def place(x):
        if policy == "none":
            return x.to(dev)
        x = x.cpu()
        if dev.type != "cuda" or x.is_pinned():
            return x
        return pinned_zeros(x.shape, x.dtype).copy_(x)
    return tree_map(place, store)


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
    counts the tensors on the training device (that of the moments: ``m``,
    or the banked layout's ``banks``), ``host`` the rest — a store in host
    RAM when training on the card, and the numpy ``slot_map``. (On a CPU
    run the training device is the host, so only the slot_map counts as
    host.) Any layout with ``m`` or ``banks`` will do: the selection
    family's, or LoRA's ``{"m", "v", "count"}``."""
    moments = opt_state["m"] if "m" in opt_state else opt_state["banks"]
    train_dev = leaves(moments)[0].device
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


def moment_itemsize(opt_state: dict) -> int:
    """Bytes of one moment element (4 for f32, 2 for bf16) of a dense or
    banked optimizer state: the B of the memory model below."""
    moments = opt_state["m"] if "m" in opt_state else opt_state["store"]
    return leaves(moments)[0].element_size()


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
