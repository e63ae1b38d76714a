"""Launcher of the hand-written CUDA decode attention kernels (rows 1 and 3).

One source, ``csrc/decode_attention.cu`` (sm_90a), holds both: the dense
decode (row 3) replaces the TPU kernel ``_kernel`` of the JAX package's
``kernels/decode_attention.py``, the paged decode (row 1) its
``_paged_kernel``; the two share one body and differ only in how a
position's K/V row is found. Its source note says what bounds them and how
they are laid out. This module binds the library (built at first use by
``_build``), picks how many chunks a row's positions are split into
(``decode_splits``), keeps the kernels' workspace and launches them; the
checks, the device dispatch and the launch counts live in ``ops.py``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

SOURCE = "decode_attention.cu"
HEAD_DIMS = (64, 128)   # the kernels' instances
MAX_HEADS = 64          # the kernels' kMaxQHeads: q heads a row
BLOCK_HEADS = 16        # kMaxHeads: q heads a block serves, so a kv head's
                        # group is served by ceil(H / 16) blocks
MAX_SPLIT = 32          # the kernels' kMaxSplit: chunks a row
# positions a chunk holds at most: a bf16 tile on the tensor cores is
# cheap beside the combine, an f32 tile on the CUDA cores is not
MAX_CHUNK = {torch.bfloat16: 512, torch.float32: 128}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_fn = None
# device -> (f32 workspace, int32 tickets): kept across calls and grown as
# needed; the kernel leaves every ticket 0 for the next launch
_scratch: dict = {}


def decode_splits(dtype, s: int) -> int:
    """How many chunks, one block each, each row's S cache positions are
    split into: the fewest that hold at most ``MAX_CHUNK[dtype]`` positions
    each, at most ``MAX_SPLIT``. A shorter chunk costs more in the combine
    than it saves (``chip_smoke.py`` phase 15 times every split on the
    H100): in bf16 one block walks a 512-position row faster than 2-32
    blocks, so the eval's 512-position caches take 1 chunk and 2048- and
    8192-position caches 4 and 16; in f32 chunks of 128 pay. A function of
    the shapes only: the host never reads ``valid_len`` (a chunk past it
    reads nothing), so a decode step makes no host sync, and the same
    inputs give the same bits."""
    return max(1, min(MAX_SPLIT, -(-s // MAX_CHUNK[dtype])))


def load():
    """(dense entry point, paged entry point, error string), built at first
    use; raises if they cannot be."""
    global _fn
    if _fn is None:
        lib = _build.load(SOURCE)
        dense, paged = lib.decode_attention, lib.paged_decode_attention
        dense.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        paged.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        dense.restype = paged.restype = ctypes.c_int
        lib.decode_attention_error_string.argtypes = [ctypes.c_int]
        lib.decode_attention_error_string.restype = ctypes.c_char_p
        for what, want in (("max_heads", MAX_HEADS),
                           ("block_heads", BLOCK_HEADS),
                           ("max_split", MAX_SPLIT)):
            got = getattr(lib, f"decode_attention_{what}")()
            if got != want:
                raise _build.KernelBuildFailure(
                    f"{SOURCE}: decode_attention_{what}() = {got}, the "
                    f"launcher expects {want}")
        _fn = (dense, paged, lib.decode_attention_error_string)
    return _fn


def _workspace(device, n_part: int, n_tickets: int):
    part, tickets = _scratch.get(device, (None, None))
    if part is None or part.numel() < n_part:
        part = torch.empty(n_part, dtype=torch.float32, device=device)
    if tickets is None or tickets.numel() < n_tickets:
        tickets = torch.zeros(n_tickets, dtype=torch.int32, device=device)
    _scratch[device] = (part, tickets)
    return part, tickets


def _scratch_args(q, kvh: int, n: int) -> tuple:
    """(workspace, tickets) pointers for a launch of n chunks a row: none
    for 1, else this device's, grown to the launch's size."""
    if n == 1:
        return None, None
    b, h, d = q.shape
    blocks = b * kvh * -(-h // BLOCK_HEADS)   # (row, kv head, slice)
    part, tickets = _workspace(q.device, blocks * n * BLOCK_HEADS * (d + 2),
                               blocks)
    return part.data_ptr(), tickets.data_ptr()


def _check(err: int, err_str, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} launch failed: CUDA error {err} "
                           f"({err_str(err).decode()})")


def launch(q, k_cache, v_cache, valid_len, hmap, out,
           n_split: int | None = None) -> None:
    """Row 3. q, out: [B, H, D]; caches [B, S, KVH, D]; valid_len [B], hmap
    [H] int32 — all contiguous CUDA tensors already checked by
    ``ops.decode_attention``. ``n_split`` chunks a row (``decode_splits``
    unless given, 1 .. ``MAX_SPLIT``); with more than 1 the kernel uses
    this device's workspace, which launches on one stream share. Launches
    on the current stream and raises if the launch was refused."""
    dense, _, err_str = load()
    b, h, d = q.shape
    _, s, kvh, _ = k_cache.shape
    n = decode_splits(q.dtype, s) if n_split is None else n_split
    part, tickets = _scratch_args(q, kvh, n)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = dense(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                    valid_len.data_ptr(), hmap.data_ptr(), out.data_ptr(),
                    part, tickets, b, h, kvh, s, d, n, d ** -0.5,
                    _DTYPE_CODE[q.dtype], stream)
    _check(err, err_str, "decode_attention")


def launch_paged(q, k_pool, v_pool, page_tables, valid_len, hmap, out,
                 n_split: int | None = None) -> None:
    """Row 1. q, out: [B, H, D]; pools [num_pages, page_size, KVH, D];
    page_tables [B, max_pages], valid_len [B], hmap [H] int32 — all
    contiguous CUDA tensors already checked by
    ``ops.paged_decode_attention``. A row's positions are those of the
    dense view the tables gather, S = max_pages * page_size, split as row
    3 splits them (``decode_splits(dtype, S)`` unless ``n_split`` is
    given), so both rows give the same bits on one pool. Launches on the
    current stream and raises if the launch was refused."""
    _, paged, err_str = load()
    b, h, d = q.shape
    num_pages, ps, kvh, _ = k_pool.shape
    max_pages = page_tables.shape[1]
    n = (decode_splits(q.dtype, max_pages * ps) if n_split is None
         else n_split)
    part, tickets = _scratch_args(q, kvh, n)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = paged(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                    page_tables.data_ptr(), valid_len.data_ptr(),
                    hmap.data_ptr(), out.data_ptr(), part, tickets, b, h,
                    kvh, num_pages, ps, max_pages, d, n, d ** -0.5,
                    _DTYPE_CODE[q.dtype], stream)
    _check(err, err_str, "paged_decode_attention")
