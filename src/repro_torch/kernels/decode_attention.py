"""Launcher of the hand-written CUDA dense decode attention kernel.

The kernel (``csrc/decode_attention.cu``, sm_90a) replaces the TPU kernel
``_kernel`` of the JAX package's ``kernels/decode_attention.py``; its source
note says what bounds it and how it is laid out. This module binds the
library (built at first use by ``_build``), picks how many chunks a row's
positions are split into (``decode_splits``), keeps the kernel's workspace
and launches it; the checks, the device dispatch and the launch count live
in ``ops.py``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

SOURCE = "decode_attention.cu"
HEAD_DIMS = (64, 128)   # the kernel's instances
MAX_HEADS = 16          # the kernel's kMaxHeads
MAX_SPLIT = 32          # the kernel's kMaxSplit: chunks a row
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
    """The bound kernel (built at first use); raises if it cannot be."""
    global _fn
    if _fn is None:
        lib = _build.load(SOURCE)
        fn = lib.decode_attention
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.decode_attention_error_string.argtypes = [ctypes.c_int]
        lib.decode_attention_error_string.restype = ctypes.c_char_p
        for what, want in (("heads", MAX_HEADS), ("split", MAX_SPLIT)):
            got = getattr(lib, f"decode_attention_max_{what}")()
            if got != want:
                raise _build.KernelBuildFailure(
                    f"{SOURCE}: decode_attention_max_{what}() = {got}, the "
                    f"launcher expects {want}")
        _fn = (fn, lib.decode_attention_error_string)
    return _fn


def _workspace(device, n_part: int, n_tickets: int):
    part, tickets = _scratch.get(device, (None, None))
    if part is None or part.numel() < n_part:
        part = torch.empty(n_part, dtype=torch.float32, device=device)
    if tickets is None or tickets.numel() < n_tickets:
        tickets = torch.zeros(n_tickets, dtype=torch.int32, device=device)
    _scratch[device] = (part, tickets)
    return part, tickets


def launch(q, k_cache, v_cache, valid_len, hmap, out,
           n_split: int | None = None) -> None:
    """q, out: [B, H, D]; caches [B, S, KVH, D]; valid_len [B], hmap [H]
    int32 — all contiguous CUDA tensors already checked by
    ``ops.decode_attention``. ``n_split`` chunks a row (``decode_splits``
    unless given, 1 .. ``MAX_SPLIT``); with more than 1 the kernel uses
    this device's workspace, which launches on one stream share. Launches
    on the current stream and raises if the launch was refused."""
    fn, err_str = load()
    b, h, d = q.shape
    _, s, kvh, _ = k_cache.shape
    n = decode_splits(q.dtype, s) if n_split is None else n_split
    part = tickets = None
    if n > 1:
        part, tickets = _workspace(q.device, b * kvh * n * MAX_HEADS * (d + 2),
                                   b * kvh)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                 valid_len.data_ptr(), hmap.data_ptr(), out.data_ptr(),
                 None if part is None else part.data_ptr(),
                 None if tickets is None else tickets.data_ptr(), b, h, kvh,
                 s, d, n, d ** -0.5, _DTYPE_CODE[q.dtype], stream)
    if err:
        raise RuntimeError(f"decode_attention launch failed: CUDA error "
                           f"{err} ({err_str(err).decode()})")
