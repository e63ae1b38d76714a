"""Launcher of the hand-written CUDA paged decode attention kernel.

The kernel (``csrc/paged_decode_attention.cu``, sm_90a) replaces the TPU
kernel ``_paged_kernel`` of the JAX package's ``kernels/decode_attention.py``;
its source note says what bounds it and how it is laid out. This module only
binds the library (built at first use by ``_build``) and launches it; the
checks, the device dispatch and the launch count live in ``ops.py``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

SOURCE = "paged_decode_attention.cu"
HEAD_DIM = 64     # the kernel's kD
MAX_HEADS = 16    # the kernel's kMaxHeads
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_fn = None


def load():
    """The bound kernel (built at first use); raises if it cannot be."""
    global _fn
    if _fn is None:
        lib = _build.load(SOURCE)
        fn = lib.paged_decode_attention
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.paged_decode_attention_error_string.argtypes = [ctypes.c_int]
        lib.paged_decode_attention_error_string.restype = ctypes.c_char_p
        for name, want in (("paged_decode_attention_head_dim", HEAD_DIM),
                           ("paged_decode_attention_max_heads", MAX_HEADS)):
            got = getattr(lib, name)()
            if got != want:
                raise _build.KernelBuildFailure(
                    f"{SOURCE}: {name}() = {got}, the launcher expects {want}")
        _fn = (fn, lib.paged_decode_attention_error_string)
    return _fn


def launch(q, k_pool, v_pool, page_tables, valid_len, hmap, out) -> None:
    """q, out: [B, H, D]; pools [num_pages, page_size, KVH, D]; page_tables
    [B, max_pages], valid_len [B], hmap [H] int32 — all contiguous CUDA
    tensors already checked by ``ops.paged_decode_attention``. Launches on
    the current stream and raises if the launch was refused."""
    fn, err_str = load()
    b, h, d = q.shape
    num_pages, ps, kvh, _ = k_pool.shape
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                 page_tables.data_ptr(), valid_len.data_ptr(),
                 hmap.data_ptr(), out.data_ptr(), b, h, kvh, num_pages, ps,
                 page_tables.shape[1], d ** -0.5, _DTYPE_CODE[q.dtype],
                 stream)
    if err:
        raise RuntimeError(f"paged_decode_attention launch failed: CUDA "
                           f"error {err} ({err_str(err).decode()})")
