"""Launcher of the hand-written CUDA dense decode attention kernel.

The kernel (``csrc/decode_attention.cu``, sm_90a) replaces the TPU kernel
``_kernel`` of the JAX package's ``kernels/decode_attention.py``; its source
note says what bounds it and how it is laid out. This module only binds the
library (built at first use by ``_build``) and launches it; the checks, the
device dispatch and the launch count live in ``ops.py``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

SOURCE = "decode_attention.cu"
HEAD_DIMS = (64, 128)   # the kernel's instances
MAX_HEADS = 16          # the kernel's kMaxHeads
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_fn = None


def load():
    """The bound kernel (built at first use); raises if it cannot be."""
    global _fn
    if _fn is None:
        lib = _build.load(SOURCE)
        fn = lib.decode_attention
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.decode_attention_error_string.argtypes = [ctypes.c_int]
        lib.decode_attention_error_string.restype = ctypes.c_char_p
        got = lib.decode_attention_max_heads()
        if got != MAX_HEADS:
            raise _build.KernelBuildFailure(
                f"{SOURCE}: decode_attention_max_heads() = {got}, the "
                f"launcher expects {MAX_HEADS}")
        _fn = (fn, lib.decode_attention_error_string)
    return _fn


def launch(q, k_cache, v_cache, valid_len, hmap, out) -> None:
    """q, out: [B, H, D]; caches [B, S, KVH, D]; valid_len [B], hmap [H]
    int32 — all contiguous CUDA tensors already checked by
    ``ops.decode_attention``. Launches on the current stream and raises if
    the launch was refused."""
    fn, err_str = load()
    b, h, d = q.shape
    _, s, kvh, _ = k_cache.shape
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                 valid_len.data_ptr(), hmap.data_ptr(), out.data_ptr(), b, h,
                 kvh, s, d, d ** -0.5, _DTYPE_CODE[q.dtype], stream)
    if err:
        raise RuntimeError(f"decode_attention launch failed: CUDA error "
                           f"{err} ({err_str(err).decode()})")
