"""Launchers of the hand-written CUDA flash attention kernels.

The kernels (``csrc/flash_attention.cu``, sm_90a) replace the TPU kernels
``_fwd_kernel``, ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel`` of the JAX
package's ``kernels/flash_attention.py``; the source note says what bounds
them and how they are laid out (the bf16 bodies on the tensor cores, the
f32 ones on the CUDA cores). This module only binds the library (built at
first use by ``_build``), allocates the bf16 dk/dv kernel's workspace and
launches; the checks, the device dispatch, the autograd and the launch
counts live in ``ops.py``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

SOURCE = "flash_attention.cu"
HEAD_DIMS = (64, 128)   # the kernels' instantiations
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
DKV_MAX_SPLIT = 4

_fn = None


def load():
    """The bound kernels (built at first use); raises if they cannot be."""
    global _fn
    if _fn is None:
        lib = _build.load(SOURCE)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        tail = [i32] * 5 + [ctypes.c_float, i32, i32]
        fns = {"fwd": (lib.flash_attention_fwd, 7, []),
               "dq": (lib.flash_attention_bwd_dq, 9, []),
               "dkv": (lib.flash_attention_bwd_dkv, 11, [i32])}  # n_split
        for fn, n_ptrs, more in fns.values():
            fn.argtypes = [ptr] * n_ptrs + tail + more + [ptr]
            fn.restype = i32
        lib.flash_attention_error_string.argtypes = [i32]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _fn = ({k: f for k, (f, _, _) in fns.items()},
               lib.flash_attention_error_string)
    return _fn


def _ptr(t):
    return None if t is None else t.data_ptr()


def dkv_splits(dtype, h: int, kvh: int) -> int:
    """How many blocks share each (k tile, kv head) of the bf16 dk/dv
    kernel: the q heads a kv head serves on average, at most
    ``DKV_MAX_SPLIT``. A function of the shapes only, so the same inputs
    give the same bits. f32: 1 (its body takes no split)."""
    if dtype != torch.bfloat16:
        return 1
    return min(DKV_MAX_SPLIT, -(-h // kvh))


def _launch(which: str, q, ptrs, k, causal: bool, *more) -> None:
    fns, err_str = load()
    b, s, h, d = q.shape
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = fns[which](*ptrs, b, s, h, k.shape[2], d, d ** -0.5,
                         int(causal), _DTYPE_CODE[q.dtype], *more, stream)
    if err:
        raise RuntimeError(f"flash_attention {which} launch failed: CUDA "
                           f"error {err} ({err_str(err).decode()})")


def launch_fwd(q, k, v, seg, hmap, causal, o, lse) -> None:
    """q, o: [B, S, H, D]; k, v: [B, S, KVH, D]; seg: [B, S] int32 or None;
    hmap: [H] int32; lse: [B, H, S] f32 — contiguous CUDA tensors already
    checked by ``ops``. Launches on the current stream; raises if the launch
    was refused."""
    _launch("fwd", q, (_ptr(q), _ptr(k), _ptr(v), _ptr(seg), _ptr(hmap),
                       _ptr(o), _ptr(lse)), k, causal)


def launch_bwd_dq(q, k, v, do, lse, delta, seg, hmap, causal, dq) -> None:
    """dq [B, S, H, D] of the forward at (q, k, v) for the output gradient
    do; lse, delta: [B, H, S] f32."""
    _launch("dq", q, (_ptr(q), _ptr(k), _ptr(v), _ptr(do), _ptr(lse),
                      _ptr(delta), _ptr(seg), _ptr(hmap), _ptr(dq)), k,
            causal)


def launch_bwd_dkv(q, k, v, do, lse, delta, seg, hmap, causal, dk, dv,
                   n_split: int | None = None) -> None:
    """dk, dv [B, S, KVH, D], each summed over its kv head's q heads. In
    bf16 ``n_split`` blocks (``dkv_splits`` unless given) share each k tile
    of a kv head; with more than 1 the kernel writes f32 partials to a
    workspace allocated here, [2, n_split, B, S, KVH, D]."""
    n = (dkv_splits(q.dtype, q.shape[2], k.shape[2]) if n_split is None
         else n_split)
    part = (torch.empty((2, n, *k.shape), dtype=torch.float32,
                        device=q.device) if n > 1 else None)
    _launch("dkv", q, (_ptr(q), _ptr(k), _ptr(v), _ptr(do), _ptr(lse),
                       _ptr(delta), _ptr(seg), _ptr(hmap), _ptr(dk),
                       _ptr(dv), _ptr(part)), k, causal, n)
