"""Triton RMSNorm forward for Hopper.

Replaces the TPU kernel ``_kernel`` of the JAX package's
``kernels/rmsnorm.py``: ``y = x * rsqrt(mean(x^2) + eps) * scale`` per row,
statistics in f32, output in the dtype of x. It is bound by memory: each
element is read once and written once with ~4 flops between. One program
normalises one row held whole in registers (``BLOCK`` = next power of two
>= D, masked, 1024 for D = 896), so x is read from device memory once.

Triton is imported, and the kernel compiled, at the first launch: this
module imports on machines without Triton (the CPU tests use the plain
version in ``ref.py``). The checks, dispatch and launch count live in
``ops.py``.
"""
from __future__ import annotations

from repro_torch.kernels import _build

MAX_D = 1024   # one row per program, held in registers by 4 warps
tl = None       # triton.language, bound at the first launch
_compiled = None


def _rmsnorm_fwd(x_ptr, scale_ptr, out_ptr, n_cols, eps,
                 BLOCK: "tl.constexpr"):
    row = tl.program_id(0).to(tl.int64)
    cols = tl.arange(0, BLOCK)
    mask = cols < n_cols
    x = tl.load(x_ptr + row * n_cols + cols, mask=mask, other=0.0)
    x = x.to(tl.float32)
    var = tl.sum(x * x, axis=0) / n_cols
    r = 1.0 / tl.sqrt(var + eps)
    s = tl.load(scale_ptr + cols, mask=mask, other=0.0).to(tl.float32)
    y = x * r * s
    tl.store(out_ptr + row * n_cols + cols, y.to(out_ptr.dtype.element_ty),
             mask=mask)


def load():
    """(triton, the jitted kernel); imports Triton at first use and raises
    if it is missing."""
    global tl, _compiled
    if _compiled is None:
        try:
            import triton
            import triton.language as language
        except ImportError as e:
            raise _build.KernelBuildFailure(
                "the RMSNorm kernel needs the triton package, which is not "
                "installed") from e
        tl = language
        _compiled = (triton, triton.jit(_rmsnorm_fwd))
    return _compiled


def launch(x2d, scale, eps: float, out) -> None:
    """x2d, out: [N, D] contiguous CUDA tensors; scale: [D]. Launches one
    program per row on the current stream (Triton's launcher raises if the
    launch is refused)."""
    triton, kernel = load()
    n, d = x2d.shape
    block = triton.next_power_of_2(d)
    kernel[(n,)](x2d, scale, out, d, eps, BLOCK=block, num_warps=4)
