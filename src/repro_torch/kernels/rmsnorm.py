"""Triton RMSNorm forward and backward for Hopper.

The forward replaces the TPU kernel ``_kernel`` of the JAX package's
``kernels/rmsnorm.py``: ``y = x * rsqrt(mean(x^2) + eps) * scale`` per row,
statistics in f32, output in the dtype of x. It is bound by memory: each
element is read once and written once with ~4 flops between. One program
normalises one row held whole in registers (``BLOCK`` = next power of two
>= D, masked, 1024 for D = 896), so x is read from device memory once.

The backward has no TPU kernel to replace: the JAX package differentiates
its RMSNorm in XLA. The port has one because the forward is a kernel on the
training path (``norms.apply``). With xhat = x r, r = rsqrt(mean(x^2) +
eps) recomputed in f32 and g = dy * scale:

    dx     = r * (g - xhat * mean(g * xhat))      per row
    dscale = sum over rows of dy * xhat           per column

It is bound by memory too: x and dy are read once and dx written once. The
column sum is a deterministic two-stage reduction with no atomics:
``_rmsnorm_bwd`` gives each program a [``ROWS``, D] tile of consecutive
rows, loaded at once, and sums its dy * xhat over the rows in f32 into one
row of ``partials[G, D]``;
``_col_sums`` then adds the G partials of each column in [COL_PARTS,
COL_BLOCK] tiles, in a fixed order.

Triton is imported, and the kernel compiled, at the first launch: this
module imports on machines without Triton (the CPU tests use the plain
version in ``ref.py``). The checks, dispatch and launch count live in
``ops.py``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

MAX_D = 1024   # one row per program, held in registers by 4 warps
BWD_ROWS = 8   # rows per backward program (512 programs at 4096 rows)
COL_PARTS = 128  # partial rows per tile of the dscale column sum
COL_BLOCK = 32   # columns per program of the dscale column sum (28 at 896)
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


def _rmsnorm_bwd(x_ptr, scale_ptr, dy_ptr, dx_ptr, part_ptr, n_rows, n_cols,
                 eps, ROWS: "tl.constexpr", BLOCK: "tl.constexpr"):
    pid = tl.program_id(0).to(tl.int64)
    rows = pid * ROWS + tl.arange(0, ROWS)
    cols = tl.arange(0, BLOCK)
    cmask = cols < n_cols
    mask = (rows[:, None] < n_rows) & cmask[None, :]
    offs = rows[:, None] * n_cols + cols[None, :]
    s = tl.load(scale_ptr + cols, mask=cmask, other=0.0).to(tl.float32)
    x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
    dy = tl.load(dy_ptr + offs, mask=mask, other=0.0).to(tl.float32)
    var = tl.sum(x * x, axis=1) / n_cols
    r = 1.0 / tl.sqrt(var + eps)
    xhat = x * r[:, None]
    gs = dy * s[None, :]
    proj = tl.sum(gs * xhat, axis=1) / n_cols
    dx = r[:, None] * (gs - xhat * proj[:, None])
    tl.store(dx_ptr + offs, dx.to(dx_ptr.dtype.element_ty), mask=mask)
    tl.store(part_ptr + pid * n_cols + cols, tl.sum(dy * xhat, axis=0),
             mask=cmask)


def _col_sums(part_ptr, out_ptr, n_parts, n_cols, PARTS: "tl.constexpr",
              COL_BLOCK: "tl.constexpr"):
    cols = tl.program_id(0) * COL_BLOCK + tl.arange(0, COL_BLOCK)
    cmask = cols < n_cols
    acc = tl.zeros([PARTS, COL_BLOCK], dtype=tl.float32)
    for i in range(0, n_parts, PARTS):
        rows = i + tl.arange(0, PARTS)
        acc += tl.load(part_ptr + rows[:, None] * n_cols + cols[None, :],
                       mask=(rows[:, None] < n_parts) & cmask[None, :],
                       other=0.0)
    tl.store(out_ptr + cols, tl.sum(acc, axis=0).to(
        out_ptr.dtype.element_ty), mask=cmask)


def load():
    """(triton, the forward kernel, the backward kernel, the column sum);
    imports Triton at first use and raises if it is missing."""
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
        _compiled = (triton, triton.jit(_rmsnorm_fwd),
                     triton.jit(_rmsnorm_bwd), triton.jit(_col_sums))
    return _compiled


def launch(x2d, scale, eps: float, out) -> None:
    """x2d, out: [N, D] contiguous CUDA tensors; scale: [D]. Launches one
    program per row on the current stream (Triton's launcher raises if the
    launch is refused)."""
    triton, kernel, _, _ = load()
    n, d = x2d.shape
    block = triton.next_power_of_2(d)
    kernel[(n,)](x2d, scale, out, d, eps, BLOCK=block, num_warps=4)


def launch_bwd(x2d, scale, dy2d, eps: float, dx, dscale) -> None:
    """x2d, dy2d, dx: [N, D] contiguous CUDA tensors; scale, dscale: [D].
    Launches the row pass and the column sum on the current stream; the
    [G, D] f32 partials are scratch allocated here."""
    triton, _, bwd, col_sums = load()
    n, d = x2d.shape
    n_parts = -(-n // BWD_ROWS)
    part = torch.empty((n_parts, d), dtype=torch.float32, device=x2d.device)
    bwd[(n_parts,)](x2d, scale, dy2d, dx, part, n, d, eps, ROWS=BWD_ROWS,
                    BLOCK=triton.next_power_of_2(d), num_warps=8)
    col_sums[(-(-d // COL_BLOCK),)](part, dscale, n_parts, d,
                                    PARTS=COL_PARTS, COL_BLOCK=COL_BLOCK,
                                    num_warps=4)
