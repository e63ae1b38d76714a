"""Triton RMSNorm forward and backward for Hopper.

The forward replaces the TPU kernel ``_kernel`` of the JAX package's
``kernels/rmsnorm.py``: ``y = x * rsqrt(mean(x^2) + eps) * scale`` per row,
statistics in f32, output in the dtype of x. It is bound by memory: each
element is read once and written once with ~4 flops between. One program
normalises one row held whole in registers (``BLOCK`` = next power of two
>= D, masked: 1024 for qwen2.5-0.5b's D 896, 2048 for llama3.2-1b's 2048,
4096 for phi4-mini's 3072, 8192 for qwen2.5-32b's 5120), so x is read
from device memory once. The program's warps grow with ``BLOCK``
(``warps``: 4 up to 1024, then one per 256 lanes: 32, Triton's most, at
``MAX_D_FWD`` = 8192), so that a thread holds at most 8 lanes of a row at
any width.

The backward has no TPU kernel to replace: the JAX package differentiates
its RMSNorm in XLA. The port has one because the forward is a kernel on the
training path (``norms.apply``). With xhat = x r, r = rsqrt(mean(x^2) +
eps) recomputed in f32 and g = dy * scale:

    dx     = r * (g - xhat * mean(g * xhat))      per row
    dscale = sum over rows of dy * xhat           per column

It is bound by memory too: x and dy are read once and dx written once
(3 N D elements; at the training path's [4096, 896] in bf16 6.6 us at the
H100's 3.35 TB/s). An earlier design lost most of its time to the column
sum: 512 programs of 8 rows wrote a partial row of dscale each (1.8 MB in
f32, written and read again), summed by 28 programs on the 132 SMs. This
one:

- the row pass (``_rmsnorm_bwd``) runs ``bwd_grid``'s programs, at most
  ``BWD_PER_SM`` an SM, each over a contiguous run of rows in [TILE, D]
  tiles (a tile 8 KB of x and as much of dy: 4 rows of bf16 at D 896, 2
  of f32; 2 rows of bf16 at D 2048, one of f32; one row at 3072), with
  the forward's ``warps``, so that a thread holds 8-32 values of each
  live [TILE, BLOCK] tensor (x, dy, xhat, g * scale, dx) and at most 8 of
  the scale and the dscale partial, which span a padded row.
  Its loop is software-pipelined over 3 stages (Triton's pipeliner copies
  the next tiles asynchronously while this one is computed), which is
  what keeps enough bytes in flight on an SM with so few programs. Its
  dscale partial, the sum over its rows of dy * xhat, stays in f32
  registers across its tiles and is written once: at most 2 x 132 partial
  rows (0.95 MB at D 896, 3.2 MB at 3072);
- the column pass (``_col_sums``) adds the partials of ``COL_BLOCK``
  columns a program (112 programs at D 896, 384 at 3072, the last masked),
  all of them in one [PARTS, COL_BLOCK] tile, in a fixed order.

A frozen layer's norm (gated weight gradients, ``core/gated.py``) needs
no dscale: the dx-only mode compiles the row pass with ``DSCALE`` off,
which drops the column sums from its loop and its partial row, and
launches no column pass. It reads x and dy and writes dx, the same bytes
bound, in one launch instead of two.

No atomics and a fixed order: on one card the same inputs give the same
bits. A row is held whole in registers, padded to the next power of two
(``MAX_D_BWD`` = 4096 at most: the row pass holds five [TILE, BLOCK]
tensors, so it stays at the widths of the models that train on the card):
the masked lanes load nothing.

Triton is imported, and the kernel compiled, at the first launch: this
module imports on machines without Triton (the CPU tests use the plain
version in ``ref.py``). The checks, dispatch and launch count live in
``ops.py``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

MAX_D_FWD = 8192   # the forward: a padded row held in registers by
                   # ``warps(MAX_D_FWD)`` = 32 warps, 8 lanes a thread
MAX_D_BWD = 4096   # the backward's row pass (five live [TILE, BLOCK] tensors)
BWD_PER_SM = 2          # row-pass programs an SM: partial rows of dscale
BWD_TILE_BYTES = 8192   # a row-pass tile of x (and one of dy)
BWD_STAGES = 3          # the row pass's pipelined loop
COL_BLOCK = 8           # columns a program of the column sum
MAX_COL_PARTS = 256     # partial rows a tile of the column sum
tl = None       # triton.language, bound at the first launch
_compiled = None
_SMS: dict = {}  # device -> its SM count, read once


def _pow2(n: int) -> int:
    """The least power of two >= n (n >= 1)."""
    return 1 << (n - 1).bit_length()


def warps(block: int) -> int:
    """Warps of a program over rows padded to ``block`` lanes: 4 up to
    1024 lanes (8 a thread), then one warp per 256 lanes (16 at 4096, 32
    at 8192)."""
    return max(4, block // 256)


def bwd_grid(n: int, d: int, sms: int, itemsize: int) -> tuple:
    """(programs, rows a program, rows a tile) of the backward's row pass
    over n >= 1 rows of width d on a card with ``sms`` SMs, in a dtype of
    ``itemsize`` bytes: tiles of ``BWD_TILE_BYTES`` (a power of two of rows,
    at most the rows there are), spread over at most ``BWD_PER_SM`` programs
    an SM, each a contiguous run of whole tiles (the last run may be
    short). Program p takes rows [p * rows, min(n, (p + 1) * rows))."""
    tile = max(1, min(BWD_TILE_BYTES // (_pow2(d) * itemsize), _pow2(n)))
    tiles = -(-n // tile)
    rows = -(-tiles // (BWD_PER_SM * sms)) * tile
    return -(-n // rows), rows, tile


def _sms(device) -> int:
    n = _SMS.get(device)
    if n is None:
        n = _SMS[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return n


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
                 rows_per_prog, eps, TILE: "tl.constexpr",
                 BLOCK: "tl.constexpr", STAGES: "tl.constexpr",
                 DSCALE: "tl.constexpr"):
    pid = tl.program_id(0)
    start = pid.to(tl.int64) * rows_per_prog
    end = tl.minimum(start + rows_per_prog, n_rows)
    cols = tl.arange(0, BLOCK)
    cmask = cols < n_cols
    s = tl.load(scale_ptr + cols, mask=cmask, other=0.0).to(tl.float32)
    acc = tl.zeros([BLOCK], dtype=tl.float32)
    for r0 in tl.range(start, end, TILE, num_stages=STAGES):
        rows = r0 + tl.arange(0, TILE)
        mask = (rows[:, None] < end) & cmask[None, :]
        offs = rows[:, None] * n_cols + cols[None, :]
        xf = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        dyf = tl.load(dy_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        var = tl.sum(xf * xf, axis=1) / n_cols
        r = 1.0 / tl.sqrt(var + eps)
        xhat = xf * r[:, None]
        gs = dyf * s[None, :]
        proj = tl.sum(gs * xhat, axis=1) / n_cols
        dx = r[:, None] * (gs - xhat * proj[:, None])
        tl.store(dx_ptr + offs, dx.to(dx_ptr.dtype.element_ty), mask=mask)
        if DSCALE:
            acc += tl.sum(dyf * xhat, axis=0)
    if DSCALE:
        tl.store(part_ptr + pid * n_cols + cols, acc, mask=cmask)


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


def launch(x2d, scale, eps: float, out):
    """x2d, out: [N, D] contiguous CUDA tensors; scale: [D]. Launches one
    program per row on the current stream (Triton's launcher raises if the
    launch is refused); returns Triton's compiled kernel (its ``n_regs``
    and ``n_spills``)."""
    triton, kernel, _, _ = load()
    n, d = x2d.shape
    block = triton.next_power_of_2(d)
    return kernel[(n,)](x2d, scale, out, d, eps, BLOCK=block,
                        num_warps=warps(block))


def launch_bwd(x2d, scale, dy2d, eps: float, dx, dscale) -> tuple:
    """x2d, dy2d, dx: [N, D] contiguous CUDA tensors, N >= 1; scale,
    dscale: [D]. Launches the row pass over ``bwd_grid``'s programs and the
    column sum on the current stream; the [programs, D] f32 partials are
    scratch allocated here. ``dscale=None``: the dx-only mode, the row pass
    alone with its column sums compiled out (``DSCALE``), no partials and
    no column pass. Both modes run the same grid, tiles, warps and row
    arithmetic, so their dx has the same bits. Returns Triton's compiled
    row pass and column pass (None in the dx-only mode)."""
    triton, _, bwd, col_sums = load()
    n, d = x2d.shape
    progs, rows, tile = bwd_grid(n, d, _sms(x2d.device), x2d.element_size())
    full = dscale is not None
    # dx-only: part_ptr is never written; dx stands in for it
    part = (torch.empty((progs, d), dtype=torch.float32, device=x2d.device)
            if full else dx)
    block = triton.next_power_of_2(d)
    row_pass = bwd[(progs,)](x2d, scale, dy2d, dx, part, n, d, rows, eps,
                             TILE=tile, BLOCK=block, STAGES=BWD_STAGES,
                             DSCALE=full, num_warps=warps(block))
    if not full:
        return row_pass, None
    return row_pass, col_sums[(-(-d // COL_BLOCK),)](
        part, dscale, progs, d, PARTS=min(MAX_COL_PARTS, _pow2(progs)),
        COL_BLOCK=COL_BLOCK, num_warps=4)
