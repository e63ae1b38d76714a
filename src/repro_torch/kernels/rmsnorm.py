"""RMSNorm forward (CUDA C++) and backward (Triton) for Hopper.

The forward replaces the TPU kernel ``_kernel`` of the JAX package's
``kernels/rmsnorm.py``: ``y = x * rsqrt(mean(x^2) + eps) * scale`` per row,
statistics in f32, output in the dtype of x. It is the CUDA C++ kernel of
``csrc/rmsnorm.cu`` (built at first use by ``_build``, bound here with
ctypes), whose source note says what bounds it and how it is laid out:
persistent blocks whose row groups stream rows at their exact width
through a ring of bulk copies in shared memory. ``fwd_plan`` picks its
instance and grid, a pure function of the shapes, the base addresses'
alignment and the card's SM count; the C side re-checks it.

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
  ``warps`` warps, so that a thread holds 8-32 values of each
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

Triton is imported, and the backward compiled, at its first launch, and
the forward's library is built at its first: this module imports on
machines without Triton or nvcc (the CPU tests use the plain versions in
``ref.py``). The checks, dispatch and launch counts live in ``ops.py``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

SOURCE = "rmsnorm.cu"   # the forward
MAX_D_FWD = 8192   # the forward's kMaxD: 4 warps a bf16 row, 8 an f32 one
VEC_BYTES = 16          # a vector of x: a bulk copy's alignment and unit
MAX_VEC_PER_LANE = 8    # the forward's kMaxVecPerLane: vectors a lane holds
FWD_STAGES = 3          # its kStages: ring slots a row group
MAX_THREADS = 1024      # its kMaxThreads: a block of the registers instance
                        # (64 registers a thread)
MAX_BULK_THREADS = 256  # its kMaxBulkThreads: a block of the bulk-copy
                        # instances, two an SM (128 registers a thread)
MAX_SMEM = 232448       # its kMaxSmem: the most shared memory a block takes
BLOCK_THREADS = MAX_BULK_THREADS   # threads a block of row groups aims at
# an H100 SM: shared memory (1 KB of it reserved a block), threads, registers
SM_SMEM, SM_THREADS, SM_REGS, SM_BLOCKS = 233472, 2048, 65536, 32
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_D_BWD = 4096   # the backward's row pass (five live [TILE, BLOCK] tensors)
BWD_PER_SM = 2          # row-pass programs an SM: partial rows of dscale
BWD_TILE_BYTES = 8192   # a row-pass tile of x (and one of dy)
BWD_STAGES = 3          # the row pass's pipelined loop
COL_BLOCK = 8           # columns a program of the column sum
MAX_COL_PARTS = 256     # partial rows a tile of the column sum
tl = None       # triton.language, bound at the first launch
_compiled = None
_fn = None      # the forward's entry point and error string
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


class FwdPlan(NamedTuple):
    """A launch of the forward, in the argument order of ``rmsnorm_fwd``."""
    vec: int      # elements a vector: 16 bytes of x (bulk copies), or 1
    warps: int    # warps a row
    rows: int     # row groups a block, each on one row at a time
    stages: int   # ring slots a row group (0: the vector-width-1 instance)
    smem: int     # dynamic shared bytes a block
    blocks: int   # the grid


def _smem(d: int, itemsize: int, warps_: int, rows: int, stages: int) -> int:
    """``csrc/rmsnorm.cu`` ``layout``: the ring's mbarriers, the warps'
    sums (2 x 4 f32 a row group and warp), the scale in f32 and the ring,
    each rounded up to 16 bytes."""
    a16 = lambda b: -(-b // 16) * 16   # noqa: E731
    return (a16(8 * rows * stages) + a16(32 * rows * warps_) + a16(4 * d)
            + rows * stages * a16(d * itemsize))


@functools.lru_cache(maxsize=512)
def fwd_plan(n: int, d: int, x_itemsize: int, aligned: bool,
             sms: int) -> FwdPlan:
    """The forward's launch over n >= 1 rows of 0 < d <= ``MAX_D_FWD``
    elements of ``x_itemsize`` bytes on a card with ``sms`` SMs; ``aligned``:
    x's and the output's base addresses are 16-byte aligned.

    - vec: 16 bytes of x (8 bf16, 4 f32) when aligned and d is a multiple
      of it, else 1 (the registers instance);
    - warps: the fewest that keep a lane at <= ``MAX_VEC_PER_LANE``
      vectors of a row (bf16: 1 up to d 2048, 2 at 3072 and 4096, 3 at
      5120, 4 at 8192; vec 1: one per 256 elements), but for f32 vectors
      max(1, B / 1024), B the least power of two >= d (1 at 896, 2 at
      2048, 4 at 3072 and 4096, 8 at 5120 and 8192): the layout through
      which the f32 path keeps the earlier forward's arithmetic, a
      temporary compatibility fork for ``chip_smoke.py`` phase 14(b)
      (``csrc/rmsnorm.cu`` ``f32_inv_rms``; ROADMAP Queue C 12);
    - rows: row groups a block, ~``BLOCK_THREADS`` threads, but no more
      than the rows an SM would get, so that few rows spread over the SMs;
    - stages: ring slots of a row group, ``FWD_STAGES`` (0 for vec 1):
      the ring of f32 rows at d 8192 (32 KB each) is 96 KB a block;
    - blocks: about one wave, those that fit on an SM by threads, shared
      memory and registers (the instances' caps: 128 a thread with 16-byte
      vectors, 64 with vec 1), times ``sms``, capped by the row
      groups that have a row. Row group g of the G = blocks x rows takes
      rows g, g + G, g + 2 G, ...: every row once, no block empty.

    The scale is staged once a block in f32, so its dtype and base change
    nothing here."""
    full = VEC_BYTES // x_itemsize
    vec = full if aligned and d % full == 0 else 1
    if vec > 1 and x_itemsize == 4:
        warps_ = max(1, _pow2(d) // 1024)
    else:
        warps_ = -(-(d // vec) // (32 * MAX_VEC_PER_LANE))
    rows = max(1, min(BLOCK_THREADS // (32 * warps_), -(-n // sms)))
    stages = FWD_STAGES if vec > 1 else 0
    smem = _smem(d, x_itemsize, warps_, rows, stages)
    threads = 32 * warps_ * rows
    per_sm = min(SM_THREADS // threads, SM_SMEM // (smem + 1024),
                 SM_REGS // ((128 if vec > 1 else 64) * threads), SM_BLOCKS)
    return FwdPlan(vec, warps_, rows, stages, smem,
                   min(sms * per_sm, -(-n // rows)))


def load_fwd():
    """(the forward's entry point, its error string), built at first use;
    raises if they cannot be."""
    global _fn
    if _fn is None:
        lib = _build.load(SOURCE)
        fn = lib.rmsnorm_fwd
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_float] + [ctypes.c_int] * 8
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.rmsnorm_fwd_error_string.argtypes = [ctypes.c_int]
        lib.rmsnorm_fwd_error_string.restype = ctypes.c_char_p
        for what, want in (("max_d", MAX_D_FWD),
                           ("max_vec_per_lane", MAX_VEC_PER_LANE),
                           ("stages", FWD_STAGES),
                           ("max_threads", MAX_THREADS),
                           ("max_bulk_threads", MAX_BULK_THREADS),
                           ("max_smem", MAX_SMEM)):
            got = getattr(lib, f"rmsnorm_fwd_{what}")()
            if got != want:
                raise _build.KernelBuildFailure(
                    f"{SOURCE}: rmsnorm_fwd_{what}() = {got}, the launcher "
                    f"expects {want}")
        _fn = (fn, lib.rmsnorm_fwd_error_string)
    return _fn


def launch(x2d, scale, eps: float, out) -> FwdPlan:
    """The forward. x2d, out: [N, D] contiguous CUDA tensors, N >= 1;
    scale: [D]; all checked by ``ops.rmsnorm``. Launches ``fwd_plan``'s
    instance on the current stream, raises if the launch was refused, and
    returns the plan."""
    fn, err_str = load_fwd()
    n, d = x2d.shape
    xp, op = x2d.data_ptr(), out.data_ptr()
    plan = fwd_plan(n, d, x2d.element_size(), (xp | op) % VEC_BYTES == 0,
                    _sms(x2d.device))
    with torch.cuda.device(x2d.device):
        err = fn(xp, scale.data_ptr(), op, n, d, eps, _DTYPE_CODE[x2d.dtype],
                 _DTYPE_CODE[scale.dtype], *plan,
                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"rmsnorm launch failed: CUDA error {err} "
                           f"({err_str(err).decode()})")
    return plan


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
    """(triton, the backward kernel, the column sum); imports Triton at
    first use and raises if it is missing."""
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
        _compiled = (triton, triton.jit(_rmsnorm_bwd), triton.jit(_col_sums))
    return _compiled


def launch_bwd(x2d, scale, dy2d, eps: float, dx, dscale) -> tuple:
    """x2d, dy2d, dx: [N, D] contiguous CUDA tensors, N >= 1; scale,
    dscale: [D]. Launches the row pass over ``bwd_grid``'s programs and the
    column sum on the current stream; the [programs, D] f32 partials are
    scratch allocated here. ``dscale=None``: the dx-only mode, the row pass
    alone with its column sums compiled out (``DSCALE``), no partials and
    no column pass. Both modes run the same grid, tiles, warps and row
    arithmetic, so their dx has the same bits. Returns Triton's compiled
    row pass and column pass (None in the dx-only mode)."""
    triton, bwd, col_sums = load()
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
