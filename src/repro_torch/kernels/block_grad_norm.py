"""Triton per-row gradient sum of squares for Hopper (paper Alg. 1 lines 1-6).

Replaces the TPU kernel ``_kernel`` of the JAX package's
``kernels/block_grad_norm.py``: for a stacked gradient leaf viewed as
[L, R], the f32 sum of squares of each row, giving [L]. It runs once per
stacked leaf every training step, and is bound by memory: each element is
read once, with two flops per element.

The TPU kernel walks the chunks of a row in order and carries the sum in
scratch memory; on Hopper the chunks run in parallel, so the reduction has
two stages and no atomics:

1. ``_partials``: one program per (chunk of ``CHUNK`` elements, row) reads
   its chunk in ``BLOCK``-wide tiles, accumulates squares in f32 registers,
   reduces them and writes one partial to ``partials[L, C]``
   (C = cdiv(R, CHUNK)). The ragged last chunk is masked: no padding copy.
2. ``_row_sums``: one program per row sums its C partials in a fixed order.

The order of every addition is fixed by the shapes, so two runs give the
same bits: a run-dependent order could flip ``topk_mask`` ties and make two
runs of one seed select different blocks.

Triton is imported, and the kernels compiled, at the first launch (see
``rmsnorm.py``). The checks, dispatch and launch count live in ``ops.py``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

CHUNK = 16384   # elements per stage-1 program (266 chunks per wg row at full width)
BLOCK = 2048    # elements per tile (8 warps x 32 lanes x 8)
SUM_BLOCK = 512  # partials per tile in stage 2
tl = None        # triton.language, bound at the first launch
_compiled = None


def _partials(g_ptr, part_ptr, R, C, CHUNK: "tl.constexpr",
              BLOCK: "tl.constexpr"):
    c = tl.program_id(0)
    row = tl.program_id(1).to(tl.int64)
    start = c.to(tl.int64) * CHUNK
    acc = tl.zeros([BLOCK], dtype=tl.float32)
    for off in range(0, CHUNK, BLOCK):
        idx = start + off + tl.arange(0, BLOCK)
        x = tl.load(g_ptr + row * R + idx, mask=idx < R, other=0.0)
        x = x.to(tl.float32)
        acc += x * x
    tl.store(part_ptr + row * C + c, tl.sum(acc, axis=0))


def _row_sums(part_ptr, out_ptr, C, SUM_BLOCK: "tl.constexpr"):
    row = tl.program_id(0).to(tl.int64)
    acc = tl.zeros([SUM_BLOCK], dtype=tl.float32)
    for off in range(0, C, SUM_BLOCK):
        idx = off + tl.arange(0, SUM_BLOCK)
        acc += tl.load(part_ptr + row * C + idx, mask=idx < C, other=0.0)
    tl.store(out_ptr + row, tl.sum(acc, axis=0))


def load():
    """(the stage-1 kernel, the stage-2 kernel); imports Triton at first use
    and raises if it is missing."""
    global tl, _compiled
    if _compiled is None:
        try:
            import triton
            import triton.language as language
        except ImportError as e:
            raise _build.KernelBuildFailure(
                "the block gradient norm kernel needs the triton package, "
                "which is not installed") from e
        tl = language
        _compiled = (triton.jit(_partials), triton.jit(_row_sums))
    return _compiled


def launch(g2d, out) -> None:
    """g2d: [L, R] contiguous CUDA tensor (f32 or bf16); out: [L] f32.
    Launches both stages on the current stream; the partials are scratch
    allocated here with ``torch.empty``."""
    partials_k, sums_k = load()
    n_rows, r = g2d.shape
    n_chunks = -(-r // CHUNK)
    part = torch.empty((n_rows, n_chunks), dtype=torch.float32,
                       device=g2d.device)
    partials_k[(n_chunks, n_rows)](g2d, part, r, n_chunks, CHUNK=CHUNK,
                                   BLOCK=BLOCK, num_warps=8)
    sums_k[(n_rows,)](part, out, n_chunks, SUM_BLOCK=SUM_BLOCK, num_warps=4)
