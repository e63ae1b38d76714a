"""Triton block-masked AdamW step for Hopper (paper Alg. 1 lines 9-13).

Replaces the TPU kernel ``_kernel`` of the JAX package's
``kernels/masked_adamw.py``: over a stacked leaf viewed as [L, R], the rows
whose ``sel`` is nonzero take an AdamW step with their own bias-correction
count ``c = max(counts[row], 1)``; the other rows keep p, m and v bit for
bit. p and g are in the parameter dtype, m and v in f32, the arithmetic in
f32, in the reference's order of operations.

It is bound by memory: a selected element reads p, g, m, v and writes p, m,
v (3 x 2 + 16 = 22 bytes at bf16 params) with ~15 flops between. The kernel
updates p, m and v in place (the reference returns new arrays), so it moves
nothing else. One program per (``TILES * BLOCK`` elements, row) walks its
chunk in ``BLOCK``-wide tiles; a program of a row with sel = 0 reads sel
and stops, so such a row is never loaded or stored and the launch costs
little more than the selected rows' bytes. The ragged end of a row is
masked, so nothing is padded or copied.

The bias corrections ``1 - b^c`` are f32 per program, as in the reference,
with ``b^c`` computed by libdevice's f64 ``pow`` and rounded once to f32,
which gives the correctly rounded f32 power that PyTorch's and XLA's
``pow`` give (libdevice's f32 ``pow`` under Triton is off by an ulp or two,
and ``1 - b2^c`` magnifies that ~1000x). The divisions and the square root
are the correctly rounded ``div_rn`` and ``sqrt_rn``: Triton's default
division and ``sqrt`` are approximate, and the step must match the
reference in bf16.

Triton is imported, and the kernel compiled, at the first launch (see
``rmsnorm.py``). The checks, dispatch and launch count live in ``ops.py``.
"""
from __future__ import annotations

from repro_torch.kernels import _build

BLOCK = 2048    # elements per tile (8 warps x 32 lanes x 8)
TILES = 8       # tiles per program (16384 elements), fewer for short rows
tl = None        # triton.language, bound at the first launch
libdevice = None  # triton's libdevice bindings, bound at the first launch
_compiled = None


def _masked_adamw(p_ptr, g_ptr, m_ptr, v_ptr, sel_ptr, cnt_ptr, R,
                  lr, b1, b2, omb1, omb2, eps, wd, BLOCK: "tl.constexpr",
                  TILES: "tl.constexpr"):
    chunk = tl.program_id(0).to(tl.int64)
    row = tl.program_id(1).to(tl.int64)
    sel = tl.load(sel_ptr + row)
    if sel > 0:
        # b^c in f64, rounded once to f32: the f32 bias correction 1 - b^c
        # (of order 1e-3 for b2) magnifies any error of b^c ~1000x
        c = tl.maximum(tl.load(cnt_ptr + row), 1.0).to(tl.float64)
        bc1 = 1.0 - libdevice.pow(b1.to(tl.float64), c).to(tl.float32)
        bc2 = 1.0 - libdevice.pow(b2.to(tl.float64), c).to(tl.float32)
        for t in range(0, TILES):
            idx = (chunk * TILES + t) * BLOCK + tl.arange(0, BLOCK)
            mask = idx < R
            off = row * R + idx
            p = tl.load(p_ptr + off, mask=mask, other=0.0).to(tl.float32)
            g = tl.load(g_ptr + off, mask=mask, other=0.0).to(tl.float32)
            m = tl.load(m_ptr + off, mask=mask, other=0.0)
            v = tl.load(v_ptr + off, mask=mask, other=0.0)
            m2 = b1 * m + omb1 * g
            v2 = b2 * v + omb2 * g * g
            mhat = tl.div_rn(m2, bc1)
            vhat = tl.div_rn(v2, bc2)
            step = lr * (tl.div_rn(mhat, tl.sqrt_rn(vhat) + eps) + wd * p)
            tl.store(p_ptr + off, (p - step).to(p_ptr.dtype.element_ty),
                     mask=mask)
            tl.store(m_ptr + off, m2, mask=mask)
            tl.store(v_ptr + off, v2, mask=mask)


def load():
    """The jitted kernel; imports Triton at first use and raises if it is
    missing."""
    global tl, libdevice, _compiled
    if _compiled is None:
        try:
            import triton
            import triton.language as language
        except ImportError as e:
            raise _build.KernelBuildFailure(
                "the masked AdamW kernel needs the triton package, which is "
                "not installed") from e
        from triton.language.extra import libdevice as ld
        tl, libdevice = language, ld
        _compiled = triton.jit(_masked_adamw)
    return _compiled


def launch(p2d, g2d, m2d, v2d, sel, counts, lr, b1, b2, eps, wd) -> None:
    """p2d, g2d: [L, R] in the param dtype; m2d, v2d: [L, R] f32; sel,
    counts: [L] f32 — contiguous CUDA tensors already checked by
    ``ops.masked_adamw``. Updates p2d, m2d and v2d in place on the current
    stream. The scalars go in as f32, ``1 - b`` rounded once on the host as
    the reference's Python floats are."""
    kernel = load()
    n_rows, r = p2d.shape
    tiles = min(TILES, -(-r // BLOCK))   # a short row: one program per row
    grid = (-(-r // (tiles * BLOCK)), n_rows)
    kernel[grid](p2d, g2d, m2d, v2d, sel, counts, r, float(lr), float(b1),
                 float(b2), 1.0 - float(b1), 1.0 - float(b2), float(eps),
                 float(wd), BLOCK=BLOCK, TILES=tiles, num_warps=8)
