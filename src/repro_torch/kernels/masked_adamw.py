"""Triton block-masked AdamW steps for Hopper (paper Alg. 1 lines 9-13),
dense and banked.

``_masked_adamw`` replaces the TPU kernel ``_kernel`` of the JAX package's
``kernels/masked_adamw.py``: over a stacked leaf viewed as [L, R], the rows
whose ``sel`` is nonzero take an AdamW step with their own bias-correction
count ``c = max(counts[row], 1)``; the other rows keep p, m and v bit for
bit. p and g are in the parameter dtype, m and v in the moment dtype (f32,
or bf16 under ``OptimizerConfig(moment_dtype="bfloat16")``), the
arithmetic in f32, in the order of the reference's XLA path
(``core/masked_adamw.py`` ``_adamw_rows``): m and v are widened on load,
the new m and v stay f32 through the bias correction and the parameter
step, and are rounded to the moment dtype only when stored. Triton's
``.to(tl.bfloat16)`` rounds to nearest even (``cvt.rn.bf16.f32``), as
XLA's convert does. The compiler may contract ``b1 * m + omb1 * g`` into
an FMA, so an f32 moment can differ from the plain version's in its last
bit, and a bf16 one by one bf16 ulp (more only where the sum cancels to
near zero). Triton compiles one variant per pointer dtype, so the f32 and
bf16 moments share this source; ``ops.py`` counts their launches apart.

``_banked_masked_adamw`` replaces ``_banked_kernel`` (banked residency,
paper §3.3): m and v are [cap, R] banks whose row i holds the moments of
leaf row ``slots[i]``. The program of bank row i reads ``slots[i]`` itself
and works on p and g row ``slots[i]`` in place, so no [cap, R] gather of p
or g and no scatter back is made. A free slot (``slots[i] >= L``) or a row
with sel = 0 is neither loaded nor stored. The reference clamps free slots
onto row L - 1 and drops that row in a scatter, which its TPU grid needed;
here a program just stops. Both kernels call one tile body
(``_adamw_tile``) and one bias correction (``_bias_corrections``), so the
banked step gives the same bits as the dense one on the same rows.

It is bound by memory: a selected element reads p, g, m, v and writes p, m,
v (3 x 2 + 16 = 22 bytes at bf16 params and f32 moments, 3 x 2 + 8 = 14
with bf16 moments) with ~15 flops between. The kernel
updates p, m and v in place (the reference returns new arrays), so it moves
nothing else; the banked kernel moves the same bytes for the same selected
rows. One program per (``TILES * BLOCK`` elements, row) walks its
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
# the jitted helpers the kernels call, bound at the first launch
_bias_corrections = None
_adamw_tile = None
_compiled = None
_compiled_banked = None


def _bias_corrections_fn(cnt, b1, b2):
    # b^c in f64, rounded once to f32: the f32 bias correction 1 - b^c
    # (of order 1e-3 for b2) magnifies any error of b^c ~1000x
    c = tl.maximum(cnt, 1.0).to(tl.float64)
    bc1 = 1.0 - libdevice.pow(b1.to(tl.float64), c).to(tl.float32)
    bc2 = 1.0 - libdevice.pow(b2.to(tl.float64), c).to(tl.float32)
    return bc1, bc2


def _adamw_tile_fn(p_ptrs, g_ptrs, m_ptrs, v_ptrs, mask, lr, b1, b2, omb1,
                   omb2, eps, wd, bc1, bc2):
    p = tl.load(p_ptrs, mask=mask, other=0.0).to(tl.float32)
    g = tl.load(g_ptrs, mask=mask, other=0.0).to(tl.float32)
    m = tl.load(m_ptrs, mask=mask, other=0.0).to(tl.float32)
    v = tl.load(v_ptrs, mask=mask, other=0.0).to(tl.float32)
    m2 = b1 * m + omb1 * g
    v2 = b2 * v + omb2 * g * g
    mhat = tl.div_rn(m2, bc1)
    vhat = tl.div_rn(v2, bc2)
    step = lr * (tl.div_rn(mhat, tl.sqrt_rn(vhat) + eps) + wd * p)
    tl.store(p_ptrs, (p - step).to(p_ptrs.dtype.element_ty), mask=mask)
    # rounded to the moment dtype only here (to nearest even for bf16)
    tl.store(m_ptrs, m2.to(m_ptrs.dtype.element_ty), mask=mask)
    tl.store(v_ptrs, v2.to(v_ptrs.dtype.element_ty), mask=mask)


def _masked_adamw(p_ptr, g_ptr, m_ptr, v_ptr, sel_ptr, cnt_ptr, R,
                  lr, b1, b2, omb1, omb2, eps, wd, BLOCK: "tl.constexpr",
                  TILES: "tl.constexpr"):
    chunk = tl.program_id(0).to(tl.int64)
    row = tl.program_id(1).to(tl.int64)
    sel = tl.load(sel_ptr + row)
    if sel > 0:
        bc1, bc2 = _bias_corrections(tl.load(cnt_ptr + row), b1, b2)
        for t in range(0, TILES):
            idx = (chunk * TILES + t) * BLOCK + tl.arange(0, BLOCK)
            off = row * R + idx
            _adamw_tile(p_ptr + off, g_ptr + off, m_ptr + off, v_ptr + off,
                        idx < R, lr, b1, b2, omb1, omb2, eps, wd, bc1, bc2)


def _banked_masked_adamw(p_ptr, g_ptr, m_ptr, v_ptr, slots_ptr, sel_ptr,
                         cnt_ptr, L, R, lr, b1, b2, omb1, omb2, eps, wd,
                         BLOCK: "tl.constexpr", TILES: "tl.constexpr"):
    chunk = tl.program_id(0).to(tl.int64)
    i = tl.program_id(1).to(tl.int64)          # bank row
    s = tl.load(slots_ptr + i).to(tl.int64)    # leaf row it holds
    sel = tl.load(sel_ptr + i)
    if (s < L) & (sel > 0):
        bc1, bc2 = _bias_corrections(tl.load(cnt_ptr + i), b1, b2)
        for t in range(0, TILES):
            idx = (chunk * TILES + t) * BLOCK + tl.arange(0, BLOCK)
            off = s * R + idx
            bank = i * R + idx
            _adamw_tile(p_ptr + off, g_ptr + off, m_ptr + bank,
                        v_ptr + bank, idx < R, lr, b1, b2, omb1, omb2, eps,
                        wd, bc1, bc2)


def load():
    """The jitted kernels (dense, banked); imports Triton at first use and
    raises if it is missing."""
    global tl, libdevice, _bias_corrections, _adamw_tile, _compiled, \
        _compiled_banked
    if _compiled is None:
        try:
            import triton
            import triton.language as language
        except ImportError as e:
            raise _build.KernelBuildFailure(
                "the masked AdamW kernels need the triton package, which is "
                "not installed") from e
        from triton.language.extra import libdevice as ld
        tl, libdevice = language, ld
        _bias_corrections = triton.jit(_bias_corrections_fn)
        _adamw_tile = triton.jit(_adamw_tile_fn)
        _compiled_banked = triton.jit(_banked_masked_adamw)
        _compiled = triton.jit(_masked_adamw)
    return _compiled, _compiled_banked


def _grid(r: int, n_rows: int):
    tiles = min(TILES, -(-r // BLOCK))   # a short row: one program per row
    return (-(-r // (tiles * BLOCK)), n_rows), tiles


def _scalars(lr, b1, b2, eps, wd):
    """The scalars as f32 kernel arguments, ``1 - b`` rounded once on the
    host as the reference's Python floats are."""
    return (float(lr), float(b1), float(b2), 1.0 - float(b1),
            1.0 - float(b2), float(eps), float(wd))


def launch(p2d, g2d, m2d, v2d, sel, counts, lr, b1, b2, eps, wd):
    """p2d, g2d: [L, R] in the param dtype; m2d, v2d: [L, R] f32 or bf16;
    sel, counts: [L] f32 — contiguous CUDA tensors already checked by
    ``ops.masked_adamw``. Updates p2d, m2d and v2d in place on the current
    stream; returns Triton's compiled kernel (its ``asm`` holds the PTX)."""
    kernel, _ = load()
    n_rows, r = p2d.shape
    grid, tiles = _grid(r, n_rows)
    return kernel[grid](p2d, g2d, m2d, v2d, sel, counts, r,
                        *_scalars(lr, b1, b2, eps, wd), BLOCK=BLOCK,
                        TILES=tiles, num_warps=8)


def launch_banked(p2d, g2d, m2d, v2d, slots, sel, counts, lr, b1, b2, eps,
                  wd):
    """p2d, g2d: [L, R] in the param dtype; m2d, v2d: [cap, R] banks (f32 or
    bf16); slots: [cap] int32; sel, counts: [cap] f32 — contiguous CUDA
    tensors already checked by ``ops.banked_masked_adamw``. Updates the p rows
    ``slots[i]`` (sel[i] > 0, slots[i] < L) and bank rows i of m2d and v2d
    in place on the current stream; returns Triton's compiled kernel."""
    _, kernel = load()
    n_leaf, r = p2d.shape
    grid, tiles = _grid(r, m2d.shape[0])
    return kernel[grid](p2d, g2d, m2d, v2d, slots, sel, counts, n_leaf, r,
                        *_scalars(lr, b1, b2, eps, wd), BLOCK=BLOCK,
                        TILES=tiles, num_warps=8)
