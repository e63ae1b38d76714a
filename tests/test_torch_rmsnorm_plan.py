"""The RMSNorm forward's launch plan (``rmsnorm.fwd_plan``), on the CPU.

The CUDA C++ forward (``csrc/rmsnorm.cu``) runs only on the card, so what
can be checked here is the plan the launcher hands it: the instance (16-byte
vectors fed by bulk copies, or the vector-width-1 instance for an unaligned
base or a width that is not a multiple of the vector), warps a row, row
groups a block, ring stages, shared bytes and blocks. It is checked at every
registered arch's d_model and at odd widths, in f32 and bf16, aligned and
not, from one row to 65536. No JAX here; the kernel's arithmetic is held
against its plain version on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.
"""
import numpy as np
import pytest

from repro_torch.kernels import rmsnorm as rn

SMS = 132   # an H100's SMs
ARCH_D = (896, 2048, 3072, 4096, 5120)   # the registered archs' d_model
ODD_D = (1, 7, 8, 895, 4097, 8192)
NS = (1, 4, 1023, 8192, 65536)


def _lanes(plan, d):
    """Vectors (or elements) a lane holds of a row."""
    return -(-(d // plan.vec) // (32 * plan.warps))


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("d", ARCH_D + ODD_D)
def test_fwd_plan(d, itemsize, aligned, n):
    """Each lane holds at most 8 vectors, with the fewest warps that allow
    it (f32 vectors: the earlier forward's max(1, 2^ceil(log2 d) / 1024));
    a block fits the kernel's threads, named barriers and shared
    memory; the ring's stages hold rows of 16-byte multiples; the blocks'
    row groups, striding by their number, cover every row exactly once and
    no block is empty; and the grid is at most one wave."""
    p = rn.fwd_plan(n, d, itemsize, aligned, SMS)
    full = 16 // itemsize
    assert p.vec == (full if aligned and d % full == 0 else 1)
    assert _lanes(p, d) <= rn.MAX_VEC_PER_LANE
    if p.vec == 4:   # f32 vectors: the earlier forward's layout
        assert p.warps == max(1, rn._pow2(d) // 1024)
    else:            # the fewest warps
        assert p.warps == 1 or -(-(d // p.vec) // (32 * (p.warps - 1))) \
            > rn.MAX_VEC_PER_LANE
    threads = 32 * p.warps * p.rows
    assert threads <= (rn.MAX_BULK_THREADS if p.vec > 1 else rn.MAX_THREADS)
    assert 1 <= p.rows <= 15
    assert p.smem == rn._smem(d, itemsize, p.warps, p.rows, p.stages)
    assert p.smem <= rn.MAX_SMEM == 232448
    if p.vec > 1:
        assert p.stages == rn.FWD_STAGES == 3
        assert d * itemsize % 16 == 0
    else:
        assert p.stages == 0
    g = p.blocks * p.rows
    seen = np.zeros(n, np.int64)
    firsts = np.arange(g)
    for k in range(-(-n // g)):
        rows = firsts + k * g
        np.add.at(seen, rows[rows < n], 1)
    assert (seen == 1).all()
    assert (p.blocks - 1) * p.rows < n   # the last block has a row
    assert p.blocks <= SMS * (rn.SM_THREADS // threads)


@pytest.mark.parametrize("itemsize, want", [
    (2, {896: 1, 2048: 1, 3072: 2, 4096: 2, 5120: 3, 8192: 4}),
    (4, {896: 1, 2048: 2, 3072: 4, 4096: 4, 5120: 8, 8192: 8})])
def test_fwd_plan_warps_at_the_archs_widths(itemsize, want):
    """Rows at their exact width: bf16 takes one warp up to D 2048, two at
    3072 and 4096, three at 5120, four at 8192; f32 one per 1024 of the
    row padded to a power of two. At the training path's [8192, 896] in bf16 a block holds 8 row
    groups of one warp and each a ring of 3 rows; at [1024, 8192] in f32
    one group of 8 warps and 3 stages of 32 KB."""
    for d, w in want.items():
        assert rn.fwd_plan(4096, d, itemsize, True, SMS).warps == w
    p = rn.fwd_plan(8192, 896, 2, True, SMS)
    assert (p.vec, p.warps, p.rows, p.stages) == (8, 1, 8, 3)
    p = rn.fwd_plan(1024, 8192, 4, True, SMS)
    assert (p.vec, p.warps, p.rows, p.stages) == (4, 8, 1, 3)
    assert p.smem == 32 + 256 + 4 * 8192 + 3 * 4 * 8192


def test_fwd_plan_spreads_few_rows_over_the_sms():
    """A decode row block ([4, D]) takes a block a row on 4 SMs."""
    for d in ARCH_D:
        p = rn.fwd_plan(4, d, 2, True, SMS)
        assert (p.rows, p.blocks) == (1, 4)
