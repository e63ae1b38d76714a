"""The port's kernels against the JAX package's.

On the CPU the port's wrappers run their plain PyTorch versions; those are
held against the JAX oracles (``repro.kernels.ref``) and the Pallas kernels
in interpret mode, over the sweep of ``tests/test_kernels.py`` (page sizes
4/8/16, scrambled tables with sentinels, mixed valid_len, f32 and bf16; the
dense decode's S and valid_len, on an unexpanded cache and a head map; its
block-norm and masked-AdamW shapes) at its tolerances. The RMSNorm
backward, which has no Pallas kernel, is held against ``jax.vjp`` of the
JAX package's ``norms.apply``. The CUDA/Triton kernels themselves are
compared with the plain versions on the card by ``tests/test_torch_cuda.py``
and ``chip_smoke.py``.
"""
import contextlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import partition as jpart
from repro.kernels import decode_attention as jdec
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import rmsnorm as jrms
from repro.models.layers import norms as jnorms
from repro_torch.kernels import ops, ref

TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
NUMPY = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}


def _tol(dtype):
    """tests/test_kernels.py::_tol."""
    return (dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16"
            else dict(rtol=1e-5, atol=1e-5))


def _pair(x: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor (bf16 rounded once,
    on the numpy side, so both get identical bits)."""
    xn = np.asarray(x, np.float32).astype(NUMPY[dtype])
    t = torch.from_numpy(np.asarray(xn, np.float32)).to(TORCH[dtype])
    return jnp.asarray(xn), t


def _as_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _paged_case(seed, b, h, kvh, d, ps, maxp, num_pages, vl, hmap, dtype):
    """q = 3 N(0, 1) against N(0, 1) keys: scores of spread 3 give a peaked
    softmax, so every output row stays near the size of a V row and is
    large beside the bf16 tolerance (see ``_assert_strong``)."""
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((num_pages, ps, kvh, d))
    v = rng.standard_normal((num_pages, ps, kvh, d))
    q = 3 * rng.standard_normal((b, h, d))
    perm = rng.permutation(num_pages)
    tbl = np.full((b, maxp), num_pages, np.int32)   # sentinel-filled
    used = 0
    for i in range(b):
        n = -(-int(vl[i]) // ps)
        tbl[i, :n] = perm[used:used + n]
        used += n
    ints = dict(tbl=tbl, vl=np.asarray(vl, np.int32),
                hmap=np.asarray(hmap, np.int32))
    return _pair(q, dtype), _pair(k, dtype), _pair(v, dtype), ints


def _assert_strong(want, dtype):
    """The comparison has power: every row of the expected output has an RMS
    of at least 10 tol, so an all-zero or flat-average output would fail."""
    w = _as_np(want)
    rms = np.sqrt((w.reshape(w.shape[0], -1) ** 2).mean(axis=1))
    assert (rms >= 10 * _tol(dtype)["atol"]).all(), rms


def _run_paged(case):
    (qj, qt), (kj, kt), (vj, vt), ints = case
    b, h, d = qt.shape
    tt = {n: torch.from_numpy(a) for n, a in ints.items()}
    out = ops.paged_decode_attention(qt.view(b, 1, h, d), kt, vt, tt["tbl"],
                                     tt["vl"], tt["hmap"]).view(b, h, d)
    ja = [jnp.asarray(ints[n]) for n in ("tbl", "vl", "hmap")]
    oracle = jref.paged_decode_attention(qj, kj, vj, *ja)
    pallas = jdec.paged_decode_attention(qj, kj, vj, *ja, interpret=True)
    return out, oracle, pallas


@pytest.mark.parametrize("ps", [4, 8, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_decode_sweep_vs_jax(ps, dtype):
    """Scrambled page tables with sentinel entries, per-row valid_len (one
    position, partial pages, full table) and a GQA hmap: the port's plain
    version matches the JAX oracle and the Pallas kernel."""
    num_pages, maxp = 20, 5
    case = _paged_case(7, 3, 4, 2, 64, ps, maxp, num_pages,
                       [1, 2 * ps + 1, maxp * ps], [0, 0, 1, 1], dtype)
    out, oracle, pallas = _run_paged(case)
    assert out.dtype == TORCH[dtype]
    _assert_strong(oracle, dtype)
    np.testing.assert_allclose(_as_np(out), _as_np(oracle), **_tol(dtype))
    np.testing.assert_allclose(_as_np(out), _as_np(pallas), **_tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_decode_qwen_heads_vs_jax(dtype):
    """The serving slice's head layout: 16 padded q heads over 2 kv heads
    (hmap [0]*7 + [1]*9, the padded heads clamped onto kv head 1), D=64,
    page 16, valid_len 1 .. a full 8-page row."""
    hmap = np.minimum(np.arange(16) // 7, 1)
    case = _paged_case(3, 4, 16, 2, 64, 16, 8, 40, [1, 17, 64, 128], hmap,
                       dtype)
    out, oracle, pallas = _run_paged(case)
    _assert_strong(oracle, dtype)
    np.testing.assert_allclose(_as_np(out), _as_np(oracle), **_tol(dtype))
    np.testing.assert_allclose(_as_np(out), _as_np(pallas), **_tol(dtype))


# the 32-head layouts rows 1 and 3 take: llama3.2-1b (32 q / 8 kv heads, D
# 64) and phi4-mini (24 q heads padded to 32, the padded ones clamped onto
# kv head 7, D 128)
WIDE_HMAPS = {64: np.arange(32) // 4, 128: np.minimum(np.arange(32) // 3, 7)}


@pytest.mark.parametrize("ps", [4, 16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_decode_32_heads_vs_jax(ps, d, dtype):
    """32 q heads on 8 kv heads at head dim 64 and 128: the port's plain
    version against the JAX oracle and the Pallas kernel (interpret mode);
    valid_len one position, a partial page and the full table."""
    maxp = 48 // ps
    case = _paged_case(9, 3, 32, 8, d, ps, maxp, 3 * maxp + 2,
                       [1, ps + 3, maxp * ps], WIDE_HMAPS[d], dtype)
    out, oracle, pallas = _run_paged(case)
    assert out.dtype == TORCH[dtype] and out.shape == (3, 32, d)
    _assert_strong(oracle, dtype)
    np.testing.assert_allclose(_as_np(out), _as_np(oracle), **_tol(dtype))
    np.testing.assert_allclose(_as_np(out), _as_np(pallas), **_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ps, maxp", [(16, 32), (16, 128), (4, 3), (1, 700)])
def test_paged_launch_splits_as_the_gathered_view(monkeypatch, dtype, ps,
                                                  maxp):
    """Row 1's launcher splits a row's positions as row 3's splits the dense
    view its tables gather (S = max_pages * page_size), so the two give the
    same bits: the split and the workspace each passes to its kernel,
    recorded from stand-ins for the library's entry points."""
    from repro_torch.kernels import decode_attention as dec
    calls = {}

    def entry(name, n_ptrs):
        def fn(*args):
            calls[name] = args[n_ptrs:]
            return 0
        return fn
    monkeypatch.setattr(dec, "load", lambda: (
        entry("dense", 8), entry("paged", 9), None))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: type("S", (), {"cuda_stream": 0}))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    b, h, kvh, d = 2, 16, 2, 64
    q, out = torch.zeros(b, h, d, dtype=dtype), torch.zeros(b, h, d,
                                                             dtype=dtype)
    pool = torch.zeros(5, ps, kvh, d, dtype=dtype)
    tbl = torch.zeros(b, maxp, dtype=torch.int32)
    vl, hm = torch.ones(b, dtype=torch.int32), torch.zeros(h,
                                                           dtype=torch.int32)
    dec.launch_paged(q, pool, pool, tbl, vl, hm, out)
    view = torch.zeros(b, maxp * ps, kvh, d, dtype=dtype)
    dec.launch(q, view, view, vl, hm, out)
    # paged: B, H, KVH, num_pages, ps, max_pages, D, n_split; dense: B, H,
    # KVH, S, D, n_split
    n = dec.decode_splits(dtype, maxp * ps)
    assert calls["paged"][7] == calls["dense"][5] == n
    assert calls["paged"][:3] == calls["dense"][:3] == (b, h, kvh)
    assert calls["paged"][6] == calls["dense"][4] == d
    assert calls["paged"][8:] == calls["dense"][6:]   # scale, dtype, stream


# 5 q heads on 2 kv heads, the last one a padded head clamped onto kv head 1
DENSE_HMAP = np.asarray([0, 0, 1, 1, 1], np.int32)
# one compile a shape instead of one for each of the oracle's ops
_dense_oracle = jax.jit(jref.decode_attention)


@pytest.mark.parametrize("s, valid", [
    (512, 100), (1024, 1024), (2048, 7), (512, (1, 100, 512)),
    (1024, (7, 1024, 333))])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_decode_vs_jax(s, valid, dtype):
    """Row 3 at the shapes of tests/test_kernels.py::TestDecodeAttention,
    scalar and per-row valid_len: the port's plain version on the
    unexpanded [B, S, KVH, D] cache read through a GQA map with a padded
    head, against the JAX oracle and the Pallas kernel (interpret mode) on
    the head-expanded, folded [B*H, S, D] view of the same cache. q = 3
    N(0, 1) against N(0, 1) keys: a peaked softmax (see ``_paged_case``)."""
    per_row = isinstance(valid, tuple)
    b, h, kvh, d = (len(valid) if per_row else 2), 5, 2, 64
    rng = np.random.default_rng(11)
    qj, qt = _pair(3 * rng.standard_normal((b, h, d)), dtype)
    kj, kt = _pair(rng.standard_normal((b, s, kvh, d)), dtype)
    vj, vt = _pair(rng.standard_normal((b, s, kvh, d)), dtype)
    vl = (torch.tensor(valid, dtype=torch.int32) if per_row else valid)
    out = ops.decode_attention(qt.view(b, 1, h, d), kt, vt, vl,
                               torch.from_numpy(DENSE_HMAP))
    assert out.dtype == TORCH[dtype] and out.shape == (b, 1, h, d)
    out = out.view(b, h, d)

    def expand(t):   # [B, S, KVH, D] -> [B, H, S, D]
        return t[:, :, DENSE_HMAP].transpose(0, 2, 1, 3)
    jvl = jnp.asarray(valid, jnp.int32)
    oracle = _dense_oracle(qj, expand(kj), expand(vj), jvl)
    pallas = jdec.decode_attention(
        qj.reshape(b * h, d), expand(kj).reshape(b * h, s, d),
        expand(vj).reshape(b * h, s, d),
        jnp.repeat(jvl, h) if per_row else jvl,
        interpret=True).reshape(b, h, d)
    _assert_strong(oracle, dtype)
    np.testing.assert_allclose(_as_np(out), _as_np(oracle), **_tol(dtype))
    np.testing.assert_allclose(_as_np(out), _as_np(pallas), **_tol(dtype))


def test_dense_decode_plain_matches_the_paged_plain_version():
    """On a gathered view: the dense plain version on the pool pages a
    table points to, laid out as a dense cache, equals the paged plain
    version on the pool (the CPU half of
    tests/test_kernels.py::test_matches_dense_kernel_on_gathered_view)."""
    hmap = np.minimum(np.arange(16) // 7, 1)
    (_, qt), (_, kt), (_, vt), ints = _paged_case(
        5, 3, 16, 2, 64, 16, 6, 30, [1, 40, 96], hmap, "float32")
    tt = {n: torch.from_numpy(a) for n, a in ints.items()}
    b, h, d = qt.shape
    paged = ops.paged_decode_attention(qt.view(b, 1, h, d), kt, vt,
                                       tt["tbl"], tt["vl"], tt["hmap"])
    rows = tt["tbl"].long().clamp(max=kt.shape[0] - 1)

    def gathered(pool):   # [B, max_pages * page_size, KVH, D]
        return pool[rows].reshape(b, -1, *pool.shape[2:]).contiguous()
    dense = ops.decode_attention(qt.view(b, 1, h, d), gathered(kt),
                                 gathered(vt), tt["vl"], tt["hmap"])
    assert dense.dtype == paged.dtype and dense.shape == paged.shape
    np.testing.assert_allclose(dense.numpy(), paged.numpy(), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("shape", [(16, 64), (8, 896), (24, 100)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_vs_jax(shape, dtype):
    rng = np.random.default_rng(1)
    xj, xt = _pair(2 * rng.standard_normal(shape), dtype)
    sj, st = _pair(1 + 0.1 * rng.standard_normal(shape[-1]), dtype)
    out = ops.rmsnorm(xt, st, 1e-6)
    assert out.dtype == xt.dtype and out.shape == xt.shape
    np.testing.assert_allclose(_as_np(out), _as_np(jref.rmsnorm(xj, sj, 1e-6)),
                               **_tol(dtype))
    np.testing.assert_allclose(
        _as_np(out), _as_np(jrms.rmsnorm(xj, sj, 1e-6, interpret=True)),
        **_tol(dtype))


def test_cpu_path_launches_no_kernel():
    """CPU tensors take the plain versions: no launch is counted."""
    before = dict(ops.LAUNCHES)
    x = torch.randn(4, 32)
    torch.testing.assert_close(ops.rmsnorm(x, torch.ones(32)),
                               ref.rmsnorm(x, torch.ones(32)))
    assert ops.LAUNCHES == before


# ------------------------------------------------ training kernels (rows 7, 8, 2b)


@pytest.mark.parametrize("shape", [(3, 100), (2, 64, 65), (5, 7, 9, 11),
                                   (1, 2048), (4, 4096)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_grad_sq_norms_vs_jax(shape, dtype):
    """The sweep of tests/test_kernels.py::TestBlockGradNorm: the port's
    plain version against the JAX oracle and the Pallas kernel (interpret
    mode, through ``ops`` which pads rows to its chunk). Both sum exact
    squares in f32, so the tolerance is f32's whatever the input type."""
    rng = np.random.default_rng(2)
    gj, gt = _pair(0.5 + 2 * rng.standard_normal(shape), dtype)
    out = ops.block_grad_sq_norms(gt)
    assert out.dtype == torch.float32 and out.shape == (shape[0],)
    for want in (jref.block_grad_sq_norms(gj), jops.block_grad_sq_norms(gj)):
        np.testing.assert_allclose(_as_np(out), _as_np(want), rtol=1e-5)


@pytest.mark.parametrize("shape", [(4, 100), (2, 32, 9), (3, 2048)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masked_adamw_vs_jax(shape, dtype):
    """The sweep of tests/test_kernels.py::TestMaskedAdamW: the port's
    wrapper on CPU tensors (the plain version, written back in place)
    against the JAX oracle and the Pallas kernel in interpret mode; rows
    with sel = 0 keep their bits."""
    rng = np.random.default_rng(3)
    nl = shape[0]
    pj, pt = _pair(rng.standard_normal(shape), dtype)
    gj, gt = _pair(0.5 + rng.standard_normal(shape), dtype)
    mj, mt = _pair(0.05 + 0.1 * rng.standard_normal(shape), "float32")
    vj, vt = _pair(0.01 + 0.01 * np.abs(rng.standard_normal(shape)),
                   "float32")
    sel = (np.arange(nl) % 2).astype(np.float32)
    cnt = np.arange(1, nl + 1, dtype=np.float32)
    args = (0.3, 0.9, 0.999, 1e-8, 0.1)
    # the port updates in place: work on copies (a CPU tensor from numpy
    # may share its memory with the JAX array made from the same numpy)
    p0, m0, v0 = pt, mt, vt
    pt, mt, vt = pt.clone(), mt.clone(), vt.clone()
    out = ops.masked_adamw(pt, gt, mt, vt, torch.from_numpy(sel),
                           torch.from_numpy(cnt), *args)
    assert out[0] is pt and out[1] is mt and out[2] is vt
    flat = lambda t: t.reshape(nl, -1)  # noqa: E731
    oracle = jref.masked_adamw(flat(pj), flat(gj), flat(mj), flat(vj),
                               jnp.asarray(sel), jnp.asarray(cnt), *args)
    pallas = jops.masked_adamw(pj, gj, mj, vj, jnp.asarray(sel),
                               jnp.asarray(cnt), *args)
    for want in (oracle, [flat(w) for w in pallas]):
        np.testing.assert_allclose(_as_np(flat(pt)), _as_np(want[0]),
                                   **_tol(dtype))
        for got, w in ((mt, want[1]), (vt, want[2])):
            np.testing.assert_allclose(_as_np(flat(got)), _as_np(w),
                                       **_tol("float32"))
    off = torch.from_numpy(sel == 0)
    for new, old in ((pt, p0), (mt, m0), (vt, v0)):
        assert torch.equal(flat(new)[off], flat(old)[off])
    moved = (flat(pt).float() - flat(p0).float())[~off].abs().max()
    assert moved > 5 * _tol(dtype)["atol"]


# bank slots per sweep shape: real rows out of order and a free slot (= L)
BANK_SLOTS = {4: [2, 4, 0], 2: [1, 2, 0], 3: [2, 0, 3]}


@pytest.mark.parametrize("shape", [(4, 100), (2, 32, 9), (3, 2048)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_banked_masked_adamw_vs_jax(shape, dtype):
    """Row 9 at the sweep of tests/test_kernels.py::TestMaskedAdamW: the
    port's wrapper on CPU tensors (the plain version, in place) against the
    JAX package's Pallas banked kernel in interpret mode, whose p rows are
    scattered back with the reference's drop semantics. The free slot has
    sel = 0 (the reference needs it); one real slot has sel = 0 too. Leaf
    rows no slot selects, the free slot's bank row and the unselected bank
    row keep their bits."""
    rng = np.random.default_rng(4)
    nl = shape[0]
    slots = np.asarray(BANK_SLOTS[nl], np.int32)
    cap = len(slots)
    bank = (cap,) + shape[1:]
    pj, pt = _pair(rng.standard_normal(shape), dtype)
    gj, gt = _pair(0.5 + rng.standard_normal(shape), dtype)
    mj, mt = _pair(0.05 + 0.1 * rng.standard_normal(bank), "float32")
    vj, vt = _pair(0.01 + 0.01 * np.abs(rng.standard_normal(bank)),
                   "float32")
    sel = np.where(slots < nl, 1.0, 0.0).astype(np.float32)
    sel[0] = 0.0    # one real slot unselected
    cnt = np.arange(1, cap + 1, dtype=np.float32)
    args = (0.3, 0.9, 0.999, 1e-8, 0.1)
    p0, m0, v0 = pt, mt, vt
    pt, mt, vt = pt.clone(), mt.clone(), vt.clone()
    out = ops.banked_masked_adamw(pt, gt, mt, vt, torch.from_numpy(slots),
                                  torch.from_numpy(sel),
                                  torch.from_numpy(cnt), *args)
    assert out[0] is pt and out[1] is mt and out[2] is vt
    p_rows, m2, v2 = jops.banked_masked_adamw(
        pj, gj, mj, vj, jnp.asarray(slots), jnp.asarray(sel),
        jnp.asarray(cnt), *args)
    want_p = jpart.scatter_rows(pj, jnp.asarray(slots), p_rows)
    np.testing.assert_allclose(_as_np(pt), _as_np(want_p), **_tol(dtype))
    for got, w in ((mt, m2), (vt, v2)):
        np.testing.assert_allclose(_as_np(got), _as_np(w),
                                   **_tol("float32"))
    on = (slots < nl) & (sel > 0)
    touched = torch.zeros(nl, dtype=torch.bool)
    touched[slots[on]] = True
    flat = lambda t: t.reshape(t.shape[0], -1)  # noqa: E731
    assert torch.equal(flat(pt)[~touched], flat(p0)[~touched])
    off = torch.from_numpy(~on)
    for new, old in ((mt, m0), (vt, v0)):
        assert torch.equal(flat(new)[off], flat(old)[off])
    moved = (flat(pt).float() - flat(p0).float())[touched].abs().max()
    assert moved > 5 * _tol(dtype)["atol"]


@pytest.mark.parametrize("shape", [(16, 64), (8, 896), (3, 5, 100)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_bwd_vs_jax(shape, dtype):
    """The RMSNorm backward's plain version against ``jax.grad`` of the JAX
    package's ``norms.apply`` (which XLA differentiates) under the same
    output gradient."""
    rng = np.random.default_rng(4)
    mu = 1 + 0.5 * rng.standard_normal(shape[-1])
    xj, xt = _pair(mu + rng.standard_normal(shape), dtype)
    sj, st = _pair(1 + 0.1 * rng.standard_normal(shape[-1]), dtype)
    dyj, dyt = _pair(1 + rng.standard_normal(shape), dtype)
    dx, ds = ops.rmsnorm_bwd(dyt, xt, st, 1e-6)
    assert dx.dtype == xt.dtype and ds.dtype == st.dtype
    _, vjp = jax.vjp(lambda x, s: jnorms.apply({"scale": s}, x, 1e-6), xj,
                     sj)
    jdx, jds = vjp(dyj)
    _assert_strong(jdx.reshape(-1, shape[-1]), dtype)
    np.testing.assert_allclose(_as_np(dx), _as_np(jdx), **_tol(dtype))
    # dscale sums over rows: compare relative to its size
    np.testing.assert_allclose(_as_np(ds), _as_np(jds), rtol=_tol(dtype)[
        "rtol"], atol=_tol(dtype)["atol"] * np.abs(_as_np(jds)).max())


@pytest.mark.parametrize("sms", [1, 8, 132])
@pytest.mark.parametrize("n, d", [(1, 896), (4, 896), (33, 64), (4096, 896),
                                  (8192, 896), (4097, 1024), (100000, 896),
                                  (4096, 2048), (4096, 3072)])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_rmsnorm_bwd_grid_covers_every_row_once(n, d, sms, itemsize):
    """Row 2b's row pass: at most 2 programs (partial rows of dscale) an
    SM, each a contiguous run of whole power-of-two tiles, every row in
    exactly one run, no run empty."""
    from repro_torch.kernels import rmsnorm as rn
    progs, rows, tile = rn.bwd_grid(n, d, sms, itemsize)
    assert 1 <= progs <= 2 * sms
    assert tile & (tile - 1) == 0 and rows % tile == 0
    assert tile * rn._pow2(d) * itemsize <= rn.BWD_TILE_BYTES or tile == 1
    seen = np.zeros(n, np.int64)
    for p in range(progs):
        lo, hi = p * rows, min(n, (p + 1) * rows)
        assert lo < hi
        seen[lo:hi] += 1
    assert (seen == 1).all()
