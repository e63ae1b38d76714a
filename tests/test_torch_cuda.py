"""The port's CUDA and Triton kernels against their plain PyTorch versions,
on the card. Marked ``cuda``; without a CUDA device every case skips. This
file imports nothing of JAX, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The sweep follows ``tests/test_kernels.py``: page sizes 4/8/16, scrambled
tables with sentinel entries, mixed valid_len (one position, partial pages,
full rows), the qwen2.5-0.5b head map, f32 and bf16 at its tolerances. The
training kernels (block gradient norms, masked AdamW, RMSNorm backward) are
checked on ragged rows, with bit-identical unselected AdamW rows and
bit-reproducible norms, on inputs whose outputs are large beside the
tolerance. The banked masked AdamW (row 9) is held against its plain
version and, bit for bit, against row 8 on the same rows. Tied scores in
``topk_mask`` go to the lower index on the card too, and three dense
training steps with their batch uploads make no host sync. The flash
attention kernels (rows 4-6) are swept over the S of the JAX package's
flash tests (128/256/384), its packed segment layout, a ragged S and head
dim 128, causal and not, with bit-reproducible dk/dv; in f32 a peaked
softmax is held against an f64 evaluation. Three packed training steps
make no host sync either. The smoke config runs at head dim 64 here: the flash
kernels take 64 and 128.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
       torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
QWEN_HMAP = np.minimum(np.arange(16) // 7, 1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run "
                    "`python -m pytest -m cuda tests/test_torch_cuda.py`")
    return torch.device("cuda")


def _paged_inputs(dev, dtype, ps, vlens, maxp, h=16, kvh=2, d=64,
                  hmap=QWEN_HMAP, seed=5):
    rng = np.random.default_rng(seed)
    b = len(vlens)
    num_pages = b * maxp + 3
    k = rng.standard_normal((num_pages, ps, kvh, d))
    v = rng.standard_normal((num_pages, ps, kvh, d))
    q = 3 * rng.standard_normal((b, 1, h, d))   # peaked softmax: see _close
    perm = rng.permutation(num_pages)
    tbl = np.full((b, maxp), num_pages, np.int32)
    used = 0
    for i, n_pos in enumerate(vlens):
        n = -(-n_pos // ps)
        tbl[i, :n] = perm[used:used + n]
        used += n
    f = [torch.tensor(a, dtype=dtype, device=dev) for a in (q, k, v)]
    i32 = [torch.tensor(a, dtype=torch.int32, device=dev)
           for a in (tbl, vlens, hmap)]
    return (*f, *i32)


def _close(out, plain, dtype):
    """out within the tolerance of plain, on outputs whose every row has an
    RMS of at least 10 atol, so that zeros or a flat average would fail."""
    rms = plain.float().reshape(plain.shape[0], -1).pow(2).mean(1).sqrt()
    assert (rms >= 10 * TOL[dtype]["atol"]).all(), rms
    torch.testing.assert_close(out.float(), plain.float(), **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("ps", [4, 8, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_matches_plain(cuda_device, ps, dtype):
    maxp = 128 // ps
    q, k, v, tbl, vl, hm = _paged_inputs(cuda_device, dtype, ps,
                                         [1, ps + 3, 64, 128, 77], maxp)
    n0 = ops.LAUNCHES["paged_decode_attention"]
    out = ops.paged_decode_attention(q, k, v, tbl, vl, hm)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["paged_decode_attention"] == n0 + 1
    assert out.dtype == dtype and out.shape == q.shape
    plain = ref.paged_decode_attention(q[:, 0], k, v, tbl, vl, hm)
    _close(out[:, 0], plain, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("h,kvh", [(16, 2), (16, 1), (4, 4)])
def test_paged_decode_head_maps(cuda_device, h, kvh):
    """The padded-head clamp, the largest group the kernel takes (all 16 q
    heads on one kv head), and MHA."""
    rep = max(1, h // kvh)
    hmap = np.minimum(np.arange(h) // rep, kvh - 1)
    q, k, v, tbl, vl, hm = _paged_inputs(cuda_device, torch.float32, 16,
                                         [300, 1, 512], 32, h=h, kvh=kvh,
                                         hmap=hmap)
    out = ops.paged_decode_attention(q, k, v, tbl, vl, hm)
    plain = ref.paged_decode_attention(q[:, 0], k, v, tbl, vl, hm)
    _close(out[:, 0], plain, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 4, 33, 4096])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_matches_plain(cuda_device, n, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(n)
    x = torch.randn(n, 896, generator=g, device=cuda_device).to(dtype)
    s = (1 + 0.1 * torch.randn(896, generator=g, device=cuda_device)).to(
        dtype)
    n0 = ops.LAUNCHES["rmsnorm"]
    out = ops.rmsnorm(x, s, 1e-6)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["rmsnorm"] == n0 + 1
    torch.testing.assert_close(out.float(), ref.rmsnorm(x, s, 1e-6).float(),
                               **TOL[dtype])


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    q, k, v, tbl, vl, hm = _paged_inputs(cuda_device, torch.float32, 16,
                                         [5, 9], 4)
    with pytest.raises(ValueError, match="int32"):
        ops.paged_decode_attention(q, k, v, tbl.long(), vl, hm)
    with pytest.raises(ValueError, match="dtype"):
        ops.paged_decode_attention(q.bfloat16(), k, v, tbl, vl, hm)
    with pytest.raises(ValueError, match="at most 16 q heads"):
        ops.paged_decode_attention(torch.cat([q, q], 2), k, v, tbl, vl,
                                   torch.cat([hm, hm]))
    with pytest.raises(ValueError, match="contiguous"):
        ops.rmsnorm(torch.ones(8, 4, device=cuda_device).T,
                    torch.ones(8, device=cuda_device))


# ------------------------------------------------ training kernels (rows 7, 8, 2b)


def _bits_equal(a, b):
    """Bit-identical, NaN payloads included."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    ib = {torch.float32: torch.int32, torch.bfloat16: torch.int16}[a.dtype]
    return torch.equal(a.view(ib), b.view(ib))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 100), (2, 64, 65), (5, 7, 9, 11),
                                   (4, 40000), (24, 896)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_grad_sq_norms_matches_plain(cuda_device, shape, dtype):
    """Ragged rows (R not a multiple of the chunk or the tile), several
    chunks per row (40000 > 16384), and two launches with the same bits."""
    g = torch.Generator(device=cuda_device).manual_seed(7)
    x = (0.5 + torch.randn(shape, generator=g, device=cuda_device)).to(dtype)
    n0 = ops.LAUNCHES["block_grad_sq_norms"]
    out = ops.block_grad_sq_norms(x)
    again = ops.block_grad_sq_norms(x)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["block_grad_sq_norms"] == n0 + 2
    assert out.dtype == torch.float32 and out.shape == (shape[0],)
    assert _bits_equal(out, again)
    torch.testing.assert_close(out, ref.block_grad_sq_norms(x),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 100), (2, 32, 9), (3, 2048),
                                   (5, 5000)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_masked_adamw_matches_plain(cuda_device, shape, dtype):
    """In place; rows with sel = 0 keep p, m and v bit for bit; lr = 0.3 so
    the step is large beside the bf16 tolerance."""
    g = torch.Generator(device=cuda_device).manual_seed(11)
    nl = shape[0]

    def rnd(scale=1.0, shift=0.0):
        return shift + scale * torch.randn(shape, generator=g,
                                           device=cuda_device)
    p, grad = rnd().to(dtype), rnd(1.0, 0.5).to(dtype)
    m, v = rnd(0.1, 0.05), rnd(0.01).abs() + 0.01
    sel = torch.tensor([float(i % 2 == 0) for i in range(nl)],
                       device=cuda_device)
    cnt = torch.arange(1, nl + 1, dtype=torch.float32, device=cuda_device)
    args = (0.3, 0.9, 0.999, 1e-8, 0.1)
    pk, mk, vk = p.clone(), m.clone(), v.clone()
    n0 = ops.LAUNCHES["masked_adamw"]
    out = ops.masked_adamw(pk, grad, mk, vk, sel, cnt, *args)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["masked_adamw"] == n0 + 1
    assert out[0] is pk and out[1] is mk and out[2] is vk
    flat = lambda t: t.reshape(nl, -1)  # noqa: E731
    pr, mr, vr = ref.masked_adamw(flat(p), flat(grad), flat(m), flat(v), sel,
                                  cnt, *args)
    torch.testing.assert_close(flat(pk).float(), pr.float(), **TOL[dtype])
    torch.testing.assert_close(flat(mk), mr, **TOL[torch.float32])
    torch.testing.assert_close(flat(vk), vr, **TOL[torch.float32])
    off = sel == 0
    for new, old in ((pk, p), (mk, m), (vk, v)):
        assert _bits_equal(flat(new)[off], flat(old)[off])
    moved = (flat(pk).float() - flat(p).float())[~off].abs().max()
    assert moved > 5 * TOL[dtype]["atol"], moved


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 33, 4096])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_bwd_matches_plain(cuda_device, n, dtype):
    """x with nonzero column means and dy = 1 + N(0, 1), so dx and dscale
    are large beside the tolerance; the backward through ``norms.apply``
    launches the kernel."""
    from repro_torch.models.layers import norms
    g = torch.Generator(device=cuda_device).manual_seed(n)
    mu = 1 + 0.5 * torch.randn(896, generator=g, device=cuda_device)
    x = (mu + torch.randn(n, 896, generator=g, device=cuda_device)).to(dtype)
    s = (1 + 0.1 * torch.randn(896, generator=g, device=cuda_device)).to(
        dtype)
    dy = (1 + torch.randn(n, 896, generator=g, device=cuda_device)).to(dtype)
    n0 = ops.LAUNCHES["rmsnorm_bwd"]
    dx, ds = ops.rmsnorm_bwd(dy, x, s, 1e-6)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["rmsnorm_bwd"] == n0 + 1
    assert dx.dtype == dtype and ds.dtype == dtype
    pdx, pds = ref.rmsnorm_bwd(dy, x, s, 1e-6)
    _close(dx, pdx, dtype)
    torch.testing.assert_close(ds.float(), pds.float(), **TOL[dtype])
    xg, sg = x.clone().requires_grad_(), s.clone().requires_grad_()
    gx, gs = torch.autograd.grad(norms.apply({"scale": sg}, xg, 1e-6),
                                 (xg, sg), dy)
    assert ops.LAUNCHES["rmsnorm_bwd"] == n0 + 2
    assert _bits_equal(gx, dx) and _bits_equal(gs, ds)


# ------------------------------------------- banked residency (row 9) and repairs


def _banked_inputs(dev, dtype, shape, slots, seed=13):
    """p, g [L, ...]; m, v [cap, ...] banks; sel with the first real slot
    and every free slot at 0; counts."""
    g = torch.Generator(device=dev).manual_seed(seed)
    nl, cap = shape[0], len(slots)
    bank = (cap,) + tuple(shape[1:])

    def rnd(shp, scale=1.0, shift=0.0):
        return shift + scale * torch.randn(shp, generator=g, device=dev)
    p, grad = rnd(shape).to(dtype), rnd(shape, 1.0, 0.5).to(dtype)
    m, v = rnd(bank, 0.1, 0.05), rnd(bank, 0.01).abs() + 0.01
    sl = torch.tensor(slots, dtype=torch.int32, device=dev)
    sel = (sl < nl).float()
    sel[0] = 0.0
    cnt = torch.arange(1, cap + 1, dtype=torch.float32, device=dev)
    return p, grad, m, v, sl, sel, cnt


@pytest.mark.cuda
@pytest.mark.parametrize("shape, slots", [((4, 100), [2, 4, 0, 3]),
                                          ((3, 2048), [2, 0, 3]),
                                          ((5, 5000), [4, 1, 5, 0, 2]),
                                          ((24, 896), [20, 3, 24, 11, 7])])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_banked_masked_adamw_matches_plain_and_row8(cuda_device, shape,
                                                    slots, dtype):
    """Row 9 in place against its plain version; free slots, the slot with
    sel = 0 and the leaf rows no slot selects keep their bits; and the same
    bits as row 8 run on a dense copy whose m and v hold the bank rows at
    the slot positions."""
    p, grad, m, v, sl, sel, cnt = _banked_inputs(cuda_device, dtype, shape,
                                                 slots)
    args = (0.3, 0.9, 0.999, 1e-8, 0.1)
    nl = shape[0]
    pk, mk, vk = p.clone(), m.clone(), v.clone()
    n0 = ops.LAUNCHES["banked_masked_adamw"]
    out = ops.banked_masked_adamw(pk, grad, mk, vk, sl, sel, cnt, *args)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["banked_masked_adamw"] == n0 + 1
    assert out[0] is pk and out[1] is mk and out[2] is vk
    pr, mr, vr = ref.banked_masked_adamw(p, grad, m, v, sl, sel, cnt, *args)
    torch.testing.assert_close(pk.float(), pr.float(), **TOL[dtype])
    torch.testing.assert_close(mk, mr, **TOL[torch.float32])
    torch.testing.assert_close(vk, vr, **TOL[torch.float32])
    on = (sl < nl) & (sel > 0)
    touched = torch.zeros(nl, dtype=torch.bool, device=cuda_device)
    touched[sl[on].long()] = True
    assert _bits_equal(pk[~touched], p[~touched])
    for new, old in ((mk, m), (vk, v)):
        assert _bits_equal(new[~on], old[~on])
    # row 8 on the dense copy
    real = (sl < nl).nonzero()[:, 0]
    rows = sl[real].long()
    pd = p.clone()
    md = torch.zeros(shape, device=cuda_device)
    vd = torch.zeros(shape, device=cuda_device)
    md[rows], vd[rows] = m[real], v[real]
    seld = torch.zeros(nl, device=cuda_device)
    cntd = torch.zeros(nl, device=cuda_device)
    seld[rows], cntd[rows] = sel[real], cnt[real]
    ops.masked_adamw(pd, grad, md, vd, seld, cntd, *args)
    torch.cuda.synchronize()
    assert _bits_equal(pk, pd)
    assert _bits_equal(mk[real], md[rows]) and _bits_equal(vk[real], vd[rows])


@pytest.mark.cuda
@pytest.mark.parametrize("scores, k, want", [([0.0] * 26, 5, [0, 1, 2, 3, 4]),
                                             ([1, 2, 2, 2, 0], 2, [1, 2])])
def test_topk_mask_ties_go_to_the_lower_index(cuda_device, scores, k, want):
    from repro_torch.core import selection
    mask = selection.topk_mask(torch.tensor(scores, device=cuda_device), k)
    assert mask.nonzero()[:, 0].tolist() == want


def _card_smoke():
    """The smoke qwen2.5-0.5b at head dim 64, which the flash kernels take
    (its own 16 they refuse)."""
    from repro_torch.configs import get_smoke_config
    return get_smoke_config("qwen2.5-0.5b").replace(head_dim=64)


@pytest.mark.cuda
def test_dense_steps_and_batch_uploads_never_sync(cuda_device):
    """Three dense training steps of the smoke config, batch uploads
    included, under ``set_sync_debug_mode("error")``: no host sync outside
    the log boundary (which the loop is not asked for here)."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.train.trainer import Trainer
    tr = Trainer(TrainConfig(model=_card_smoke(), seq_len=48,
                             global_batch=4, steps=4), device="cuda")
    tr.train(1)     # first launches: builds and compiles the kernels
    torch.cuda.synchronize()
    state = tr.state
    torch.cuda.set_sync_debug_mode("error")
    try:
        for step in range(1, 4):
            batch = tr._device_batch(tr.data.batch_at(step))
            state, metrics = tr.step_fn(state, batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert state["step"] == 4
    assert torch.isfinite(metrics["loss"]).item()


@pytest.mark.cuda
@pytest.mark.parametrize("async_swap", [True, False])
def test_banked_step_syncs_the_host_once(cuda_device, async_swap):
    """The banked step's only host sync is its read of the selected (and
    predicted) block ids: one synchronising call a step under
    ``set_sync_debug_mode("warn")``, batch uploads included."""
    import warnings

    from repro_torch.configs.base import OptimizerConfig, TrainConfig
    from repro_torch.train.trainer import Trainer
    tr = Trainer(TrainConfig(
        model=_card_smoke(), seq_len=48, global_batch=4,
        steps=5, optimizer=OptimizerConfig(moment_residency="banked",
                                           offload="host",
                                           async_swap=async_swap)),
        device="cuda")
    tr.train(1)
    torch.cuda.synchronize()
    state = tr.state
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for step in range(1, 5):
                batch = tr._device_batch(tr.data.batch_at(step))
                state, _ = tr.step_fn(state, batch)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught if "synchronizing" in str(w.message)]
    assert len(syncs) == 4, [str(w.message) for w in caught]
    assert tr.step_fn.swap_stats.steps == 5


# ------------------------------------------------ flash attention (rows 4-6)


def _packed_segments(b, s):
    """The variable-length packed layout of tests/test_kernels.py (a pad
    tail, segments across the tile boundaries), rows repeated past 2."""
    seg = np.zeros((b, s), np.int32)
    seg[0::2, :s // 3] = 1
    seg[0::2, s // 3:s - 40] = 2
    seg[0::2, s - 40:s - 16] = 3
    seg[1::2, :min(150, s)] = 1
    seg[1::2, 150:] = 2
    return seg


def _flash_inputs(dev, dtype, b, s, h, kvh, d, segmented, seed=7,
                  q_scale=None):
    """N(0, 1) keys, values and do. In bf16 q = 3 N(0, 1): peaked softmax
    rows, so that the outputs stay large beside the 2e-2 tolerance. In f32
    q = N(0, 1) by default: the peaked q is held against an f64 evaluation
    instead (``test_flash_attention_f32_peaked_against_f64``)."""
    rng = np.random.default_rng(seed)
    if q_scale is None:
        q_scale = 3 if dtype == torch.bfloat16 else 1
    q = q_scale * rng.standard_normal((b, s, h, d))
    k, v = (rng.standard_normal((b, s, kvh, d)) for _ in range(2))
    do = rng.standard_normal((b, s, h, d))
    rep = max(1, h // kvh)
    hmap = np.minimum(np.arange(h) // rep, kvh - 1)
    f = [torch.tensor(a, dtype=dtype, device=dev) for a in (q, k, v, do)]
    i32 = [torch.tensor(a, dtype=torch.int32, device=dev)
           for a in (hmap, _packed_segments(b, s))]
    return (*f, i32[0], i32[1] if segmented else None)


def _check_flash(dev, dtype, b, s, h, kvh, d, segmented, causal=True):
    q, k, v, do, hm, seg = _flash_inputs(dev, dtype, b, s, h, kvh, d,
                                         segmented)
    mode = dict(causal=causal, segment_ids=seg)
    before = dict(ops.LAUNCHES)
    o, lse = ops.flash_attention_fwd(q, k, v, hm, **mode)
    grads = ops.flash_attention_bwd(q, k, v, o, lse, do, hm, **mode)
    again = ops.flash_attention_bwd(q, k, v, o, lse, do, hm, **mode)
    torch.cuda.synchronize()
    for name, n in (("flash_attention_fwd", 1), ("flash_attention_bwd_dq", 2),
                    ("flash_attention_bwd_dkv", 2)):
        assert ops.LAUNCHES[name] == before[name] + n
    assert o.dtype == dtype and lse.shape == (b, h, s)
    po, plse = ref.flash_attention_fwd(q, k, v, hm, seg, causal)
    _close(o, po, dtype)
    _close(lse, plse, torch.float32)
    plain = ref.flash_attention_bwd(q, k, v, o, lse, do, hm, seg, causal)
    for got, want in zip(grads, plain):
        assert got.dtype == dtype
        if s > 1:
            _close(got, want, dtype)
        else:   # one key: p = 1, so dq = dk = 0 exactly
            torch.testing.assert_close(got.float(), want.float(),
                                       **TOL[dtype])
    # dk, dv are summed in a fixed order with no atomics
    assert _bits_equal(grads[1], again[1]) and _bits_equal(grads[2], again[2])


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("segmented", [False, True])
@pytest.mark.parametrize("s", [128, 256, 384])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_matches_plain(cuda_device, s, dtype, segmented,
                                       causal):
    """o, lse, dq, dk, dv of the kernels against the plain versions with a
    GQA map (4 q heads on 2 kv heads), causal or not."""
    _check_flash(cuda_device, dtype, 2, s, 4, 2, 64, segmented, causal)


@pytest.mark.cuda
@pytest.mark.parametrize("s, d", [(1, 64), (65, 64), (300, 64), (200, 128),
                                  (512, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_ragged_and_head_dim_128(cuda_device, s, d, dtype):
    """S that no tile divides, and head dim 128, segmented, with the
    qwen2.5-0.5b head map (16 q heads, 2 kv heads, the padded two clamped
    onto the last)."""
    _check_flash(cuda_device, dtype, 2, s, 16, 2, d, True)


def _excess(got, exact):
    """max |got - exact| / (atol + rtol |exact|) at the f32 tolerance: at
    most 1 is within it."""
    tol = TOL[torch.float32]
    return ((got.double() - exact).abs()
            / (tol["atol"] + tol["rtol"] * exact.abs())).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s, d", [(384, 64), (300, 64), (512, 128)])
def test_flash_attention_f32_peaked_against_f64(cuda_device, s, d, causal):
    """f32 at q = 3 N(0, 1), segmented, 16 q heads on 2 kv heads: the
    kernels' o, lse, dq, dk, dv and the plain f32 versions' are both held
    against the plain version evaluated in f64 on the same inputs. Each
    output of the kernels is within the f32 tolerance of f64, or no further
    from it than the plain f32 version is."""
    q, k, v, do, hm, seg = _flash_inputs(cuda_device, torch.float32, 2, s,
                                         16, 2, d, True, q_scale=3)
    mode = dict(causal=causal, segment_ids=seg)
    o, lse = ops.flash_attention_fwd(q, k, v, hm, **mode)
    kern = (o, lse, *ops.flash_attention_bwd(q, k, v, o, lse, do, hm,
                                             **mode))
    po, plse = ref.flash_attention_fwd(q, k, v, hm, seg, causal)
    plain = (po, plse, *ref.flash_attention_bwd(q, k, v, po, plse, do, hm,
                                                seg, causal))
    q64, k64, v64, do64 = (t.double() for t in (q, k, v, do))
    xo, xlse = ref.flash_attention_fwd(q64, k64, v64, hm, seg, causal)
    exact = (xo, xlse, *ref.flash_attention_bwd(q64, k64, v64, xo, xlse,
                                                do64, hm, seg, causal))
    for name, got, pl, x in zip(("o", "lse", "dq", "dk", "dv"), kern, plain,
                                exact):
        assert x.dtype == torch.float64 and got.dtype == torch.float32
        e_kern, e_plain = _excess(got, x), _excess(pl, x)
        assert e_kern <= max(1.0, e_plain), (name, e_kern, e_plain)


@pytest.mark.cuda
def test_flash_attention_autograd_and_refusals(cuda_device):
    """The autograd Function runs one forward and one dq and dk/dv launch
    each, and equals the plain versions; what the kernels do not take is
    refused by name."""
    q, k, v, do, hm, seg = _flash_inputs(cuda_device, torch.float32, 2, 96,
                                         4, 2, 64, True)
    qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
    before = dict(ops.LAUNCHES)
    out = ops.flash_attention(qq, kk, vv, hm, segment_ids=seg)
    out.backward(do)
    torch.cuda.synchronize()
    assert {n: ops.LAUNCHES[n] - before[n] for n in before} == {
        n: int(n.startswith("flash")) for n in before}
    po, plse = ref.flash_attention_fwd(q, k, v, hm, seg)
    _close(out.detach(), po, torch.float32)
    for got, want in zip((qq.grad, kk.grad, vv.grad),
                         ref.flash_attention_bwd(q, k, v, po, plse, do, hm,
                                                 seg)):
        _close(got, want, torch.float32)
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(q[..., :32].contiguous(), k[..., :32].contiguous(),
                            v[..., :32].contiguous(), hm)
    with pytest.raises(ValueError, match="softcap"):
        ops.flash_attention(q, k, v, hm, softcap=50.0)
    with pytest.raises(ValueError, match="int32"):
        ops.flash_attention(q, k, v, hm, segment_ids=seg.long())
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ops.flash_attention(q.half(), k.half(), v.half(), hm)


@pytest.mark.cuda
def test_packed_steps_never_sync(cuda_device):
    """Three packed training steps (segment ids and positions uploaded
    with the batch, attention through the segment-masked kernels) under
    ``set_sync_debug_mode("error")``."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import loader
    from repro_torch.train.trainer import Trainer
    tr = Trainer(TrainConfig(model=_card_smoke(), seq_len=128,
                             global_batch=2, steps=4),
                 data_source=loader.make_source("packed_math", seq_len=128,
                                                global_batch=2),
                 device="cuda")
    tr.train(1)
    torch.cuda.synchronize()
    state = tr.state
    stream = tr.data.batches(3)
    before = dict(ops.LAUNCHES)
    torch.cuda.set_sync_debug_mode("error")
    try:
        for host, _ in stream:
            assert "segment_ids" in host
            state, metrics = tr.step_fn(state, tr._device_batch(host))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    nl = tr.tcfg.model.num_layers
    assert ops.LAUNCHES["flash_attention_fwd"] - before[
        "flash_attention_fwd"] == 3 * 2 * nl
    assert ops.LAUNCHES["flash_attention_bwd_dkv"] - before[
        "flash_attention_bwd_dkv"] == 3 * nl
    assert state["step"] == 4
    assert torch.isfinite(metrics["loss"]).item()
