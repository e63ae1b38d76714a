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
version and, bit for bit, against row 8 on the same rows; with bf16 m and v
rows 8 and 9 are held within one bf16 ulp of the plain version, a tie
rounds to even, and dense bf16-moment steps make no host sync. A banked
checkpoint with its pinned store round-trips on the card. Tied scores in
``topk_mask`` go to the lower index on the card too, and three dense
training steps with their batch uploads make no host sync. The flash
attention kernels (rows 4-6) are swept over the S of the JAX package's
flash tests (128/256/384), its packed segment layout, ragged S (1, 17, 65,
300, 1000) and head dim 128, causal and not, with bit-reproducible dk/dv,
the bf16 dk/dv at each split of its q work (1-4) and with one q head a kv
head, the bf16 dq (tensor cores) bit-reproducible; segment layouts that
probe the skipped tiles (boundaries on tile edges, a segment over three
tiles, all pad after the first tile, one segment over the row, which must
give the bits of no segments); in f32 a peaked softmax is held against an
f64 evaluation. Three packed training steps make no host sync either,
nor do three LoRA steps; one f32 LoRA step equals the CPU's.
The RMSNorm backward's dx-only mode (a frozen layer's norm under gated
weight gradients) gives the full mode's dx bits in one launch, and gated
training steps launch each mode by the mask with one host sync a step.
Prefetching (depth 2, the copy stream) adds no host sync to a training
call, dense or banked, and obs adds one a step (its selection read); the
copy stream's batches are bit-equal to the synchronous upload.
Rows 2 and 2b are also held at llama3.2-1b's and phi4-mini's widths (D
2048 and 3072) and at ``MAX_D_BWD`` (4096), without register spills; row 2
at qwen2.5-32b's 5120 and at ``MAX_D_FWD`` (8192), without spills (its
CUDA instances as ptxas reports them), at odd widths, one row and 65536,
on an offset view of a flat buffer and in every x / scale dtype pair; each
refuses a wider row (the backward 5120). Rows 1 and 3 are held at 48 and 64
q heads (qwen2.5-32b's padded map, three and four blocks a kv head), and
``lm.init`` of a qwen2.5-32b-width stack peaks within one f32 draw of its
bf16 bytes.
The dense decode attention kernel (row 3) is held against its plain version at
the shapes of ``chip_smoke.py`` phase 15 (the eval shape, the S and
valid_len of ``tests/test_kernels.py``, ragged S, head dim 128), against
row 1 on a gathered view, in f32 against f64, and forced to each split of a
row's positions (1-32 chunks, with valid_len 0 and chunks past valid_len
and S); q heads outside its head map get zeros; a chunk of dense decode
steps makes no host sync. The smoke config runs at head dim 64 here: the
flash and decode kernels take 64 and 128.
The serving stack: a sampled decode chunk (paged and dense) makes no host
sync, the counter-based sampling noise has the CPU's bits, and a prefix-cache
admission whose copy-on-write and pad rows write to the pool's sink page
runs without a device assert and keeps the prefix-off engine's tokens.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
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


# 32 q heads on 8 kv heads: llama3.2-1b's map at head dim 64, phi4-mini's
# (24 heads padded to 32, the padded ones on kv head 7) at 128
WIDE_HMAPS = {64: np.arange(32) // 4, 128: np.minimum(np.arange(32) // 3, 7)}


@pytest.mark.cuda
@pytest.mark.parametrize("ps", [4, 16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_32_heads(cuda_device, ps, d, dtype):
    """Row 1 at 32 q heads on 8 kv heads (two blocks a kv head, the second
    with no head to serve) at head dim 64 and 128, against the plain
    version; bit-identical over two launches."""
    q, k, v, tbl, vl, hm = _paged_inputs(cuda_device, dtype, ps,
                                         [1, ps + 3, 300, 512], 512 // ps,
                                         h=32, kvh=8, d=d,
                                         hmap=WIDE_HMAPS[d])
    out = ops.paged_decode_attention(q, k, v, tbl, vl, hm)
    again = ops.paged_decode_attention(q, k, v, tbl, vl, hm)
    assert _bits_equal(out, again)
    _close(out[:, 0], ref.paged_decode_attention(q[:, 0], k, v, tbl, vl, hm),
           dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("hmap", [[0] * 32, [0] * 17 + [1] * 15,
                                  [1, 0] * 16],
                         ids=["one-kv-head", "17-15", "interleaved"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_groups_over_16_heads(cuda_device, hmap, dtype):
    """A kv head with more than 16 q heads is served by two blocks (its
    heads 0-15 and 16-31): rows 1 and 3 against their plain versions, and
    bit-equal to each other on one pool."""
    kvh = max(hmap) + 1
    q, k, v, tbl, vl, hm = _paged_inputs(cuda_device, dtype, 16,
                                         [1, 19, 300, 512], 32, h=32,
                                         kvh=kvh, hmap=np.asarray(hmap))
    paged = ops.paged_decode_attention(q, k, v, tbl, vl, hm)
    _close(paged[:, 0], ref.paged_decode_attention(q[:, 0], k, v, tbl, vl,
                                                   hm), dtype)
    kd, vd = _gathered(k, tbl, q.shape[0]), _gathered(v, tbl, q.shape[0])
    assert _bits_equal(ops.decode_attention(q, kd, vd, vl, hm), paged)


# qwen2.5-32b's map (40 q heads padded to 48 on 8 kv heads: 5 a kv head,
# 13 on kv head 7), 48 and 64 heads on one kv head (three and four blocks),
# and chatglm3-6b's 32 q heads on 2 kv heads
WIDE_GROUPS = {"qwen2.5-32b": np.minimum(np.arange(48) // 5, 7),
               "48-one-kv-head": np.zeros(48, int),
               "64-interleaved": np.arange(64) % 2,
               "64-one-kv-head": np.zeros(64, int),
               "chatglm3-6b": np.arange(32) // 16}


@pytest.mark.cuda
@pytest.mark.parametrize("group", list(WIDE_GROUPS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_up_to_64_heads(cuda_device, group, dtype):
    """Rows 1 and 3 past 32 q heads (the map read as two 32-head words) at
    head dim 128: against their plain versions, bit-equal to each other on
    one pool, and bit-identical over two launches."""
    hmap = WIDE_GROUPS[group]
    q, k, v, tbl, vl, hm = _paged_inputs(cuda_device, dtype, 16,
                                         [1, 19, 300, 512], 32,
                                         h=len(hmap), kvh=int(hmap.max()) + 1,
                                         d=128, hmap=hmap)
    paged = ops.paged_decode_attention(q, k, v, tbl, vl, hm)
    again = ops.paged_decode_attention(q, k, v, tbl, vl, hm)
    assert _bits_equal(paged, again)
    _close(paged[:, 0], ref.paged_decode_attention(q[:, 0], k, v, tbl, vl,
                                                   hm), dtype)
    kd, vd = _gathered(k, tbl, q.shape[0]), _gathered(v, tbl, q.shape[0])
    dense = ops.decode_attention(q, kd, vd, vl, hm)
    _close(dense[:, 0], ref.decode_attention_cache(q[:, 0], kd, vd, vl, hm),
           dtype)
    assert _bits_equal(dense, paged)


def _gathered(pool, tbl, b):
    """The dense [B, max_pages * page_size, KVH, D] view of a pool that its
    tables gather (sentinels clamped), as the plain paged version reads
    it."""
    rows = tbl.long().clamp(max=pool.shape[0] - 1)
    return pool[rows].reshape(b, -1, *pool.shape[2:]).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("n_split", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_every_split(cuda_device, dtype, n_split):
    """Row 1 forced to each split 1-4 at 32 rows of 2048 positions (page
    16): against the plain version and bit-identical over two launches."""
    from repro_torch.kernels import decode_attention as dec
    q, k, v, tbl, vl, hm = _paged_inputs(cuda_device, dtype, 16,
                                         [2048] * 31 + [1000], 128)
    outs = []
    for _ in range(2):
        out = torch.full((32, 16, 64), float("nan"), dtype=dtype,
                         device=cuda_device)
        dec.launch_paged(q.view(32, 16, 64), k, v, tbl, vl, hm, out,
                         n_split=n_split)
        outs.append(out)
    torch.cuda.synchronize()
    assert _bits_equal(outs[0], outs[1])
    _close(outs[0], ref.paged_decode_attention(q[:, 0], k, v, tbl, vl, hm),
           dtype)


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
    with pytest.raises(ValueError, match="at most 64 q heads"):
        ops.paged_decode_attention(torch.cat([q] * 5, 2), k, v, tbl, vl,
                                   torch.cat([hm] * 5))
    with pytest.raises(ValueError, match="head dim"):
        ops.paged_decode_attention(q[..., :32].contiguous(),
                                   k[..., :32].contiguous(),
                                   v[..., :32].contiguous(), tbl, vl, hm)
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
@pytest.mark.parametrize("n", [1, 4, 33, 4096, 8192])
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


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 4, 33, 4096, 8192])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_bwd_dx_only(cuda_device, n, dtype):
    """The dx-only mode (a frozen layer's norm): one launch counted as
    ``rmsnorm_bwd_dx``, dx within the tolerance of the plain version and
    bit-equal to the full mode's dx; ``norms.apply`` takes it when the
    scale needs no gradient."""
    from repro_torch.models.layers import norms
    g = torch.Generator(device=cuda_device).manual_seed(n + 1)
    mu = 1 + 0.5 * torch.randn(896, generator=g, device=cuda_device)
    x = (mu + torch.randn(n, 896, generator=g, device=cuda_device)).to(dtype)
    s = (1 + 0.1 * torch.randn(896, generator=g, device=cuda_device)).to(
        dtype)
    dy = (1 + torch.randn(n, 896, generator=g, device=cuda_device)).to(dtype)
    before = dict(ops.LAUNCHES)
    dx, ds = ops.rmsnorm_bwd(dy, x, s, 1e-6, with_dscale=False)
    torch.cuda.synchronize()
    assert ds is None and dx.dtype == dtype
    assert {k: ops.LAUNCHES[k] - before[k] for k in before} == {
        k: int(k == "rmsnorm_bwd_dx") for k in before}
    pdx, pds = ref.rmsnorm_bwd(dy, x, s, 1e-6, with_dscale=False)
    assert pds is None
    _close(dx, pdx, dtype)
    full_dx, _ = ops.rmsnorm_bwd(dy, x, s, 1e-6)
    assert _bits_equal(dx, full_dx)
    xg = x.clone().requires_grad_()
    (gx,) = torch.autograd.grad(norms.apply({"scale": s}, xg, 1e-6), (xg,),
                                dy)
    assert ops.LAUNCHES["rmsnorm_bwd_dx"] == before["rmsnorm_bwd_dx"] + 2
    assert _bits_equal(gx, dx)


def _wide_rows(dev, n, d, dtype, seed):
    """x with nonzero column means, scale near 1 and dy = 1 + N(0, 1): the
    outputs of rows 2 and 2b are large beside the tolerance."""
    g = torch.Generator(device=dev).manual_seed(seed)
    mu = 1 + 0.5 * torch.randn(d, generator=g, device=dev)
    x = (mu + torch.randn(n, d, generator=g, device=dev)).to(dtype)
    s = (1 + 0.1 * torch.randn(d, generator=g, device=dev)).to(dtype)
    dy = (1 + torch.randn(n, d, generator=g, device=dev)).to(dtype)
    return x, s, dy


def _forward_spills_nothing():
    """Every instance of the CUDA forward (``csrc/rmsnorm.cu``) compiled
    without spills, as ptxas reports them in its build."""
    from repro_torch.kernels import _build
    fwd = [u for u in _build.usage("rmsnorm.cu")
           if "rmsnorm_fwd_kernel" in u.kernel]
    assert len(fwd) == 8, fwd   # x and scale each f32 or bf16, vec 16 B or 1
    assert all(u.spill_bytes == 0 for u in fwd), fwd


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4, 4096])
@pytest.mark.parametrize("d", [2048, 3072, 4096])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_wide_rows(cuda_device, n, d, dtype):
    """Rows 2 and 2b at llama3.2-1b's and phi4-mini's widths (2048, 3072)
    and at ``MAX_D_BWD``: the forward, the backward and its dx-only mode within
    the tolerance of their plain versions, dx and dscale bit-identical over
    two launches, dx-only's dx the full mode's bits, and no compiled kernel
    spilling registers."""
    from repro_torch.kernels import rmsnorm as rn
    x, s, dy = _wide_rows(cuda_device, n, d, dtype, seed=d + n)
    n0 = dict(ops.LAUNCHES)
    y = ops.rmsnorm(x, s, 1e-6)
    dx, ds = ops.rmsnorm_bwd(dy, x, s, 1e-6)
    dx2, ds2 = ops.rmsnorm_bwd(dy, x, s, 1e-6)
    dxo, dso = ops.rmsnorm_bwd(dy, x, s, 1e-6, with_dscale=False)
    torch.cuda.synchronize()
    assert {k: ops.LAUNCHES[k] - n0[k] for k in n0} == {
        k: {"rmsnorm": 1, "rmsnorm_bwd": 2, "rmsnorm_bwd_dx": 1}.get(k, 0)
        for k in n0}
    _close(y, ref.rmsnorm(x, s, 1e-6), dtype)
    pdx, pds = ref.rmsnorm_bwd(dy, x, s, 1e-6)
    _close(dx, pdx, dtype)
    torch.testing.assert_close(ds.float(), pds.float(), **TOL[dtype])
    assert _bits_equal(dx, dx2) and _bits_equal(ds, ds2)
    assert dso is None and _bits_equal(dxo, dx)
    kernels = rn.launch_bwd(x, s, dy, 1e-6, torch.empty_like(x),
                            torch.empty_like(s))
    for k in kernels:
        assert k.n_spills == 0, (k.name, k.n_regs, k.n_spills)
    _forward_spills_nothing()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4, 1024])
@pytest.mark.parametrize("d", [5120, 8192])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_forward_past_4096(cuda_device, n, d, dtype):
    """Row 2 at qwen2.5-32b's D 5120 and at ``MAX_D_FWD`` (8192): within
    the tolerance of its plain version, bit-identical over two launches,
    one launch counted, no register spills."""
    x, s, _ = _wide_rows(cuda_device, n, d, dtype, seed=d + n)
    n0 = ops.LAUNCHES["rmsnorm"]
    y = ops.rmsnorm(x, s, 1e-6)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["rmsnorm"] == n0 + 1
    _close(y, ref.rmsnorm(x, s, 1e-6), dtype)
    assert _bits_equal(y, ops.rmsnorm(x, s, 1e-6))
    _forward_spills_nothing()


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n, d, offset", [
    (3, 1, 0), (5, 7, 0), (4, 8, 0), (33, 895, 0), (9, 4097, 0),
    (1, 896, 0), (65536, 896, 0), (64, 896, 1), (16, 5120, 1)])
def test_rmsnorm_forward_odd_rows(cuda_device, x_dtype, s_dtype, n, d,
                                  offset):
    """Row 2 at odd widths (1, 7, 895, 4097: the vector-width-1 instance),
    at one row and at 65536, and on an offset view ``buf[1:].view(n, d)``
    of a flat buffer, whose base is not 16-byte aligned (the vector-width-1
    instance too), in each x / scale dtype pair: within the tolerance of
    the plain version, bit-identical over two launches, a launch counted
    each."""
    from repro_torch.kernels import rmsnorm as rn
    g = torch.Generator(device=cuda_device).manual_seed(n + d)
    buf = (1 + 0.5 * torch.randn(n * d + offset, generator=g,
                                 device=cuda_device)).to(x_dtype)
    x = buf[offset:].view(n, d)
    s = (1 + 0.1 * torch.randn(d, generator=g, device=cuda_device)).to(
        s_dtype)
    n0 = ops.LAUNCHES["rmsnorm"]
    y = ops.rmsnorm(x, s, 1e-6)
    y2 = ops.rmsnorm(x, s, 1e-6)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["rmsnorm"] == n0 + 2
    _close(y, ref.rmsnorm(x, s, 1e-6), x_dtype)
    assert _bits_equal(y, y2)
    out = torch.empty_like(x)
    plan = rn.launch(x, s, 1e-6, out)
    assert (plan.vec == 1) == bool(offset or d % (16 // x.element_size()))
    assert _bits_equal(out, y)


@pytest.mark.cuda
def test_rmsnorm_refuses_rows_wider_than_max_d(cuda_device):
    """The forward refuses D past ``MAX_D_FWD`` (8192); the backward, both
    modes, past ``MAX_D_BWD`` (4096), so qwen2.5-32b's 5120 too; no launch
    is counted."""
    from repro_torch.kernels import rmsnorm as rn
    x, s, _ = _wide_rows(cuda_device, 2, rn.MAX_D_FWD + 1, torch.float32, 1)
    before = dict(ops.LAUNCHES)
    with pytest.raises(ValueError, match=f"D <= {rn.MAX_D_FWD}"):
        ops.rmsnorm(x, s)
    for d in (5120, rn.MAX_D_BWD + 1):
        x, s, dy = _wide_rows(cuda_device, 2, d, torch.float32, 1)
        with pytest.raises(ValueError, match=f"D <= {rn.MAX_D_BWD}"):
            ops.rmsnorm_bwd(dy, x, s)
        with pytest.raises(ValueError, match=f"D <= {rn.MAX_D_BWD}"):
            ops.rmsnorm_bwd(dy, x, s, with_dscale=False)
    assert ops.LAUNCHES == before


@pytest.mark.cuda
def test_init_peak_within_one_f32_draw(cuda_device):
    """``lm.init`` of qwen2.5-32b at full width with 2 layers (5.1 GB of
    bf16) draws slice by slice: its peak is the bf16 bytes it returns plus
    at most one f32 draw, one [d_model, d_ff] layer of ``mlp.wg`` (0.57
    GB), never a whole leaf in f32."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    cfg = get_config("qwen2.5-32b").replace(num_layers=2)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    params = lm.init(cfg, torch.Generator(device=cuda_device).manual_seed(0),
                     device="cuda")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    held = sum(t.numel() * t.element_size() for t in _tree_leaves(params))
    draw = 4 * cfg.d_model * cfg.d_ff
    assert held == 2 * sum(math.prod(sh) for sh in _tree_leaves(
        lm.param_shapes(cfg)))
    assert held <= peak <= held + draw + (8 << 20), (held, peak, draw)
    del params
    torch.cuda.empty_cache()


def _tree_leaves(tree):
    for v in tree.values():
        yield from (_tree_leaves(v) if isinstance(v, dict) else (v,))


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


def _bf16_gap(got, want, terms):
    """The gap between bf16 moments in units of one bf16 ulp at the larger
    value plus the f32 rounding of the update's terms (the kernel may
    contract b m + (1 - b) g into an FMA; where the sum cancels to near
    zero that moves it by more than a bf16 ulp of the result): at most 1
    is "within one bf16 ulp"."""
    a, b = got.float(), want.float()
    big = torch.maximum(a.abs(), b.abs()).clamp(min=2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(big)) - 7)
    return ((a - b).abs() / (ulp + 2.0 ** -22 * terms)).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("shape, slots", [((4, 100), [2, 4, 0, 3]),
                                          ((5, 5000), [4, 1, 5, 0, 2]),
                                          ((24, 896), [20, 3, 24, 11, 7])])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bf16_moment_adamw_matches_plain(cuda_device, shape, slots, dtype):
    """Rows 8 and 9 with bf16 m and v (``moment_dtype="bfloat16"``): m and
    v within one bf16 ulp of the plain version, p within the tolerance,
    unselected rows and free slots keep their bits, row 9 gives row 8's
    bits, and the launches count as ``*_bf16m``."""
    p, grad, m, v, sl, sel, cnt = _banked_inputs(cuda_device, dtype, shape,
                                                 slots)
    m, v = m.bfloat16(), v.bfloat16()
    args = (0.3, 0.9, 0.999, 1e-8, 0.1)
    nl = shape[0]
    real = (sl < nl).nonzero()[:, 0]
    rows = sl[real].long()
    md = torch.zeros(shape, dtype=torch.bfloat16, device=cuda_device)
    vd = torch.zeros(shape, dtype=torch.bfloat16, device=cuda_device)
    md[rows], vd[rows] = m[real], v[real]
    seld = torch.zeros(nl, device=cuda_device)
    cntd = torch.zeros(nl, device=cuda_device)
    seld[rows], cntd[rows] = sel[real], cnt[real]
    before = dict(ops.LAUNCHES)
    pd, mdk, vdk = p.clone(), md.clone(), vd.clone()
    ops.masked_adamw(pd, grad, mdk, vdk, seld, cntd, *args)
    pk, mk, vk = p.clone(), m.clone(), v.clone()
    ops.banked_masked_adamw(pk, grad, mk, vk, sl, sel, cnt, *args)
    torch.cuda.synchronize()
    assert {k: ops.LAUNCHES[k] - before[k] for k in before} == {
        k: int(k in ("masked_adamw_bf16m", "banked_masked_adamw_bf16m"))
        for k in before}
    pr, mr, vr = ref.masked_adamw(p, grad, md, vd, seld, cntd, *args)
    assert mdk.dtype == torch.bfloat16 and vdk.dtype == torch.bfloat16
    gf = grad.float()
    tm = 0.9 * md.float().abs() + 0.1 * gf.abs()
    tv = 0.999 * vd.float().abs() + 0.001 * gf * gf
    assert _bf16_gap(mdk, mr, tm) <= 1 and _bf16_gap(vdk, vr, tv) <= 1
    torch.testing.assert_close(pd.float(), pr.float(), **TOL[dtype])
    off = seld == 0
    for new, old in ((pd, p), (mdk, md), (vdk, vd)):
        assert _bits_equal(new[off], old[off])
    assert _bits_equal(pk, pd)
    assert _bits_equal(mk[real], mdk[rows]) and _bits_equal(vk[real],
                                                            vdk[rows])
    on = (sl < nl) & (sel > 0)
    assert _bits_equal(mk[~on], m[~on]) and _bits_equal(vk[~on], v[~on])


@pytest.mark.cuda
def test_bf16_moments_round_ties_to_nearest_even(cuda_device):
    """b1 = b2 = 0 makes m' = g exactly (f32 params): a g on a tie between
    two bf16 values is stored as the even one, as XLA's convert and
    PyTorch's cast round."""
    step = 2.0 ** -8     # half a bf16 ulp at 1
    g = torch.tensor([[1 + step, 1 + 3 * step, -(1 + step), 1 + 5 * step]],
                     device=cuda_device)
    want = torch.tensor([[1.0, 1 + 2 ** -6, -1.0, 1 + 2 ** -6]],
                        dtype=torch.bfloat16, device=cuda_device)
    m = torch.zeros_like(g, dtype=torch.bfloat16)
    v = torch.zeros_like(m)
    one = torch.ones(1, device=cuda_device)
    ops.masked_adamw(torch.ones_like(g), g, m, v, one, one, 1e-3, 0.0, 0.0,
                     1e-8, 0.0)
    torch.cuda.synchronize()
    assert _bits_equal(m, want) and _bits_equal(m, g.bfloat16())


@pytest.mark.cuda
def test_bf16_moment_dense_steps_never_sync(cuda_device):
    """Dense training steps with bf16 moments make no host sync between log
    boundaries, as the f32 ones do."""
    from repro_torch.configs.base import OptimizerConfig, TrainConfig
    from repro_torch.train.trainer import Trainer
    tr = Trainer(TrainConfig(model=_card_smoke(), seq_len=48,
                             global_batch=4, steps=4,
                             optimizer=OptimizerConfig(
                                 moment_dtype="bfloat16")), device="cuda")
    tr.train(1)
    torch.cuda.synchronize()
    state = tr.state
    n0 = ops.LAUNCHES["masked_adamw_bf16m"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        for step in range(1, 4):
            batch = tr._device_batch(tr.data.batch_at(step))
            state, _ = tr.step_fn(state, batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert ops.LAUNCHES["masked_adamw_bf16m"] > n0


@pytest.mark.cuda
@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_banked_checkpoint_round_trip_on_the_card(cuda_device, tmp_path,
                                                  moments):
    """A banked state with its pinned host store saved on the card and
    restored by a new Trainer: every leaf's bits, the store pinned again,
    the banks on the card, and the next step equal to the saver's."""
    from repro_torch.checkpoint import manager
    from repro_torch.configs.base import OptimizerConfig, TrainConfig
    from repro_torch.core import partition as part
    from repro_torch.train.trainer import Trainer

    def tcfg():
        return TrainConfig(
            model=_card_smoke(), seq_len=48, global_batch=4, steps=3,
            checkpoint_dir=str(tmp_path), checkpoint_every=2,
            optimizer=OptimizerConfig(moment_residency="banked",
                                      offload="host", async_swap=True,
                                      moment_dtype=moments))
    saver = Trainer(tcfg(), device="cuda")
    saver.train(2)
    resumed = Trainer(tcfg(), device="cuda")
    assert resumed.maybe_restore() == 2
    store = part.leaves(resumed.state["opt"]["store"])
    assert all(t.is_pinned() for t in store)
    assert store[0].dtype == getattr(torch, moments)
    assert resumed.state["opt"]["counts"].is_cuda
    for (path, a), (_, b) in zip(manager.flatten(saver.state),
                                 manager.flatten(resumed.state)):
        if isinstance(a, torch.Tensor):
            same = (_bits_equal(a, b) if a.is_floating_point()
                    else a.dtype == b.dtype and torch.equal(a, b))
            assert a.device == b.device and same, path
        else:
            assert np.array_equal(a, b), path
    saver.train(1)
    resumed.train(1)
    assert resumed.log.losses == saver.log.losses[2:]
    for a, b in zip(part.leaves(saver.state["params"]),
                    part.leaves(resumed.state["params"])):
        assert _bits_equal(a, b)


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


def _sync_count(fn) -> int:
    """Synchronising CUDA calls that ``fn`` makes, from any thread, under
    ``set_sync_debug_mode("warn")``."""
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return len([w for w in caught if "synchronizing" in str(w.message)])


def _packed_trainer(residency, depth):
    from repro_torch.configs.base import OptimizerConfig, TrainConfig
    from repro_torch.data import loader
    from repro_torch.train.trainer import Trainer
    opt = (OptimizerConfig(moment_residency="banked", offload="host",
                           async_swap=True)
           if residency == "banked" else OptimizerConfig())
    return Trainer(TrainConfig(model=_card_smoke(), seq_len=128,
                               global_batch=2, steps=8, log_every=10 ** 6,
                               optimizer=opt),
                   data_source=loader.make_source("packed_math", seq_len=128,
                                                  global_batch=2),
                   prefetch_depth=depth, device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("residency", ["device", "banked"])
def test_prefetch_and_obs_add_no_host_sync(cuda_device, residency):
    """A 3-step ``train`` call (one log window) with prefetch 2 against 0,
    obs off: the same host syncs (the window's boundary, and the banked
    step's indices read a step) and the same losses. Obs on adds one sync
    a step, the selection telemetry's read."""
    from repro_torch import obs
    syncs, losses = {}, {}
    for depth, on in ((0, False), (2, False), (0, True)):
        tr = _packed_trainer(residency, depth)
        tr.train(1)     # first launches: builds and compiles the kernels
        torch.cuda.synchronize()
        if on:
            obs.enable()
        try:
            syncs[depth, on] = _sync_count(lambda: tr.train(3))
        finally:
            obs.disable()
        losses[depth, on] = tr.log.losses
    assert syncs[2, False] == syncs[0, False], syncs
    assert syncs[0, True] == syncs[0, False] + 3, syncs
    if residency == "banked":
        assert syncs[0, False] >= 3, syncs
    assert losses[2, False] == losses[0, False] == losses[0, True]


@pytest.mark.cuda
def test_copy_stream_batches_equal_the_synchronous_upload(cuda_device):
    """Batches placed by the prefetch worker on the copy stream, claimed
    on the current stream, are bit-equal to the synchronous pinned upload
    and live on the card."""
    from repro_torch.data.pipeline import Prefetcher
    from repro_torch.data.pipeline.prefetch import CopyStreamStager
    tr = _packed_trainer("device", 2)
    stager = CopyStreamStager(cuda_device)
    want = [tr._device_batch(b) for b, _ in tr.data.batches(5)]
    with Prefetcher(tr.data.batches(5), stager.place, depth=2) as pf:
        got = [stager.claim(placed) for placed, _ in pf]
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            assert g[k].device.type == "cuda" and g[k].dtype == w[k].dtype
            assert torch.equal(g[k], w[k]), k
    assert stager.stream != torch.cuda.current_stream()


@pytest.mark.cuda
@pytest.mark.parametrize("residency", ["device", "banked"])
def test_gated_steps_launch_by_the_mask(cuda_device, residency):
    """Four gated adagradselect steps of the smoke config: the RMSNorm
    backward runs its full mode once per norm of a selected layer and the
    final norm, its dx-only mode once per norm of a frozen layer; one host
    sync a step (the mask read; the banked step's ids ride in it)."""
    import warnings

    from repro_torch.configs.base import (OptimizerConfig, SelectConfig,
                                          TrainConfig)
    from repro_torch.train.trainer import Trainer
    cfg = _card_smoke().replace(gate_weight_grads=True)
    tr = Trainer(TrainConfig(
        model=cfg, seq_len=48, global_batch=4, steps=5,
        select=SelectConfig(k_percent=40, steps_per_epoch=2),
        optimizer=OptimizerConfig(
            moment_residency=residency,
            offload="host" if residency == "banked" else "none")),
        device="cuda")
    tr.train(1)
    torch.cuda.synchronize()
    state, masks = tr.state, []
    before = dict(ops.LAUNCHES)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for step in range(1, 5):
                batch = tr._device_batch(tr.data.batch_at(step))
                state, metrics = tr.step_fn(state, batch)
                masks.append(metrics["mask"])
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # (the first use of the mode also warns that it is a prototype)
    syncs = [w for w in caught
             if "called a synchronizing" in str(w.message)]
    assert len(syncs) == 4, [str(w.message) for w in caught]
    nl = cfg.num_layers
    sel = sum(int(m[1:1 + nl].sum()) for m in masks)
    got = {k: ops.LAUNCHES[k] - before[k] for k in before}
    assert got["rmsnorm_bwd"] == 2 * sel + 4
    assert got["rmsnorm_bwd_dx"] == 2 * (4 * nl - sel)
    assert 0 < sel < 4 * nl
    assert torch.isfinite(metrics["loss"]).item()


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


def _segment_layout(name, b, s):
    """Segment ids that probe the kernels' tile skipping (64-wide tiles):
    boundaries on tile edges; a segment over three tiles; a row that is all
    pad (id 0) after its first tile; one segment over the whole row."""
    pos = np.arange(s)
    seg = np.zeros((b, s), np.int32)
    if name == "tile_edges":
        seg[0::2] = 1 + pos // 64
        seg[1::2] = 1 + pos // 128
    elif name == "three_tiles":
        seg[:] = np.where(pos < 40, 1, np.where(pos < 190, 2, 3))
        seg[1::2, s - 30:] = 0
    elif name == "pad_after_first":
        seg[:, :30], seg[:, 30:64] = 1, 2
        seg[1::2, :64] = 5
    elif name == "single":
        seg[:] = 1
    else:
        raise ValueError(name)
    return seg


def _flash_inputs(dev, dtype, b, s, h, kvh, d, segmented, seed=7,
                  q_scale=None, layout=None):
    """N(0, 1) keys, values and do. In bf16 q = 3 N(0, 1): peaked softmax
    rows, so that the outputs stay large beside the 2e-2 tolerance. In f32
    q = N(0, 1) by default: the peaked q is held against an f64 evaluation
    instead (``test_flash_attention_f32_peaked_against_f64``). Segment ids:
    the packed layout, or ``_segment_layout(layout)``."""
    rng = np.random.default_rng(seed)
    if q_scale is None:
        q_scale = 3 if dtype == torch.bfloat16 else 1
    q = q_scale * rng.standard_normal((b, s, h, d))
    k, v = (rng.standard_normal((b, s, kvh, d)) for _ in range(2))
    do = rng.standard_normal((b, s, h, d))
    rep = max(1, h // kvh)
    hmap = np.minimum(np.arange(h) // rep, kvh - 1)
    ids = (_packed_segments(b, s) if layout is None
           else _segment_layout(layout, b, s))
    f = [torch.tensor(a, dtype=dtype, device=dev) for a in (q, k, v, do)]
    i32 = [torch.tensor(a, dtype=torch.int32, device=dev)
           for a in (hmap, ids)]
    return (*f, i32[0], i32[1] if segmented else None)


def _check_flash(dev, dtype, b, s, h, kvh, d, segmented, causal=True,
                 layout=None):
    q, k, v, do, hm, seg = _flash_inputs(dev, dtype, b, s, h, kvh, d,
                                         segmented, layout=layout)
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
    return (o, lse, *grads)


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
@pytest.mark.parametrize("s, d", [(1, 64), (17, 64), (65, 64), (300, 64),
                                  (1000, 64), (200, 128), (512, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_ragged_and_head_dim_128(cuda_device, s, d, dtype):
    """S that no tile divides, and head dim 128, segmented, with the
    qwen2.5-0.5b head map (16 q heads, 2 kv heads, the padded two clamped
    onto the last)."""
    _check_flash(cuda_device, dtype, 2, s, 16, 2, d, True)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("layout", ["tile_edges", "three_tiles",
                                    "pad_after_first", "single"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_segment_layouts(cuda_device, layout, d, causal,
                                         dtype):
    """Segment layouts against the tiles that the kernels skip when no
    (query, key) pair of two tiles shares an id, with the qwen2.5-0.5b head
    map (16 q heads, 7 and 9 on the 2 kv heads), S 384. One segment over
    the whole row gives the bits of no segments."""
    out = _check_flash(cuda_device, dtype, 2, 384, 16, 2, d, True, causal,
                       layout=layout)
    if layout == "single":
        plain = _check_flash(cuda_device, dtype, 2, 384, 16, 2, d, False,
                             causal)
        for got, want in zip(out, plain):
            assert _bits_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n_split", [1, 2, 3, 4])
@pytest.mark.parametrize("s, d, causal", [(300, 64, True), (512, 128, False)])
def test_flash_dkv_every_split(cuda_device, s, d, causal, n_split):
    """The bf16 dk/dv kernel at each split of a kv head's q work (1 stores
    dk, dv from the registers, 2-4 go through the f32 partials and the sum
    kernel), segmented, with the qwen2.5-0.5b head map: against the plain
    version, and bit-identical over two launches."""
    q, k, v, do, hm, seg = _flash_inputs(cuda_device, torch.bfloat16, 2, s,
                                         16, 2, d, True)
    o, lse = ops.flash_attention_fwd(q, k, v, hm, causal=causal,
                                     segment_ids=seg)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    outs = []
    for _ in range(2):
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        fa.launch_bwd_dkv(q, k, v, do, lse, delta, seg, hm, causal, dk, dv,
                          n_split=n_split)
        outs.append((dk, dv))
    torch.cuda.synchronize()
    _, pk, pv = ref.flash_attention_bwd(q, k, v, o, lse, do, hm, seg, causal)
    _close(outs[0][0], pk, torch.bfloat16)
    _close(outs[0][1], pv, torch.bfloat16)
    assert _bits_equal(outs[0][0], outs[1][0])
    assert _bits_equal(outs[0][1], outs[1][1])


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_one_q_head_per_kv_head(cuda_device, dtype, causal):
    """4 q heads on 4 kv heads, segmented, S 300: in bf16 the dk/dv kernel
    takes its one-split path (no q heads to share out)."""
    assert fa.dkv_splits(torch.bfloat16, 4, 4) == 1
    _check_flash(cuda_device, dtype, 2, 300, 4, 4, 64, True, causal)


@pytest.mark.cuda
@pytest.mark.parametrize("s, d, causal", [(300, 64, True), (512, 128, False)])
def test_flash_dq_tensor_cores_repeat_their_bits(cuda_device, s, d, causal):
    """The bf16 dq body (tensor cores, tiles with no attending pair
    skipped), segmented, with the qwen2.5-0.5b head map: against the plain
    version, and bit-identical over two launches (no partials, no
    atomics)."""
    q, k, v, do, hm, seg = _flash_inputs(cuda_device, torch.bfloat16, 2, s,
                                         16, 2, d, True)
    o, lse = ops.flash_attention_fwd(q, k, v, hm, causal=causal,
                                     segment_ids=seg)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    outs = []
    for _ in range(2):
        dq = torch.full_like(q, float("nan"))
        fa.launch_bwd_dq(q, k, v, do, lse, delta, seg, hm, causal, dq)
        outs.append(dq)
    torch.cuda.synchronize()
    pq, _, _ = ref.flash_attention_bwd(q, k, v, o, lse, do, hm, seg, causal)
    _close(outs[0], pq, torch.bfloat16)
    assert _bits_equal(outs[0], outs[1])


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


# ---------------------------------------- dense decode attention (row 3)


def _decode_inputs(dev, dtype, b, s, vlens, d=64, seed=3):
    """One layer's dense cache [B, S, 2, D] and q [B, 1, 16, D] through the
    qwen2.5-0.5b head map; q = 3 N(0, 1): a peaked softmax (see _close)."""
    rng = np.random.default_rng(seed)
    q = 3 * rng.standard_normal((b, 1, 16, d))
    k = rng.standard_normal((b, s, 2, d))
    v = rng.standard_normal((b, s, 2, d))
    f = [torch.tensor(a, dtype=dtype, device=dev) for a in (q, k, v)]
    i32 = [torch.tensor(a, dtype=torch.int32, device=dev)
           for a in (vlens, QWEN_HMAP)]
    return (*f, *i32)


DECODE_SHAPES = [(16, 512, 64, [1, 9, 300, 512] * 4), (2, 512, 64, [100] * 2),
                 (2, 1024, 64, [1024] * 2), (2, 2048, 64, [7] * 2),
                 (3, 512, 64, [1, 100, 512]), (3, 1024, 64, [7, 1024, 333]),
                 (2, 1, 64, [1, 1]), (2, 300, 64, [1, 300]),
                 (2, 512, 128, [100, 512])]


@pytest.mark.cuda
@pytest.mark.parametrize("b, s, d, vlens", DECODE_SHAPES,
                         ids=["eval", "S512", "S1024", "S2048", "vec512",
                              "vec1024", "S1", "S300", "D128"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_decode_matches_plain(cuda_device, b, s, d, vlens, dtype):
    q, k, v, vl, hm = _decode_inputs(cuda_device, dtype, b, s, vlens, d)
    n0 = ops.LAUNCHES["decode_attention"]
    out = ops.decode_attention(q, k, v, vl, hm)
    again = ops.decode_attention(q, k, v, vl, hm)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["decode_attention"] == n0 + 2
    assert out.dtype == dtype and out.shape == q.shape
    assert _bits_equal(out, again)
    _close(out[:, 0], ref.decode_attention_cache(q[:, 0], k, v, vl, hm),
           dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_decode_zeros_heads_outside_the_map(cuda_device, dtype):
    """Heads whose hmap entry is outside [0, KVH) get zeros, not whatever
    the output's memory held; the others match the plain version on the
    mapped heads."""
    q, k, v, vl, hm = _decode_inputs(cuda_device, dtype, 3, 512,
                                     [1, 100, 512])
    bad = hm.clone()
    bad[3], bad[12] = 2, -1
    garbage = torch.full_like(q, float("nan"))
    del garbage   # the block the output is likely to reuse holds NaNs
    out = ops.decode_attention(q, k, v, vl, bad)
    assert (out[:, 0, [3, 12]] == 0).all()
    keep = [h for h in range(16) if h not in (3, 12)]
    want = ref.decode_attention_cache(q[:, 0, keep], k, v, vl, hm[keep])
    _close(out[:, 0, keep], want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_decode_matches_paged_on_gathered_view(cuda_device, dtype):
    """Row 3 on the dense view gathered from a pool through its tables
    gives the bits of row 1 on the pool (one body, the same split; the
    tolerance of tests/test_kernels.py::
    test_matches_dense_kernel_on_gathered_view, tightened to equality)."""
    q, k, v, tbl, vl, hm = _paged_inputs(cuda_device, dtype, 16,
                                         [1, 19, 300, 512], 32)
    paged = ops.paged_decode_attention(q, k, v, tbl, vl, hm)
    kd, vd = _gathered(k, tbl, q.shape[0]), _gathered(v, tbl, q.shape[0])
    dense = ops.decode_attention(q, kd, vd, vl, hm)
    assert _bits_equal(dense, paged)


@pytest.mark.cuda
@pytest.mark.parametrize("b, s, d, vlens", [DECODE_SHAPES[0],
                                            DECODE_SHAPES[-1]],
                         ids=["eval", "D128"])
def test_dense_decode_f32_peaked_against_f64(cuda_device, b, s, d, vlens):
    """f32 at q = 3 N(0, 1): the kernel's output and the plain f32
    version's against the plain version in f64; the kernel is within the
    f32 tolerance of f64, or no further from it than the plain version."""
    q, k, v, vl, hm = _decode_inputs(cuda_device, torch.float32, b, s, vlens,
                                     d, seed=4)
    got = ops.decode_attention(q, k, v, vl, hm)[:, 0]
    plain = ref.decode_attention_cache(q[:, 0], k, v, vl, hm)
    exact = ref.decode_attention_cache(q[:, 0].double(), k.double(),
                                       v.double(), vl, hm)
    assert exact.dtype == torch.float64
    e_kern, e_plain = _excess(got, exact), _excess(plain, exact)
    assert e_kern <= max(1.0, e_plain), (e_kern, e_plain)


@pytest.mark.cuda
@pytest.mark.parametrize("n_split", range(1, 33))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_decode_every_split(cuda_device, dtype, n_split):
    """Row 3 forced to each split of a row's positions (1 .. 32 chunks),
    S 300 (no chunk length divides it): valid_len 0, 1, 150 and 300, so
    some chunks lie wholly past valid_len or past S; two q heads outside
    the head map. Against the plain version on the mapped heads of the rows
    with valid_len >= 1, zeros elsewhere, bit-identical over two launches."""
    from repro_torch.kernels import decode_attention as dec
    vlens = [0, 1, 150, 300]
    q, k, v, vl, hm = _decode_inputs(cuda_device, dtype, 4, 300, vlens)
    bad = hm.clone()
    bad[3], bad[12] = 2, -1
    outs = []
    for _ in range(2):
        out = torch.full((4, 16, 64), float("nan"), dtype=dtype,
                         device=cuda_device)
        dec.launch(q.view(4, 16, 64), k, v, vl, bad, out, n_split=n_split)
        outs.append(out)
    torch.cuda.synchronize()
    assert _bits_equal(outs[0], outs[1])
    out = outs[0]
    keep = [h for h in range(16) if h not in (3, 12)]
    assert (out[0] == 0).all() and (out[1:, [3, 12]] == 0).all()
    want = ref.decode_attention_cache(q[1:, 0][:, keep], k[1:], v[1:],
                                      vl[1:], hm[keep])
    _close(out[1:, keep], want, dtype)


@pytest.mark.cuda
def test_dense_decode_chunk_never_syncs(cuda_device):
    """A chunk of 8 dense-cache decode steps, as the engine runs them
    (greedy tokens, finished flags on the device), under
    ``set_sync_debug_mode("error")``: attention through row 3 once per
    layer and step, and no host sync."""
    from repro_torch.models import lm
    cfg = _card_smoke()
    params = lm.init(cfg, torch.Generator(device=cuda_device).manual_seed(0),
                     device="cuda")
    cache = lm.init_cache(cfg, 4, 64, device="cuda")
    tok = torch.ones(4, dtype=torch.int32, device=cuda_device)
    fin = torch.zeros(4, dtype=torch.bool, device=cuda_device)
    lm.decode_step(params, cfg, tok[:, None], cache)   # builds the kernels
    torch.cuda.synchronize()
    before = dict(ops.LAUNCHES)
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(8):
            logits, cache = lm.decode_step(params, cfg, tok[:, None], cache)
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            nxt = torch.where(fin, 0, nxt).to(torch.int32)
            fin = fin | (nxt == 2)
            tok = nxt
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert ops.LAUNCHES["decode_attention"] - before[
        "decode_attention"] == 8 * cfg.num_layers
    assert ops.LAUNCHES["paged_decode_attention"] == before[
        "paged_decode_attention"]
    assert cache["pos"].tolist() == [9] * 4


# ------------------------------------------------------- the serving stack


@pytest.mark.cuda
@pytest.mark.parametrize("kv_layout", ["paged", "dense"])
def test_sampled_decode_chunk_never_syncs(cuda_device, kv_layout):
    """A sampled decode chunk of the engine (each slot's token drawn from
    its counter-based stream) under ``set_sync_debug_mode("error")``: no
    host sync, and each row's tokens inside the vocabulary."""
    from repro_torch.models import lm
    from repro_torch.serve import Request, ServeConfig, ServeEngine
    cfg = _card_smoke()
    params = lm.init(cfg, torch.Generator(device=cuda_device).manual_seed(0),
                     device="cuda")
    eng = ServeEngine(cfg, params, ServeConfig(
        max_len=64, num_slots=3, temperature=0.8, rng=4,
        kv_layout=kv_layout, page_size=8), device="cuda")
    for i in range(3):
        eng.submit(Request(uid=i, tokens=np.arange(1, 6 + i),
                           max_new_tokens=40))
    eng.step()                  # admission (syncs) and a first chunk
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        toks = eng._decode_steps()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    toks = toks.cpu()
    assert toks.shape == (3, eng.decode_chunk)
    assert ((toks >= 0) & (toks < cfg.vocab_size)).all()


@pytest.mark.cuda
def test_sampling_noise_bits_equal_the_cpu(cuda_device):
    """The counter-based Gumbel noise at qwen2.5-0.5b's padded vocabulary
    for many (seed, uid, token index) on the card equals the CPU's bit for
    bit, and so do the tokens drawn from the same f32 logits."""
    from repro_torch.serve import sampling
    vocab = 151936
    keys = [sampling.stream_key(seed, uid) for seed in (0, 7, 2**40 + 3)
            for uid in (0, 1, 12345, 2**33)]
    skey = torch.tensor(keys, dtype=torch.int64)
    ctr = torch.arange(len(keys), dtype=torch.int64) * 37
    g_cpu = sampling.gumbel(skey, ctr, vocab)
    g_card = sampling.gumbel(skey.to(cuda_device), ctr.to(cuda_device),
                             vocab).cpu()
    assert torch.equal(g_cpu.view(torch.int32), g_card.view(torch.int32))
    logits = torch.randn(len(keys), vocab,
                         generator=torch.Generator().manual_seed(1))
    t_cpu = sampling.sample(logits, 0.8, skey, ctr)
    t_card = sampling.sample(logits.to(cuda_device), 0.8,
                             skey.to(cuda_device), ctr.to(cuda_device))
    assert torch.equal(t_cpu, t_card.cpu())


@pytest.mark.cuda
def test_prefix_admission_writes_to_the_sink(cuda_device):
    """f32, page 8, ``prefill_rows=4``: a whole-prompt hit copies its
    boundary page on write, and the batch's pad rows send their
    copy-on-write and KV writes to the pool's sink page. No device assert,
    the tokens equal the prefix-off engine's, and only the tree's pages
    stay live."""
    from repro_torch.models import lm
    from repro_torch.serve import Request, ServeConfig, ServeEngine
    cfg = _card_smoke().replace(dtype="float32")
    params = lm.init(cfg, torch.Generator(device=cuda_device).manual_seed(0),
                     device="cuda")
    rng = np.random.default_rng(11)
    prefix = rng.integers(1, cfg.vocab_size, (24,)).astype(np.int32)
    prompts = [np.concatenate([prefix, rng.integers(1, cfg.vocab_size,
                                                    (s,))])
               for s in (5, 9)] + [prefix.copy()]
    kw = dict(max_len=48, num_slots=2, decode_chunk=4, min_bucket=8,
              kv_layout="paged", page_size=8, num_pages=24, prefill_rows=4)
    res = {}
    for on in (False, True):
        eng = ServeEngine(cfg, params, ServeConfig(prefix_cache=on, **kw),
                          device="cuda")
        res[on] = eng.run([Request(uid=i, tokens=p, max_new_tokens=6,
                                   arrival=2 * i)
                           for i, p in enumerate(prompts)])
        torch.cuda.synchronize()
    assert eng.stats["prefix_hits"] == 2, eng.stats
    assert res[True].completions[2].prefix_pages == 2   # the COW hit
    for uid in res[False]:
        np.testing.assert_array_equal(res[True][uid], res[False][uid])
    assert eng.page_pool_stats()["live_pages"] == eng._prefix.cached_pages


@pytest.mark.cuda
def test_lora_step_on_the_card_equals_the_cpu(cuda_device):
    """One f32 LoRA step (TF32 off) on the card and on the CPU from one
    state: the loss within 1e-5 relative, each adapter leaf's update within
    1e-2 of the CPU's (relative L2, as ``chip_smoke.py`` phase 8 holds
    them: Adam's first step is lr * sign(g), so a gradient within rounding
    of zero may flip), the count advanced; the card ran the model's kernels
    and no selection kernel."""
    from repro_torch.configs.base import OptimizerConfig, TrainConfig
    from repro_torch.core import partition as part
    from repro_torch.train.trainer import Trainer
    tcfg = TrainConfig(
        model=_card_smoke().replace(dtype="float32"), method="lora",
        optimizer=OptimizerConfig(lr=1e-3, schedule="constant",
                                  warmup_steps=0, lora_rank=4),
        seq_len=48, global_batch=4, steps=1, log_every=1)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        card = Trainer(tcfg, device="cuda")
        cpu = Trainer(tcfg, device="cpu")
        cpu.state = part.tree_map(lambda x: x.cpu().clone(), {
            k: v for k, v in card.state.items() if k != "step"})
        cpu.state["step"] = 0
        before = [x.clone() for x in part.leaves(cpu.state["lora"])]
        ops.reset_launches()
        card.train(1)
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)
        cpu.train(1)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    lc, lh = card.log.losses[0], cpu.log.losses[0]
    assert abs(lc - lh) <= 1e-5 * abs(lh), (lc, lh)
    for a, b, a0 in zip(part.leaves(card.state["lora"]),
                        part.leaves(cpu.state["lora"]), before):
        dc, dh = a.cpu() - a0, b - a0
        if dh.norm() == 0:
            assert not dc.any()
        else:
            assert ((dc - dh).norm() / dh.norm()).item() <= 1e-2
    assert card.state["opt"]["count"].item() == 1.0
    assert all(launches[n] > 0 for n in (
        "rmsnorm", "rmsnorm_bwd_dx", "flash_attention_fwd",
        "flash_attention_bwd_dq", "flash_attention_bwd_dkv")), launches
    assert all(launches[n] == 0 for n in (
        "rmsnorm_bwd", "block_grad_sq_norms", "masked_adamw",
        "banked_masked_adamw")), launches


@pytest.mark.cuda
def test_lora_steps_never_sync(cuda_device):
    """Three LoRA steps of the smoke config, batch uploads included, under
    ``set_sync_debug_mode("error")``: the unmasked AdamW's count and bias
    corrections stay on the card, so no step reads a value back."""
    from repro_torch.configs.base import OptimizerConfig, TrainConfig
    from repro_torch.train.trainer import Trainer
    tr = Trainer(TrainConfig(model=_card_smoke(), method="lora",
                             optimizer=OptimizerConfig(lora_rank=4),
                             seq_len=48, global_batch=4, steps=4),
                 device="cuda")
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
    assert state["step"] == 4 and state["opt"]["count"].item() == 4
    assert torch.isfinite(metrics["loss"]).item()
