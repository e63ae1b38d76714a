"""The port's CUDA and Triton kernels against their plain PyTorch versions,
on the card. Marked ``cuda``; without a CUDA device every case skips. This
file imports nothing of JAX, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The sweep follows ``tests/test_kernels.py``: page sizes 4/8/16, scrambled
tables with sentinel entries, mixed valid_len (one position, partial pages,
full rows), the qwen2.5-0.5b head map, f32 and bf16 at its tolerances.
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
