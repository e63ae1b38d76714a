"""The port's flash attention (rows 4-6) and segment masking against the JAX
package's, on the CPU.

The port's plain versions (``kernels/ref.py``), which its wrappers run for
CPU tensors and which the card holds its CUDA kernels to, against the JAX
Pallas kernels run in interpret mode with 32-wide tiles, so that several
tiles, the causal bounds and cross-segment tiles run; and the port's
``ops.flash_attention`` with autograd against the JAX ``ops.flash_attention``
and ``jax.grad`` with respect to the UNEXPANDED k and v (the JAX wrapper
head-expands them; XLA's gather transpose sums dk/dv per kv head, which the
port's dk/dv kernel does in place). Inputs come from numpy with a seed.
Tolerances: f32 1e-5, bf16 2e-2 (``tests/test_kernels.py::_tol``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa
from repro.kernels import ops as jops
from repro.models.layers import attention_core as jcore
from repro_torch.kernels import ops, ref
from repro_torch.models.layers import attention_core as core

B, S, D = 2, 96, 32
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
HMAPS = {"gqa": np.array([0, 0, 1, 1]),
         # 3 real q heads padded to 4, clamped onto the last kv head
         "padded": np.minimum(np.arange(4), 1)}


def _segments(b, s):
    """Packed rows: segments across the 32-wide tiles and a pad tail."""
    seg = np.zeros((b, s), np.int32)
    seg[0, :20], seg[0, 20:61], seg[0, 61:80] = 1, 2, 3
    seg[1, :37], seg[1, 37:] = 1, 2
    return seg


def _inputs(hmap, seed=0):
    rng = np.random.default_rng(seed)
    h, kvh = len(hmap), int(hmap.max()) + 1
    q = rng.standard_normal((B, S, h, D)).astype(np.float32)
    k = rng.standard_normal((B, S, kvh, D)).astype(np.float32)
    v = rng.standard_normal((B, S, kvh, D)).astype(np.float32)
    do = rng.standard_normal((B, S, h, D)).astype(np.float32)
    return q, k, v, do


def _t(a, dtype="float32"):
    return torch.from_numpy(np.array(a)).to(getattr(torch, dtype))


def _np(t):
    return t.detach().float().numpy()


def _jax_kernels(q, k, v, do, hmap, seg, dtype):
    """The JAX Pallas kernels (interpret mode, 32-wide tiles) on the
    head-expanded, head-folded layout; dk/dv summed per kv head."""
    h = len(hmap)
    jd = getattr(jnp, dtype)

    def fold(x):   # [B, S, H, D] -> [B*H, S, D]
        return jnp.asarray(x, jd).transpose(0, 2, 1, 3).reshape(B * h, S, D)
    qf, kf, vf, dof = (fold(x) for x in (q, k[:, :, hmap], v[:, :, hmap],
                                         do))
    segf = (None if seg is None
            else jnp.repeat(jnp.asarray(seg, jnp.float32), h, axis=0))

    @jax.jit
    def run(qf, kf, vf, dof):
        o, lse = jfa.flash_attention_fwd(qf, kf, vf, segf, segf, bq=32,
                                         bk=32)
        return (o, lse, *jfa.flash_attention_bwd(qf, kf, vf, o, lse, dof,
                                                 segf, segf, bq=32, bk=32))
    o, lse, dq, dk, dv = (np.asarray(x, np.float32)
                          for x in run(qf, kf, vf, dof))

    def unfold(x):
        return x.reshape(B, h, S, D).transpose(0, 2, 1, 3)

    def per_kv(x):   # sum the q heads of each kv head
        out = np.zeros((B, S, int(hmap.max()) + 1, D), np.float32)
        np.add.at(out, (slice(None), slice(None), hmap), unfold(x))
        return out
    return (unfold(o), lse.reshape(B, h, S), unfold(dq), per_kv(dk),
            per_kv(dv))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("segmented", [False, True])
@pytest.mark.parametrize("hmap_name", ["gqa", "padded"])
def test_plain_flash_matches_pallas_kernels(hmap_name, segmented, dtype):
    """o, lse, dq, dk and dv of the plain versions against the JAX
    forward, dq and dk/dv kernels."""
    hmap = HMAPS[hmap_name]
    q, k, v, do = _inputs(hmap, seed=len(hmap_name) + segmented)
    seg = _segments(B, S) if segmented else None
    want = _jax_kernels(q, k, v, do, hmap, seg, dtype)
    tq, tk, tv, tdo = (_t(x, dtype) for x in (q, k, v, do))
    hm = _t(hmap).int()
    tseg = None if seg is None else _t(seg).int()
    o, lse = ref.flash_attention_fwd(tq, tk, tv, hm, tseg)
    got = (o, lse, *ref.flash_attention_bwd(tq, tk, tv, o, lse, tdo, hm,
                                            tseg))
    assert o.dtype == tq.dtype and lse.dtype == torch.float32
    for name, g, w in zip(("o", "lse", "dq", "dk", "dv"), got, want):
        tol = TOL["float32"] if name == "lse" else TOL[dtype]
        np.testing.assert_allclose(_np(g), w, err_msg=name, **tol)


@pytest.mark.parametrize("segmented", [False, True])
def test_plain_flash_in_f64_matches_pallas_kernels(segmented):
    """f64 inputs are evaluated in f64 (the card tests' accuracy reference
    for peaked f32 inputs), and agree with the JAX f32 kernels."""
    hmap = HMAPS["gqa"]
    q, k, v, do = _inputs(hmap, seed=11)
    seg = _segments(B, S) if segmented else None
    want = _jax_kernels(q, k, v, do, hmap, seg, "float32")
    tq, tk, tv, tdo = (_t(x, "float64") for x in (q, k, v, do))
    hm = _t(hmap).int()
    tseg = None if seg is None else _t(seg).int()
    o, lse = ref.flash_attention_fwd(tq, tk, tv, hm, tseg)
    got = (o, lse, *ref.flash_attention_bwd(tq, tk, tv, o, lse, tdo, hm,
                                            tseg))
    for name, g, w in zip(("o", "lse", "dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float64, name
        np.testing.assert_allclose(g.numpy(), w, err_msg=name,
                                   **TOL["float32"])


@pytest.mark.parametrize("segmented", [False, True])
def test_ops_flash_attention_grads_match_jax(segmented):
    """The port's ``ops.flash_attention`` and its autograd against the JAX
    ``ops.flash_attention`` and ``jax.grad`` with respect to the
    unexpanded k and v, with padded heads whose output gradient is zero
    (the model's head mask): their dk/dv contribution is exactly 0."""
    hmap = HMAPS["padded"]
    q, k, v, do = _inputs(hmap, seed=5)
    do[:, :, 3] = 0.0          # the padded head, masked at the output
    seg = _segments(B, S) if segmented else None

    def jloss(q, k, v):
        o = jops.flash_attention(q, k[:, :, hmap], v[:, :, hmap],
                                 segment_ids=seg)
        return jnp.sum(o * do), o
    (_, jo), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                     has_aux=True)(q, k, v)
    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    out = ops.flash_attention(tq, tk, tv, _t(hmap).int(),
                              segment_ids=None if seg is None
                              else _t(seg).int())
    out.backward(_t(do))
    np.testing.assert_allclose(_np(out), np.asarray(jo), **TOL["float32"])
    for name, g, w in zip("qkv", (tq.grad, tk.grad, tv.grad), jg):
        np.testing.assert_allclose(_np(g), np.asarray(w), err_msg=name,
                                   **TOL["float32"])
    assert np.all(_np(tq.grad)[:, :, 3] == 0)
    # kv head 1 holds q heads 1..3: without the padded head its dk/dv
    # have the same bits
    do1 = do.copy()
    tq2, tk2, tv2 = (_t(x).requires_grad_() for x in (q, k, v))
    seg_t = None if seg is None else _t(seg).int()
    o2 = ops.flash_attention(tq2[:, :, :3], tk2, tv2,
                             _t(hmap[:3]).int(), segment_ids=seg_t)
    o2.backward(_t(do1[:, :, :3]))
    assert torch.equal(tk2.grad, tk.grad) and torch.equal(tv2.grad, tv.grad)


@pytest.mark.parametrize("chunk_q", [32, 96])
def test_chunked_attention_with_segments_matches_jax(chunk_q):
    """``chunked_attention(segment_ids=...)`` (the ``use_pallas="never"``
    path), over one chunk and over three, against the JAX one."""
    hmap = HMAPS["gqa"]
    q, k, v, _ = _inputs(hmap, seed=9)
    seg = _segments(B, S)
    want = jcore.chunked_attention(q, k, v, hmap=hmap, chunk_q=chunk_q,
                                   segment_ids=jnp.asarray(seg))
    got = core.chunked_attention(_t(q), _t(k), _t(v), hmap=hmap,
                                 chunk_q=chunk_q, segment_ids=_t(seg).int())
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL["float32"])
    # and the flash path's plain version gives the same attention
    flash, _ = ref.flash_attention_fwd(_t(q), _t(k), _t(v), _t(hmap).int(),
                                       _t(seg).int())
    np.testing.assert_allclose(_np(flash), np.asarray(want),
                               **TOL["float32"])
