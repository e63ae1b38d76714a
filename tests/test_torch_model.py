"""The port's dense model against the JAX package's, on the same numpy
parameters and tokens.

The config exercises every trap of the full-width qwen2.5-0.5b at a small
size: padded and zero-masked q heads (pad_heads_to=6 over 4 heads), an hmap
clamp onto the last kv head, the padded-vocab -1e30 logit bias (250 -> 256),
QKV bias and tied embeddings, in f32. Parameter values come from numpy with
a seed (biases and norm scales nonzero), never from JAX's PRNG. Tolerance
1e-4: sums are reordered across layers.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import lm as jlm
from repro.models.layers import attention_core as jcore
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm
from repro_torch.models.layers import attention_core as core

TOL = dict(rtol=1e-4, atol=1e-4)
OVERRIDES = dict(pad_heads_to=6, vocab_size=250, pad_vocab_multiple=16)


def _configs():
    jcfg = jax_smoke_config("qwen2.5-0.5b").replace(**OVERRIDES)
    cfg = get_smoke_config("qwen2.5-0.5b").replace(**OVERRIDES)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jcfg, cfg


def np_params(jcfg, seed=0, dtype=np.float32) -> dict:
    """Numpy parameters in the shapes of ``repro.models.lm.init``."""
    shapes = jax.eval_shape(lambda k: jlm.init(k, jcfg),
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "scale":
            v = 1.0 + 0.1 * rng.standard_normal(s.shape)
        else:   # weights, and biases kept nonzero
            v = 0.1 * rng.standard_normal(s.shape)
        return v.astype(dtype)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def model():
    jcfg, cfg = _configs()
    npp = np_params(jcfg)
    jparams = jax.tree.map(jnp.asarray, npp)
    return jcfg, cfg, jparams, convert.params_from_numpy(npp, cfg, "cpu")


def _close(t, j):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), **TOL)


def _tokens(b, s, vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def test_prefill_logits_with_lengths(model):
    jcfg, cfg, jp, tp = model
    toks = _tokens(3, 16, cfg.vocab_size)
    lengths = np.asarray([16, 9, 1], np.int32)
    jl, jc = jlm.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, 24,
                         lengths=jnp.asarray(lengths))
    tl_, tc = lm.prefill(tp, cfg, {"tokens": torch.from_numpy(toks)}, 24,
                         lengths=torch.from_numpy(lengths))
    _close(tl_, jl)
    _close(tc["k"], jc["k"])
    _close(tc["v"], jc["v"])
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    # the padded vocab rows are masked out
    assert (tl_[:, cfg.vocab_size:] < -1e29).all()
    # and without lengths: logits at the last position
    jl, _ = jlm.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, 16)
    tl_, tc = lm.prefill(tp, cfg, {"tokens": torch.from_numpy(toks)}, 16)
    _close(tl_, jl)
    assert tc["pos"].tolist() == [16, 16, 16]


def test_chunked_attention_matches_jax():
    """Prefill attention over query chunks with the padded-head hmap (the
    reference's lax.scan over chunks is a loop here)."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 16, 6, 8)).astype(np.float32)
    k = rng.standard_normal((2, 16, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 16, 2, 8)).astype(np.float32)
    hmap = np.minimum(np.arange(6) // 2, 1)
    want = jcore.chunked_attention(q, k, v, hmap=hmap, chunk_q=4)
    got = core.chunked_attention(*map(torch.from_numpy, (q, k, v)),
                                 hmap=hmap, chunk_q=4)
    _close(got, want)
    _close(core.full_attention(*map(torch.from_numpy, (q, k, v)), hmap=hmap),
           want)


def _prefilled(model, lengths, max_len):
    jcfg, cfg, jp, tp = model
    toks = _tokens(len(lengths), max(lengths), cfg.vocab_size, seed=2)
    lv = np.asarray(lengths, np.int32)
    jl, jc = jlm.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, max_len,
                         lengths=jnp.asarray(lv))
    tl_, tc = lm.prefill(tp, cfg, {"tokens": torch.from_numpy(toks)},
                         max_len, lengths=torch.from_numpy(lv))
    nxt = np.array(jnp.argmax(jl, -1), np.int32)[:, None]
    return jc, tc, nxt


def test_dense_decode_steps(model):
    """Prefill at mixed lengths, then decode steps against the dense cache:
    every row attends over and writes at its own position."""
    jcfg, cfg, jp, tp = model
    jc, tc, nxt = _prefilled(model, [12, 5, 9], 16)
    for _ in range(3):
        jl, jc = jlm.decode_step(jp, jcfg, jnp.asarray(nxt), jc)
        tl_, tc = lm.decode_step(tp, cfg, torch.from_numpy(nxt), tc)
        _close(tl_, jl)
        nxt = np.array(jnp.argmax(jl, -1), np.int32)[:, None]
    _close(tc["k"], jc["k"])
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


@pytest.mark.parametrize("use_pallas", ["never", "always"])
def test_paged_decode_steps(model, use_pallas):
    """Paged decode over a scrambled page table against JAX's paged
    decode_step (reference gather path, and the Pallas kernel in interpret
    mode). Slot 2 holds no pages (sentinel row) and rides along: its writes
    must drop (into the port's sink page, the one past JAX's pool), so both
    pools stay equal to JAX's."""
    jcfg, cfg, jp, tp = model
    jcfg = jcfg.replace(use_pallas=use_pallas)
    ps, num_pages, max_len = 4, 16, 20
    lengths = [10, 3]
    jc, tc, nxt = _prefilled(model, lengths, 12)
    cache_j = jlm.init_paged_cache(jcfg, 3, max_len, ps, num_pages)
    cache_t = lm.init_paged_cache(cfg, 3, max_len, ps, num_pages,
                                  device="cpu")
    perm = np.random.default_rng(4).permutation(num_pages).astype(np.int32)
    table = np.full((3, 5), num_pages, np.int32)
    table[0, :4] = perm[:4]       # 10 prompt + 3 new -> 4 pages
    table[1, :2] = perm[4:6]      # 3 prompt + 3 new -> 2 pages
    cache_j = {**cache_j, "pages": jnp.asarray(table)}
    cache_t["pages"] = torch.from_numpy(table)
    slots = np.asarray([0, 1], np.int32)
    lv = np.asarray(lengths, np.int32)
    cache_j = jlm.insert_slots_paged(cache_j, jc, slots, lv)
    lm.insert_slots_paged(cache_t, tc, slots, lv)
    assert cache_t["k"].shape[1] == num_pages + 1
    _close(cache_t["k"][:, :num_pages], cache_j["k"])
    tok = np.concatenate([nxt, [[0]]]).astype(np.int32)
    for _ in range(3):
        jl, cache_j = jlm.decode_step(jp, jcfg, jnp.asarray(tok), cache_j)
        tl_, cache_t = lm.decode_step(tp, cfg, torch.from_numpy(tok),
                                      cache_t)
        _close(tl_[:2], jl[:2])
        tok = np.array(jnp.argmax(jl, -1), np.int32)[:, None]
    _close(cache_t["k"][:, :num_pages], cache_j["k"])
    _close(cache_t["v"][:, :num_pages], cache_j["v"])
    np.testing.assert_array_equal(cache_t["pos"].numpy(),
                                  np.asarray(cache_j["pos"]))


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
def test_convert_round_trip(dtype):
    jcfg, cfg = _configs()
    npp = np_params(jcfg, seed=5, dtype=dtype)
    tp = convert.params_from_numpy(npp, cfg, "cpu")
    want_dtype = torch.float32 if dtype == np.float32 else torch.bfloat16
    assert tp["layers"]["attn"]["wq"].dtype == want_dtype
    assert tuple(tp["layers"]["attn"]["wq"].shape) == (3, 64, 6, 16)
    back = convert.params_to_numpy(tp)
    flat_a = jax.tree_util.tree_leaves_with_path(npp)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    # f32 -> bf16 on the way in, when asked
    half = convert.params_from_numpy(npp, cfg, "cpu", dtype=torch.bfloat16)
    assert half["embed"]["tok"].dtype == torch.bfloat16


def test_convert_rejects_mismatched_trees():
    jcfg, cfg = _configs()
    npp = np_params(jcfg)
    bad = {**npp, "embed": {"tok": npp["embed"]["tok"][:-1]}}
    with pytest.raises(ValueError, match="embed/tok"):
        convert.params_from_numpy(bad, cfg, "cpu")
    with pytest.raises(KeyError, match="keys"):
        convert.params_from_numpy({**npp, "lm_head": {}}, cfg, "cpu")


def test_init_shapes_match_jax():
    jcfg, cfg = _configs()
    shapes = jax.eval_shape(lambda k: jlm.init(k, jcfg),
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
    want = jax.tree.map(lambda s: tuple(s.shape), shapes)
    got = lm.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), got) == want
    assert got["layers"]["attn"]["bq"].abs().sum() == 0
    assert isinstance(cfg, ModelConfig)


class _CountSyncs(TorchDispatchMode):
    """Counts the ops that read a device value back to the host."""

    SYNC_OPS = ("aten._local_scalar_dense", "aten.nonzero", "aten.is_nonzero")

    def __init__(self):
        super().__init__()
        self.syncs = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if str(func).startswith(self.SYNC_OPS):
            self.syncs.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("paged", [False, True])
def test_decode_step_never_syncs_the_host(model, paged):
    """A decode step enqueues its work without reading anything back (the
    engine syncs once per decode chunk): no ``.item()``, no data-dependent
    shapes — including the sentinel-drop of paged writes."""
    _, cfg, _, tp = model
    if paged:
        cache = lm.init_paged_cache(cfg, 3, 16, 4, 8, device="cpu")
        cache["pages"][0, :2] = torch.tensor([5, 2], dtype=torch.int32)
    else:
        cache = lm.init_cache(cfg, 3, 16, device="cpu")
    counter = _CountSyncs()
    with counter:
        lm.decode_step(tp, cfg, torch.zeros((3, 1), dtype=torch.int32),
                       cache)
    assert counter.syncs == []
