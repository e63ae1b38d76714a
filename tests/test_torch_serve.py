"""The port's serve engine against the JAX package's.

Greedy tokens of ``repro_torch.serve.ServeEngine.run`` must equal
``repro.serve.ServeEngine.run`` token for token on a staggered mixed-length
workload with fewer slots than requests, dense and paged, in f32, on the
same numpy parameters; the engines' counters must agree too. The host-side
pieces copied from the JAX package (page allocator, FCFS scheduler, serve
config validation) are pinned against their originals.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import lm as jlm
from repro.serve import pages as jpages
from repro.serve import scheduler as jsched
from repro.serve.config import ServeConfig as JServeConfig
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.scheduler import Request as JRequest
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.serve import (FCFSScheduler, PageAllocator, PoolExhausted,
                               Request, ServeConfig, ServeEngine)

OVERRIDES = dict(pad_heads_to=6, vocab_size=250, pad_vocab_multiple=16)


@pytest.fixture(scope="module")
def model():
    jcfg = jax_smoke_config("qwen2.5-0.5b").replace(**OVERRIDES)
    cfg = get_smoke_config("qwen2.5-0.5b").replace(**OVERRIDES)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    shapes = jax.eval_shape(lambda k: jlm.init(k, jcfg),
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
    rng = np.random.default_rng(0)

    def leaf(path, s):
        base = 1.0 if path[-1].key == "scale" else 0.0
        return (base + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
    npp = jax.tree_util.tree_map_with_path(leaf, shapes)
    return (jcfg, jax.tree.map(jnp.asarray, npp), cfg,
            convert.params_from_numpy(npp, cfg, "cpu"))


LENS = [8, 21, 8, 16, 30, 5]
ARRIVALS = [0, 0, 1, 2, 3, 4]


def _workload(vocab, max_new=8, seed=7):
    """Mixed prompt lengths (three buckets), staggered arrivals."""
    rng = np.random.default_rng(seed)
    toks = [rng.integers(1, vocab, (n,)).astype(np.int32) for n in LENS]
    return [dict(uid=i, tokens=toks[i], max_new_tokens=max_new,
                 arrival=ARRIVALS[i]) for i in range(len(LENS))]


def _both(model, work, **kw):
    jcfg, jp, cfg, tp = model
    jeng = JServeEngine(jcfg, jp, JServeConfig(**kw))
    jres = jeng.run([JRequest(**w) for w in work])
    teng = ServeEngine(cfg, tp, ServeConfig(**kw), device="cpu")
    tres = teng.run([Request(**w) for w in work])
    assert set(tres) == set(jres)
    for uid in jres:
        np.testing.assert_array_equal(tres[uid], jres[uid],
                                      err_msg=f"request {uid}")
        assert (tres.completions[uid].finish_reason
                == jres.completions[uid].finish_reason)
    return jeng, teng, tres


@pytest.mark.parametrize("kv_layout", ["dense", "paged"])
def test_engine_matches_jax_engine(model, kv_layout):
    kw = dict(max_len=40, num_slots=3, decode_chunk=4, kv_layout=kv_layout,
              page_size=4)
    jeng, teng, _ = _both(model, _workload(250), **kw)
    assert teng.stats == jeng.stats
    assert teng.stats["completed"] == len(LENS)
    if kv_layout == "paged":
        assert teng.page_pool_stats() == jeng.page_pool_stats()
        assert teng.page_pool_stats()["live_pages"] == 0


def test_engine_eos_and_prefill_rows_match_jax(model):
    """EOS terminates a slot on the device; grouped [2, bucket] prefills."""
    kw = dict(max_len=40, num_slots=3, decode_chunk=4, kv_layout="paged",
              page_size=8, prefill_rows=2)
    work = _workload(250, max_new=10)
    jcfg, jp, _, _ = model
    first = JServeEngine(jcfg, jp, JServeConfig(**kw)).run(
        [JRequest(**w) for w in work])
    eos = int(first[1][3])   # a token the model emits mid-sequence
    jeng, teng, res = _both(model, work, eos_id=eos, **kw)
    assert teng.stats == jeng.stats
    assert any(c.finish_reason == "eos" for c in res.completions.values())


def test_backpressure_matches_jax(model):
    """An undersized pool: admission pushes what does not fit back to the
    queue head; tokens still equal the JAX engine's."""
    kw = dict(max_len=40, num_slots=3, decode_chunk=4, kv_layout="paged",
              page_size=4, num_pages=12)
    jeng, teng, _ = _both(model, _workload(250), **kw)
    assert teng.stats["backpressure"] > 0
    assert teng.stats == jeng.stats
    dense = ServeEngine(model[2], model[3],
                        ServeConfig(max_len=40, num_slots=3), device="cpu")
    assert teng.kv_cache_bytes() < dense.kv_cache_bytes()


def test_pool_exhausted_at_submit(model):
    jcfg, jp, cfg, tp = model
    kw = dict(max_len=32, num_slots=4, kv_layout="paged", page_size=4,
              num_pages=5)
    # 8 prompt + 20 new = 28 positions = 7 pages > 5-page pool
    with pytest.raises(PoolExhausted, match="grow num_pages"):
        ServeEngine(cfg, tp, ServeConfig(**kw), device="cpu").submit(
            Request(uid=9, tokens=np.ones(8, np.int32), max_new_tokens=20))
    with pytest.raises(jpages.PoolExhausted, match="grow num_pages"):
        JServeEngine(jcfg, jp, JServeConfig(**kw)).submit(
            JRequest(uid=9, tokens=np.ones(8, np.int32), max_new_tokens=20))


def _alloc_ops(seed, n_ops=300):
    rng = np.random.default_rng(seed)
    return [(int(rng.integers(0, 4)), int(rng.integers(0, 6)),
             int(rng.integers(1, 5))) for _ in range(n_ops)]


def _apply(alloc, op, slot, n):
    """One allocator operation; returns the error type or the outcome."""
    try:
        if op == 0:
            if not alloc.can_allocate(n):
                return "deferred"
            alloc.allocate(slot, n)
        elif op == 1:
            alloc.free(slot)
        elif op == 2:
            live = [s for s in range(alloc.num_slots)
                    if alloc.table[s, 0] < alloc.num_pages and s != slot]
            if live:
                shared = [int(p) for p in alloc.table[live[0], :1]]
                alloc.alias(slot, shared, max(0, n - 1))
        else:
            alloc.incref(int(alloc.table[slot, 0]) % alloc.num_pages)
            alloc.decref(int(alloc.table[slot, 0]) % alloc.num_pages)
    except (RuntimeError, ValueError) as e:
        return type(e).__name__
    return "ok"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_page_allocator_matches_jax(seed):
    """Same operation sequence on both allocators: same outcomes, tables,
    refcounts and stats; refcounts never negative, and a page is on the
    free list exactly when its refcount is 0."""
    mine = PageAllocator(16, 6, 5)
    ref = jpages.PageAllocator(16, 6, 5)
    for op in _alloc_ops(seed):
        assert _apply(mine, *op) == _apply(ref, *op), op
        np.testing.assert_array_equal(mine.table, ref.table)
        np.testing.assert_array_equal(mine.refcount, ref.refcount)
        assert (mine.refcount >= 0).all()
        free = set(mine._free)
        assert free == {p for p in range(16) if mine.refcount[p] == 0}
    assert mine.stats() == ref.stats()


def test_scheduler_fcfs_matches_jax():
    """FCFS grouping by key, arrival gating and push_front restoring queue
    order, against the JAX scheduler with no admission policy."""
    rng = np.random.default_rng(3)
    reqs = [dict(uid=i, tokens=np.ones(int(rng.integers(1, 40)), np.int32),
                 max_new_tokens=2, arrival=float(rng.integers(0, 4)))
            for i in range(30)]
    reqs.sort(key=lambda r: r["arrival"])
    mine, ref = FCFSScheduler(), jsched.FCFSScheduler()
    for r in reqs:
        mine.submit(Request(**r))
        ref.submit(JRequest(**r))

    def key(r):
        return min(32, 1 << max(0, r.prompt_len - 1).bit_length())
    now = 0
    while ref.pending:
        free = int(rng.integers(1, 4))
        a = mine.next_group(free, now=now, key=key)
        b = ref.next_group(free, now=now, key=key)
        assert [r.uid for r in a] == [r.uid for r in b]
        if a and rng.random() < 0.3:   # backpressure the tail
            mine.push_front(a[1:])
            ref.push_front(b[1:])
        now += 1
    assert mine.pending == 0


@pytest.mark.parametrize("bad", [
    dict(max_len=0), dict(decode_chunk=0), dict(kv_layout="ring"),
    dict(min_bucket=12), dict(page_size=0), dict(prefix_cache=True),
    dict(preempt=True), dict(admission="lifo"), dict(prefill_rows=0)])
def test_serve_config_validation_matches_jax(bad):
    kw = {**dict(max_len=16, num_slots=2), **bad}
    with pytest.raises(ValueError) as want:
        JServeConfig(**kw)
    with pytest.raises(ValueError) as got:
        ServeConfig(**kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("feature", [dict(mesh=object())])
def test_unported_features_raise(feature):
    JServeConfig(max_len=16, num_slots=2, **feature)   # valid for JAX
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ServeConfig(max_len=16, num_slots=2, **feature)
