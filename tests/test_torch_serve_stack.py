"""The port's full serving stack against the JAX package's.

Greedy tokens and the ``stats`` counters of ``repro_torch.serve`` must equal
``repro.serve``'s on the same numpy parameters (f32, tokens exact) for
chunked prefill (dense and paged), the radix prefix cache (a whole-prompt
hit with copy-on-write included), grouped prefix admission, preemption
with and without the prefix cache, prefix-aware admission, ``PrefixStore``
adoption across engines and ``generate``. The host structures copied from
the JAX package (``PrefixCache``, ``PrefixAwareAdmission``) are driven side
by side with their originals under the same random operation sequences.

Sampled decoding is held in the port alone (the port's counter-based
streams do not reproduce JAX's threefry bits): one seed repeats its tokens,
a request alone draws what it draws in a batch and across preemption, and
the draws follow ``softmax(logits / T)``. Stream-out, ``close()`` and the
loose-kwargs shim behave as the reference's.
"""
import dataclasses
import json
import warnings
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_shim import given, settings, st

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import lm as jlm
from repro.serve import _oracle as joracle
from repro.serve import engine as jengine
from repro.serve import pages as jpages
from repro.serve import prefix_cache as jprefix
from repro.serve import scheduler as jsched
from repro.serve.config import ServeConfig as JServeConfig
from repro.serve.prefix_store import PrefixStore as JPrefixStore
from repro.serve.scheduler import Request as JRequest
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.models import lm
from repro_torch.serve import (Completion, FCFSScheduler, PageAllocator,
                               PrefixAwareAdmission, PrefixCache,
                               PrefixStore, Request, ServeConfig,
                               ServeEngine, generate, sampling)
from repro_torch.serve._oracle import generate_legacy

OVERRIDES = dict(pad_heads_to=6, vocab_size=250, pad_vocab_multiple=16)
V = 250


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


def _engines(model, store=None, jstore=None, **kw):
    jcfg, jp, cfg, tp = model
    jeng = jengine.ServeEngine(jcfg, jp, JServeConfig(
        **kw, **({"prefix_store": jstore} if jstore is not None else {})))
    teng = ServeEngine(cfg, tp, ServeConfig(
        **kw, **({"prefix_store": store} if store is not None else {})),
        device="cpu")
    return jeng, teng


def _run_both(jeng, teng, work):
    jres = jeng.run([JRequest(**w) for w in work])
    tres = teng.run([Request(**w) for w in work])
    assert set(tres) == set(jres)
    for uid in jres:
        np.testing.assert_array_equal(tres[uid], jres[uid],
                                      err_msg=f"request {uid}")
        for f in ("finish_reason", "first_token_step", "done_step",
                  "prefix_pages"):
            assert (getattr(tres.completions[uid], f)
                    == getattr(jres.completions[uid], f)), (uid, f)
    assert teng.stats == jeng.stats
    assert teng.page_pool_stats() == jeng.page_pool_stats()
    return tres


def _both(model, work, **kw):
    jeng, teng = _engines(model, **kw)
    return jeng, teng, _run_both(jeng, teng, work)


def _mixed(max_new=8, seed=7):
    """Mixed prompt lengths (three buckets), staggered arrivals."""
    rng = np.random.default_rng(seed)
    lens, arrivals = [8, 21, 8, 16, 30, 5], [0, 0, 1, 2, 3, 4]
    return [dict(uid=i, tokens=rng.integers(1, V, (n,)).astype(np.int32),
                 max_new_tokens=max_new, arrival=arrivals[i])
            for i, n in enumerate(lens)]


def _shared_prefix(page_size=8, seed=11, max_new=6):
    """One shared prefix of 3 pages, per-request suffixes, and an exact
    copy of the prefix (the whole-prompt hit: copy-on-write)."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(1, V, (3 * page_size,)).astype(np.int32)
    toks = [np.concatenate([prefix, rng.integers(1, V, (s,))
                            .astype(np.int32)]) for s in (5, 9, 2)]
    toks.append(prefix.copy())
    return [dict(uid=i, tokens=toks[i], max_new_tokens=max_new, arrival=i)
            for i in range(len(toks))]


def _prefix_uneven(seed=29):
    """A 2-page shared prefix, uneven budgets, two requests a step: the
    pool runs dry and the longest-budget resident is preempted."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(1, V, (8,)).astype(np.int32)
    plan = [(3, 4, 0), (5, 14, 0), (2, 6, 1), (6, 14, 1), (4, 8, 2),
            (1, 10, 2)]
    return [dict(uid=i, tokens=np.concatenate(
        [prefix, rng.integers(1, V, (s,)).astype(np.int32)]),
        max_new_tokens=n, arrival=a) for i, (s, n, a) in enumerate(plan)]


def _uneven(seed=13):
    rng = np.random.default_rng(seed)
    return [dict(uid=i, tokens=rng.integers(1, V, (8,)).astype(np.int32),
                 max_new_tokens=n) for i, n in enumerate([4, 12, 6, 12, 8])]


# ------------------------------------------------ greedy parity with JAX


@pytest.mark.parametrize("kv_layout", ["dense", "paged"])
def test_chunked_prefill_matches_jax(model, kv_layout):
    """prefill_chunk=8: the len-30 prompt's bucket of 32 is prefilled in 4
    chunks between decode chunks; tokens and stats equal the JAX engine's
    and the single-shot engine's tokens."""
    kw = dict(max_len=40, num_slots=3, decode_chunk=4, kv_layout=kv_layout,
              page_size=4)
    _, teng, res = _both(model, _mixed(), prefill_chunk=8, **kw)
    assert teng.stats["prefill_chunks"] >= 4, teng.stats
    single = ServeEngine(model[2], model[3], ServeConfig(**kw),
                         device="cpu").run([Request(**w) for w in _mixed()])
    for uid in single:
        np.testing.assert_array_equal(res[uid], single[uid])


def test_prefix_cache_matches_jax(model):
    """One slot, so each completion lands in the tree before the next
    admission: requests 1-3 hit the 24-token prefix, request 3 is a
    whole-prompt hit (copy-on-write, a 1-token prefill); only the tree's
    pages stay live."""
    kw = dict(max_len=48, num_slots=1, decode_chunk=4, min_bucket=8,
              kv_layout="paged", page_size=8, num_pages=32)
    _, teng, res = _both(model, _shared_prefix(), prefix_cache=True, **kw)
    assert teng.stats["prefix_hits"] == 3, teng.stats
    off = ServeEngine(model[2], model[3], ServeConfig(**kw), device="cpu")
    off_res = off.run([Request(**w) for w in _shared_prefix()])
    for uid in off_res:
        np.testing.assert_array_equal(res[uid], off_res[uid])
    saved = 2 * 3 * 8 + (3 * 8 - 1)
    assert (off.stats["prefill_tokens"] - teng.stats["prefill_tokens"]
            == saved)
    assert (teng.page_pool_stats()["live_pages"]
            == teng._prefix.cached_pages)
    assert res.completions[3].prefix_pages == 2


@pytest.mark.parametrize("rows", [1, 4])
def test_grouped_prefix_admission_matches_jax(model, rows):
    """Same-start groups prefill as one [prefill_rows, chunk] call: the
    same tokens and suffix-only prefill tokens as one request a call,
    fewer prefill calls."""
    rng = np.random.default_rng(17)
    prefix = rng.integers(1, V, (16,)).astype(np.int32)
    work = [dict(uid=i, tokens=np.concatenate(
        [prefix, rng.integers(1, V, (5,)).astype(np.int32)]),
        max_new_tokens=6) for i in range(8)]
    kw = dict(max_len=32, num_slots=4, decode_chunk=4, min_bucket=8,
              kv_layout="paged", page_size=8, num_pages=32,
              prefix_cache=True, prefill_rows=rows)
    _, teng, _ = _both(model, work, **kw)
    assert teng.stats["prefix_hits"] > 0
    if rows > 1:
        one = ServeEngine(model[2], model[3],
                          ServeConfig(**{**kw, "prefill_rows": 1}),
                          device="cpu")
        one.run([Request(**w) for w in work])
        assert teng.stats["prefill_tokens"] == one.stats["prefill_tokens"]
        assert teng.stats["prefills"] < one.stats["prefills"]


@pytest.mark.parametrize("prefix_cache", [False, True])
def test_preemption_matches_jax(model, prefix_cache):
    """An oversubscribed pool with preemption: victims requeue at the head
    and re-admit (through the prefix cache when it is on); tokens and
    stats equal the JAX engine's and the ample-pool engine's tokens."""
    work = _prefix_uneven() if prefix_cache else _uneven()
    kw = dict(max_len=32, num_slots=3 if prefix_cache else 4,
              decode_chunk=4, min_bucket=8, kv_layout="paged", page_size=4,
              prefix_cache=prefix_cache)
    small, ample = (8 if prefix_cache else 6), 40
    _, teng, res = _both(model, work, num_pages=small, preempt=True, **kw)
    full = ServeEngine(model[2], model[3],
                       ServeConfig(num_pages=ample, **kw), device="cpu")
    full_res = full.run([Request(**w) for w in work])
    for uid in full_res:
        np.testing.assert_array_equal(res[uid], full_res[uid])
    tree = teng._prefix.cached_pages if prefix_cache else 0
    assert teng.page_pool_stats()["live_pages"] == tree
    assert teng.page_pool_stats()["high_water_pages"] <= small
    assert teng.stats["preempted"] >= 1, teng.stats
    assert (teng.stats["prefix_hits"] > 0) == prefix_cache


def _prefix_aware_work():
    rng = np.random.default_rng(23)
    prefix = rng.integers(1, V, (16,)).astype(np.int32)
    toks = []
    for i in range(10):
        tail = rng.integers(1, V, (3 + (i % 4),))
        toks.append(np.concatenate([prefix, tail]).astype(np.int32)
                    if i % 2 == 0 else
                    rng.integers(1, V, (16 + (i % 5),)).astype(np.int32))
    return [dict(uid=i, tokens=toks[i], max_new_tokens=5, arrival=i // 3)
            for i in range(len(toks))]


def test_prefix_aware_admission_matches_jax(model):
    """admission='prefix_aware' reorders admissions around the tree's
    eviction frontier exactly as the JAX engine does (tokens, stats, the
    policy's counters), and its tokens equal strict FCFS's."""
    kw = dict(max_len=32, num_slots=2, decode_chunk=4, min_bucket=8,
              kv_layout="paged", page_size=8, num_pages=24,
              prefix_cache=True, prefix_cache_pages=6)
    jeng, teng, res = _both(model, _prefix_aware_work(),
                            admission="prefix_aware", admission_max_skips=3,
                            **kw)
    assert teng.admission_policy.stats == jeng.admission_policy.stats
    fcfs = ServeEngine(model[2], model[3],
                       ServeConfig(admission="fcfs", **kw), device="cpu")
    fcfs_res = fcfs.run([Request(**w) for w in _prefix_aware_work()])
    assert set(fcfs_res) == set(res)
    for uid in fcfs_res:
        np.testing.assert_array_equal(res[uid], fcfs_res[uid])


def test_prefix_store_adoption_matches_jax(model):
    """A second engine over the same params and store adopts the first
    one's tree and pools (every admission a hit, suffix-only prefill);
    tokens, stats and the stores' counters equal the JAX side's."""
    rng = np.random.default_rng(21)
    prefix = rng.integers(1, V, (16,)).astype(np.int32)
    work = [dict(uid=i, tokens=np.concatenate(
        [prefix, rng.integers(1, V, (s,)).astype(np.int32)]),
        max_new_tokens=6, arrival=i) for i, s in enumerate(range(3, 7))]
    kw = dict(max_len=48, num_slots=2, decode_chunk=4, min_bucket=8,
              kv_layout="paged", page_size=8, num_pages=32,
              prefix_cache=True)
    store, jstore = PrefixStore(), JPrefixStore()
    first = []
    for wave in range(2):
        jeng, teng = _engines(model, store=store, jstore=jstore, **kw)
        assert store.stats == jstore.stats
        res = _run_both(jeng, teng, work)
        if wave:
            assert teng.stats["prefix_hits"] == len(work)
            assert teng.stats["prefill_tokens"] < first[0]
            for uid in res:
                np.testing.assert_array_equal(res[uid], first[1][uid])
        first = [teng.stats["prefill_tokens"], res]
        tree = teng._prefix.cached_pages
        assert teng.page_pool_stats()["live_pages"] == tree > 0
        jeng.close()
        teng.close()
        assert store.stats == jstore.stats and len(store) == 1
        assert store.cached_pages() == jstore.cached_pages() == tree
    other = {k: v for k, v in model[3].items()}
    other["final_norm"] = {"scale": model[3]["final_norm"]["scale"] + 1}
    ServeEngine(model[2], other, ServeConfig(prefix_store=store, **kw),
                device="cpu")
    assert store.stats["misses"] == 2 and len(store) == 1


def test_generate_matches_jax_and_legacy(model):
    """Module-level ``generate`` (the engine) equals the port's static
    batch loop and the JAX ``generate``, with and without EOS."""
    jcfg, jp, cfg, tp = model
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, V, (3, 16)).astype(np.int32)}
    want = np.asarray(jengine.generate(jp, jcfg, batch, max_new_tokens=10))
    got = generate(tp, cfg, batch, max_new_tokens=10, device="cpu")
    leg = generate_legacy(tp, cfg, batch, max_new_tokens=10, device="cpu")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(leg, want)
    eos = int(want[0, 4])
    want = joracle.generate_legacy(jp, jcfg, batch, max_new_tokens=10,
                                   eos_id=eos)
    np.testing.assert_array_equal(
        generate(tp, cfg, batch, max_new_tokens=10, eos_id=eos,
                 device="cpu"), want)
    np.testing.assert_array_equal(
        generate_legacy(tp, cfg, batch, max_new_tokens=10, eos_id=eos,
                        device="cpu"), want)


def test_prefill_chunk_and_insert_starts_match_jax(model):
    """``lm.prefill_chunk`` (two chunks over a scratch) against the JAX
    function: the carried logits and the scratch; then
    ``insert_slots_paged(starts=...)`` against JAX's: pad rows, positions
    below ``start`` and at or past ``length`` never reach a live page."""
    jcfg, jp, cfg, tp = model
    rng = np.random.default_rng(4)
    toks = rng.integers(0, V, (2, 16)).astype(np.int32)
    lengths = np.array([13, 6], np.int32)
    jc = jlm.init_cache(jcfg, 2, 16)
    jscr = {"k": jc["k"], "v": jc["v"]}
    jlast = jnp.zeros((2, jcfg.padded_vocab_size), jnp.float32)
    tscr = {k: torch.zeros(v.shape) for k, v in jscr.items()}
    tlast = torch.zeros((2, cfg.padded_vocab_size))
    for start in (0, 8):
        jlast, jscr = jlm.prefill_chunk(jp, jcfg, toks[:, start:start + 8],
                                        jscr, start, lengths, jlast)
        tlast, tscr = lm.prefill_chunk(
            tp, cfg, torch.as_tensor(toks[:, start:start + 8]), tscr, start,
            torch.as_tensor(lengths), tlast)
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), rtol=1e-4,
                               atol=1e-4)
    for k in ("k", "v"):
        np.testing.assert_allclose(tscr[k].numpy(), np.asarray(jscr[k]),
                                   rtol=1e-4, atol=1e-4)
    ps, num_pages = 4, 6
    table = np.full((3, 4), num_pages, np.int32)
    table[2, :3] = [5, 1, 3]
    table[0, :2] = [0, 4]
    jcache = {**jlm.init_paged_cache(jcfg, 3, 16, ps, num_pages),
              "pages": jnp.asarray(table)}
    jout = jlm.insert_slots_paged(jcache, jscr, np.array([2, 3], np.int32),
                                  lengths, starts=5)
    tcache = lm.init_paged_cache(cfg, 3, 16, ps, num_pages, device="cpu")
    tcache["pages"] = torch.as_tensor(table)
    lm.insert_slots_paged(tcache, tscr, np.array([2, 3], np.int32), lengths,
                          starts=5)
    np.testing.assert_array_equal(tcache["pos"].numpy(),
                                  np.asarray(jout["pos"]))
    for k in ("k", "v"):
        np.testing.assert_allclose(tcache[k][:, :num_pages].numpy(),
                                   np.asarray(jout[k]), rtol=1e-4,
                                   atol=1e-4)
    # slot 2: positions 0-3 on page 5, 4-7 on page 1; below start 5 nothing
    assert not tcache["k"][:, 5].any() and not tcache["k"][:, 1, :1].any()
    assert tcache["k"][:, 1, 1:].abs().sum() > 0


# --------------------------------------- host structures against JAX's


def _tree_ops(seed, n_ops, capacity, mine, ref):
    """The same random insert / match / evict / lru_pages sequence on the
    port's tree and allocator and the reference's."""
    rng = np.random.default_rng(seed)
    slot_cycle = 0
    for _ in range(n_ops):
        op = int(rng.integers(0, 4))
        tokens = rng.integers(0, 3, int(rng.integers(4, 20)))
        touch, n_evict = bool(rng.random() < 0.7), int(rng.integers(1, 4))
        out = []
        for cache, alloc in (mine, ref):
            if op == 0:
                n_pages = -(-len(tokens) // 4)
                if not alloc.can_allocate(n_pages):
                    cache.evict(n_pages)
                slot = slot_cycle % 8
                if alloc.can_allocate(n_pages) and not alloc._used[slot]:
                    alloc.allocate(slot, n_pages)
                    nfull = len(tokens) // 4
                    out.append(cache.insert(
                        tokens[:nfull * 4],
                        [int(p) for p in alloc.table[slot, :nfull]]))
                    alloc.free(slot)
            elif op == 1:
                out.append(cache.match(tokens, touch=touch))
            elif op == 2:
                out.append(cache.evict(n_evict))
            else:
                out.append(cache.lru_pages(3))
        if op == 0:
            slot_cycle += 1
        assert out[0] == out[1] if len(out) == 2 else not out, (op, out)
        assert mine[0].snapshot() == ref[0].snapshot()
        np.testing.assert_array_equal(mine[1].refcount, ref[1].refcount)
        assert (mine[1].refcount >= 0).all()
        assert mine[0].cached_pages <= capacity


@settings(max_examples=15, deadline=None)
@given(seed=st.integers(0, 10**6), n_ops=st.integers(5, 40),
       capacity=st.integers(0, 32))
def test_prefix_cache_matches_jax_under_random_ops(seed, n_ops, capacity):
    """Inserts, matches, evictions and frontier reads give the same pages,
    snapshots and refcounts as the reference's tree; a full eviction
    drains every reference the tree holds."""
    trees = []
    for pc, pa in ((PrefixCache, PageAllocator),
                   (jprefix.PrefixCache, jpages.PageAllocator)):
        alloc = pa(num_pages=64, num_slots=8, pages_per_slot=8)
        trees.append((pc(4, capacity, alloc.incref, alloc.decref), alloc))
    _tree_ops(seed, n_ops, capacity, *trees)
    for cache, alloc in trees:
        for page in cache.snapshot().values():
            assert alloc.refcount[page] >= 1
        cache.evict(cache.cached_pages + 1)
        assert cache.cached_pages == 0 and (alloc.refcount == 0).all()
        assert alloc.free_pages == alloc.num_pages


def test_aliased_page_survives_eviction_until_slot_frees():
    """A tree page aliased by a resident stays live through its eviction
    and returns to the free list when the slot frees."""
    alloc = PageAllocator(num_pages=8, num_slots=2, pages_per_slot=4)
    cache = PrefixCache(4, 8, alloc.incref, alloc.decref)
    alloc.allocate(0, 2)
    cache.insert(np.arange(8), [int(p) for p in alloc.table[0, :2]])
    pages = [int(p) for p in alloc.table[0, :2]]
    alloc.free(0)
    alloc.alias(1, cache.match(np.arange(8)), 1)
    assert sorted(cache.evict(2)) == sorted(pages)
    assert all(alloc.refcount[p] == 1 for p in pages)
    alloc.free(1)
    assert (alloc.refcount == 0).all() and alloc.free_pages == 8


def _sched_requests(seed, n):
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, 25, n)
    arrivals = np.sort(rng.integers(0, 4, n))
    return [dict(uid=i, tokens=np.zeros(lens[i], np.int32),
                 max_new_tokens=1, arrival=int(arrivals[i]))
            for i in range(n)]


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 10**6), n=st.integers(1, 24),
       free_slots=st.integers(1, 4), max_skips=st.integers(1, 5),
       hot_frac=st.sampled_from([0.0, 0.3, 0.7, 1.0]))
def test_prefix_aware_admission_matches_jax(seed, n, free_slots, max_skips,
                                            hot_frac):
    """Under the same frontier pressure the port's policy pivots the same
    groups as the reference's, with the same counters; every request is
    admitted once and none is bypassed more than ``max_skips`` times."""
    rng = np.random.default_rng(seed)
    reqs = _sched_requests(seed, n)
    hot = {r["uid"] for r in reqs if rng.random() < hot_frac}
    scheds, bypassed = [], Counter()
    for policy_cls, sched_cls, req_cls in (
            (PrefixAwareAdmission, FCFSScheduler, Request),
            (jsched.PrefixAwareAdmission, jsched.FCFSScheduler,
             JRequest)):
        policy = policy_cls(lambda r: {1} if r.uid in hot else set(),
                            lambda: {1}, max_skips=max_skips)
        sch = sched_cls(policy)
        for r in reqs:
            sch.submit(req_cls(**r))
        scheds.append(sch)
    mine, ref = scheds
    orig = mine.policy.on_admit

    def on_admit(admitted, skipped):
        bypassed.update(r.uid for r in skipped)
        orig(admitted, skipped)
    mine.policy.on_admit = on_admit
    now, drained = 0, []
    while ref.pending:
        a = mine.next_group(free_slots, now=now)
        b = ref.next_group(free_slots, now=now)
        assert [r.uid for r in a] == [r.uid for r in b]
        assert mine.next_arrival() == ref.next_arrival()
        drained += [r.uid for r in a]
        now += 1
    assert mine.pending == 0 and len(mine) == 0
    assert sorted(drained) == [r["uid"] for r in reqs]
    assert mine.policy.stats == ref.policy.stats
    assert all(c <= max_skips for c in bypassed.values())


def test_admission_policy_base_is_fcfs():
    """The base policy and a policy-less scheduler group alike; grouping
    defaults to ``Request.signature``."""
    reqs = _sched_requests(5, 12)
    plain = FCFSScheduler()
    based = FCFSScheduler(jsched.AdmissionPolicy())
    for r in reqs:
        plain.submit(Request(**r))
        based.submit(Request(**r))
    while plain.pending:
        assert ([r.uid for r in plain.next_group(3)]
                == [r.uid for r in based.next_group(3)])
    assert Request(**reqs[0]).signature() == JRequest(**reqs[0]).signature()


# ------------------------------------------------ sampling (port alone)


def _sampled(model, work, num_slots, seed=2, **kw):
    cfg, tp = model[2], model[3]
    base = dict(max_len=40, num_slots=num_slots, decode_chunk=4,
                temperature=0.8, rng=seed)
    eng = ServeEngine(cfg, tp, ServeConfig(**{**base, **kw}), device="cpu")
    return eng, eng.run([Request(**w) for w in work])


def test_sampling_repeats_with_its_seed(model):
    _, a = _sampled(model, _mixed(), 3)
    _, b = _sampled(model, _mixed(), 3)
    _, c = _sampled(model, _mixed(), 3, seed=torch.Generator().manual_seed(3))
    _, d = _sampled(model, _mixed(), 3, seed=3)
    greedy = ServeEngine(model[2], model[3], ServeConfig(
        max_len=40, num_slots=3, decode_chunk=4), device="cpu").run(
            [Request(**w) for w in _mixed()])
    for uid in a:
        np.testing.assert_array_equal(a[uid], b[uid])
        np.testing.assert_array_equal(c[uid], d[uid])
    assert any(not np.array_equal(a[u], c[u]) for u in a)
    assert any(not np.array_equal(a[u], greedy[u]) for u in a)


@pytest.mark.parametrize("kv_layout", ["dense", "paged"])
def test_sampled_request_alone_equals_batched(model, kv_layout):
    """A request's tokens do not depend on what shares its batch, its slot
    or its admission order (chunked prefill included)."""
    _, full = _sampled(model, _mixed(), 3, kv_layout=kv_layout, page_size=4,
                       prefill_chunk=8)
    for w in _mixed()[:4]:
        _, solo = _sampled(model, [{**w, "arrival": 0}], 1,
                           kv_layout=kv_layout, page_size=4)
        np.testing.assert_array_equal(full[w["uid"]], solo[w["uid"]])


@pytest.mark.parametrize("prefix_cache", [False, True])
def test_sampled_preemption_is_exact(model, prefix_cache):
    """Sampled tokens with preemption equal those without: the stream
    resumes at the request's next token index."""
    work = _prefix_uneven() if prefix_cache else _uneven()
    kw = dict(kv_layout="paged", page_size=4, min_bucket=8,
              prefix_cache=prefix_cache, max_len=32)
    _, ample = _sampled(model, work, 3, num_pages=60, **kw)
    peng, pre = _sampled(model, work, 3, num_pages=8 if prefix_cache else 6,
                         preempt=True, **kw)
    assert peng.stats["preempted"] >= 1, peng.stats
    for uid in ample:
        np.testing.assert_array_equal(pre[uid], ample[uid],
                                      err_msg=f"request {uid}")


def test_sampled_grouped_prefix_admission_is_exact(model):
    rng = np.random.default_rng(17)
    prefix = rng.integers(1, V, (16,)).astype(np.int32)
    work = [dict(uid=i, tokens=np.concatenate(
        [prefix, rng.integers(1, V, (5,)).astype(np.int32)]),
        max_new_tokens=6) for i in range(8)]
    kw = dict(kv_layout="paged", page_size=8, num_pages=32, min_bucket=8,
              prefix_cache=True, max_len=32)
    _, one = _sampled(model, work, 4, prefill_rows=1, **kw)
    _, grp = _sampled(model, work, 4, prefill_rows=4, **kw)
    for uid in one:
        np.testing.assert_array_equal(grp[uid], one[uid])


def test_sampling_follows_softmax():
    """Draws of the counter-based streams match softmax(logits / T): a
    chi-square over 8 outcomes, across token indices and across uids."""
    logits = torch.tensor([1.0, 0.5, -0.3, 2.0, 0.0, -1.0, 0.7, 1.5])
    p = torch.softmax(logits / 0.8, -1).numpy()
    n = 40000
    for skey, ctr in (
            (torch.full((n,), sampling.stream_key(3, 7)), torch.arange(n)),
            (torch.tensor([sampling.stream_key(3, i) for i in range(n)]),
             torch.zeros(n, dtype=torch.int64))):
        toks = sampling.sample(logits.expand(n, -1), 0.8, skey, ctr)
        freq = np.bincount(toks.numpy(), minlength=8) / n
        chi2 = float((((freq - p) ** 2) / p).sum() * n)
        assert chi2 < 24.3, (chi2, freq, p)    # 7 dof, p = 0.001


def test_noise_log_is_accurate_and_exact():
    """The noise's logarithm from float32 + - * / within 3e-7 of log, and
    bit-repeatable; the noise is a pure function of (key, index)."""
    x = torch.cat([torch.rand(20000) * 20 + 1e-7,
                   torch.tensor([1.0, 2.0, 0.5, 1e-7, 1.4142135])])
    rel = ((sampling._log(x).double() - torch.log(x.double())).abs()
           / torch.log(x.double()).abs().clamp(min=1e-3))
    assert rel.max() < 3e-7
    sk = torch.tensor([sampling.stream_key(0, 5), sampling.stream_key(1, 5)])
    g = sampling.gumbel(sk, torch.tensor([4, 4]), 300)
    assert torch.equal(g, sampling.gumbel(sk, torch.tensor([4, 4]), 300))
    assert not torch.equal(g[0], g[1])
    assert torch.equal(g[0], sampling.gumbel(sk[:1], torch.tensor([4]),
                                             300)[0])


def test_generate_sampled_takes_the_legacy_loop(model):
    cfg, tp = model[2], model[3]
    batch = {"tokens": np.random.default_rng(3).integers(0, V, (2, 8))}
    a = generate(tp, cfg, batch, max_new_tokens=6, temperature=0.7, rng=5,
                 device="cpu")
    b = generate_legacy(tp, cfg, batch, max_new_tokens=6, temperature=0.7,
                        rng=torch.Generator().manual_seed(5), device="cpu")
    np.testing.assert_array_equal(a, b)


# ------------------------------------------------------ other behaviour


def test_stream_out_delivers_and_reraises(model):
    cfg, tp = model[2], model[3]
    got = {}
    kw = dict(max_len=40, num_slots=3, decode_chunk=4)
    eng = ServeEngine(cfg, tp, ServeConfig(
        on_complete=lambda c: got.__setitem__(c.uid, c), **kw),
        device="cpu")
    res = eng.run([Request(**w) for w in _mixed(max_new=4)])
    assert set(got) == set(res)
    for uid in res:
        assert isinstance(got[uid], Completion)
        np.testing.assert_array_equal(got[uid].tokens, res[uid])
        assert got[uid].done_step >= got[uid].first_token_step

    def boom(comp):
        raise RuntimeError("detok failed")
    beng = ServeEngine(cfg, tp, ServeConfig(on_complete=boom, **kw),
                       device="cpu")
    with pytest.raises(RuntimeError, match="detok failed"):
        beng.run([Request(**w) for w in _mixed(max_new=4)])
    inline = {}
    ieng = ServeEngine(cfg, tp, ServeConfig(
        on_complete=lambda c: inline.__setitem__(c.uid, c.tokens),
        stream_out=False, **kw), device="cpu")
    ieng.run([Request(**w) for w in _mixed(max_new=4)])
    assert set(inline) == set(res)


def test_close_on_busy_engine_raises(model):
    cfg, tp = model[2], model[3]
    eng = ServeEngine(cfg, tp, ServeConfig(max_len=40, num_slots=3,
                                           prefill_chunk=8), device="cpu")
    eng.submit(Request(uid=0, tokens=np.ones(20, np.int32),
                       max_new_tokens=4))
    eng.step()
    assert eng._job is not None
    with pytest.raises(RuntimeError, match="busy engine"):
        eng.close()
    eng.run()
    eng.close()
    eng.close()
    with pytest.raises(RuntimeError, match="closed"):
        eng.step()


def test_loose_kwargs_shim_warns_and_matches(model):
    cfg, tp = model[2], model[3]
    got = {}
    with pytest.warns(DeprecationWarning, match="ServeConfig"):
        leg_eng = ServeEngine(cfg, tp, max_len=40, num_slots=3,
                              decode_chunk=4, device="cpu",
                              on_complete=lambda uid, t:
                              got.__setitem__(uid, t))
    assert leg_eng.serve_cfg.max_len == 40
    leg = leg_eng.run([Request(**w) for w in _mixed(max_new=4)])
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        new = ServeEngine(cfg, tp, ServeConfig(max_len=40, num_slots=3,
                                               decode_chunk=4),
                          device="cpu").run(
            [Request(**w) for w in _mixed(max_new=4)])
    assert set(leg) == set(new) == set(got)
    for uid in new:
        np.testing.assert_array_equal(leg[uid], new[uid])
        np.testing.assert_array_equal(got[uid], new[uid])
    with pytest.raises(TypeError, match="both a ServeConfig"):
        ServeEngine(cfg, tp, ServeConfig(max_len=40, num_slots=1),
                    decode_chunk=4, device="cpu")


@pytest.mark.parametrize("feature", [
    dict(kv_layout="paged", prefix_cache=True),
    dict(kv_layout="paged", preempt=True), dict(prefill_chunk=8),
    dict(temperature=0.7), dict(on_complete=lambda c: None),
    dict(kv_layout="paged", prefix_cache=True, admission="prefix_aware",
         prefix_store=PrefixStore())])
def test_features_are_served(model, feature):
    """Each feature the port used to refuse builds an engine that serves."""
    eng = ServeEngine(model[2], model[3],
                      ServeConfig(max_len=24, num_slots=2, min_bucket=8,
                                  **feature), device="cpu")
    res = eng.run([Request(uid=0, tokens=np.arange(1, 19), max_new_tokens=3)])
    assert len(res[0]) == 3 and (res[0] < V).all()


def test_serve_launcher_takes_the_stack_flags(capsys, tmp_path):
    """The launcher's flags of the reference run on the CPU; ``--trace``
    and ``--metrics-json`` write a trace that validates and a snapshot
    with the engine's latency histograms."""
    from repro_torch.launch import serve as launch_serve
    base = ["--arch", "qwen2.5-0.5b", "--smoke", "--device", "cpu",
            "--new-tokens", "6", "--prompt-len", "24"]
    assert launch_serve.main(base + [
        "--kv-layout", "paged", "--page-size", "8", "--prefix-cache",
        "--preempt", "--admission", "prefix_aware", "--persist-prefix",
        "--temperature", "0.8"]) == 0
    out = capsys.readouterr().out
    assert "2nd wave" in out and "prefix store: 1 adoptions" in out
    assert launch_serve.main(base + ["--prefill-chunk", "8"]) == 0
    assert '"prefill_chunks": 4' in capsys.readouterr().out
    from repro_torch import obs
    trace, snap = tmp_path / "t.json", tmp_path / "m.json"
    assert launch_serve.main(base + ["--trace", str(trace), "--metrics-json",
                                     str(snap)]) == 0
    assert not obs.enabled()
    names = {e["name"] for e in obs.validate_trace_file(str(trace))}
    assert {"admission", "decode_chunk", "e2e", "ttft"} <= names
    doc = json.loads(snap.read_text())
    assert doc["serve"]["e2e_us"]["count"] == 4
