"""The port's banked moment residency (paper §3.3) and its two repairs, on
the CPU.

- Tied scores: ``topk_mask`` takes the lower index first, as ``lax.top_k``.
- Port only: banked equals dense bit for bit for every policy and for a
  schedule that evicts and re-admits blocks (the embedding included);
  async equals sync equals dense bit for bit through the ``Trainer``; the
  swap planner's hit, miss, disabled and quiesce contracts.
- Against the JAX package: ``plan_swap``, ``predict_next`` (the JAX draws
  injected) and a five-step banked ``topk_grad`` trajectory from an
  exported JAX banked TrainState (losses 1e-5, masks and slot_map exact,
  moments 1e-6).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs.base import OptimizerConfig as JOptimizerConfig
from repro.configs.base import SelectConfig as JSelectConfig
from repro.configs.base import TrainConfig as JTrainConfig
from repro.core import adagradselect as jsel
from repro.core import masked_adamw as jadamw
from repro.core import partition as jpart
from repro.core import selection as jselection
from repro.train.trainer import Trainer as JTrainer
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import (ModelConfig, OptimizerConfig,
                                      SelectConfig, TrainConfig)
from repro_torch.core import adagradselect, masked_adamw, swap
from repro_torch.core import partition as part
from repro_torch.core import selection
from repro_torch.models import lm
from repro_torch.train.trainer import Trainer

POLICIES = ("all", "random", "topk_grad", "adagradselect", "lisa", "grass")
# untied (an lm_head block), 4 layers: 7 blocks; vocab 32 holds the
# synthetic math task's tokens
TINY = ModelConfig(name="banked-tiny", family="dense", num_layers=4,
                   d_model=16, num_heads=2, num_kv_heads=2, head_dim=8,
                   d_ff=32, vocab_size=32, dtype="float32", remat="none",
                   tie_embeddings=False)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def _bits_equal_trees(a, b, what=""):
    la, lb = part.leaves(a), part.leaves(b)
    assert len(la) == len(lb)
    for i, (x, y) in enumerate(zip(la, lb)):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.view(torch.int32), y.view(torch.int32)), \
            f"{what} leaf {i}"


# ------------------------------------------------------------- repairs


@pytest.mark.parametrize("scores, k", [(np.zeros(26, np.float32), 5),
                                       (np.array([1, 2, 2, 2, 0],
                                                 np.float32), 2)],
                         ids=["zeros26-k5", "mixed-k2"])
def test_topk_mask_ties_match_lax_top_k(scores, k):
    want = np.asarray(jselection.topk_mask(jnp.asarray(scores), k))
    got = _np(selection.topk_mask(torch.from_numpy(scores), k))
    np.testing.assert_array_equal(got, want)
    assert np.nonzero(got)[0].tolist() == (
        [0, 1, 2, 3, 4] if k == 5 else [1, 2])


# ----------------------------------------------- banked == dense, port only


def _tiny_params(seed=0):
    return lm.init(TINY, torch.Generator().manual_seed(seed), device="cpu")


def _grads_like(params, step):
    """Deterministic synthetic grads that vary per step (a nonzero mean)."""
    rng = np.random.default_rng(100 + step)
    return part.tree_map(
        lambda p: torch.from_numpy(
            (0.01 * (0.5 + rng.standard_normal(p.shape))).astype(
                np.float32)).to(p.dtype), params)


def _clone(tree):
    return part.tree_map(lambda t: t.clone(), tree)


# block ids of TINY: 0 embed, 1-4 layers, 5 final_norm, 6 lm_head. Evicts
# and re-admits layers, and admits the embedding at step 0, evicts it at
# step 1, admits it again at step 2 and evicts it at step 3.
SCHEDULE = ([0, 1, 2], [1, 3], [0, 2, 5], [2, 4, 6], [0, 1, 2], [1, 3, 4],
            [0])


@pytest.mark.parametrize("policy", POLICIES + ("schedule",))
def test_banked_bit_exact_vs_dense(policy):
    """Seven steps of the same (grads, mask, lr) through the dense update
    and the banked layout (sync boundaries): params, the materialised
    moments and the counts equal bit for bit at every step."""
    pn = part.build_partition(TINY)
    nb = pn.num_blocks
    scfg = SelectConfig(policy=policy if policy != "schedule" else "random",
                        k_percent=40, steps_per_epoch=4, epsilon_decay=0.1,
                        lisa_interval=3, always_include=(0,))
    cap = min(nb, scfg.num_selected(nb) + len(scfg.always_include))
    ocfg = OptimizerConfig(lr=1e-2, weight_decay=0.01)
    params = _tiny_params()
    params_d, params_b = _clone(params), _clone(params)
    opt_d = masked_adamw.init_opt_state(pn, params_d)
    opt_b = masked_adamw.init_banked_opt_state(pn, params_b, cap, "host")
    sel_state = adagradselect.init_state(nb, seed=3, policy=scfg.policy,
                                         k=cap)
    resident_embed = []
    for step in range(7):
        grads = _grads_like(params_b, step)
        if policy == "schedule":
            mask = torch.zeros(nb, dtype=torch.bool)
            mask[SCHEDULE[step]] = True
        else:
            norms = part.block_grad_norms(pn, grads)
            mask, sel_state = adagradselect.select(scfg, sel_state, norms,
                                                   nb)
            assert sel_state["indices"].shape == (cap,)
        masked_adamw.update(ocfg, pn, params_d, grads, opt_d, mask, 1e-2)
        opt_b["slot_map"] = masked_adamw.swap_banked(
            pn, opt_b["banks"], opt_b["store"], opt_b["slot_map"],
            _np(mask))
        masked_adamw.banked_update(ocfg, pn, params_b, grads,
                                   opt_b["banks"], opt_b["counts"], mask,
                                   1e-2)
        resident_embed.append(bool(opt_b["slot_map"][0] >= 0))
        _bits_equal_trees(params_d, params_b, f"params step {step}")
        m_full, v_full = masked_adamw.materialize_moments(pn, opt_b)
        _bits_equal_trees(opt_d["m"], m_full, f"m step {step}")
        _bits_equal_trees(opt_d["v"], v_full, f"v step {step}")
        assert torch.equal(opt_d["counts"], opt_b["counts"])
    if policy == "schedule":
        assert resident_embed[:4] == [True, False, True, False]


def test_swap_moves_store_rows_and_bank_rows():
    """A boundary admits the store's rows (not zeros) into the banks and
    writes evicted bank rows back to the store, the embedding's whole leaf
    included: admit {embed, 1, 2}, change the banks, then swap to {2, 3}."""
    pn = part.build_partition(TINY)
    nb = pn.num_blocks
    opt = masked_adamw.init_banked_opt_state(pn, _tiny_params(), 3, "host")
    g = torch.Generator().manual_seed(5)
    for leaf in part.leaves(opt["store"]):
        leaf.copy_(torch.randn(leaf.shape, generator=g))
    before = _clone(opt["store"])
    mask = np.zeros(nb, bool)
    mask[[0, 1, 2]] = True
    opt["slot_map"] = masked_adamw.swap_banked(
        pn, opt["banks"], opt["store"], opt["slot_map"], mask)
    m, v = masked_adamw.materialize_moments(pn, opt)
    _bits_equal_trees({k: before[k]["m"] for k in before}, m, "admitted m")
    _bits_equal_trees({k: before[k]["v"] for k in before}, v, "admitted v")
    for leaf in part.leaves({k: {"m": b["m"], "v": b["v"]}
                             for k, b in opt["banks"].items()}):
        leaf.mul_(2.0)    # what an update would do to the resident rows
    m2, v2 = masked_adamw.materialize_moments(pn, opt)
    mask[:] = False
    mask[[2, 3]] = True
    opt["slot_map"] = masked_adamw.swap_banked(
        pn, opt["banks"], opt["store"], opt["slot_map"], mask)
    assert opt["slot_map"][0] == -1 and opt["slot_map"][1] == -1
    emb = opt["store"]["embed"]["m"]["tok"]
    assert torch.equal(emb, 2 * before["embed"]["m"]["tok"])
    m3, v3 = masked_adamw.materialize_moments(pn, opt)
    _bits_equal_trees(m2, m3, "m after eviction")
    _bits_equal_trees(v2, v3, "v after eviction")


def _banked_tcfg(policy, residency, async_swap=True, steps=5):
    return TrainConfig(
        model=TINY, method=policy,
        select=SelectConfig(k_percent=40, steps_per_epoch=10,
                            epsilon_decay=0.05),
        optimizer=OptimizerConfig(
            lr=1e-2, schedule="constant", warmup_steps=0,
            moment_residency=residency,
            offload="host" if residency == "banked" else "none",
            async_swap=async_swap),
        seq_len=48, global_batch=4, steps=steps, seed=0, log_every=0)


@pytest.mark.parametrize("policy", ["random", "adagradselect"])
def test_trainer_async_equals_sync_equals_dense(policy):
    runs = {}
    for name, res, asy in (("dense", "device", True),
                           ("sync", "banked", False),
                           ("async", "banked", True)):
        tr = Trainer(_banked_tcfg(policy, res, asy), device="cpu")
        tr.train()
        runs[name] = tr
    dense, sync, asyn = runs["dense"], runs["sync"], runs["async"]
    pn = part.build_partition(TINY)
    for tr in (sync, asyn):
        assert tr.log.losses == dense.log.losses
        _bits_equal_trees(dense.state["params"], tr.state["params"])
        m, v = masked_adamw.materialize_moments(pn, tr.state["opt"])
        _bits_equal_trees(dense.state["opt"]["m"], m)
        _bits_equal_trees(dense.state["opt"]["v"], v)
        assert torch.equal(dense.state["opt"]["counts"],
                           tr.state["opt"]["counts"])
    s_stats, a_stats = sync.step_fn.swap_stats, asyn.step_fn.swap_stats
    assert s_stats.dispatches == 0 and s_stats.predicted_hits == 0
    assert s_stats.sync_swaps == s_stats.boundaries >= 1
    assert a_stats.dispatches == 5 and a_stats.boundaries >= 1
    assert a_stats.predicted_hits + a_stats.sync_swaps == a_stats.boundaries
    # the first step's boundary has no prediction in flight
    assert a_stats.sync_swaps == a_stats.mispredicts + 1
    # the reference's rate counts that boundary against the planner
    assert a_stats.predicted_hit_rate == (a_stats.predicted_hits
                                          / a_stats.boundaries)
    if policy == "random":   # predicted exactly
        assert a_stats.mispredicts == 0 and a_stats.dispatched_hit_rate == 1
        assert a_stats.predicted_hit_rate == ((a_stats.boundaries - 1)
                                              / a_stats.boundaries)


# ---------------------------------------------------------- the planner


def _planner_fixture(cap=2):
    pn = part.build_partition(TINY)
    params = _tiny_params()
    opt = masked_adamw.init_banked_opt_state(pn, params, cap, "host")
    # nonzero store rows, so admissions and evictions move visible values
    for leaf in part.leaves(opt["store"]):
        leaf.copy_(torch.randn(leaf.shape,
                               generator=torch.Generator().manual_seed(7)))
    return pn, opt


def _copy_opt(opt):
    return {"banks": _clone(opt["banks"]),
            "slot_map": np.array(opt["slot_map"]),
            "counts": opt["counts"].clone(), "store": _clone(opt["store"])}


def _sel_cfg(policy="random"):
    return SelectConfig(policy=policy, k_percent=40, steps_per_epoch=6,
                        epsilon_decay=0.1, lisa_interval=3)


def _ids_mask(nb, ids):
    m = np.zeros(nb, bool)
    m[ids[ids < nb]] = True
    return m


def _assert_opt_equal(a, b):
    np.testing.assert_array_equal(a["slot_map"], b["slot_map"])
    _bits_equal_trees({k: {"m": v["m"], "v": v["v"]}
                       for k, v in a["banks"].items()},
                      {k: {"m": v["m"], "v": v["v"]}
                       for k, v in b["banks"].items()}, "banks")
    for key in a["banks"]:
        assert torch.equal(a["banks"][key]["slots"],
                           b["banks"][key]["slots"])
    _bits_equal_trees(a["store"], b["store"], "store")


def test_planner_hit_leaves_only_the_commit():
    """Dispatch with the state that makes the next selection, resolve with
    that selection: the result equals the synchronous swap bit for bit, and
    the boundary counts as a predicted hit with no fallback."""
    pn, opt = _planner_fixture(cap=3)
    nb = pn.num_blocks
    cfg = _sel_cfg("random")
    sel = adagradselect.init_state(nb, seed=1, policy="random", k=3)
    _, sel = adagradselect.select(cfg, sel, torch.zeros(nb), nb)
    opt["slot_map"] = masked_adamw.swap_banked(
        pn, opt["banks"], opt["store"], opt["slot_map"],
        _ids_mask(nb, _np(sel["indices"])))
    ref = _copy_opt(opt)
    planner = swap.SwapPlanner(pn, nb, enabled=True)
    pred = _np(adagradselect.predict_next(cfg, sel, nb))
    planner.dispatch(pred, opt["banks"], opt["store"], opt["slot_map"])
    _, sel_next = adagradselect.select(cfg, sel, torch.zeros(nb), nb)
    idx = _np(sel_next["indices"])
    np.testing.assert_array_equal(pred, idx)
    ref["slot_map"] = masked_adamw.swap_banked(
        pn, ref["banks"], ref["store"], ref["slot_map"], _ids_mask(nb, idx))
    opt["slot_map"] = planner.resolve(idx, opt["banks"], opt["store"],
                                      opt["slot_map"])
    planner.quiesce()
    _assert_opt_equal(opt, ref)
    assert planner.stats.predicted_hits == planner.stats.boundaries == 1
    assert planner.stats.sync_swaps == 0


def test_planner_mispredict_falls_back_and_counts():
    pn, opt = _planner_fixture(cap=2)
    nb = pn.num_blocks
    cfg = _sel_cfg("random")
    sel = adagradselect.init_state(nb, seed=1, policy="random", k=2)
    _, sel = adagradselect.select(cfg, sel, torch.zeros(nb), nb)
    opt["slot_map"] = masked_adamw.swap_banked(
        pn, opt["banks"], opt["store"], opt["slot_map"],
        _ids_mask(nb, _np(sel["indices"])))
    planner = swap.SwapPlanner(pn, nb, enabled=True)
    pred = _np(adagradselect.predict_next(cfg, sel, nb))
    ref = _copy_opt(opt)
    planner.dispatch(pred, opt["banks"], opt["store"], opt["slot_map"])
    wrong = np.sort((pred + 1) % nb)   # a selection it did not predict
    assert not np.array_equal(wrong, pred)
    ref["slot_map"] = masked_adamw.swap_banked(
        pn, ref["banks"], ref["store"], ref["slot_map"],
        _ids_mask(nb, wrong))
    opt["slot_map"] = planner.resolve(wrong, opt["banks"], opt["store"],
                                      opt["slot_map"])
    planner.quiesce()
    assert planner.stats.sync_swaps == planner.stats.boundaries == 1
    assert planner.stats.mispredicts == 1
    assert planner.stats.predicted_hits == 0
    assert planner.stats.predicted_hit_rate == 0
    assert planner.stats.dispatched_hit_rate == 0
    np.testing.assert_array_equal(opt["slot_map"], ref["slot_map"])
    # the banks equal the synchronous swap's; the store may also hold the
    # inert writebacks of predicted evictions, whose blocks stay resident
    m_got, v_got = masked_adamw.materialize_moments(pn, opt)
    m_ref, v_ref = masked_adamw.materialize_moments(pn, ref)
    _bits_equal_trees(m_got, m_ref, "m")
    _bits_equal_trees(v_got, v_ref, "v")


def test_planner_disabled_never_dispatches():
    pn, opt = _planner_fixture(cap=2)
    nb = pn.num_blocks
    sel = adagradselect.init_state(nb, seed=0, policy="random", k=2)
    planner = swap.SwapPlanner(pn, nb, enabled=False)
    planner.dispatch(np.array([1, 2]), opt["banks"], opt["store"],
                     opt["slot_map"])
    assert planner._pending is None and planner.stats.dispatches == 0
    planner.resolve(np.array([1, 2]), opt["banks"], opt["store"],
                    opt["slot_map"])
    assert planner.stats.sync_swaps == 1   # still served, synchronously
    assert planner.stats.mispredicts == 0
    assert sel["indices"].shape == (2,)


def test_planner_quiesce_drains_pending():
    pn, opt = _planner_fixture(cap=2)
    nb = pn.num_blocks
    planner = swap.SwapPlanner(pn, nb, enabled=True)
    planner.dispatch(np.array([1, 2]), opt["banks"], opt["store"],
                     opt["slot_map"])
    assert planner._pending is not None
    planner.quiesce()
    assert planner._pending is None
    # the dropped job leaves no boundary behind: the next one is sync
    planner.resolve(np.array([1, 2]), opt["banks"], opt["store"],
                    opt["slot_map"])
    assert planner.stats.sync_swaps == 1 and planner.stats.predicted_hits == 0
    assert planner.stats.mispredicts == 0


# ------------------------------------------------ against the JAX package


def test_plan_swap_matches_reference():
    """Random residencies and masks: the same plans as the reference, and
    the same overflow."""
    jcfg = jax_smoke_config("qwen2.5-0.5b").replace(num_layers=6)
    cfg = get_smoke_config("qwen2.5-0.5b").replace(num_layers=6)
    jpn, pn = jpart.build_partition(jcfg), part.build_partition(cfg)
    nb = pn.num_blocks
    caps = {"embed": 1, "layers": 3, "final_norm": 1}
    rng = np.random.default_rng(0)
    fields = [f.name for f in dataclasses.fields(masked_adamw.GroupSwapPlan)]
    for _ in range(60):
        slot_map = np.full(nb, -1, np.int32)
        for g in pn.groups:
            ids = rng.choice(g.length, rng.integers(0, caps[g.key] + 1),
                             replace=False)
            slot_map[g.start + ids] = rng.permutation(caps[g.key])[:len(ids)]
        mask = rng.random(nb) < 0.4
        try:
            want = jadamw.plan_swap(jpn, slot_map, mask, caps)
        except RuntimeError as e:
            with pytest.raises(RuntimeError, match="bank overflow"):
                masked_adamw.plan_swap(pn, slot_map, mask, caps)
            assert "bank overflow" in str(e)
            continue
        got = masked_adamw.plan_swap(pn, slot_map, mask, caps)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            for f in fields:
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    over = np.zeros(nb, bool)
    over[1:5] = True   # 4 layers for 3 slots
    with pytest.raises(RuntimeError, match="bank overflow"):
        masked_adamw.plan_swap(pn, np.full(nb, -1, np.int32), over, caps)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_scatter_rows_match_reference(dtype):
    """Free-slot sentinels (= L) drop their writes. (The port has no
    ``gather_rows``: row 9 and its plain version read rows through the
    slots themselves.)"""
    rng = np.random.default_rng(6)
    leaf = rng.standard_normal((5, 3, 4)).astype(np.float32)
    rows = rng.standard_normal((4, 3, 4)).astype(np.float32)
    slots = np.array([3, 5, 0, 5], np.int32)
    jleaf, jrows = jnp.asarray(leaf, dtype), jnp.asarray(rows, dtype)
    tdt = getattr(torch, dtype)
    tleaf = torch.from_numpy(leaf).to(tdt)
    tslots = torch.from_numpy(slots)
    out = part.scatter_rows(tleaf.clone(), tslots,
                            torch.from_numpy(rows).to(tdt))
    want = jpart.scatter_rows(jleaf, jnp.asarray(slots), jrows)
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(want, np.float32))


def _jax_draws(jc, jstate, n):
    """The noise the reference's next ``select`` draws at this state."""
    key = jax.random.fold_in(jstate["key"], jstate["step"])
    k_eps, k_dir, k_gum, k_rnd = jax.random.split(key, 4)
    d = {"eps": jax.random.uniform(k_eps),
         "gum": jax.random.gumbel(k_gum, (n,)),
         "rnd": jax.random.uniform(k_rnd, (n,))}
    if "freq" in jstate:
        alpha = jstate["freq"].astype(jnp.float32) + jc.dirichlet_delta
        d["dir"] = jax.random.dirichlet(k_dir, alpha)
    return {k: torch.tensor(np.asarray(v)) for k, v in d.items()}


@pytest.mark.parametrize("policy", POLICIES)
def test_predict_next_matches_reference(policy):
    """Five post-select states of both packages (norms and draws shared):
    the port's prediction with the reference's draws injected equals the
    reference's; for the policies that read no norms the port's own
    prediction also equals its next selection."""
    nb, seed = 12, 3
    kw = dict(policy=policy, k_percent=25.0, epsilon_decay=0.3,
              steps_per_epoch=3, lisa_interval=2, always_include=(0,))
    jc, tc = JSelectConfig(**kw), SelectConfig(**kw)
    k = tc.num_selected(nb) + 1
    jstate = jsel.init_state(nb, seed, policy=policy, k=k)
    tstate = adagradselect.init_state(nb, seed, policy=policy, k=k)
    own = adagradselect.init_state(nb, seed, policy=policy, k=k)
    rng = np.random.default_rng(1)
    for i in range(5):
        norms = rng.random(nb).astype(np.float32)
        draws = _jax_draws(jc, jstate, nb)
        _, jstate = jsel.select(jc, jstate, jnp.asarray(norms), nb)
        _, tstate = adagradselect.select(tc, tstate, torch.from_numpy(norms),
                                         nb, draws=draws)
        want = np.asarray(jsel.predict_next(jc, jstate, nb))
        got = adagradselect.predict_next(tc, tstate, nb,
                                         draws=_jax_draws(jc, jstate, nb))
        np.testing.assert_array_equal(_np(got), want, err_msg=f"step {i}")
        _, own = adagradselect.select(tc, own, torch.from_numpy(norms), nb)
        if policy in ("random", "lisa", "all"):
            pred = adagradselect.predict_next(tc, own, nb)
            _, nxt = adagradselect.select(tc, own, torch.zeros(nb), nb)
            assert torch.equal(pred, nxt["indices"]), f"step {i}"


OVERRIDES = dict(pad_heads_to=6, vocab_size=250, pad_vocab_multiple=16)


def test_banked_trainer_trajectory_vs_jax():
    """Five banked ``topk_grad`` steps of both Trainers from the JAX
    trainer's initial banked state (exported and converted) and the same
    batches: losses to 1e-5, masks and slot_map equal, the materialised
    moments to 1e-6."""
    jcfg = jax_smoke_config("qwen2.5-0.5b").replace(**OVERRIDES)
    cfg = get_smoke_config("qwen2.5-0.5b").replace(**OVERRIDES)
    kw = dict(seq_len=48, global_batch=4, steps=5, seed=0, log_every=0,
              method="topk_grad")
    sk = dict(k_percent=40, steps_per_epoch=10, epsilon_decay=0.05)
    ok = dict(lr=1e-2, schedule="constant", warmup_steps=0,
              moment_residency="banked", offload="host", async_swap=True)
    jtr = JTrainer(JTrainConfig(model=jcfg, select=JSelectConfig(**sk),
                                optimizer=JOptimizerConfig(**ok), **kw))
    ttr = Trainer(TrainConfig(model=cfg, select=SelectConfig(**sk),
                              optimizer=OptimizerConfig(**ok), **kw),
                  device="cpu")
    ttr.state = convert.train_state_from_numpy(jax.device_get(jtr.state),
                                               cfg, "cpu", offload="host")
    assert set(ttr.state["opt"]) == {"banks", "slot_map", "counts", "store"}
    jlog, tlog = jtr.train(), ttr.train()
    np.testing.assert_allclose(tlog.losses, jlog.losses, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(_np(ttr.state["sel"]["mask"]),
                                  np.asarray(jtr.state["sel"]["mask"]))
    np.testing.assert_array_equal(ttr.state["opt"]["slot_map"],
                                  np.asarray(jtr.state["opt"]["slot_map"]))
    np.testing.assert_array_equal(_np(ttr.state["opt"]["counts"]),
                                  np.asarray(jtr.state["opt"]["counts"]))
    jm, jv = jadamw.materialize_moments(jpart.build_partition(jcfg),
                                        jtr.state["opt"])
    tm, tv = masked_adamw.materialize_moments(part.build_partition(cfg),
                                              ttr.state["opt"])
    for t_tree, j_tree in ((tm, jm), (tv, jv)):
        jl = jax.tree_util.tree_leaves(j_tree)
        tl = part.leaves(t_tree)
        assert len(jl) == len(tl)
        for t, j in zip(tl, jl):
            np.testing.assert_allclose(_np(t), np.asarray(j), rtol=1e-6,
                                       atol=1e-6)
