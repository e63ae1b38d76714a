"""The port's training path against the JAX package's, on the CPU.

Both sides get the same numpy parameters, batches, gradients and states;
nothing relies on JAX's PRNG to make the port's inputs. The config is the
smoke qwen2.5-0.5b in f32 with the full-width traps at a small size: padded
and zero-masked q heads (6 over 4), the padded-vocab logit bias (250 ->
256), QKV bias, tied embeddings and ``remat="full"``. Tolerances: logits
1e-4 and gradients rtol 1e-4 (sums reordered across layers), the loss and
the block norms 1e-5, the optimizer step 1e-6; masks exact.

The stochastic policies draw their noise from a ``torch.Generator`` in the
port and from JAX keys in the reference. Their tests compute the
reference's draws (``fold_in``, ``split``, then ``uniform``/``dirichlet``/
``gumbel``, as ``adagradselect.select`` does) and hand them to the port's
``select``, and then the masks and states must be equal.
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
from repro.models import lm as jlm
from repro.optim.schedules import learning_rate as jlearning_rate
from repro.train import step as jstep
from repro.train.trainer import Trainer as JTrainer
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import (OptimizerConfig, SelectConfig,
                                      TrainConfig)
from repro_torch.core import adagradselect, masked_adamw
from repro_torch.core import partition as part
from repro_torch.models import lm
from repro_torch.optim.schedules import learning_rate
from repro_torch.train import step
from repro_torch.train.trainer import Trainer

OVERRIDES = dict(pad_heads_to=6, vocab_size=250, pad_vocab_multiple=16)
POLICIES = ("all", "random", "topk_grad", "adagradselect", "lisa", "grass")


def _configs():
    jcfg = jax_smoke_config("qwen2.5-0.5b").replace(**OVERRIDES)
    cfg = get_smoke_config("qwen2.5-0.5b").replace(**OVERRIDES)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jcfg, cfg


def _np_tree(shapes, seed, scale=0.1, ones_for_scale=True):
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        v = scale * rng.standard_normal(s.shape)
        if ones_for_scale and path[-1].key == "scale":
            v = 1.0 + v
        return v.astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _param_shapes(jcfg):
    return jax.eval_shape(lambda k: jlm.init(k, jcfg),
                          jax.ShapeDtypeStruct((2,), jnp.uint32))


def _batch(b, s, vocab, seed=1):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (b, s)).astype(np.int32),
            "loss_mask": (rng.random((b, s)) < 0.7).astype(np.float32)}


def _t(tree):
    """numpy tree -> torch tree (CPU)."""
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree).copy())


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def _assert_trees(t_tree, j_tree, **tol):
    jl = jax.tree_util.tree_leaves_with_path(j_tree)
    tl = part.leaves(t_tree)
    assert len(jl) == len(tl)
    for (path, j), t in zip(jl, tl):
        np.testing.assert_allclose(_np(t), np.asarray(j), err_msg=str(path),
                                   **tol)


@pytest.fixture(scope="module")
def model():
    jcfg, cfg = _configs()
    npp = _np_tree(_param_shapes(jcfg), 0)
    return (jcfg, cfg, jax.tree.map(jnp.asarray, npp),
            convert.params_from_numpy(npp, cfg, "cpu"))


# ------------------------------------------------------------ model + loss


def test_apply_train_logits_and_loss(model):
    jcfg, cfg, jp, tp = model
    b = _batch(3, 24, cfg.vocab_size)
    jlog, (jloss, jmet) = jax.jit(lambda p, bb: (
        jlm.apply_train(p, jcfg, bb)[0],
        jstep.model_loss(jlm, jcfg, p, bb)))(jp, jax.tree.map(jnp.asarray,
                                                              b))
    tlog, aux, extra = lm.apply_train(tp, cfg, _t(b))
    assert tlog.shape == (3, 24, cfg.padded_vocab_size) and extra == {}
    np.testing.assert_allclose(_np(tlog), np.asarray(jlog), rtol=1e-4,
                               atol=1e-4)
    tloss, tmet = step.model_loss(cfg, tp, _t(b))
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5,
                               atol=1e-5)
    assert float(aux) == float(jmet["aux_loss"]) == 0.0


def test_gradients_per_leaf(model):
    jcfg, cfg, jp, tp = model
    b = _batch(2, 20, cfg.vocab_size, seed=2)
    jb = jax.tree.map(jnp.asarray, b)
    jg = jax.jit(jax.grad(
        lambda p: jstep.model_loss(jlm, jcfg, p, jb)[0]))(jp)
    (loss, _), tg = step.value_and_grad(
        lambda p, mb: step.model_loss(cfg, p, mb), tp, _t(b))
    assert not loss.requires_grad
    # padded q heads are masked at the output: their weights get no gradient
    wq = _np(tg["layers"]["attn"]["wq"])
    assert np.all(wq[:, :, cfg.num_heads:] == 0)
    _assert_trees(tg, jg, rtol=1e-4, atol=1e-7)


def test_accumulated_gradients_match_one_batch(model):
    """microbatch > 1: the f32-accumulated mean equals the whole batch's
    gradient (equal loss-mask counts per microbatch, as the synthetic data
    has)."""
    jcfg, cfg, jp, tp = model
    b = _batch(4, 16, cfg.vocab_size, seed=3)
    b["loss_mask"] = np.ones_like(b["loss_mask"])
    fn = lambda p, mb: step.model_loss(cfg, p, mb)  # noqa: E731
    (l1, _), g1 = step.accumulate_grads(fn, tp, _t(b), 1)
    (l2, m2), g2 = step.accumulate_grads(fn, tp, _t(b), 2)
    np.testing.assert_allclose(l2.item(), l1.item(), rtol=1e-5)
    assert set(m2) == {"ce_loss", "aux_loss"}
    for a, c in zip(part.leaves(g1), part.leaves(g2)):
        np.testing.assert_allclose(_np(c), _np(a), rtol=1e-4, atol=1e-7)


# ------------------------------------------------------- norms, clip, adamw


def _grads(jcfg, seed=4):
    return _np_tree(_param_shapes(jcfg), seed, scale=1.0,
                    ones_for_scale=False)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_block_grad_norms(use_pallas):
    jcfg, cfg = _configs()
    g = _grads(jcfg)
    jpn = jpart.build_partition(jcfg)
    want = jax.jit(lambda gg: jpart.block_grad_norms(
        jpn, gg, use_pallas=use_pallas))(jax.tree.map(jnp.asarray, g))
    pn = part.build_partition(cfg)
    assert pn.num_blocks == jpn.num_blocks == cfg.num_blocks
    assert pn.block_names == jpn.block_names
    got = part.block_grad_norms(pn, _t(g))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(
        part.params_per_block(pn, _t(g)),
        jpart.params_per_block(jpn, g))


@pytest.mark.parametrize("max_norm", [1.0, 1e6])
def test_clip_by_global_norm(max_norm):
    jcfg, _ = _configs()
    g = _grads(jcfg, seed=5)
    jclipped, jnorm = jadamw.clip_by_global_norm(
        jax.tree.map(jnp.asarray, g), max_norm)
    tclipped, tnorm = masked_adamw.clip_by_global_norm(_t(g), max_norm)
    np.testing.assert_allclose(tnorm.item(), float(jnorm), rtol=1e-5)
    _assert_trees(tclipped, jclipped, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_masked_adamw_update(use_pallas):
    """Some blocks selected (the embedding and layer 1), nonzero moments and
    counts: the port's in-place update equals the reference's, and the
    unselected blocks keep params and moments bit for bit."""
    jcfg, cfg = _configs()
    shapes = _param_shapes(jcfg)
    params, grads = _np_tree(shapes, 6), _np_tree(shapes, 7, scale=1.0)
    m = _np_tree(shapes, 8, scale=0.01, ones_for_scale=False)
    v = jax.tree.map(lambda x: np.abs(x) + 1e-3,
                     _np_tree(shapes, 9, scale=0.01, ones_for_scale=False))
    nb = cfg.num_blocks
    counts = np.arange(nb, dtype=np.float32)
    mask = np.zeros(nb, bool)
    mask[[0, 2]] = True
    ocfg = OptimizerConfig(lr=1e-2, weight_decay=0.1)
    jocfg = JOptimizerConfig(lr=1e-2, weight_decay=0.1)
    jopt = {"m": jax.tree.map(jnp.asarray, m),
            "v": jax.tree.map(jnp.asarray, v),
            "counts": jnp.asarray(counts)}
    jupdate = jax.jit(jadamw.update, static_argnums=(0, 1),
                      static_argnames=("use_pallas",))
    jp2, jo2 = jupdate(jocfg, jpart.build_partition(jcfg),
                       jax.tree.map(jnp.asarray, params),
                       jax.tree.map(jnp.asarray, grads), jopt,
                       jnp.asarray(mask), 3e-3, use_pallas=use_pallas)
    tp, topt = _t(params), {"m": _t(m), "v": _t(v),
                            "counts": torch.from_numpy(counts.copy())}
    tp2, to2 = masked_adamw.update(ocfg, part.build_partition(cfg), tp,
                                   _t(grads), topt, torch.from_numpy(mask),
                                   3e-3)
    assert tp2 is tp and to2 is topt   # in place
    _assert_trees(tp2, jp2, rtol=1e-6, atol=1e-6)
    _assert_trees(to2["m"], jo2["m"], rtol=1e-6, atol=1e-6)
    _assert_trees(to2["v"], jo2["v"], rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(_np(to2["counts"]), np.asarray(jo2["counts"]))
    # unselected: the final norm and layers 0 and 2 keep their bits
    np.testing.assert_array_equal(_np(tp2["final_norm"]["scale"]),
                                  params["final_norm"]["scale"])
    wq = _np(tp2["layers"]["attn"]["wq"])
    np.testing.assert_array_equal(wq[[0, 2]],
                                  params["layers"]["attn"]["wq"][[0, 2]])
    assert not np.array_equal(wq[1], params["layers"]["attn"]["wq"][1])


@pytest.mark.parametrize("schedule", ["constant", "linear", "cosine"])
def test_learning_rate(schedule):
    kw = dict(lr=3e-4, warmup_steps=10, total_steps=100, schedule=schedule)
    for s in (0, 1, 9, 10, 11, 37, 99, 100, 150):
        assert learning_rate(OptimizerConfig(**kw), s) == float(
            jlearning_rate(JOptimizerConfig(**kw), s)), (schedule, s)


# ------------------------------------------------------------- selection


def _jax_draws(jcfg_sel, jstate, n):
    """The noise ``repro.core.adagradselect.select`` draws at this state."""
    key = jax.random.fold_in(jstate["key"], jstate["step"])
    k_eps, k_dir, k_gum, k_rnd = jax.random.split(key, 4)
    d = {"eps": jax.random.uniform(k_eps),
         "gum": jax.random.gumbel(k_gum, (n,)),
         "rnd": jax.random.uniform(k_rnd, (n,))}
    if "freq" in jstate:
        alpha = jstate["freq"].astype(jnp.float32) + jcfg_sel.dirichlet_delta
        d["dir"] = jax.random.dirichlet(k_dir, alpha)
    return {k: torch.tensor(np.asarray(v)) for k, v in d.items()}


@pytest.mark.parametrize("policy", POLICIES)
def test_select_policies(policy):
    """Eight selection steps from the same state under the same norms and
    noise: equal masks and states at every step. The epsilon schedule
    crosses from exploration to exploitation (steps_per_epoch 4), lisa
    resamples every 3 steps, and one block is always included."""
    nb, seed = 12, 3
    kw = dict(policy=policy, k_percent=25.0, epsilon_decay=0.3,
              steps_per_epoch=4, lisa_interval=3, always_include=(0,))
    jc, tc = JSelectConfig(**kw), SelectConfig(**kw)
    k = tc.num_selected(nb) + 1
    jstate = jsel.init_state(nb, seed, policy=policy, k=k)
    tstate = adagradselect.init_state(nb, seed, policy=policy, k=k)
    rng = np.random.default_rng(0)
    for i in range(8):
        norms = rng.random(nb).astype(np.float32)
        draws = _jax_draws(jc, jstate, nb)
        jmask, jstate = jsel.select(jc, jstate, jnp.asarray(norms), nb)
        tmask, tstate = adagradselect.select(tc, tstate,
                                             torch.from_numpy(norms), nb,
                                             draws=draws)
        np.testing.assert_array_equal(_np(tmask), np.asarray(jmask),
                                      err_msg=f"step {i}")
        assert tstate["step"] == int(jstate["step"])
        np.testing.assert_array_equal(_np(tstate["indices"]),
                                      np.asarray(jstate["indices"]))
        for f in ("freq", "cum_norms"):
            if f in jstate:
                np.testing.assert_allclose(_np(tstate[f]),
                                           np.asarray(jstate[f]), rtol=1e-6)
        n_sel = int(tmask.sum())
        assert (n_sel == nb if policy == "all" else k - 1 <= n_sel <= k)
        assert adagradselect.epsilon(tc, i) == float(
            jsel.epsilon(jc, jnp.asarray(i, jnp.int32)))


def test_observe_and_layer_masks():
    """The gate-mode helpers: ``observe`` feeds norms to the cumulative
    signal without selecting; ``layer_masks_dict`` slices the body group's
    mask."""
    jcfg, cfg = _configs()
    nb = cfg.num_blocks
    norms = np.linspace(0.5, 2.0, nb).astype(np.float32)
    mask = np.asarray([True, False, True, True, False])
    for policy in ("adagradselect", "topk_grad"):
        jc, tc = JSelectConfig(policy=policy), SelectConfig(policy=policy)
        js = jsel.observe(jc, jsel.init_state(nb, 0, policy=policy),
                          jnp.asarray(norms))
        ts = adagradselect.observe(
            tc, adagradselect.init_state(nb, 0, policy=policy),
            torch.from_numpy(norms))
        assert set(ts) - {"seed"} == set(js) - {"key"}
        if "cum_norms" in js:
            np.testing.assert_array_equal(_np(ts["cum_norms"]),
                                          np.asarray(js["cum_norms"]))
    jm = jpart.layer_masks_dict(jpart.build_partition(jcfg),
                                jnp.asarray(mask))
    tm = part.layer_masks_dict(part.build_partition(cfg),
                               torch.from_numpy(mask))
    assert set(tm) == set(jm) == {"layers"}
    np.testing.assert_array_equal(_np(tm["layers"]), np.asarray(jm["layers"]))


def test_select_own_draws_are_reproducible():
    """Without injected draws the port's selection depends only on (seed,
    step): two runs agree, another seed differs somewhere."""
    tc = SelectConfig(policy="random", k_percent=25.0)

    def run(seed):
        st = adagradselect.init_state(16, seed, policy="random")
        masks = []
        for _ in range(6):
            m, st = adagradselect.select(tc, st, torch.rand(16), 16)
            masks.append(_np(m))
        return np.stack(masks)
    assert np.array_equal(run(5), run(5))
    assert not np.array_equal(run(5), run(6))


# -------------------------------------------------------------- trajectory


def _tcfgs(method):
    jcfg, cfg = _configs()
    kw = dict(seq_len=48, global_batch=4, steps=5, seed=0, log_every=0)
    sk = dict(k_percent=40, steps_per_epoch=10, epsilon_decay=0.05)
    ok = dict(lr=1e-2, schedule="constant", warmup_steps=0)
    return (JTrainConfig(model=jcfg, select=JSelectConfig(**sk),
                         optimizer=JOptimizerConfig(**ok), method=method,
                         **kw),
            TrainConfig(model=cfg, select=SelectConfig(**sk),
                        optimizer=OptimizerConfig(**ok), method=method,
                        **kw))


@pytest.mark.parametrize("method", ["topk_grad", "full"])
def test_trainer_trajectory(method):
    """Five steps of both Trainers from the JAX trainer's initial state and
    the same synthetic batches: losses to 1e-5, final masks and counts
    equal."""
    jt, tt = _tcfgs(method)
    jtr = JTrainer(jt)
    state0 = jax.device_get(jtr.state)
    ttr = Trainer(tt, device="cpu")
    ttr.state = convert.train_state_from_numpy(state0, tt.model, "cpu")
    assert ttr.state["sel"]["seed"] == 0
    np.testing.assert_array_equal(ttr.state["sel"]["jax_key"],
                                  state0["sel"]["key"])
    jlog = jtr.train()
    tlog = ttr.train()
    assert tlog.steps == jlog.steps == list(range(5))
    np.testing.assert_allclose(tlog.losses, jlog.losses, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(_np(ttr.state["sel"]["mask"]),
                                  np.asarray(jtr.state["sel"]["mask"]))
    np.testing.assert_array_equal(_np(ttr.state["opt"]["counts"]),
                                  np.asarray(jtr.state["opt"]["counts"]))
    assert ttr.state["step"] == int(jtr.state["step"]) == 5
