"""The port's gated weight gradients (``ModelConfig.gate_weight_grads``)
against the JAX package's, on the CPU.

Both sides get the same numpy parameters and batches; the config is the
smoke qwen2.5-0.5b in f32 with the full-width traps of
``tests/test_torch_train.py``. The JAX package gates each block's dW with
a custom VJP and ``lax.cond`` (``repro.core.gated``); the port detaches a
frozen layer's parameters (``repro_torch.core.gated``), so its backward
computes no dW for them. Tolerances: a block's gradients 2e-4 and its dx
1e-5 (the reference's own pins, ``tests/test_models.py``), model gradients
those of ``test_gradients_per_leaf``, trajectories as
``test_trainer_trajectory``; frozen rows exactly zero, masks and counts
exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import partition as jpart
from repro.core.gated import gated_block_apply
from repro.models import blocks as jblocks
from repro.models import lm as jlm
from repro.train import step as jstep
from repro.train.trainer import Trainer as JTrainer
from repro_torch import convert
from repro_torch.configs.base import (ModelConfig, OptimizerConfig,
                                      SelectConfig, TrainConfig)
from repro_torch.core import gated
from repro_torch.core import partition as part
from repro_torch.kernels import ops, ref
from repro_torch.models import blocks
from repro_torch.models.layers import norms
from repro_torch.train import step
from repro_torch.train.trainer import Trainer
from test_torch_banked import _banked_tcfg, _bits_equal_trees
from test_torch_train import (_assert_trees, _batch, _configs, _np,
                              _np_tree, _param_shapes, _t, _tcfgs)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: under pytest-xdist each worker's default of one
    thread a core oversubscribes the host, and the tiny models' many small
    ops then wait on each other (the loss test took 197 s in a 6-worker
    run, 2.6 s alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gated_configs(remat="full"):
    jcfg, cfg = _configs()
    kw = dict(gate_weight_grads=True, remat=remat)
    return jcfg.replace(**kw), cfg.replace(**kw)


def _gate_tcfg(tcfg):
    return dataclasses.replace(
        tcfg, model=tcfg.model.replace(gate_weight_grads=True))


# ------------------------------------------------------------------ block


def _block_case():
    jcfg, cfg = _gated_configs()
    shapes = jax.eval_shape(lambda k: jblocks.attn_block_init(k, jcfg),
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
    npp = _np_tree(shapes, 5)
    # a unit-scale residual stream: the norms divide a 0.1-scale x by its
    # RMS and give dx of order 40, where f32 reassociation alone exceeds
    # the 1e-5 pin; here dx is of order 10 and the largest error 4.8e-6
    x = np.random.default_rng(6).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32)
    return jcfg, cfg, npp, x


def _jax_block_grads(jcfg, npp, x, bit):
    def loss(p, xx, m):
        y, _ = gated_block_apply(
            lambda pp, x2: jblocks.attn_block_apply(pp, jcfg, x2), p, xx, m)
        return jnp.sum(y ** 2)
    return jax.jit(jax.grad(loss, argnums=(0, 1)))(
        jax.tree.map(jnp.asarray, npp), jnp.asarray(x), jnp.asarray(bit))


def _port_block_grads(cfg, npp, x, bit):
    """(dparams with None where the backward computed nothing, dx)."""
    ps = part.tree_map(lambda a: a.requires_grad_(True), _t(npp))
    xt = torch.from_numpy(x.copy()).requires_grad_(True)
    y = blocks.attn_block_apply(gated.gate_layer(ps, bool(bit)), cfg, xt)
    leaves = part.leaves(ps)
    grads = torch.autograd.grad((y ** 2).sum(), leaves + [xt],
                                allow_unused=True)
    return grads[:-1], grads[-1]


@pytest.mark.parametrize("bit", [1.0, 0.0])
def test_gated_block_matches_reference(bit):
    """Mask 1: the block's gradients are the reference's (gated and
    ungated); mask 0: the port computes no dW at all (the reference's are
    zeros) and its dx is the reference's."""
    jcfg, cfg, npp, x = _block_case()
    (jdp, jdx) = _jax_block_grads(jcfg, npp, x, bit)
    tdp, tdx = _port_block_grads(cfg, npp, x, bit)
    jl = jax.tree_util.tree_leaves(jdp)
    assert len(jl) == len(tdp)
    np.testing.assert_allclose(_np(tdx), np.asarray(jdx), atol=1e-5)
    if bit:
        for t, j in zip(tdp, jl):
            np.testing.assert_allclose(_np(t), np.asarray(j), atol=2e-4)
    else:
        assert all(t is None for t in tdp)
        assert not any(np.asarray(j).any() for j in jl)
        # the activation gradient is the ungated block's
        _, udx = _port_block_grads(cfg.replace(gate_weight_grads=False),
                                   npp, x, 1.0)
        np.testing.assert_allclose(_np(tdx), _np(udx), atol=1e-5)


# ------------------------------------------------------------------ model


@pytest.fixture(scope="module")
def params_np():
    jcfg, _ = _configs()
    return _np_tree(_param_shapes(jcfg), 0)


def _port_grads(cfg, npp, b, block_mask):
    masks = part.layer_masks_dict(part.build_partition(cfg),
                                  torch.tensor(block_mask))
    tp = convert.params_from_numpy(npp, cfg, "cpu")
    (loss, _), g = step.value_and_grad(
        lambda p, mb: step.model_loss(cfg, p, mb, masks=masks), tp, _t(b))
    return loss, g


@pytest.mark.parametrize("remat", ["full", "none"])
def test_gated_model_gradients(params_np, remat):
    """Layer mask [1, 0, 1]: every leaf's gradient is the reference's
    (``jax.grad`` of its gated ``model_loss``), the frozen layer's rows are
    exactly zero, and remat "full" and "none" give the same bits."""
    jcfg, cfg = _gated_configs(remat)
    block_mask = [True, True, False, True, True]    # embed, 3 layers, norm
    b = _batch(2, 20, cfg.vocab_size, seed=2)
    jb = jax.tree.map(jnp.asarray, b)
    jmasks = jpart.layer_masks_dict(jpart.build_partition(jcfg),
                                    jnp.asarray(block_mask))
    jg = jax.jit(jax.grad(lambda p: jstep.model_loss(
        jlm, jcfg, p, jb, masks=jmasks)[0]))(
            jax.tree.map(jnp.asarray, params_np))
    _, tg = _port_grads(cfg, params_np, b, block_mask)
    _assert_trees(tg, jg, rtol=1e-4, atol=1e-7)
    for leaf in part.leaves(tg["layers"]):
        assert not leaf[1].any()
        assert leaf[0].any() and leaf[2].any()
    other = "none" if remat == "full" else "full"
    _, tg2 = _port_grads(cfg.replace(remat=other), params_np, b, block_mask)
    _bits_equal_trees(tg, tg2, "remat")


def test_all_layers_frozen_gives_zeros(params_np):
    """Every layer frozen: no layer leaf is reached by the loss, and
    ``value_and_grad`` gives zero tensors, not None (the reference's
    ``dparams_zero``); the embedding and the final norm get theirs."""
    _, cfg = _gated_configs()
    b = _batch(2, 12, cfg.vocab_size, seed=3)
    loss, g = _port_grads(cfg, params_np, b, [True, False, False, False,
                                             True])
    assert torch.isfinite(loss)
    shapes = part.leaves(convert.params_from_numpy(params_np, cfg, "cpu"))
    assert [t.shape for t in part.leaves(g)] == [t.shape for t in shapes]
    assert all(isinstance(t, torch.Tensor) and not t.any()
               for t in part.leaves(g["layers"]))
    assert g["embed"]["tok"].any() and g["final_norm"]["scale"].any()


# -------------------------------------------------------------- training


@pytest.mark.parametrize("method", ["topk_grad", "full"])
def test_gated_trainer_trajectory(method):
    """Five gated steps of both Trainers from the JAX trainer's initial
    state and the same batches: losses to 1e-5, masks and counts equal."""
    jt, tt = (_gate_tcfg(c) for c in _tcfgs(method))
    jtr = JTrainer(jt)
    state0 = jax.device_get(jtr.state)
    ttr = Trainer(tt, device="cpu")
    ttr.state = convert.train_state_from_numpy(state0, tt.model, "cpu")
    jlog = jtr.train()
    tlog = ttr.train()
    assert tlog.steps == jlog.steps == list(range(5))
    np.testing.assert_allclose(tlog.losses, jlog.losses, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(_np(ttr.state["sel"]["mask"]),
                                  np.asarray(jtr.state["sel"]["mask"]))
    np.testing.assert_array_equal(_np(ttr.state["opt"]["counts"]),
                                  np.asarray(jtr.state["opt"]["counts"]))
    assert ttr.state["step"] == int(jtr.state["step"]) == 5


def test_gated_banked_equals_gated_dense():
    """topk_grad, 4 gated steps: banked (async and sync) and dense give the
    same losses, parameters, moments and counts, bit for bit."""
    from repro_torch.core import masked_adamw
    runs = {}
    for name, res, asy in (("dense", "device", True),
                           ("sync", "banked", False),
                           ("async", "banked", True)):
        tr = Trainer(_gate_tcfg(_banked_tcfg("topk_grad", res, asy, 4)),
                     device="cpu")
        tr.train()
        runs[name] = tr
    dense = runs["dense"]
    pn = part.build_partition(dense.tcfg.model)
    for tr in (runs["sync"], runs["async"]):
        assert tr.log.losses == dense.log.losses
        _bits_equal_trees(dense.state["params"], tr.state["params"])
        m, v = masked_adamw.materialize_moments(pn, tr.state["opt"])
        _bits_equal_trees(dense.state["opt"]["m"], m)
        _bits_equal_trees(dense.state["opt"]["v"], v)
        assert torch.equal(dense.state["opt"]["counts"],
                           tr.state["opt"]["counts"])
        assert torch.equal(dense.state["sel"]["mask"],
                           tr.state["sel"]["mask"])


def _record_masks(tr):
    """Wrap the trainer's step so that each step's mask is kept."""
    inner, masks = tr.step_fn, []

    def step_fn(state, batch):
        state, metrics = inner(state, batch)
        masks.append(metrics["mask"].clone())
        return state, metrics
    step_fn.__dict__.update(inner.__dict__)
    tr.step_fn = step_fn
    return masks


@pytest.mark.parametrize("policy", ["adagradselect", "random"])
def test_gated_banked_equals_gated_dense_as_masks_change(policy):
    """Six gated steps whose masks change from step to step: banked (sync
    and async) and dense give the same masks, losses, parameters, moments
    and counts, bit for bit, while the banks swap blocks and the async
    planner's predictions (made before each step's norms are observed) meet
    boundaries."""
    from repro_torch.core import masked_adamw
    runs, masks = {}, {}
    for name, res, asy in (("dense", "device", True),
                           ("sync", "banked", False),
                           ("async", "banked", True)):
        tr = Trainer(_gate_tcfg(_banked_tcfg(policy, res, asy, 6)),
                     device="cpu")
        masks[name] = _record_masks(tr)
        tr.train()
        runs[name] = tr
    dense = runs["dense"]
    assert len(masks["dense"]) == 6
    assert len({tuple(m.tolist()) for m in masks["dense"]}) > 1
    pn = part.build_partition(dense.tcfg.model)
    for name in ("sync", "async"):
        tr = runs[name]
        assert all(torch.equal(a, b)
                   for a, b in zip(masks["dense"], masks[name]))
        assert tr.log.losses == dense.log.losses
        _bits_equal_trees(dense.state["params"], tr.state["params"])
        m, v = masked_adamw.materialize_moments(pn, tr.state["opt"])
        _bits_equal_trees(dense.state["opt"]["m"], m)
        _bits_equal_trees(dense.state["opt"]["v"], v)
        assert torch.equal(dense.state["opt"]["counts"],
                           tr.state["opt"]["counts"])
        assert torch.equal(dense.state["opt"]["counts"],
                           torch.stack(masks["dense"]).sum(0).to(
                               dense.state["opt"]["counts"].dtype))
    s_stats = runs["sync"].step_fn.swap_stats
    a_stats = runs["async"].step_fn.swap_stats
    assert s_stats.sync_swaps == s_stats.boundaries >= 2
    assert a_stats.dispatches == 6 and a_stats.boundaries >= 2
    # at least one boundary met a prediction in flight, right or wrong
    assert a_stats.predicted_hits + a_stats.mispredicts >= 1
    assert a_stats.predicted_hits + a_stats.sync_swaps == a_stats.boundaries


def test_gated_adagradselect_loss_falls():
    """The reference's ``test_gate_weight_grads_training_runs``: the gated
    adagradselect run trains, and its loss falls."""
    tiny = ModelConfig(name="tiny", family="dense", num_layers=4, d_model=64,
                       num_heads=4, num_kv_heads=2, head_dim=16, d_ff=256,
                       vocab_size=32, dtype="float32", remat="none",
                       tie_embeddings=True, gate_weight_grads=True)
    tcfg = TrainConfig(
        model=tiny, method="adagradselect",
        select=SelectConfig(policy="adagradselect", k_percent=34,
                            steps_per_epoch=20),
        optimizer=OptimizerConfig(lr=3e-3, schedule="constant",
                                  warmup_steps=5),
        seq_len=64, global_batch=16, steps=30, log_every=0)
    log = Trainer(tcfg, device="cpu").train()
    assert np.isfinite(log.losses).all()
    assert log.losses[-1] < log.losses[0] * 0.8


# ----------------------------------------------------- dx-only RMSNorm bwd


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_bwd_dx_only_plain(dtype):
    """The plain dx-only backward gives the full backward's dx bit for bit
    and no dscale; ``norms.apply`` asks for it when the scale needs no
    gradient, and launches nothing on the CPU."""
    g = torch.Generator().manual_seed(3)
    x = (1 + torch.randn(6, 5, 96, generator=g)).to(dtype)
    s = (1 + 0.1 * torch.randn(96, generator=g)).to(dtype)
    dy = torch.randn(6, 5, 96, generator=g).to(dtype)
    before = dict(ops.LAUNCHES)
    dx, ds = ref.rmsnorm_bwd(dy, x, s, 1e-6)
    for fn in (ref.rmsnorm_bwd, ops.rmsnorm_bwd):
        dx1, ds1 = fn(dy, x, s, 1e-6, with_dscale=False)
        assert ds1 is None and dx1.dtype == dtype
        assert torch.equal(dx1, dx)
    xg = x.clone().requires_grad_()
    y = norms.apply({"scale": s}, xg, 1e-6)
    (gx,) = torch.autograd.grad(y, (xg,), dy)
    assert torch.equal(gx, dx)
    assert ops.LAUNCHES == before
