"""The port's LoRA baseline (``optim/adamw.py``, ``optim/lora.py``,
``methods/lora.py``) against the JAX package's, on the CPU.

Both sides get the same numpy parameters, adapters and batches; the config
is the smoke qwen2.5-0.5b in f32 with the full-width traps of
``tests/test_torch_train.py`` (padded q heads, QKV bias, tied embeddings,
``remat="full"``). Adapter inits are not compared draw for draw (the
reference draws from JAX keys): their keys, shapes and dtypes are, and the
port's draws' spread. Tolerances: the merge and the eval params 1e-6, five
AdamW steps 1e-6, a five-step LoRA trajectory's losses 1e-5 relative and
its adapters and moments 1e-4 (relative, with an absolute floor of 1e-6:
v holds squared gradients of order 1e-6); report counts exact. Then the
port's entry points on the CPU: the ``Trainer`` with obs off and on, the
launcher, a checkpoint resume bit-equal to the straight run, and the greedy
eval on the merged params.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs.base import OptimizerConfig as JOptimizerConfig
from repro.configs.base import TrainConfig as JTrainConfig
from repro.methods.lora import LoRAMethod as JLoRAMethod
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.optim import lora as jlora
from repro.train.trainer import Trainer as JTrainer
from repro_torch import convert, obs
from repro_torch.checkpoint import manager
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import OptimizerConfig, TrainConfig
from repro_torch.core import partition as part
from repro_torch.core.offload import resident_opt_bytes
from repro_torch.data.synthetic import MathTaskConfig
from repro_torch.launch import train as launch_train
from repro_torch.methods.lora import LoRAMethod
from repro_torch.models import lm
from repro_torch.optim import adamw, lora
from repro_torch.train import evaluate
from repro_torch.train.trainer import Trainer
from test_torch_checkpoint import _assert_same_state
from test_torch_train import _configs, _np, _np_tree, _param_shapes, _t

RANK = 8
ALPHA = 16.0


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: under pytest-xdist each worker's default of one
    thread a core oversubscribes the host, and the tiny models' many small
    ops then wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_lora_np(jcfg, npp, rank=RANK, seed=1):
    """The reference's adapters for numpy params ``npp``, as numpy."""
    return jax.device_get(jlora.init_lora(
        jax.random.PRNGKey(seed), jax.tree.map(jnp.asarray, npp), jcfg,
        rank))


def _random_adapters(lp_np, seed=3, scale=0.1):
    """Adapters of the reference's keys and shapes with nonzero a and b."""
    rng = np.random.default_rng(seed)
    return {path: {k: (scale * rng.standard_normal(x.shape)).astype(
        np.float32) for k, x in ab.items()} for path, ab in lp_np.items()}


def _jdict(tree):
    return jax.tree.map(jnp.asarray, tree)


# ----------------------------------------------------------------- init


def _smoke_pair(arch, dtype):
    jcfg = jax_smoke_config(arch).replace(dtype=dtype)
    cfg = get_smoke_config(arch).replace(dtype=dtype)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jcfg, cfg


@pytest.mark.parametrize("arch, dtype", [
    ("qwen2.5-0.5b", "float32"), ("llama3.2-1b", "float32"),
    ("qwen2.5-0.5b", "bfloat16")], ids=["qwen", "llama", "qwen-bf16"])
def test_init_lora_layout_matches_reference(arch, dtype):
    """Keys, shapes and dtypes of ``init_lora`` equal the reference's; b is
    zero; a's draws have mean 0 and std fan_in^-0.5 within 5 standard
    errors (std: relative 5 / sqrt(2 n); mean: 5 / sqrt(n) of the std)."""
    jcfg, cfg = _smoke_pair(arch, dtype)
    jparams = jlm.init(jax.random.PRNGKey(0), jcfg)
    jl = jlora.init_lora(jax.random.PRNGKey(1), jparams, jcfg, RANK)
    params = lm.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    tl = lora.init_lora(torch.Generator().manual_seed(1), params, cfg, RANK)
    assert sorted(tl) == sorted(jl) and len(tl) == 7
    for path, ab in tl.items():
        for k in ("a", "b"):
            j = jl[path][k]
            assert tuple(ab[k].shape) == tuple(j.shape), (path, k)
            assert str(ab[k].dtype).split(".")[-1] == str(j.dtype), (path, k)
        assert not ab["b"].any(), path
        a = ab["a"].double()
        fan_in = a.shape[-2]
        n, want = a.numel(), fan_in ** -0.5
        assert abs(a.std().item() / want - 1) < 5 / math.sqrt(2 * n), path
        assert abs(a.mean().item()) < 5 * want / math.sqrt(n), path
    # each leaf draws its own stream: seeded by the seed and the path
    again = lora.init_lora(torch.Generator().manual_seed(1), params, cfg,
                           RANK)
    other = lora.init_lora(torch.Generator().manual_seed(2), params, cfg,
                           RANK)
    for path in tl:
        assert torch.equal(tl[path]["a"], again[path]["a"])
        assert not torch.equal(tl[path]["a"], other[path]["a"])


def test_full_width_adapter_count_matches_reference():
    """qwen2.5-0.5b at full width, rank 256: (1920 + 1024 + 1024 + 1920 +
    3 * 5760) * 256 adapter parameters a layer, 142,344,192 in all, as the
    reference's ``init_lora`` gives them (traced, nothing allocated)."""
    jcfg, cfg = jax_config("qwen2.5-0.5b"), get_config("qwen2.5-0.5b")
    shapes = jax.eval_shape(
        lambda k: jlora.init_lora(k, jlm.init(k, jcfg), jcfg, 256),
        jax.ShapeDtypeStruct((2,), jnp.uint32))
    want = sum(math.prod(x.shape) for x in jax.tree.leaves(shapes))
    got = sum(math.prod(a) + math.prod(b)
              for a, b, _ in lora.adapter_layout(cfg, 256).values())
    assert got == want == 142_344_192 == 24 * 5_931_008


# ----------------------------------------------------------------- merge


@pytest.fixture(scope="module")
def base():
    jcfg, cfg = _configs()
    npp = _np_tree(_param_shapes(jcfg), 0)
    return jcfg, cfg, npp


def test_merge_matches_reference(base):
    """Nonzero a and b: every merged leaf within 1e-6 of the reference's;
    zero b: the base exactly; the untargeted leaves pass through."""
    jcfg, cfg, npp = base
    lp = _random_adapters(_jax_lora_np(jcfg, npp))
    jm = jlora.merge(_jdict(npp), _jdict(lp), jcfg, RANK, ALPHA)
    tp = convert.params_from_numpy(npp, cfg, "cpu")
    tm = lora.merge(tp, convert.lora_from_numpy(lp, cfg, RANK, "cpu"), cfg,
                    RANK, ALPHA)
    for (path, t), j in zip(part.leaves_with_path(tm), jax.tree.leaves(jm)):
        np.testing.assert_allclose(_np(t), np.asarray(j), rtol=1e-6,
                                   atol=1e-6, err_msg=path)
    orig = dict(part.leaves_with_path(tp))
    assert len(lp) == 7
    for path, t in part.leaves_with_path(tm):
        assert torch.equal(t, orig[path]) == (path not in lp), path
    zero_b = {p: {"a": ab["a"], "b": np.zeros_like(ab["b"])}
              for p, ab in lp.items()}
    tz = lora.merge(tp, convert.lora_from_numpy(zero_b, cfg, RANK, "cpu"),
                    cfg, RANK, ALPHA)
    for (path, t), (_, w) in zip(part.leaves_with_path(tz),
                                 part.leaves_with_path(tp)):
        assert torch.equal(t, w), path


def test_merge_differentiates_the_adapters_only(base):
    """The base is detached (the reference's stop_gradient): a base that
    requires grad gets none, the adapters get theirs."""
    jcfg, cfg, npp = base
    tp = part.tree_map(lambda x: x.requires_grad_(True),
                       convert.params_from_numpy(npp, cfg, "cpu"))
    lp = part.tree_map(lambda x: x.requires_grad_(True),
                       convert.lora_from_numpy(_random_adapters(
                           _jax_lora_np(jcfg, npp)), cfg, RANK, "cpu"))
    merged = lora.merge(tp, lp, cfg, RANK, ALPHA)
    sum(x.square().sum() for x in part.leaves(merged)).backward()
    assert all(x.grad is None for x in part.leaves(tp))
    assert all(x.grad is not None and x.grad.any()
               for x in part.leaves(lp))


# ----------------------------------------------------------------- adamw


def test_adamw_update_matches_reference():
    """Five steps of the unmasked AdamW on a random tree (a stacked leaf, a
    matrix, a vector), fresh gradients and a rate each step: params, m, v
    and the count within 1e-6 of the reference's."""
    rng = np.random.default_rng(7)
    shapes = {"x": {"a": (3, 5, 4), "b": (4, 6)}, "y": (9,)}

    def tree(scale):
        return jax.tree.map(
            lambda s: (scale * rng.standard_normal(s)).astype(np.float32),
            shapes, is_leaf=lambda s: isinstance(s, tuple))
    p0 = tree(1.0)
    jcfg = JOptimizerConfig(weight_decay=0.1)
    cfg = OptimizerConfig(weight_decay=0.1)
    jp, jopt = _jdict(p0), jadamw.init_opt_state(_jdict(p0))
    tp = _t(p0)
    topt = adamw.init_opt_state(tp)
    assert topt["count"].dtype == torch.float32 and topt["count"].ndim == 0
    for i in range(5):
        g = tree(10.0 ** -(i % 3))
        lr = float(np.float32(1e-2 * (i + 1)))
        jp, jopt = jadamw.update(jcfg, jp, _jdict(g), jopt,
                                 jnp.float32(lr))
        tp, topt = adamw.update(cfg, tp, _t(g), topt, lr)
    for t_tree, j_tree in ((tp, jp), (topt["m"], jopt["m"]),
                           (topt["v"], jopt["v"])):
        for t, j in zip(part.leaves(t_tree), jax.tree.leaves(j_tree)):
            np.testing.assert_allclose(_np(t), np.asarray(j), rtol=1e-6,
                                       atol=1e-6)
    assert topt["count"].item() == float(jopt["count"]) == 5.0


# ------------------------------------------------------------ trajectory


def _lora_tcfgs(steps=5, lr=1e-2, **kw):
    jcfg, cfg = _configs()
    common = dict(seq_len=48, global_batch=4, steps=steps, seed=0,
                  log_every=0, method="lora", **kw)
    ok = dict(lr=lr, schedule="constant", warmup_steps=0, lora_rank=RANK,
              lora_alpha=ALPHA)
    return (JTrainConfig(model=jcfg, optimizer=JOptimizerConfig(**ok),
                         **common),
            TrainConfig(model=cfg, optimizer=OptimizerConfig(**ok),
                        **common))


def _assert_close_tree(t_tree, j_tree, path_prefix):
    for path, t in part.leaves_with_path(t_tree):
        *head, k = path.split("/")
        j = np.asarray(j_tree["/".join(head)][k])
        np.testing.assert_allclose(_np(t), j, rtol=1e-4, atol=1e-6,
                                   err_msg=f"{path_prefix}/{path}")


def test_lora_trajectory_matches_reference():
    """Five steps of both Trainers with ``method="lora"`` from the JAX
    trainer's exported state (base and adapters of its ``init_state``) and
    the same synthetic batches: losses within 1e-5 relative, adapters and
    moments within 1e-4, the count and the step equal."""
    jt, tt = _lora_tcfgs()
    jtr = JTrainer(jt)
    state0 = jax.device_get(jtr.state)
    ttr = Trainer(tt, device="cpu")
    assert ttr.sel_cfg == tt.select   # a method without selection
    ttr.state = convert.lora_state_from_numpy(state0, tt.model, RANK, "cpu")
    jlog, tlog = jtr.train(), ttr.train()
    assert tlog.steps == jlog.steps == list(range(5))
    np.testing.assert_allclose(tlog.losses, jlog.losses, rtol=1e-5, atol=0)
    js = jax.device_get(jtr.state)
    _assert_close_tree(ttr.state["lora"], js["lora"], "lora")
    _assert_close_tree(ttr.state["opt"]["m"], js["opt"]["m"], "m")
    _assert_close_tree(ttr.state["opt"]["v"], js["opt"]["v"], "v")
    assert ttr.state["opt"]["count"].item() == float(js["opt"]["count"]) == 5
    assert ttr.state["step"] == int(js["step"]) == 5
    # the adapters moved, the base did not
    assert any(ab["b"].any() for ab in ttr.state["lora"].values())
    for t, j in zip(part.leaves(ttr.state["base"]),
                    jax.tree.leaves(state0["base"])):
        np.testing.assert_array_equal(_np(t), np.asarray(j))


def _reference_state(jt, seed=5):
    """The JAX LoRA state of ``jt`` with nonzero adapters, as numpy."""
    state = jax.device_get(JLoRAMethod().init_state(
        jt.model, jt.optimizer, seed=0))
    state["lora"] = _random_adapters(state["lora"], seed)
    return state


def test_eval_params_match_reference():
    jt, tt = _lora_tcfgs()
    state = _reference_state(jt)
    jm = JLoRAMethod().eval_params(jt.model, jt.optimizer,
                                   jax.tree.map(jnp.asarray, state))
    tm = LoRAMethod().eval_params(
        tt.model, tt.optimizer,
        convert.lora_state_from_numpy(state, tt.model, RANK, "cpu"))
    for (path, t), j in zip(part.leaves_with_path(tm), jax.tree.leaves(jm)):
        np.testing.assert_allclose(_np(t), np.asarray(j), rtol=1e-6,
                                   atol=1e-6, err_msg=path)


def test_trainable_param_report_matches_reference():
    """Total, trainable and the modelled optimizer bytes exactly; resident:
    the adapters' f32 m and v and the 0-d count, all on the training
    device (the reference's own figure counts its count the same way)."""
    jt, tt = _lora_tcfgs()
    state = _reference_state(jt)
    jrep = JLoRAMethod().trainable_param_report(
        jt.model, jax.tree.map(jnp.asarray, state))
    tstate = convert.lora_state_from_numpy(state, tt.model, RANK, "cpu")
    trep = LoRAMethod().trainable_param_report(tt.model, tstate)
    assert trep.method == jrep.method == "lora"
    assert trep.num_params_total == jrep.num_params_total
    assert trep.num_params_trainable == jrep.num_params_trainable
    assert trep.opt_bytes == jrep.opt_bytes == 8 * trep.num_params_trainable
    assert trep.detail == jrep.detail
    assert trep.opt_bytes_resident == trep.opt_bytes + 4
    assert resident_opt_bytes(tstate["opt"]) == {
        "device": trep.opt_bytes + 4, "host": 0}


@pytest.mark.parametrize("bad, err, match", [
    (lambda lp: {k: v for k, v in lp.items() if k != "layers/attn/wq"},
     KeyError, "adapter keys"),
    (lambda lp: {**lp, "layers/attn/wq": {"a": lp["layers/attn/wq"]["a"]}},
     KeyError, "keys"),
    (lambda lp: {**lp, "layers/mlp/wd": {
        "a": lp["layers/mlp/wd"]["a"][..., :-1],
        "b": lp["layers/mlp/wd"]["b"]}}, ValueError, "rank 8"),
], ids=["missing-leaf", "missing-b", "wrong-rank"])
def test_lora_from_numpy_checks_keys_and_shapes(base, bad, err, match):
    jcfg, cfg, npp = base
    lp = _jax_lora_np(jcfg, npp)
    assert sorted(convert.lora_from_numpy(lp, cfg, RANK, "cpu")) == sorted(lp)
    with pytest.raises(err, match=match):
        convert.lora_from_numpy(bad(lp), cfg, RANK, "cpu")


# --------------------------------------------------------- entry points


def _cpu_tcfg(steps=2, ckdir="", **kw):
    return TrainConfig(
        model=get_smoke_config("qwen2.5-0.5b"), method="lora",
        optimizer=OptimizerConfig(lr=1e-3, schedule="constant",
                                  warmup_steps=0, lora_rank=4),
        seq_len=48, global_batch=2, steps=steps, log_every=1,
        checkpoint_dir=ckdir, **kw)


@pytest.mark.parametrize("with_obs", [False, True], ids=["obs-off",
                                                         "obs-on"])
def test_trainer_trains_lora_on_cpu(with_obs):
    """Two finite steps; with obs on the selection telemetry skips the
    steps, whose metrics have no mask, and the step counter counts them."""
    obs.metrics.reset()
    if with_obs:
        obs.enable()
    try:
        tr = Trainer(_cpu_tcfg(), device="cpu")
        log = tr.train()
        trace = obs.selection_trace()
        snap = obs.snapshot() if with_obs else None
    finally:
        obs.disable()
        obs.metrics.reset()
    assert len(log.losses) == 2 and np.isfinite(log.losses).all()
    assert [sorted(m) for m in log.metrics] == [sorted(
        ["step", "loss", "grad_norm", "lr", "ce_loss", "aux_loss"])] * 2
    assert tr.state["step"] == 2 and tr.state["opt"]["count"].item() == 2
    if with_obs:
        assert trace is not None and len(trace) == 0
        assert snap["train"]["steps"] == 2 and "selection" not in snap
    else:
        assert trace is None


def test_launcher_trains_lora_on_cpu(capsys):
    assert launch_train.main(["--arch", "qwen2.5-0.5b", "--smoke",
                              "--device", "cpu", "--method", "lora",
                              "--lora-rank", "4", "--steps", "2",
                              "--seq-len", "48", "--global-batch", "2"]) == 0
    out = capsys.readouterr().out
    n = LoRAMethod().trainable_param_report(
        get_smoke_config("qwen2.5-0.5b"), LoRAMethod().init_state(
            get_smoke_config("qwen2.5-0.5b"), OptimizerConfig(lora_rank=4),
            device="cpu")).num_params_trainable
    assert f"[lora] trainable {n:,}/" in out
    assert "adapters on 7 leaf groups" in out and "final loss" in out


def test_lora_resume_is_bit_equal(tmp_path):
    """4 steps straight against 2 + a checkpoint + a new Trainer's restore
    + 2: the adapters, moments, count, base, step and losses bit for bit.
    The adapter keys hold "/", so the restore walks the target's keys."""
    straight = Trainer(_cpu_tcfg(4, checkpoint_every=2), device="cpu")
    straight.train(4)
    first = Trainer(_cpu_tcfg(4, str(tmp_path), checkpoint_every=2),
                    device="cpu")
    first.train(2)
    flat, _ = manager.CheckpointManager(str(tmp_path)).load_flat()
    assert "lora/layers/attn/wq/a" in flat and "opt/count" in flat
    resumed = Trainer(_cpu_tcfg(4, str(tmp_path), checkpoint_every=2),
                      device="cpu")
    assert resumed.maybe_restore() == 2
    assert sorted(resumed.state["lora"]) == sorted(first.state["lora"])
    resumed.train(2)
    assert resumed.state["step"] == 4
    assert resumed.log.losses == straight.log.losses[2:]
    _assert_same_state(resumed.state, straight.state)


def test_math_accuracy_on_lora_eval_params():
    tr = Trainer(_cpu_tcfg(), device="cpu")
    tr.train()
    cfg = tr.tcfg.model
    params = tr.method.eval_params(cfg, tr.tcfg.optimizer, tr.state)
    assert not any(x.requires_grad for x in part.leaves(params))
    acc = evaluate.math_accuracy(params, cfg,
                                 MathTaskConfig(digits=1, seq_len=24),
                                 num_problems=3, batch_size=2, device="cpu")
    assert 0.0 <= acc <= 1.0


def test_one_step_from_nonzero_adapters_matches_reference():
    """One step of each method's step function from the same converted
    state with nonzero a and b (the trajectory starts from b = 0): loss and
    gradient norm within 1e-5 relative; the metrics carry no mask."""
    jt, tt = _lora_tcfgs(steps=1)
    state = _reference_state(jt)
    jfn = JLoRAMethod().make_step(jt.model, jt.optimizer, donate=False)
    batch = {"tokens": np.random.default_rng(2).integers(
        0, tt.model.vocab_size, (2, 24)).astype(np.int32),
        "loss_mask": np.ones((2, 24), np.float32)}
    _, jmet = jfn(jax.tree.map(jnp.asarray, state), _jdict(batch))
    tstate = convert.lora_state_from_numpy(state, tt.model, RANK, "cpu")
    new, tmet = LoRAMethod().make_step(tt.model, tt.optimizer)(
        tstate, _t(batch))
    assert new["step"] == 1 and "mask" not in tmet
    np.testing.assert_allclose(tmet["loss"].item(), float(jmet["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(tmet["grad_norm"].item(),
                               float(jmet["grad_norm"]), rtol=1e-5)
