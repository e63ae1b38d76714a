"""The port's checkpoints (``repro_torch.checkpoint``) on the CPU.

- The pins of the reference's ``tests/test_checkpoint.py``: a bit-exact
  round trip (dense and banked, f32 and bf16), keep-k, an async save that
  leaves no ``tmp.`` directory, the latest of many, a snapshot that an
  in-place write after ``save`` does not reach, and the writer's error
  raised at ``wait()``.
- Resumes equal to the uninterrupted run, bit for bit: dense
  adagradselect (f32 and bf16 moments), banked host for lisa and
  adagradselect with the checkpoint inside a selection interval, gated
  weight gradients, and a packed ``SFTPipeline`` whose batches after the
  restore are the uninterrupted run's.
- Against the JAX package: a file its ``Trainer`` wrote resumes in the port
  as the JAX run continues; its bf16 files (which it cannot restore itself)
  restore in the port with equal bits; its ``CheckpointManager`` reads an
  f32 file the port wrote; a dtype or shape mismatch raises with the leaf's
  path.
"""
import os
import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs.base import OptimizerConfig as JOptimizerConfig
from repro.configs.base import SelectConfig as JSelectConfig
from repro.configs.base import TrainConfig as JTrainConfig
from repro.train import step as jstep
from repro.train.trainer import Trainer as JTrainer
from repro_torch import convert
from repro_torch.checkpoint import manager
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import (OptimizerConfig, SelectConfig,
                                      TrainConfig)
from repro_torch.core import masked_adamw
from repro_torch.core import partition as part
from repro_torch.data import loader
from repro_torch.launch import train as launch_train
from repro_torch.train import step
from repro_torch.train.trainer import Trainer

OVERRIDES = dict(pad_heads_to=6, vocab_size=250, pad_vocab_multiple=16)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, as in ``tests/test_torch_gated.py``: under
    pytest-xdist each worker's default of one thread a core oversubscribes
    the host and the small models' ops wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(**kw):
    return get_smoke_config("qwen2.5-0.5b").replace(remat="none", **kw)


def _bits(x):
    """A leaf as comparable numpy bits (tensors of any dtype, arrays,
    ints)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.numpy()
    return np.asarray(x)


def _assert_same_state(a, b):
    fa, fb = manager.flatten(a), manager.flatten(b)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (path, x), (_, y) in zip(fa, fb):
        assert type(x) is type(y), path
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.device == y.device, path
        np.testing.assert_array_equal(_bits(x), _bits(y), err_msg=path)


def _state(residency="device", moments=torch.float32, dtype="float32"):
    """A smoke TrainState whose moments, counts and selection fields are
    nonzero (so a restore that drops a leaf shows)."""
    st = step.init_train_state(
        _cfg(dtype=dtype), select_k=2, moment_residency=residency,
        store_policy="host", device="cpu", moment_dtype=moments)
    st["sel"]["seed"] = (1 << 64) - 3
    gen = torch.Generator().manual_seed(1)
    for _, leaf in manager.flatten({"opt": st["opt"], "sel": st["sel"]}):
        if isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
            leaf.copy_(torch.rand(leaf.shape, generator=gen))
    if residency == "banked":
        st["opt"]["slot_map"][:2] = [0, 1]
    st["step"], st["sel"]["step"] = 7, 6
    return st


# ------------------------------------------ the reference's manager pins


@pytest.mark.parametrize("residency, moments, dtype", [
    ("device", torch.float32, "float32"),
    ("banked", torch.bfloat16, "bfloat16")], ids=["dense-f32", "banked-bf16"])
def test_roundtrip_bitexact(tmp_path, residency, moments, dtype):
    st = _state(residency, moments, dtype)
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(7, st)
    mgr.wait()
    restored, at = mgr.restore(st)
    assert at == 7 and restored["sel"]["seed"] == (1 << 64) - 3
    _assert_same_state(restored, st)


def test_keep_k_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"x": torch.tensor(float(s))})
    mgr.wait()
    assert mgr.all_steps() == [3, 4]


def test_async_save_waits_and_leaves_no_tmp(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(1, _state())
    mgr.wait()
    assert mgr.all_steps() == [1]
    assert not [d for d in os.listdir(tmp_path) if d.startswith("tmp.")]
    assert mgr.last_save["bytes"] == os.path.getsize(
        tmp_path / "step_00000001" / "proc_0.npz")


def test_restore_latest_of_many(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=5)
    for s in (10, 20, 30):
        mgr.save(s, {"w": torch.full((3,), float(s))})
    mgr.wait()
    restored, at = mgr.restore({"w": torch.zeros(3)})
    assert at == 30 and float(restored["w"][0]) == 30.0


def test_async_save_snapshots_the_host_store(tmp_path):
    """In-place writes after ``save`` (the next boundary's writeback into
    the store, a slot_map update, the next step's AdamW) do not reach the
    file: the writer owns a copy of every leaf."""
    st = _state("banked")
    store_leaf = part.leaves(st["opt"]["store"])[0]
    want = {p: _bits(x).copy() for p, x in manager.flatten(st)}
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(1, st)
    store_leaf.fill_(-1.0)
    st["opt"]["slot_map"][:] = 5
    part.leaves(st["params"])[0].add_(1.0)
    mgr.wait()
    restored, _ = mgr.restore(st)
    for path, x in manager.flatten(restored):
        np.testing.assert_array_equal(_bits(x), want[path], err_msg=path)


def test_writer_error_is_raised_at_wait(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path))

    def fail(*a, **k):
        raise OSError("disk full")
    monkeypatch.setattr(manager.np, "savez", fail)
    mgr.save(1, {"x": torch.zeros(2)})
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    mgr.wait()   # raised once
    assert mgr.all_steps() == []


def test_stall_counts_the_wait_on_the_previous_writer(tmp_path,
                                                     monkeypatch):
    """A save issued while the previous save's writer still runs blocks
    the loop until it ends; that wait is part of the save's stall."""
    mgr = CheckpointManager(str(tmp_path))
    savez = manager.np.savez

    def slow(*a, **k):
        time.sleep(0.3)
        savez(*a, **k)
    monkeypatch.setattr(manager.np, "savez", slow)
    mgr.save(1, {"x": torch.zeros(2)})
    assert mgr.last_save["wait_s"] < 0.2
    mgr.save(2, {"x": torch.ones(2)})
    assert mgr.last_save["wait_s"] >= 0.2
    assert mgr.last_save["stall_s"] >= mgr.last_save["wait_s"]
    mgr.wait()
    assert mgr.all_steps() == [1, 2]


# --------------------------------------- resumes equal the straight run


def _tcfg(ckdir="", policy="adagradselect", steps=6, cfg=None, **opt):
    return TrainConfig(
        model=cfg or _cfg(), method=policy,
        select=SelectConfig(policy=policy, k_percent=40, lisa_interval=4),
        optimizer=OptimizerConfig(lr=1e-3, schedule="constant",
                                  warmup_steps=0, **opt),
        seq_len=48, global_batch=4, steps=steps, log_every=0,
        checkpoint_dir=ckdir, checkpoint_every=3, checkpoint_keep=3)


def _resume(tmp_path, tcfg_of, source=None):
    """(6 steps straight, 3 + checkpoint + a new Trainer's restore + 3)."""
    src = source or (lambda: None)
    straight = Trainer(tcfg_of(""), data_source=src(), device="cpu")
    straight.train(6)
    first = Trainer(tcfg_of(str(tmp_path)), data_source=src(), device="cpu")
    first.train(3)
    resumed = Trainer(tcfg_of(str(tmp_path)), data_source=src(),
                      device="cpu")
    assert resumed.maybe_restore() == 3
    if "slot_map" in first.state["opt"]:
        np.testing.assert_array_equal(resumed.state["opt"]["slot_map"],
                                      first.state["opt"]["slot_map"])
    resumed.train(3)
    assert resumed.state["step"] == 6
    assert resumed.log.losses == straight.log.losses[3:]
    return straight, resumed


def _assert_same_run(a, b):
    opt_a, opt_b = a.state["opt"], b.state["opt"]
    if "store" in opt_a:
        pn = part.build_partition(a.tcfg.model)
        _assert_same_state(
            dict(zip("mv", masked_adamw.materialize_moments(pn, opt_a))),
            dict(zip("mv", masked_adamw.materialize_moments(pn, opt_b))))
    _assert_same_state(a.state, b.state)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_dense_resume_is_bit_equal(tmp_path, moments):
    a, b = _resume(tmp_path, lambda d: _tcfg(d, moment_dtype=moments))
    _assert_same_run(a, b)


@pytest.mark.parametrize("policy", ["lisa", "adagradselect"])
def test_banked_resume_is_bit_equal(tmp_path, policy):
    """Banked host residency saved inside a selection interval (lisa
    resamples every 4 steps; the save is at 3): params, materialised
    moments, banks, slot_map and selection state."""
    a, b = _resume(tmp_path, lambda d: _tcfg(
        d, policy, moment_residency="banked", offload="host",
        async_swap=True))
    _assert_same_run(a, b)


def test_gated_resume_is_bit_equal(tmp_path):
    a, b = _resume(tmp_path, lambda d: _tcfg(
        d, cfg=_cfg(gate_weight_grads=True)))
    _assert_same_run(a, b)


def test_packed_resume_continues_the_record_stream(tmp_path):
    """The cursor in meta.json resumes the packed stream: the batches after
    the restore are the uninterrupted run's (records and non-pad tokens a
    step), and so is the state."""
    def src():
        return loader.make_source("packed_math", seq_len=96, global_batch=2,
                                  seed=0, pack=True)
    a, b = _resume(tmp_path, lambda d: _tcfg(d), src)
    meta = CheckpointManager(str(tmp_path)).load_meta(3)
    assert meta["data_cursor"]["record"] > 0
    assert b.log.records == a.log.records[3:]
    assert b.log.real_tokens == a.log.real_tokens[3:]
    assert b.data.cursor() == a.data.cursor()
    _assert_same_run(a, b)


# ----------------------------------------------------- the JAX package


def _jax_tcfgs(ckdir):
    jcfg = jax_smoke_config("qwen2.5-0.5b").replace(**OVERRIDES)
    cfg = get_smoke_config("qwen2.5-0.5b").replace(**OVERRIDES)
    kw = dict(seq_len=48, global_batch=4, steps=3, seed=0, log_every=0,
              checkpoint_dir=ckdir, checkpoint_every=3)
    sk = dict(k_percent=40, steps_per_epoch=10, epsilon_decay=0.05)
    ok = dict(lr=1e-2, schedule="constant", warmup_steps=0)
    return (JTrainConfig(model=jcfg, select=JSelectConfig(**sk),
                         optimizer=JOptimizerConfig(**ok),
                         method="topk_grad", **kw),
            TrainConfig(model=cfg, select=SelectConfig(**sk),
                        optimizer=OptimizerConfig(**ok), method="topk_grad",
                        **kw))


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """The JAX Trainer saves at step 3; the port restores that file and
    trains 3 steps as the JAX Trainer does (test_trainer_trajectory's
    tolerance)."""
    jt, tt = _jax_tcfgs(str(tmp_path))
    jtr = JTrainer(jt)
    jtr.train()
    ttr = Trainer(tt, device="cpu")
    assert ttr.maybe_restore() == 3
    assert ttr.state["sel"]["seed"] == 0
    np.testing.assert_array_equal(
        ttr.state["opt"]["counts"].numpy(),
        np.asarray(jtr.state["opt"]["counts"]))
    jlog, tlog = jtr.train(), ttr.train()
    assert tlog.steps == jlog.steps[3:] == [3, 4, 5]
    np.testing.assert_allclose(tlog.losses, jlog.losses[3:], rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(ttr.state["sel"]["mask"].numpy(),
                                  np.asarray(jtr.state["sel"]["mask"]))
    assert ttr.state["step"] == int(jtr.state["step"]) == 6


def _jax_bf16_state(residency):
    """A JAX bf16 TrainState (bf16 params and moments) with random
    moments; the banked store is numpy ``ml_dtypes.bfloat16``."""
    cfg = jax_smoke_config("qwen2.5-0.5b").replace(dtype="bfloat16")
    st = jstep.init_train_state(cfg, seed=0, select_k=2,
                                moment_dtype=jnp.bfloat16,
                                moment_residency=residency,
                                store_policy="host")
    rng = np.random.default_rng(0)

    def rnd(x):
        if np.asarray(x).dtype != ml_dtypes.bfloat16:
            return x
        r = rng.standard_normal(np.shape(x)).astype(ml_dtypes.bfloat16)
        return r if isinstance(x, np.ndarray) else jnp.asarray(r)
    st["opt"] = jax.tree.map(rnd, st["opt"])
    return jax.device_get(st)


@pytest.mark.parametrize("residency", ["device", "banked"])
def test_jax_bf16_checkpoint_restores_bit_equal(tmp_path, residency):
    """The reference's writer leaves bf16 as |V2; the port reads those
    leaves by its target's dtype (``CheckpointManager.restore``) and as bf16
    in ``convert.train_state_from_checkpoint``, bit for bit."""
    jst = _jax_bf16_state(residency)
    JCheckpointManager(str(tmp_path), async_save=False).save(3, jst)
    flat, _ = CheckpointManager(str(tmp_path)).load_flat()
    assert flat["params/embed/tok"].dtype == np.dtype("V2")
    conv, at = convert.train_state_from_checkpoint(
        str(tmp_path), _cfg(dtype="bfloat16"), device="cpu")
    assert at == 3
    target = step.init_train_state(
        _cfg(dtype="bfloat16"), select_k=2, moment_residency=residency,
        device="cpu", moment_dtype=torch.bfloat16)
    restored, _ = CheckpointManager(str(tmp_path)).restore(target)
    conv["sel"].pop("jax_key")
    for path, leaf in manager.flatten(jst):
        if path == "sel/key":
            continue
        want = np.asarray(leaf)
        if want.dtype == ml_dtypes.bfloat16:
            want = want.view(np.int16)
        for got in (restored, conv):
            node = got
            for k in path.split("/"):
                node = node[k]
            np.testing.assert_array_equal(_bits(node), want, err_msg=path)
    assert restored["sel"]["seed"] == conv["sel"]["seed"] == 0


def test_reference_reads_a_port_f32_checkpoint(tmp_path):
    """The reference's ``CheckpointManager.restore`` takes a file the port
    wrote into a JAX TrainState: same values, the seed as its PRNG key."""
    _, tt = _jax_tcfgs(str(tmp_path))
    ttr = Trainer(tt, device="cpu")
    ttr.state["sel"]["seed"] = (7 << 32) | 9
    ttr.train()
    jtarget = jstep.init_train_state(
        jax_smoke_config("qwen2.5-0.5b").replace(**OVERRIDES), seed=0,
        policy="topk_grad", select_k=ttr.state["sel"]["indices"].shape[0])
    restored, at = JCheckpointManager(str(tmp_path)).restore(jtarget)
    assert at == 3 and int(restored["step"]) == 3
    np.testing.assert_array_equal(restored["sel"]["key"], [7, 9])
    flat = dict(manager.flatten(ttr.state))
    for path, leaf in manager.flatten(restored):
        if path == "sel/key":
            continue
        want = flat[path]
        np.testing.assert_array_equal(
            np.asarray(leaf), _bits(want), err_msg=path)


@pytest.mark.parametrize("saved, target, match", [
    (dict(moments=torch.bfloat16), dict(moments=torch.float32),
     "'opt/m/.*dtype"),
    (dict(moments=torch.float32), dict(moments=torch.bfloat16),
     "'opt/m/.*dtype"),
    (dict(dtype="bfloat16"), dict(dtype="float32"), "'params/.*dtype"),
], ids=["bf16-into-f32", "f32-into-bf16", "bf16-params-into-f32"])
def test_dtype_mismatch_raises_with_the_path(tmp_path, saved, target, match):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _state(**saved))
    mgr.wait()
    with pytest.raises(ValueError, match=match):
        mgr.restore(_state(**target))


def test_shape_mismatch_raises_with_the_path(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _state())
    mgr.wait()
    other = step.init_train_state(_cfg(num_layers=2), select_k=2,
                                  device="cpu")
    with pytest.raises(ValueError, match="'params/layers/.*shape"):
        mgr.restore(other)


def test_launcher_resumes_on_the_cpu(tmp_path, capsys):
    """``launch.train --checkpoint-dir D --checkpoint-every 3`` run twice:
    the second run prints "resumed from step 6" and trains 6 more steps."""
    argv = ["--arch", "qwen2.5-0.5b", "--smoke", "--device", "cpu",
            "--steps", "6", "--seq-len", "48", "--global-batch", "2",
            "--checkpoint-dir", str(tmp_path), "--checkpoint-every", "3"]
    assert launch_train.main(argv) == 0
    first = capsys.readouterr().out
    assert "resumed" not in first and "checkpoint: step 6" in first
    assert launch_train.main(argv) == 0
    second = capsys.readouterr().out
    assert "resumed from step 6" in second and "checkpoint: step 12" in second
    assert CheckpointManager(str(tmp_path)).all_steps() == [6, 9, 12]
