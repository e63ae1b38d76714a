"""bf16 AdamW moments (``OptimizerConfig(moment_dtype="bfloat16")``) in the
port, on the CPU.

- The plain bf16-moment masked AdamW, dense (row 8's plain version and the
  unstacked leaves' ``_adamw_rows``) and banked (row 9's), against the
  reference's XLA path ``core/masked_adamw._adamw_rows(..., pallas_ok=
  False)`` on bf16 m and v (ROADMAP Queue C item 7: its Pallas path returns
  f32 moments): m and v within one bf16 ulp, p within the f32 parity
  tolerance (1e-6) or one bf16 ulp for bf16 params; rows with sel = 0 keep
  their bits; ties round to nearest even.
- Banked equals dense bit for bit with bf16 moments, with and without
  gated weight gradients.
- A five-step topk_grad trajectory with bf16 moments against the JAX
  ``Trainer`` (losses 1e-5, masks and counts exact).
- The moments' resident bytes halve, dense and banked, and so does the
  §3.3 model's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs.base import OptimizerConfig as JOptimizerConfig
from repro.configs.base import SelectConfig as JSelectConfig
from repro.configs.base import TrainConfig as JTrainConfig
from repro.core import masked_adamw as jadamw
from repro.train.trainer import Trainer as JTrainer
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import (OptimizerConfig, SelectConfig,
                                      TrainConfig)
from repro_torch.core import masked_adamw, offload
from repro_torch.core import partition as part
from repro_torch.kernels import ref
from repro_torch.train.trainer import Trainer

OVERRIDES = dict(pad_heads_to=6, vocab_size=250, pad_vocab_multiple=16)
HP = dict(lr=1e-2, b1=0.9, b2=0.999, eps=1e-8, wd=0.1)
L, R = 6, 300
SEL = np.array([1, 0, 1, 1, 0, 1], np.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, as in ``tests/test_torch_gated.py``: under
    pytest-xdist each worker's default of one thread a core oversubscribes
    the host and the small models' ops wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16_bits(x) -> np.ndarray:
    """bf16 values (a tensor or an ml_dtypes array) as int16 bits."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().astype(np.int32)
    return np.asarray(x).view(np.int16).astype(np.int32)


def _within_one_ulp(got, want, what):
    """Same-sign bf16 values one apart in their bits are one ulp apart."""
    g, w = _bf16_bits(got), _bf16_bits(want)
    assert (np.sign(g) == np.sign(w)).all(), what
    assert np.abs(g - w).max() <= 1, f"{what}: {np.abs(g - w).max()} ulps"


def _inputs(pdtype, rows=L, seed=0):
    rng = np.random.default_rng(seed)
    p = rng.standard_normal((rows, R)).astype(np.float32)
    g = (0.5 + rng.standard_normal((rows, R))).astype(np.float32)
    m = (0.05 + 0.1 * rng.standard_normal((rows, R))).astype(
        ml_dtypes.bfloat16)
    v = (0.01 + 0.01 * np.abs(rng.standard_normal((rows, R)))).astype(
        ml_dtypes.bfloat16)
    if pdtype == "bfloat16":
        p, g = p.astype(ml_dtypes.bfloat16), g.astype(ml_dtypes.bfloat16)
    return p, g, m, v


def _torch(x):
    x = np.asarray(x)
    if x.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(x.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(x.copy())


def _reference(p, g, m, v, sel, cnt):
    """The reference's XLA masked AdamW on [rows, R] with per-row sel and
    counts."""
    ocfg = JOptimizerConfig(b1=HP["b1"], b2=HP["b2"], eps=HP["eps"],
                            weight_decay=HP["wd"])
    fn = jax.jit(lambda *a: jadamw._adamw_rows(ocfg, *a, HP["lr"],
                                               pallas_ok=False))
    p2, m2, v2 = fn(*(jnp.asarray(x) for x in (p, g, m, v)),
                    jnp.asarray(sel)[:, None], jnp.asarray(cnt)[:, None])
    assert m2.dtype == jnp.bfloat16 and v2.dtype == jnp.bfloat16
    return np.asarray(p2), np.asarray(m2), np.asarray(v2)


def _check_step(pdtype, got, want, p0, m0, v0, on):
    (tp, tm, tv), (jp, jm, jv) = got, want
    if pdtype == "float32":
        np.testing.assert_allclose(tp.numpy(), jp, rtol=1e-6, atol=1e-6)
    else:
        _within_one_ulp(tp, jp, "p")
    _within_one_ulp(tm, jm, "m")
    _within_one_ulp(tv, jv, "v")
    for what, new, old in (("p", tp, p0), ("m", tm, m0), ("v", tv, v0)):
        np.testing.assert_array_equal(
            _bf16_bits(new[~on]) if new.dtype == torch.bfloat16
            else new[~on].numpy(),
            _bf16_bits(old[~on]) if old.dtype == ml_dtypes.bfloat16
            else old[~on], err_msg=f"{what} of a row with sel = 0")
    assert not np.array_equal(_bf16_bits(tm[on]), _bf16_bits(m0[on]))


@pytest.mark.parametrize("pdtype", ["float32", "bfloat16"])
def test_plain_dense_matches_the_reference_xla_path(pdtype):
    p, g, m, v = _inputs(pdtype)
    cnt = np.arange(1, L + 1, dtype=np.float32)
    got = ref.masked_adamw(*map(_torch, (p, g, m, v, SEL, cnt)),
                           *HP.values())
    assert got[1].dtype == got[2].dtype == torch.bfloat16
    _check_step(pdtype, got, _reference(p, g, m, v, SEL, cnt), p, m, v,
                SEL > 0)


def test_unstacked_leaf_matches_the_reference_xla_path():
    """``core.masked_adamw._adamw_rows`` (the embedding, final norm and head
    leaves, outside the kernel) on one bf16-moment row, in place."""
    p, g, m, v = _inputs("float32", rows=1)
    ocfg = OptimizerConfig(b1=HP["b1"], b2=HP["b2"], eps=HP["eps"],
                           weight_decay=HP["wd"])
    tp, tm, tv = _torch(p[0]), _torch(m[0]), _torch(v[0])
    masked_adamw._adamw_rows(ocfg, tp, _torch(g[0]), tm, tv,
                             torch.tensor(1.0), torch.tensor(3.0), HP["lr"])
    jp, jm, jv = _reference(p, g, m, v, np.ones(1, np.float32),
                            np.full(1, 3.0, np.float32))
    assert tm.dtype == torch.bfloat16
    np.testing.assert_allclose(tp.numpy(), jp[0], rtol=1e-6, atol=1e-6)
    _within_one_ulp(tm, jm[0], "m")
    _within_one_ulp(tv, jv[0], "v")


@pytest.mark.parametrize("pdtype", ["float32", "bfloat16"])
def test_plain_banked_matches_the_reference_xla_path(pdtype):
    """Row 9's plain version: bank rows at out-of-order slots, a free slot
    and an unselected held row, against the reference on the gathered
    rows."""
    p, g, _, _ = _inputs(pdtype, rows=L)
    _, _, m, v = _inputs(pdtype, rows=4, seed=1)
    slots = np.array([4, 0, L, 2], np.int32)        # slot 2 is free
    sel = np.array([1, 1, 1, 0], np.float32)        # row 2 held, unselected
    cnt = np.array([2, 5, 1, 3], np.float32)
    got = ref.banked_masked_adamw(*map(_torch, (p, g, m, v, slots, sel,
                                                 cnt)), *HP.values())
    held = np.minimum(slots, L - 1)
    on = (slots < L) & (sel > 0)
    jp, jm, jv = _reference(p[held], g[held], m, v, np.where(on, sel, 0),
                            cnt)
    _within_one_ulp(got[1], jm, "m")
    _within_one_ulp(got[2], jv, "v")
    rows = slots[on]
    if pdtype == "float32":
        np.testing.assert_allclose(got[0].numpy()[rows], jp[on], rtol=1e-6,
                                   atol=1e-6)
    else:
        _within_one_ulp(got[0][torch.from_numpy(rows).long()], jp[on], "p")
    untouched = np.setdiff1d(np.arange(L), rows)
    np.testing.assert_array_equal(_bf16_bits(got[0][untouched])
                                  if pdtype == "bfloat16"
                                  else got[0].numpy()[untouched],
                                  _bf16_bits(p[untouched])
                                  if pdtype == "bfloat16" else p[untouched])
    for new, old in ((got[1], m), (got[2], v)):
        np.testing.assert_array_equal(_bf16_bits(new[~on]),
                                      _bf16_bits(old[~on]))


def test_moments_round_ties_to_nearest_even():
    """b1 = b2 = 0 makes m' = g exactly (f32 params): g on a tie between
    two bf16 values goes to the even one, as the reference's convert
    does."""
    one = np.float32(1.0)
    step = np.float32(2.0 ** -8)   # half a bf16 ulp at 1
    g = np.array([[one + step, one + 3 * step, -(one + step),
                   one + 5 * step]], np.float32)
    want_m = np.array([[1.0, 1.0 + 2 ** -6, -1.0, 1.0 + 2 ** -6]],
                      ml_dtypes.bfloat16)
    z = np.zeros_like(g).astype(ml_dtypes.bfloat16)
    hp = dict(HP, b1=0.0, b2=0.0)
    _, m2, _ = ref.masked_adamw(_torch(np.ones_like(g)), _torch(g),
                                _torch(z), _torch(z),
                                torch.ones(1), torch.ones(1), *hp.values())
    np.testing.assert_array_equal(_bf16_bits(m2), _bf16_bits(want_m))
    np.testing.assert_array_equal(_bf16_bits(want_m),
                                  _bf16_bits(g.astype(ml_dtypes.bfloat16)))


# ---------------------------------------------------------------- training


def _tcfg(policy="random", gate=False, **opt):
    cfg = get_smoke_config("qwen2.5-0.5b").replace(remat="none",
                                                   gate_weight_grads=gate)
    return TrainConfig(
        model=cfg, method=policy,
        select=SelectConfig(policy=policy, k_percent=40),
        optimizer=OptimizerConfig(lr=1e-3, schedule="constant",
                                  warmup_steps=0, moment_dtype="bfloat16",
                                  **opt),
        seq_len=48, global_batch=4, steps=5, log_every=0)


@pytest.mark.parametrize("gate", [False, True], ids=["ungated", "gated"])
def test_banked_equals_dense_bit_for_bit(gate):
    """The random policy moves blocks in and out of the banks every step;
    the bf16 moments keep their bits through the store."""
    dense = Trainer(_tcfg(gate=gate), device="cpu")
    banked = Trainer(_tcfg(gate=gate, moment_residency="banked",
                           offload="host", async_swap=True), device="cpu")
    dense.train()
    banked.train()
    assert banked.log.losses == dense.log.losses
    pn = part.build_partition(dense.tcfg.model)
    m, v = masked_adamw.materialize_moments(pn, banked.state["opt"])
    for got, want in ((m, dense.state["opt"]["m"]),
                      (v, dense.state["opt"]["v"]),
                      (banked.state["params"], dense.state["params"])):
        for a, b in zip(part.leaves(got), part.leaves(want)):
            assert a.dtype == b.dtype
            assert torch.equal(a.view(torch.int16) if a.dtype ==
                               torch.bfloat16 else a, b.view(torch.int16)
                               if b.dtype == torch.bfloat16 else b)
    assert all(x.dtype == torch.bfloat16
               for x in part.leaves(banked.state["opt"]["store"]))


def test_trainer_trajectory_with_bf16_moments():
    """Five topk_grad steps of both Trainers with bf16 moments from the JAX
    trainer's initial state: losses to 1e-5, masks and counts equal, the
    moments bf16 on both sides."""
    jcfg = jax_smoke_config("qwen2.5-0.5b").replace(**OVERRIDES)
    cfg = get_smoke_config("qwen2.5-0.5b").replace(**OVERRIDES)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    kw = dict(seq_len=48, global_batch=4, steps=5, seed=0, log_every=0,
              method="topk_grad")
    sk = dict(k_percent=40, steps_per_epoch=10, epsilon_decay=0.05)
    ok = dict(lr=1e-2, schedule="constant", warmup_steps=0,
              moment_dtype="bfloat16")
    jtr = JTrainer(JTrainConfig(model=jcfg, select=JSelectConfig(**sk),
                                optimizer=JOptimizerConfig(**ok), **kw))
    ttr = Trainer(TrainConfig(model=cfg, select=SelectConfig(**sk),
                              optimizer=OptimizerConfig(**ok), **kw),
                  device="cpu")
    ttr.state = convert.train_state_from_numpy(jax.device_get(jtr.state),
                                               cfg, "cpu")
    jlog, tlog = jtr.train(), ttr.train()
    np.testing.assert_allclose(tlog.losses, jlog.losses, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(ttr.state["sel"]["mask"].numpy(),
                                  np.asarray(jtr.state["sel"]["mask"]))
    np.testing.assert_array_equal(ttr.state["opt"]["counts"].numpy(),
                                  np.asarray(jtr.state["opt"]["counts"]))
    # the gradients differ by ~1e-5 between the frameworks, which carries
    # a few entries across a bf16 rounding boundary over five steps: each
    # m entry within one bf16 ulp of its leaf's largest magnitude
    jm = jax.tree_util.tree_leaves(jtr.state["opt"]["m"])
    for t, j in zip(part.leaves(ttr.state["opt"]["m"]), jm):
        assert t.dtype == torch.bfloat16 and j.dtype == jnp.bfloat16
        j = np.asarray(j).astype(np.float32)
        np.testing.assert_allclose(t.float().numpy(), j, rtol=0,
                                   atol=2.0 ** -8 * np.abs(j).max())


@pytest.mark.parametrize("residency", ["device", "banked"])
def test_resident_moment_bytes_halve(residency):
    opt = dict(moment_residency=residency,
               offload="host" if residency == "banked" else "none")
    f32 = Trainer(dataclasses.replace(_tcfg(**opt), optimizer=OptimizerConfig(
        **opt)), device="cpu")
    bf16 = Trainer(_tcfg(**opt), device="cpu")

    def moment_bytes(state):
        o = state["opt"]
        trees = [o["m"], o["v"]] if residency == "device" else \
            [b[k] for b in o["banks"].values() for k in "mv"] + [o["store"]]
        return sum(x.numel() * x.element_size() for t in trees
                   for x in part.leaves(t))
    assert 2 * moment_bytes(bf16.state) == moment_bytes(f32.state)
    r32 = offload.resident_opt_bytes(f32.state["opt"])
    r16 = offload.resident_opt_bytes(bf16.state["opt"])
    assert r32["device"] + r32["host"] - (r16["device"] + r16["host"]) \
        == moment_bytes(bf16.state)
    cfg = bf16.tcfg.model
    assert 2 * bf16.method.trainable_param_report(cfg, bf16.state).opt_bytes \
        == f32.method.trainable_param_report(cfg, f32.state).opt_bytes
