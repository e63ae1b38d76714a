"""The paper's other two models, llama3.2-1b and phi4-mini-3.8b, in the
port against the JAX package, on the CPU.

- Each config equals the reference's field for field (CONFIG and SMOKE).
- The SMOKE configs' prefill logits and two dense decode steps, and a
  five-step ``topk_grad`` trajectory against the JAX ``Trainer``.
- A head-layout variant of each full config keeps the real q/kv head counts,
  head dim and ``pad_heads_to`` (32 q on 8 kv heads at head dim 64; 24 q
  padded to 32 on 8 kv at head dim 128, kv head 7 serving 3 real and 8
  padded heads) at d_model 256, d_ff 256, vocab 256 and 2 layers in f32:
  the SMOKE configs have head dim 16 and 2 kv heads and never see those
  head maps. Its training logits, prefill logits and one paged decode
  step are held against JAX.
- The plain RMSNorm forward and backward (full and dx-only) at the two
  models' widths, D 2048 and 3072, against the reference's Pallas kernel
  in interpret mode and ``jax.vjp`` of its ``norms.apply``.

Parameters come from numpy with a seed (norm scales 1 + 0.1 N(0, 1), the
rest 0.1 N(0, 1); these configs have no QKV bias), never from JAX's PRNG.
Tolerances: logits 1e-4 (sums reordered across layers), losses 1e-5, the
RMSNorm f32 1e-5 (``tests/test_kernels.py::_tol``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs.base import OptimizerConfig as JOptimizerConfig
from repro.configs.base import SelectConfig as JSelectConfig
from repro.configs.base import TrainConfig as JTrainConfig
from repro.kernels import ref as jref
from repro.kernels import rmsnorm as jrms
from repro.models import lm as jlm
from repro.models.layers import attention as jattn
from repro.models.layers import norms as jnorms
from repro.train.trainer import Trainer as JTrainer
from repro_torch import convert
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import (OptimizerConfig, SelectConfig,
                                      TrainConfig)
from repro_torch.kernels import ref
from repro_torch.models import lm
from repro_torch.models.layers import attention
from repro_torch.train.trainer import Trainer

ARCHS = ("llama3.2-1b", "phi4-mini-3.8b")
TOL = dict(rtol=1e-4, atol=1e-4)
# the head-layout variant: each model's own heads at a small width
NARROW = dict(d_model=256, d_ff=256, vocab_size=256, num_layers=2,
              dtype="float32")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, as in ``tests/test_torch_gated.py``: under
    pytest-xdist each worker's default of one thread a core oversubscribes
    the host, and the small models' many small ops wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_params(jcfg, seed=0) -> dict:
    shapes = jax.eval_shape(lambda k: jlm.init(k, jcfg),
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        v = 0.1 * rng.standard_normal(s.shape)
        if path[-1].key == "scale":
            v = 1.0 + v
        return v.astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _smoke(arch):
    jcfg, cfg = jax_smoke_config(arch), get_smoke_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jcfg, cfg


def _narrow(arch):
    """The full config at NARROW widths, ``head_dim`` passed explicitly
    (``d_model // num_heads`` would no longer give the model's own)."""
    jfull, full = jax_config(arch), get_config(arch)
    kw = dict(NARROW, head_dim=full.head_dim)
    jcfg, cfg = jfull.replace(**kw), full.replace(**kw)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jcfg, cfg


def _model(jcfg, cfg, seed=0):
    npp = _np_params(jcfg, seed)
    return (jax.tree.map(jnp.asarray, npp),
            convert.params_from_numpy(npp, cfg, "cpu"))


def _close(t, j):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), **TOL)


def _tokens(b, s, vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


# ------------------------------------------------------------ configs


@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_reference(arch, which):
    get, jget = ((get_config, jax_config) if which == "CONFIG"
                 else (get_smoke_config, jax_smoke_config))
    assert dataclasses.asdict(get(arch)) == dataclasses.asdict(jget(arch))
    assert get(arch).attn_bias is False
    assert get(arch).num_blocks == jget(arch).num_blocks


def test_full_configs_have_the_papers_shapes():
    """The table of the reference's configs: layers, blocks, widths and
    heads (padded), and parameter counts reckoned from the port's specs."""
    want = {"llama3.2-1b": (16, 18, 2048, 32, 8, 64, 1235.8),
            "phi4-mini-3.8b": (32, 34, 3072, 32, 8, 128, 4037.3)}
    for arch, (nl, nb, d, hp, kvh, dh, mparams) in want.items():
        cfg = get_config(arch)
        shapes = lm.param_shapes(cfg)
        assert "bq" not in shapes["layers"]["attn"]
        n = sum(int(np.prod(s)) for s in jax.tree_util.tree_leaves(
            shapes, is_leaf=lambda x: isinstance(x, tuple)))
        assert (cfg.num_layers, cfg.num_blocks, cfg.d_model,
                cfg.padded_heads, cfg.num_kv_heads, cfg.head_dim) == (
                    nl, nb, d, hp, kvh, dh)
        assert round(n / 1e6, 1) == mparams


# ------------------------------------------------------- SMOKE: the model


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_prefill_and_decode(arch):
    """Prefill at mixed lengths, then two decode steps against the dense
    cache, logits within 1e-4 of the reference's."""
    jcfg, cfg = _smoke(arch)
    jp, tp = _model(jcfg, cfg)
    toks = _tokens(3, 12, cfg.vocab_size)
    lv = np.asarray([12, 5, 9], np.int32)
    jl, jc = jlm.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, 16,
                         lengths=jnp.asarray(lv))
    tl_, tc = lm.prefill(tp, cfg, {"tokens": torch.from_numpy(toks)}, 16,
                         lengths=torch.from_numpy(lv))
    _close(tl_, jl)
    for _ in range(2):
        nxt = np.array(jnp.argmax(jl, -1), np.int32)[:, None]
        jl, jc = jlm.decode_step(jp, jcfg, jnp.asarray(nxt), jc)
        tl_, tc = lm.decode_step(tp, cfg, torch.from_numpy(nxt), tc)
        _close(tl_, jl)
    _close(tc["k"], jc["k"])
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


# ---------------------------------------------- the models' head layouts


@pytest.mark.parametrize("arch", ARCHS)
def test_head_layout_maps_like_the_reference(arch):
    """The q-head -> kv-head map of the full config, on the host and on the
    device, equals the reference's (phi4-mini: 3 q heads a kv head, the 8
    padded heads clamped onto kv head 7)."""
    cfg = get_config(arch)
    want = np.asarray(jattn._hmap(jax_config(arch)))
    np.testing.assert_array_equal(attention._hmap(cfg), want)
    np.testing.assert_array_equal(
        attention._hmap_tensor(cfg, "cpu").numpy(), want)
    assert len(want) == 32 and np.bincount(want).tolist() == (
        [4] * 8 if arch == "llama3.2-1b" else [3] * 7 + [11])


@pytest.mark.parametrize("arch", ARCHS)
def test_head_layout_logits(arch):
    """The training forward (the flash kernels' plain versions) and the
    prefill at the models' own heads, against the reference."""
    jcfg, cfg = _narrow(arch)
    jp, tp = _model(jcfg, cfg, seed=2)
    toks = _tokens(2, 24, cfg.vocab_size, seed=3)
    jlog = jlm.apply_train(jp, jcfg, {"tokens": jnp.asarray(toks)})[0]
    tlog = lm.apply_train(tp, cfg, {"tokens": torch.from_numpy(toks)})[0]
    _close(tlog, jlog)
    lv = np.asarray([24, 13], np.int32)
    jl, _ = jlm.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, 32,
                        lengths=jnp.asarray(lv))
    tl_, _ = lm.prefill(tp, cfg, {"tokens": torch.from_numpy(toks)}, 32,
                        lengths=torch.from_numpy(lv))
    _close(tl_, jl)


@pytest.mark.parametrize("use_pallas", ["never", "always"])
@pytest.mark.parametrize("arch", ARCHS)
def test_head_layout_paged_decode(arch, use_pallas):
    """One paged decode step at the models' own heads over a scrambled page
    table (the reference's gather path, and its Pallas paged kernel in
    interpret mode): logits and the written pools equal JAX's."""
    jcfg, cfg = _narrow(arch)
    jp, tp = _model(jcfg, cfg, seed=4)
    jcfg = jcfg.replace(use_pallas=use_pallas)
    ps, num_pages, max_len = 4, 12, 16
    lengths = [9, 3]
    toks = _tokens(2, 9, cfg.vocab_size, seed=5)
    lv = np.asarray(lengths, np.int32)
    jl, jc = jlm.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, 12,
                         lengths=jnp.asarray(lv))
    _, tc = lm.prefill(tp, cfg, {"tokens": torch.from_numpy(toks)}, 12,
                       lengths=torch.from_numpy(lv))
    cache_j = jlm.init_paged_cache(jcfg, 2, max_len, ps, num_pages)
    cache_t = lm.init_paged_cache(cfg, 2, max_len, ps, num_pages,
                                  device="cpu")
    perm = np.random.default_rng(6).permutation(num_pages).astype(np.int32)
    table = np.full((2, 4), num_pages, np.int32)
    table[0, :3] = perm[:3]       # 9 prompt + 1 new -> 3 pages
    table[1, :1] = perm[3:4]      # 3 prompt + 1 new -> 1 page
    cache_j = {**cache_j, "pages": jnp.asarray(table)}
    cache_t["pages"] = torch.from_numpy(table)
    slots = np.asarray([0, 1], np.int32)
    cache_j = jlm.insert_slots_paged(cache_j, jc, slots, lv)
    lm.insert_slots_paged(cache_t, tc, slots, lv)
    nxt = np.array(jnp.argmax(jl, -1), np.int32)[:, None]
    jl, cache_j = jlm.decode_step(jp, jcfg, jnp.asarray(nxt), cache_j)
    tl_, cache_t = lm.decode_step(tp, cfg, torch.from_numpy(nxt), cache_t)
    _close(tl_, jl)
    _close(cache_t["k"][:, :num_pages], cache_j["k"])
    _close(cache_t["v"][:, :num_pages], cache_j["v"])


# ---------------------------------------------------- SMOKE: training


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_topk_grad_trajectory(arch):
    """Five topk_grad steps of both Trainers from one state (the JAX
    trainer's, its params replaced by numpy ones) on the same synthetic
    batches: losses to 1e-5, final masks and counts equal."""
    jcfg, cfg = _smoke(arch)
    kw = dict(seq_len=48, global_batch=4, steps=5, seed=0, log_every=0,
              method="topk_grad")
    sk = dict(k_percent=40, steps_per_epoch=10, epsilon_decay=0.05)
    ok = dict(lr=1e-2, schedule="constant", warmup_steps=0)
    jtr = JTrainer(JTrainConfig(model=jcfg, select=JSelectConfig(**sk),
                                optimizer=JOptimizerConfig(**ok), **kw))
    jtr.state = {**jtr.state, "params": jax.tree.map(
        jnp.asarray, _np_params(jcfg, seed=7))}
    state0 = jax.device_get(jtr.state)
    tt = TrainConfig(model=cfg, select=SelectConfig(**sk),
                     optimizer=OptimizerConfig(**ok), **kw)
    ttr = Trainer(tt, device="cpu")
    ttr.state = convert.train_state_from_numpy(state0, cfg, "cpu")
    jlog = jtr.train()
    tlog = ttr.train()
    assert tlog.steps == jlog.steps == list(range(5))
    np.testing.assert_allclose(tlog.losses, jlog.losses, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(ttr.state["sel"]["mask"].numpy(),
                                  np.asarray(jtr.state["sel"]["mask"]))
    np.testing.assert_array_equal(ttr.state["opt"]["counts"].numpy(),
                                  np.asarray(jtr.state["opt"]["counts"]))
    assert int(ttr.state["sel"]["mask"].sum()) == tt.select.num_selected(
        cfg.num_blocks)


# ---------------------------------------------- RMSNorm at the new widths


@pytest.mark.parametrize("d", [2048, 3072])
def test_rmsnorm_wide_vs_jax(d):
    """The plain forward at D 2048 and 3072 against the reference's Pallas
    kernel (interpret mode) and its plain version, f32 1e-5."""
    rng = np.random.default_rng(d)
    x = (2 * rng.standard_normal((6, d))).astype(np.float32)
    s = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    out = ref.rmsnorm(torch.from_numpy(x), torch.from_numpy(s), 1e-6)
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        out.numpy(), np.asarray(jrms.rmsnorm(jnp.asarray(x), jnp.asarray(s),
                                             1e-6, interpret=True)), **tol)
    np.testing.assert_allclose(
        out.numpy(), np.asarray(jref.rmsnorm(jnp.asarray(x), jnp.asarray(s),
                                             1e-6)), **tol)


@pytest.mark.parametrize("with_dscale", [True, False])
@pytest.mark.parametrize("d", [2048, 3072])
def test_rmsnorm_bwd_wide_vs_jax(d, with_dscale):
    """The plain backward at D 2048 and 3072, full and dx-only, against
    ``jax.vjp`` of the reference's ``norms.apply``, f32 1e-5 (dscale
    relative to its largest entry: it sums over rows)."""
    rng = np.random.default_rng(d + 1)
    mu = 1 + 0.5 * rng.standard_normal(d)
    x = (mu + rng.standard_normal((8, d))).astype(np.float32)
    s = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    dy = (1 + rng.standard_normal((8, d))).astype(np.float32)
    dx, ds = ref.rmsnorm_bwd(*map(torch.from_numpy, (dy, x, s)), 1e-6,
                             with_dscale=with_dscale)
    _, vjp = jax.vjp(lambda xx, ss: jnorms.apply({"scale": ss}, xx, 1e-6),
                     jnp.asarray(x), jnp.asarray(s))
    jdx, jds = vjp(jnp.asarray(dy))
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), rtol=1e-5,
                               atol=1e-5)
    if with_dscale:
        jds = np.asarray(jds)
        np.testing.assert_allclose(ds.numpy(), jds, rtol=1e-5,
                                   atol=1e-5 * np.abs(jds).max())
    else:
        assert ds is None
