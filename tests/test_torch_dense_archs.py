"""The reference's other three dense archs, chatglm3-6b, yi-9b and
qwen2.5-32b, in the port against the JAX package, on the CPU.

- Each config equals the reference's field for field (CONFIG and SMOKE),
  and the full configs have the reckoned layers, blocks, heads and
  parameter counts.
- The SMOKE configs' prefill logits and two dense decode steps, and a
  five-step ``topk_grad`` trajectory against the JAX ``Trainer``.
- A head-layout variant of each full config keeps its own q/kv heads, head
  dim 128, partial rotary (chatglm3-6b's 0.5), QKV bias and
  ``pad_heads_to`` (qwen2.5-32b's 40 q heads padded to 48 on 8 kv heads,
  kv head 7 serving 5 real and 8 padded heads) at d_model 256, d_ff 256,
  vocab 256 and 2 layers in f32: the SMOKE configs have head dim 16 and 2
  kv heads and never see those layouts. Its training logits, prefill
  logits and one paged decode step are held against JAX.
- The plain RMSNorm forward at qwen2.5-32b's D 5120 (and the forward's
  widest, 8192) against the reference's Pallas kernel in interpret mode;
  the plain dense and paged decode at 48 q / 8 kv heads against
  ``repro.kernels.ref``.
- ``lm.init`` draws each leaf slice by slice: shapes, scales and a fixed
  order (the same generator gives the same values).

Parameters come from numpy with a seed (norm scales 1 + 0.1 N(0, 1), the
rest, biases included, 0.1 N(0, 1)), never from JAX's PRNG. Tolerances:
logits 1e-4 (sums reordered across layers), losses 1e-5, kernels' plain
versions ``tests/test_kernels.py::_tol`` (f32 1e-5, bf16 2e-2).
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import ml_dtypes
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
from repro.train.trainer import Trainer as JTrainer
from repro_torch import convert
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import (OptimizerConfig, SelectConfig,
                                      TrainConfig)
from repro_torch.kernels import ops, ref
from repro_torch.models import lm
from repro_torch.models.layers import attention
from repro_torch.train.trainer import Trainer

ARCHS = ("chatglm3-6b", "yi-9b", "qwen2.5-32b")
TOL = dict(rtol=1e-4, atol=1e-4)
# the head-layout variant: each model's own heads at a small width
NARROW = dict(d_model=256, d_ff=256, vocab_size=256, num_layers=2,
              dtype="float32")
# qwen2.5-32b's q-head -> kv-head map: 5 a kv head, the 8 padded heads
# clamped onto kv head 7
QWEN32_HMAP = np.minimum(np.arange(48) // 5, 7)


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


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


# ------------------------------------------------------------ configs


@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_reference(arch, which):
    get, jget = ((get_config, jax_config) if which == "CONFIG"
                 else (get_smoke_config, jax_smoke_config))
    assert dataclasses.asdict(get(arch)) == dataclasses.asdict(jget(arch))
    assert get(arch).num_blocks == jget(arch).num_blocks
    assert get(arch).padded_heads == jget(arch).padded_heads


def test_full_configs_have_the_reckoned_shapes():
    """Layers, blocks, widths, heads (padded), QKV bias, rotary factor and
    the parameter counts (all and a layer) reckoned from the port's specs,
    the figures the card phases are sized by."""
    want = {"chatglm3-6b": (28, 31, 4096, 32, 2, 128, True, 0.5,
                            6_243_584_000, 203_960_832),
            "yi-9b": (48, 51, 4096, 32, 4, 128, False, 1.0,
                      8_829_407_232, 173_023_232),
            "qwen2.5-32b": (64, 67, 5120, 48, 8, 128, True, 1.0,
                            33_435_030_528, 498_092_032)}
    for arch, (nl, nb, d, hp, kvh, dh, bias, rot, n_all, n_layer) in \
            want.items():
        cfg = get_config(arch)
        shapes = lm.param_shapes(cfg)
        n = sum(math.prod(s) for s in _leaves(shapes))
        per_layer = sum(math.prod(s) for s in _leaves(shapes["layers"]))
        assert (cfg.num_layers, cfg.num_blocks, cfg.d_model,
                cfg.padded_heads, cfg.num_kv_heads, cfg.head_dim,
                cfg.attn_bias, cfg.partial_rotary_factor) == (
                    nl, nb, d, hp, kvh, dh, bias, rot)
        assert ("bq" in shapes["layers"]["attn"]) == bias
        assert (n, per_layer // nl) == (n_all, n_layer)


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
    device, equals the reference's (qwen2.5-32b: 5 q heads a kv head, the 8
    padded heads clamped onto kv head 7, 13 there)."""
    cfg = get_config(arch)
    want = np.asarray(jattn._hmap(jax_config(arch)))
    np.testing.assert_array_equal(attention._hmap(cfg), want)
    np.testing.assert_array_equal(
        attention._hmap_tensor(cfg, "cpu").numpy(), want)
    counts = {"chatglm3-6b": [16] * 2, "yi-9b": [8] * 4,
              "qwen2.5-32b": [5] * 7 + [13]}[arch]
    assert np.bincount(want).tolist() == counts
    if arch == "qwen2.5-32b":
        np.testing.assert_array_equal(want, QWEN32_HMAP)


@pytest.mark.parametrize("arch", ARCHS)
def test_head_layout_logits(arch):
    """The training forward (the flash kernels' plain versions) and the
    prefill at the models' own heads, rotary width and bias, against the
    reference."""
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


@pytest.mark.parametrize("arch", ARCHS)
def test_head_layout_paged_decode(arch):
    """One paged decode step at the models' own heads over a scrambled page
    table (the reference's gather path): logits and the written pools equal
    JAX's."""
    jcfg, cfg = _narrow(arch)
    jp, tp = _model(jcfg, cfg, seed=4)
    jcfg = jcfg.replace(use_pallas="never")
    ps, num_pages, max_len = 4, 12, 16
    toks = _tokens(2, 9, cfg.vocab_size, seed=5)
    lv = np.asarray([9, 3], np.int32)
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


# ----------------------------------- the kernels' plain versions, widened


def _tol(dtype):
    """tests/test_kernels.py::_tol."""
    return (dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16"
            else dict(rtol=1e-5, atol=1e-5))


@pytest.mark.parametrize("d", [5120, 8192])
def test_rmsnorm_forward_widened_vs_jax(d):
    """The plain forward at qwen2.5-32b's D 5120 and at the forward's
    widest, 8192, against the reference's Pallas kernel (interpret mode)
    and its plain version, f32 1e-5."""
    rng = np.random.default_rng(d)
    x = (2 * rng.standard_normal((6, d))).astype(np.float32)
    s = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    out = ops.rmsnorm(torch.from_numpy(x), torch.from_numpy(s), 1e-6)
    np.testing.assert_allclose(
        out.numpy(), np.asarray(jrms.rmsnorm(jnp.asarray(x), jnp.asarray(s),
                                             1e-6, interpret=True)),
        **_tol("float32"))
    np.testing.assert_allclose(
        out.numpy(), np.asarray(jref.rmsnorm(jnp.asarray(x), jnp.asarray(s),
                                             1e-6)), **_tol("float32"))


def _pair(a, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    a = np.asarray(a, np.float32)
    if dtype == "bfloat16":
        a16 = a.astype(ml_dtypes.bfloat16)
        return (jnp.asarray(a16),
                torch.from_numpy(a16.view(np.uint16).astype(np.int16))
                .view(torch.bfloat16))
    return jnp.asarray(a), torch.from_numpy(a.copy())


def _strong(want, dtype):
    """Every row of the expected output has an RMS of at least 10 tol, so
    an all-zero or flat-average output would fail the comparison."""
    w = np.asarray(want, np.float32)
    rms = np.sqrt((w.reshape(w.shape[0], -1) ** 2).mean(axis=1))
    assert (rms >= 10 * _tol(dtype)["atol"]).all(), rms


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_decode_48_heads_vs_jax(dtype):
    """Row 1's plain version at qwen2.5-32b's map (48 q heads, 8 kv, D 128)
    over a scrambled table with sentinels, valid_len one position, a
    partial page and the full table, against the JAX oracle."""
    rng = np.random.default_rng(48)
    b, ps, maxp, d = 3, 4, 12, 128
    num_pages = b * maxp + 2
    qj, qt = _pair(3 * rng.standard_normal((b, 48, d)), dtype)
    kj, kt = _pair(rng.standard_normal((num_pages, ps, 8, d)), dtype)
    vj, vt = _pair(rng.standard_normal((num_pages, ps, 8, d)), dtype)
    vl = np.asarray([1, ps + 3, maxp * ps], np.int32)
    perm = rng.permutation(num_pages)
    tbl = np.full((b, maxp), num_pages, np.int32)
    used = 0
    for i in range(b):
        n = -(-int(vl[i]) // ps)
        tbl[i, :n] = perm[used:used + n]
        used += n
    hm = QWEN32_HMAP.astype(np.int32)
    out = ops.paged_decode_attention(
        qt.view(b, 1, 48, d), kt, vt, torch.from_numpy(tbl),
        torch.from_numpy(vl), torch.from_numpy(hm)).view(b, 48, d)
    oracle = jref.paged_decode_attention(qj, kj, vj, jnp.asarray(tbl),
                                         jnp.asarray(vl), jnp.asarray(hm))
    _strong(oracle, dtype)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(oracle, np.float32), **_tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_decode_48_heads_vs_jax(dtype):
    """Row 3's plain version at qwen2.5-32b's map on an unexpanded [B, S,
    KVH, D] cache with per-row valid_len, against the JAX oracle on the
    head-expanded view."""
    rng = np.random.default_rng(49)
    b, s, d = 3, 64, 128
    qj, qt = _pair(3 * rng.standard_normal((b, 48, d)), dtype)
    kj, kt = _pair(rng.standard_normal((b, s, 8, d)), dtype)
    vj, vt = _pair(rng.standard_normal((b, s, 8, d)), dtype)
    vl = np.asarray([1, 33, 64], np.int32)
    hm = QWEN32_HMAP.astype(np.int32)
    out = ops.decode_attention(qt.view(b, 1, 48, d), kt, vt,
                               torch.from_numpy(vl),
                               torch.from_numpy(hm)).view(b, 48, d)

    def expand(t):   # [B, S, KVH, D] -> [B, H, S, D]
        return t[:, :, hm].transpose(0, 2, 1, 3)
    oracle = jref.decode_attention(qj, expand(kj), expand(vj),
                                   jnp.asarray(vl))
    _strong(oracle, dtype)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(oracle, np.float32), **_tol(dtype))


# ------------------------------------------------------------ lm.init


def test_init_draws_each_leaf_in_slices(monkeypatch):
    """``lm.init`` at qwen2.5-32b's head layout, narrow and with slices
    smaller than its leaves: the reference's shapes, zero biases, unit
    scales, each weight's std its scale, and the same generator seed the
    same values (a fixed order of draws); the slices are drawn one after
    another, so a draw of one slice gives the values of that slice."""
    cfg = _narrow("qwen2.5-32b")[1].replace(num_layers=3)
    monkeypatch.setattr(lm, "INIT_DRAW", 256 * 256)   # one layer's wg a draw
    a = lm.init(cfg, torch.Generator().manual_seed(3), device="cpu")
    b = lm.init(cfg, torch.Generator().manual_seed(3), device="cpu")
    shapes = lm.param_shapes(cfg)
    assert jax.tree.map(lambda t: tuple(t.shape), a) == shapes
    for x, y in zip(_leaves(a), _leaves(b)):
        assert torch.equal(x, y)
    assert not a["layers"]["attn"]["bq"].any()
    assert bool((a["layers"]["ln1"]["scale"] == 1).all())
    wg = a["layers"]["mlp"]["wg"]
    assert abs(wg.std().item() / 256 ** -0.5 - 1) < 0.02
    g = torch.Generator().manual_seed(3)
    first = torch.randn((1, 256, 256), generator=g) * 256 ** -0.5
    # the first leaf drawn is embed/tok, [256, 256]: one draw
    np.testing.assert_allclose(a["embed"]["tok"].numpy(), first[0].numpy(),
                               rtol=1e-6, atol=0)
