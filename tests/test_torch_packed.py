"""The port's packed SFT pipeline and packed training against the JAX
package's, on the CPU.

- The records, packed and unpacked batches, pipeline cursors and packing
  statistics are bit-equal to the JAX copies (numpy on both sides).
- Packed ``apply_train`` logits equal the JAX model's at 1e-4, with the
  attention on the reference's ``chunked_attention`` (``use_pallas=
  "never"``) and on the flash path (``"auto"``: the plain versions of the
  flash kernels here).
- Inside the port, a packed batch's loss and gradients equal the unpacked
  oracle's (one record per row): loss 1e-5 relative, each gradient leaf
  within 1e-5 of its largest magnitude.
- Five packed ``topk_grad`` and ``full`` Trainer steps from the JAX
  trainer's exported state equal the JAX ``Trainer(data_source=...)``:
  losses 1e-5, masks, counts and the committed cursor equal.

The model is the smoke qwen2.5-0.5b of ``tests/test_torch_train.py`` (f32,
padded heads, padded vocab); nothing relies on JAX's PRNG for the port's
inputs.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.data import loader as jloader
from repro.data import pipeline as jpipe
from repro.data import synthetic as jsynthetic
from repro.models import lm as jlm
from repro.train.trainer import Trainer as JTrainer
from repro_torch import convert
from repro_torch.data import loader, pipeline, synthetic
from repro_torch.data.pipeline import packing
from repro_torch.models import lm
from repro_torch.train import step
from repro_torch.train.trainer import Trainer
from test_torch_train import (_configs, _np, _np_tree, _param_shapes, _t,
                              _tcfgs)

TEXTS = [("What is 2+2?", "4"), ("Übersetze: Haus", "house"),
         ("x" * 70, "a long prompt, cut at the row length"), ("p", "")]


def _jsonl(tmp_path):
    path = tmp_path / "sft.jsonl"
    path.write_text("\n".join(json.dumps({"prompt": p, "completion": c})
                              for p, c in TEXTS) + "\n\n")
    return str(path)


def _sources(kind, tmp_path):
    if kind == "jsonl_sft":
        path = _jsonl(tmp_path)
        return jpipe.JsonlSftRecords(path), pipeline.JsonlSftRecords(path)
    return (jpipe.SyntheticMathRecords(
        jsynthetic.MathTaskConfig(seed=3), num_records=50),
        pipeline.SyntheticMathRecords(synthetic.MathTaskConfig(seed=3),
                                      num_records=50))


def _equal_batches(a, b):
    assert sorted(a) == sorted(b)
    for key in a:
        assert a[key].dtype == b[key].dtype, key
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


@pytest.mark.parametrize("kind", ["packed_math", "jsonl_sft"])
def test_records_batches_and_cursors_are_bit_equal(kind, tmp_path):
    jsrc, tsrc = _sources(kind, tmp_path)
    assert tsrc.num_records == jsrc.num_records
    for i in range(tsrc.num_records):
        jr, tr = jsrc.record_at(i), tsrc.record_at(i)
        np.testing.assert_array_equal(tr.prompt, jr.prompt)
        np.testing.assert_array_equal(tr.completion, jr.completion)
    n = tsrc.num_records
    for seq_len in (50, 128):
        for cursor in (0, 3, n - 2):      # the last crosses the epoch
            jb, jc = jpipe.packing.pack_batch(jsrc, cursor, 3, seq_len)
            tb, tc = packing.pack_batch(tsrc, cursor, 3, seq_len)
            assert tc == jc
            _equal_batches(tb, jb)
            jb, jc = jpipe.packing.unpacked_batch(jsrc, cursor, 3, seq_len)
            tb, tc = packing.unpacked_batch(tsrc, cursor, 3, seq_len)
            assert tc == jc
            _equal_batches(tb, jb)
        assert packing.packing_stats(tsrc, seq_len, 3) == \
            jpipe.packing.packing_stats(jsrc, seq_len, 3)


@pytest.mark.parametrize("pack", [True, False])
def test_pipeline_stream_matches_jax(pack, tmp_path):
    """``make_source`` pipelines: the batch stream, the cursors it yields
    and a restored cursor, as the JAX pipeline gives them."""
    kw = dict(seq_len=96, global_batch=2, seed=1, pack=pack,
              num_records=20)
    jp = jloader.make_source("packed_math", **kw)
    tp = loader.make_source("packed_math", **kw)
    assert isinstance(tp, pipeline.SFTPipeline)
    for _ in range(2):
        for (jb, jc), (tb, tc) in zip(jp.batches(4), tp.batches(4)):
            assert tc == jc
            _equal_batches(tb, jb)
        jp.restore_cursor(jc)
        tp.restore_cursor(tc)
        assert tp.cursor() == jp.cursor()
    src = loader.make_source("synthetic_math", seq_len=48, global_batch=2)
    adapter = pipeline.StepIndexedAdapter(src, 3)
    (b, c), = adapter.batches(1)
    assert c == {"step": 4}
    _equal_batches(b, src.batch_at(3))
    # the legacy ring source builds and gives the reference's batches
    path = tmp_path / "docs.jsonl"
    path.write_text("".join(json.dumps({"text": f"doc {i} " * (i + 1)})
                            + "\n" for i in range(6)))
    kw = dict(seq_len=16, global_batch=2, path=str(path))
    tj = loader.make_source("jsonl", **kw)
    jj = jloader.make_source("jsonl", **kw)
    for s in (0, 5):
        _equal_batches(tj.batch_at(s), jj.batch_at(s))


def _packed_np(seq_len=96, rows=2, cursor=0):
    src = pipeline.SyntheticMathRecords(synthetic.MathTaskConfig(),
                                        num_records=64)
    return packing.pack_batch(src, cursor, rows, seq_len), src


@pytest.mark.parametrize("use_pallas", ["never", "auto"])
def test_packed_apply_train_matches_jax(use_pallas):
    jcfg, cfg = _configs()
    npp = _np_tree(_param_shapes(jcfg), 0)
    (batch, _), _ = _packed_np()
    assert batch["segment_ids"].max() == 2
    jlog = jax.jit(lambda p, b: jlm.apply_train(p, jcfg, b)[0])(
        jax.tree.map(jnp.asarray, npp), jax.tree.map(jnp.asarray, batch))
    cfg = cfg.replace(use_pallas=use_pallas)
    tlog, _, _ = lm.apply_train(convert.params_from_numpy(npp, cfg, "cpu"),
                                cfg, _t(batch))
    np.testing.assert_allclose(_np(tlog), np.asarray(jlog), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("use_pallas", ["never", "auto"])
def test_packed_equals_unpacked_oracle(use_pallas):
    """Loss and gradients of a packed batch equal those of the same records
    one a row (every cross-segment target is a masked prompt token)."""
    _, cfg = _configs()
    cfg = cfg.replace(use_pallas=use_pallas)
    npp = _np_tree(_param_shapes(_configs()[0]), 0)
    params = convert.params_from_numpy(npp, cfg, "cpu")
    (packed, nxt), src = _packed_np(cursor=5)
    unpacked, nxt_u = packing.unpacked_batch(src, 5, nxt - 5, 48)
    assert nxt_u == nxt and nxt - 5 == 4

    def run(batch):
        return step.value_and_grad(
            lambda p, mb: step.model_loss(cfg, p, mb), params, _t(batch))
    (lp, _), gp = run(packed)
    (lu, _), gu = run(unpacked)
    np.testing.assert_allclose(lp.item(), lu.item(), rtol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(
            jax.tree.map(_np, gp)), jax.tree_util.tree_leaves(
            jax.tree.map(_np, gu))):
        scale = np.abs(b).max()
        assert np.abs(a - b).max() <= 1e-5 * max(scale, 1e-30), (
            a.shape, np.abs(a - b).max(), scale)


@pytest.mark.parametrize("method", ["topk_grad", "full"])
def test_packed_trainer_trajectory(method):
    """Five packed steps of both Trainers, each on its own packed_math
    pipeline (two records a row), from the JAX trainer's initial state."""
    jt, tt = _tcfgs(method)
    jt = dataclasses.replace(jt, seq_len=96)
    tt = dataclasses.replace(tt, seq_len=96)
    kw = dict(seq_len=96, global_batch=tt.global_batch, seed=0)
    jtr = JTrainer(jt, data_source=jloader.make_source("packed_math", **kw))
    ttr = Trainer(tt, data_source=loader.make_source("packed_math", **kw),
                  device="cpu")
    ttr.state = convert.train_state_from_numpy(jax.device_get(jtr.state),
                                               tt.model, "cpu")
    jlog = jtr.train()
    tlog = ttr.train()
    np.testing.assert_allclose(tlog.losses, jlog.losses, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(_np(ttr.state["sel"]["mask"]),
                                  np.asarray(jtr.state["sel"]["mask"]))
    np.testing.assert_array_equal(_np(ttr.state["opt"]["counts"]),
                                  np.asarray(jtr.state["opt"]["counts"]))
    assert ttr.data.cursor() == jtr.data.cursor() == {"record": 40}
    assert tlog.records == [8] * 5
    assert all(0 < n <= 4 * 96 for n in tlog.real_tokens)
    # the next call continues the record stream where this one stopped
    ttr.train(1)
    assert ttr.data.cursor() == {"record": 48}
