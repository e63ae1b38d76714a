"""The port's ``Prefetcher`` and the legacy ``jsonl`` source against the JAX
package's, on the CPU.

- The four ``Prefetcher`` contracts of ``tests/test_pipeline.py`` (order,
  ``depth=0`` synchronous, worker errors re-raised, ``close`` unblocks the
  producer), against the port's class.
- Over one packed pipeline the port's and the reference's prefetchers give
  equal batches and cursors.
- ``Trainer(prefetch_depth=2)`` equals ``prefetch_depth=0`` bit for bit
  (losses, records, every state leaf), packed and on the legacy
  ``batch_at`` source; read-ahead does not advance the committed cursor;
  a checkpoint resume with prefetch on equals the straight run.
- ``JsonlSource.batch_at`` equals the reference's on one file.
"""
import json

import numpy as np
import pytest
import torch

from repro.data import loader as jloader
from repro.data.pipeline import Prefetcher as JPrefetcher
from repro_torch import obs
from repro_torch.data import loader
from repro_torch.data.pipeline import Prefetcher
from repro_torch.train.trainer import Trainer
from test_torch_checkpoint import (_assert_same_run, _assert_same_state,
                                   _tcfg)


@pytest.fixture(autouse=True)
def _obs_clean():
    obs.disable()
    obs.metrics.reset()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    obs.disable()
    obs.metrics.reset()


# ------------------------------------------------ the Prefetcher contracts


def test_prefetcher_preserves_order_and_values():
    def stream():
        for i in range(20):
            yield {"x": np.full((2,), i)}, {"record": i + 1}
    with Prefetcher(stream(), lambda b: b, depth=4) as pf:
        out = list(pf)
    assert [c["record"] for _, c in out] == list(range(1, 21))
    assert all(int(b["x"][0]) == i for i, (b, _) in enumerate(out))
    assert obs.metrics.snapshot()["data"]["prefetch_batches"] == 20


def test_prefetcher_depth0_is_synchronous():
    pf = Prefetcher(iter([({"x": 1}, {"record": 1})]), depth=0)
    assert pf._thread is None
    assert next(pf) == ({"x": 1}, {"record": 1})
    with pytest.raises(StopIteration):
        next(pf)


def test_prefetcher_surfaces_worker_errors():
    def stream():
        yield {"x": 1}, {"record": 1}
        raise RuntimeError("boom")
    with Prefetcher(stream(), depth=2) as pf:
        next(pf)
        with pytest.raises(RuntimeError, match="boom"):
            while True:
                next(pf)


def test_prefetcher_close_unblocks_producer():
    """A full queue + early consumer exit must not deadlock or leak."""
    def stream():
        i = 0
        while True:
            yield {"x": i}, {"record": i}
            i += 1
    pf = Prefetcher(stream(), depth=1)
    next(pf)
    pf.close()
    assert pf._thread is None


def _packed(mod):
    return mod.make_source("packed_math", seq_len=96, global_batch=2,
                           seed=0, pack=True, num_records=40)


@pytest.mark.parametrize("depth", [0, 2])
def test_prefetchers_match_the_reference(depth):
    """The same packed pipeline through both prefetchers: equal batches
    and cursors, in order."""
    with Prefetcher(_packed(loader).batches(6), depth=depth) as tp, \
            JPrefetcher(_packed(jloader).batches(6), depth=depth) as jp:
        got, want = list(tp), list(jp)
    assert [c for _, c in got] == [c for _, c in want]
    for (tb, _), (jb, _) in zip(got, want):
        assert tb.keys() == jb.keys()
        for k in tb:
            np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)


# -------------------------------------------------------- the trainer


def _run(depth, packed, steps=5):
    data = _packed(loader) if packed else None
    tr = Trainer(_tcfg(steps=steps), data_source=data, prefetch_depth=depth,
                 device="cpu")
    tr.train(3)
    tr.train(steps - 3)
    return tr


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "legacy"])
def test_prefetch_is_bit_identical(packed):
    """Prefetch 2 against 0 over two ``train`` calls: the same losses,
    records and non-pad tokens a step, cursor and state, bit for bit."""
    a, b = _run(0, packed), _run(2, packed)
    assert b.log.losses == a.log.losses
    assert b.log.records == a.log.records
    assert b.log.real_tokens == a.log.real_tokens
    if packed:
        assert b.data.cursor() == a.data.cursor()
    _assert_same_state(a.state, b.state)


def test_readahead_does_not_advance_the_cursor():
    """The worker runs ahead of the loop (a depth of 4 over a 2-step call),
    yet the committed cursor is the one after the last batch trained on."""
    data = _packed(loader)
    want = 0
    for _ in range(2):
        _, want = data.build(want)
    tr = Trainer(_tcfg(), data_source=data, prefetch_depth=4, device="cpu")
    tr.train(2)
    assert data.cursor() == {"record": want}
    assert sum(tr.log.records) == want


def test_resume_with_prefetch(tmp_path):
    """3 steps + checkpoint, then a new prefetching Trainer restores and
    runs 3 more: the straight run's losses and state, bit for bit."""
    def trainer(ckdir):
        return Trainer(_tcfg(ckdir), data_source=_packed(loader),
                       prefetch_depth=2, device="cpu")
    straight = trainer("")
    straight.train(6)
    trainer(str(tmp_path)).train(3)
    resumed = trainer(str(tmp_path))
    assert resumed.maybe_restore() == 3
    resumed.train(3)
    assert resumed.log.losses == straight.log.losses[3:]
    assert resumed.data.cursor() == straight.data.cursor()
    _assert_same_run(straight, resumed)


# --------------------------------------------------- the legacy jsonl source


@pytest.mark.parametrize("docs, seq_len", [
    ([f"document {i}: " + "abc " * i for i in range(7)], 24),
    (["short"], 32)], ids=["ring", "padded"])
def test_jsonl_source_matches_the_reference(tmp_path, docs, seq_len):
    """Byte-tokenized documents in a ring of rows (a corpus shorter than a
    row is padded), batch for batch as the reference's."""
    path = tmp_path / "docs.jsonl"
    path.write_text("\n".join(json.dumps({"text": d}) for d in docs)
                    + "\n\n")
    kw = dict(seq_len=seq_len, global_batch=3, path=str(path))
    src, ref = loader.make_source("jsonl", **kw), \
        jloader.make_source("jsonl", **kw)
    np.testing.assert_array_equal(src.rows, ref.rows)
    for step in range(4):
        got, want = src.batch_at(step), ref.batch_at(step)
        assert got.keys() == want.keys()
        for k in got:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_jsonl_source_refuses_an_empty_corpus(tmp_path):
    path = tmp_path / "empty.jsonl"
    path.write_text("\n")
    with pytest.raises(ValueError, match="empty"):
        loader.make_source("jsonl", seq_len=8, global_batch=1,
                           path=str(path))
