"""The port's greedy eval (``repro_torch.train.evaluate``) against the JAX
package's.

The answer parsers copied from ``repro.data.synthetic`` are pinned against
their originals; ``math_accuracy`` runs on a smoke config (f32, a padded q
head, a 32-token vocabulary, the embedding rows of ANS and EOS scaled so
that greedy decoding of random weights emits the ANS token and digits) with
the same numpy parameters in both packages:
each problem's decoded answer and the score must be equal. The score does
not depend on the slot count, and the dense decode's plain kernel version
(``use_pallas="auto"``) gives the tokens of the reference's einsum path
(``"never"``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_smoke_config as jax_smoke_config
from repro.data import synthetic as jsyn
from repro.models import lm as jlm
from repro.train import evaluate as jeval
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.data import synthetic
from repro_torch.kernels import ops
from repro_torch.methods import registry
from repro_torch.train import evaluate

OVERRIDES = dict(pad_heads_to=6, vocab_size=32, pad_vocab_multiple=16)
TASK = synthetic.MathTaskConfig(digits=1, seq_len=24, seed=3)
N_PROBLEMS = 8


@pytest.fixture(scope="module")
def model():
    jcfg = jax_smoke_config("qwen2.5-0.5b").replace(**OVERRIDES)
    cfg = get_smoke_config("qwen2.5-0.5b").replace(**OVERRIDES)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    shapes = jax.eval_shape(lambda k: jlm.init(k, jcfg),
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
    rng = np.random.default_rng(0)

    def leaf(path, s):
        base = 1.0 if path[-1].key == "scale" else 0.0
        return (base + 0.3 * rng.standard_normal(s.shape)).astype(np.float32)
    npp = jax.tree_util.tree_map_with_path(leaf, shapes)
    # the tied embedding's ANS row scaled up and its EOS row down, so that
    # greedy decoding of these random weights reaches ANS and digits before
    # it stops: the per-problem answers compared are not all None
    npp["embed"]["tok"][synthetic.ANS] *= 4.0
    npp["embed"]["tok"][synthetic.EOS] *= 0.2
    return (jcfg, jax.tree.map(jnp.asarray, npp), cfg,
            convert.params_from_numpy(npp, cfg, "cpu"))


def _jtask(task):
    return jsyn.MathTaskConfig(**dataclasses.asdict(task))


@pytest.mark.parametrize("digits, seq_len", [(3, 64), (1, 24)])
def test_answer_parsers_match_jax(digits, seq_len):
    task = synthetic.MathTaskConfig(digits=digits, seq_len=seq_len, seed=7)
    jtask = _jtask(task)
    for i in range(200):
        for split in (True, False):
            assert synthetic.answer_of(task, i, split) == jsyn.answer_of(
                jtask, i, split)
        toks, _ = synthetic.sample_problem(task, task.eval_offset + i)
        assert synthetic.decode_answer(toks) == jsyn.decode_answer(toks)
        assert synthetic.decode_answer(toks) == synthetic.answer_of(task, i)
    garbled = [np.asarray(t, np.int32) for t in (
        [], [synthetic.ANS], [synthetic.ANS, synthetic.EOS],
        [3, synthetic.ANS, 9, 10, synthetic.PLUS, 11],
        [synthetic.D0 + 4, synthetic.ANS, synthetic.D0, synthetic.D0 + 7])]
    for toks in garbled:
        assert synthetic.decode_answer(toks) == jsyn.decode_answer(toks)


def test_math_accuracy_matches_jax(model, monkeypatch):
    """The same decoded answer for each held-out problem, and the same
    score, as the JAX evaluator on the same numpy params."""
    jcfg, jp, cfg, tp = model
    seen, parse = [], jsyn.decode_answer

    def recording(tokens):
        seen.append(parse(tokens))
        return seen[-1]
    monkeypatch.setattr(jeval.synthetic, "decode_answer", recording)
    jacc = jeval.math_accuracy(jp, jcfg, _jtask(TASK),
                               num_problems=N_PROBLEMS, batch_size=4)
    monkeypatch.undo()
    run = evaluate.greedy_eval(tp, cfg, TASK, num_problems=N_PROBLEMS,
                               batch_size=4, device="cpu")
    assert run.predictions == seen
    assert run.accuracy == jacc
    assert run.answers == [synthetic.answer_of(TASK, i)
                           for i in range(N_PROBLEMS)]
    # the comparison has power: some generations carry an answer
    assert any(p is not None for p in run.predictions), run.tokens
    assert evaluate.math_accuracy(tp, cfg, TASK, num_problems=N_PROBLEMS,
                                  batch_size=4, device="cpu") == jacc


def test_math_accuracy_independent_of_slots_and_path(model):
    """The score is the same for 4 and 8 slots (tests/test_serve.py pins
    this for the reference), and the plain dense decode kernel version
    (``use_pallas="auto"``, through ``ops.decode_attention``) generates the
    tokens of the reference's einsum path (``"never"``)."""
    _, _, cfg, tp = model
    before = dict(ops.LAUNCHES)
    runs = {(slots, mode): evaluate.greedy_eval(
        tp, cfg.replace(use_pallas=mode), TASK, num_problems=N_PROBLEMS,
        batch_size=slots, device="cpu")
        for slots in (4, 8) for mode in ("auto", "never")}
    assert ops.LAUNCHES == before   # CPU tensors: plain versions only
    base = runs[(4, "auto")]
    for key, run in runs.items():
        assert run.accuracy == base.accuracy, key
        assert run.predictions == base.predictions, key
    for slots in (4, 8):
        for a, b in zip(runs[(slots, "auto")].tokens,
                        runs[(slots, "never")].tokens):
            np.testing.assert_array_equal(a, b)
    for run in runs.values():
        assert run.stats["admitted"] == run.stats["completed"] == N_PROBLEMS


def test_eval_params_of_selection_methods(model):
    """``eval_params`` returns the state's params (the reference's
    ``SelectionMethod.eval_params``)."""
    from repro_torch.configs.base import TrainConfig
    _, _, cfg, _ = model
    tcfg = TrainConfig(model=cfg, seq_len=TASK.seq_len, global_batch=2,
                       steps=1)
    method = registry.build("adagradselect", tcfg)
    state = method.init_state(cfg, tcfg.optimizer, 0, device="cpu")
    assert method.eval_params(cfg, tcfg.optimizer, state) is state["params"]


def test_eval_refuses_what_is_not_ported(model):
    """A mesh raises (item 11); the prefix cache, which raised until the
    serving stack was ported (item 7), serves the same answers as the
    default engine."""
    _, _, cfg, tp = model
    with pytest.raises(NotImplementedError, match="item 11"):
        evaluate.math_accuracy(tp, cfg, TASK, mesh=object(), device="cpu")
    plain = evaluate.greedy_eval(tp, cfg, TASK, num_problems=4,
                                 batch_size=2, device="cpu")
    cached = evaluate.greedy_eval(
        tp, cfg, TASK, num_problems=4, batch_size=2, device="cpu",
        serve_cfg=evaluate.ServeConfig(max_len=8, num_slots=1,
                                       kv_layout="paged", prefix_cache=True))
    assert cached.accuracy == plain.accuracy
    for a, b in zip(cached.tokens, plain.tokens):
        np.testing.assert_array_equal(a, b)
