"""Task evaluation — the GSM8K-protocol proxy: zero-shot, greedy decoding,
exact match on the generated answer (paper §4.2). Port of the JAX package's
``train/evaluate.py`` onto the port's ``ServeEngine``, whose default dense
layout runs the dense decode kernel on the card.

``math_accuracy`` keeps the reference's signature and protocol, plus
``device`` (the card unless the caller passes ``device="cpu"``, which runs
the plain versions of the kernels). ``greedy_eval`` is the same run, and
returns what it generated beside the score. As in the reference, the
trainer has no eval hook: train, then evaluate ``method.eval_params(...)``.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.data import synthetic
from repro_torch.serve.config import ServeConfig
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.scheduler import Request


@dataclass
class EvalRun:
    accuracy: float
    answers: list           # the expected answer of each problem
    predictions: list       # the decoded answer of each problem (or None)
    tokens: list            # the generated tokens of each problem
    stats: dict             # the engine's counters over the whole run


def greedy_eval(params, cfg: ModelConfig, task: synthetic.MathTaskConfig,
                *, num_problems: int = 64, batch_size: int = 16, mesh=None,
                batch_axes=("data",), serve_cfg: ServeConfig | None = None,
                device="cuda") -> EvalRun:
    """Greedy-decode the CoT + answer for held-out problems; exact match.

    Problems stream through a ``ServeEngine`` in full-slot chunks of
    ``batch_size`` slots, drained one at a time, so memory scales with
    ``batch_size`` instead of ``num_problems`` and every admission has the
    same [slots, prompt_len] prefill shape.

    ``serve_cfg`` overrides the default serving configuration; its
    capacity fields, ``eos_id``, ``mesh`` and ``batch_axes`` are forced to
    the eval protocol's values (a paged layout with the prefix cache, for
    one, serves the same greedy answers)."""
    if mesh is not None:
        raise NotImplementedError(
            "evaluation on a mesh is not ported yet (ROADMAP Queue A item "
            "11, 'Distributed')")
    p_len = synthetic.prompt_len(task)
    toks = [synthetic.sample_problem(task, task.eval_offset + i)[0][:p_len]
            for i in range(num_problems)]
    answers = [synthetic.answer_of(task, i) for i in range(num_problems)]
    prompts = np.stack(toks).astype(np.int32)

    slots = min(batch_size, num_problems)
    if serve_cfg is None:
        scfg = ServeConfig(max_len=task.seq_len, num_slots=slots,
                           eos_id=synthetic.EOS, batch_axes=batch_axes)
    else:
        scfg = replace(serve_cfg, max_len=task.seq_len, num_slots=slots,
                       eos_id=synthetic.EOS, mesh=None,
                       batch_axes=batch_axes)
    engine = ServeEngine(cfg, params, scfg, device=device)
    preds, gen = [], []
    for start in range(0, num_problems, slots):
        chunk = prompts[start:start + slots]
        reqs = [Request(uid=start + i, tokens=chunk[i],
                        max_new_tokens=task.seq_len - p_len)
                for i in range(len(chunk))]
        res = engine.run(reqs)
        for i in range(len(chunk)):
            gen.append(res[start + i])
            preds.append(synthetic.decode_answer(res[start + i]))
    engine.close()
    correct = sum(int(p == a) for p, a in zip(preds, answers))
    return EvalRun(accuracy=correct / num_problems, answers=answers,
                   predictions=preds, tokens=gen, stats=dict(engine.stats))


def math_accuracy(params, cfg: ModelConfig, task: synthetic.MathTaskConfig,
                  *, num_problems: int = 64, batch_size: int = 16, mesh=None,
                  batch_axes=("data",), serve_cfg: ServeConfig | None = None,
                  device="cuda") -> float:
    """The exact-match accuracy of ``greedy_eval``."""
    return greedy_eval(params, cfg, task, num_problems=num_problems,
                       batch_size=batch_size, mesh=mesh,
                       batch_axes=batch_axes, serve_cfg=serve_cfg,
                       device=device).accuracy
