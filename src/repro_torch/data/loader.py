"""Data sources of the trainer (the synthetic-math part of the JAX package's
``data/loader.py``).

``SyntheticMathSource.batch_at(step)`` gives the global batch of a step as
numpy arrays ``{"tokens", "loss_mask"}``, a pure function of the step. The
jsonl sources and the streaming SFT pipeline (``jsonl_sft``,
``packed_math``) are ROADMAP Queue A item 8.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.data import synthetic


@dataclass
class SyntheticMathSource:
    cfg: synthetic.MathTaskConfig
    global_batch: int

    def batch_at(self, step: int) -> dict:
        return synthetic.batch_at(self.cfg, step, self.global_batch)


def make_source(kind: str, *, seq_len: int, global_batch: int,
                seed: int = 1234, digits: int = 3):
    if kind == "synthetic_math":
        return SyntheticMathSource(
            synthetic.MathTaskConfig(digits=digits, seq_len=seq_len,
                                     seed=seed), global_batch)
    if kind in ("jsonl", "jsonl_sft", "packed_math"):
        raise NotImplementedError(
            f"data source {kind!r} is not ported yet (ROADMAP Queue A item "
            f"8, 'Packed SFT pipeline')")
    raise ValueError(kind)
