"""Data sources of the trainer (the JAX package's ``data/loader.py`` without
its legacy jsonl ring source).

``SyntheticMathSource.batch_at(step)`` gives the global batch of a step as
numpy arrays ``{"tokens", "loss_mask"}``, a pure function of the step.
``make_source("packed_math" | "jsonl_sft", ...)`` returns a streaming
``data.pipeline.SFTPipeline`` over variable-length prompt/completion
records, packed with ``segment_ids`` and per-segment ``positions`` unless
``pack=False``. The legacy ``jsonl`` ring source is ROADMAP Queue A item 8.
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
                seed: int = 1234, path: str = "", digits: int = 3,
                pack: bool = True, num_records: int = 4096):
    """``synthetic_math`` is the pure-f(step) source; ``jsonl_sft``
    (prompt/completion lines) and ``packed_math`` (the synthetic corpus as
    variable-length records) return a streaming ``SFTPipeline`` (packed
    unless ``pack=False``)."""
    if kind == "synthetic_math":
        return SyntheticMathSource(
            synthetic.MathTaskConfig(digits=digits, seq_len=seq_len,
                                     seed=seed), global_batch)
    if kind == "jsonl":
        raise NotImplementedError(
            "data source 'jsonl' (the legacy ring-packed document source) "
            "is not ported yet (ROADMAP Queue A item 8, 'Packed SFT "
            "pipeline'); use 'jsonl_sft' for prompt/completion corpora")
    if kind in ("jsonl_sft", "packed_math"):
        from repro_torch.data import pipeline as pipe
        if kind == "jsonl_sft":
            source = pipe.JsonlSftRecords(path)
        else:
            source = pipe.SyntheticMathRecords(
                synthetic.MathTaskConfig(digits=digits, seq_len=seq_len,
                                         seed=seed),
                num_records=num_records)
        return pipe.SFTPipeline(source, seq_len=seq_len,
                                global_batch=global_batch, pack=pack)
    raise ValueError(kind)
