"""Data sources of the trainer (port of the JAX package's
``data/loader.py``, one host).

``SyntheticMathSource.batch_at(step)`` and ``JsonlSource.batch_at(step)``
(byte-tokenized ``{"text"}`` documents packed into fixed-length rows of a
ring) give the global batch of a step as numpy arrays ``{"tokens",
"loss_mask"}``, a pure function of the step. ``make_source("packed_math"
| "jsonl_sft", ...)`` returns a streaming ``data.pipeline.SFTPipeline``
over variable-length prompt/completion records, packed with
``segment_ids`` and per-segment ``positions`` unless ``pack=False``.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field

import numpy as np

from repro_torch.data import synthetic
from repro_torch.data import tokenizer as tok


@dataclass
class SyntheticMathSource:
    cfg: synthetic.MathTaskConfig
    global_batch: int

    def batch_at(self, step: int) -> dict:
        return synthetic.batch_at(self.cfg, step, self.global_batch)


@dataclass
class JsonlSource:
    """Packs byte-tokenized documents into fixed-length rows (drop-remainder).
    The whole (small) corpus is materialized once; batches index a ring."""
    path: str
    seq_len: int
    global_batch: int
    rows: np.ndarray = field(init=False)

    def __post_init__(self):
        stream: list[int] = []
        with open(self.path) as f:
            for line in f:
                if not line.strip():
                    continue
                text = json.loads(line).get("text", "")
                stream.extend(tok.encode(text).tolist())
        if not stream:
            raise ValueError(
                f"{self.path}: no tokens — the corpus is empty (need at "
                f"least 1 token; {self.seq_len} fill one row)")
        if len(stream) < self.seq_len:
            # shorter than one row: pad the tail (PAD rows are loss-masked
            # out in batch_at)
            stream = stream + [tok.PAD] * (self.seq_len - len(stream))
        n = len(stream) // self.seq_len
        arr = np.asarray(stream[: n * self.seq_len], np.int32)
        self.rows = arr.reshape(n, self.seq_len)

    def batch_at(self, step: int) -> dict:
        n = self.rows.shape[0]
        idx = (np.arange(self.global_batch) + step * self.global_batch) % n
        toks = self.rows[idx]
        return {"tokens": toks,
                "loss_mask": (toks != tok.PAD).astype(np.float32)}


def make_source(kind: str, *, seq_len: int, global_batch: int,
                seed: int = 1234, path: str = "", digits: int = 3,
                pack: bool = True, num_records: int = 4096):
    """``synthetic_math`` / ``jsonl`` are the pure-f(step) sources;
    ``jsonl_sft`` (prompt/completion lines) and ``packed_math`` (the
    synthetic corpus as variable-length records) return a streaming
    ``SFTPipeline`` (packed unless ``pack=False``)."""
    if kind == "synthetic_math":
        return SyntheticMathSource(
            synthetic.MathTaskConfig(digits=digits, seq_len=seq_len,
                                     seed=seed), global_batch)
    if kind == "jsonl":
        return JsonlSource(path, seq_len, global_batch)
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
