"""Variable-length SFT record sources (the pipeline's input end; a copy of
the JAX package's ``data/pipeline/records.py``).

A ``Record`` is one prompt/completion pair as token id arrays — *no padding,
no fixed length*. Sources expose deterministic random access
(``record_at(index)``) over a finite corpus; the stream position is therefore
a single integer **cursor** (record index, monotonically increasing across
epochs — ``record_at(cursor % num_records)``), which serializes into a
checkpoint and resumes the stream exactly (see pipeline.SFTPipeline).

Two concrete sources:

* ``SyntheticMathRecords`` — the offline MetaMathQA proxy as variable-length
  records (same problems as data/synthetic.py, but without seq_len padding,
  so the packer sees true lengths).
* ``JsonlSftRecords`` — real SFT corpora: one ``{"prompt": str,
  "completion": str}`` JSON object per line, byte-tokenized. The prompt is
  encoded with BOS (and no EOS), the completion with EOS (and no BOS), so a
  packed segment is ``BOS prompt... completion... EOS`` and always *starts*
  with a loss-masked token — the invariant that makes the packed loss equal
  the per-example oracle (a cross-segment next-token target is always
  masked).
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Protocol, runtime_checkable

import numpy as np

from repro_torch.data import synthetic
from repro_torch.data import tokenizer as tok


@dataclass(frozen=True)
class Record:
    """One SFT example. ``prompt`` tokens are context (loss-masked 0);
    ``completion`` tokens are supervised (loss-masked 1)."""
    prompt: np.ndarray       # [P] i32, P >= 1 (starts with BOS)
    completion: np.ndarray   # [C] i32

    def __post_init__(self):
        if len(self.prompt) < 1:
            raise ValueError(
                "Record.prompt must be non-empty (segments must start with a "
                "loss-masked token so packed cross-segment targets are "
                "masked; prepend BOS)")

    def __len__(self) -> int:
        return len(self.prompt) + len(self.completion)


@runtime_checkable
class RecordSource(Protocol):
    """Deterministic random access over a finite corpus of records.

    ``record_at(i)`` must be a pure function of ``i`` for 0 <= i <
    ``num_records`` — the pipeline wraps indices modulo ``num_records`` (an
    epoch) and resumes from a plain integer cursor."""

    num_records: int

    def record_at(self, index: int) -> Record: ...


@dataclass
class SyntheticMathRecords:
    """data/synthetic.py problems as variable-length records.

    ``num_records`` bounds the corpus (one epoch); problems themselves are a
    pure function of (seed, index) so any size is valid."""
    cfg: synthetic.MathTaskConfig
    num_records: int = 4096
    eval_split: bool = False

    def record_at(self, index: int) -> Record:
        if not 0 <= index < self.num_records:
            raise IndexError(index)
        base = self.cfg.eval_offset if self.eval_split else 0
        toks, mask = synthetic.sample_problem(self.cfg, base + index)
        # strip the fixed-length padding: true length = last supervised
        # token (the mask covers CoT + answer + EOS)
        end = int(np.max(np.nonzero(mask))) + 1
        p_len = synthetic.prompt_len(self.cfg)
        return Record(prompt=np.asarray(toks[:p_len], np.int32),
                      completion=np.asarray(toks[p_len:end], np.int32))


@dataclass
class JsonlSftRecords:
    """``{"prompt", "completion"}`` JSONL corpus, byte-tokenized and
    materialized once (SFT corpora are small; streaming decode stays an
    option behind the same protocol)."""
    path: str
    _records: list[Record] = field(init=False, repr=False)

    def __post_init__(self):
        self._records = []
        with open(self.path) as f:
            for ln, line in enumerate(f, 1):
                if not line.strip():
                    continue
                obj = json.loads(line)
                if "prompt" not in obj or "completion" not in obj:
                    raise ValueError(
                        f"{self.path}:{ln}: jsonl_sft records need "
                        f"'prompt' and 'completion' keys, got "
                        f"{sorted(obj)} (use --data jsonl for plain "
                        f"{{'text': ...}} document corpora)")
                self._records.append(Record(
                    prompt=tok.encode(obj["prompt"], add_bos=True,
                                      add_eos=False),
                    completion=tok.encode(obj["completion"], add_bos=False,
                                          add_eos=True)))
        if not self._records:
            raise ValueError(f"{self.path}: empty jsonl_sft corpus")

    @property
    def num_records(self) -> int:
        return len(self._records)

    def record_at(self, index: int) -> Record:
        return self._records[index]
