"""Streaming SFT input pipeline: records -> packed [B, L] batches -> device
(a copy of the JAX package's ``data/pipeline/__init__.py``).

  records.py   RecordSource — variable-length prompt/completion records with
               deterministic random access (cursor = one integer)
  packing.py   greedy segment-aware packer (tokens / loss_mask /
               segment_ids / positions), pure in the cursor
  prefetch.py  background-thread batch build + upload, ``depth`` ahead (on
               the card through pinned memory on a copy stream)

``SFTPipeline`` ties them together behind the iterator seam the Trainer
consumes: ``batches()`` yields ``(host_batch, cursor_after)`` pairs computed
from a LOCAL copy of the cursor, so iterating (and the prefetcher running
it ahead) never mutates pipeline state. The trainer commits consumption
back via ``restore_cursor`` with the cursor of the last batch it actually
used.

Legacy ``batch_at(step)`` sources keep working: the trainer wraps them in
``StepIndexedAdapter`` (cursor IS the step counter, as before).
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.data.pipeline import packing, records
from repro_torch.data.pipeline.prefetch import Prefetcher
from repro_torch.data.pipeline.records import (JsonlSftRecords, Record,
                                               RecordSource,
                                               SyntheticMathRecords)

__all__ = [
    "JsonlSftRecords", "Prefetcher", "Record", "RecordSource",
    "SFTPipeline", "StepIndexedAdapter", "SyntheticMathRecords", "packing",
    "records",
]


@dataclass
class SFTPipeline:
    """Streaming packed-batch producer over a RecordSource.

    ``pack=True``: greedy multi-segment packing (block-diagonal attention —
    the model consumes segment_ids/positions). ``pack=False``: one record
    per row, padded — the unpacked oracle layout with the same batch keys.
    """

    source: RecordSource
    seq_len: int
    global_batch: int
    pack: bool = True
    _cursor: int = field(default=0, init=False)

    # ------------------------------------------------------------ stream
    def build(self, cursor: int) -> tuple[dict, int]:
        """One batch from ``cursor`` — pure, the resume primitive."""
        fn = packing.pack_batch if self.pack else packing.unpacked_batch
        return fn(self.source, cursor, self.global_batch, self.seq_len)

    def batches(self, steps: int | None = None):
        """Yield ``(host_batch, cursor_after)`` from the current committed
        cursor. Iterates a LOCAL cursor — pipeline state is only advanced by
        ``restore_cursor`` (the trainer commits what it consumed)."""
        local = self._cursor
        produced = 0
        while steps is None or produced < steps:
            batch, local = self.build(local)
            yield batch, {"record": local}
            produced += 1

    # ------------------------------------------------------------ cursor
    def cursor(self) -> dict:
        """Serializable stream position."""
        return {"record": self._cursor}

    def restore_cursor(self, cursor: dict):
        self._cursor = int(cursor["record"])


@dataclass
class StepIndexedAdapter:
    """Iterator seam over a legacy pure-``f(step)`` source (SyntheticMath):
    the cursor is the step counter, which the TrainState already holds."""

    source: object  # anything with batch_at(step) -> dict
    start_step: int = 0

    def batches(self, steps: int | None = None):
        step = self.start_step
        while steps is None or step < self.start_step + steps:
            yield self.source.batch_at(step), {"step": step + 1}
            step += 1
