"""Greedy segment-aware sequence packing (MaxText-style decoder_segment_ids;
a copy of the JAX package's ``data/pipeline/packing.py``).

``pack_batch(source, cursor, B, L)`` consumes records from ``cursor`` and
fills ``[B, L]`` rows first-fit: a record that still fits the current row is
appended as the next *segment*; one that doesn't closes the row. No record is
split across rows (a record longer than L is truncated to its first L
tokens — the only token loss packing introduces). The function is PURE in
``cursor``: rebuilding a batch from the same cursor yields bit-identical
arrays and the same ``next_cursor``, which is what makes checkpoint resume
and async prefetch exact.

Batch layout (all [B, L]):
  tokens       i32, PAD-filled tails
  loss_mask    f32, 1.0 on completion tokens only
  segment_ids  i32, 1..n per row, 0 = padding
  positions    i32, restart at 0 at every segment start (RoPE sees each
               example at its unpacked positions)

Parity contract: with block-diagonal attention (attend only within equal
nonzero segment_ids, causal within a segment) and the reset positions, the
loss/gradients of a packed batch equal the per-example unpacked oracle
(``unpacked_batch`` with one record per row) — every cross-segment
next-token target lands on a segment's first token, which is loss-masked
(records.Record guarantees a non-empty prompt).
"""
from __future__ import annotations

import numpy as np

from repro_torch.data import tokenizer as tok
from repro_torch.data.pipeline.records import Record, RecordSource


def _record_arrays(rec: Record) -> tuple[np.ndarray, np.ndarray]:
    toks = np.concatenate([rec.prompt, rec.completion]).astype(np.int32)
    mask = np.concatenate([np.zeros(len(rec.prompt), np.float32),
                           np.ones(len(rec.completion), np.float32)])
    return toks, mask


def _empty_batch(batch_size: int, seq_len: int) -> dict:
    return {
        "tokens": np.full((batch_size, seq_len), tok.PAD, np.int32),
        "loss_mask": np.zeros((batch_size, seq_len), np.float32),
        "segment_ids": np.zeros((batch_size, seq_len), np.int32),
        "positions": np.zeros((batch_size, seq_len), np.int32),
    }


def _place(batch: dict, row: int, start: int, toks, mask, seg: int):
    ln = len(toks)
    batch["tokens"][row, start:start + ln] = toks
    batch["loss_mask"][row, start:start + ln] = mask
    batch["segment_ids"][row, start:start + ln] = seg
    batch["positions"][row, start:start + ln] = np.arange(ln)


def pack_batch(source: RecordSource, cursor: int, batch_size: int,
               seq_len: int) -> tuple[dict, int]:
    """Greedy first-fit packing. -> (batch, next_cursor). Pure in cursor."""
    n = source.num_records
    batch = _empty_batch(batch_size, seq_len)
    i = cursor
    for row in range(batch_size):
        used, seg = 0, 0
        while True:
            toks, mask = _record_arrays(source.record_at(i % n))
            ln = len(toks)
            if ln > seq_len:
                toks, mask, ln = toks[:seq_len], mask[:seq_len], seq_len
            if used + ln > seq_len:
                break  # doesn't fit — record opens the next row
            seg += 1
            _place(batch, row, used, toks, mask, seg)
            used += ln
            i += 1
            if used == seq_len:
                break
    return batch, i


def unpacked_batch(source: RecordSource, cursor: int, batch_size: int,
                   seq_len: int) -> tuple[dict, int]:
    """One record per row, padded to seq_len (the per-example oracle layout
    and the pack=False pipeline mode). Emits only ``tokens``/``loss_mask``
    — single-segment rows ARE the plain causal path (pads sit at the tail,
    behind every supervised token), so no segment keys are needed and the
    batch stays consumable by every architecture family (ssm/hybrid/vlm/
    MLA included), which packed batches are not."""
    n = source.num_records
    batch = _empty_batch(batch_size, seq_len)
    i = cursor
    for row in range(batch_size):
        toks, mask = _record_arrays(source.record_at(i % n))
        ln = min(len(toks), seq_len)
        _place(batch, row, 0, toks[:ln], mask[:ln], 1)
        i += 1
    return {"tokens": batch["tokens"], "loss_mask": batch["loss_mask"]}, i


# ------------------------------------------------------------- accounting


def packing_stats(source: RecordSource, seq_len: int,
                  batch_size: int) -> dict:
    """One-epoch packing-efficiency accounting (what the JAX package's
    ``benchmarks/bench_data.py`` reports).

    ``*_kept``: fraction of the corpus' supervised (completion) tokens that
    train with their full example context intact —
      * packed: everything except truncation of records longer than L;
      * drop_remainder: the legacy concat-and-reshape layout
        (data/loader.JsonlSource) loses the reshape remainder AND corrupts
        every example straddling a row boundary (its context mixes the
        previous document);
      * unpacked: one example per row — tail truncation only.
    ``*_slot_util``: non-pad fraction of the [B, L] token slots actually
    emitted over the epoch (device-FLOP utilization of the layout).
    """
    n = source.num_records
    lens = np.array([len(source.record_at(i)) for i in range(n)])
    comp = np.array([len(source.record_at(i).completion) for i in range(n)])
    total_completion = int(comp.sum())
    total_tokens = int(lens.sum())

    # packed: walk one epoch through pack_batch
    packed_kept = 0
    packed_slots = packed_used = 0
    cur = 0
    while cur < n:
        batch, nxt = pack_batch(source, cur, batch_size, seq_len)
        for i in range(cur, min(nxt, n)):
            rec = source.record_at(i)
            if len(rec) <= seq_len:
                packed_kept += len(rec.completion)
            else:  # truncated: completion tokens within the first L survive
                packed_kept += max(0, seq_len - len(rec.prompt))
        packed_slots += batch["tokens"].size
        packed_used += int((batch["segment_ids"] != 0).sum())
        cur = nxt

    # drop-remainder: concatenate, reshape [*, L], drop the tail; an example
    # is intact iff it lies fully inside one row
    bounds = np.concatenate([[0], np.cumsum(lens)])
    kept_len = (total_tokens // seq_len) * seq_len
    drop_kept = 0
    for i in range(n):
        s, e = int(bounds[i]), int(bounds[i + 1])
        if e <= kept_len and s // seq_len == (e - 1) // seq_len:
            drop_kept += int(comp[i])

    # unpacked per-example rows: completion tokens that fit after the prompt
    unp_kept = int(sum(max(0, min(int(c), seq_len - int(ln - c)))
                       for ln, c in zip(lens, comp)))
    unp_rows = -(-n // batch_size) * batch_size
    unp_used = int(np.minimum(lens, seq_len).sum())

    denom = max(1, total_completion)
    return {
        "num_records": n,
        "corpus_tokens": total_tokens,
        "completion_tokens": total_completion,
        "packed_kept": packed_kept / denom,
        "drop_remainder_kept": drop_kept / denom,
        "unpacked_kept": unp_kept / denom,
        "packed_slot_util": packed_used / max(1, packed_slots),
        "unpacked_slot_util": unp_used / max(1, unp_rows * seq_len),
    }
