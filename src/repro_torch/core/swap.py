"""Overlapped moment streaming for the banked residency (port of the JAX
package's ``core/swap.py``).

A selection-change boundary moves evicted blocks' bank rows to the store
and admitted blocks' store rows into the banks. ``SwapPlanner`` takes that
work off the critical path by predicting the next selection
(``adagradselect.predict_next``; exact for policies that read no gradient
norms) and running the predicted boundary's copies while the card computes:

* ``dispatch`` (after step t's phase B is queued) plans the boundary of the
  predicted mask and queues its copies on a dedicated copy stream, which
  first waits on an event recorded on the current stream. So evictions read
  the bank rows phase B(t) wrote, and admissions read store rows that no
  queued work changes (admitted blocks are not resident). Every store copy
  goes on this one stream, so a block evicted at boundary t and admitted
  again at t + 1 is read after its writeback.
* ``resolve`` (step t + 1, after the one host read of the real indices)
  makes the current stream wait on the copies' event. If the prediction
  was exact only ``commit_swap`` is left: a few device copies of staged
  rows into bank slots. A miss falls back to the synchronous
  ``swap_banked`` on the current stream and is counted; the predicted
  evictions it already wrote are inert (those blocks' moments are still in
  the banks) and the staged rows are dropped.

The reference runs the boundary on a background thread that blocks on
``device_get``; its safety rests on immutable arrays. The port updates
params, banks and store in place, and a thread would race CUDA streams and
the caching allocator, so the planner uses no thread: it only queues work
on streams and orders it with events, on the caller's thread. The staging
rows are allocated on the copy stream and marked with ``record_stream``
where the current stream consumes them; a dropped job is first waited on.
The reference's ``StagingPool`` is not needed: the pinned store is the
staging on the host side. Nor is its ``close``, which shuts its thread
down: ``quiesce`` is all the end of training needs.

On the CPU there are no streams and each copy completes where it is issued;
the planner's plans, hits and misses are the same.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import masked_adamw as ma


@dataclasses.dataclass
class SwapStats:
    """Boundary accounting and step-phase times of the banked step.
    ``boundaries`` counts selection changes that moved moments;
    ``predicted_hits`` those fully served by a dispatch; ``sync_swaps`` the
    synchronous ones; ``mispredicts`` the sync swaps made while a wrong
    prediction (or one whose plan overflowed) was in flight. A boundary with
    no prediction in flight — the first step of a ``train`` call, or async
    disabled — is a sync swap but no mispredict. ``predicted_hit_rate`` is
    the reference's, hits over all boundaries; ``dispatched_hit_rate`` is
    hits over the boundaries that had a prediction in flight. Phase times
    are host-clock microseconds summed over steps: ``phase_a_us`` includes
    the wait for the forward, backward and selection (the indices read), ``swap_us`` the boundary (resolve and commit, or the
    synchronous swap), ``phase_b_us`` the queueing of the update and of the
    next dispatch. (The reference's obs histograms wait for ROADMAP Queue A
    item 10.)"""
    steps: int = 0
    boundaries: int = 0
    predicted_hits: int = 0
    sync_swaps: int = 0
    mispredicts: int = 0
    dispatches: int = 0
    phase_a_us: float = 0.0
    swap_us: float = 0.0
    phase_b_us: float = 0.0

    @property
    def predicted_hit_rate(self) -> float:
        return (self.predicted_hits / self.boundaries if self.boundaries
                else 1.0)

    @property
    def dispatched_hit_rate(self) -> float:
        predicted = self.predicted_hits + self.mispredicts
        return self.predicted_hits / predicted if predicted else 1.0

    def as_dict(self) -> dict:
        return {**dataclasses.asdict(self),
                "predicted_hit_rate": self.predicted_hit_rate,
                "dispatched_hit_rate": self.dispatched_hit_rate}


def _mask(num_blocks: int, indices: np.ndarray) -> np.ndarray:
    mask = np.zeros((num_blocks,), bool)
    mask[indices[indices < num_blocks]] = True
    return mask


class SwapPlanner:
    """Owns the predicted boundary of one banked trainer. At most one job is
    in flight; ``resolve`` and ``quiesce`` order the current stream after
    it before anything it touches is used again."""

    def __init__(self, partition, num_blocks: int, enabled: bool = True):
        self.partition = partition
        self.num_blocks = num_blocks
        self.enabled = enabled
        self.stats = SwapStats()
        self._stream = None    # the copy stream, made at the first dispatch
        self._pending = None   # the dispatched job

    def dispatch(self, pred_indices: np.ndarray, banks: dict, store: dict,
                 slot_map) -> None:
        """Queue the boundary of the predicted next selection
        (``pred_indices``, host ints). Call after this step's update is
        queued. No-op when async streaming is disabled or a job is
        pending."""
        if not self.enabled or self._pending is not None:
            return
        idx = np.asarray(pred_indices)
        self.stats.dispatches += 1
        try:
            plans = ma.plan_swap(self.partition, slot_map,
                                 _mask(self.num_blocks, idx),
                                 ma.bank_caps(banks))
        except RuntimeError:
            # the predicted selection overflows a bank; the real one may not
            self._pending = {"idx": idx, "plans": None}
            return
        staged, done = {}, None
        if plans:
            staged, done = self._enqueue(plans, banks, store)
        self._pending = {"idx": idx, "plans": plans, "staged": staged,
                         "done": done}

    def _enqueue(self, plans, banks, store):
        """The plans' admissions and evictions, queued after everything the
        current stream holds: on the copy stream on the card, in place on
        the CPU. Returns (staged rows, the copies' event or None)."""
        dev = next(iter(banks.values()))["slots"].device
        if dev.type != "cuda":
            staged = ma.prefetch_admissions(plans, banks, store)
            ma.writeback_evictions(plans, banks, store)
            return staged, None
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
        ready = torch.cuda.Event()
        ready.record()
        self._stream.wait_event(ready)
        with torch.cuda.stream(self._stream):
            staged = ma.prefetch_admissions(plans, banks, store)
            ma.writeback_evictions(plans, banks, store)
            done = torch.cuda.Event()
            done.record(self._stream)
        return staged, done

    def resolve(self, indices: np.ndarray, banks: dict, store: dict,
                slot_map):
        """The boundary of this step's real selection (``indices``, host
        ints). A pending exact prediction leaves only the commit; anything
        else falls back to ``swap_banked``. Returns the new slot_map."""
        idx = np.asarray(indices)
        job = self._take_pending()
        if job is not None and job["plans"] is not None \
                and np.array_equal(job["idx"], idx):
            if job["plans"]:   # an unchanged selection is not a boundary
                self.stats.boundaries += 1
                self.stats.predicted_hits += 1
            return ma.commit_swap(job["plans"], banks, slot_map,
                                  job["staged"])
        mask = _mask(self.num_blocks, idx)
        if not ma.plan_swap(self.partition, slot_map, mask,
                            ma.bank_caps(banks)):
            return np.array(slot_map, np.int32)
        self.stats.boundaries += 1
        self.stats.sync_swaps += 1
        self.stats.mispredicts += job is not None
        return ma.swap_banked(self.partition, banks, store, slot_map, mask)

    def quiesce(self) -> None:
        """Order the current stream after any pending job and drop it. Run
        before reading the state on the host and at the end of training;
        nothing is lost (staged rows can be made again, predicted
        writebacks are inert)."""
        self._take_pending()

    def _take_pending(self):
        job, self._pending = self._pending, None
        if job is not None and job.get("done") is not None:
            torch.cuda.current_stream().wait_event(job["done"])
        return job
