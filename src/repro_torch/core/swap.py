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

Observability, as in the reference: the planner registers its
``SwapStats`` histograms, its ``mispredict`` counter and ``as_dict`` under
subsystem ``swap`` (last planner wins), emits a ``swap_mispredict``
instant on each miss and, while tracing, a ``swap_dispatch_job`` span a
dispatch. With no thread of its own, the span goes on a lane of its own
(``PLANNER_TRACK``), where the reference's sits on its planner thread's
track; it times the host's planning and queueing of the copies, not the
copies.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import masked_adamw as ma

# the trace lane of the dispatches: the planner has no thread of its own
PLANNER_TRACK = "swap-planner (copy stream)"


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
    hits over the boundaries that had a prediction in flight.

    Phase times live in obs histograms, as in the reference: the banked
    step times each phase once through ``obs.timed`` (host clock, µs a
    step), and trace spans ride the same measurement. ``phase_a`` includes
    the wait for the forward, backward and selection (the indices read),
    ``swap`` the boundary (resolve and commit, or the synchronous swap),
    ``phase_b`` the queueing of the update and of the next dispatch. The
    accumulated-µs fields (``phase_a_us`` etc.) are read-only views over
    the histograms' totals, and ``mispredicts`` one over the ``mispredict``
    counter."""
    steps: int = 0
    boundaries: int = 0
    predicted_hits: int = 0
    sync_swaps: int = 0
    dispatches: int = 0
    phase_a: obs.Histogram = dataclasses.field(
        default_factory=obs.Histogram, repr=False)
    swap: obs.Histogram = dataclasses.field(
        default_factory=obs.Histogram, repr=False)
    phase_b: obs.Histogram = dataclasses.field(
        default_factory=obs.Histogram, repr=False)
    mispredict: obs.Counter = dataclasses.field(
        default_factory=obs.Counter, repr=False)

    @property
    def mispredicts(self) -> int:
        return self.mispredict.value

    @property
    def phase_a_us(self) -> float:
        return self.phase_a.total

    @property
    def swap_us(self) -> float:
        return self.swap.total

    @property
    def phase_b_us(self) -> float:
        return self.phase_b.total

    @property
    def predicted_hit_rate(self) -> float:
        return (self.predicted_hits / self.boundaries if self.boundaries
                else 1.0)

    @property
    def dispatched_hit_rate(self) -> float:
        predicted = self.predicted_hits + self.mispredicts
        return self.predicted_hits / predicted if predicted else 1.0

    def as_dict(self) -> dict:
        return {"steps": self.steps, "boundaries": self.boundaries,
                "predicted_hits": self.predicted_hits,
                "sync_swaps": self.sync_swaps,
                "mispredicts": self.mispredicts,
                "dispatches": self.dispatches,
                "phase_a_us": self.phase_a_us, "swap_us": self.swap_us,
                "phase_b_us": self.phase_b_us,
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
        # last-planner-wins registry bindings: the active trainer's phase
        # histograms, boundary counts and mispredicts in obs.snapshot()
        for name, metric in (("phase_a_us", self.stats.phase_a),
                             ("swap_us", self.stats.swap),
                             ("phase_b_us", self.stats.phase_b),
                             ("mispredicts", self.stats.mispredict)):
            obs.metrics.register(name, metric, subsystem="swap")
        obs.metrics.register("banked", self.stats.as_dict, subsystem="swap")

    def dispatch(self, pred_indices: np.ndarray, banks: dict, store: dict,
                 slot_map) -> None:
        """Queue the boundary of the predicted next selection
        (``pred_indices``, host ints). Call after this step's update is
        queued. No-op when async streaming is disabled or a job is
        pending."""
        if not self.enabled or self._pending is not None:
            return
        tr = obs.tracer()
        t0 = time.perf_counter_ns()
        self._pending = self._job(np.asarray(pred_indices), banks, store,
                                  slot_map)
        self.stats.dispatches += 1
        if tr is not None:
            # its own lane, as the reference's planner thread has its track
            tr.complete("swap_dispatch_job", t0, time.perf_counter_ns(),
                        track=PLANNER_TRACK)

    def _job(self, idx, banks, store, slot_map) -> dict:
        """Plan the predicted boundary and queue its copies."""
        try:
            plans = ma.plan_swap(self.partition, slot_map,
                                 _mask(self.num_blocks, idx),
                                 ma.bank_caps(banks))
        except RuntimeError:
            # the predicted selection overflows a bank; the real one may not
            return {"idx": idx, "plans": None}
        staged, done = {}, None
        if plans:
            staged, done = self._enqueue(plans, banks, store)
        return {"idx": idx, "plans": plans, "staged": staged, "done": done}

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
        if job is not None:
            # a dispatch was in flight but missed (or overflowed)
            self.stats.mispredict.inc()
            obs.instant("swap_mispredict",
                        {"predicted": job["idx"].tolist(),
                         "actual": idx.tolist()}
                        if job["plans"] is not None
                        else {"failed_plan": True})
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
