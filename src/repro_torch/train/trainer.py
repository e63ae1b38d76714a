"""Training loop with logging (port of the JAX package's
``train/trainer.py``, single device).

Method-agnostic: the fine-tuning method is resolved through the
``repro_torch.methods`` registry, which supplies the TrainState and the step
function. The state is made on ``device`` — the card unless the caller
passes ``device="cpu"`` — and every batch goes there.

The loss is read back only at ``log_every`` boundaries, as the reference
does: between boundaries the loop only enqueues steps (losses stay device
scalars), and at a boundary one device synchronisation drains the queue,
so the step times are honest window averages. ``log_every=0`` — or a
custom ``on_straggler`` hook, which needs true per-step times so that one
slow step is never averaged away — syncs every step. (The banked
residency's step also reads its selected block ids back, once a step, by
design, and a step with gated weight gradients its mask:
``methods/selection.py``.) The straggler watchdog keeps an EWMA of the
boundary step times from the fourth step of a ``train`` call on; a step
slower than ``tcfg.straggler_tau`` times the EWMA is counted and handed to
``on_straggler(step, dt, ewma)`` (default: nothing).

Data: the synthetic math source by default, or any ``data_source=`` as
the reference takes it — a pure ``batch_at(step)`` source or a streaming
``data.pipeline.SFTPipeline`` (packed SFT batches with ``segment_ids`` and
``positions``, whose attention runs the segment-masked flash kernels).
The loop consumes ``(batch, cursor)`` pairs and commits the cursor of the
last batch it trained on with ``restore_cursor``, so the next ``train``
call continues the record stream. The log keeps each step's records and
non-pad tokens. With ``prefetch_depth > 0`` a ``data.pipeline.Prefetcher``
builds and uploads up to that many batches ahead on its own thread (on the
card through pinned memory on a copy stream of the trainer's,
``CopyStreamStager``); the loop still commits only the cursor of the last
batch it trained on, never the worker's read-ahead. Prefetch on or off
changes timing only: trajectories are bit-identical.

Observability (``repro_torch.obs``), as the reference's: always-on
counters ``steps`` and ``stragglers``, the histogram ``step_time_us`` and
the gauge ``last_loss`` under subsystem ``train``; while tracing, the
``train_step`` and ``log_sync`` spans (host clock: ``train_step`` covers
the step's enqueue unless a sync sits inside it) and the selection
telemetry, each step's mask and block norms read in one device-to-host
copy into ``obs.selection_trace()``. With obs disabled the loop adds no
host sync and no launch.

Checkpoints (``tcfg.checkpoint_dir``, ``checkpoint_every``,
``checkpoint_keep``), as the reference's: every ``checkpoint_every`` steps
the loop quiesces the swap planner and saves the whole TrainState with the
data cursor in ``meta.json`` (``checkpoint.manager``: the snapshot is
taken in stream order, the file is written on a writer thread); ``train``
waits for the last save before it returns. ``maybe_restore()`` resumes from
the latest checkpoint and re-places the state: tensors on the trainer's
device, the banked store per ``offload`` (``offload.ensure_store_residency``),
``slot_map`` as numpy and the steps and seed as ints. A save synchronises
the card once; between saves the step's host syncs are unchanged.

Not ported, and raising with its ROADMAP Queue A item: ``mesh`` (item
11). ``eval_every > 0`` raises too: the reference trainer stores it and
never reads it (it has no eval hook); its callers train, then evaluate
``train.evaluate.math_accuracy`` on ``method.eval_params(...)``, as the
port's do.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

from repro_torch import methods, obs
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import TrainConfig
from repro_torch.core import offload
from repro_torch.data import loader as data_loader
from repro_torch.data import tokenizer
from repro_torch.data.pipeline import StepIndexedAdapter
from repro_torch.data.pipeline.prefetch import CopyStreamStager, Prefetcher
from repro_torch.device import resolve_device


@dataclass
class TrainLog:
    steps: list = field(default_factory=list)
    losses: list = field(default_factory=list)
    step_times: list = field(default_factory=list)
    metrics: list = field(default_factory=list)
    records: list = field(default_factory=list)      # examples per step
    real_tokens: list = field(default_factory=list)  # non-pad tokens per step


def batch_counts(batch: dict) -> tuple[int, int]:
    """(records, non-pad tokens) of a host batch: a packed batch counts its
    segments and its positions with a nonzero segment id; an unpacked one
    holds one record a row and counts its non-PAD tokens."""
    seg = batch.get("segment_ids")
    if seg is not None:
        return int(seg.max(axis=1).sum()), int((seg != 0).sum())
    toks = batch["tokens"]
    return toks.shape[0], int((toks != tokenizer.PAD).sum())


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP Queue A "
                              f"item {item})")


class Trainer:
    def __init__(self, tcfg: TrainConfig, *, method: str | None = None,
                 data_source=None, prefetch_depth: int = 0,
                 on_straggler=None, mesh=None, device="cuda"):
        if mesh is not None:
            _not_ported("training on a mesh", "11, 'Distributed'")
        if tcfg.eval_every:
            raise NotImplementedError(
                f"eval_every={tcfg.eval_every}: the reference trainer has no "
                f"eval hook (it never reads eval_every); train, then call "
                f"repro_torch.train.evaluate.math_accuracy on "
                f"method.eval_params(...)")
        self.tcfg = tcfg
        self.device = resolve_device(device)
        self.method = methods.build(method or tcfg.method, tcfg)
        # a method without selection (lora) reports the config's
        self.sel_cfg = getattr(self.method, "sel_cfg", tcfg.select)
        self.state = self.method.init_state(tcfg.model, tcfg.optimizer,
                                            tcfg.seed, device=self.device)
        self.step_fn = self.method.make_step(tcfg.model, tcfg.optimizer)
        self.data = data_source or data_loader.make_source(
            "synthetic_math", seq_len=tcfg.seq_len,
            global_batch=tcfg.global_batch, seed=tcfg.seed)
        self.prefetch_depth = prefetch_depth
        self._stager = None   # the copy stream's stager, made on first use
        self._cursor = None   # the cursor after the last batch trained on
        self.ckpt = (CheckpointManager(tcfg.checkpoint_dir,
                                       tcfg.checkpoint_keep)
                     if tcfg.checkpoint_dir else None)
        self.log = TrainLog()
        self._watchdog_active = on_straggler is not None
        self.on_straggler = on_straggler or (lambda step, dt, ewma: None)
        self._ewma = None
        # always-on registry instruments (host-side, sub-µs; the tracing
        # and selection-telemetry reads are gated on obs.enabled())
        self._m_steps = obs.metrics.counter("steps", subsystem="train")
        self._m_step_time = obs.metrics.histogram("step_time_us",
                                                  subsystem="train")
        self._m_stragglers = obs.metrics.counter("stragglers",
                                                 subsystem="train")
        self._m_loss = obs.metrics.gauge("last_loss", subsystem="train")

    # ------------------------------------------------------------- resume
    def maybe_restore(self) -> int:
        """Resume from the latest checkpoint, if there is one; returns its
        step (0 when there is none). Streaming sources resume their record
        stream from the cursor saved beside the state."""
        if self.ckpt is None or self.ckpt.latest_step() is None:
            return 0
        self._quiesce()
        host, step = self.ckpt.restore(self.state)
        self.state = None   # free the initial state before placing
        self.state = self._place(host)
        cursor = self.ckpt.load_meta(step).get("data_cursor")
        if cursor is not None and hasattr(self.data, "restore_cursor"):
            self.data.restore_cursor(cursor)
        return step

    def _place(self, host: dict) -> dict:
        """A restored host state on its sides: every tensor on the
        trainer's device but the banked store, which goes where
        ``offload`` keeps it; numpy arrays and ints as they are."""
        def to_dev(x, path=""):
            if path == "opt/store":
                return offload.ensure_store_residency(
                    x, self.tcfg.optimizer.offload, self.device)
            if isinstance(x, dict):
                return {k: to_dev(v, f"{path}/{k}" if path else k)
                        for k, v in x.items()}
            return x.to(self.device) if isinstance(x, torch.Tensor) else x
        return to_dev(host)

    def _quiesce(self) -> None:
        """Order the card after any dispatched banked boundary (which
        writes the host store and holds bank rows) before the state is
        read or replaced."""
        planner = getattr(self.step_fn, "swap_planner", None)
        if planner is not None:
            planner.quiesce()

    def _device_batch(self, batch: dict) -> dict:
        """The batch on the state's device. On the card each array is staged
        in pinned memory and copied with ``non_blocking=True``, so the host
        does not wait for the queued steps: a copy from pageable memory
        would synchronise. PyTorch's pinned host allocator records an event
        after the copy and keeps the staging block until that event has
        completed. On the CPU the arrays are used as they are."""
        if self.device.type == "cpu":
            return {k: torch.from_numpy(v) for k, v in batch.items()}
        return {k: torch.from_numpy(v).pin_memory().to(self.device,
                                                       non_blocking=True)
                for k, v in batch.items()}

    def _placement(self):
        """(place, claim) of this ``train`` call's batches: ``place`` runs
        where the batch is made (the prefetch worker, or the loop) and
        returns its counts with the placed batch; ``claim`` runs in the loop
        and returns the device batch. With prefetch on the card the upload
        goes on the trainer's copy stream (``CopyStreamStager``); else it is
        ``_device_batch`` on the current stream."""
        if self.device.type == "cuda" and self.prefetch_depth:
            if self._stager is None:
                self._stager = CopyStreamStager(self.device)
            upload, claim = self._stager.place, self._stager.claim
        else:
            upload, claim = self._device_batch, (lambda b: b)

        def place(host):
            return batch_counts(host), upload(host)
        return place, claim

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _batch_stream(self, step0: int, steps: int):
        """(host_batch, cursor_after) pairs for the next ``steps`` steps:
        streaming pipelines (anything with ``batches``) iterate from their
        committed cursor, pure ``batch_at`` sources through the
        ``StepIndexedAdapter``."""
        if hasattr(self.data, "batches"):
            return self.data.batches(steps)
        return StepIndexedAdapter(self.data, step0).batches(steps)

    def train(self, steps: int | None = None) -> TrainLog:
        """Run ``steps`` steps (default ``tcfg.steps``) from the state's
        step; returns the log, which accumulates across calls."""
        steps = steps if steps is not None else self.tcfg.steps
        step0 = self.state["step"]
        place, claim = self._placement()
        fetch = Prefetcher(self._batch_stream(step0, steps), place,
                           depth=self.prefetch_depth)
        self._cursor = None   # the cursor after the last batch trained on
        try:
            self._train_loop(fetch, claim, step0, steps)
        finally:
            fetch.close()
            # banked residency: order the card after any dispatched boundary
            # before the caller reads the state
            self._quiesce()
            # commit consumption: the stream resumes after the last batch
            # the loop trained on, not after the worker's read-ahead
            if (self._cursor is not None
                    and hasattr(self.data, "restore_cursor")):
                self.data.restore_cursor(self._cursor)
        if self.ckpt is not None:
            self.ckpt.wait()
        return self.log

    def _train_loop(self, fetch, claim, step0: int, steps: int) -> None:
        tcfg = self.tcfg
        last = step0 + steps - 1
        pending = []  # (step, device-scalar loss) since the last boundary
        t0 = time.perf_counter()
        sel_trace = obs.selection_trace()
        for step in range(step0, step0 + steps):
            ((records, real), placed), self._cursor = next(fetch)
            self.log.records.append(records)
            self.log.real_tokens.append(real)
            batch = claim(placed)
            if not pending:
                t0 = time.perf_counter()
            with obs.span("train_step", {"step": step} if obs.enabled()
                          else None):
                self.state, metrics = self.step_fn(self.state, batch)
            pending.append((step, metrics["loss"]))

            # selection telemetry (obs enabled only: reading the mask off
            # the card is a host sync the disabled contract forbids); the
            # mask is the one this step's update applied, so the recorded
            # counts equal state["opt"]["counts"]. One copy a step.
            if sel_trace is not None and metrics.get("mask") is not None:
                mask = metrics["mask"]
                host = torch.cat([mask.float(),
                                  metrics["block_norms"].float()]).cpu()
                nb = mask.shape[0]
                sel_trace.record(step, host[:nb].numpy(),
                                 host[nb:].numpy())

            at_log = tcfg.log_every and step % tcfg.log_every == 0
            if (at_log or step == last or not tcfg.log_every
                    or self._watchdog_active):
                with obs.span("log_sync"):
                    self._sync()
                dt = (time.perf_counter() - t0) / len(pending)
                self.log.steps.extend(s for s, _ in pending)
                self.log.losses.extend(float(x) for _, x in pending)
                self.log.step_times.extend([dt] * len(pending))
                self._m_steps.inc(len(pending))
                self._m_step_time.record(dt * 1e6)
                self._m_loss.set(self.log.losses[-1])
                pending = []
                self._watch(step, step0, dt)
            if at_log:
                small = {k: (v.item() if isinstance(v, torch.Tensor)
                             else v)
                         for k, v in metrics.items()
                         if not isinstance(v, torch.Tensor)
                         or v.ndim == 0}
                self.log.metrics.append({"step": step, **small})
            if (self.ckpt is not None and tcfg.checkpoint_every
                    and (step + 1) % tcfg.checkpoint_every == 0):
                # the cursor rides in meta.json: a restore resumes the
                # record stream right after this step's batch
                self._quiesce()
                self.ckpt.save(step + 1, self.state,
                               extra_meta={"data_cursor": self._cursor})

    def _watch(self, step: int, step0: int, dt: float) -> None:
        """The straggler watchdog: an EWMA of the boundary step times from
        the fourth step of the call on (the first ones warm up)."""
        if step <= step0 + 2:
            return
        self._ewma = dt if self._ewma is None else \
            0.9 * self._ewma + 0.1 * dt
        if self._ewma and dt > self.tcfg.straggler_tau * self._ewma:
            self._m_stragglers.inc()
            obs.instant("straggler", {"step": step, "dt_s": dt,
                                      "ewma_s": self._ewma})
            self.on_straggler(step, dt, self._ewma)
