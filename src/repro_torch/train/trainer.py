"""Training loop with logging (port of the JAX package's
``train/trainer.py``, single device).

Method-agnostic: the fine-tuning method is resolved through the
``repro_torch.methods`` registry, which supplies the TrainState and the step
function. The state is made on ``device`` — the card unless the caller
passes ``device="cpu"`` — and every batch goes there.

The loss is read back only at ``log_every`` boundaries, as the reference
does: between boundaries the loop only enqueues steps (losses stay device
scalars), and at a boundary one device synchronisation drains the queue,
so the step times are honest window averages. ``log_every=0`` syncs every
step. (The banked residency's step also reads its selected block ids back,
once a step, by design: ``methods/selection.py``.)

Data: the synthetic math source by default, or any ``data_source=`` as
the reference takes it — a pure ``batch_at(step)`` source or a streaming
``data.pipeline.SFTPipeline`` (packed SFT batches with ``segment_ids`` and
``positions``, whose attention runs the segment-masked flash kernels).
The loop consumes ``(batch, cursor)`` pairs and commits the cursor of the
last batch it trained on with ``restore_cursor``, so the next ``train``
call continues the record stream. The log keeps each step's records and
non-pad tokens.

Not ported, and raising with their ROADMAP Queue A item: checkpoints (item
3), eval (item 5), ``prefetch_depth > 0`` (item 8), ``mesh`` (item 11).
The obs instruments and trace spans of the reference wait for item 10;
its straggler watchdog, which no caller of the port uses yet, is left out.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

from repro_torch import methods
from repro_torch.configs.base import TrainConfig
from repro_torch.data import loader as data_loader
from repro_torch.data import tokenizer
from repro_torch.data.pipeline import StepIndexedAdapter
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
                 data_source=None, prefetch_depth: int = 0, mesh=None,
                 device="cuda"):
        if mesh is not None:
            _not_ported("training on a mesh", "11, 'Distributed'")
        if prefetch_depth:
            _not_ported("prefetch_depth > 0 (the Prefetcher)",
                        "8, 'Packed SFT pipeline'")
        if tcfg.checkpoint_dir or tcfg.checkpoint_every:
            _not_ported("checkpointing", "3, 'Method registry, trainer and "
                        "launcher' (its checkpoint part)")
        if tcfg.eval_every:
            _not_ported("eval during training", "5, 'Greedy eval'")
        self.tcfg = tcfg
        self.device = resolve_device(device)
        self.method = methods.build(method or tcfg.method, tcfg)
        self.sel_cfg = self.method.sel_cfg
        self.state = self.method.init_state(tcfg.model, tcfg.optimizer,
                                            tcfg.seed, device=self.device)
        self.step_fn = self.method.make_step(tcfg.model, tcfg.optimizer)
        self.data = data_source or data_loader.make_source(
            "synthetic_math", seq_len=tcfg.seq_len,
            global_batch=tcfg.global_batch, seed=tcfg.seed)
        self.log = TrainLog()

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
        tcfg = self.tcfg
        steps = steps if steps is not None else tcfg.steps
        step0 = self.state["step"]
        last = step0 + steps - 1
        pending = []  # (step, device-scalar loss) since the last boundary
        t0 = time.perf_counter()
        stream = self._batch_stream(step0, steps)
        cursor = None   # the cursor after the last batch trained on
        try:
            for step in range(step0, step0 + steps):
                host, cursor = next(stream)
                records, real = batch_counts(host)
                self.log.records.append(records)
                self.log.real_tokens.append(real)
                batch = self._device_batch(host)
                if not pending:
                    t0 = time.perf_counter()
                self.state, metrics = self.step_fn(self.state, batch)
                pending.append((step, metrics["loss"]))

                at_log = tcfg.log_every and step % tcfg.log_every == 0
                if at_log or step == last or not tcfg.log_every:
                    self._sync()
                    dt = (time.perf_counter() - t0) / len(pending)
                    self.log.steps.extend(s for s, _ in pending)
                    self.log.losses.extend(float(x) for _, x in pending)
                    self.log.step_times.extend([dt] * len(pending))
                    pending = []
                if at_log:
                    small = {k: (v.item() if isinstance(v, torch.Tensor)
                                 else v)
                             for k, v in metrics.items()
                             if not isinstance(v, torch.Tensor)
                             or v.ndim == 0}
                    self.log.metrics.append({"step": step, **small})
        finally:
            # banked residency: order the card after any dispatched boundary
            # before the caller reads the state
            planner = getattr(self.step_fn, "swap_planner", None)
            if planner is not None:
                planner.quiesce()
            # commit consumption: the stream resumes after the last batch
            # the loop trained on
            if cursor is not None and hasattr(self.data, "restore_cursor"):
                self.data.restore_cursor(cursor)
        return self.log
