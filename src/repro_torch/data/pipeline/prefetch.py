"""Async batch prefetch: overlap host batch construction, and the copy to
the card, with device compute (port of the JAX package's
``data/pipeline/prefetch.py``).

``Prefetcher`` drains a ``(host_batch, cursor_after)`` iterator on a
background thread named ``data-prefetch``, runs ``place`` on each batch,
and keeps up to ``depth`` placed batches in a bounded queue (while
tracing, each build is a ``prefetch_batch`` span on that thread's track). The train
loop's ``next()`` then returns a batch that is already placed while the
thread builds the next ones: host batch construction leaves the critical
path.

Determinism contract: the prefetcher only *reorders work in time*, never
the stream — batches come off the queue in exactly the order the iterator
produced them, and the iterator itself is a pure function of its starting
cursor (``packing.pack_batch``). Trajectories with prefetch on and off are
therefore bit-identical (pinned in tests/test_torch_prefetch.py and, on
the card, ``chip_smoke.py`` phase 31).

Error/shutdown semantics: exceptions in the worker are re-raised at the
consumer's next ``next()``; ``close()`` (or context-manager exit) unblocks
and joins the thread, so a crashed train loop never leaks a producer.

On the card the placing is ``CopyStreamStager``'s: the worker stages each
array in pinned memory and copies it with ``non_blocking=True`` on a copy
stream of its own, then records an event; the consumer's ``claim`` makes
its current stream wait on that event and marks each tensor used there
(``record_stream``). Three hazards are closed so:

* a copy made on the default stream would queue behind the steps the
  loop has already enqueued (a new thread's current stream is the default
  stream, hence ``torch.cuda.stream(copy_stream)`` inside the worker);
* the caching allocator would hand a batch's device memory to the copy
  stream's next batch while the compute stream still reads it, without
  ``record_stream`` on the compute stream;
* a pinned staging block must outlive its copy: PyTorch's pinned host
  allocator records an event on the copy's stream and hands the block out
  again only after that event, and a copy from pageable memory would
  synchronise the host instead.
"""
from __future__ import annotations

import queue
import threading

import torch

from repro_torch import obs

_DONE = object()


class Prefetcher:
    """Iterator over ``stream`` with ``depth`` batches built+placed ahead.

    ``depth == 0`` degrades to fully synchronous iteration (no thread) — the
    on/off switch is this one constructor argument, nothing else changes.
    """

    def __init__(self, stream, place=None, depth: int = 2):
        self._stream = iter(stream)
        self._place = place or (lambda x: x)
        self.depth = depth
        self._err: BaseException | None = None
        self._thread = None
        # prefetch-depth occupancy: how many placed batches were waiting
        # when the consumer arrived (depth sustained = producer keeps up)
        self._g_occupancy = obs.metrics.gauge("prefetch_occupancy",
                                              subsystem="data")
        self._c_batches = obs.metrics.counter("prefetch_batches",
                                              subsystem="data")
        if depth > 0:
            self._q: queue.Queue = queue.Queue(maxsize=depth)
            self._stop = threading.Event()
            self._thread = threading.Thread(target=self._work, daemon=True,
                                            name="data-prefetch")
            self._thread.start()

    # ------------------------------------------------------------ worker
    def _build(self):
        """The next (placed batch, cursor); raises StopIteration at the
        end. While tracing, a ``prefetch_batch`` span on the building
        thread's track (the worker's is named ``data-prefetch``)."""
        with obs.span("prefetch_batch"):
            batch, cursor = next(self._stream)
            return self._place(batch), cursor

    def _work(self):
        try:
            while True:
                try:
                    placed, cursor = self._build()
                except StopIteration:
                    break
                while not self._stop.is_set():
                    try:
                        self._q.put((placed, cursor), timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return
        except BaseException as e:  # noqa: BLE001 — surfaced to consumer
            self._err = e
        finally:
            while not self._stop.is_set():
                try:
                    self._q.put(_DONE, timeout=0.1)
                    break
                except queue.Full:
                    continue

    # ---------------------------------------------------------- consumer
    def __iter__(self):
        return self

    def __next__(self):
        if self._thread is None:  # synchronous mode
            item = self._build()
            self._c_batches.inc()
            return item
        self._g_occupancy.set(self._q.qsize())
        item = self._q.get()
        if item is _DONE:
            if self._err is not None:
                err, self._err = self._err, None
                raise err
            raise StopIteration
        self._c_batches.inc()
        return item

    def close(self):
        if self._thread is not None:
            self._stop.set()
            # drain so a blocked put() observes the stop event promptly
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join()
            self._thread = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class CopyStreamStager:
    """Places host batches on a CUDA device from a prefetch worker, on a
    dedicated copy stream (see the module docstring). ``place`` runs on the
    worker and returns ``(tensors, ready event)``; ``claim`` runs on the
    consumer's thread and returns the tensors, ordered after their copies
    on its current stream."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)

    def place(self, batch: dict) -> tuple[dict, torch.cuda.Event]:
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            out = {k: torch.from_numpy(v).pin_memory().to(self.device,
                                                           non_blocking=True)
                   for k, v in batch.items()}
            ready = torch.cuda.Event()
            ready.record(self.stream)
        return out, ready

    def claim(self, placed: tuple[dict, torch.cuda.Event]) -> dict:
        out, ready = placed
        current = torch.cuda.current_stream(self.device)
        current.wait_event(ready)
        for t in out.values():
            t.record_stream(current)
        return out
