"""Background detokenize/stream-out queue for the serve engine (port of the
JAX package's ``serve/streamout.py``, with its obs counter
``streamed_completions`` under subsystem ``serve`` and its
``streamout_callback`` span on the worker's track).

Finished sequences are handed off to a daemon worker thread so
``ServeEngine.step()`` never blocks on host-side decode: the engine's hot
loop only enqueues ``Completion`` records and moves on to the next decode
chunk, while the worker runs the user callback — detokenization, HTTP
writes, logging — off the critical path.

Error contract: a callback exception does not kill the engine loop; the
first one is captured and re-raised from ``drain()`` (which ``run()`` calls
before returning), so failures surface at the end of the batch instead of
being swallowed. ``drain`` blocks until every enqueued completion has been
processed — results are complete when it returns.
"""
from __future__ import annotations

import queue
import threading

import numpy as np

from repro_torch import obs

_STOP = object()


class StreamOut:
    """Single worker thread draining a completion queue (see module doc).

    ``callback(completion)`` runs on the worker thread with the finished
    request's ``Completion`` record (uid, tokens, finish reason, timing,
    prefix-reuse count — see serve/results.py).
    """

    def __init__(self, callback=None):
        self._callback = callback
        self._q: queue.Queue = queue.Queue()
        self._results: dict[int, np.ndarray] = {}
        self._error: BaseException | None = None
        # incremented from the worker thread — thread-safe by contract
        self._c_streamed = obs.metrics.counter("streamed_completions",
                                               subsystem="serve")
        self._thread = threading.Thread(
            target=self._worker, name="serve-streamout", daemon=True)
        self._thread.start()

    @property
    def pending(self) -> int:
        return self._q.unfinished_tasks

    def put(self, completion) -> None:
        """Enqueue a finished request's ``Completion`` (non-blocking;
        called from step())."""
        self._q.put(completion)

    def _worker(self) -> None:
        while True:
            item = self._q.get()
            try:
                if item is _STOP:
                    return
                with obs.span("streamout_callback"):
                    self._results[item.uid] = item.tokens
                    if self._callback is not None:
                        self._callback(item)
                self._c_streamed.inc()
            except BaseException as e:  # noqa: BLE001 — surfaced via drain()
                if self._error is None:
                    self._error = e
            finally:
                self._q.task_done()

    def drain(self) -> dict[int, np.ndarray]:
        """Block until the queue is empty; re-raise the first callback
        error; return {uid: tokens} for everything streamed so far."""
        self._q.join()
        if self._error is not None:
            err, self._error = self._error, None
            raise err
        return dict(self._results)

    def close(self) -> None:
        """Drain, then stop the worker thread."""
        self._q.join()
        self._q.put(_STOP)
        self._thread.join()
