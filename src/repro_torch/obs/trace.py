"""Span tracing with Chrome trace-event JSON export, Perfetto-loadable (a
port of the JAX package's ``obs/trace.py``).

``Tracer`` records duration spans (``B``/``E`` pairs), instant events
(``i``), and retroactive complete events (``X`` with explicit begin/end
timestamps — used for per-request latency spans whose endpoints were
stamped before the span could be emitted). Events are thread-aware: each OS
thread gets its own ``tid`` plus a ``thread_name`` metadata event, so the
swap planner's background dispatch shows up as its own track; logical
tracks (one lane per in-flight serve request, the swap planner's copy-stream
dispatches) are synthetic tids allocated by label via ``track=``.

Timestamps are ``time.perf_counter_ns()`` relative to tracer start,
exported in microseconds (the trace-event unit). Export writes
``{"traceEvents": [...]}``, the JSON object form both Perfetto and
``chrome://tracing`` load directly. The event buffer is bounded
(``max_events``); overflow drops new events and counts them, so a runaway
trace can't exhaust host memory.

Spans measure the HOST's clock. A CUDA step enqueues its kernels and
returns, so a span around it (``train_step``) covers how long the step
took to enqueue, unless a host sync sits inside it (the banked step's
indices read, a log boundary's ``log_sync``). The device's view comes
through the optional ``torch.profiler`` bridge: with ``torch_profiler=True``
every span also enters ``torch.profiler.record_function(name)``, so inside
a ``torch.profiler.profile(...)`` capture the spans frame the device
kernels launched from their thread. (Autograd runs a CUDA backward on a
thread of its own, so its kernels fall outside the caller's range.) The
bridge swallows no exception.

``validate_trace`` is the structural checker the tests and CI use in place
of opening the file by hand: per-tid matched/properly-nested B/E pairs with
non-decreasing timestamps, non-negative X durations, known phase types.
"""
from __future__ import annotations

import json
import threading
import time


class _Span:
    """Context manager emitting one B/E pair (and optionally framing a
    ``torch.profiler.record_function`` range)."""

    __slots__ = ("_tracer", "_name", "_args", "_ann")

    def __init__(self, tracer, name, args=None):
        self._tracer = tracer
        self._name = name
        self._args = args
        self._ann = None

    def __enter__(self):
        tr = self._tracer
        if tr._torch_bridge:
            import torch
            self._ann = torch.profiler.record_function(self._name)
            self._ann.__enter__()
        tr._emit("B", self._name, args=self._args)
        return self

    def __exit__(self, *exc):
        self._tracer._emit("E", self._name)
        if self._ann is not None:
            self._ann.__exit__(*exc)
        return False


class _NoopSpan:
    """Shared do-nothing span: the disabled-mode fast path returns this
    singleton, so ``with obs.span(...)`` costs one attribute check."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP_SPAN = _NoopSpan()


class Tracer:
    def __init__(self, *, torch_profiler: bool = False,
                 max_events: int = 1_000_000):
        self._t0_ns = time.perf_counter_ns()
        self._events: list[dict] = []
        self._lock = threading.Lock()
        self._max_events = int(max_events)
        self.dropped = 0
        self._named_threads: set[int] = set()
        self._tracks: dict[str, int] = {}  # label -> synthetic tid
        self._torch_bridge = bool(torch_profiler)

    # ------------------------------------------------------------ plumbing
    def _us(self, t_ns: int | None = None) -> float:
        t_ns = time.perf_counter_ns() if t_ns is None else t_ns
        return (t_ns - self._t0_ns) / 1e3

    def _append(self, ev: dict) -> None:
        with self._lock:
            if len(self._events) >= self._max_events:
                self.dropped += 1
                return
            self._events.append(ev)

    def _thread_tid(self) -> int:
        tid = threading.get_ident()
        if tid not in self._named_threads:
            self._named_threads.add(tid)
            self._append({"ph": "M", "name": "thread_name", "pid": 0,
                          "tid": tid,
                          "args": {"name": threading.current_thread().name}})
        return tid

    def track_tid(self, label: str) -> int:
        """Synthetic tid for a logical track (e.g. one lane per serve
        request), named ``label`` in the viewer."""
        with self._lock:
            tid = self._tracks.get(label)
            if tid is not None:
                return tid
            tid = 1_000_000_000 + len(self._tracks)
            self._tracks[label] = tid
        self._append({"ph": "M", "name": "thread_name", "pid": 0, "tid": tid,
                      "args": {"name": label}})
        return tid

    def _emit(self, ph: str, name: str, *, args=None) -> None:
        ev = {"ph": ph, "name": name, "pid": 0, "tid": self._thread_tid(),
              "ts": self._us()}
        if args:
            ev["args"] = args
        self._append(ev)

    # ------------------------------------------------------------- surface
    def span(self, name: str, args: dict | None = None) -> _Span:
        return _Span(self, name, args)

    def instant(self, name: str, args: dict | None = None) -> None:
        ev = {"ph": "i", "name": name, "pid": 0, "tid": self._thread_tid(),
              "ts": self._us(), "s": "t"}
        if args:
            ev["args"] = args
        self._append(ev)

    def complete(self, name: str, t0_ns: int, t1_ns: int, *,
                 track: str | None = None, args: dict | None = None) -> None:
        """Retroactive span from raw ``perf_counter_ns`` endpoints (an ``X``
        event). Endpoints stamped before the tracer started are dropped —
        they have no meaningful position on this trace's timeline."""
        if t0_ns < self._t0_ns or t1_ns < t0_ns:
            return
        tid = (self.track_tid(track) if track is not None
               else self._thread_tid())
        ev = {"ph": "X", "name": name, "pid": 0, "tid": tid,
              "ts": self._us(t0_ns), "dur": (t1_ns - t0_ns) / 1e3}
        if args:
            ev["args"] = args
        self._append(ev)

    # -------------------------------------------------------------- export
    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def export(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"traceEvents": self.events(),
                       "displayTimeUnit": "ms"}, f)


def validate_trace(events: list[dict]) -> None:
    """Structural well-formedness of a trace-event list; raises
    ``AssertionError`` with context on the first violation.

    Checks: every event has ph/name/pid/tid (+ts for non-metadata); B/E
    pairs match by name and nest properly per tid; timestamps are
    non-decreasing per tid in emission order for B/E/i (X events are
    retroactive, so only their ``dur >= 0`` is checked); no unterminated
    spans."""
    stacks: dict[int, list] = {}
    last_ts: dict[int, float] = {}
    for i, ev in enumerate(events):
        assert isinstance(ev, dict), f"event {i} is not an object"
        for k in ("ph", "name", "pid", "tid"):
            assert k in ev, f"event {i} missing {k!r}: {ev}"
        ph, tid = ev["ph"], ev["tid"]
        assert ph in ("B", "E", "i", "I", "X", "M"), \
            f"event {i}: unknown phase {ph!r}"
        if ph == "M":
            continue
        ts = ev.get("ts")
        assert isinstance(ts, (int, float)) and ts >= 0, \
            f"event {i} ({ev['name']}): bad ts {ts!r}"
        if ph == "X":
            assert ev.get("dur", -1) >= 0, \
                f"event {i} ({ev['name']}): X needs dur >= 0"
            continue
        prev = last_ts.get(tid)
        assert prev is None or ts >= prev, \
            f"event {i} ({ev['name']}): ts {ts} < {prev} on tid {tid}"
        last_ts[tid] = ts
        if ph == "B":
            stacks.setdefault(tid, []).append(ev["name"])
        elif ph == "E":
            stack = stacks.get(tid) or []
            assert stack, f"event {i}: E {ev['name']!r} with empty stack"
            top = stack.pop()
            assert top == ev["name"], \
                f"event {i}: E {ev['name']!r} closes B {top!r} (tid {tid})"
    open_spans = {t: s for t, s in stacks.items() if s}
    assert not open_spans, f"unterminated spans: {open_spans}"


def validate_trace_file(path: str) -> list[dict]:
    """Load + validate an exported trace file; returns its event list."""
    with open(path) as f:
        doc = json.load(f)
    assert isinstance(doc, dict) and isinstance(doc.get("traceEvents"), list)
    validate_trace(doc["traceEvents"])
    return doc["traceEvents"]
