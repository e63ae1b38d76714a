"""Unified telemetry: process-global metrics registry + gated span tracing
(port of the JAX package's ``obs/__init__.py``).

Two layers with different cost contracts:

* **Metrics registry** (``obs.metrics``) — ALWAYS ON. Counters, gauges, and
  bounded histograms are host-side Python with sub-microsecond record cost
  (the same order as the ad-hoc stat dicts they replaced). Subsystems
  register instruments under a subsystem label and everything exports as
  one JSON document via ``obs.snapshot()``.

* **Span tracing + selection telemetry** — OFF by default. ``obs.span``
  returns a shared no-op context manager until ``obs.enable()`` installs a
  ``Tracer``; instrumentation sites that would force a host sync (reading
  the selection mask and block norms off the card) guard on
  ``obs.enabled()``. Disabled mode therefore adds **no host sync and no
  launch** — step trajectories are bit-identical with obs on or off, and
  the launch counts and host syncs a step are those of a run without obs
  (pinned in tests/test_torch_obs.py and, on the card,
  tests/test_torch_cuda.py and ``chip_smoke.py`` phase 31).

Spans and ``timed`` read the host's clock: around a CUDA step they cover
its enqueue, not its device time (see ``obs/trace.py``).
``enable(torch_profiler=True)`` also opens a
``torch.profiler.record_function`` range per span, so a
``torch.profiler`` capture shows the device kernels under the spans.

Typical wiring (see train/trainer.py, core/swap.py, serve/engine.py):

    hist = obs.metrics.histogram("step_time_us", subsystem="train")
    with obs.timed(hist, "phase_a"):      # histogram always, span if on
        ...
    with obs.span("decode_chunk"):         # no-op when disabled
        ...
    obs.metrics.register("stats", engine_stats_callable, subsystem="serve")

Launchers expose ``--trace PATH`` (Chrome trace-event JSON, loadable in
Perfetto / chrome://tracing) and ``--metrics-json PATH``
(``obs.snapshot()``, rendered by ``launch/inspect.py``).
"""
from __future__ import annotations

import time

from repro_torch.obs.registry import (Counter, Gauge,  # noqa: F401
                                      Histogram, MetricsRegistry)
from repro_torch.obs.selection import SelectionTrace  # noqa: F401
from repro_torch.obs.trace import (NOOP_SPAN, Tracer,  # noqa: F401
                                   validate_trace, validate_trace_file)

# the process-global registry: always on, cheap, snapshot-exportable
metrics = MetricsRegistry()

_tracer: Tracer | None = None
_selection: SelectionTrace | None = None


def enabled() -> bool:
    """True when span tracing (and selection telemetry) is active."""
    return _tracer is not None


def enable(*, torch_profiler: bool = False, selection: bool = True,
           max_events: int = 1_000_000) -> Tracer:
    """Install a fresh ``Tracer`` (and, by default, a fresh
    ``SelectionTrace``). Idempotent in spirit: calling again replaces the
    active tracer so each run exports a self-contained trace.
    ``torch_profiler=True`` frames each span in a
    ``torch.profiler.record_function`` range."""
    global _tracer, _selection
    _tracer = Tracer(torch_profiler=torch_profiler, max_events=max_events)
    _selection = SelectionTrace() if selection else None
    return _tracer


def disable() -> None:
    global _tracer, _selection
    _tracer = None
    _selection = None


def tracer() -> Tracer | None:
    return _tracer


def selection_trace() -> SelectionTrace | None:
    return _selection


def span(name: str, args: dict | None = None):
    """Duration span context manager; the disabled path returns a shared
    no-op singleton (one global read + one ``is None`` check)."""
    tr = _tracer
    return NOOP_SPAN if tr is None else tr.span(name, args)


def instant(name: str, args: dict | None = None) -> None:
    tr = _tracer
    if tr is not None:
        tr.instant(name, args)


class _Timed:
    """Times its body with ``perf_counter`` and records the elapsed
    microseconds into ``hist`` — always; additionally emits a trace span
    when tracing is on. The one timing source of truth for phase timings
    (SwapStats et al. are views over these histograms)."""

    __slots__ = ("_hist", "_name", "_args", "_span", "_t0")

    def __init__(self, hist: Histogram, name: str, args: dict | None = None):
        self._hist = hist
        self._name = name
        self._args = args
        self._span = None

    def __enter__(self):
        tr = _tracer
        if tr is not None:
            self._span = tr.span(self._name, self._args)
            self._span.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt_us = (time.perf_counter() - self._t0) * 1e6
        self._hist.record(dt_us)
        if self._span is not None:
            self._span.__exit__(*exc)
            self._span = None
        return False


def timed(hist: Histogram, name: str, args: dict | None = None) -> _Timed:
    return _Timed(hist, name, args)


def snapshot() -> dict:
    """One JSON-able document: every registered metric by subsystem, plus
    the selection telemetry under ``"selection"`` when enabled."""
    doc = metrics.snapshot()
    if _selection is not None and len(_selection):
        doc["selection"] = _selection.snapshot()
    return doc


def export_trace(path: str) -> None:
    if _tracer is None:
        raise RuntimeError("obs.export_trace: tracing is not enabled "
                           "(call obs.enable() before the run)")
    _tracer.export(path)
