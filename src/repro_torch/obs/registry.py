"""Process-global metrics registry: counters, gauges, bounded histograms (a
copy of the JAX package's ``obs/registry.py``).

The registry is ALWAYS ON — its instruments are plain host-side Python
(lock-guarded ints, floats, and a fixed-size bucket array), so recording
into them costs what an ad-hoc stat dict costs (an attribute access and an
add under a lock, sub-microsecond). Nothing here ever touches a device
value: anything that would force a host sync (reading a CUDA tensor,
``torch.cuda.synchronize``) belongs behind ``obs.enabled()`` at the call
site, never inside an instrument. That split is the disabled-mode
guarantee: tracing off means zero *added* host syncs and no added launch.

Instruments are keyed ``(subsystem, name)``. Get-or-create accessors
(``registry.counter/gauge/histogram``) return the shared instrument;
``register`` binds an externally-owned instrument (or a zero-arg callable
polled at snapshot time) under a key, last-writer-wins — the idiom for
per-instance stats like a trainer's ``SwapStats`` histograms, where "the
current trainer owns the name" is the useful semantic. ``snapshot()``
renders everything as one nested JSON-able dict
``{subsystem: {name: value}}``.

``Histogram`` is log-bucketed and bounded: geometric bucket boundaries with
growth ``2**(1/8)`` per bucket, so any recorded value lands within ~4.4%
relative error of its bucket's geometric-midpoint representative, and the
bucket array is a fixed-size list regardless of how many values stream in.
Quantiles are nearest-rank (``floor(q * (n - 1))``, numpy's ``lower``
method) over the bucket counts.
"""
from __future__ import annotations

import math
import threading


class Counter:
    """Monotonic counter; ``inc`` is thread-safe (the prefetch and
    stream-out threads record into the same instrument as the main loop)."""

    __slots__ = ("_value", "_lock")

    def __init__(self):
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        return self._value

    def snapshot(self):
        return self._value


class Gauge:
    """Last-write-wins scalar (queue depth, pool occupancy)."""

    __slots__ = ("_value",)

    def __init__(self):
        self._value = 0.0

    def set(self, v: float) -> None:
        self._value = float(v)

    @property
    def value(self) -> float:
        return self._value

    def snapshot(self):
        return self._value


# 8 buckets per octave: bucket width 2**(1/8) ~ 1.0905x, representative at
# the geometric midpoint -> worst-case relative error 2**(1/16)-1 ~ 4.4%
_BPO = 8
# bucket index range: 2**-16 .. 2**48 covers sub-ns .. ~3 days in us
_IDX_LO = -16 * _BPO
_IDX_HI = 48 * _BPO
_NBUCKETS = _IDX_HI - _IDX_LO + 1


class Histogram:
    """Bounded log-bucketed histogram with nearest-rank quantiles.

    Fixed memory: one int per bucket (``num_buckets`` total) plus running
    count/total/min/max — independent of how many values are recorded.
    Non-positive values land in a dedicated zero bucket whose
    representative is 0.0. ``record`` is thread-safe.
    """

    __slots__ = ("_counts", "_zero", "count", "total", "min", "max", "_lock")

    num_buckets = _NBUCKETS

    def __init__(self):
        self._counts = [0] * _NBUCKETS
        self._zero = 0  # values <= 0
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._lock = threading.Lock()

    @staticmethod
    def _index(v: float) -> int:
        i = math.floor(math.log2(v) * _BPO)
        return min(max(int(i), _IDX_LO), _IDX_HI) - _IDX_LO

    @staticmethod
    def _representative(bucket: int) -> float:
        return 2.0 ** ((bucket + _IDX_LO + 0.5) / _BPO)

    def record(self, v: float) -> None:
        v = float(v)
        with self._lock:
            if v > 0.0:
                self._counts[self._index(v)] += 1
            else:
                self._zero += 1
            self.count += 1
            self.total += v
            self.min = v if v < self.min else self.min
            self.max = v if v > self.max else self.max

    def quantile(self, q: float) -> float:
        """Nearest-rank quantile (rank ``floor(q * (count - 1))``): the
        bucket representative is within ~4.4% of the true order statistic."""
        with self._lock:
            if not self.count:
                return 0.0
            rank = math.floor(min(max(q, 0.0), 1.0) * (self.count - 1))
            if rank < self._zero:
                return 0.0
            seen = self._zero
            for b, c in enumerate(self._counts):
                seen += c
                if seen > rank:
                    return self._representative(b)
            return self.max  # unreachable unless counts raced; be safe

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def summary(self) -> dict:
        if not self.count:
            return {"count": 0}
        return {"count": self.count, "sum": self.total, "mean": self.mean,
                "min": self.min, "max": self.max,
                "p50": self.quantile(0.50), "p95": self.quantile(0.95),
                "p99": self.quantile(0.99)}

    def snapshot(self):
        return self.summary()


class MetricsRegistry:
    """Named instruments grouped by subsystem, snapshot-exportable as one
    nested dict. See module docstring for the ownership idioms."""

    def __init__(self):
        self._metrics: dict = {}
        self._lock = threading.Lock()

    def _get_or_create(self, name: str, subsystem: str, cls):
        key = (subsystem, name)
        with self._lock:
            m = self._metrics.get(key)
            if m is None or not isinstance(m, cls):
                m = self._metrics[key] = cls()
            return m

    def counter(self, name: str, subsystem: str = "") -> Counter:
        return self._get_or_create(name, subsystem, Counter)

    def gauge(self, name: str, subsystem: str = "") -> Gauge:
        return self._get_or_create(name, subsystem, Gauge)

    def histogram(self, name: str, subsystem: str = "") -> Histogram:
        return self._get_or_create(name, subsystem, Histogram)

    def register(self, name: str, metric, subsystem: str = "") -> None:
        """Bind an externally-owned instrument — or a zero-arg callable
        polled at snapshot time — under ``(subsystem, name)``. Last writer
        wins: re-registering (a new trainer, a new engine) replaces the
        previous owner's binding."""
        with self._lock:
            self._metrics[(subsystem, name)] = metric

    def unregister(self, name: str, subsystem: str = "") -> None:
        with self._lock:
            self._metrics.pop((subsystem, name), None)

    def snapshot(self) -> dict:
        """-> ``{subsystem: {name: value}}``, JSON-able. Counter -> int,
        gauge -> float, histogram -> summary dict, callable -> its return
        value (errors render as ``{"error": ...}`` rather than poisoning
        the whole snapshot)."""
        with self._lock:
            items = list(self._metrics.items())
        out: dict = {}
        for (subsystem, name), metric in items:
            try:
                value = (metric.snapshot() if hasattr(metric, "snapshot")
                         else metric() if callable(metric) else metric)
            except Exception as e:  # noqa: BLE001 — snapshot must not raise
                value = {"error": repr(e)}
            out.setdefault(subsystem or "default", {})[name] = value
        return out

    def reset(self) -> None:
        """Drop every instrument (tests)."""
        with self._lock:
            self._metrics.clear()
