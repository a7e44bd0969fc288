"""Thread-safe metric registry: counters, gauges, timers and histograms.

Counterpart of ``mxnet_tpu/telemetry/registry.py``, which is pure Python:
the port keeps its own copy and never imports the JAX package. The
``Predictor`` and the decode engine read the histograms (latency p50/p99)
and the ``Predictor`` the timers (a bucket program's call). A timer records
no span: the port has no event log yet. Metric objects are created once and
kept for the process lifetime: hot instrumentation sites resolve a Counter
a single time and call ``inc()`` on it, so the enabled-path cost is one
lock + one add.
``reset()`` zeroes values in place rather than dropping objects, so
pre-resolved references held by the hot paths never go stale.
"""
from __future__ import annotations

import contextlib
import threading
import time

__all__ = ["Counter", "Gauge", "Timer", "Histogram", "Registry"]


class Counter:
    """Monotonic counter. ``inc`` is atomic under an internal lock —
    CPython's ``+=`` on an attribute is NOT atomic (read/add/store can
    interleave across threads), and DataLoader worker threads do hit the
    same counters concurrently."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n=1):
        with self._lock:
            self._value += n

    @property
    def value(self):
        return self._value

    def reset(self):
        with self._lock:
            self._value = 0

    def __repr__(self):
        return f"Counter({self.name}={self._value})"


class Gauge:
    """Last-write-wins scalar (e.g. queue depth, live bytes)."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name):
        self.name = name
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v):
        with self._lock:
            self._value = float(v)

    @property
    def value(self):
        return self._value

    def reset(self):
        with self._lock:
            self._value = 0.0

    def __repr__(self):
        return f"Gauge({self.name}={self._value})"


class Timer:
    """Accumulating duration metric: (total seconds, count)."""

    __slots__ = ("name", "_total", "_count", "_lock")

    def __init__(self, name):
        self.name = name
        self._total = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def record(self, seconds):
        with self._lock:
            self._total += seconds
            self._count += 1

    @contextlib.contextmanager
    def time(self):
        """Time a block on the host clock."""
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            self.record(time.perf_counter() - t0)

    @property
    def total(self):
        return self._total

    @property
    def count(self):
        return self._count

    @property
    def value(self):
        return (self._total, self._count)

    def reset(self):
        with self._lock:
            self._total = 0.0
            self._count = 0

    def __repr__(self):
        return f"Timer({self.name}: {self._total:.6f}s/{self._count})"


class Histogram:
    """Percentile-capable sample metric (serve p50/p99 latency).

    A bounded ring of the most recent ``capacity`` samples (old samples are
    overwritten, so the percentiles describe recent traffic) plus exact
    running count and sum. Percentiles use the nearest-rank method over a
    sorted copy of the ring: an O(n log n) read, paid by the reader, never
    by the recording hot path."""

    __slots__ = ("name", "_buf", "_next", "_count", "_sum", "_lock", "_cap")

    def __init__(self, name, capacity=8192):
        self.name = name
        self._cap = int(capacity)
        self._buf = []
        self._next = 0
        self._count = 0
        self._sum = 0.0
        self._lock = threading.Lock()

    def record(self, value):
        v = float(value)
        with self._lock:
            if len(self._buf) < self._cap:
                self._buf.append(v)
            else:
                self._buf[self._next] = v
                self._next = (self._next + 1) % self._cap
            self._count += 1
            self._sum += v

    def percentile(self, p):
        """Nearest-rank percentile of the retained window; None when
        empty."""
        return self.percentiles(p)[0]

    def percentiles(self, *ps):
        """Several percentiles from one sorted copy of the window."""
        with self._lock:
            data = sorted(self._buf)
        if not data:
            return [None] * len(ps)
        n = len(data)
        out = []
        for p in ps:
            if not 0 <= p <= 100:
                from ..base import MXNetError

                raise MXNetError(f"percentile {p} outside [0, 100]")
            # nearest rank: the smallest value with at least p % of the
            # samples at or below it
            rank = max(int(-(-(p / 100.0 * n) // 1)), 1)
            out.append(data[rank - 1])
        return out

    @property
    def count(self):
        return self._count

    @property
    def sum(self):
        return self._sum

    @property
    def mean(self):
        return self._sum / self._count if self._count else 0.0

    @property
    def value(self):
        """Snapshot dict: count, sum and mean, and p50/p90/p99 of the
        window."""
        p50, p90, p99 = self.percentiles(50, 90, 99)
        return {"count": self._count, "sum": self._sum, "mean": self.mean,
                "p50": p50, "p90": p90, "p99": p99}

    def reset(self):
        with self._lock:
            self._buf = []
            self._next = 0
            self._count = 0
            self._sum = 0.0

    def __repr__(self):
        return f"Histogram({self.name}: n={self._count})"


class Registry:
    """Process-wide name -> metric map. Creation is locked; lookups of an
    existing metric are a plain dict get (readers never block writers for
    long — the registry is small and append-mostly)."""

    def __init__(self):
        self._metrics: dict = {}
        self._lock = threading.Lock()
        # bumped on every metric creation; lets per-step accounting cache
        # resolved metric objects and refresh only when the set grows
        self.version = 0

    def _get(self, name, cls):
        m = self._metrics.get(name)
        if m is None:
            with self._lock:
                m = self._metrics.get(name)
                if m is None:
                    m = cls(name)
                    self._metrics[name] = m
                    self.version += 1
        if not isinstance(m, cls):
            from ..base import MXNetError

            raise MXNetError(
                f"telemetry metric {name!r} already registered as "
                f"{type(m).__name__}, not {cls.__name__}")
        return m

    def counter(self, name) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name) -> Gauge:
        return self._get(name, Gauge)

    def timer(self, name) -> Timer:
        return self._get(name, Timer)

    def histogram(self, name) -> Histogram:
        return self._get(name, Histogram)

    def snapshot(self) -> dict:
        """Plain-value view: {name: int | float | (total, count) | dict}."""
        return {name: m.value for name, m in sorted(self._metrics.items())}

    def reset(self):
        """Zero every metric IN PLACE (objects stay valid — hot sites hold
        direct references)."""
        for m in list(self._metrics.values()):
            m.reset()

    def __iter__(self):
        return iter(list(self._metrics.values()))
