"""Thread-safe metric registry: counters and gauges.

Counterpart of ``mxnet_tpu/telemetry/registry.py``, which is pure Python:
the port keeps its own copy of the counter and gauge half and never imports
the JAX package. Timers and histograms come with the first site that reads
them (the decode engine keeps its own latency window for ``stats()``). Metric objects are created once and kept for the process
lifetime: hot instrumentation sites resolve a Counter a single time and
call ``inc()`` on it, so the enabled-path cost is one lock + one add.
``reset()`` zeroes values in place rather than dropping objects, so
pre-resolved references held by the hot paths never go stale.
"""
from __future__ import annotations

import threading

__all__ = ["Counter", "Gauge", "Registry"]


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

    def snapshot(self) -> dict:
        """Plain-value view: {name: int|float}."""
        return {name: m.value for name, m in sorted(self._metrics.items())}

    def reset(self):
        """Zero every metric IN PLACE (objects stay valid — hot sites hold
        direct references)."""
        for m in list(self._metrics.values()):
            m.reset()

    def __iter__(self):
        return iter(list(self._metrics.values()))
