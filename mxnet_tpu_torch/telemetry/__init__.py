"""mxnet_tpu_torch.telemetry — the process-wide metric registry.

Counterpart of the registry half of ``mxnet_tpu/telemetry/__init__.py``:
``counter``, ``gauge``, ``timer``, ``histogram``, ``metrics`` and
``reset``, with the reference's names. Metrics registered by a layer (the
tuning tier's ``tune.*`` counters, the serving layers' ``serve.*``) move
whether or not the reference's gate is on, so the port needs no gate yet:
``enable``/``disable``/``MXNET_TELEMETRY`` come with the first
instrumentation site that reads them, as do the event log, request traces,
step accounting, watchdog, exporter, health checks and memory ledger.
"""
from __future__ import annotations

from .registry import Counter, Gauge, Histogram, Registry, Timer

__all__ = ["reset", "counter", "gauge", "timer", "histogram", "metrics",
           "Counter", "Gauge", "Timer", "Histogram", "Registry"]

REGISTRY = Registry()


def reset():
    """Zero every metric in place (metric objects stay valid: hot sites
    hold direct references)."""
    REGISTRY.reset()


def counter(name) -> Counter:
    return REGISTRY.counter(name)


def gauge(name) -> Gauge:
    return REGISTRY.gauge(name)


def timer(name) -> Timer:
    return REGISTRY.timer(name)


def histogram(name) -> Histogram:
    return REGISTRY.histogram(name)


def metrics() -> dict:
    """Plain-value snapshot of every metric."""
    return REGISTRY.snapshot()
