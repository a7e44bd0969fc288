"""mxnet_tpu_torch.telemetry — the process-wide metric registry.

Counterpart of the registry half of ``mxnet_tpu/telemetry/__init__.py``:
``counter``, ``gauge``, ``metrics`` and ``reset``, with the reference's
names. Metrics registered by a layer (the tuning tier's ``tune.*``
counters) move whether or not the reference's gate is on, so the port needs
no gate yet: ``enable``/``disable``/``MXNET_TELEMETRY`` come with the first
instrumentation site that reads them, as do timers, histograms, the event
log, step accounting, watchdog, exporter and memory ledger.
"""
from __future__ import annotations

from .registry import Counter, Gauge, Registry

__all__ = ["reset", "counter", "gauge", "metrics", "Counter", "Gauge",
           "Registry"]

REGISTRY = Registry()


def reset():
    """Zero every metric in place (metric objects stay valid: hot sites
    hold direct references)."""
    REGISTRY.reset()


def counter(name) -> Counter:
    return REGISTRY.counter(name)


def gauge(name) -> Gauge:
    return REGISTRY.gauge(name)


def metrics() -> dict:
    """Plain-value snapshot of every metric."""
    return REGISTRY.snapshot()
