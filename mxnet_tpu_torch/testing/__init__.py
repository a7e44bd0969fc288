"""mxnet_tpu_torch.testing — the fault-injection harness.

Counterpart of ``mxnet_tpu/testing/__init__.py``. Production code imports
only :mod:`chaos` (stdlib only, near-zero cost when no fault is armed).
"""
from . import chaos
from .chaos import FaultError, fault_point

__all__ = ["chaos", "FaultError", "fault_point"]
