"""Base utilities of the PyTorch/CUDA port: the framework error type.

Counterpart of ``mxnet_tpu/base.py``. Only what the ported slices need is
carried: :class:`MXNetError`, the exception every layer of the port raises,
:func:`warn_once` (reference :30) and the dtype-name helper.
"""
from __future__ import annotations

import threading
import warnings

import torch

__all__ = ["MXNetError", "to_dtype", "warn_once"]

# process-level dedup of degradation warnings: a hot path may meet the same
# unsupported configuration every step, and the useful signal is "this run
# degraded", once
_warned_keys: set = set()
_warned_lock = threading.Lock()


def warn_once(key, message, category=RuntimeWarning, stacklevel=2):
    """Emit ``message`` at most once per process for ``key``; returns True
    when the warning fired (reference: ``mxnet_tpu/base.py:30``)."""
    with _warned_lock:
        if key in _warned_keys:
            return False
        _warned_keys.add(key)
    warnings.warn(message, category, stacklevel=stacklevel + 1)
    return True


class MXNetError(RuntimeError):
    """Framework error type (reference: MXGetLastError / dmlc::Error)."""


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "float64": torch.float64,
           "int32": torch.int32, "int64": torch.int64, "int8": torch.int8,
           "uint8": torch.uint8, "bool": torch.bool,
           "float8_e4m3fn": torch.float8_e4m3fn,
           "float8_e5m2": torch.float8_e5m2}


def to_dtype(dtype):
    """A torch dtype from a torch dtype or its name (``"float32"``,
    ``"bfloat16"``, ``"float8_e4m3fn"``, ...)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _DTYPES[str(dtype)]
    except KeyError:
        raise MXNetError(f"unsupported dtype {dtype!r}") from None
