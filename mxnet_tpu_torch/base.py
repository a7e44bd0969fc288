"""Base utilities of the PyTorch/CUDA port: the framework error type and
dtypes.

Counterpart of ``mxnet_tpu/base.py``. Only what the ported slices need is
carried: :class:`MXNetError`, the exception every layer of the port raises,
:func:`warn_once` (reference :30), :class:`Registry` (reference :116, the
name -> class store behind ``metric.create``), :func:`to_dtype` and the
reference's dtype aliases with :func:`canonical_dtype` / :func:`dtype_name`
(:77-110).

The reference runs JAX with 64-bit types off, so its arrays are never
int64, uint64 or float64: a request for one gives int32, uint32 or
float32. :func:`canonical_dtype` applies the same rule here, and the
``NDArray`` layer (``mx.np``, ``mx.npx``, ``ops.registry.invoke``) narrows
every 64-bit result torch returns (sums of ints, indices) to the same
32-bit types.
"""
from __future__ import annotations

import contextlib
import gc
import threading
import warnings

import torch

__all__ = ["MXNetError", "Registry", "to_dtype", "canonical_dtype",
           "dtype_name", "narrow", "warn_once", "collector_paused"]

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


class Registry:
    """Name -> object registry with decorator support (reference :116, its
    ``register``, ``get`` and ``list``); names are case-insensitive."""

    def __init__(self, kind: str):
        self.kind = kind
        self._store: dict[str, object] = {}

    def register(self, obj=None, name=None):
        def _do(o):
            key = (name or getattr(o, "__name__", None) or str(o)).lower()
            self._store[key] = o
            return o

        if obj is None:
            return _do
        return _do(obj)

    def get(self, name: str):
        key = name.lower() if isinstance(name, str) else name
        if key not in self._store:
            raise KeyError(
                f"{self.kind} '{name}' is not registered. "
                f"Known: {sorted(self._store)}"
            )
        return self._store[key]

    def list(self):
        return sorted(self._store)


@contextlib.contextmanager
def collector_paused():
    """Python's cyclic garbage collector off for the block, restored after.
    Wrap a CUDA graph capture in it: a graph that the collector frees while
    another is being captured ends that capture (destroying a graph is not
    permitted while a stream captures), and the port's captured programs
    and steps sit in reference cycles that only the collector frees.
    ``torch.cuda.graph`` collects once before it starts capturing."""
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


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


# the reference's aliases (mxnet_tpu/base.py:80-87)
_DTYPE_ALIASES = {
    "float": "float32",
    "double": "float64",
    "half": "float16",
    "int": "int32",
    "long": "int64",
    "bool_": "bool",
}

# 64-bit types as the reference's x64-off JAX gives them
_NARROW = {torch.int64: torch.int32, torch.float64: torch.float32,
           torch.uint64: torch.uint32, torch.complex128: torch.complex64}

_TORCH_OF_NAME = {**_DTYPES, "float16": torch.float16, "int16": torch.int16,
                  "uint16": torch.uint16, "uint32": torch.uint32,
                  "uint64": torch.uint64, "complex64": torch.complex64,
                  "complex128": torch.complex128}
_NAME_OF_TORCH = {v: k for k, v in _TORCH_OF_NAME.items()}


def dtype_name(dtype) -> str:
    """String name of a dtype given as a torch dtype, a numpy dtype or
    type, or a name (``'float32'``, ``'bfloat16'``, ...); reference :105."""
    if dtype is None:
        return "None"
    if isinstance(dtype, torch.dtype):
        return _NAME_OF_TORCH[dtype]
    if isinstance(dtype, str):
        return _DTYPE_ALIASES.get(dtype, dtype)
    name = getattr(dtype, "__name__", None)
    if name == "bfloat16" or str(dtype) == "bfloat16":
        return "bfloat16"
    import numpy as onp

    return str(onp.dtype(dtype))


def canonical_dtype(dtype):
    """The torch dtype the reference's arrays take for a user's dtype spec
    (a name, an alias, a numpy or torch dtype; None stays None), 64-bit
    types narrowed as x64-off JAX narrows them (reference :90)."""
    if dtype is None:
        return None
    name = dtype_name(dtype)
    try:
        dt = _TORCH_OF_NAME[name]
    except KeyError:
        raise MXNetError(f"unsupported dtype {dtype!r}") from None
    return _NARROW.get(dt, dt)


def narrow(t):
    """``t`` with a 64-bit dtype narrowed to the reference's 32-bit one;
    other tensors as they are."""
    dt = _NARROW.get(t.dtype)
    return t if dt is None else t.to(dt)
