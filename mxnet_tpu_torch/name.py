"""Name manager: ``NameManager`` and ``Prefix`` give symbols unique names
per op type. Counterpart of ``mxnet_tpu/name.py``, the same code (it holds
no JAX)."""
from __future__ import annotations

import threading

__all__ = ["NameManager", "Prefix"]


class NameManager:
    """Assigns unique names per op type; usable as a context manager."""

    _local = threading.local()

    def __init__(self):
        self._counter = {}

    def get(self, name, hint):
        if name is not None:
            return name
        idx = self._counter.get(hint, 0)
        self._counter[hint] = idx + 1
        return f"{hint}{idx}"

    @classmethod
    def current(cls):
        stack = getattr(cls._local, "stack", None)
        if stack:
            return stack[-1]
        if not hasattr(cls._local, "default"):
            cls._local.default = NameManager()
        return cls._local.default

    def __enter__(self):
        stack = getattr(NameManager._local, "stack", None)
        if stack is None:
            stack = NameManager._local.stack = []
        stack.append(self)
        return self

    def __exit__(self, *exc):
        NameManager._local.stack.pop()


class Prefix(NameManager):
    def __init__(self, prefix):
        super().__init__()
        self._prefix = prefix

    def get(self, name, hint):
        return self._prefix + super().get(name, hint)
