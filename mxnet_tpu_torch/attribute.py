"""Attribute scoping for symbols: ``AttrScope`` attaches attributes to the
symbols made inside it. Counterpart of ``mxnet_tpu/attribute.py``, the
same code (it holds no JAX)."""
from __future__ import annotations

import threading

__all__ = ["AttrScope"]


class AttrScope:
    _local = threading.local()

    def __init__(self, **kwargs):
        self._attrs = {k: str(v) for k, v in kwargs.items()}

    def get(self, attrs=None):
        out = dict(self._attrs)
        if attrs:
            out.update(attrs)
        return out

    @classmethod
    def current(cls):
        stack = getattr(cls._local, "stack", None)
        if stack:
            return stack[-1]
        if not hasattr(cls._local, "default"):
            cls._local.default = AttrScope()
        return cls._local.default

    def __enter__(self):
        stack = getattr(AttrScope._local, "stack", None)
        if stack is None:
            stack = AttrScope._local.stack = []
        # nested scopes merge outward-in
        merged = AttrScope()
        merged._attrs = {**AttrScope.current()._attrs, **self._attrs}
        stack.append(merged)
        return merged

    def __exit__(self, *exc):
        AttrScope._local.stack.pop()
