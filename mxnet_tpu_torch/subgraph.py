"""Graph-pass / subgraph-property registry (the ``optimize_for`` hook).

Counterpart of ``mxnet_tpu/subgraph.py``. A *backend* is a list of
Symbol -> Symbol passes that run before a traced graph becomes a
:class:`~mxnet_tpu_torch.cached_op.CachedOp`
(``HybridBlock.optimize_for``, ``Symbol.optimize_for``,
``cached_op.trace(..., transform=)``): the place where a subgraph is
replaced by one fused op, as the reference's oneDNN/TensorRT regions. The
built-in ``"default"`` backend is the identity; ``"tpu"``
(:mod:`mxnet_tpu_torch.tpu_passes`, a name kept because users' code passes
it) fuses hand-written attention onto the flash kernels.
"""
from __future__ import annotations

from .base import MXNetError

__all__ = ["register_backend", "register_pass", "get_passes",
           "list_backends", "apply_passes"]

_backends: dict[str, list] = {}


def register_backend(name: str):
    """Declare a pass backend (reference: MXNET_REGISTER_SUBGRAPH_BACKEND)."""
    _backends.setdefault(name.lower(), [])
    return name


def register_pass(backend: str, pass_fn=None):
    """Attach a Symbol -> Symbol pass to a backend (decorator-friendly)."""

    def _do(fn):
        _backends.setdefault(backend.lower(), []).append(fn)
        return fn

    if pass_fn is None:
        return _do
    return _do(pass_fn)


def get_passes(backend: str):
    try:
        return list(_backends[str(backend).lower()])
    except KeyError:
        raise MXNetError(f"subgraph backend {backend!r} not registered; "
                         f"known: {sorted(_backends)}") from None


def list_backends():
    return sorted(_backends)


def apply_passes(sym, backend: str):
    """Run a backend's passes over a Symbol, in registration order."""
    for pass_fn in get_passes(backend):
        sym = pass_fn(sym)
    return sym


register_backend("default")

# the built-in "tpu" backend registers itself on import
from . import tpu_passes  # noqa: E402,F401
