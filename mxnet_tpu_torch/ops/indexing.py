"""Indexing of the port: ``NDArray.__getitem__`` / ``__setitem__`` and the
functional indexed updates.

Counterpart of ``mxnet_tpu/ops/indexing.py:82-151``. A key's static part
(ints, slices, Ellipsis, None) is frozen into the op's attributes; its
index arrays are op inputs, so a gather is recorded by autograd like any
other op. Boolean masks are op inputs too: torch indexes with them
directly (the reference copies to the host for their data-dependent shape).

``__setitem__`` writes by rebinding, as the reference's ``.at[].set``: the
array gets a new tensor and any other handle to the old one keeps its
values. It raises on an array recorded by autograd inside ``record()``.
``index_update`` / ``index_add`` are the functional forms, recorded by
autograd; ``index_add`` accumulates repeated indices, as ``.at[].add``.
"""
from __future__ import annotations

import numpy as onp
import torch

from .. import autograd as _ag
from ..base import MXNetError
from . import registry as _reg
from .registry import get_op, invoke, register

_SLICE = "s"
_INT = "i"
_ELL = "e"
_NONE = "n"
_ARR = "a"


def _freeze_key(key, device):
    """Encode an index key into a hashable spec; returns (spec, arrays)."""
    NDArray = _reg._nd.NDArray
    if not isinstance(key, tuple):
        key = (key,)
    spec, arrays = [], []
    for item in key:
        if isinstance(item, slice):
            spec.append((_SLICE, item.start, item.stop, item.step))
        elif isinstance(item, (bool, onp.bool_)):
            spec.append((_ARR,))
            arrays.append(torch.tensor(bool(item), device=device))
        elif isinstance(item, (int, onp.integer)):
            spec.append((_INT, int(item)))
        elif item is Ellipsis:
            spec.append((_ELL,))
        elif item is None:
            spec.append((_NONE,))
        elif isinstance(item, (NDArray, torch.Tensor)):
            spec.append((_ARR,))
            arrays.append(item)
        elif isinstance(item, (list, onp.ndarray)):
            spec.append((_ARR,))
            arrays.append(torch.as_tensor(onp.asarray(item), device=device))
        else:
            raise MXNetError(f"unsupported index item {item!r}")
    return tuple(spec), arrays


def _thaw_key(spec, arrays):
    out, it = [], iter(arrays)
    for s in spec:
        if s[0] == _SLICE:
            out.append(slice(s[1], s[2], s[3]))
        elif s[0] == _INT:
            out.append(s[1])
        elif s[0] == _ELL:
            out.append(Ellipsis)
        elif s[0] == _NONE:
            out.append(None)
        else:
            a = next(it)
            out.append(a if a.dtype == torch.bool else a.long())
    return tuple(out)


def _positive_steps(x, key):
    """(dims to flip, key): ``key`` on ``x`` flipped on those dims selects
    what ``key`` selects on ``x``, with every slice step positive (torch's
    slices take no negative step)."""
    if not any(isinstance(k, slice) and k.step is not None and k.step < 0
               for k in key):
        return (), key
    used = sum(k.dim() if isinstance(k, torch.Tensor) and
               k.dtype == torch.bool else 1
               for k in key if k is not None and k is not Ellipsis)
    dims, new, d = [], [], 0
    for k in key:
        if k is None:
            new.append(k)
            continue
        if k is Ellipsis:
            d += x.dim() - used
            new.append(k)
            continue
        if isinstance(k, slice) and k.step is not None and k.step < 0:
            n = x.shape[d]
            sel = range(n)[k]
            dims.append(d)
            new.append(slice(n - 1 - sel[0], n - sel[-1], -k.step)
                       if len(sel) else slice(0, 0))
        else:
            new.append(k)
        d += k.dim() if isinstance(k, torch.Tensor) and \
            k.dtype == torch.bool else 1
    return tuple(dims), tuple(new)


def _get(x, key):
    dims, key = _positive_steps(x, key)
    return (x.flip(dims) if dims else x)[key]


def _set(x, key, v):
    """A new tensor: ``x`` with ``x[key] = v``."""
    dims, key = _positive_steps(x, key)
    out = x.flip(dims) if dims else x.clone()
    out[key] = v
    return out.flip(dims) if dims else out


def _value(v, like):
    if isinstance(v, torch.Tensor) or onp.isscalar(v):
        return v
    return torch.as_tensor(onp.asarray(v), device=like.device)


def _positions(x, spec, arrays):
    """The flat positions of ``x`` that the key selects, in the shape of
    the selection."""
    flat = torch.arange(x.numel(), device=x.device).reshape(x.shape)
    return _get(flat, _thaw_key(spec, arrays))


@register("slice_key")
def _slice_key(spec=()):
    def f(x, *idx_arrays):
        return _get(x, _thaw_key(spec, idx_arrays))

    return f


@register("index_update")
def _index_update(spec=()):
    def f(x, v, *idx_arrays):
        return _set(x, _thaw_key(spec, idx_arrays), _value(v, x))

    return f


@register("index_add")
def _index_add(spec=()):
    def f(x, v, *idx_arrays):
        pos = _positions(x, spec, idx_arrays)
        v = _value(v, x)
        vals = torch.broadcast_to(v.to(x.dtype) if
                                  isinstance(v, torch.Tensor) else
                                  torch.tensor(v, dtype=x.dtype,
                                               device=x.device), pos.shape)
        return x.reshape(-1).index_add(0, pos.reshape(-1),
                                       vals.reshape(-1)).reshape(x.shape)

    return f


def getitem(self, key):
    spec, arrays = _freeze_key(key, self._data.device)
    return invoke(get_op("slice_key"), [self] + arrays, {"spec": spec})


def setitem(self, key, value):
    NDArray = _reg._nd.NDArray
    if _ag.is_recording() and self._data.requires_grad:
        raise MXNetError("in-place indexed assignment on an array recorded "
                         "by autograd is not allowed")
    spec, arrays = _freeze_key(key, self._data.device)
    if isinstance(value, NDArray):
        value = value._data
    idx = _thaw_key(spec, [a._data if isinstance(a, NDArray) else a
                           for a in arrays])
    with torch.no_grad():
        data = _set(self._data.detach(), idx, _value(value, self._data))
    self._set_data(data)


def index_update(data, key, value):
    """Functional indexed update: a new array with ``data[key] = value``
    (``a.at[key].set(value)``), recorded by autograd."""
    spec, arrays = _freeze_key(key, data._data.device)
    return invoke(get_op("index_update"), [data, value] + arrays,
                  {"spec": spec})


def index_add(data, key, value):
    """Functional indexed add (``a.at[key].add(value)``): repeated indices
    accumulate."""
    spec, arrays = _freeze_key(key, data._data.device)
    return invoke(get_op("index_add"), [data, value] + arrays,
                  {"spec": spec})
