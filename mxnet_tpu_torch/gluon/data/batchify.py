"""Batchify functions (reference: python/mxnet/gluon/data/batchify.py over
src/io/batchify.cc — Stack, Pad, Group/Tuple).

Counterpart of ``mxnet_tpu/gluon/data/batchify.py``: samples are stacked on
the host (numpy) and the batch becomes an NDArray on the current context
(in a spawned ``DataLoader`` worker, the CPU).
"""
from __future__ import annotations

import numpy as onp
import torch

from ...base import MXNetError
from ...ndarray.ndarray import NDArray

__all__ = ["Stack", "Pad", "Tuple", "Group"]


def _np(x):
    if isinstance(x, NDArray):
        return x.asnumpy()
    if isinstance(x, torch.Tensor):
        return NDArray(x).asnumpy()
    return onp.asarray(x)


def _to_nd(out, dtype=None):
    if dtype is not None:
        out = out.astype(dtype)
    elif out.dtype == onp.float64:
        out = out.astype(onp.float32)
    return NDArray(out)


class Stack:
    """Stack samples along a new batch axis (reference: batchify.Stack).

    Tuple/list samples are stacked per field (like the reference)."""

    def __call__(self, data):
        # tuples = multi-field samples (stack per field); lists are
        # array-like payloads
        if isinstance(data[0], tuple):
            return tuple(Stack()(list(field)) for field in zip(*data))
        arrs = [_np(d) for d in data]
        return _to_nd(onp.stack(arrs))


class Pad:
    """Pad ragged samples to the per-axis batch max (reference:
    batchify.Pad:212 — val/dtype/round_to signature; the gluon-nlp style
    axis/pad_val/ret_length arguments are also accepted).

    ALL ragged axes pad to the batch maximum; ``round_to`` rounds the padded
    length of ``axis`` up to a multiple (shape-bucketing for compile caches).
    """

    def __init__(self, axis=0, pad_val=None, ret_length=False, dtype=None,
                 val=None, round_to=None):
        self._axis = axis
        self._pad_val = pad_val if pad_val is not None else \
            (val if val is not None else 0)
        self._ret_length = ret_length
        self._dtype = dtype
        self._round_to = round_to

    def __call__(self, data):
        arrs = [_np(d) for d in data]
        ndim = arrs[0].ndim
        if any(a.ndim != ndim for a in arrs):
            raise MXNetError("Pad: samples must share a rank")
        lengths = onp.asarray([a.shape[self._axis] for a in arrs],
                              dtype="int32")
        maxes = [max(a.shape[d] for a in arrs) for d in range(ndim)]
        if self._round_to:
            r = self._round_to
            maxes[self._axis] = -(-maxes[self._axis] // r) * r
        padded = []
        for a in arrs:
            pad_width = [(0, maxes[d] - a.shape[d]) for d in range(ndim)]
            padded.append(onp.pad(a, pad_width,
                                  constant_values=self._pad_val))
        out = _to_nd(onp.stack(padded), self._dtype)
        if self._ret_length:
            return out, NDArray(lengths)
        return out


class Tuple:
    """Apply one batchify fn per sample field (reference: batchify.Group)."""

    def __init__(self, *fns):
        if len(fns) == 1 and isinstance(fns[0], (list, tuple)):
            fns = tuple(fns[0])
        self._fns = fns

    def __call__(self, data):
        if len(data[0]) != len(self._fns):
            raise MXNetError(
                f"Tuple batchify: samples have {len(data[0])} fields but "
                f"{len(self._fns)} functions were given")
        return tuple(fn([sample[i] for sample in data])
                     for i, fn in enumerate(self._fns))


Group = Tuple  # reference alias
