"""mx.nd of the port: the legacy NDArray namespace.

Counterpart of ``mxnet_tpu/nd.py``: the legacy call conventions (``dim``
for ``axis``, CamelCase op names, ``broadcast_*`` / ``elemwise_*``,
``mx.nd.save`` / ``load``) over the one array type and the ``mx.np`` /
``mx.npx`` surface. ``save`` and ``load`` use the reference's ``.npz``
container and keys (``__single__``, ``__list__<i>``, or the dict's own),
so a file written by either package loads in the other. Any other
registered op resolves by name (:func:`__getattr__`, through
``symbol._LEGACY_NAMES`` and the registry). ``mx.nd.sparse`` is
:mod:`mxnet_tpu_torch.ndarray.sparse`; ``NDArray``, ``array`` and
``from_torch`` are the NDArray package's.
"""
from __future__ import annotations

import os as _os

import numpy as _onp

from . import numpy as _np
from . import numpy_extension as _npx
from . import random  # noqa: F401
from .base import MXNetError
from .engine import wait_all as waitall  # noqa: F401
from .ndarray import sparse  # noqa: F401
from .ndarray.ndarray import NDArray, array, from_torch  # noqa: F401

# the numpy surface under its legacy names
zeros = _np.zeros
ones = _np.ones
full = _np.full
arange = _np.arange
empty = _np.empty
eye = _np.eye
zeros_like = _np.zeros_like
ones_like = _np.ones_like
add = _np.add
subtract = _np.subtract
multiply = _np.multiply
divide = _np.true_divide
power = _np.power
maximum = _np.maximum
minimum = _np.minimum
exp = _np.exp
log = _np.log
sqrt = _np.sqrt
square = _np.square
abs = _np.abs
sign = _np.sign
sin = _np.sin
cos = _np.cos
tanh = _np.tanh
sigmoid = _npx.sigmoid
relu = _npx.relu
dot = _np.dot
sum = _np.sum
mean = _np.mean
max = _np.max
min = _np.min
argmax = _np.argmax
argmin = _np.argmin
clip = _np.clip
where = _np.where
stack = _np.stack
split = _np.split
take = _np.take
one_hot = _np.one_hot
pick = _np.pick
topk = _np.topk
sort = _np.sort
argsort = _np.argsort
expand_dims = _np.expand_dims
squeeze = _np.squeeze
transpose = _np.transpose
reshape = _np.reshape
tile = _np.tile
repeat = _np.repeat
flip = _np.flip
norm = _np.linalg.norm
softmax = _npx.softmax
log_softmax = _npx.log_softmax
SequenceMask = _npx.sequence_mask
SequenceLast = _npx.sequence_last
SequenceReverse = _npx.sequence_reverse
Activation = _npx.activation
FullyConnected = _npx.fully_connected
Convolution = _npx.convolution
Pooling = _npx.pooling
Dropout = _npx.dropout
Embedding = _npx.embedding
LeakyReLU = _npx.leaky_relu
batch_dot = _npx.batch_dot


def concat(*data, dim=1):
    """Legacy concat along ``dim`` (reference: nd.concat)."""
    if len(data) == 1 and isinstance(data[0], (list, tuple)):
        data = data[0]
    return _np.concatenate(list(data), axis=dim)


def flatten(data):
    return data.reshape((data.shape[0], -1))


def slice_axis(data, axis, begin, end):
    return _npx.slice_axis(data, axis=axis, begin=begin, end=end)


def broadcast_add(a, b):
    return _np.add(a, b)


broadcast_plus = broadcast_add


def broadcast_sub(a, b):
    return _np.subtract(a, b)


def broadcast_mul(a, b):
    return _np.multiply(a, b)


def broadcast_div(a, b):
    return _np.true_divide(a, b)


def broadcast_maximum(a, b):
    return _np.maximum(a, b)


def broadcast_minimum(a, b):
    return _np.minimum(a, b)


def elemwise_add(a, b):
    return _np.add(a, b)


def elemwise_sub(a, b):
    return _np.subtract(a, b)


def elemwise_mul(a, b):
    return _np.multiply(a, b)


# -- save / load: the reference's .npz container (reference :152-183) --------
def save(fname, data):
    """Write an NDArray, a list or a dict of them to ``fname`` exactly
    (through a file object: numpy would append ``.npz`` to a bare path)."""
    with open(fname, "wb") as f:
        if isinstance(data, NDArray):
            _onp.savez(f, __single__=data.asnumpy())
        elif isinstance(data, list):
            _onp.savez(f, **{f"__list__{i}": d.asnumpy()
                             for i, d in enumerate(data)})
        elif isinstance(data, dict):
            _onp.savez(f, **{k: v.asnumpy() for k, v in data.items()})
        else:
            raise MXNetError(f"cannot save {type(data)}")


def load(fname, ctx=None):
    """Read what :func:`save` wrote (in either package) onto ``ctx`` (None:
    the current context)."""
    if not _os.path.exists(fname) and _os.path.exists(fname + ".npz"):
        fname = fname + ".npz"
    with _onp.load(fname) as z:
        keys = list(z.keys())
        if keys == ["__single__"]:
            return array(z["__single__"], ctx=ctx)
        if keys and keys[0].startswith("__list__"):
            return [array(z[f"__list__{i}"], ctx=ctx)
                    for i in range(len(keys))]
        return {k: array(z[k], ctx=ctx) for k in keys}


def __getattr__(name):
    """Any registered op by its name or legacy name (reference :185-202)."""
    from .ops.registry import _OPS, apply_op
    from .symbol import _LEGACY_NAMES

    op_name = _LEGACY_NAMES.get(name, name)
    if op_name not in _OPS:
        raise AttributeError(f"module 'mxnet_tpu_torch.nd' has no attribute "
                             f"{name!r}")

    def wrapper(*inputs, **attrs):
        out = attrs.pop("out", None)
        arrs = [_npx._nd(x) if hasattr(x, "shape") else x for x in inputs]
        return apply_op(op_name, *arrs, out=out, **attrs)

    wrapper.__name__ = name
    globals()[name] = wrapper
    return wrapper
