"""mx.np of the port — the NumPy-compatible array API on NDArrays.

Counterpart of ``mxnet_tpu/numpy/__init__.py``. Every function here goes
through ``ops.registry.invoke`` (autograd-aware) to the ops of
:mod:`mxnet_tpu_torch.ops._core`, :mod:`.indexing` and :mod:`.nn`, which
run PyTorch on the arrays' device. Creation functions take ``ctx=`` or
``device=`` (a :class:`~mxnet_tpu_torch.context.Context`, a
``torch.device`` or a name); without one they use the current context: the
GPU, or the CPU inside ``with mx.cpu():``. Dtypes follow the reference's
x64-off JAX: ``arange(5)`` and integer data are int32, float data float32.

Functions with data-dependent output shapes (``unique``, ``nonzero``,
``flatnonzero`` without ``size``) copy to the host, as the reference's.

``mx.np.random`` is :mod:`mxnet_tpu_torch.random`, as the reference's is
its ``random`` module. ``diagflat``, ``fill_diagonal``, ``rollaxis``,
``polyval``, ``blackman``, ``hamming``, ``hanning`` and ``tril_indices``
run the ops of :mod:`mxnet_tpu_torch.ops.extra`.
"""
from __future__ import annotations

import builtins as _bi

import numpy as _onp
import torch as _torch

from ..base import canonical_dtype as _canon
from ..base import dtype_name as _dname
from ..context import resolve_device as _resolve
from ..ndarray.ndarray import NDArray, array
from ..ops.registry import apply_op as _op
from ..ops import indexing as _indexing
from .. import random  # noqa: F401 — mx.np.random
from . import linalg  # noqa: F401
from ._serialization import (save, savez, savez_compressed,  # noqa: F401
                             load)

ndarray = NDArray

pi = _onp.pi
e = _onp.e
euler_gamma = _onp.euler_gamma
inf = _onp.inf
nan = _onp.nan
newaxis = None

float32 = _onp.float32
float64 = _onp.float64
float16 = _onp.float16
int8 = _onp.int8
int16 = _onp.int16
int32 = _onp.int32
int64 = _onp.int64
uint8 = _onp.uint8
uint16 = _onp.uint16
uint32 = _onp.uint32
uint64 = _onp.uint64
bool_ = _onp.bool_


def __getattr__(name):
    raise AttributeError(
        f"module 'mxnet_tpu_torch.numpy' has no attribute {name!r}")


def _as_nd(x, like=None):
    """``x`` as an NDArray (on ``like``'s device when given): a tensor
    wrapped as it is, without a copy, so autograd sees the op. A Python
    scalar beside an array (``like``) stays a scalar, as the ops take it
    with JAX's weak typing."""
    if isinstance(x, NDArray):
        return x
    if isinstance(x, _torch.Tensor):
        return NDArray(x)
    if like is not None and _onp.isscalar(x):
        return x
    return array(x, ctx=None if like is None else like._data.device)


def _both_nd(x1, x2):
    # at least one operand must be an array for dispatch
    arrays = (NDArray, _torch.Tensor)
    if not isinstance(x1, arrays) and not isinstance(x2, arrays):
        x1 = array(x1)
    like = _as_nd(x1 if isinstance(x1, arrays) else x2)
    return _as_nd(x1, like), _as_nd(x2, like)


# -- generated wrappers ------------------------------------------------------
_UNARY_FUNCS = [
    "abs", "absolute", "negative", "sign", "exp", "expm1", "log", "log2",
    "log10", "log1p", "sqrt", "cbrt", "square", "reciprocal", "sin", "cos",
    "tan", "arcsin", "arccos", "arctan", "sinh", "cosh", "tanh", "arcsinh",
    "arccosh", "arctanh", "floor", "ceil", "trunc", "rint", "fix", "invert",
    "logical_not", "isnan", "isinf", "isfinite", "isposinf", "isneginf",
    "degrees", "radians", "conj", "real", "imag", "angle", "atleast_1d",
    "atleast_2d", "atleast_3d",
]
_ALIAS = {"absolute": "abs"}

_BINARY_FUNCS = [
    "add", "subtract", "multiply", "true_divide", "divide", "floor_divide",
    "mod", "fmod", "remainder", "power", "maximum", "minimum", "fmax", "fmin",
    "hypot", "arctan2", "logaddexp", "equal", "not_equal", "less",
    "less_equal", "greater", "greater_equal", "logical_and", "logical_or",
    "logical_xor", "bitwise_and", "bitwise_or", "bitwise_xor", "left_shift",
    "right_shift", "matmul", "dot", "inner", "outer", "vdot", "kron",
    "copysign", "gcd", "lcm", "ldexp", "nextafter",
]
_BALIAS = {"divide": "true_divide", "remainder": "mod"}


def _def_unary(name):
    opname = _ALIAS.get(name, name)

    def f(x, out=None, **kw):
        return _op(opname, _as_nd(x), out=out)

    f.__name__ = name
    return f


def _def_binary(name):
    opname = _BALIAS.get(name, name)

    def f(x1, x2, out=None, **kw):
        a, b = _both_nd(x1, x2)
        return _op(opname, a, b, out=out)

    f.__name__ = name
    return f


for _n in _UNARY_FUNCS:
    globals()[_n] = _def_unary(_n)
for _n in _BINARY_FUNCS:
    globals()[_n] = _def_binary(_n)

erf = _def_unary("erf")
erfinv = _def_unary("erfinv")
gamma = _def_unary("gamma")
gammaln = _def_unary("gammaln")


# -- reductions --------------------------------------------------------------
def _ax(axis):
    return tuple(axis) if isinstance(axis, list) else axis


def _dt(dtype):
    return None if dtype is None else _dname(_canon(dtype))


def _red(name, has_dtype=True, has_ddof=False):
    def f(a, axis=None, dtype=None, out=None, keepdims=False, ddof=0, **kw):
        attrs = {"axis": _ax(axis), "keepdims": keepdims}
        if has_dtype and dtype is not None:
            attrs["dtype"] = _dt(dtype)
        if has_ddof:
            attrs["ddof"] = ddof
        return _op(name, _as_nd(a), out=out, **attrs)

    f.__name__ = name
    return f


sum = _red("sum")
mean = _red("mean")
prod = _red("prod")
std = _red("std", has_ddof=True)
var = _red("var", has_ddof=True)
nansum = _red("nansum")
nanmean = _red("nanmean")


def _red_nodtype(name):
    def f(a, axis=None, out=None, keepdims=False, **kw):
        return _op(name, _as_nd(a), axis=_ax(axis), keepdims=keepdims,
                   out=out)

    f.__name__ = name
    return f


max = _red_nodtype("max")
min = _red_nodtype("min")
amax = max
amin = min
nanmax = _red_nodtype("nanmax")
nanmin = _red_nodtype("nanmin")
all = _red_nodtype("all")
any = _red_nodtype("any")
median = _red_nodtype("median")
logsumexp = _red_nodtype("logsumexp")


def argmax(a, axis=None, out=None, keepdims=False):
    return _op("argmax", _as_nd(a), axis=axis, keepdims=keepdims, out=out)


def argmin(a, axis=None, out=None, keepdims=False):
    return _op("argmin", _as_nd(a), axis=axis, keepdims=keepdims, out=out)


def cumsum(a, axis=None, dtype=None, out=None):
    return _op("cumsum", _as_nd(a), axis=axis, dtype=_dt(dtype), out=out)


def cumprod(a, axis=None, dtype=None, out=None):
    return _op("cumprod", _as_nd(a), axis=axis, dtype=_dt(dtype), out=out)


def average(a, axis=None, weights=None, returned=False):
    if weights is None:
        return mean(a, axis=axis)
    a = _as_nd(a)
    return _op("average", a, _as_nd(weights, a), axis=_ax(axis))


def trace(a, offset=0, axis1=0, axis2=1):
    return _op("trace", _as_nd(a), offset=offset, axis1=axis1, axis2=axis2)


# -- shape manipulation ------------------------------------------------------
def _tup(v):
    return tuple(v) if isinstance(v, (list, tuple)) else v


def reshape(a, newshape, order="C"):
    return _op("reshape", _as_nd(a), newshape=_tup(newshape))


def transpose(a, axes=None):
    return _op("transpose", _as_nd(a), axes=tuple(axes) if axes else None)


def swapaxes(a, axis1, axis2):
    return _op("swapaxes", _as_nd(a), axis1=axis1, axis2=axis2)


def moveaxis(a, source, destination):
    return _op("moveaxis", _as_nd(a), source=_tup(source),
               destination=_tup(destination))


def squeeze(a, axis=None):
    return _op("squeeze", _as_nd(a), axis=axis)


def expand_dims(a, axis):
    return _op("expand_dims", _as_nd(a), axis=axis)


def broadcast_to(a, shape):
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    return _op("broadcast_to", _as_nd(a), shape=shape)


def broadcast_arrays(*args):
    shape = _onp.broadcast_shapes(*[a.shape for a in args])
    return [broadcast_to(a, shape) for a in args]


def tile(a, reps):
    return _op("tile", _as_nd(a), reps=_tup(reps))


def repeat(a, repeats, axis=None):
    return _op("repeat", _as_nd(a), repeats=_tup(repeats), axis=axis)


def flip(a, axis=None):
    return _op("flip", _as_nd(a), axis=axis)


def flipud(a):
    return flip(a, 0)


def fliplr(a):
    return flip(a, 1)


def roll(a, shift, axis=None):
    return _op("roll", _as_nd(a), shift=_tup(shift), axis=_tup(axis))


def rot90(a, k=1, axes=(0, 1)):
    return _op("rot90", _as_nd(a), k=k, axes=tuple(axes))


def ravel(a, order="C"):
    return reshape(a, (-1,))


def _seq(seq):
    nds = [s for s in seq if isinstance(s, NDArray)]
    like = nds[0] if nds else None
    return [_as_nd(s, like) if not _onp.isscalar(s) else array(s)
            for s in seq]


def concatenate(seq, axis=0, out=None):
    return _op("concatenate", *_seq(seq), axis=axis, out=out)


concat = concatenate


def stack(seq, axis=0, out=None):
    return _op("stack", *_seq(seq), axis=axis, out=out)


def vstack(seq):
    return concatenate([atleast_2d(s) for s in _seq(seq)], axis=0)


def hstack(seq):
    seq = _seq(seq)
    if seq[0].ndim == 1:
        return concatenate(seq, axis=0)
    return concatenate(seq, axis=1)


def dstack(seq):
    return concatenate([atleast_3d(s) for s in _seq(seq)], axis=2)


def column_stack(seq):
    seq = [s if s.ndim > 1 else s.reshape((-1, 1)) for s in _seq(seq)]
    return concatenate(seq, axis=1)


def split(ary, indices_or_sections, axis=0):
    out = _op("split", _as_nd(ary),
              indices_or_sections=_tup(indices_or_sections), axis=axis)
    return list(out) if isinstance(out, tuple) else [out]


def array_split(ary, indices_or_sections, axis=0):
    out = _op("array_split", _as_nd(ary),
              indices_or_sections=_tup(indices_or_sections), axis=axis)
    return list(out) if isinstance(out, tuple) else [out]


def vsplit(ary, ios):
    return split(ary, ios, 0)


def hsplit(ary, ios):
    return split(ary, ios, 1)


def dsplit(ary, ios):
    return split(ary, ios, 2)


def pad(array_, pad_width, mode="constant", constant_values=0, **kw):
    pw = pad_width
    if isinstance(pw, (list, tuple)):
        pw = tuple(tuple(p) if isinstance(p, (list, tuple)) else p
                   for p in pw)
    return _op("pad", _as_nd(array_), pad_width=pw, mode=mode,
               constant_values=constant_values)


def clip(a, a_min=None, a_max=None, out=None):
    return _op("clip", _as_nd(a), a_min=a_min, a_max=a_max, out=out)


def round(a, decimals=0, out=None):
    return _op("round", _as_nd(a), decimals=decimals, out=out)


around = round
round_ = round


def diag(v, k=0):
    return _op("diag", _as_nd(v), k=k)


def diagonal(a, offset=0, axis1=0, axis2=1):
    return _op("diagonal", _as_nd(a), offset=offset, axis1=axis1,
               axis2=axis2)


def tril(m, k=0):
    return _op("tril", _as_nd(m), k=k)


def triu(m, k=0):
    return _op("triu", _as_nd(m), k=k)


def where(condition, x=None, y=None):
    if x is None and y is None:
        return nonzero(condition)
    c = _as_nd(condition)
    return _op("where", c, _as_nd(x, c), _as_nd(y, c))


def sort(a, axis=-1):
    return _op("sort", _as_nd(a), axis=axis)


def argsort(a, axis=-1):
    return _op("argsort", _as_nd(a), axis=axis)


def searchsorted(a, v, side="left"):
    a = _as_nd(a)
    return _op("searchsorted", a, _as_nd(v, a), side=side)


def take(a, indices, axis=None, mode="clip", out=None):
    a = _as_nd(a)
    return _op("take", a, _as_nd(indices, a), axis=axis, mode=mode, out=out)


def take_along_axis(a, indices, axis=0):
    a = _as_nd(a)
    return _op("take_along_axis", a, _as_nd(indices, a), axis=axis)


def gather_nd(data, indices):
    data = _as_nd(data)
    return _op("gather_nd", data, _as_nd(indices, data))


def pick(data, index, axis=-1, mode="clip", keepdims=False):
    data = _as_nd(data)
    return _op("pick", data, _as_nd(index, data), axis=axis, mode=mode,
               keepdims=keepdims)


def one_hot(indices, depth, on_value=1.0, off_value=0.0, dtype="float32"):
    return _op("one_hot", _as_nd(indices), depth=depth, on_value=on_value,
               off_value=off_value, dtype=_dt(dtype))


def meshgrid(*xi, indexing="xy"):
    out = _op("meshgrid", *[_as_nd(x) for x in xi], indexing=indexing)
    return list(out) if isinstance(out, tuple) else [out]


def bincount(x, weights=None, minlength=0):
    if weights is not None:
        raise NotImplementedError("bincount weights not supported yet")
    return _op("bincount", _as_nd(x), minlength=minlength)


def diff(a, n=1, axis=-1):
    return _op("diff", _as_nd(a), n=n, axis=axis)


def ediff1d(a):
    return _op("ediff1d", _as_nd(a))


def interp(x, xp, fp):
    x = _as_nd(x)
    return _op("interp", x, _as_nd(xp, x), _as_nd(fp, x))


def tensordot(a, b, axes=2):
    if isinstance(axes, (list, tuple)):
        axes = tuple(tuple(x) if isinstance(x, (list, tuple)) else x
                     for x in axes)
    a = _as_nd(a)
    return _op("tensordot", a, _as_nd(b, a), axes=axes)


def einsum(subscripts, *operands, optimize="optimal"):
    return _op("einsum", *[_as_nd(o) for o in operands],
               subscripts=subscripts, optimize=optimize)


def cross(a, b, axis=-1):
    a = _as_nd(a)
    return _op("cross", a, _as_nd(b, a), axis=axis)


def topk(data, k=1, axis=-1, ret_typ="indices", is_ascend=False):
    return _op("topk", _as_nd(data), k=k, axis=axis, ret_typ=ret_typ,
               is_ascend=is_ascend)


# -- dynamic-shape host fallbacks (documented) ------------------------------
def _host_nd(res, like):
    return array(res, ctx=like._data.device)


def unique(ar, return_index=False, return_inverse=False, return_counts=False,
           axis=None):
    ar = _as_nd(ar)
    res = _onp.unique(ar.asnumpy(), return_index=return_index,
                      return_inverse=return_inverse,
                      return_counts=return_counts, axis=axis)
    if isinstance(res, tuple):
        return tuple(_host_nd(r, ar) for r in res)
    return _host_nd(res, ar)


def nonzero(a):
    a = _as_nd(a)
    return tuple(_host_nd(r, a) for r in _onp.nonzero(a.asnumpy()))


def flatnonzero(a, size=None):
    a = _as_nd(a)
    if size is not None:
        return _op("flatnonzero_bounded", a, size=size)
    return _host_nd(_onp.flatnonzero(a.asnumpy()), a)


# -- creation ----------------------------------------------------------------
array = array


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _made(make, ctx=None, device=None, dtype=None):
    """An NDArray of ``make(device)`` on ``device`` or ``ctx`` (None: the
    current context), 64-bit dtypes narrowed."""
    dev = _resolve(device or ctx)
    t = make(dev)
    return NDArray(t if dtype is None else t.to(dtype))


def zeros(shape, dtype="float32", order="C", ctx=None, device=None):
    dt = _canon(dtype) or _torch.float32
    return _made(lambda d: _torch.zeros(_shape(shape), dtype=dt, device=d),
                 ctx, device)


def ones(shape, dtype="float32", order="C", ctx=None, device=None):
    dt = _canon(dtype) or _torch.float32
    return _made(lambda d: _torch.ones(_shape(shape), dtype=dt, device=d),
                 ctx, device)


def _fill_dtype(fill_value):
    if isinstance(fill_value, bool):
        return _torch.bool
    if isinstance(fill_value, (int, _onp.integer)):
        return _torch.int32
    return _torch.float32


def full(shape, fill_value, dtype=None, ctx=None, device=None, out=None):
    if isinstance(fill_value, NDArray):
        fill_value = fill_value.item()
    dt = _canon(dtype) or _fill_dtype(fill_value)
    if out is not None:
        out._set_data(_torch.full(_shape(shape), fill_value, dtype=dt,
                                  device=out._data.device))
        return out
    return _made(lambda d: _torch.full(_shape(shape), fill_value, dtype=dt,
                                       device=d), ctx, device)


def empty(shape, dtype="float32", order="C", ctx=None, device=None):
    return zeros(shape, dtype, order, ctx, device)


def _like(a, ctx):
    a = _as_nd(a)
    return a, (ctx if ctx is not None else a._data.device)


def zeros_like(a, dtype=None, ctx=None):
    a, where_ = _like(a, ctx)
    return zeros(a.shape, dtype or _dname(a._data.dtype), ctx=where_)


def ones_like(a, dtype=None, ctx=None):
    a, where_ = _like(a, ctx)
    return ones(a.shape, dtype or _dname(a._data.dtype), ctx=where_)


def full_like(a, fill_value, dtype=None, ctx=None):
    a, where_ = _like(a, ctx)
    return full(a.shape, fill_value, dtype or _dname(a._data.dtype),
                ctx=where_)


def empty_like(a, dtype=None, ctx=None):
    return zeros_like(a, dtype, ctx)


def arange(start, stop=None, step=1, dtype=None, ctx=None, device=None):
    lo, hi = (0, start) if stop is None else (start, stop)
    ints = _bi.all(isinstance(v, (int, _onp.integer)) for v in (lo, hi, step))
    dt = _canon(dtype) or (_torch.int32 if ints else _torch.float32)
    return _made(lambda d: _torch.arange(
        lo, hi, step, device=d, dtype=None if ints else _torch.float64),
        ctx, device, dt)


def linspace(start, stop, num=50, endpoint=True, retstep=False, dtype=None,
             axis=0, ctx=None, device=None):
    dt = _canon(dtype) or _torch.float32
    n = int(num)
    div = (n - 1) if endpoint else n
    step = (stop - start) / div if div > 0 else float("nan")

    def make(d):
        if endpoint:
            t = _torch.linspace(start, stop, n, device=d,
                                dtype=_torch.float64)
        else:
            t = start + _torch.arange(n, device=d,
                                      dtype=_torch.float64) * step
        return t

    out = _made(make, ctx, device, dt)
    if axis not in (0, None) and out.ndim:
        out = moveaxis(out, 0, axis)
    return (out, float(step)) if retstep else out


def logspace(start, stop, num=50, endpoint=True, base=10.0, dtype=None,
             ctx=None):
    y = linspace(start, stop, num, endpoint=endpoint, dtype="float32",
                 ctx=ctx)
    out = power(base, y)
    return out if dtype is None else out.astype(dtype)


def eye(N, M=None, k=0, dtype="float32", ctx=None, device=None):
    dt = _canon(dtype) or _torch.float32
    m = N if M is None else M

    def make(d):
        ones_ = _torch.ones((N, m), dtype=dt, device=d)
        return _torch.triu(_torch.tril(ones_, k), k)

    return _made(make, ctx, device)


def identity(n, dtype="float32", ctx=None):
    return eye(n, dtype=dtype, ctx=ctx)


def tri(N, M=None, k=0, dtype="float32", ctx=None):
    dt = _canon(dtype) or _torch.float32
    m = N if M is None else M
    return _made(lambda d: _torch.tril(_torch.ones((N, m), dtype=dt,
                                                   device=d), k), ctx)


def indices(dimensions, dtype="int32", ctx=None):
    dims = tuple(dimensions)
    dt = _canon(dtype)

    def make(d):
        grids = _torch.meshgrid(*[_torch.arange(n, device=d) for n in dims],
                                indexing="ij")
        return _torch.stack(grids) if grids else \
            _torch.zeros((0,), dtype=_torch.int64, device=d)

    return _made(make, ctx, None, dt)


def asarray(a, dtype=None):
    if isinstance(a, NDArray) and dtype is None:
        return a
    return array(a, dtype=dtype)


def ascontiguousarray(a, dtype=None):
    return asarray(a, dtype)


def copy(a):
    return _op("copy", _as_nd(a))


def astype(a, dtype):
    return _as_nd(a).astype(dtype)


def may_share_memory(a, b):
    return a is b


def shares_memory(a, b):
    return a is b


def isscalar(x):
    return _onp.isscalar(x)


def ndim(a):
    return a.ndim if isinstance(a, NDArray) else _onp.ndim(a)


def shape(a):
    return _as_nd(a).shape


def size(a, axis=None):
    if axis is None:
        return _as_nd(a).size
    return _as_nd(a).shape[axis]


def result_type(*args):
    dt = None
    for a in args:
        t = a._data if isinstance(a, NDArray) else _torch.as_tensor(a)
        dt = t.dtype if dt is None else _torch.promote_types(dt, t.dtype)
    dt = _canon(dt)
    return dt if dt == _torch.bfloat16 else _onp.dtype(_dname(dt))


def isclose(a, b, rtol=1e-5, atol=1e-8, equal_nan=False):
    a, b = _both_nd(a, b)
    return less_equal(abs(subtract(a, b)),
                      add(atol, multiply(rtol, abs(b))))


def allclose(a, b, rtol=1e-5, atol=1e-8, equal_nan=False):
    return bool(all(isclose(a, b, rtol, atol, equal_nan)).item())


def array_equal(a, b):
    a, b = _both_nd(a, b)
    if a.shape != b.shape:
        return False
    return bool(all(equal(a, b)).item())


def fft(*a, **kw):  # namespace placeholder, as the reference's
    raise TypeError("use np.fft_ functions")


def histogram(a, bins=10, range=None):
    a = _as_nd(a)
    if isinstance(bins, int):
        h, edges = _op("histogram_bounded", a, bins=bins,
                       range=tuple(range) if range else None)
        return h.astype("int32"), edges
    h, edges = _onp.histogram(a.asnumpy(), bins=bins, range=range)
    return _host_nd(h.astype(_onp.int32), a), _host_nd(edges, a)


def index_update(a, key, value):
    """Functional scatter-update (``a.at[key].set(value)``)."""
    a = _as_nd(a)
    return _indexing.index_update(a, key, _as_nd(value, a))


def index_add(a, key, value):
    a = _as_nd(a)
    return _indexing.index_add(a, key, _as_nd(value, a))


# -- extra surface ----------------------------------------------------------
signbit = _def_unary("signbit")
positive = _def_unary("positive")
deg2rad = _def_unary("deg2rad")
rad2deg = _def_unary("rad2deg")
exp2 = _def_unary("exp2")
i0 = _def_unary("i0")
sinc = _def_unary("sinc")


def nan_to_num(x, copy=True, nan=0.0, posinf=None, neginf=None):
    return _op("nan_to_num", _as_nd(x), nan=nan, posinf=posinf,
               neginf=neginf)


heaviside = _def_binary("heaviside")
float_power = _def_binary("float_power")


def divmod(x1, x2):
    a, b = _both_nd(x1, x2)
    return _op("true_divmod", a, b)


def digitize(x, bins, right=False):
    x = _as_nd(x)
    return _op("digitize", x, _as_nd(bins, x), right=right)


def corrcoef(x):
    return _op("corrcoef", _as_nd(x))


def cov(m):
    return _op("cov", _as_nd(m))


def append(arr, values, axis=None):
    a = _as_nd(arr)
    v = _as_nd(values, a) if not _onp.isscalar(values) else \
        array(values, ctx=a._data.device)
    if axis is None:
        return concatenate([a.reshape((-1,)), v.reshape((-1,))], axis=0)
    return concatenate([a, v], axis=axis)


def delete(arr, obj, axis=None):
    a = _as_nd(arr)
    return _host_nd(_onp.delete(a.asnumpy(), obj if not isinstance(
        obj, NDArray) else obj.asnumpy(), axis=axis), a)


def insert(arr, obj, values, axis=None):
    a = _as_nd(arr)
    vals = values.asnumpy() if isinstance(values, NDArray) else values
    return _host_nd(_onp.insert(a.asnumpy(), obj, vals, axis=axis), a)


def trim_zeros(filt, trim="fb"):
    a = _as_nd(filt)
    return _host_nd(_onp.trim_zeros(a.asnumpy(), trim), a)


def count_nonzero(a, axis=None):
    return sum(not_equal(_as_nd(a), 0).astype("int32"), axis=axis)


def _norm_q(q):
    qa = _onp.asarray(q.asnumpy() if isinstance(q, NDArray) else q,
                      dtype="float64")
    return float(qa) if qa.ndim == 0 else tuple(qa.tolist())


def quantile(a, q, axis=None, out=None, overwrite_input=None,
             interpolation="linear", keepdims=False):
    return _op("quantile", _as_nd(a), q=_norm_q(q), axis=_ax(axis),
               method=interpolation or "linear", keepdims=keepdims, out=out)


def percentile(a, q, axis=None, out=None, overwrite_input=None,
               interpolation="linear", keepdims=False):
    return _op("percentile", _as_nd(a), q=_norm_q(q), axis=_ax(axis),
               method=interpolation or "linear", keepdims=keepdims, out=out)


# numpy stragglers over the ops of ops/extra.py (reference :784-820)
def diagflat(v, k=0):
    return _op("diagflat", _as_nd(v), k=k)


def fill_diagonal(a, val, wrap=False):
    """In place, as numpy's: rebinds ``a`` and returns None."""
    if _onp.isscalar(val):
        res = _op("fill_diagonal", _as_nd(a), val=val, wrap=wrap)
    else:
        res = _op("fill_diagonal", _as_nd(a), _as_nd(val), wrap=wrap)
    a._set_data(res._data)


def rollaxis(a, axis, start=0):
    return _op("rollaxis", _as_nd(a), axis=axis, start=start)


def polyval(p, x):
    return _op("polyval", _as_nd(p), _as_nd(x))


def blackman(M, dtype=None, ctx=None):
    return _op("blackman", M=int(M), ctx=ctx)


def hamming(M, dtype=None, ctx=None):
    return _op("hamming", M=int(M), ctx=ctx)


def hanning(M, dtype=None, ctx=None):
    return _op("hanning", M=int(M), ctx=ctx)


def tril_indices(n, k=0, m=None, ctx=None):
    return _op("tril_indices", n=int(n), k=int(k),
               m=int(m) if m is not None else None, ctx=ctx)
