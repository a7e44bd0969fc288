"""Core operators of the port: elementwise, reductions, shape, indexing
gathers, linalg and fft, under the reference's names and attributes.

Counterpart of ``mxnet_tpu/ops/_core.py``, which lowers each op to
``jax.numpy``; here each lowers to the torch function with numpy's
semantics. Where torch and numpy differ, the function here follows numpy
(and the reference): ``median`` averages the two middles, ``argsort`` and
``sort`` are stable, ``take`` clamps (mode ``"clip"``) or wraps, and
``take_along_axis`` wraps indices in [-n, 0) and fills those outside
[-n, n) (NaN for floats, the type's least value for signed integers, its
largest for unsigned ones, True for bool), as ``jnp.take_along_axis``.

A Python scalar operand takes the dtype of the tensor beside it where its
kind allows, as JAX's weak types do: int32 + 2 stays int32, bf16 * 0.5
stays bf16, int32 + 0.5 is float32. Results with 64-bit dtypes are
narrowed by ``invoke`` to the reference's 32-bit ones.
"""
from __future__ import annotations

import numpy as onp
import torch
import torch.nn.functional as F

from ..base import MXNetError, canonical_dtype
from .registry import register, register_alias

_FILL_DT = {torch.bool: True}


def fill_value(dtype):
    """``jnp``'s fill for an index out of range (mode ``"fill"``)."""
    if dtype in _FILL_DT:
        return _FILL_DT[dtype]
    if dtype.is_floating_point or dtype.is_complex:
        return float("nan")
    info = torch.iinfo(dtype)
    return info.max if info.min == 0 else info.min


def wrap_fill_index(idx, n):
    """(index in [0, n), in range): ``idx`` with [-n, 0) wrapped and the
    rest clamped, and the mask of the entries that lay in [-n, n)."""
    i = idx.long()
    i = torch.where(i < 0, i + n, i)
    ok = (i >= 0) & (i < n)
    return i.clamp(0, max(n - 1, 0)), ok


def _weak(v, like):
    """A Python scalar as a 0-d host tensor of ``like``'s dtype where its
    kind fits (JAX's weak typing), else of the default dtype of its kind."""
    if isinstance(v, torch.Tensor):
        return v
    dt = like.dtype
    if isinstance(v, bool):
        tdt = dt
    elif isinstance(v, (int, onp.integer)):
        tdt = torch.int32 if dt == torch.bool else dt
    elif isinstance(v, (float, onp.floating)):
        tdt = dt if dt.is_floating_point or dt.is_complex else torch.float32
    elif isinstance(v, complex):
        tdt = dt if dt.is_complex else torch.complex64
    else:
        return torch.as_tensor(onp.asarray(v), device=like.device)
    return torch.tensor(v, dtype=tdt)


def _bin(f):
    def g(a, b):
        if not isinstance(a, torch.Tensor):
            a = _weak(a, b)
        elif not isinstance(b, torch.Tensor):
            b = _weak(b, a)
        return f(a, b)

    return g


def _float(x):
    return x if x.is_floating_point() or x.is_complex() else \
        x.to(torch.float32)


def _float_unary(f):
    return lambda x: f(_float(x))


def _cbrt(x):
    x = _float(x)
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


def _rounding(f):
    return lambda x: f(x) if x.is_floating_point() else x.clone()


# ---------------------------------------------------------------------------
# elementwise unary — reference :19-73
# ---------------------------------------------------------------------------
_UNARY = {
    "abs": torch.abs,
    "negative": torch.negative,
    "sign": torch.sign,
    "exp": _float_unary(torch.exp),
    "expm1": _float_unary(torch.expm1),
    "log": _float_unary(torch.log),
    "log2": _float_unary(torch.log2),
    "log10": _float_unary(torch.log10),
    "log1p": _float_unary(torch.log1p),
    "sqrt": _float_unary(torch.sqrt),
    "cbrt": _cbrt,
    "square": torch.square,
    "reciprocal": _float_unary(torch.reciprocal),
    "sin": _float_unary(torch.sin),
    "cos": _float_unary(torch.cos),
    "tan": _float_unary(torch.tan),
    "arcsin": _float_unary(torch.arcsin),
    "arccos": _float_unary(torch.arccos),
    "arctan": _float_unary(torch.arctan),
    "sinh": _float_unary(torch.sinh),
    "cosh": _float_unary(torch.cosh),
    "tanh": _float_unary(torch.tanh),
    "arcsinh": _float_unary(torch.arcsinh),
    "arccosh": _float_unary(torch.arccosh),
    "arctanh": _float_unary(torch.arctanh),
    "floor": _rounding(torch.floor),
    "ceil": _rounding(torch.ceil),
    "trunc": _rounding(torch.trunc),
    "rint": _rounding(torch.round),
    "fix": _rounding(torch.trunc),
    "invert": torch.bitwise_not,
    "logical_not": torch.logical_not,
    "isnan": torch.isnan,
    "isinf": torch.isinf,
    "isfinite": torch.isfinite,
    "isposinf": torch.isposinf,
    "isneginf": torch.isneginf,
    "erf": _float_unary(torch.special.erf),
    "erfinv": _float_unary(torch.special.erfinv),
    "gamma": _float_unary(lambda x: torch.exp(torch.lgamma(x))),
    "gammaln": _float_unary(torch.lgamma),
    "sigmoid": _float_unary(torch.sigmoid),
    "relu": torch.relu,
    "softsign": _float_unary(F.softsign),
    "degrees": _float_unary(torch.rad2deg),
    "radians": _float_unary(torch.deg2rad),
    "conj": torch.conj_physical,
    "real": lambda x: torch.real(x).clone(),
    "imag": lambda x: torch.imag(x) if x.is_complex() else
    torch.zeros_like(x),
    "angle": _float_unary(torch.angle),
    "copy": torch.clone,
    # the reference's legacy_elemwise ones_like/zeros_like (:136), which
    # the attention pass's segment ids use
    "ones_like": torch.ones_like,
    "zeros_like": torch.zeros_like,
    "stop_gradient": torch.Tensor.detach,
    # extra numpy-parity unary ops (reference :288-296)
    "signbit": torch.signbit,
    "positive": torch.clone,
    "deg2rad": _float_unary(torch.deg2rad),
    "rad2deg": _float_unary(torch.rad2deg),
    "exp2": _float_unary(torch.exp2),
    "i0": _float_unary(torch.special.i0),
    "sinc": _float_unary(torch.sinc),
}
for _name, _fn in _UNARY.items():
    register(_name, (lambda f: (lambda **a: f))(_fn),
             differentiable=_name != "stop_gradient")


# ---------------------------------------------------------------------------
# elementwise binary — reference :78-128
# ---------------------------------------------------------------------------
def _dot(a, b):
    if a.dim() == 0 or b.dim() == 0:
        return a * b
    return torch.tensordot(a, b, dims=([a.dim() - 1],
                                       [max(b.dim() - 2, 0)]))


def _heaviside(x, h):
    return torch.heaviside(x, h.to(x.dtype))


def _ldexp(x, e):
    return _float(x) * torch.pow(2.0, e.to(torch.float32))


_BINARY = {
    "add": torch.add,
    "subtract": torch.subtract,
    "multiply": torch.multiply,
    "true_divide": torch.true_divide,
    "floor_divide": torch.floor_divide,
    "mod": torch.remainder,
    "fmod": torch.fmod,
    "power": torch.pow,
    "maximum": torch.maximum,
    "minimum": torch.minimum,
    "fmax": torch.fmax,
    "fmin": torch.fmin,
    "hypot": lambda a, b: torch.hypot(_float(a), _float(b)),
    "arctan2": lambda a, b: torch.atan2(_float(a), _float(b)),
    "logaddexp": lambda a, b: torch.logaddexp(_float(a), _float(b)),
    "equal": torch.eq,
    "not_equal": torch.ne,
    "less": torch.lt,
    "less_equal": torch.le,
    "greater": torch.gt,
    "greater_equal": torch.ge,
    "logical_and": torch.logical_and,
    "logical_or": torch.logical_or,
    "logical_xor": torch.logical_xor,
    "bitwise_and": torch.bitwise_and,
    "bitwise_or": torch.bitwise_or,
    "bitwise_xor": torch.bitwise_xor,
    "left_shift": torch.bitwise_left_shift,
    "right_shift": torch.bitwise_right_shift,
    "matmul": torch.matmul,
    "dot": _dot,
    "copysign": lambda a, b: torch.copysign(_float(a), b),
    "gcd": torch.gcd,
    "lcm": torch.lcm,
    "ldexp": _ldexp,
    "nextafter": torch.nextafter,
    "heaviside": _heaviside,
    "float_power": lambda a, b: torch.float_power(a, b),
}
for _name, _fn in _BINARY.items():
    register(_name, (lambda f: (lambda **a: f))(_bin(_fn)))

register("inner", lambda **a: _bin(torch.inner))
register("outer", lambda **a: lambda x, y: torch.outer(x.reshape(-1),
                                                        y.reshape(-1)))
register("vdot", lambda **a: lambda x, y: torch.vdot(x.reshape(-1),
                                                     y.reshape(-1)))
register("kron", lambda **a: torch.kron)
register("cross", lambda axis=-1, **a:
         (lambda x, y: torch.linalg.cross(x, y, dim=axis)))
register("tensordot", lambda axes=2:
         (lambda a, b: torch.tensordot(a, b, dims=axes)))
register("true_divmod", lambda **a: _bin(lambda x, y: (
    torch.floor_divide(x, y), torch.remainder(x, y))))


# ---------------------------------------------------------------------------
# reductions — reference :133-178
# ---------------------------------------------------------------------------
def _dims(axis, x):
    """``axis`` (None, int or tuple) as a tuple of dims of ``x``."""
    if axis is None:
        return tuple(range(x.dim()))
    if isinstance(axis, (tuple, list)):
        return tuple(a % max(x.dim(), 1) for a in axis)
    return (axis % max(x.dim(), 1),)


def _keep(out, x, axis, keepdims):
    """``out`` (reduced over ``axis`` without kept dims) reshaped as
    numpy's ``keepdims=True`` gives it."""
    if not keepdims:
        return out
    dims = _dims(axis, x)
    shape = [1 if i in dims else s for i, s in enumerate(x.shape)]
    return out.reshape(shape)


def _sum(axis=None, keepdims=False, dtype=None, **kw):
    dt = canonical_dtype(dtype)
    return lambda x: torch.sum(x, dim=_dims(axis, x), keepdim=keepdims,
                               dtype=dt)


def _mean(axis=None, keepdims=False, dtype=None, **kw):
    dt = canonical_dtype(dtype)
    return lambda x: torch.mean(x.to(dt) if dt is not None else _float(x),
                                dim=_dims(axis, x), keepdim=keepdims)


def _prod(axis=None, keepdims=False, dtype=None, **kw):
    dt = canonical_dtype(dtype)

    def f(x):
        out = x if dt is None else x.to(dt)
        for d in sorted(_dims(axis, x), reverse=True):
            out = torch.prod(out, dim=d)
        return _keep(out, x, axis, keepdims)

    return f


def _moment(fn):
    def make(axis=None, keepdims=False, dtype=None, ddof=None, **kw):
        return lambda x: fn(_float(x), dim=_dims(axis, x),
                            correction=ddof or 0, keepdim=keepdims)

    return make


def _extreme(fn):
    return lambda axis=None, keepdims=False, **a: (
        lambda x: fn(x, dim=_dims(axis, x), keepdim=keepdims))


def _arg(fn):
    def make(axis=None, keepdims=False, **a):
        def f(x):
            if axis is None:
                out = fn(x.reshape(-1), dim=0)
                return out.reshape([1] * x.dim()) if keepdims else out
            return fn(x, dim=axis, keepdim=keepdims)

        return f

    return make


def _nanext(largest):
    def make(axis=None, keepdims=False, **a):
        def f(x):
            nan = torch.isnan(x)
            fill = float("-inf") if largest else float("inf")
            red = torch.amax if largest else torch.amin
            out = red(torch.where(nan, fill, x), dim=_dims(axis, x),
                      keepdim=keepdims)
            allnan = torch.all(nan, dim=_dims(axis, x), keepdim=keepdims)
            return torch.where(allnan, float("nan"), out)

        return f

    return make


def _median(axis=None, keepdims=False, **a):
    def f(x):
        xf = _float(x)
        if axis is None:
            out = torch.quantile(xf.reshape(-1), 0.5)
        else:
            out = torch.quantile(xf, 0.5, dim=axis)
        return _keep(out, x, axis, keepdims)

    return f


def _cum(fn):
    def make(axis=None, dtype=None):
        dt = canonical_dtype(dtype)

        def f(x):
            if axis is None:
                x = x.reshape(-1)
            return fn(x, dim=0 if axis is None else axis, dtype=dt)

        return f

    return make


def _average(axis=None):
    def f(x, w):
        if w.dim() == 1 and x.dim() > 1 and axis is not None:
            shape = [1] * x.dim()
            shape[axis] = w.shape[0]
            w = w.reshape(shape)
        x, w = _float(x), _float(w)
        w = torch.broadcast_to(w, x.shape)
        return torch.sum(x * w, dim=_dims(axis, x)) / \
            torch.sum(w, dim=_dims(axis, x))

    return f


register("sum", _sum)
register("mean", _mean)
register("prod", _prod)
register("std", _moment(torch.std))
register("var", _moment(torch.var))
register("max", _extreme(torch.amax))
register("min", _extreme(torch.amin))
register("argmax", _arg(torch.argmax), differentiable=False)
register("argmin", _arg(torch.argmin), differentiable=False)
register("all", lambda axis=None, keepdims=False, **a: (
    lambda x: torch.all(x, dim=_dims(axis, x), keepdim=keepdims)))
register("any", lambda axis=None, keepdims=False, **a: (
    lambda x: torch.any(x, dim=_dims(axis, x), keepdim=keepdims)))
register("cumsum", _cum(torch.cumsum))
register("cumprod", _cum(torch.cumprod))
register("logsumexp", lambda axis=None, keepdims=False: (
    lambda x: torch.logsumexp(_float(x), dim=_dims(axis, x),
                              keepdim=keepdims)))
register("nansum", lambda axis=None, keepdims=False, dtype=None, **kw: (
    lambda x: torch.nansum(x, dim=_dims(axis, x), keepdim=keepdims,
                           dtype=canonical_dtype(dtype))))
register("nanmean", lambda axis=None, keepdims=False, dtype=None, **kw: (
    lambda x: torch.nanmean(_float(x), dim=_dims(axis, x),
                            keepdim=keepdims)))
register("nanmax", _nanext(True))
register("nanmin", _nanext(False))
register("median", _median)
register("average", _average)
register("norm", lambda ord=None, axis=None, keepdims=False: (
    lambda x: torch.linalg.norm(_float(x), ord=ord, dim=axis,
                                keepdim=keepdims)))
register("trace", lambda offset=0, axis1=0, axis2=1: (
    lambda x: torch.diagonal(x, offset, axis1, axis2).sum(-1)))


# ---------------------------------------------------------------------------
# shape manipulation — reference :183-245
# ---------------------------------------------------------------------------
def _shape(s):
    return (s,) if isinstance(s, int) else tuple(s)


def _transpose(axes=None):
    return lambda x: x.permute(*(reversed(range(x.dim())) if axes is None
                                 else axes))


def _expand_dims(axis=0):
    def f(x):
        axes = _shape(axis)
        n = x.dim() + len(axes)
        for a in sorted(a % n for a in axes):
            x = x.unsqueeze(a)
        return x

    return f


def _squeeze(axis=None):
    def f(x):
        if axis is None:
            return torch.squeeze(x)
        for a in _shape(axis):
            if x.shape[a] != 1:
                raise ValueError(
                    f"cannot select an axis to squeeze out which has size "
                    f"not equal to one (axis {a} of {tuple(x.shape)})")
        return torch.squeeze(x, dim=_shape(axis))

    return f


def _repeat(repeats=1, axis=None):
    def f(x):
        r = torch.as_tensor(repeats, device=x.device) \
            if isinstance(repeats, (list, tuple)) else repeats
        return torch.repeat_interleave(x, r, dim=axis)

    return f


def _flip(axis=None):
    return lambda x: torch.flip(x, dims=_dims(axis, x))


def _pad_index(n, before, after, mode, device):
    """Source positions of numpy's pad modes along an axis of size n."""
    i = torch.arange(-before, n + after, device=device)
    if mode == "edge":
        return i.clamp(0, n - 1)
    if mode == "wrap":
        return i.remainder(n)
    if mode in ("reflect", "symmetric"):
        if mode == "reflect":
            period = 2 * (n - 1) if n > 1 else 1
            j = i.remainder(period)
            return torch.where(j >= n, period - j, j)
        period = 2 * n
        j = i.remainder(period)
        return torch.where(j >= n, period - 1 - j, j)
    raise MXNetError(f"pad mode {mode!r} is not supported")


def _pad_widths(pad_width, ndim):
    pw = pad_width
    if isinstance(pw, int):
        return [(pw, pw)] * ndim
    pw = tuple(pw)
    if len(pw) and isinstance(pw[0], int):
        pw = (pw,) if len(pw) == 2 else ((pw[0], pw[0]),)
    pw = [tuple(p) if len(p) == 2 else (p[0], p[0]) for p in pw]
    return pw * ndim if len(pw) == 1 else pw


def _pad(pad_width=0, mode="constant", constant_values=0):
    def f(x):
        widths = _pad_widths(pad_width, x.dim())
        if mode == "constant":
            flat = [v for b, a in reversed(widths) for v in (b, a)]
            return F.pad(x, flat, value=constant_values)
        for ax, (b, a) in enumerate(widths):
            if b or a:
                x = torch.index_select(
                    x, ax, _pad_index(x.shape[ax], b, a, mode, x.device))
        return x

    return f


def _split(indices_or_sections=1, axis=0, even=True):
    def f(x):
        ios = indices_or_sections
        if isinstance(ios, int):
            if even and x.shape[axis] % ios:
                raise ValueError(
                    "array split does not result in an equal division")
            return tuple(torch.tensor_split(x, ios, dim=axis))
        return tuple(torch.tensor_split(x, list(ios), dim=axis))

    return f


def _clip(a_min=None, a_max=None):
    return lambda x: torch.clamp(x, a_min, a_max)


def _sort(axis=-1):
    def f(x):
        if axis is None:
            x = x.reshape(-1)
        return torch.sort(x, dim=-1 if axis is None else axis,
                          stable=True).values

    return f


def _argsort(axis=-1):
    def f(x):
        if axis is None:
            x = x.reshape(-1)
        return torch.argsort(x, dim=-1 if axis is None else axis,
                             stable=True)

    return f


def _topk(k=1, axis=-1, ret_typ="indices", is_ascend=False):
    def f(x):
        vals, idx = torch.topk(x, k, dim=axis, largest=not is_ascend,
                               sorted=True)
        if ret_typ == "indices":
            return idx
        if ret_typ == "value":
            return vals
        return (vals, idx)

    return f


def _take(axis=None, mode="clip"):
    def f(x, idx):
        ax = axis
        if ax is None:
            x, ax = x.reshape(-1), 0
        ax = ax % x.dim()
        n = x.shape[ax]
        if mode in ("clip", "raise"):
            i, ok = idx.long().clamp(0, n - 1), None
        elif mode == "wrap":
            i, ok = idx.long().remainder(n), None
        elif mode == "fill":
            i, ok = wrap_fill_index(idx, n)
        else:
            raise MXNetError(f"take: unknown mode {mode!r}")
        out = torch.index_select(x, ax, i.reshape(-1)).reshape(
            x.shape[:ax] + idx.shape + x.shape[ax + 1:])
        if ok is not None:
            shape = [1] * ax + list(idx.shape) + [1] * (x.dim() - ax - 1)
            out = torch.where(ok.reshape(shape), out, fill_value(out.dtype))
        return out

    return f


def take_along_axis(x, idx, axis):
    """``jnp.take_along_axis`` with its default mode: ``idx`` broadcast
    against ``x`` off ``axis``, [-n, 0) wrapped, entries outside [-n, n)
    filled (:func:`fill_value`). No host sync and no data-dependent shape."""
    ax = axis % x.dim()
    n = x.shape[ax]
    xs, js = list(x.shape), list(idx.shape)
    bshape = [max(a, b) for a, b in zip(xs, js)]
    xs_b, js_b = list(bshape), list(bshape)
    xs_b[ax], js_b[ax] = xs[ax], js[ax]
    i, ok = wrap_fill_index(idx.expand(js_b), n)
    out = torch.gather(x.expand(xs_b), ax, i)
    return torch.where(ok, out, fill_value(out.dtype))


def _gather_nd(data, indices):
    idx = tuple(indices[i].long() for i in range(indices.shape[0]))
    return data[idx]


def _one_hot(depth=1, on_value=1.0, off_value=0.0, dtype="float32"):
    dt = canonical_dtype(dtype)

    def f(idx):
        ar = torch.arange(depth, device=idx.device)
        hot = (idx.long().unsqueeze(-1) == ar).to(dt)
        return hot * (on_value - off_value) + off_value

    return f


def _interp(x, xp, fp):
    x, xp, fp = _float(x), _float(xp), _float(fp)
    i = torch.searchsorted(xp, x.contiguous(), right=True).clamp(
        1, xp.shape[0] - 1)
    x0, x1, y0, y1 = xp[i - 1], xp[i], fp[i - 1], fp[i]
    y = y0 + (x - x0) / (x1 - x0) * (y1 - y0)
    y = torch.where(x <= xp[0], fp[0], y)
    return torch.where(x >= xp[-1], fp[-1], y)


def _ravel_multi_index(shape=None):
    def f(multi):
        out = torch.zeros_like(multi[0]).long()
        for row, dim in zip(multi, shape):
            out = out * dim + row.long().clamp(0, dim - 1)
        return out

    return f


def _bincount(minlength=0, length=None):
    def f(x):
        if length is None:
            return torch.bincount(x.reshape(-1).long(), minlength=minlength)
        x = x.reshape(-1).long()
        x = x[(x >= 0) & (x < length)]
        return torch.bincount(x, minlength=length)[:length]

    return f


def _flatnonzero_bounded(size=None):
    def f(x):
        nz = torch.nonzero(x.reshape(-1)).reshape(-1)[:size]
        pad = torch.full((size - nz.shape[0],), -1, dtype=nz.dtype,
                         device=nz.device)
        return torch.cat([nz, pad])

    return f


register("reshape", lambda newshape=None, **a:
         (lambda x: torch.reshape(x, _shape(newshape))))
register("transpose", _transpose)
register("swapaxes", lambda axis1=0, axis2=1:
         (lambda x: torch.swapaxes(x, axis1, axis2)))
register("moveaxis", lambda source=0, destination=0:
         (lambda x: torch.movedim(x, source, destination)))
register("squeeze", _squeeze)
register("expand_dims", _expand_dims)
register("broadcast_to", lambda shape=None:
         (lambda x: torch.broadcast_to(x, _shape(shape))))
register("tile", lambda reps=1: (lambda x: torch.tile(x, _shape(reps))))
register("repeat", _repeat)
register("flip", _flip)
register("roll", lambda shift=0, axis=None:
         (lambda x: torch.roll(x, shift, axis)))
register("rot90", lambda k=1, axes=(0, 1):
         (lambda x: torch.rot90(x, k, axes)))
register("astype", lambda dtype="float32":
         (lambda x: x.to(canonical_dtype(dtype))))
register("flatten", lambda **a: (lambda x: x.reshape(x.shape[0], -1)))
register("clip", _clip)
register("round", lambda decimals=0: _rounding(
    lambda x: torch.round(x, decimals=decimals)))
register("diag", lambda k=0: (lambda x: torch.diag(x, k)))
register("diagonal", lambda offset=0, axis1=0, axis2=1:
         (lambda x: torch.diagonal(x, offset, axis1, axis2)))
register("tril", lambda k=0: (lambda x: torch.tril(x, k)))
register("triu", lambda k=0: (lambda x: torch.triu(x, k)))
register("pad", _pad)
register("concatenate", lambda axis=0: (
    lambda *xs: torch.cat([x.reshape(-1) for x in xs]) if axis is None
    else torch.cat(xs, dim=axis)))
register("stack", lambda axis=0: (lambda *xs: torch.stack(xs, dim=axis)))
register("split", lambda indices_or_sections=1, axis=0:
         _split(indices_or_sections, axis))
register("array_split", lambda indices_or_sections=1, axis=0:
         _split(indices_or_sections, axis, even=False))
register("atleast_1d", lambda **a: torch.atleast_1d)
register("atleast_2d", lambda **a: torch.atleast_2d)
register("atleast_3d", lambda **a: torch.atleast_3d)
register("where", lambda **a: (
    lambda c, x, y: torch.where(c.bool(), *_where_pair(x, y))))
register_alias("_npi_where", "where")
register_alias("_npi_ones_like", "ones_like")
register("searchsorted", lambda side="left": (
    lambda a, v: torch.searchsorted(a, v.contiguous(), side=side)),
    differentiable=False)
register("sort", _sort)
register("argsort", _argsort, differentiable=False)
register("topk", _topk)
register("take", _take)
register("take_along_axis", lambda axis=0:
         (lambda x, idx: take_along_axis(x, idx, axis)))
register("gather_nd", lambda **a: _gather_nd)
register("one_hot", _one_hot, differentiable=False)
register("interp", lambda **a: _interp)
register("unravel_index", lambda shape=None: (
    lambda idx: torch.stack(torch.unravel_index(idx.long(), _shape(shape)))),
    differentiable=False)
register("ravel_multi_index", _ravel_multi_index, differentiable=False)
register("meshgrid", lambda indexing="xy":
         (lambda *xs: tuple(torch.meshgrid(*xs, indexing=indexing))))
register("bincount", _bincount, differentiable=False)
register("diff", lambda n=1, axis=-1: (lambda x: torch.diff(x, n, axis)))
register("ediff1d", lambda **a: (lambda x: torch.diff(x.reshape(-1))))
register("flatnonzero_bounded", _flatnonzero_bounded, differentiable=False)
register("tril_indices_from", lambda k=0: (
    lambda x: torch.tril_indices(x.shape[0], x.shape[1], offset=k,
                                 device=x.device)),
    differentiable=False)


def _where_pair(x, y):
    if not isinstance(x, torch.Tensor) and not isinstance(y, torch.Tensor):
        return x, y
    if not isinstance(x, torch.Tensor):
        x = _weak(x, y)
    elif not isinstance(y, torch.Tensor):
        y = _weak(y, x)
    return x, y


# ---------------------------------------------------------------------------
# linalg — reference :262-284
# ---------------------------------------------------------------------------
def _lstsq(rcond=None):
    def f(a, b):
        x = torch.linalg.pinv(a) @ b
        rank = torch.linalg.matrix_rank(a)
        s = torch.linalg.svdvals(a)
        m, n = a.shape
        if int(rank) == n and m > n:
            r = b - a @ x
            res = (r * r).sum(0)
            res = res.reshape(1) if b.dim() == 1 else res
        else:
            res = torch.zeros((0,), dtype=a.dtype, device=a.device)
        return (x, res, rank, s)

    return f


_LINALG = {
    "linalg_inv": torch.linalg.inv,
    "linalg_pinv": torch.linalg.pinv,
    "linalg_det": torch.linalg.det,
    "linalg_cholesky": torch.linalg.cholesky,
    "linalg_eigh": lambda x: tuple(torch.linalg.eigh(x)),
    "linalg_eigvalsh": torch.linalg.eigvalsh,
    "linalg_matrix_rank": torch.linalg.matrix_rank,
}
for _name, _fn in _LINALG.items():
    register(_name, (lambda f: (lambda **a: f))(_fn))

register("linalg_svd", lambda full_matrices=True, compute_uv=True: (
    (lambda x: tuple(torch.linalg.svd(x, full_matrices=full_matrices)))
    if compute_uv else torch.linalg.svdvals))
register("linalg_qr", lambda mode="reduced":
         (lambda x: tuple(torch.linalg.qr(x, mode=mode))))
register("linalg_slogdet", lambda **a:
         (lambda x: tuple(torch.linalg.slogdet(x))))
register("linalg_solve", lambda **a: torch.linalg.solve)
register("linalg_lstsq", _lstsq)
register("linalg_matrix_power", lambda n=1:
         (lambda x: torch.linalg.matrix_power(x, n)))
register("linalg_multi_dot", lambda **a:
         (lambda *xs: torch.linalg.multi_dot(list(xs))))
register("linalg_tensorsolve", lambda axes=None:
         (lambda a, b: torch.linalg.tensorsolve(a, b, dims=axes)))
register("linalg_tensorinv", lambda ind=2:
         (lambda x: torch.linalg.tensorinv(x, ind=ind)))
register("einsum", lambda subscripts="", optimize="optimal":
         (lambda *xs: torch.einsum(subscripts, *xs)))

# fft — reference :286-290
register("fft", lambda n=None, axis=-1:
         (lambda x: torch.fft.fft(x, n, axis)))
register("ifft", lambda n=None, axis=-1:
         (lambda x: torch.fft.ifft(x, n, axis)))
register("rfft", lambda n=None, axis=-1:
         (lambda x: torch.fft.rfft(_float(x), n, axis)))
register("irfft", lambda n=None, axis=-1:
         (lambda x: torch.fft.irfft(x, n, axis)))


# extra numpy-parity ops — reference :297-351
def _digitize(right=False):
    return lambda x, bins: torch.searchsorted(
        bins, x.contiguous(), side="left" if right else "right")


def _histogram(bins=10, range=None):  # noqa: A002 — the reference's name
    def f(x):
        xf = _float(x)
        if range is None:
            lo, hi = float(xf.min()), float(xf.max())
        else:
            lo, hi = float(range[0]), float(range[1])
        if lo == hi:
            lo, hi = lo - 0.5, hi + 0.5
        edges = torch.linspace(lo, hi, bins + 1, device=x.device,
                               dtype=xf.dtype)
        hist = torch.histc(xf, bins, lo, hi)
        return hist, edges

    return f


def _quantile(scale):
    def make(q=0.5, axis=None, keepdims=False, method="linear"):
        def quant(xf, qt, how):
            if axis is None:
                out = torch.quantile(xf.reshape(-1), qt, interpolation=how)
                return out.reshape(qt.shape + (1,) * xf.dim()) \
                    if keepdims else out
            return torch.quantile(xf, qt, dim=axis, keepdim=keepdims,
                                  interpolation=how)

        def f(x):
            qt = torch.as_tensor(q, dtype=torch.float32,
                                 device=x.device) / scale
            xf = _float(x)
            if method != "nearest":
                return quant(xf, qt, method)
            # JAX's "nearest" takes the lower neighbour at a tie (numpy's
            # and torch's round half to even)
            n = xf.numel() if axis is None else xf.shape[axis]
            pos = qt * (n - 1)
            low = (pos - torch.floor(pos)) <= 0.5
            low = low.reshape(low.shape + (1,) * (quant(xf, qt, "lower").dim()
                                                  - low.dim()))
            return torch.where(low, quant(xf, qt, "lower"),
                               quant(xf, qt, "higher"))

        return f

    return make


register("nan_to_num", lambda nan=0.0, posinf=None, neginf=None: (
    lambda x: torch.nan_to_num(x, nan=nan, posinf=posinf, neginf=neginf)))
register("digitize", _digitize, differentiable=False)
register("histogram_bounded", _histogram, differentiable=False)
register("corrcoef", lambda **a: lambda x: torch.corrcoef(_float(x)))
register("cov", lambda **a: lambda x: torch.cov(_float(x)))
register("quantile", _quantile(1.0))
register("percentile", _quantile(100.0))


def last_wins(idx, n):
    """For each position of ``idx`` (values in [0, n)), the position of the
    last entry with the same value: gathering a per-entry source through it
    makes every duplicate write the last one's value, whatever order the
    device scatters in. On the device, no host read."""
    pos = torch.arange(idx.numel(), device=idx.device)
    last = torch.full((n,), -1, dtype=pos.dtype, device=idx.device)
    last.scatter_reduce_(0, idx.long(), pos, reduce="amax")
    return last[idx.long()]
