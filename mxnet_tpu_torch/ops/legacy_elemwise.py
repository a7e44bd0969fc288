"""Legacy scalar, strict-elementwise, creation and slice op families.

Counterpart of ``mxnet_tpu/ops/legacy_elemwise.py``: the reference op names
whose signature differs from the numpy-surface ops, in plain torch:

- the ``_*_scalar`` families, with the scalar a static attribute; a Python
  scalar takes the tensor's dtype where its kind allows, as JAX's weak
  types do (``_core._bin``): int32 + 1.5 is float32, bf16 * 1.7 multiplies
  by bf16(1.7). The comparisons give 0/1 in the input's dtype;
- the identity ops with a backward of their own (``MakeLoss``,
  ``gradientmultiplier``, ``IdentityAttachKLSparseReg``), each a
  ``torch.autograd.Function``;
- the creation ops. They have no operand to take a device from: each
  resolves ``ctx`` (None: the current context) when it is called, never
  when its function is made, since ``Op.fn`` caches one function per set
  of attributes;
- the legacy slice family, ``Reshape`` with its 0/-1/-2/-3/-4 codes and
  ``_npx_reshape`` with its own, ``SliceChannel`` and the splits;
- the assignments (``_slice_assign``, ``_scatter_set_nd``, ...), which
  return a new tensor and leave their input as it was, as the reference's
  ``.at[].set`` does;
- the multi-tensor helpers, ``histogram`` (device-side: no
  ``torch.histogram``, which is CPU-only), ``index_array`` and the legacy
  NN extras ``LRN``, ``SoftmaxActivation``, ``BatchNormWithReLU`` and
  ``SyncBatchNorm``.

``_contrib_dynamic_reshape`` reads its shape operand on the host, so it is
eager only (``eager_only``): inside a compiled program it raises.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..base import MXNetError, canonical_dtype
from ..context import resolve_device
from ._core import _BINARY, _bin, _cbrt, _float, _prod, _weak
from ._core import _shape as _shp
from .random_ops import _dt
from .registry import get_op, register, register_alias

# ---------------------------------------------------------------------------
# binary-with-scalar family (reference :30-115)
# ---------------------------------------------------------------------------
_add, _sub, _mul, _div = (_bin(_BINARY[n]) for n in
                          ("add", "subtract", "multiply", "true_divide"))
_mod, _pow, _max, _min = (_bin(_BINARY[n]) for n in
                          ("mod", "power", "maximum", "minimum"))
_fmax, _fmin, _fmod, _copysign = (_bin(_BINARY[n]) for n in
                                  ("fmax", "fmin", "fmod", "copysign"))
_atan2 = _bin(_BINARY["arctan2"])


def _like(s, x):
    """``jnp.asarray(s, x.dtype)``: the scalar in ``x``'s dtype (an
    integer dtype truncates it), as a 0-d host tensor."""
    return torch.tensor(s, dtype=x.dtype)


def _hypot_scalar(x, s):
    """``jnp.hypot(x, jnp.asarray(s, x.dtype))`` by its formula, ``max *
    sqrt(1 + (min / max)^2)`` in x's (inexact) dtype, so that bf16 rounds
    where the reference's does."""
    c = abs(float(_like(s, x)))
    x = _float(x).abs()
    y = torch.full_like(x, c)
    hi, lo = torch.maximum(x, y), torch.minimum(x, y)
    out = torch.where(hi == 0, hi, hi * torch.sqrt(1 + torch.square(
        lo / torch.where(hi == 0, torch.ones_like(hi), hi))))
    return torch.where(torch.isposinf(hi), hi, out)


_SCALAR_OPS = {
    "_plus_scalar": _add,
    "_minus_scalar": _sub,
    "_rminus_scalar": lambda x, s: _sub(s, x),
    "_mul_scalar": _mul,
    "_div_scalar": _div,
    "_rdiv_scalar": lambda x, s: _div(s, x),
    "_mod_scalar": _mod,
    "_rmod_scalar": lambda x, s: _mod(s, x),
    "_power_scalar": _pow,
    # the base as a Python number of its weak dtype: pow's backward computes
    # with its base, which a host tensor cannot be beside a CUDA exponent
    "_rpower_scalar": lambda x, s: torch.pow(_weak(s, x).item(), x),
    "_maximum_scalar": _max,
    "_minimum_scalar": _min,
    "_hypot_scalar": _hypot_scalar,
    "_npi_copysign_scalar": _copysign,
    "_npi_rcopysign_scalar": lambda x, s: _copysign(_like(s, x), x),
    "_npi_arctan2_scalar": lambda x, s: _atan2(x, _like(s, x)),
    "_npi_rarctan2_scalar": lambda x, s: _atan2(_like(s, x), x),
    "_npi_fmax_scalar": _fmax,
    "_npi_fmin_scalar": _fmin,
    "_npi_fmod_scalar": _fmod,
    "_npi_rfmod_scalar": lambda x, s: _fmod(_like(s, x), x),
    "_npi_ldexp_scalar": lambda x, s: _float(x) * (2.0 ** int(s)),
    "_npi_rldexp_scalar": lambda x, s: torch.ldexp(
        torch.full(x.shape, s, dtype=torch.float32, device=x.device),
        x.to(torch.int32)),
}
for _name, _fn2 in _SCALAR_OPS.items():
    register(_name,
             (lambda f: (lambda scalar=0.0, is_int=False, **a:
                         (lambda x: f(x, scalar))))(_fn2))

_SCALAR_INT_OPS = {
    "_npi_gcd_scalar": torch.gcd,
    "_npi_lcm_scalar": torch.lcm,
    "_npi_bitwise_and_scalar": torch.bitwise_and,
    "_npi_bitwise_or_scalar": torch.bitwise_or,
    "_npi_bitwise_xor_scalar": torch.bitwise_xor,
}
for _name, _fn2 in _SCALAR_INT_OPS.items():
    # the scalar filled on x's device: gcd and lcm take no host operand
    register(_name,
             (lambda f: (lambda scalar=0, is_int=True, **a:
                         (lambda x: f(x, torch.full_like(x, int(scalar))))))(
                 _fn2),
             differentiable=False)


def _logical(kind):
    """``jnp.logical_*(x, s)`` with ``s`` static: its truth decides."""
    def make(x, s):
        nz = x != 0
        if kind == "and":
            return nz if s else torch.zeros_like(nz)
        if kind == "or":
            return torch.ones_like(nz) if s else nz
        return ~nz if s else nz

    return make


# the comparisons give the input's dtype as 0/1, not bool, and carry no
# gradient (reference :81-97)
_SCALAR_CMP = {
    "_equal_scalar": _bin(torch.eq),
    "_not_equal_scalar": _bin(torch.ne),
    "_greater_scalar": _bin(torch.gt),
    "_greater_equal_scalar": _bin(torch.ge),
    "_lesser_scalar": _bin(torch.lt),
    "_lesser_equal_scalar": _bin(torch.le),
    "_logical_and_scalar": _logical("and"),
    "_logical_or_scalar": _logical("or"),
    "_logical_xor_scalar": _logical("xor"),
}
for _name, _fn2 in _SCALAR_CMP.items():
    register(_name,
             (lambda f: (lambda scalar=0.0, is_int=False, **a:
                         (lambda x: f(x, scalar).to(x.dtype))))(_fn2),
             differentiable=False)

for _alias, _tgt in {
    "_npi_add_scalar": "_plus_scalar",
    "_npi_subtract_scalar": "_minus_scalar",
    "_npi_rsubtract_scalar": "_rminus_scalar",
    "_npi_multiply_scalar": "_mul_scalar",
    "_npi_true_divide_scalar": "_div_scalar",
    "_npi_rtrue_divide_scalar": "_rdiv_scalar",
    "_npi_mod_scalar": "_mod_scalar",
    "_npi_rmod_scalar": "_rmod_scalar",
    "_npi_power_scalar": "_power_scalar",
    "_npi_rpower_scalar": "_rpower_scalar",
}.items():
    register_alias(_alias, _tgt)


register("_npi_where_lscalar", lambda scalar=0.0, **a:
         (lambda cond, rhs: torch.where(cond.bool(), scalar, rhs)))
register("_npi_where_rscalar", lambda scalar=0.0, **a:
         (lambda cond, lhs: torch.where(cond.bool(), lhs, scalar)))
register("_npi_where_scalar2", lambda x=0.0, y=0.0, **a:
         (lambda cond: torch.where(cond.bool(), float(x), float(y)).to(
             torch.float32)),
         differentiable=False)

# ---------------------------------------------------------------------------
# unary extras (reference :129-139); ones_like/zeros_like are _core's
# ---------------------------------------------------------------------------
register("reciprocal_sqrt", lambda **a: torch.rsqrt)
register("rcbrt", lambda **a: (lambda x: 1.0 / _cbrt(x)))
register("digamma", lambda **a: (lambda x: torch.special.digamma(_float(x))))
register("hard_sigmoid", lambda alpha=0.2, beta=0.5:
         (lambda x: torch.clamp(alpha * x + beta, 0.0, 1.0)))


def _nanprod(axis=None, keepdims=False, **a):
    prod = _prod(axis, keepdims)
    return lambda x: prod(torch.where(torch.isnan(x), torch.ones_like(x), x))


register("nanprod", _nanprod)
register_alias("_npi_zeros_like", "zeros_like")


# ---------------------------------------------------------------------------
# identities with a backward of their own (reference :142-196)
# ---------------------------------------------------------------------------
class _MakeLoss(torch.autograd.Function):
    """Identity forward; the backward seeds ``grad_scale`` whatever
    gradient arrives (src/operator/make_loss.cc)."""

    @staticmethod
    def forward(ctx, x, grad_scale):
        ctx.grad_scale = grad_scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return torch.full_like(g, ctx.grad_scale), None


class _GradMult(torch.autograd.Function):
    """Identity forward, gradient times ``scalar`` (reversal when < 0)."""

    @staticmethod
    def forward(ctx, x, scalar):
        ctx.scalar = scalar
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scalar, None


class _KLSparseReg(torch.autograd.Function):
    """Identity forward; the backward adds the gradient of the KL sparsity
    penalty of the batch mean ``rho`` (clipped to [1e-6, 1 - 1e-6]):
    ``penalty * (-t / rho + (1 - t) / (1 - rho))``."""

    @staticmethod
    def forward(ctx, x, t, penalty):
        ctx.save_for_backward(torch.clamp(torch.mean(x), 1e-6, 1 - 1e-6))
        ctx.t, ctx.penalty = t, penalty
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        (rho,) = ctx.saved_tensors
        t = ctx.t
        return g + ctx.penalty * (-t / rho + (1 - t) / (1 - rho)), None, None


register("make_loss", lambda grad_scale=1.0, **a:
         (lambda x: _MakeLoss.apply(x, grad_scale)))
register_alias("MakeLoss", "make_loss")
register("gradientmultiplier", lambda scalar=1.0, **a:
         (lambda x: _GradMult.apply(x, scalar)))
register_alias("_contrib_gradientmultiplier", "gradientmultiplier")
register("IdentityAttachKLSparseReg",
         lambda sparseness_target=0.1, penalty=0.001, momentum=0.9, **a:
         (lambda x: _KLSparseReg.apply(x, sparseness_target, penalty)))

register("_grad_add", lambda **a: _add)
register("add_n", lambda num_args=0, **a: (lambda *xs: sum(xs[1:], xs[0])))
register_alias("ElementWiseSum", "add_n")
register("_identity_with_attr_like_rhs", lambda **a:
         (lambda lhs, rhs: lhs.clone()), differentiable=False)


def _constraint_check(msg="constraint violated", **a):
    """``all(x)``; raises ``msg`` when it is False, where it runs eagerly.
    Inside a compiled program the flag flows to the caller unread, as the
    reference's under ``jit``."""
    from ..cached_op import is_inlined

    def f(x):
        ok = torch.all(x)
        if not is_inlined() and not bool(ok):
            raise MXNetError(msg)
        return ok

    return f


register("_npx_constraint_check", _constraint_check, differentiable=False)


def _div_sqrt_dim(**a):
    def f(x):
        # the square root of the last dim in x's dtype (bf16 rounds it), as
        # the reference's jnp.sqrt(jnp.asarray(d, x.dtype))
        d = torch.tensor(x.shape[-1], dtype=x.dtype if x.is_floating_point()
                         else torch.float32)
        return x / torch.sqrt(d)

    return f


register("div_sqrt_dim", _div_sqrt_dim)
register_alias("_contrib_div_sqrt_dim", "div_sqrt_dim")


# ---------------------------------------------------------------------------
# creation ops (reference :227-290): the device resolves at each call
# ---------------------------------------------------------------------------
register("zeros", lambda shape=(), dtype="float32", ctx=None, **a:
         (lambda: torch.zeros(_shp(shape), dtype=_dt(dtype),
                              device=resolve_device(ctx))),
         differentiable=False)
register("ones", lambda shape=(), dtype="float32", ctx=None, **a:
         (lambda: torch.ones(_shp(shape), dtype=_dt(dtype),
                             device=resolve_device(ctx))),
         differentiable=False)
register("full", lambda shape=(), value=0.0, dtype="float32", ctx=None, **a:
         (lambda: torch.full(_shp(shape), value, dtype=_dt(dtype),
                             device=resolve_device(ctx))),
         differentiable=False)
register("full_like", lambda fill_value=0.0, dtype=None, **a:
         (lambda x: torch.full_like(
             x, fill_value, dtype=canonical_dtype(dtype) or x.dtype)),
         differentiable=False)


def _eye(n, m, k, dtype, device):
    rows = torch.arange(n, device=device).unsqueeze(1)
    cols = torch.arange(m, device=device).unsqueeze(0)
    return (cols - rows == k).to(dtype)


register("eye", lambda N=1, M=None, k=0, dtype="float32", ctx=None, **a:
         (lambda: _eye(int(N), int(N if M is None else M), int(k),
                       _dt(dtype), resolve_device(ctx))),
         differentiable=False)


def _make_npi_identity(shape=None, n=None, dtype="float32", ctx=None, **a):
    # the frontend passes shape=(n, n) (np_init_op.cc IdentityParam)
    if n is None:
        n = shape[0] if shape else 1
    return lambda: _eye(int(n), int(n), 0, _dt(dtype), resolve_device(ctx))


register("_npi_identity", _make_npi_identity, differentiable=False)


def _make_arange(start=0, stop=None, step=1.0, repeat=1, dtype="float32",
                 ctx=None, infer_range=False, **a):
    """The legacy contract (init_op.cc RangeParam): ``arange(N)`` is
    [0, N). The values are numpy's ``arange`` (the reference's): the
    first two in double, the rest ``first + i * (second - first)`` in the
    dtype, so a fractional step rounds as numpy's does."""
    lo, hi = (0, start) if stop is None else (start, stop)
    n = max(0, math.ceil((hi - lo) / step))
    dt = _dt(dtype)

    def f():
        dev = resolve_device(ctx)
        if not dt.is_floating_point:
            out = torch.arange(int(lo), int(lo) + n * int(step), int(step),
                               dtype=dt, device=dev)
        else:
            first = torch.tensor(lo, dtype=dt)
            second = torch.tensor(lo + step, dtype=dt)
            i = torch.arange(n, dtype=dt, device=dev)
            out = i * (second - first) + first
            if n > 1:
                out[1] = second.item()
        return torch.repeat_interleave(out, repeat) if repeat != 1 else out

    return f


register("arange", _make_arange, differentiable=False)


def _linspace(start, stop, num, endpoint, dtype, device):
    """``jnp.linspace``'s formula: ``start * (1 - s) + stop * s`` with
    ``s = i / div`` in the computation dtype, the end point appended.
    ``start``/``stop`` are numbers or 0-d tensors."""
    ct = dtype if dtype.is_floating_point else torch.float32
    start, stop = (v.to(ct) if isinstance(v, torch.Tensor) else
                   torch.full((), v, dtype=ct, device=device)
                   for v in (start, stop))
    div = num - 1 if endpoint else num
    if num > 1:
        # over a device tensor: CUDA divides by a host scalar as a multiply
        # by its reciprocal, which rounds otherwise
        step = torch.arange(div, dtype=ct, device=device) / \
            torch.full((), div, dtype=ct, device=device)
        out = start * (1 - step) + stop * step
        if endpoint:
            out = torch.cat([out, stop.reshape(1)])
    else:
        out = start.reshape(1)[:num]
    if not dtype.is_floating_point:
        out = torch.floor(out)
    return out.to(dtype)


register("linspace", lambda start=0.0, stop=1.0, num=50, endpoint=True,
         dtype="float32", ctx=None, **a:
         (lambda: _linspace(start, stop, int(num), endpoint, _dt(dtype),
                            resolve_device(ctx))),
         differentiable=False)


def _logspace(start=0.0, stop=1.0, num=50, endpoint=True, base=10.0,
              dtype="float32", ctx=None, **a):
    dt = _dt(dtype)

    def f():
        dev = resolve_device(ctx)
        lin = _linspace(start, stop, int(num), endpoint, torch.float32, dev)
        return torch.pow(base, lin).to(dt)

    return f


register("logspace", _logspace, differentiable=False)
register("tri", lambda N=1, M=None, k=0, dtype="float32", ctx=None, **a:
         (lambda: torch.tril(torch.ones(
             int(N), int(N if M is None else M), dtype=_dt(dtype),
             device=resolve_device(ctx)), int(k))),
         differentiable=False)


def _indices(dims, dtype, device):
    dims = _shp(dims)
    if not dims:
        return torch.zeros((0,), dtype=dtype, device=device)
    grids = torch.meshgrid(*[torch.arange(d, dtype=dtype, device=device)
                             for d in dims], indexing="ij")
    return torch.stack(grids)


register("indices", lambda dimensions=(), dtype="int32", ctx=None, **a:
         (lambda: _indices(dimensions, _dt(dtype, torch.int32),
                           resolve_device(ctx))),
         differentiable=False)
for _alias, _tgt in {
    "_zeros": "zeros", "_zeros_without_dtype": "zeros", "_ones": "ones",
    "_full": "full", "_eye": "eye", "_arange": "arange",
    "_linspace": "linspace",
    "_npi_zeros": "zeros", "_npi_ones": "ones", "_npi_full": "full",
    "_npi_full_like": "full_like", "_npi_eye": "eye",
    "_npi_arange": "arange",
    "_npi_linspace": "linspace", "_npi_logspace": "logspace",
    "_npi_tri": "tri", "_npi_indices": "indices",
}.items():
    register_alias(_alias, _tgt)

# ---------------------------------------------------------------------------
# stack and split variants (reference :302-310)
# ---------------------------------------------------------------------------
register("hstack", lambda **a: (lambda *xs: torch.hstack(xs)))
register("vstack", lambda **a: (lambda *xs: torch.vstack(xs)))
register("dstack", lambda **a: (lambda *xs: torch.dstack(xs)))
register("column_stack", lambda **a: (lambda *xs: torch.column_stack(xs)))


def _sections(ios):
    return ios if isinstance(ios, int) else list(ios)


register("hsplit", lambda indices_or_sections=1, **a:
         (lambda x: tuple(torch.hsplit(x, _sections(indices_or_sections)))))
register("dsplit", lambda indices_or_sections=1, **a:
         (lambda x: tuple(torch.dsplit(x, _sections(indices_or_sections)))))
for _alias, _tgt in {
    "_npi_hstack": "hstack", "_npi_vstack": "vstack",
    "_npi_dstack": "dstack", "_npi_column_stack": "column_stack",
    "_npi_hsplit": "hsplit", "_npi_dsplit": "dsplit",
}.items():
    register_alias(_alias, _tgt)


# ---------------------------------------------------------------------------
# the legacy slice family (reference :320-390)
# ---------------------------------------------------------------------------
def _norm_be(b, e, s, dim):
    """One (begin, end, step) triple as the reference's Python slice."""
    s = 1 if s in (None, 0) else s
    if b is not None and b < 0:
        b += dim
    if e is not None and e < 0:
        e += dim
    return slice(b, e, s)


def _legacy_slices(begin, end, step, shape):
    """Per sliced axis, a slice of positive step over the elements the
    reference's key selects, and whether they come reversed (torch slices
    take no negative step)."""
    step = tuple(step or ()) + (None,) * (len(begin) - len(step or ()))
    out = []
    for b, e, s, d in zip(begin, end, step, shape):
        start, stop, st = _norm_be(b, e, s, d).indices(d)
        n = len(range(start, stop, st))
        if st > 0 or n == 0:
            out.append((slice(start, start + n * st, st) if n else
                        slice(0, 0), False))
        else:
            last = start + (n - 1) * st
            out.append((slice(last, start + 1, -st), True))
    return out


def _flip_axes(parts):
    return [i for i, (_, rev) in enumerate(parts) if rev]


def _legacy_slice(x, begin, end, step):
    parts = _legacy_slices(begin, end, step, x.shape)
    out = x[tuple(p for p, _ in parts)]
    flips = _flip_axes(parts)
    return out.flip(flips) if flips else out


def _legacy_assign(lhs, begin, end, step, value):
    """``lhs.at[key].set(value)``: a new tensor; ``lhs`` as it was."""
    parts = _legacy_slices(begin, end, step, lhs.shape)
    key = tuple(p for p, _ in parts)
    out = lhs.clone()
    if isinstance(value, torch.Tensor):
        value = value.to(lhs.dtype).expand_as(out[key])
        flips = _flip_axes(parts)
        out[key] = value.flip(flips) if flips else value
    else:
        out[key] = value
    return out


register("slice", lambda begin=(), end=(), step=(), **a:
         (lambda x: _legacy_slice(x, begin, end, step)))
register_alias("crop", "slice")


def _slice_axis(axis=0, begin=0, end=None, **a):
    def f(x):
        d = x.shape[axis]
        lo = begin if begin >= 0 else d + begin
        hi = d if end is None else (end if end >= 0 else d + end)
        return x.narrow(axis, lo, hi - lo)

    return f


register("slice_axis", _slice_axis)


def _slice_like(axes=(), **a):
    def f(x, like):
        sel = tuple(ax + x.dim() if ax < 0 else ax for ax in axes)
        return x[tuple(slice(0, like.shape[i]) if not axes or i in sel
                       else slice(None) for i in range(x.dim()))]

    return f


register("slice_like", _slice_like)


def _broadcast_axis(x, axis, size):
    axis = (axis,) if isinstance(axis, int) else tuple(axis)
    size = (size,) if isinstance(size, int) else tuple(size)
    shape = list(x.shape)
    for ax, sz in zip(axis, size):
        shape[ax] = sz
    return torch.broadcast_to(x, tuple(shape))


def _broadcast_like_axes(x, like, lhs_axes, rhs_axes):
    shape = list(x.shape)
    for la, ra in zip(lhs_axes, rhs_axes):
        shape[la] = like.shape[ra]
    return torch.broadcast_to(x, tuple(shape))


def _reshape_like(x, like, lb, le, rb, re):
    if lb is None and le is None and rb is None and re is None:
        return torch.reshape(x, like.shape)
    lb = 0 if lb is None else lb
    le = x.dim() if le is None else le
    rb = 0 if rb is None else rb
    re = like.dim() if re is None else re
    return torch.reshape(x, x.shape[:lb] + like.shape[rb:re] + x.shape[le:])


register("broadcast_axis", lambda axis=(), size=(), **a:
         (lambda x: _broadcast_axis(x, axis, size)))
register_alias("broadcast_axes", "broadcast_axis")
register("broadcast_like", lambda lhs_axes=None, rhs_axes=None, **a:
         (lambda x, like: torch.broadcast_to(x, like.shape)
          if lhs_axes is None else _broadcast_like_axes(
              x, like, lhs_axes, rhs_axes)))
register("reshape_like", lambda lhs_begin=None, lhs_end=None,
         rhs_begin=None, rhs_end=None, **a:
         (lambda x, like: _reshape_like(x, like, lhs_begin, lhs_end,
                                        rhs_begin, rhs_end)))


def legacy_reshape_shape(src, spec, reverse=False):
    """The target shape of legacy ``Reshape`` (matrix_op-inl.h
    InferReshapeShape): 0 copies a dim, -1 infers one, -2 copies the rest,
    -3 merges two, -4 splits one into the next two codes (one may be -1);
    ``reverse`` reads the codes right to left."""
    if reverse:
        src = src[::-1]
        spec = tuple(spec)[::-1]
    out, i = [], 0
    spec = list(spec)
    j = 0
    while j < len(spec):
        c = spec[j]
        if c == 0:
            out.append(src[i])
            i += 1
        elif c == -1:
            out.append(-1)
            i += 1
        elif c == -2:
            out.extend(src[i:])
            i = len(src)
        elif c == -3:
            out.append(src[i] * src[i + 1])
            i += 2
        elif c == -4:
            d1, d2 = spec[j + 1], spec[j + 2]
            if d1 == -1:
                d1 = src[i] // d2
            if d2 == -1:
                d2 = src[i] // d1
            out.extend([d1, d2])
            i += 1
            j += 2
        else:
            out.append(c)
            i += 1
        j += 1
    if reverse:
        out = out[::-1]
    return tuple(out)


register("Reshape", lambda shape=(), reverse=False, **a:
         (lambda x: torch.reshape(
             x, legacy_reshape_shape(tuple(x.shape), shape, reverse))))


def npx_reshape_shape(src, spec, reverse=False):
    """``_npx_reshape``'s codes (np_matrix_op.cc NumpyXReshapeInferShape):
    -1 infers one dim, -2 copies the next, -3 skips a size-1 dim, -4
    copies all the rest, -5 merges two, -6 splits one into the two next
    values (one may be -1); ``reverse`` applies the spec right to left."""
    src = list(src)
    spec = list(spec)
    if reverse:
        return tuple(reversed(npx_reshape_shape(src[::-1], spec[::-1])))
    out, i = [], 0
    j = 0
    while j < len(spec):
        c = spec[j]
        if c == -2:
            out.append(src[i])
            i += 1
        elif c == -1:
            out.append(-1)
            i += 1
        elif c == -3:
            if src[i] != 1:
                raise ValueError(
                    "-3 reshape code may only skip a size-1 dimension, "
                    f"got {src[i]} at axis {i}")
            i += 1
        elif c == -4:
            out.extend(src[i:])
            i = len(src)
        elif c == -5:
            out.append(src[i] * src[i + 1])
            i += 2
        elif c == -6:
            d0 = src[i]
            d1, d2 = spec[j + 1], spec[j + 2]
            if d1 == -1:
                d1 = d0 // d2
            if d2 == -1:
                d2 = d0 // d1
            out.extend([d1, d2])
            i += 1
            j += 2
        else:
            out.append(c)
            i += 1
        j += 1
    return tuple(out)


register("_npx_reshape", lambda newshape=(), reverse=False, **a:
         (lambda x: torch.reshape(
             x, npx_reshape_shape(tuple(x.shape), newshape, reverse))))


def _pieces(parts, axis, squeeze):
    return tuple(p.squeeze(axis) if squeeze else p for p in parts)


def _slice_channel(num_outputs=1, axis=1, squeeze_axis=False, **a):
    def f(x):
        if x.shape[axis] % num_outputs:
            raise ValueError(
                "array split does not result in an equal division")
        return _pieces(torch.tensor_split(x, num_outputs, dim=axis), axis,
                       squeeze_axis)

    return f


register("SliceChannel", _slice_channel, nout=2)
register_alias("split_legacy", "SliceChannel")


def _split_v2(indices=(), axis=0, squeeze_axis=False, sections=0, **a):
    def f(x):
        if sections and x.shape[axis] % sections:
            raise ValueError(
                "array split does not result in an equal division")
        ios = sections if sections else list(indices)
        return _pieces(torch.tensor_split(x, ios, dim=axis), axis,
                       squeeze_axis)

    return f


register("_split_v2", _split_v2, nout=2)
register("swapaxes_legacy", lambda dim1=0, dim2=0, **a:
         (lambda x: torch.swapaxes(x, dim1, dim2)))
register("_rnn_param_concat", lambda dim=0, num_args=0, **a:
         (lambda *xs: torch.cat([x.reshape(-1) for x in xs], 0)))


# ---------------------------------------------------------------------------
# scatter and assignment (reference :497-515): each returns a new tensor
# ---------------------------------------------------------------------------
def _nd_index(ind):
    return tuple(ind[i].long() for i in range(ind.shape[0]))


register("scatter_nd", lambda shape=(), **a:
         (lambda data, ind: torch.zeros(
             _shp(shape), dtype=data.dtype, device=data.device).index_put(
             _nd_index(ind), data, accumulate=True)))
register("_scatter_set_nd", lambda shape=(), **a:
         (lambda data, ind: torch.zeros(
             _shp(shape), dtype=data.dtype, device=data.device).index_put(
             _nd_index(ind), data)))
register("_slice_assign", lambda begin=(), end=(), step=(), **a:
         (lambda lhs, rhs: _legacy_assign(lhs, begin, end, step, rhs)))
register_alias("_crop_assign", "_slice_assign")
register("_slice_assign_scalar", lambda begin=(), end=(), step=(),
         scalar=0.0, **a:
         (lambda lhs: _legacy_assign(lhs, begin, end, step, scalar)))
register_alias("_crop_assign_scalar", "_slice_assign_scalar")

# ---------------------------------------------------------------------------
# storage helpers (reference :519-527): dense tensors are the one storage,
# so cast_storage is the identity on values (NDArray.tostype swaps class)
# ---------------------------------------------------------------------------
register("cast_storage", lambda stype="default", **a: (lambda x: x))


def _sparse_retain(data, idx):
    i = idx.long()
    return torch.zeros_like(data).index_copy(0, i, data.index_select(0, i))


register("_sparse_retain", lambda **a: _sparse_retain)


def _square_sum(axis=None, keepdims=False, **a):
    def f(x):
        dims = tuple(range(x.dim())) if axis is None else \
            ((axis,) if isinstance(axis, int) else tuple(axis))
        return torch.sum(torch.square(x), dim=dims, keepdim=keepdims)

    return f


register("square_sum", _square_sum)
register_alias("_square_sum", "square_sum")

# ---------------------------------------------------------------------------
# multi-tensor helpers (reference :531-552)
# ---------------------------------------------------------------------------
register("multi_sum_sq", lambda num_arrays=1, **a:
         (lambda *xs: tuple(torch.sum(torch.square(x)) for x in xs)),
         nout=2, differentiable=False)
register("reset_arrays", lambda num_arrays=1, **a:
         (lambda *xs: tuple(torch.zeros_like(x) for x in xs)),
         nout=2, differentiable=False)


def _multi_lars(eta=0.001, eps=1e-8, rescale_grad=1.0, **a):
    """Layer-wise adaptive rates (contrib/multi_lars.cc): ``lr * eta *
    ||w|| / (||g|| * rescale + wd * ||w|| + eps)``, the plain ``lr`` where
    either norm is zero."""
    def f(lrs, w_sq, g_sq, wds):
        w_n = torch.sqrt(w_sq)
        g_n = torch.sqrt(g_sq) * rescale_grad
        adaptive = eta * w_n / (g_n + wds * w_n + eps)
        cond = (w_n > 0) & (g_n > 0)
        return lrs * torch.where(cond, adaptive, torch.ones_like(adaptive))

    return f


register("multi_lars", _multi_lars, differentiable=False)


# ---------------------------------------------------------------------------
# histogram (reference :557-565): jnp.histogram's rule on the device
# ---------------------------------------------------------------------------
def _histogram(x, edges):
    """``(counts, edges)``: bin i counts edges[i] <= v < edges[i + 1], the
    last bin closed on the right; values outside are dropped."""
    n = edges.shape[0]
    x = x.reshape(-1)
    idx = torch.searchsorted(edges, x, right=True)
    idx = torch.where(x == edges[-1], torch.full_like(idx, n - 1), idx)
    counts = torch.zeros(n + 1, dtype=x.dtype, device=x.device)
    counts.scatter_add_(0, idx, torch.ones_like(x))
    return counts[1:n], edges


def _histogram_bins(bin_cnt=None, range=None, **a):  # noqa: A002
    if bin_cnt is None:
        return lambda x, bins: _histogram(
            _float(x), bins.to(_float(x).dtype).contiguous())

    def f(x):
        x = _float(x)
        if range:
            lo, hi = (torch.full((), v, dtype=x.dtype, device=x.device)
                      for v in range)
        else:
            lo, hi = x.min(), x.max()
        flat = lo == hi
        lo, hi = torch.where(flat, lo - 0.5, lo), torch.where(flat, hi + 0.5,
                                                              hi)
        edges = _linspace(lo, hi, int(bin_cnt) + 1, True, x.dtype, x.device)
        return _histogram(x.contiguous(), edges)

    return f


register("histogram", _histogram_bins, nout=2, differentiable=False)
register_alias("_histogram", "histogram")


# ---------------------------------------------------------------------------
# index_array, share_memory, diag_indices_from (reference :567-588)
# ---------------------------------------------------------------------------
def _index_array(axes=None, **a):
    def f(x):
        full = _indices(x.shape, torch.int32, x.device).movedim(0, -1)
        return full if axes is None else full[..., list(axes)]

    return f


register("index_array", _index_array, differentiable=False)
register_alias("_contrib_index_array", "index_array")
# the reference answers False whatever the operands (reference :581)
register("_npi_share_memory", lambda **a:
         (lambda a_, b: torch.zeros((), dtype=torch.bool, device=a_.device)),
         differentiable=False)
register("_npi_diag_indices_from", lambda **a:
         (lambda x: tuple(torch.arange(x.shape[0], dtype=torch.int32,
                                       device=x.device)
                          for _ in range(x.dim()))),
         nout=2, differentiable=False)


# ---------------------------------------------------------------------------
# legacy NN extras (reference :595-680)
# ---------------------------------------------------------------------------
def _lrn(alpha=1e-4, beta=0.75, knorm=2.0, nsize=5, **a):
    """Cross-channel LRN on axis 1: ``x / (knorm + alpha / nsize *
    sum_window(x^2)) ** beta``, the window sum a sum of ``nsize`` shifted
    slices of the zero-padded squares (the reference's formula: its
    backward is this one's autograd)."""
    def f(x):
        half = nsize // 2
        padded = F.pad(torch.square(x), [0, 0] * (x.dim() - 2) + [half, half])
        c = x.shape[1]
        ssum = sum(padded.narrow(1, k, c) for k in range(nsize))
        return x / torch.pow(knorm + (alpha / nsize) * ssum, beta)

    return f


register("lrn", _lrn)
register_alias("LRN", "lrn")


def _softmax_activation(mode="instance", **a):
    def f(x):
        if mode == "channel":
            return torch.softmax(x, dim=1)
        return torch.softmax(x.reshape(x.shape[0], -1), dim=-1).reshape(
            x.shape)

    return f


register("softmax_activation", _softmax_activation)
register_alias("SoftmaxActivation", "softmax_activation")


def _bn_with_relu(**attrs):
    bn = get_op("batch_norm")._make_fn(**attrs)

    def f(x, gamma, beta, mmean, mvar):
        y, *rest = bn(x, gamma, beta, mmean, mvar)
        return (torch.relu(y), *rest)

    return f


register("batch_norm_with_relu", _bn_with_relu, nout=3)
register_alias("_contrib_BatchNormWithReLU", "batch_norm_with_relu")


def _sync_batch_norm(eps=1e-3, momentum=0.9, fix_gamma=True, ndev=1,
                     key="", axis_name=None, **a):
    """SyncBatchNorm on one device: batch statistics over every axis but
    1 (contrib/sync_batch_norm.cc with ``ndev=1``). The moments of a
    device mesh (``axis_name``) wait for the port's mesh (ROADMAP A8)."""
    if axis_name is not None:
        raise MXNetError(
            f"sync_batch_norm: axis_name={axis_name!r} reduces over a device "
            "mesh, which the port does not have yet (ROADMAP A8)")

    def f(x, gamma, beta, mmean, mvar):
        g = torch.ones_like(gamma) if fix_gamma else gamma
        red = tuple(i for i in range(x.dim()) if i != 1)
        mean = torch.mean(x, dim=red)
        var = torch.mean(torch.square(x), dim=red) - torch.square(mean)
        shape = [1] * x.dim()
        shape[1] = x.shape[1]
        out = (x - mean.reshape(shape)) * torch.rsqrt(
            var.reshape(shape) + eps) * g.reshape(shape) + beta.reshape(shape)
        new_mean = (momentum * mmean + (1 - momentum) * mean).detach()
        new_var = (momentum * mvar + (1 - momentum) * var).detach()
        return out, new_mean, new_var

    return f


register("sync_batch_norm", _sync_batch_norm, nout=3)
register_alias("_contrib_SyncBatchNorm", "sync_batch_norm")

# the shape arrives as a tensor and is read on the host: eager only
register("_contrib_dynamic_reshape", lambda **a:
         (lambda x, shape: torch.reshape(
             x, tuple(int(s) for s in shape.tolist()))),
         eager_only=True)
