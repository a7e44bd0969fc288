"""The quantized (int8) op family and the intgemm protocol.

Counterpart of ``mxnet_tpu/ops/quantized_ops.py``, every name of it:
``quantize_v2`` and ``requantize`` (:34-76), ``quantized_act``,
``_flatten``, ``_concat``, ``_elemwise_add``, ``_elemwise_mul`` and
``_embedding`` (:82-182), ``quantized_fully_connected_v2`` and
``quantized_conv`` (:185-241), ``quantized_pooling`` (:244),
``quantized_batch_norm`` (:276), the straight-through estimators
``round_ste``/``sign_ste`` (:306-327), the five ``intgemm_*`` ops
(:335-387) and their ``_contrib_*`` names. A quantized tensor travels as
``(int8 codes, min, max)``: each op takes the ranges as trailing 0-d float32
operands and returns its own; the scale of a range is ``max(|min|, |max|) /
127`` (symmetric int8).

The integer products (``quantized_fully_connected_v2``, ``quantized_conv``,
``intgemm_fully_connected``) accumulate int8 x int8 in int32, as the
reference's ``preferred_element_type=int32`` products do: on the card
``torch._int_mm`` (cuBLASLt's int8 GEMM; its operands zero-padded to more
than 16 rows and to inner and column counts that are multiples of 8, which
adds nothing to the sums), on the CPU a float64 product, exact for every sum
below 2^53. A convolution is a product of the codes' strided slices
(im2col, in int8: no float carries the codes) with the flattened filters.

The reference runs each op as one XLA program on the CPU, and the port
keeps its arithmetic to the bit where a code follows from it:

- a float cast to an integer type saturates (NaN to 0), as XLA's does;
  torch's cast wraps (:func:`_sat`);
- XLA folds a division whose divisor is a constant (a Python number, or an
  expression of constants such as a calibrated range) into a product with
  the divisor's float32 reciprocal; a constant expression itself is folded
  exactly. Such divisions are products with :func:`_recip` here, and a
  division by a value computed at run time is a division by a tensor (never
  by a Python number, which CUDA would also turn into a reciprocal's
  product, computed its own way);
- XLA contracts ``a * b + c`` into one fused multiply-add: the sums of
  ``quantized_elemwise_add`` and the affine map of ``quantized_batch_norm``
  are rounded once (:func:`_fma`, exact products in float64).

``quantized_batch_norm``'s ``gamma / sqrt(var + eps)`` is XLA's ``rsqrt``
on the CPU, which lies an ulp from the correctly rounded quotient the port
computes; its codes agree except where a value lies within that of a
rounding boundary.
"""
from __future__ import annotations

import itertools

import numpy as onp
import torch
import torch.nn.functional as F

from ._core import _take
from .registry import register, register_alias

__all__ = []

_I8MAX = 127.0
_I32_TOP = 2147483648.0         # float32(2 ** 31 - 1): the top of an int32 code
_BOUNDS = {torch.int8: (-128, 127), torch.int32: (-2 ** 31, 2 ** 31 - 1)}


def _recip(c):
    """The float32 reciprocal of the constant ``c`` (itself taken in
    float32), as a Python float: XLA's product for ``x / c``."""
    return float(onp.float32(1.0) / onp.float32(c))


def _scale(mn, mx):
    """``max(|mn|, |mx|, 1e-12) / 127`` of two 0-d tensors (reference :27;
    the constant divisor as its reciprocal's product)."""
    return torch.maximum(mn.abs(), mx.abs()).clamp_min(1e-12) * \
        _recip(_I8MAX)


def _scale_const(mn, mx):
    """``_scale`` of two constants, folded exactly in float32."""
    m = onp.maximum(onp.maximum(abs(onp.float32(mn)), abs(onp.float32(mx))),
                    onp.float32(1e-12))
    return float(m / onp.float32(_I8MAX))


def _const(v, like):
    """The 0-d float32 tensor of ``v`` on ``like``'s device."""
    return torch.full((), float(onp.float32(v)), dtype=torch.float32,
                      device=like.device)


def _sat(x, dtype):
    """``x`` cast to the integer ``dtype`` as XLA casts: a float saturates
    at the type's bounds and NaN gives 0; an integer wraps."""
    if not x.is_floating_point():
        return x.to(dtype)
    lo, hi = _BOUNDS[dtype]
    if dtype == torch.int8:
        return torch.nan_to_num(x, nan=0.0, posinf=hi, neginf=lo) \
            .clamp(lo, hi).to(dtype)
    return torch.nan_to_num(x.to(torch.float64), nan=0.0, posinf=hi,
                            neginf=lo).clamp(lo, hi).to(dtype)


def _codes(real, lo=-_I8MAX, hi=_I8MAX, dtype=torch.int8):
    """``clip(round(real), lo, hi)`` as ``dtype`` (half to even)."""
    return _sat(torch.round(real).clamp(lo, hi), dtype)


def _fma(a, b, c):
    """``a * b + c`` rounded once to float32 (XLA's contraction): the
    product of two float32 values is exact in float64."""
    return (a.to(torch.float64) * b.to(torch.float64) +
            c.to(torch.float64)).to(torch.float32)


def int8_matmul(a, w):
    """int8 ``a`` (M, K) times int8 ``w`` (N, K) transposed, accumulated in
    int32: (M, N). On the card ``torch._int_mm`` over zero-padded operands
    (it takes more than 16 rows and inner and column counts that are
    multiples of 8, and ``w`` as the transposed view of a row-major
    matrix); on the CPU a float64 product, exact below 2^53."""
    if not a.is_cuda:
        return torch.matmul(a.to(torch.float64),
                            w.to(torch.float64).t()).to(torch.int32)
    m, k = a.shape
    n = w.shape[0]
    mp, kp, np_ = max(m, 17), -(-k // 8) * 8, -(-n // 8) * 8
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if (np_, kp) != (n, k):
        w = F.pad(w, (0, kp - k, 0, np_ - n))
    out = torch._int_mm(a.contiguous(), w.contiguous().t())
    return out if (mp, np_) == (m, n) else out[:m, :n]


def _dense_i32(x, w):
    """``dot_general`` of ``x``'s last axis with ``w``'s axis 1 in int32,
    the operands cast to int8 first (reference :196-199)."""
    x, w = _sat(x, torch.int8), _sat(w, torch.int8)
    out = int8_matmul(x.reshape(-1, x.shape[-1]), w)
    return out.reshape(*x.shape[:-1], w.shape[0])


def _im2col(x, kernel, stride, pad, dilate):
    """(B, C, *S) codes as (B * L, C * prod(kernel)) columns of their
    strided slices (zero padding), and the output's spatial extent."""
    if any(pad):
        x = F.pad(x, [p for p in reversed(pad) for _ in (0, 1)])
    b, c = x.shape[:2]
    sp = x.shape[2:]
    out = [(sp[i] - dilate[i] * (kernel[i] - 1) - 1) // stride[i] + 1
           for i in range(len(kernel))]
    cols = []
    for off in itertools.product(*[range(k) for k in kernel]):
        cols.append(x[(slice(None), slice(None)) + tuple(
            slice(o * d, o * d + s * (n - 1) + 1, s)
            for o, d, s, n in zip(off, dilate, stride, out))])
    col = torch.stack(cols, 2).reshape(b, c * len(cols), -1)
    return col.transpose(1, 2).reshape(-1, c * len(cols)), out


def _out_range(s_out):
    mx = s_out * _I32_TOP
    return -mx, mx


# ---------------------------------------------------------------------------
# quantize / requantize (reference :34-76)
# ---------------------------------------------------------------------------
@register("quantize_v2", nout=3)
def _quantize_v2(out_type="int8", min_calib_range=None, max_calib_range=None,
                 **a):
    def f(x):
        if min_calib_range is not None:
            s = _scale_const(min_calib_range, max_calib_range)
            return (_codes(x * _recip(s)), _const(min_calib_range, x),
                    _const(max_calib_range, x))
        mn = torch.min(x).to(torch.float32)
        mx = torch.max(x).to(torch.float32)
        return _codes(x / _scale(mn, mx)), mn, mx

    return f


register_alias("_contrib_quantize_v2", "quantize_v2")


@register("requantize", nout=3)
def _requantize(min_calib_range=None, max_calib_range=None, **a):
    """An int32 accumulator with its ranges as int8 codes against a new
    range (reference :54)."""
    def f(q32, mn_in, mx_in):
        s_in = torch.maximum(mn_in.abs(), mx_in.abs()).clamp_min(1e-12) * \
            _recip(2.0 ** 31 - 1)
        real = q32.to(torch.float32) * s_in
        if min_calib_range is not None:
            s = _scale_const(min_calib_range, max_calib_range)
            return (_codes(real * _recip(s)), _const(min_calib_range, q32),
                    _const(max_calib_range, q32))
        mn, mx = torch.min(real), torch.max(real)
        return _codes(real / _scale(mn, mx)), mn, mx

    return f


register_alias("_contrib_requantize", "requantize")


# ---------------------------------------------------------------------------
# quantized compute ops (reference :82-300)
# ---------------------------------------------------------------------------
@register("quantized_act", nout=3)
def _quantized_act(act_type="relu", **a):
    """relu on the codes: monotonic and zero-preserving (reference :83)."""
    def f(q, mn, mx):
        if act_type != "relu":
            raise ValueError("quantized_act supports act_type='relu' only")
        return q.clamp_min(0), mn.clamp_min(0.0), mx.clamp_min(0.0)

    return f


register_alias("_contrib_quantized_act", "quantized_act")


@register("quantized_flatten", nout=3)
def _quantized_flatten(**a):
    def f(q, mn, mx):
        return q.reshape(q.shape[0], -1), mn, mx

    return f


register_alias("_contrib_quantized_flatten", "quantized_flatten")


@register("quantized_concat", nout=3)
def _quantized_concat(dim=1, num_args=1, **a):
    """Every input's codes rescaled onto the widest range, then joined
    (reference :109)."""
    def f(*args):
        n = len(args) // 3
        qs, mns, mxs = args[:n], args[n:2 * n], args[2 * n:]
        mn, mx = mns[0], mxs[0]
        for m in mns[1:]:
            mn = torch.minimum(mn, m)
        for m in mxs[1:]:
            mx = torch.maximum(mx, m)
        s_out = _scale(mn, mx)
        parts = [_codes(q.to(torch.float32) * (_scale(m0, m1) / s_out))
                 for q, m0, m1 in zip(qs, mns, mxs)]
        return torch.cat(parts, dim), mn, mx

    return f


register_alias("_contrib_quantized_concat", "quantized_concat")


@register("quantized_elemwise_add", nout=3)
def _quantized_elemwise_add(**a):
    """The float32 sum (one fused multiply-add) as int32 codes on the grid
    ``2^-22 max(sa, sb)`` (reference :137)."""
    def f(qa, qb, mna, mxa, mnb, mxb):
        sa, sb = _scale(mna, mxa), _scale(mnb, mxb)
        fsum = _fma(qa.to(torch.float32), sa, qb.to(torch.float32) * sb)
        s_out = torch.maximum(sa, sb) * 2.0 * (2.0 ** -23)
        acc = _codes(fsum / s_out, -(2 ** 31 - 1), 2 ** 31 - 1, torch.int32)
        return (acc,) + _out_range(s_out)

    return f


register_alias("_contrib_quantized_elemwise_add", "quantized_elemwise_add")


@register("quantized_elemwise_mul", nout=3)
def _quantized_elemwise_mul(**a):
    def f(qa, qb, mna, mxa, mnb, mxb):
        acc = _sat(qa, torch.int32) * _sat(qb, torch.int32)
        return (acc,) + _out_range(_scale(mna, mxa) * _scale(mnb, mxb))

    return f


register_alias("_contrib_quantized_elemwise_mul", "quantized_elemwise_mul")


@register("quantized_embedding", nout=3)
def _quantized_embedding(input_dim=0, output_dim=0, **a):
    take = _take(axis=0, mode="fill")

    def f(idx, qweight, mn, mx):
        return take(qweight, _sat(idx, torch.int32)), mn, mx

    return f


register_alias("_contrib_quantized_embedding", "quantized_embedding")


def _bias_codes(qb, mnb, mxb, s_out):
    """A quantized bias on the accumulator's grid, in int32."""
    return _sat(torch.round(qb.to(torch.float32) *
                            (_scale(mnb, mxb) / s_out)), torch.int32)


@register("quantized_fully_connected_v2", nout=3)
def _quantized_fc(num_hidden=0, no_bias=False, flatten=True, **a):
    """int8 x int8 -> int32 (reference :186); the accumulator's ranges are
    those of its int32 codes."""
    def f(*args):
        if no_bias:
            qx, qw, mnx, mxx, mnw, mxw = args
        else:
            qx, qw, qb, mnx, mxx, mnw, mxw, mnb, mxb = args
        x = qx.reshape(qx.shape[0], -1) if flatten else qx
        acc = _dense_i32(x, qw)
        s_out = _scale(mnx, mxx) * _scale(mnw, mxw)
        if not no_bias:
            acc = acc + _bias_codes(qb, mnb, mxb, s_out)
        return (acc,) + _out_range(s_out)

    return f


@register("quantized_conv", nout=3)
def _quantized_conv(kernel=(), stride=(), pad=(), dilate=(), num_filter=0,
                    no_bias=True, layout="NCHW", **a):
    """An N-d convolution of int8 codes, accumulated in int32 (reference
    :213: channels first, one group, symmetric padding)."""
    def f(*args):
        if no_bias:
            qx, qw, mnx, mxx, mnw, mxw = args
        else:
            qx, qw, qb, mnx, mxx, mnw, mxw, mnb, mxb = args
        nd = len(kernel) if kernel else qw.dim() - 2
        ks = tuple(qw.shape[2:])
        cols, out = _im2col(_sat(qx, torch.int8), ks,
                            tuple(stride) if stride else (1,) * nd,
                            tuple(pad) if pad else (0,) * nd,
                            tuple(dilate) if dilate else (1,) * nd)
        w = _sat(qw, torch.int8).reshape(qw.shape[0], -1)
        acc = int8_matmul(cols, w).reshape(qx.shape[0], -1, w.shape[0]) \
            .transpose(1, 2).reshape(qx.shape[0], w.shape[0], *out)
        s_out = _scale(mnx, mxx) * _scale(mnw, mxw)
        if not no_bias:
            acc = acc + _bias_codes(qb, mnb, mxb, s_out).reshape(
                1, -1, *([1] * nd))
        return (acc,) + _out_range(s_out)

    return f


register_alias("_contrib_quantized_conv", "quantized_conv")


@register("quantized_pooling", nout=3)
def _quantized_pooling(kernel=(), pool_type="max", stride=(), pad=(),
                       global_pool=False, **a):
    """Max pooling of the codes with -128 padding, or their int32 window
    sum (zero padding counted) over the whole window, rounded half to even
    (reference :245). Pooled in float64 over three spatial axes, which
    holds every code and window sum exactly."""
    def f(q, mn, mx):
        nd = q.dim() - 2
        if global_pool:
            win, st, pd = tuple(q.shape[2:]), (1,) * nd, (0,) * nd
        else:
            win = tuple(kernel)
            st = tuple(stride) if stride else (1,) * len(win)
            pd = tuple(pad) if pad else (0,) * len(win)
        x = q.to(torch.float64)
        if any(pd):
            x = F.pad(x, [p for p in reversed(pd) for _ in (0, 1)],
                      value=-128.0 if pool_type == "max" else 0.0)
        lift = 3 - nd
        x = x.reshape(x.shape[:2] + (1,) * lift + x.shape[2:])
        win3, st3 = (1,) * lift + win, (1,) * lift + st
        if pool_type == "max":
            out, dtype = F.max_pool3d(x, win3, st3), q.dtype
        else:
            acc = F.avg_pool3d(x, win3, st3, divisor_override=1)
            denom = 1
            for w in win:
                denom *= w
            out = torch.round(acc.to(torch.float32) * _recip(denom))
            dtype = torch.int8
        out = out.reshape(out.shape[:2] + out.shape[2 + lift:])
        return _sat(out, dtype), mn, mx

    return f


register_alias("_contrib_quantized_pooling", "quantized_pooling")


@register("quantized_batch_norm", nout=3)
def _quantized_batch_norm(eps=1e-3, min_calib_range=None,
                          max_calib_range=None, **a):
    """BatchNorm folded onto the codes: a per-channel affine map of their
    values, requantized (reference :277)."""
    def f(q, gamma, beta, mean, var, mn, mx):
        shape = (1, -1) + (1,) * (q.dim() - 2)
        inv = gamma / torch.sqrt(var + eps)
        t = _fma(q.to(torch.float32), _scale(mn, mx), -mean.reshape(shape))
        real = _fma(t, inv.reshape(shape), beta.reshape(shape))
        if min_calib_range is not None:
            s = _scale_const(min_calib_range, max_calib_range)
            return (_codes(real * _recip(s)), _const(min_calib_range, q),
                    _const(max_calib_range, q))
        mn_o, mx_o = torch.min(real), torch.max(real)
        return _codes(real / _scale(mn_o, mx_o)), mn_o, mx_o

    return f


register_alias("_contrib_quantized_batch_norm", "quantized_batch_norm")


# ---------------------------------------------------------------------------
# straight-through estimators (reference :306-327)
# ---------------------------------------------------------------------------
class _RoundSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return torch.round(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _SignSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return torch.sign(x)

    @staticmethod
    def backward(ctx, g):
        return g


register("round_ste", lambda **a: _RoundSTE.apply)
register("sign_ste", lambda **a: _SignSTE.apply)
register_alias("_contrib_round_ste", "round_ste")
register_alias("_contrib_sign_ste", "sign_ste")


# ---------------------------------------------------------------------------
# the intgemm protocol (reference :335-387): maxabsolute -> prepare -> gemm
# ---------------------------------------------------------------------------
def _prepare(x, maxabs):
    """``clip(round(x * (127 / max(maxabs, 1e-12))))`` as int8; the
    quotient's divisor is computed at run time, so it is a division."""
    m = maxabs.clamp_min(1e-12)
    return _codes(x * (torch.full_like(m, _I8MAX) / m))


register("intgemm_maxabsolute", lambda **a: (lambda x: x.abs().max()))
register_alias("_contrib_intgemm_maxabsolute", "intgemm_maxabsolute")

register("intgemm_prepare_data", lambda **a: _prepare, differentiable=False)
register_alias("_contrib_intgemm_prepare_data", "intgemm_prepare_data")

register("intgemm_prepare_weight", lambda already_quantized=False, **a:
         (lambda w, *maxabs: _sat(w, torch.int8) if already_quantized
          else _prepare(w, maxabs[0])),
         differentiable=False)
register_alias("_contrib_intgemm_prepare_weight", "intgemm_prepare_weight")


def _take_weight(**a):
    take = _take(axis=0, mode="fill")
    return lambda w, idx: take(w, _sat(idx, torch.int32))


register("intgemm_take_weight", _take_weight, differentiable=False)
register_alias("_contrib_intgemm_take_weight", "intgemm_take_weight")


@register("intgemm_fully_connected")
def _intgemm_fully_connected(out_type="float32", num_hidden=0, no_bias=True,
                             flatten=True, **a):
    """``A_int8 . B_int8^T * scale (+ bias)`` (reference :362); ``scale`` is
    the product of the two dequantization scales."""
    def f(*args):
        if no_bias:
            qa, qw, scale = args
        else:
            qa, qw, scale, bias = args
        x = qa.reshape(qa.shape[0], -1) if flatten else qa
        acc = _dense_i32(x, qw)
        if out_type == "int32":
            return acc
        if no_bias:
            return acc.to(torch.float32) * scale
        return _fma(acc.to(torch.float32), scale, bias)

    return f


register_alias("_contrib_intgemm_fully_connected", "intgemm_fully_connected")
