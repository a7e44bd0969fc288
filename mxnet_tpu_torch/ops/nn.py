"""Neural-network operators of the port: registered ops and their
tensor-level doors.

Counterpart of ``mxnet_tpu/ops/nn.py`` for the operators the GPT and
ResNet training and serving paths call. Each op is registered in
:mod:`.registry` under the reference's name and attributes
(``fully_connected``, ``convolution``, ``deconvolution``, ``pooling``,
``adaptive_avg_pool2d``, ``sequence_mask``, ``sequence_reverse``,
``sequence_last``, ``batch_norm``, ``layer_norm``, ``group_norm``,
``instance_norm``, ``rms_norm``, ``smooth_l1``, ``ctc_loss``, ``embedding``,
``leaky_relu``, ``activation``, ``softmax``, ``log_softmax``,
``masked_softmax``, ``dropout``, ``pick``, ``multihead_attention``,
``flash_attention``), so ``mx.npx`` and NDArrays reach them through
``invoke``. The matrix products, convolutions, pooling and elementwise work
stay plain PyTorch (cuDNN on the card), as the reference leaves them to XLA;
LayerNorm and masked attention (forward and backward) route to the
hand-written kernels in :mod:`.cuda_kernels`.

The functions of this module (``fully_connected(x, weight, bias)``, ...)
are the tensor-level doors that GPT, the losses, the compiled step and the
decode programs call with ``torch.Tensor``s. Each resolves the registered
op's cached function for its attributes once (:class:`_Door`) and calls it,
so captured programs keep calling plain tensor functions. Mixed precision
is cast by the registry, as in the reference: while AMP is on, a door of an
op in ``amp.MXU_OPS`` (``fully_connected``, ``matmul``,
``multihead_attention``, ``flash_attention``) resolves the function with
the ``__amp__`` attribute, which casts float32 tensor operands at entry;
the others follow the dtype that flows in.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import _deferred_compute as _dc
from .. import amp as _amp
from .. import autograd as _ag
from .. import random as _random
from ..base import MXNetError
from . import cuda_kernels as _kern
from ._core import fill_value, promoted, take_along_axis, wrap_fill_index
from .registry import get_op, register

__all__ = ["fully_connected", "matmul", "convolution", "deconvolution",
           "pooling",
           "adaptive_avg_pool2d", "batch_norm", "layer_norm", "group_norm",
           "instance_norm", "rms_norm", "smooth_l1", "ctc_loss", "embedding",
           "leaky_relu", "activation", "dropout", "softmax", "log_softmax",
           "masked_softmax", "pick", "one_hot", "multihead_attention",
           "flash_attention"]

_NEG_INF = -1e30


class _Door:
    """The tensor-level door of a registered op: :meth:`fn` gives the op's
    cached function for a set of attributes and the AMP state, resolved
    through :meth:`Op.fn` once per such set."""

    __slots__ = ("op", "mxu", "_fns")

    def __init__(self, name):
        self.op = get_op(name)
        self.mxu = name in _amp.MXU_OPS
        self._fns = {}

    def fn(self, **attrs):
        amp = _amp.target_dtype() if self.mxu and _amp.is_enabled() \
            else None
        key = (tuple(attrs.items()), amp)
        f = self._fns.get(key)
        if f is None:
            full = dict(attrs)
            if amp is not None:
                full["__amp__"] = amp
            f = self._fns[key] = self.op.fn(**full)
        if _dc._state.ctx is not None:
            # deferred compute: the door call is one node of the trace
            if amp is not None:
                attrs["__amp__"] = amp
            return lambda *args: _dc.call(self.op, attrs, f, args)
        return f


# ---------------------------------------------------------------------------
# registered ops (reference ops/nn.py)
# ---------------------------------------------------------------------------
@register("fully_connected")
def _fc(no_bias=False, flatten=True, num_hidden=0):
    def f(x, w, *b):
        if flatten and x.dim() > 2:
            x = x.reshape(x.shape[0], -1)
        # jnp.matmul promotes mixed operands (a converted layer fed from an
        # fp32 cache row)
        x, w = promoted(x, w)
        y = torch.matmul(x, w.t())
        if not no_bias:
            y = y + b[0]
        return y

    return f


# ---------------------------------------------------------------------------
# convolution and pooling (reference :47-224)
# ---------------------------------------------------------------------------
_DEFAULT_LAYOUT = {3: "NCW", 4: "NCHW", 5: "NCDHW"}
_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}


def _channels_first(layout, nd):
    """(to, back): the permutations between ``layout`` and channels-first,
    or (None, None) when it is channels-first already. A channels-last
    layout (``NWC``, ``NHWC``, ``NDHWC``) is logical, as the reference's
    dimension numbers (:47-52): x is permuted, with the same result."""
    lay = layout or _DEFAULT_LAYOUT[nd]
    if lay[1] == "C":
        return None, None
    return (0, nd - 1, *range(1, nd - 1)), (0, *range(2, nd), 1)


def _per_dim(v, n, default):
    return tuple(v) if v else (default,) * n


@register("convolution")
def _convolution(kernel=(), stride=(), dilate=(), pad=(), num_filter=0,
                 num_group=1, no_bias=False, layout=None):
    """N-d convolution (1-3 spatial dims), weight (O, I / groups, *k) in any
    layout (reference :55-83)."""
    def f(x, w, *b):
        nsp = x.dim() - 2
        to, back = _channels_first(layout, x.dim())
        if to is not None:
            x = x.permute(to)
        y = _CONV[nsp](x, w, None if no_bias else b[0],
                       stride=_per_dim(stride, nsp, 1),
                       padding=_per_dim(pad, nsp, 0),
                       dilation=_per_dim(dilate, nsp, 1), groups=num_group)
        return y if back is None else y.permute(back)

    return f


_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


@register("deconvolution")
def _deconvolution(kernel=(), stride=(), dilate=(), pad=(), adj=(),
                   num_filter=0, num_group=1, no_bias=False, layout=None):
    """Transposed convolution (reference :86-130), weight (in, out /
    groups, *k) in every layout: out = (in - 1) s + d (k - 1) + 1 - 2 p +
    adj. torch's own output padding must stay below the stride or the
    dilation; past that the full product is cropped and padded to the
    reference's extent instead (the extra cells have no input: zeros)."""
    def f(x, w, *b):
        nsp = x.dim() - 2
        to, back = _channels_first(layout, x.dim())
        if to is not None:
            x = x.permute(to)
        s, d = _per_dim(stride, nsp, 1), _per_dim(dilate, nsp, 1)
        p, a = _per_dim(pad, nsp, 0), _per_dim(adj, nsp, 0)
        bias = None if no_bias else b[0]
        if all(0 <= a[i] < max(s[i], d[i]) for i in range(nsp)):
            y = _CONV_T[nsp](x, w, bias, stride=s, padding=p,
                             output_padding=a, groups=num_group, dilation=d)
        else:
            y = _CONV_T[nsp](x, w, None, stride=s, groups=num_group,
                             dilation=d)
            crops = []
            for i in reversed(range(nsp)):
                crops += [-p[i], a[i] - p[i]]
            y = F.pad(y, crops)
            if bias is not None:
                y = y + bias.reshape((-1,) + (1,) * nsp)
        return y if back is None else y.permute(back)

    return f


def _ceil_extra(size, k, s, p, ceil_mode):
    """The ceil-mode padding past the symmetric one that lets the window
    grid cover the last partial window (reference :165-172)."""
    rem = (size + 2 * p - k) % s
    return s - rem if ceil_mode and rem else 0


def _torch_pool_size(size, k, s, p, ceil_mode):
    """Output extent of torch's pooling (which drops a last window that
    starts in the right padding)."""
    span = size + 2 * p - k
    out = (-(-span // s) if ceil_mode else span // s) + 1
    if ceil_mode and (out - 1) * s >= size + p:
        out -= 1
    return out


def _windows(x, k, s):
    """x (N, C, *spatial) -> (N, C, *out, *k): every pooling window."""
    for i, (ki, si) in enumerate(zip(k, s)):
        x = x.unfold(2 + i, ki, si)
    return x


def _pad_spatial(x, lohi, value):
    pads = []
    for lo, hi in reversed(lohi):
        pads += [lo, hi]
    return F.pad(x, pads, value=value)


@register("pooling")
def _pooling(kernel=(), pool_type="max", stride=(), pad=(), global_pool=False,
             count_include_pad=True, layout=None, ceil_mode=False):
    """Max or average pooling (anything but ``"max"`` averages, as the
    reference, :147-204). Where torch's pooling computes the same windows
    (padding at most half the kernel, the same output extent) it runs
    torch's (cuDNN's) op; otherwise the windows are padded explicitly (-inf
    or the integer minimum for max, 0 for average) and reduced, with the
    reference's divisor: the symmetric padding counts when
    ``count_include_pad``, the ceil-mode extra never."""
    is_max = pool_type == "max"

    def f(x):
        to, back = _channels_first(layout, x.dim())
        if to is not None:
            x = x.permute(to)
        y = _pool(x)
        return y if back is None else y.permute(back)

    def _pool(x):
        nsp = x.dim() - 2
        sp = tuple(range(2, x.dim()))
        if global_pool:
            return x.amax(dim=sp, keepdim=True) if is_max else \
                x.mean(dim=sp, keepdim=True)
        k = tuple(kernel)
        s = _per_dim(stride, nsp, 1)
        p = _per_dim(pad, nsp, 0)
        sizes = x.shape[2:]
        extra = [_ceil_extra(n, ki, si, pi, ceil_mode)
                 for n, ki, si, pi in zip(sizes, k, s, p)]
        ours = [(n + 2 * pi + e - ki) // si + 1
                for n, ki, si, pi, e in zip(sizes, k, s, p, extra)]
        if x.is_floating_point() and all(2 * pi <= ki for pi, ki in
                                         zip(p, k)) and ours == [
                _torch_pool_size(n, ki, si, pi, ceil_mode)
                for n, ki, si, pi in zip(sizes, k, s, p)]:
            if is_max:
                return _MAX_POOL[nsp](x, k, s, p, ceil_mode=ceil_mode)
            return _AVG_POOL[nsp](x, k, s, p, ceil_mode=ceil_mode,
                                  count_include_pad=count_include_pad)
        lohi = [(pi, pi + e) for pi, e in zip(p, extra)]
        red = tuple(range(-nsp, 0))
        if is_max:
            fill = float("-inf") if x.is_floating_point() else \
                torch.iinfo(x.dtype).min
            return _windows(_pad_spatial(x, lohi, fill), k, s).amax(dim=red)
        total = _windows(_pad_spatial(x, lohi, 0), k, s).sum(dim=red)
        ones = torch.ones((1, 1, *sizes), dtype=torch.float32,
                          device=x.device)
        if count_include_pad:
            ones = _pad_spatial(_pad_spatial(ones, [(pi, pi) for pi in p], 1),
                                [(0, e) for e in extra], 0)
        else:
            ones = _pad_spatial(ones, lohi, 0)
        count = _windows(ones, k, s).sum(dim=red)
        return total / count.to(total.dtype)

    return f


@register("adaptive_avg_pool2d")
def _adaptive_avg_pool2d(output_size=1):
    """Average pooling of NCHW to ``output_size``, which must divide the
    input's extent (reference :207-224)."""
    osz = (output_size, output_size) if isinstance(output_size, int) \
        else tuple(output_size)

    def f(x):
        n, c, h, w = x.shape
        if osz == (1, 1):
            return x.mean(dim=(2, 3), keepdim=True)
        if h % osz[0] or w % osz[1]:
            raise MXNetError(
                f"adaptive_avg_pool2d requires divisible sizes: {(h, w)} "
                f"into {osz}")
        return x.reshape(n, c, osz[0], h // osz[0], osz[1],
                         w // osz[1]).mean(dim=(3, 5))

    return f


@register("batch_norm", nout=3)
def _batch_norm(eps=1e-5, momentum=0.9, fix_gamma=True, use_batch_stats=True,
                axis=1):
    """BatchNorm over ``axis`` (reference :227-252), three outputs ``(out,
    new_mean, new_var)``. With batch stats the new running stats mix in the
    batch's *biased* variance with MXNet's momentum (the weight of the old
    stat), and carry no gradient; otherwise the moving stats normalise and
    come back as they are. The formula is the reference's, in its dtypes:
    x's dtype for ``out``, the promotion of the stats' for the new stats
    (the means sum in fp32 for bf16 x). One value per channel gives
    variance 0."""
    def f(x, gamma, beta, moving_mean, moving_var):
        g = torch.ones_like(gamma) if fix_gamma else gamma
        ax = axis if axis >= 0 else x.dim() + axis
        red = tuple(i for i in range(x.dim()) if i != ax)
        shape = [1] * x.dim()
        shape[ax] = x.shape[ax]
        if use_batch_stats:
            # two passes, as jnp.var: the variance's error is then second
            # order in the mean's rounding, which decides the result where
            # a channel holds few values
            mean = x.mean(dim=red)
            centered = x - mean.reshape(shape)
            var = (centered * centered).mean(dim=red)
            new_mean = (momentum * moving_mean +
                        (1 - momentum) * mean).detach()
            new_var = (momentum * moving_var +
                       (1 - momentum) * var).detach()
        else:
            mean, var = moving_mean, moving_var
            new_mean, new_var = moving_mean, moving_var
            centered = x - mean.reshape(shape).to(x.dtype)
        inv = torch.rsqrt(var.float() + eps).to(x.dtype)
        out = centered * (g * inv).reshape(shape).to(x.dtype) + \
            beta.reshape(shape).to(x.dtype)
        return out, new_mean, new_var

    return f


@register("layer_norm")
def _layer_norm(axis=-1, eps=1e-5):
    """The last axis runs the fused row kernel; any other axis the plain
    formula (reference :255)."""
    def f(x, gamma, beta):
        ax = axis if axis >= 0 else x.dim() + axis
        if ax == x.dim() - 1:
            return _kern.fused_layer_norm(x.contiguous(), gamma, beta, eps)
        mean = x.mean(dim=ax, keepdim=True)
        var = x.var(dim=ax, unbiased=False, keepdim=True)
        inv = torch.rsqrt(var.float() + eps).to(x.dtype)
        shape = [1] * x.dim()
        shape[ax] = x.shape[ax]
        return (x - mean) * inv * gamma.reshape(shape) + beta.reshape(shape)

    return f


@register("group_norm")
def _group_norm(num_groups=1, eps=1e-5):
    """GroupNorm over (N, C, ...) (reference :274): the channels cut into
    ``num_groups`` groups, each normalised by its biased variance (two
    passes, as ``jnp.var``) and ``rsqrt`` in the input's dtype."""
    def f(x, gamma, beta):
        n, c = x.shape[0], x.shape[1]
        xg = x.reshape(n, num_groups, c // num_groups, *x.shape[2:])
        red = tuple(range(2, xg.dim()))
        mean = xg.mean(dim=red, keepdim=True)
        centered = xg - mean
        var = (centered * centered).mean(dim=red, keepdim=True)
        out = (centered * torch.rsqrt(var + eps)).reshape(x.shape)
        shape = [1] * x.dim()
        shape[1] = c
        return out * gamma.reshape(shape) + beta.reshape(shape)

    return f


@register("instance_norm")
def _instance_norm(eps=1e-5):
    """InstanceNorm over (N, C, ...) (reference :291): each (sample,
    channel) normalised over its spatial extent."""
    def f(x, gamma, beta):
        red = tuple(range(2, x.dim()))
        mean = x.mean(dim=red, keepdim=True)
        centered = x - mean
        var = (centered * centered).mean(dim=red, keepdim=True)
        shape = [1] * x.dim()
        shape[1] = x.shape[1]
        return centered * torch.rsqrt(var + eps) * gamma.reshape(shape) + \
            beta.reshape(shape)

    return f


@register("rms_norm")
def _rms_norm(axis=-1, eps=1e-6):
    """RMSNorm over ``axis`` (reference :305): the mean of squares in
    float32, its ``rsqrt`` cast to x's dtype before the product, so a bf16
    x rounds as the reference's does."""
    def f(x, gamma):
        ms = x.float().square().mean(dim=axis, keepdim=True)
        return (x * torch.rsqrt(ms + eps).to(x.dtype)) * gamma

    return f


@register("embedding")
def _embedding(input_dim=0, output_dim=0, sparse_grad=False):
    """Rows of ``weight`` at ``idx``, as the reference's ``jnp.take``
    (reference :418): an index in [-n, 0) wraps, and the row of an index
    outside [-n, n) is filled (NaN for a float table). Gathered at the
    clamped index and filled by a mask: no host sync, no data-dependent
    shape, no device-side assert."""
    def f(idx, weight):
        i, ok = wrap_fill_index(idx, weight.shape[0])
        return torch.where(ok.unsqueeze(-1), weight[i],
                           fill_value(weight.dtype))

    return f


@register("sequence_mask")
def _sequence_mask(use_sequence_length=False, value=0.0, axis=0):
    """Steps at or past each sequence's length set to ``value``
    (reference :426); the batch axis is the other of the first two."""
    def f(x, *length):
        if not use_sequence_length:
            return x
        shape = [1] * x.dim()
        shape[axis] = x.shape[axis]
        idx = torch.arange(x.shape[axis], device=x.device).reshape(shape)
        lshape = [1] * x.dim()
        lshape[1 - axis] = x.shape[1 - axis]
        mask = idx < length[0].reshape(lshape)
        return torch.where(mask, x, torch.tensor(value, dtype=x.dtype,
                                                 device=x.device))

    return f


@register("sequence_reverse")
def _sequence_reverse(use_sequence_length=False, axis=0):
    """Each sequence's first ``length`` steps reversed, the rest kept
    (reference :444; sequence axis 0)."""
    def f(x, *length):
        if not use_sequence_length:
            return torch.flip(x, (axis,))
        t = torch.arange(x.shape[0], device=x.device)[:, None]
        ln = length[0][None, :].to(torch.int32)
        src = torch.where(t < ln, ln - 1 - t, t)
        return x[src, torch.arange(x.shape[1], device=x.device)[None, :]]

    return f


@register("sequence_last")
def _sequence_last(use_sequence_length=False, axis=0):
    """Each sequence's last valid step (reference :460)."""
    def f(x, *length):
        if not use_sequence_length:
            return x.select(axis, x.shape[axis] - 1)
        idx = length[0].to(torch.int32).long() - 1
        return x[idx, torch.arange(x.shape[1], device=x.device)]

    return f


@register("leaky_relu")
def _leaky_relu(act_type="leaky", slope=0.25):
    """The LeakyReLU family (reference :341); ``gelu`` is the exact erf
    form, ``gelu_tanh`` the tanh approximation."""
    if act_type == "leaky":
        return lambda x: F.leaky_relu(x, slope)
    if act_type == "elu":
        return lambda x: F.elu(x, slope)
    if act_type == "selu":
        return F.selu
    if act_type == "gelu":
        return lambda x: F.gelu(x, approximate="none")
    if act_type == "gelu_tanh":
        return lambda x: F.gelu(x, approximate="tanh")
    if act_type == "prelu":
        return lambda x, alpha: torch.where(x >= 0, x, alpha * x)
    raise MXNetError(f"unknown leaky_relu variant {act_type!r}")


_ACTIVATIONS = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "softrelu": F.softplus,
    "softsign": F.softsign,
    "log_sigmoid": F.logsigmoid,
    "mish": F.mish,
    # the reference's HardSigmoid: clip(0.2 x + 0.5, 0, 1)
    "hard_sigmoid": lambda x: torch.clamp(0.2 * x + 0.5, 0.0, 1.0),
    "hard_swish": F.hardswish,
    "silu": F.silu,
}


@register("activation")
def _activation(act_type="relu"):
    if act_type not in _ACTIVATIONS:
        raise MXNetError(f"unknown activation {act_type!r}")
    return _ACTIVATIONS[act_type]


def _length_mask(x, length, axis):
    ax = axis if axis >= 0 else x.dim() + axis
    shape = [1] * x.dim()
    shape[ax] = x.shape[ax]
    idx = torch.arange(x.shape[ax], device=x.device).reshape(shape)
    lshape = [1] * x.dim()
    lshape[0] = x.shape[0]
    return idx < length.reshape(lshape)


def _tempered(x, temperature):
    return x / temperature if temperature not in (None, 1.0) else x


@register("softmax")
def _softmax(axis=-1, temperature=None, use_length=False):
    """Softmax over ``axis`` (reference :357); with ``use_length`` the
    second operand (B,) masks each row's positions >= its length."""
    def f(x, *length):
        z = _tempered(x, temperature)
        if use_length:
            z = torch.where(_length_mask(x, length[0], axis), z,
                            torch.full_like(z, float("-inf")))
        return torch.softmax(z, dim=axis)

    return f


@register("log_softmax")
def _log_softmax(axis=-1, temperature=None):
    return lambda x: torch.log_softmax(_tempered(x, temperature), dim=axis)


@register("masked_softmax")
def _masked_softmax(axis=-1, temperature=1.0):
    def f(x, mask):
        m = mask.bool()
        z = torch.where(m, _tempered(x, temperature), float("-inf"))
        return torch.where(m, torch.softmax(z, dim=axis), 0.0)

    return f


@register("dropout", needs_rng=True)
def _dropout(p=0.5, mode="training", training=True):
    """Inverted dropout (reference :403); the keep mask is drawn from the
    generator operand."""
    def f(gen, x):
        if not training or p <= 0.0:
            return x
        keep = 1.0 - p
        mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x)).to(x.dtype)

    return f


@register("pick")
def _pick(axis=-1, keepdims=False, mode="clip"):
    """``x``'s entries at ``index`` along ``axis`` (reference :476, whose
    ``jnp.take_along_axis`` ignores ``mode``): an index in [-n, 0) wraps and
    one outside [-n, n) gives the fill value (NaN for a float x, the type's
    least value for a signed int, True for bool)."""
    def f(x, idx):
        out = take_along_axis(x, idx.unsqueeze(axis), axis)
        return out if keepdims else out.squeeze(axis)

    return f


@register("smooth_l1")
def _smooth_l1(scalar=1.0):
    """0.5 (s x)^2 where |x| < 1 / s^2, else |x| - 0.5 / s^2 (reference
    :486)."""
    def f(x):
        s2 = scalar * scalar
        return torch.where(x.abs() < 1.0 / s2, 0.5 * s2 * x * x,
                           x.abs() - 0.5 / s2)

    return f


_LOG_EPSILON = -1e5   # optax's stand-in for log(0): a finite loss


def _ctc(logits, logit_pad, labels, label_pad, blank_id):
    """Per-sequence CTC loss of ``logits`` (B, T, V) against ``labels`` (B,
    N), optax's ``ctc_loss`` (the reference's route) step for step: the
    forward recursion in log space over blank (``phi``) and label
    (``emit``) states, log(0) as ``-1e5``, so an infeasible alignment
    costs a large finite loss where ``F.ctc_loss`` gives inf. A padded
    step keeps the states; the answer is read at each row's label
    length."""
    logprobs = torch.log_softmax(logits, dim=-1)
    b, t_len, v = logits.shape
    n = labels.shape[1]
    dt = torch.promote_types(logprobs.dtype, torch.float32)
    labellens = n - label_pad.sum(dim=1).to(torch.int64)
    repeat = (labels[:, :-1] == labels[:, 1:]).to(dt)
    repeat = F.pad(repeat, (0, 1))
    lp_phi = logprobs[:, :, blank_id].transpose(0, 1).unsqueeze(-1).to(dt)
    # optax's einsum with one_hot(labels): a label outside [0, V) emits 0
    valid = (labels >= 0) & (labels < v)
    idx = labels.clamp(0, v - 1).long().unsqueeze(1).expand(b, t_len, n)
    lp_emit = torch.where(valid.unsqueeze(1), logprobs.gather(2, idx),
                          torch.zeros((), dtype=logprobs.dtype,
                                      device=logprobs.device))
    lp_emit = lp_emit.transpose(0, 1).to(dt)            # (T, B, N)
    phi = torch.full((b, n + 1), _LOG_EPSILON, dtype=torch.float32,
                     device=logits.device)
    phi[:, 0] = 0.0
    emit = torch.full((b, n), _LOG_EPSILON, dtype=torch.float32,
                      device=logits.device)

    def update_phi(p, added):
        return torch.cat([p[:, :1], torch.logaddexp(p[:, 1:], added)], 1)

    pads = logit_pad.transpose(0, 1).to(dt).unsqueeze(-1)   # (T, B, 1)
    skip_rep = _LOG_EPSILON * repeat
    skip_new = _LOG_EPSILON * (1.0 - repeat)
    for t in range(t_len):
        prev_orig = phi
        prev_phi = update_phi(phi, emit + skip_rep)
        e, ph, pad = lp_emit[t], lp_phi[t], pads[t]
        next_emit = torch.logaddexp(prev_phi[:, :-1] + e, emit + e)
        next_phi = update_phi(prev_phi + ph, emit + ph + skip_new)
        emit = pad * emit + (1.0 - pad) * next_emit
        phi = pad * prev_orig + (1.0 - pad) * next_phi
    last = update_phi(phi, emit)
    return -last.gather(1, labellens.unsqueeze(1)).squeeze(1)


@register("ctc_loss")
def _ctc_loss(use_data_lengths=False, use_label_lengths=False,
              blank_label="first"):
    """CTC loss of ``data`` (T, B, V) logits against ``label`` (B, L)
    (reference :496). The blank is class 0 for ``blank_label="first"``
    (labels <= 0 are then padding when no lengths are given) and V - 1 for
    ``"last"`` (labels < 0 padding); optional operands give each row's data
    and label lengths. One loss a row, (B,)."""
    def f(data, label, *lens):
        logits = data.transpose(0, 1)
        b, t_len, v = logits.shape
        dev = data.device
        i = 0
        if use_data_lengths:
            dl = lens[i].to(torch.int32)
            i += 1
        else:
            dl = torch.full((b,), t_len, dtype=torch.int32, device=dev)
        if use_label_lengths:
            ll = lens[i].to(torch.int32)
        elif blank_label == "first":
            ll = ((label >= 0) & (label != 0)).sum(-1).to(torch.int32)
        else:
            ll = (label >= 0).sum(-1).to(torch.int32)
        logit_pad = (torch.arange(t_len, device=dev)[None, :] >=
                     dl[:, None]).float()
        label_pad = (torch.arange(label.shape[1], device=dev)[None, :] >=
                     ll[:, None]).float()
        blank = 0 if blank_label == "first" else v - 1
        return _ctc(logits, logit_pad, label.to(torch.int32), label_pad,
                    blank)

    return f


@register("multihead_attention")
def _multihead_attention(num_heads=1, dropout=0.0, causal=False, scale=None,
                         num_kv_heads=None):
    """Multi-head attention over (B, T, heads * D) projections (reference
    :535). The dispatch keeps the reference's three branches exactly:

    - no mask: the flash kernel;
    - a (B, 1, 1, Tk) key-padding mask with Tq == Tk: the flash kernel with
      q ids = 1 and kv ids = (mask != 0) — a fully masked row emits zeros;
    - any other mask: dense attention with hidden logits at -1e30 — a fully
      masked row gives a ~uniform softmax there, not zeros.

    ``num_kv_heads`` (GQA/MQA): k/v carry that many heads, each shared by
    ``num_heads // num_kv_heads`` query heads (repeated before attention,
    as the reference's stopgap at :556-564).
    """
    n_kv = num_heads if num_kv_heads is None else int(num_kv_heads)
    if n_kv < 1 or num_heads % n_kv:
        raise MXNetError(
            f"num_kv_heads must be a positive divisor of num_heads "
            f"{num_heads}, got {num_kv_heads}")

    def f(q, k, v, *mask):
        # the reference's einsums promote mixed operands (a converted
        # model's bf16 query against the engine's fp32 KV cache attends in
        # fp32); the kernels take one dtype
        q, k, v = promoted(q, k, v)
        B, Tq, E = q.shape
        Tk = k.shape[1]
        D = E // num_heads
        qh = q.reshape(B, Tq, num_heads, D).transpose(1, 2)
        kh = k.reshape(B, Tk, n_kv, D).transpose(1, 2)
        vh = v.reshape(B, Tk, n_kv, D).transpose(1, 2)
        if n_kv != num_heads:
            reps = num_heads // n_kv
            kh = kh.repeat_interleave(reps, dim=1)
            vh = vh.repeat_interleave(reps, dim=1)
        s = scale if scale is not None else 1.0 / math.sqrt(D)
        m = mask[0] if mask else None
        if m is None:
            out = _kern.flash_attention(qh.contiguous(), kh.contiguous(),
                                        vh.contiguous(), s, causal)
        elif m.dim() == 4 and m.shape[1] == 1 and m.shape[2] == 1 and \
                m.shape[0] == B and m.shape[3] == Tk and Tq == Tk:
            seg = (m.reshape(B, Tk) != 0).to(torch.int32)
            out = _kern.flash_attention(qh.contiguous(), kh.contiguous(),
                                        vh.contiguous(), s, causal,
                                        q_segment_ids=torch.ones_like(seg),
                                        kv_segment_ids=seg)
        else:
            logits = torch.matmul(qh, kh.transpose(-1, -2)) * s
            # the reference's where(..., -1e30) in the logits' dtype: -inf
            # in fp16, whose range ends at 65504
            neg = torch.full_like(logits, _NEG_INF, dtype=torch.float32) \
                .to(logits.dtype)
            if causal:
                cm = torch.ones((Tq, Tk), dtype=torch.bool,
                                device=q.device).tril(Tk - Tq)
                logits = torch.where(cm, logits, neg)
            logits = torch.where(m.to(torch.bool), logits, neg)
            w = torch.softmax(logits, dim=-1)
            out = torch.matmul(w, vh)
        return out.transpose(1, 2).reshape(B, Tq, E)

    return f


@register("flash_attention")
def _flash_attention(num_heads=1, causal=False, scale=None):
    """The ``flash_attention`` op (reference :599): canonical (B, H, T, D)
    operands; rank-2/3 operands are lifted to rank 4 and the output
    restored. Optional 4th/5th inputs: (B, Tq)/(B, Tk) segment ids (one
    id given is used for both sides)."""
    def f(q, k, v, *segments):
        q, k, v = promoted(q, k, v)
        ndim = q.dim()
        if ndim == 2:
            qq, kk, vv = (a[None, None] for a in (q, k, v))
        elif ndim == 3:
            qq, kk, vv = (a[:, None] for a in (q, k, v))
        elif ndim == 4:
            qq, kk, vv = q, k, v
        else:
            raise MXNetError(
                f"flash_attention expects rank 2-4 operands, got {ndim}")
        q_seg = k_seg = None
        if segments:
            q_seg = segments[0]
            k_seg = segments[1] if len(segments) > 1 else segments[0]
            if ndim == 2:
                q_seg, k_seg = q_seg[None], k_seg[None]
        out = _kern.flash_attention(qq.contiguous(), kk.contiguous(),
                                    vv.contiguous(), scale, causal,
                                    q_segment_ids=q_seg,
                                    kv_segment_ids=k_seg)
        if ndim == 2:
            return out[0, 0]
        if ndim == 3:
            return out[:, 0]
        return out

    return f


# ---------------------------------------------------------------------------
# tensor-level doors
# ---------------------------------------------------------------------------
_FC = _Door("fully_connected")
_MATMUL = _Door("matmul")
_CONVOLUTION = _Door("convolution")
_POOLING = _Door("pooling")
_ADAPTIVE_AVG = _Door("adaptive_avg_pool2d")
_BATCH_NORM = _Door("batch_norm")
_LN = _Door("layer_norm")
_GROUP_NORM = _Door("group_norm")
_INSTANCE_NORM = _Door("instance_norm")
_RMS_NORM = _Door("rms_norm")
_SMOOTH_L1 = _Door("smooth_l1")
_CTC = _Door("ctc_loss")
_EMBEDDING = _Door("embedding")
_LEAKY = _Door("leaky_relu")
_ACTIVATION = _Door("activation")
_DROPOUT = _Door("dropout")
_SOFTMAX = _Door("softmax")
_LOG_SOFTMAX = _Door("log_softmax")
_MASKED_SOFTMAX = _Door("masked_softmax")
_DECONVOLUTION = _Door("deconvolution")
_PICK = _Door("pick")
_ONE_HOT = _Door("one_hot")
_MHA = _Door("multihead_attention")
_FLASH = _Door("flash_attention")


def fully_connected(x, weight, bias=None, flatten=True):
    """y = x W^T (+ b); weight layout (units, in_units) (reference :31).
    Under AMP the bias is cast with x and W, as in the reference."""
    if bias is None:
        return _FC.fn(no_bias=True, flatten=flatten)(x, weight)
    return _FC.fn(no_bias=False, flatten=flatten)(x, weight, bias)


def matmul(a, b):
    """The registered ``matmul`` op (reference ``ops/_core.py:110``,
    ``jnp.matmul``), cast under AMP."""
    return _MATMUL.fn()(a, b)


def convolution(x, weight, bias=None, kernel=(), stride=(), dilate=(),
                pad=(), num_filter=0, num_group=1, layout=None):
    """The ``convolution`` op on tensors (reference :55), cast under AMP;
    tuples for the per-dimension attributes."""
    f = _CONVOLUTION.fn(kernel=kernel, stride=stride, dilate=dilate, pad=pad,
                        num_filter=num_filter, num_group=num_group,
                        no_bias=bias is None, layout=layout)
    return f(x, weight) if bias is None else f(x, weight, bias)


def deconvolution(x, weight, bias=None, kernel=(), stride=(), dilate=(),
                  pad=(), adj=(), num_filter=0, num_group=1, layout=None):
    """The ``deconvolution`` op on tensors (reference :86)."""
    f = _DECONVOLUTION.fn(kernel=kernel, stride=stride, dilate=dilate,
                          pad=pad, adj=adj, num_filter=num_filter,
                          num_group=num_group, no_bias=bias is None,
                          layout=layout)
    return f(x, weight) if bias is None else f(x, weight, bias)


def pooling(x, kernel=(), pool_type="max", stride=(), pad=(),
            global_pool=False, count_include_pad=True, layout=None,
            ceil_mode=False):
    """The ``pooling`` op on tensors (reference :147)."""
    return _POOLING.fn(kernel=kernel, pool_type=pool_type, stride=stride,
                       pad=pad, global_pool=global_pool,
                       count_include_pad=count_include_pad, layout=layout,
                       ceil_mode=ceil_mode)(x)


def adaptive_avg_pool2d(x, output_size=1):
    return _ADAPTIVE_AVG.fn(output_size=output_size)(x)


def batch_norm(x, gamma, beta, running_mean, running_var, eps=1e-5,
               momentum=0.9, fix_gamma=True, use_batch_stats=True, axis=1):
    """The ``batch_norm`` op on tensors (reference :227): ``(out, new_mean,
    new_var)``."""
    return _BATCH_NORM.fn(eps=eps, momentum=momentum, fix_gamma=fix_gamma,
                          use_batch_stats=use_batch_stats, axis=axis)(
        x, gamma, beta, running_mean, running_var)


def layer_norm(x, gamma, beta, axis=-1, eps=1e-5):
    """LayerNorm over ``axis`` (reference :255)."""
    return _LN.fn(axis=axis, eps=eps)(x, gamma, beta)


def group_norm(x, gamma, beta, num_groups=1, eps=1e-5):
    """GroupNorm of (N, C, ...) ``x`` (reference :274)."""
    return _GROUP_NORM.fn(num_groups=num_groups, eps=eps)(x, gamma, beta)


def instance_norm(x, gamma, beta, eps=1e-5):
    """InstanceNorm of (N, C, ...) ``x`` (reference :291)."""
    return _INSTANCE_NORM.fn(eps=eps)(x, gamma, beta)


def rms_norm(x, gamma, axis=-1, eps=1e-6):
    """RMSNorm over ``axis`` (reference :305)."""
    return _RMS_NORM.fn(axis=axis, eps=eps)(x, gamma)


def smooth_l1(x, scalar=1.0):
    """The smooth L1 function (reference :486)."""
    return _SMOOTH_L1.fn(scalar=scalar)(x)


def ctc_loss(data, label, data_lengths=None, label_lengths=None,
             blank_label="first"):
    """CTC loss of (T, B, V) logits against (B, L) labels (reference
    :496); see the registered op."""
    args = [a for a in (data_lengths, label_lengths) if a is not None]
    return _CTC.fn(use_data_lengths=data_lengths is not None,
                   use_label_lengths=label_lengths is not None,
                   blank_label=blank_label)(data, label, *args)


def embedding(idx, weight):
    """Rows of ``weight`` at integer ``idx`` (reference :418); out-of-range
    rows filled as the registered op says."""
    return _EMBEDDING.fn()(idx, weight)


def leaky_relu(x, alpha=None, act_type="leaky", slope=0.25):
    """The reference's LeakyReLU family (reference :341)."""
    if act_type == "prelu":
        return _LEAKY.fn(act_type=act_type, slope=slope)(x, alpha)
    return _LEAKY.fn(act_type=act_type, slope=slope)(x)


def activation(x, act_type="relu"):
    return _ACTIVATION.fn(act_type=act_type)(x)


def dropout(x, p=0.5, training=False, generator=None):
    """Inverted dropout (reference :403). Active when ``training`` is True
    or the autograd training flag is set — inside ``autograd.record()``, as
    the reference's ``npx.dropout`` (numpy_extension:161-163); the identity
    otherwise and at p <= 0. The keep mask is drawn from ``generator``, by
    default the generator of x's device in :mod:`mxnet_tpu_torch.random`."""
    if p <= 0.0 or not (training or _ag.is_training()):
        return x
    if generator is None:
        generator = _random.generator(x.device)
    return _DROPOUT.fn(p=p, mode="training", training=True)(generator, x)


def softmax(x, axis=-1, temperature=None, length=None):
    """Softmax over ``axis`` (reference :357); ``length`` (B,) masks each
    row's positions >= its length."""
    if length is None:
        return _SOFTMAX.fn(axis=axis, temperature=temperature)(x)
    return _SOFTMAX.fn(axis=axis, temperature=temperature,
                       use_length=True)(x, length)


def log_softmax(x, axis=-1, temperature=None):
    """Log-softmax over ``axis`` (reference :369)."""
    return _LOG_SOFTMAX.fn(axis=axis, temperature=temperature)(x)


def masked_softmax(x, mask, axis=-1, temperature=1.0):
    return _MASKED_SOFTMAX.fn(axis=axis, temperature=temperature)(x, mask)


def pick(x, index, axis=-1, keepdims=False, mode="clip"):
    """``x``'s entries at ``index`` along ``axis`` (reference :476); out of
    range as the registered op says."""
    return _PICK.fn(axis=axis, keepdims=keepdims, mode=mode)(x, index)


def one_hot(indices, depth, on_value=1.0, off_value=0.0, dtype="float32"):
    """One-hot over a new last axis (reference ``ops/_core.py:221``); an
    index outside [0, depth) gives the ``off_value`` vector."""
    return _ONE_HOT.fn(depth=depth, on_value=on_value, off_value=off_value,
                       dtype=dtype)(indices)


def multihead_attention(q, k, v, mask=None, num_heads=1, causal=False,
                        scale=None, num_kv_heads=None):
    """Multi-head attention over (B, T, heads * D) projections; see the
    registered op."""
    f = _MHA.fn(num_heads=num_heads, causal=causal, scale=scale,
                num_kv_heads=num_kv_heads)
    return f(q, k, v) if mask is None else f(q, k, v, mask)


def flash_attention(q, k, v, *segments, causal=False, scale=None):
    """The ``flash_attention`` op on tensors; see the registered op."""
    return _FLASH.fn(causal=causal, scale=scale)(q, k, v, *segments)
