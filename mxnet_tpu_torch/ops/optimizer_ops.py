"""The optimizer update ops of the port: the reference's
``mxnet_tpu/ops/optimizer_ops.py``, all of it.

The dense registered updates (reference :32-230, :396-872): ``sgd_update``,
``sgd_mom_update``, ``nag_mom_update``, ``signsgd_update``,
``signum_update``, ``adam_update`` (no bias correction, as the op),
``adamw_update``, ``adabelief_update``, ``ftml_update``, ``ftrl_update``,
``rmsprop_update``, ``rmspropalex_update``, ``lamb_update_phase1``/
``phase2``; ``all_finite``/``multi_all_finite`` (0-d bools, on the device);
the ``mp_*`` forms, which take an fp32 master operand and return the weight
as the master's cast-back; the multi-tensor ``multi_(mp_)sgd(_mom)``,
``preloaded_multi_*`` (``lrs`` and ``wds`` the last two tensors),
``multi_(mp_)adamw``/``adabelief`` (a trailing ``rescale_grad`` tensor) and
``multi_(mp_)lamb``/``lans`` (``learning_rates``, ``step_count``,
``num_tensors``) families, whose operands interleave a weight's tensors and
whose outputs come back flat in the same order, registered without
``nout`` (one Symbol entry, as the reference's); and the reference's
underscore names. Each op is functional, as the reference's: it returns
the new weight and states, and a user writes them back with ``out=``
(``mx.nd.multi_mp_lamb_update(..., out=[...])``). Output dtypes are JAX's
promotion of the operands: Python hypers are weak, tensors are not (a
0-dim tensor too, which torch would rank below a wider dtype, so those
operands are promoted by hand, ``_like``). LAMB's and LANS's trust ratios
take whole-tensor norms (:func:`norm`: float64 sums on the CPU), so the
card's sums run in another order.

The recurrences whose formula the optimizer classes share (momentum SGD,
NAG, Signum, FTRL, FTML, the trust ratio, the norm) are written once here
(``*_step``, :func:`trust_ratio`, :func:`norm`) and
:mod:`mxnet_tpu_torch.optimizer` runs them; where the op's formula differs
from the class's (LAMB's op has no bounds but ``lamb_update_phase2``'s, Adam's
op no bias correction), the op follows the reference's op.

The row-sparse (lazy) updates (reference :256-380): the update cores of
SGD, AdaGrad, lazy Adam, FTRL and GroupAdaGrad for a row-sparse gradient
(``grad_rows`` (k, ...) for the rows ``indices`` (k,)), and the
registered ``sparse_sgd_update``, ``sparse_adagrad_update``,
``sparse_adam_update``, ``sparse_ftrl_update`` and the dense
``group_adagrad_update``.

Only the named rows of the weight and of its states move; every other row
keeps its bits. The cores write in place (``index_copy_`` /
``index_add_`` on the device, no host read), where the reference rebinds
donated buffers; the registered ops run them on copies and return those.
The arithmetic runs in float32 and each result is written in its target's
dtype; the hypers are rounded to float32 first, as the reference passes
them (``_f32``), so ``1 - beta2`` is ``1 - float32(0.999)`` there and
here.

Indices need not be sorted or unique, and they are taken as the reference
takes them: each entry's update is computed from the old rows, a
duplicated row that is *set* (weights, moments, histories) keeps the last
entry's value, and a row that is *added to* (AdaGrad's and GroupAdaGrad's
weights) receives every entry's delta.
"""
from __future__ import annotations

import numpy as onp
import torch

from ._core import last_wins
from ._core import promoted as _like
from .registry import register, register_alias

__all__ = ["sparse_sgd_", "sparse_adagrad_", "sparse_adam_",
           "sparse_ftrl_", "sparse_group_adagrad_"]


def _f32(*xs):
    """The hypers rounded to float32 (as Python floats)."""
    return [float(onp.float32(x)) for x in xs]


def _grad(grad_rows, rescale_grad, clip_gradient):
    """The rescaled gradient rows in float32, clipped to
    [-|clip|, clip] when ``clip_gradient`` > 0 (the reference's runtime
    clip: <= 0 turns it off)."""
    g = grad_rows.float() * rescale_grad
    if clip_gradient > 0:
        g = g.clamp(-abs(clip_gradient), clip_gradient)
    return g


def _set_rows(target, idx, rows, src):
    """``target[idx] = rows`` with duplicates resolved to the last entry."""
    target.index_copy_(0, idx, rows[src].to(target.dtype))


def sparse_sgd_(weight, grad_rows, indices, lr, wd, rescale_grad,
                clip_gradient):
    """Row-sparse SGD (reference :262): ``w[i] -= lr (g + wd w[i])``."""
    lr, wd, rescale_grad, clip_gradient = _f32(lr, wd, rescale_grad,
                                               clip_gradient)
    idx = indices.long()
    w_rows = weight.index_select(0, idx).float()
    g = _grad(grad_rows, rescale_grad, clip_gradient) + wd * w_rows
    _set_rows(weight, idx, w_rows - lr * g, last_wins(idx, weight.shape[0]))


def sparse_adagrad_(weight, history, grad_rows, indices, lr, wd, epsilon,
                    rescale_grad, clip_gradient):
    """Row-sparse AdaGrad (reference :274): history and weight move on the
    gradient's rows only."""
    lr, wd, epsilon, rescale_grad, clip_gradient = _f32(
        lr, wd, epsilon, rescale_grad, clip_gradient)
    idx = indices.long()
    g = _grad(grad_rows, rescale_grad, clip_gradient) + \
        wd * weight.index_select(0, idx).float()
    h_rows = history.index_select(0, idx) + g * g
    _set_rows(history, idx, h_rows, last_wins(idx, weight.shape[0]))
    weight.index_add_(0, idx, (-lr * g / (torch.sqrt(h_rows) + epsilon))
                      .to(weight.dtype))


def sparse_adam_(weight, mean, var, grad_rows, indices, lr, wd, beta1,
                 beta2, epsilon, rescale_grad, clip_gradient, bc1, bc2):
    """Lazy row-sparse Adam (reference :288): mean, var and weight move on
    the gradient's rows only; ``bc1``/``bc2`` are ``1 - beta ** t`` of the
    shared step count (inactive rows' moments do not decay)."""
    lr, wd, beta1, beta2, epsilon, rescale_grad, clip_gradient = _f32(
        lr, wd, beta1, beta2, epsilon, rescale_grad, clip_gradient)
    idx = indices.long()
    w_rows = weight.index_select(0, idx).float()
    g = _grad(grad_rows, rescale_grad, clip_gradient) + wd * w_rows
    m_rows = beta1 * mean.index_select(0, idx) + (1 - beta1) * g
    v_rows = beta2 * var.index_select(0, idx) + (1 - beta2) * g * g
    upd = lr * (m_rows / bc1) / (torch.sqrt(v_rows / bc2) + epsilon)
    src = last_wins(idx, weight.shape[0])
    _set_rows(weight, idx, w_rows - upd, src)
    _set_rows(mean, idx, m_rows, src)
    _set_rows(var, idx, v_rows, src)


def sparse_ftrl_(weight, z, n, grad_rows, indices, lr, lamda1, beta, wd,
                 rescale_grad, clip_gradient):
    """Row-sparse FTRL (reference :310): z, n and weight move on the
    gradient's rows only."""
    lr, lamda1, beta, wd, rescale_grad, clip_gradient = _f32(
        lr, lamda1, beta, wd, rescale_grad, clip_gradient)
    idx = indices.long()
    g = _grad(grad_rows, rescale_grad, clip_gradient)
    w_rows = weight.index_select(0, idx).float()
    n_rows = n.index_select(0, idx)
    sigma = (torch.sqrt(n_rows + g * g) - torch.sqrt(n_rows)) / lr
    z_rows = z.index_select(0, idx) + g - sigma * w_rows
    n_rows = n_rows + g * g
    new_w = torch.where(
        z_rows.abs() > lamda1,
        -(z_rows - torch.sign(z_rows) * lamda1) /
        ((beta + torch.sqrt(n_rows)) / lr + wd), torch.zeros_like(z_rows))
    src = last_wins(idx, weight.shape[0])
    _set_rows(weight, idx, new_w, src)
    _set_rows(z, idx, z_rows, src)
    _set_rows(n, idx, n_rows, src)


def sparse_group_adagrad_(weight, history, grad_rows, indices, lr, epsilon,
                          rescale_grad, clip_gradient):
    """Row-sparse GroupAdaGrad (reference :332): one history value a row,
    the mean of the squared gradient over the row's other axes."""
    lr, epsilon, rescale_grad, clip_gradient = _f32(lr, epsilon, rescale_grad,
                                                    clip_gradient)
    idx = indices.long()
    g = _grad(grad_rows, rescale_grad, clip_gradient)
    sq = (g * g).mean(dim=tuple(range(1, g.dim())), keepdim=True) \
        if g.dim() > 1 else g * g
    h_rows = history.index_select(0, idx) + sq
    _set_rows(history, idx, h_rows, last_wins(idx, weight.shape[0]))
    weight.index_add_(0, idx, (-lr * g / (torch.sqrt(h_rows) + epsilon))
                      .to(weight.dtype))


def _bc(beta, t):
    """``1 - beta ** t`` in float32, as the reference computes it."""
    return float(onp.float32(1) - onp.float32(beta) ** onp.float32(t))


@register("sparse_sgd_update")
def _sparse_sgd_update(lr=0.01, wd=0.0, rescale_grad=1.0,
                       clip_gradient=-1.0):
    def f(weight, grad_rows, indices):
        w = weight.clone()
        sparse_sgd_(w, grad_rows, indices, lr, wd, rescale_grad,
                    clip_gradient)
        return w

    return f


@register("sparse_adagrad_update", nout=2)
def _sparse_adagrad_update(lr=0.01, epsilon=1e-7, wd=0.0, rescale_grad=1.0,
                           clip_gradient=-1.0):
    def f(weight, history, grad_rows, indices):
        w, h = weight.clone(), history.clone()
        sparse_adagrad_(w, h, grad_rows, indices, lr, wd, epsilon,
                        rescale_grad, clip_gradient)
        return w, h

    return f


@register("sparse_adam_update", nout=3)
def _sparse_adam_update(lr=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                        wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                        t=1.0):
    def f(weight, mean, var, grad_rows, indices):
        w, m, v = weight.clone(), mean.clone(), var.clone()
        sparse_adam_(w, m, v, grad_rows, indices, lr, wd, beta1, beta2,
                     epsilon, rescale_grad, clip_gradient, _bc(beta1, t),
                     _bc(beta2, t))
        return w, m, v

    return f


@register("sparse_ftrl_update", nout=3)
def _sparse_ftrl_update(lr=0.1, lamda1=0.01, beta=1.0, wd=0.0,
                        rescale_grad=1.0, clip_gradient=-1.0):
    def f(weight, z, n, grad_rows, indices):
        w, zz, nn = weight.clone(), z.clone(), n.clone()
        sparse_ftrl_(w, zz, nn, grad_rows, indices, lr, lamda1, beta, wd,
                     rescale_grad, clip_gradient)
        return w, zz, nn

    return f


@register("group_adagrad_update", nout=2)
def _group_adagrad_update(lr=0.01, epsilon=1e-5, rescale_grad=1.0,
                          clip_gradient=-1.0):
    """Dense GroupAdaGrad (reference :375): one history value a row, kept
    as (rows,)."""
    def f(weight, history, grad):
        g = grad * rescale_grad
        if clip_gradient > 0:
            g = g.clamp(-clip_gradient, clip_gradient)
        h = history + (g * g).mean(dim=tuple(range(1, g.dim()))) \
            if g.dim() > 1 else history + g * g
        denom = torch.sqrt(h).reshape((-1,) + (1,) * (g.dim() - 1)) + \
            epsilon
        return weight - lr * g / denom, h

    return f


# ---------------------------------------------------------------------------
# the dense registered updates (reference :32-230, :396-872)
# ---------------------------------------------------------------------------
def norm(x):
    """The whole tensor's 2-norm (``jnp.linalg.norm`` of any shape), a 0-dim
    tensor of x's dtype on x's device. On the CPU it is summed in float64:
    torch's CPU norm of float32 sums in float32 lanes, which is 6.8e-4 off
    at 2.4 M values near 1 (a trust ratio's update), where the card's tree
    sum, and XLA's, are not."""
    if x.device.type == "cpu":
        return torch.linalg.vector_norm(x, dtype=torch.float64).to(x.dtype)
    return torch.linalg.vector_norm(x)


def trust_ratio(r1, r2):
    """``r1 / r2`` where both norms are positive, else 1."""
    return torch.where((r1 > 0) & (r2 > 0), r1 / r2, torch.ones_like(r1 / r2))


def sgd_mom_step(w, mom, g, lr, momentum):
    """Momentum SGD on a gradient that holds its weight decay."""
    mom = momentum * mom - lr * g
    return w + mom, mom


def nag_mom_step(w, mom, g, lr, momentum):
    """Nesterov momentum on a gradient that holds its weight decay."""
    mom = momentum * mom + g
    return w - lr * (g + momentum * mom), mom


def signum_step(w, mom, g, lr, momentum):
    """Signum's momentum and its signed step."""
    mom = momentum * mom - (1 - momentum) * g
    return w + lr * torch.sign(mom), mom


def ftrl_step(w, z, n, g, lr, lamda1, beta, wd):
    """FTRL-proximal: the new weight, z and n."""
    n_new = n + g * g
    sigma = (torch.sqrt(n_new) - torch.sqrt(n)) / lr
    z = z + g - sigma * w
    w = torch.where(z.abs() > lamda1,
                    -(z - torch.sign(z) * lamda1) /
                    ((beta + torch.sqrt(n_new)) / lr + wd),
                    torch.zeros_like(z))
    return w, z, n_new


def ftml_step(w, d, v, z, g, lr, beta1, beta2, epsilon, bc1, bc2):
    """FTML on a gradient that holds its weight decay; ``bc1``/``bc2`` are
    ``1 - beta ** t``. Returns the new weight, d, v and z."""
    v = beta2 * v + (1 - beta2) * g * g
    d_new = bc1 / lr * (torch.sqrt(v / bc2) + epsilon)
    z = beta1 * z + (1 - beta1) * g - (d_new - beta1 * d) * w
    return -z / d_new, d_new, v, z


def _clip(g, c):
    return g.clamp(-c, c) if c > 0 else g


def _wd_grad(weight, grad, wd, rescale_grad, clip_gradient):
    return _clip(grad * rescale_grad, clip_gradient) + wd * weight


def _fp32(x):
    return x.to(torch.float32)


@register("sgd_update")
def _sgd_update(lr=0.01, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                lazy_update=False):
    def f(weight, grad):
        return weight - lr * _wd_grad(weight, grad, wd, rescale_grad,
                                      clip_gradient)

    return f


@register("sgd_mom_update", nout=2)
def _sgd_mom_update(lr=0.01, momentum=0.9, wd=0.0, rescale_grad=1.0,
                    clip_gradient=-1.0, lazy_update=False):
    def f(weight, grad, mom):
        return sgd_mom_step(weight, mom, _wd_grad(
            weight, grad, wd, rescale_grad, clip_gradient), lr, momentum)

    return f


@register("nag_mom_update", nout=2)
def _nag_mom_update(lr=0.01, momentum=0.9, wd=0.0, rescale_grad=1.0,
                    clip_gradient=-1.0):
    def f(weight, grad, mom):
        return nag_mom_step(weight, mom, _wd_grad(
            weight, grad, wd, rescale_grad, clip_gradient), lr, momentum)

    return f


@register("signsgd_update")
def _signsgd_update(lr=0.01, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    def f(weight, grad):
        return weight - lr * torch.sign(_wd_grad(
            weight, grad, wd, rescale_grad, clip_gradient))

    return f


@register("signum_update", nout=2)
def _signum_update(lr=0.01, momentum=0.9, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0, wd_lh=0.0):
    def f(weight, grad, mom):
        w, mom = signum_step(weight, mom, _wd_grad(
            weight, grad, wd, rescale_grad, clip_gradient), lr, momentum)
        if wd_lh > 0:
            w = w - lr * wd_lh * weight
        return w, mom

    return f


@register("adam_update", nout=3)
def _adam_update(lr=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8, wd=0.0,
                 rescale_grad=1.0, clip_gradient=-1.0, lazy_update=False):
    """Adam without bias correction, as the reference's op (the optimizer
    corrects by rescaling ``lr``)."""
    def f(weight, grad, mean, var):
        g = _wd_grad(weight, grad, wd, rescale_grad, clip_gradient)
        m = beta1 * mean + (1 - beta1) * g
        v = beta2 * var + (1 - beta2) * g * g
        return weight - lr * m / (torch.sqrt(v) + epsilon), m, v

    return f


def _adamw_step(w, g, m, v, lr, eta, wd, beta1, beta2, epsilon, clip_c):
    g = _clip(g, clip_c)
    m = beta1 * m + (1 - beta1) * g
    v = beta2 * v + (1 - beta2) * g * g
    return w - lr * eta * (m / (torch.sqrt(v) + epsilon) + wd * w), m, v


def _adabelief_step(w, g, m, s, lr, eta, wd, beta1, beta2, epsilon, clip_c):
    g = _clip(g, clip_c)
    m = beta1 * m + (1 - beta1) * g
    s = beta2 * s + (1 - beta2) * torch.square(g - m) + epsilon
    return w - lr * eta * (m / (torch.sqrt(s) + epsilon) + wd * w), m, s


@register("adamw_update", nout=3)
def _adamw_update(lr=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8, wd=0.0,
                  eta=1.0, rescale_grad=1.0, clip_gradient=-1.0):
    """Decoupled weight decay (reference :105)."""
    def f(weight, grad, mean, var):
        return _adamw_step(weight, grad * rescale_grad, mean, var, lr, eta,
                           wd, beta1, beta2, epsilon, clip_gradient)

    return f


@register("adabelief_update", nout=3)
def _adabelief_update(lr=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                      wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    def f(weight, grad, mean, var):
        return _adabelief_step(weight, grad * rescale_grad, mean, var, lr,
                               1.0, wd, beta1, beta2, epsilon, clip_gradient)

    return f


@register("ftml_update", nout=4)
def _ftml_update(lr=0.001, beta1=0.6, beta2=0.999, epsilon=1e-8, t=1,
                 wd=0.0, rescale_grad=1.0, clip_grad=-1.0):
    def f(weight, grad, d, v, z):
        g = _wd_grad(weight, grad, wd, rescale_grad, clip_grad)
        return ftml_step(weight, d, v, z, g, lr, beta1, beta2, epsilon,
                         1 - beta1 ** t, 1 - beta2 ** t)

    return f


@register("ftrl_update", nout=3)
def _ftrl_update(lr=0.1, lamda1=0.01, beta=1.0, wd=0.0, rescale_grad=1.0,
                 clip_gradient=-1.0):
    def f(weight, grad, z, n):
        return ftrl_step(weight, z, n, _clip(grad * rescale_grad,
                                             clip_gradient),
                         lr, lamda1, beta, wd)

    return f


@register("rmsprop_update", nout=2)
def _rmsprop_update(lr=0.001, gamma1=0.95, epsilon=1e-8, wd=0.0,
                    rescale_grad=1.0, clip_gradient=-1.0,
                    clip_weights=-1.0):
    def f(weight, grad, n):
        g = _wd_grad(weight, grad, wd, rescale_grad, clip_gradient)
        n = gamma1 * n + (1 - gamma1) * g * g
        w = weight - lr * g / torch.sqrt(n + epsilon)
        return _clip(w, clip_weights), n

    return f


@register("rmspropalex_update", nout=4)
def _rmspropalex_update(lr=0.001, gamma1=0.95, gamma2=0.9, epsilon=1e-8,
                        wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    def f(weight, grad, n, g_state, delta):
        g = _wd_grad(weight, grad, wd, rescale_grad, clip_gradient)
        n = gamma1 * n + (1 - gamma1) * g * g
        g_new = gamma1 * g_state + (1 - gamma1) * g
        d = gamma2 * delta - lr * g / torch.sqrt(n - g_new * g_new + epsilon)
        return weight + d, n, g_new, d

    return f


def lamb_direction(w, g, m, v, wd, t, beta1, beta2, epsilon,
                   bias_correction=True):
    """LAMB's phase 1: the update direction, and the new moments."""
    m = beta1 * m + (1 - beta1) * g
    v = beta2 * v + (1 - beta2) * g * g
    mh, vh = (m / (1 - beta1 ** t), v / (1 - beta2 ** t)) \
        if bias_correction else (m, v)
    return mh / (torch.sqrt(vh) + epsilon) + wd * w, m, v


def _lamb_r1(r1_in, lower_bound, upper_bound):
    r1 = r1_in.reshape(())
    if lower_bound > 0:
        r1 = r1.clamp(min=lower_bound)
    if upper_bound > 0:
        r1 = r1.clamp(max=upper_bound)
    return r1


@register("lamb_update_phase1", nout=3)
def _lamb_phase1(beta1=0.9, beta2=0.999, epsilon=1e-6, t=1, wd=0.0,
                 bias_correction=True, rescale_grad=1.0, clip_gradient=-1.0):
    def f(weight, grad, mean, var):
        return lamb_direction(weight, _clip(grad * rescale_grad,
                                            clip_gradient), mean, var, wd, t,
                              beta1, beta2, epsilon, bias_correction)

    return f


@register("lamb_update_phase2")
def _lamb_phase2(lr=0.001, lower_bound=-1.0, upper_bound=-1.0):
    """The weight moved along phase 1's direction by ``lr`` times the trust
    ratio of the norms ``r1 = |w|`` (clamped to the bounds that are > 0)
    and ``r2 = |direction|``, one-element tensors (reference :223)."""
    def f(weight, g_update, r1_in, r2_in):
        r1 = _lamb_r1(r1_in, lower_bound, upper_bound)
        weight, g_update, r1, r2 = _like(weight, g_update, r1,
                                         r2_in.reshape(()))
        return weight - lr * trust_ratio(r1, r2) * g_update

    return f


@register("all_finite")
def _all_finite(init_output=True):
    def f(x):
        return torch.isfinite(x).all()

    return f


@register("multi_all_finite")
def _multi_all_finite(num_arrays=1, init_output=True):
    """A 0-d bool: every entry of every operand finite, on the operands'
    device (one reduction an operand, no host read)."""
    def f(*arrays):
        if not arrays:
            return torch.tensor(True)
        return torch.stack([torch.isfinite(a).all() for a in arrays]).all()

    return f


# -- mixed precision: an fp32 master operand, the weight its cast-back ------
@register("mp_sgd_update", nout=2)
def _mp_sgd_update(lr=0.01, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    def f(weight, grad, weight32):
        g = _clip(_fp32(grad) * rescale_grad, clip_gradient)
        w32 = weight32 - lr * (g + wd * weight32)
        return w32.to(weight.dtype), w32

    return f


@register("mp_sgd_mom_update", nout=3)
def _mp_sgd_mom_update(lr=0.01, momentum=0.9, wd=0.0, rescale_grad=1.0,
                       clip_gradient=-1.0):
    def f(weight, grad, mom, weight32):
        g = _clip(_fp32(grad) * rescale_grad, clip_gradient)
        w32, m = sgd_mom_step(weight32, mom, g + wd * weight32, lr, momentum)
        return w32.to(weight.dtype), m, w32

    return f


@register("mp_nag_mom_update", nout=3)
def _mp_nag_mom_update(lr=0.01, momentum=0.9, wd=0.0, rescale_grad=1.0,
                       clip_gradient=-1.0):
    def f(weight, grad, mom, weight32):
        g = _clip(_fp32(grad) * rescale_grad, clip_gradient) + wd * weight32
        w32, m = nag_mom_step(weight32, mom, g, lr, momentum)
        return w32.to(weight.dtype), m, w32

    return f


@register("mp_lamb_update_phase1", nout=3)
def _mp_lamb_phase1(beta1=0.9, beta2=0.999, epsilon=1e-6, t=1, wd=0.0,
                    bias_correction=True, rescale_grad=1.0,
                    clip_gradient=-1.0):
    def f(weight, grad, mean, var, weight32):
        return lamb_direction(weight32, _clip(_fp32(grad) * rescale_grad,
                                              clip_gradient), mean, var, wd,
                              t, beta1, beta2, epsilon, bias_correction)

    return f


@register("mp_lamb_update_phase2", nout=2)
def _mp_lamb_phase2(lr=0.001, lower_bound=-1.0, upper_bound=-1.0):
    def f(weight, g_update, r1_in, r2_in, weight32):
        r1 = _lamb_r1(r1_in, lower_bound, upper_bound)
        w32, g_update, r1, r2 = _like(weight32, g_update, r1,
                                      r2_in.reshape(()))
        w32 = w32 - lr * trust_ratio(r1, r2) * g_update
        return w32.to(weight.dtype), w32

    return f


@register("mp_adamw_update", nout=4)
def _mp_adamw_update(lr=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                     wd=0.0, eta=1.0, clip_gradient=-1.0):
    """Mixed-precision AdamW (reference :833); the trailing operand is the
    ``rescale_grad`` tensor."""
    def f(weight, grad, mean, var, weight32, rescale):
        w32, m, v = _adamw_step(weight32, _fp32(grad) * _fp32(rescale), mean,
                                var, lr, eta, wd, beta1, beta2, epsilon,
                                clip_gradient)
        return w32.to(weight.dtype), m, v, w32

    return f


@register("mp_adabelief_update", nout=4)
def _mp_adabelief_update(lr=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                         wd=0.0, eta=1.0, clip_gradient=-1.0):
    def f(weight, grad, mean, var, weight32, rescale):
        w32, m, s = _adabelief_step(weight32, _fp32(grad) * _fp32(rescale),
                                    mean, var, lr, eta, wd, beta1, beta2,
                                    epsilon, clip_gradient)
        return w32.to(weight.dtype), m, s, w32

    return f


# -- multi-tensor forms: operands interleaved a weight at a time, outputs
# flat in the same order; registered without ``nout`` (one Symbol entry) --
def _sgd_family(mom, mp, preloaded):
    """``multi_(mp_)sgd(_mom)_update`` and their ``preloaded_`` forms:
    operands (w, g[, mom][, w32]) a weight, and for ``preloaded_`` the
    ``lrs`` and ``wds`` tensors last (reference :401, :523-630)."""
    k = 2 + mom + mp

    def make(lrs=(), wds=(), momentum=0.9, rescale_grad=1.0,
             clip_gradient=-1.0, num_weights=1):
        def f(*args):
            lr_t, wd_t = (args[-2], args[-1]) if preloaded else (lrs, wds)
            out = []
            for i in range(num_weights):
                op = args[k * i:k * i + k]
                w = op[0]
                w32 = op[-1] if mp else w
                g = _clip((_fp32(op[1]) if mp else op[1]) * rescale_grad,
                          clip_gradient)
                lr, wd = lr_t[i], wd_t[i]
                if preloaded:       # 0-dim tensors: JAX's promotion
                    w32, g, lr, wd = _like(w32, g, lr, wd)
                if mom:
                    w_new, m_new = sgd_mom_step(w32, op[2], g + wd * w32,
                                                lr, momentum)
                else:
                    w_new = w32 - lr * (g + wd * w32)
                states = [m_new] if mom else []
                out.extend([w_new.to(w.dtype)] + states + [w_new] if mp else
                           [w_new] + states)
            return tuple(out)

        return f

    return make


def _register_sgd_family():
    for mom in (0, 1):
        for mp in (0, 1):
            for pre in (0, 1):
                name = ("preloaded_" if pre else "") + "multi_" + \
                    ("mp_" if mp else "") + "sgd_" + ("mom_" if mom else "") \
                    + "update"
                register(name, _sgd_family(mom, mp, pre))


_register_sgd_family()


def _multi_rescaled(step, mp):
    """``multi_(mp_)adamw``/``adabelief``: operands (w, g, m, v[, w32]) a
    weight, then the ``rescale_grad`` tensor shared by all."""
    def make(lrs=(), wds=(), etas=(), beta1=0.9, beta2=0.999, epsilon=1e-8,
             clip_gradient=-1.0, num_weights=1):
        k = 4 + mp

        def f(*args):
            rescale = _fp32(args[-1])
            out = []
            for i in range(num_weights):
                w, g, m, v = args[k * i:k * i + 4]
                w32 = args[k * i + 4] if mp else w
                g, r = _like(_fp32(g) if mp else g, rescale)
                w_new, m, v = step(w32, g * r, m, v, lrs[i], etas[i], wds[i],
                                   beta1, beta2, epsilon, clip_gradient)
                out.extend([w_new.to(w.dtype), m, v, w_new] if mp else
                           [w_new, m, v])
            return tuple(out)

        return f

    return make


register("multi_adamw_update", _multi_rescaled(_adamw_step, 0))
register("multi_mp_adamw_update", _multi_rescaled(_adamw_step, 1))
register("multi_adabelief_update", _multi_rescaled(_adabelief_step, 0))
register("multi_mp_adabelief_update", _multi_rescaled(_adabelief_step, 1))


def _lamb_step(w, g, m, v, lr, wd, t, beta1, beta2, epsilon, clip_c,
               bias_correction):
    upd, m, v = lamb_direction(w, _clip(g, clip_c), m, v, wd, t, beta1,
                               beta2, epsilon, bias_correction)
    return w - lr * trust_ratio(norm(w), norm(upd)) * upd, m, v


def _lans_step(w, g, m, v, lr, wd, t, beta1, beta2, epsilon, clip_c,
               bias_correction=True):
    """LANS (reference :729): the gradient normalised by its norm, then two
    parts, the moment's and the gradient's, each with its own trust
    ratio."""
    gn = norm(g)
    g = _clip(torch.where(gn > 0, g / gn, g), clip_c)
    m = beta1 * m + (1 - beta1) * g
    v = beta2 * v + (1 - beta2) * g * g
    denom = torch.sqrt(v / (1 - beta2 ** t)) + epsilon
    r1 = norm(w)
    part_m = m / (1 - beta1 ** t) / denom + wd * w
    part_g = g / denom + wd * w
    w = w - lr * (beta1 * trust_ratio(r1, norm(part_m)) * part_m +
                  (1 - beta1) * trust_ratio(r1, norm(part_g)) * part_g)
    return w, m, v


def _multi_trust(step, mp):
    """``multi_(mp_)lamb``/``lans``: operands (w, g, m, v[, w32]) a
    tensor; ``rescale_grad`` an attribute."""
    def make(learning_rates=(), wds=(), step_count=(), beta1=0.9,
             beta2=0.999, epsilon=1e-6, rescale_grad=1.0, clip_gradient=-1.0,
             bias_correction=True, num_tensors=1):
        k = 4 + mp

        def f(*args):
            out = []
            for i in range(num_tensors):
                w, g, m, v = args[k * i:k * i + 4]
                w32 = args[k * i + 4] if mp else w
                w_new, m, v = step(w32, (_fp32(g) if mp else g) * rescale_grad,
                                   m, v, learning_rates[i], wds[i],
                                   step_count[i], beta1, beta2, epsilon,
                                   clip_gradient, bias_correction)
                out.extend([w_new.to(w.dtype), m, v, w_new] if mp else
                           [w_new, m, v])
            return tuple(out)

        return f

    return make


register("multi_lamb_update", _multi_trust(_lamb_step, 0))
register("multi_mp_lamb_update", _multi_trust(_lamb_step, 1))


def _lans_make(mp):
    make = _multi_trust(_lans_step, mp)

    def lans(learning_rates=(), wds=(), step_count=(), beta1=0.9,
             beta2=0.999, epsilon=1e-6, rescale_grad=1.0, clip_gradient=-1.0,
             num_tensors=1):
        return make(learning_rates, wds, step_count, beta1, beta2, epsilon,
                    rescale_grad, clip_gradient, True, num_tensors)

    return lans


register("multi_lans_update", _lans_make(0))
register("multi_mp_lans_update", _lans_make(1))

# the reference's underscore dispatch names (its contrib registrations)
for _legacy, _tgt in {
    "_multi_adamw_update": "multi_adamw_update",
    "_multi_mp_adamw_update": "multi_mp_adamw_update",
    "_multi_lamb_update": "multi_lamb_update",
    "_multi_mp_lamb_update": "multi_mp_lamb_update",
    "_multi_lans_update": "multi_lans_update",
    "_multi_mp_lans_update": "multi_mp_lans_update",
    "_multi_adabelief_update": "multi_adabelief_update",
    "_multi_mp_adabelief_update": "multi_mp_adabelief_update",
    "_mp_adamw_update": "mp_adamw_update",
    "_mp_adabelief_update": "mp_adabelief_update",
}.items():
    register_alias(_legacy, _tgt)
