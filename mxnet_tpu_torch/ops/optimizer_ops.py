"""Row-sparse (lazy) optimizer updates of the port.

Counterpart of ``mxnet_tpu/ops/optimizer_ops.py:256-380``: the update cores
of SGD, AdaGrad, lazy Adam, FTRL and GroupAdaGrad for a row-sparse
gradient (``grad_rows`` (k, ...) for the rows ``indices`` (k,)), and the
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
from .registry import register

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
