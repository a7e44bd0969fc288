"""The port's ops over ``mxnet_tpu/ops/extra.py``: ``batch_dot`` (:22),
the window functions and numpy stragglers (``blackman``, ``hamming``,
``hanning``, ``diagflat``, ``fill_diagonal``, ``rollaxis``, ``polyval``,
``tril_indices``, :505-560) and the CSR x dense product ``dot_csr``
(:563), in plain torch on the operands' device.

``dot_csr`` is a gather of the dense rows each stored entry touches, a
multiply by the entry's value and a segment sum (``index_add``) into the
output rows: static shapes, no host read, and autograd gives the dense
operand (and the values) their gradients through the gather's and the
sum's own backward, again a scatter and a gather. On the card
``index_add`` adds with atomics, so its sums are not in the CPU's order.

The rest of the reference's ``extra.py`` (interleaved matmuls, MultiBox,
im2col, ...) is ROADMAP A9.
"""
from __future__ import annotations

import math

import torch

from ..context import resolve_device
from .registry import register

__all__ = []


@register("batch_dot")
def _batch_dot(transpose_a=False, transpose_b=False):
    def f(a, b):
        x = a.transpose(-1, -2) if transpose_a else a
        y = b.transpose(-1, -2) if transpose_b else b
        return torch.matmul(x, y)

    return f


def _window(kind, M, ctx):
    """numpy's window of length ``M`` in float32 (numpy's formulas, as
    ``jnp.blackman`` etc. compute them)."""
    dev = resolve_device(ctx)
    if M < 1:
        return torch.zeros(0, dtype=torch.float32, device=dev)
    if M == 1:
        return torch.ones(1, dtype=torch.float32, device=dev)
    n = torch.arange(1 - M, M, 2, dtype=torch.float64, device=dev)
    x = math.pi * n / (M - 1)
    if kind == "blackman":
        w = 0.42 + 0.5 * torch.cos(x) + 0.08 * torch.cos(2 * x)
    elif kind == "hamming":
        w = 0.54 + 0.46 * torch.cos(x)
    else:
        w = 0.5 + 0.5 * torch.cos(x)
    return w.float()


for _kind in ("blackman", "hamming", "hanning"):
    register(_kind, lambda M=10, ctx=None, _k=_kind, **a:
             (lambda: _window(_k, M, ctx)), differentiable=False)


@register("diagflat")
def _diagflat(k=0):
    def f(x):
        return torch.diagflat(x.reshape(-1), k)

    return f


def _resize(v, n):
    """numpy's ``resize`` of a 1-D view of ``v`` to ``n`` values (the
    values repeated cyclically)."""
    flat = v.reshape(-1)
    reps = -(-n // max(flat.numel(), 1))
    return flat.repeat(reps)[:n]


@register("fill_diagonal")
def _fill_diagonal(val=None, wrap=False):
    """numpy.fill_diagonal over flat strides: for 2-D the diagonal is
    ``a.flat[:end:ncols+1]`` with ``end = ncols * ncols`` for tall
    matrices unless ``wrap``; ``val`` a scalar attribute or an array
    operand (tiled as numpy tiles it)."""
    def f(x, *val_arr):
        if x.dim() != 2:
            n = x.shape[0]
            idx = (torch.arange(n, device=x.device),) * x.dim()
            v = _resize(val_arr[0], n) if val_arr else \
                torch.full((n,), val, dtype=x.dtype, device=x.device)
            return x.index_put(idx, v.to(x.dtype))
        rows, cols = x.shape
        end = x.numel() if (wrap or rows <= cols) else cols * cols
        pos = torch.arange(0, end, cols + 1, device=x.device)
        vals = _resize(val_arr[0], pos.numel()) if val_arr else \
            torch.full(pos.shape, val, dtype=x.dtype, device=x.device)
        flat = x.reshape(-1).index_put((pos,), vals.to(x.dtype))
        return flat.reshape(x.shape)

    return f


@register("rollaxis")
def _rollaxis(axis=0, start=0):
    def f(x):
        n = x.dim()
        ax = axis % n
        st = start + n if start < 0 else start
        if ax < st:
            st -= 1
        if ax == st:
            return x
        return torch.movedim(x, ax, st)

    return f


@register("polyval")
def _polyval():
    def f(p, x):
        y = torch.zeros_like(x * p[0]) if p.numel() else torch.zeros_like(x)
        for i in range(p.shape[0]):   # Horner, as jnp.polyval
            y = y * x + p[i]
        return y

    return f


@register("tril_indices", differentiable=False)
def _tril_indices(n=1, k=0, m=None, ctx=None):
    def f():
        idx = torch.tril_indices(n, n if m is None else m, k,
                                 device=resolve_device(ctx))
        return idx[0].int(), idx[1].int()

    return f


@register("dot_csr")
def _dot_csr(num_rows=0, transpose_a=False):
    """CSR x dense (reference :563): values (nnz,), col_ids (nnz,), row_ids
    (nnz,), dense (K,) or (K, N) -> (num_rows,) or (num_rows, N)."""

    def f(values, col_ids, row_ids, dense):
        out_ids = (col_ids if transpose_a else row_ids).long()
        gather_ids = (row_ids if transpose_a else col_ids).long()
        g = dense.index_select(0, gather_ids)
        contrib = values[:, None] * g if g.dim() > 1 else values * g
        out = torch.zeros((int(num_rows),) + tuple(dense.shape[1:]),
                          dtype=contrib.dtype, device=contrib.device)
        return out.index_add(0, out_ids, contrib)

    return f
