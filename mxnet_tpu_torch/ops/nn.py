"""Neural-network operators of the port: plain functions on tensors.

Counterpart of ``mxnet_tpu/ops/nn.py`` for the operators the GPT training
and serving paths call. The matrix products and elementwise work stay plain
PyTorch, as the reference leaves them to XLA; LayerNorm and masked
attention (forward and backward) route to the hand-written kernels in
:mod:`.cuda_kernels`.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import autograd as _ag
from .. import random as _random
from ..base import MXNetError
from . import cuda_kernels as _kern

__all__ = ["fully_connected", "layer_norm", "embedding", "leaky_relu",
           "dropout", "softmax", "log_softmax", "pick", "one_hot",
           "multihead_attention", "flash_attention"]

_NEG_INF = -1e30


def fully_connected(x, weight, bias=None, flatten=True):
    """y = x W^T (+ b); weight layout (units, in_units) (reference :31)."""
    if flatten and x.dim() > 2:
        x = x.reshape(x.shape[0], -1)
    y = torch.matmul(x, weight.t())
    if bias is not None:
        y = y + bias
    return y


def layer_norm(x, gamma, beta, axis=-1, eps=1e-5):
    """LayerNorm over ``axis`` (reference :255). The last axis runs the
    fused row kernel; any other axis the plain formula."""
    ax = axis if axis >= 0 else x.dim() + axis
    if ax == x.dim() - 1:
        return _kern.fused_layer_norm(x.contiguous(), gamma, beta, eps)
    mean = x.mean(dim=ax, keepdim=True)
    var = x.var(dim=ax, unbiased=False, keepdim=True)
    inv = torch.rsqrt(var.float() + eps).to(x.dtype)
    shape = [1] * x.dim()
    shape[ax] = x.shape[ax]
    return (x - mean) * inv * gamma.reshape(shape) + beta.reshape(shape)


def embedding(idx, weight):
    """Rows of ``weight`` at integer ``idx`` (reference :418)."""
    return weight[idx.long()]


def leaky_relu(x, alpha=None, act_type="leaky", slope=0.25):
    """The reference's LeakyReLU family (reference :341); ``gelu`` is the
    exact erf form, ``gelu_tanh`` the tanh approximation."""
    if act_type == "leaky":
        return F.leaky_relu(x, slope)
    if act_type == "elu":
        return F.elu(x, slope)
    if act_type == "selu":
        return F.selu(x)
    if act_type == "gelu":
        return F.gelu(x, approximate="none")
    if act_type == "gelu_tanh":
        return F.gelu(x, approximate="tanh")
    if act_type == "prelu":
        return torch.where(x >= 0, x, alpha * x)
    raise MXNetError(f"unknown leaky_relu variant {act_type!r}")


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
    keep = 1.0 - p
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x)).to(x.dtype)


def softmax(x, axis=-1, temperature=None, length=None):
    """Softmax over ``axis`` (reference :357); ``length`` (B,) masks each
    row's positions >= its length."""
    z = x / temperature if temperature not in (None, 1.0) else x
    if length is not None:
        ax = axis if axis >= 0 else x.dim() + axis
        shape = [1] * x.dim()
        shape[ax] = x.shape[ax]
        idx = torch.arange(x.shape[ax], device=x.device).reshape(shape)
        lshape = [1] * x.dim()
        lshape[0] = x.shape[0]
        z = torch.where(idx < length.reshape(lshape), z,
                        torch.full_like(z, float("-inf")))
    return torch.softmax(z, dim=axis)


def log_softmax(x, axis=-1):
    """Log-softmax over ``axis`` (reference :369)."""
    return torch.log_softmax(x, dim=axis)


def pick(x, index, axis=-1, keepdims=False):
    """``x``'s entries at ``index`` along ``axis`` (reference :476);
    ``index`` has x's shape without that axis and is clamped into range
    (the reference's default mode, ``"clip"``)."""
    idx = index.long().clamp(0, x.shape[axis] - 1)
    out = torch.gather(x, axis, idx.unsqueeze(axis))
    return out if keepdims else out.squeeze(axis)


def one_hot(indices, depth, dtype=torch.float32):
    """One-hot over the last axis; an index outside [0, depth) gives the
    zero vector, as the reference's ``one_hot`` (F.one_hot would raise)."""
    ar = torch.arange(depth, device=indices.device)
    return (indices.unsqueeze(-1) == ar).to(dtype)


def multihead_attention(q, k, v, mask=None, num_heads=1, causal=False,
                        scale=None, num_kv_heads=None):
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
    if mask is None:
        out = _kern.flash_attention(qh.contiguous(), kh.contiguous(),
                                    vh.contiguous(), s, causal)
    elif mask.dim() == 4 and mask.shape[1] == 1 and mask.shape[2] == 1 and \
            mask.shape[0] == B and mask.shape[3] == Tk and Tq == Tk:
        seg = (mask.reshape(B, Tk) != 0).to(torch.int32)
        out = _kern.flash_attention(qh.contiguous(), kh.contiguous(),
                                    vh.contiguous(), s, causal,
                                    q_segment_ids=torch.ones_like(seg),
                                    kv_segment_ids=seg)
    else:
        logits = torch.matmul(qh, kh.transpose(-1, -2)) * s
        neg = torch.full_like(logits, _NEG_INF)
        if causal:
            cm = torch.ones((Tq, Tk), dtype=torch.bool,
                            device=q.device).tril(Tk - Tq)
            logits = torch.where(cm, logits, neg)
        logits = torch.where(mask.to(torch.bool), logits, neg)
        w = torch.softmax(logits, dim=-1)
        out = torch.matmul(w, vh)
    return out.transpose(1, 2).reshape(B, Tq, E)


def flash_attention(q, k, v, *segments, causal=False, scale=None):
    """The ``flash_attention`` op (reference :599): canonical (B, H, T, D)
    operands; rank-2/3 operands are lifted to rank 4 and the output
    restored. Optional 4th/5th inputs: (B, Tq)/(B, Tk) segment ids (one
    id given is used for both sides)."""
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
                                q_segment_ids=q_seg, kv_segment_ids=k_seg)
    if ndim == 2:
        return out[0, 0]
    if ndim == 3:
        return out[:, 0]
    return out
