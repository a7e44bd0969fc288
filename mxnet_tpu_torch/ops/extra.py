"""The port's ops over ``mxnet_tpu/ops/extra.py``, all of them: ``batch_dot``
(:22), ``khatri_rao`` (:32), the four interleaved attention products
(``interleaved_matmul_selfatt_qk``/``_valatt``,
``interleaved_matmul_encdec_qk``/``_valatt``, :44-105),
``depth_to_space``/``space_to_depth`` (:108-133), ``im2col``/``col2im``
(:134-188), ``reverse``, ``batch_take``, ``argmax_channel``,
``shape_array``, ``size_array``, ``arange_like``, ``allclose``,
``index_copy``, ``quadratic``, ``softmin``, ``masked_log_softmax``,
``softmax_cross_entropy``, ``amp_cast`` and ``amp_multicast`` (:190-323),
``bipartite_matching`` (:326), the MultiBox trio ``multibox_prior``/
``multibox_target``/``multibox_detection`` (:370-503), the window functions
and numpy stragglers (``blackman``, ``hamming``, ``hanning``, ``diagflat``,
``fill_diagonal``, ``rollaxis``, ``polyval``, ``tril_indices``, :505-560)
and the CSR x dense product ``dot_csr`` (:563), in plain torch on the
operands' device.

The interleaved products read a fused projection whose last axis is laid
out per head as (H, 3, D) (self-attention: q, k, v) or (H, 2, D)
(encoder-decoder: k, v), as MXNet's ``transformer.cc``; ``*_qk`` scales q by
1/sqrt(D) in q's dtype before the product and returns (B H, Tq, Tk), and
``*_valatt`` returns (Tq, B, H D). The products are ``torch.matmul`` in the
operands' promoted dtype (the reference's ``jnp.einsum``, not a Pallas
kernel). ``im2col``/``col2im`` are the reference's strided slices of the
padded image, a stack and a sum of slices (overlaps add, so the card's
``col2im`` sums in its own order). ``arange_like`` rounds ``start + step *
i`` once to float32 (computed in double, where the float32 product is
exact), as the reference's XLA program fuses the multiply-add, then casts to
x's dtype. ``index_copy`` keeps the reference's winner where an index
repeats: the last row given (XLA's scatter on the CPU), found by a
scatter-max of the positions, the same on every device, where CUDA's
``index_copy_`` keeps an arbitrary one; only the winning row takes the
gradient. ``masked_log_softmax`` gives -inf at masked entries (a fully
masked row all -inf, its gradient 0); ``softmax_cross_entropy`` returns the
(1,)-shaped sum; ``shape_array``/``size_array`` int64, narrowed to the
reference's int32 by ``invoke``; ``amp_multicast`` casts to the widest
operand by item size (the narrowest under ``cast_narrow``), the first on a
tie.

``dot_csr`` is a gather of the dense rows each stored entry touches, a
multiply by the entry's value and a segment sum (``index_add``) into the
output rows: static shapes, no host read, and autograd gives the dense
operand (and the values) their gradients through the gather's and the
sum's own backward, again a scatter and a gather. On the card
``index_add`` adds with atomics, so its sums are not in the CPU's order.

``bipartite_matching``'s greedy sweep is a Python loop over the rows, a
few device operations a row and no host read. ``multibox_prior`` makes the
anchors in float32 on the device from ``arange`` (no host data, so a
captured SSD body makes them in its program), a product and a sum each
rounded; the reference's XLA program on the CPU contracts some of those
multiply-adds into fused ones (one rounding), lane by lane as its code
generator chooses, so its anchors lie within one ulp of the port's.
``multibox_target`` keeps the reference's two-stage match: every valid
ground truth claims its best anchor, where the reference scatters
``best_gt.at[best_anchor].set(..)``.
Two ground truths can share a best anchor (and a padded row, whose IoU
column is all -1, names anchor 0 and writes back the value it read); XLA's
scatter on the CPU keeps the last write in row order, and the port keeps
the same one on every device by a scatter-max of the row positions (CUDA's
``index_put_`` with repeated indices keeps an arbitrary one). Hard
negative mining ranks by a stable ``argsort``, as ``jnp.argsort``, and
compares the rank with the float32 budget ``ratio * sum(pos)``.
"""
from __future__ import annotations

import math

import numpy as onp
import torch

from ..base import dtype_name, to_dtype
from ..context import resolve_device
from .registry import get_op, register
from .vision import _pair_iou

__all__ = []


@register("batch_dot")
def _batch_dot(transpose_a=False, transpose_b=False):
    def f(a, b):
        x = a.transpose(-1, -2) if transpose_a else a
        y = b.transpose(-1, -2) if transpose_b else b
        return torch.matmul(x, y)

    return f


@register("khatri_rao")
def _khatri_rao():
    """Column-wise Kronecker product of (n_i, k) matrices (reference :32)."""
    def f(*mats):
        out = mats[0]
        for m in mats[1:]:
            out = (out[:, None, :] * m[None, :, :]).reshape(
                out.shape[0] * m.shape[0], -1)
        return out

    return f


def _bmm(a, b):
    """``a @ b`` in the promoted dtype of the two (``jnp.einsum``'s; a
    torch product refuses mixed dtypes)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.to(dt), b.to(dt))


def _heads(x, heads, parts, part):
    """Part ``part`` of ``x`` (T, B, parts * H * D) interleaved per head as
    (H, parts, D): (B, H, T, D)."""
    t, b, e = x.shape
    d = e // (parts * heads)
    return x.reshape(t, b, heads, parts, d)[..., part, :].permute(1, 2, 0, 3)


@register("interleaved_matmul_selfatt_qk")
def _imm_selfatt_qk(heads=1):
    """q k^T / sqrt(D) of a fused (T, B, 3 H D) projection interleaved per
    head as (H, 3, D) (reference :44): (B H, T, T). q is scaled before the
    product, in its own dtype."""
    def f(qkv):
        t, b, e3 = qkv.shape
        d = e3 // (3 * heads)
        q, k = _heads(qkv, heads, 3, 0), _heads(qkv, heads, 3, 1)
        out = _bmm(q * (1.0 / (d ** 0.5)), k.transpose(-1, -2))
        return out.reshape(b * heads, t, t)

    return f


@register("interleaved_matmul_selfatt_valatt")
def _imm_selfatt_valatt(heads=1):
    """The attention (B H, T, T) applied to v of the fused projection
    (reference :59): (T, B, H D)."""
    def f(qkv, att):
        t, b, _ = qkv.shape
        v = _heads(qkv, heads, 3, 2)
        out = _bmm(att.reshape(b, heads, t, t), v)
        return out.permute(2, 0, 1, 3).reshape(t, b, -1)

    return f


@register("interleaved_matmul_encdec_qk")
def _imm_encdec_qk(heads=1):
    """q k^T / sqrt(D) of a query (Tq, B, H D) and a fused key-value
    projection (Tk, B, 2 H D) interleaved as (H, 2, D) (reference :73):
    (B H, Tq, Tk)."""
    def f(q_proj, kv_proj):
        tq, b, e = q_proj.shape
        d = e // heads
        q = q_proj.reshape(tq, b, heads, d).permute(1, 2, 0, 3)
        k = _heads(kv_proj, heads, 2, 0)
        out = _bmm(q * (1.0 / (d ** 0.5)), k.transpose(-1, -2))
        return out.reshape(b * heads, tq, kv_proj.shape[0])

    return f


@register("interleaved_matmul_encdec_valatt")
def _imm_encdec_valatt(heads=1):
    """The attention (B H, Tq, Tk) applied to v of the fused key-value
    projection (reference :90): (Tq, B, H D)."""
    def f(kv_proj, att):
        tk, b, _ = kv_proj.shape
        v = _heads(kv_proj, heads, 2, 1)
        tq = att.shape[1]
        out = _bmm(att.reshape(b, heads, tq, tk), v)
        return out.permute(2, 0, 1, 3).reshape(tq, b, -1)

    return f


@register("depth_to_space")
def _depth_to_space(block_size=2):
    s = block_size

    def f(x):
        n, c, h, w = x.shape
        r = x.reshape(n, s, s, c // (s * s), h, w)
        return r.permute(0, 3, 4, 1, 5, 2).reshape(
            n, c // (s * s), h * s, w * s)

    return f


@register("space_to_depth")
def _space_to_depth(block_size=2):
    s = block_size

    def f(x):
        n, c, h, w = x.shape
        r = x.reshape(n, c, h // s, s, w // s, s)
        return r.permute(0, 3, 5, 1, 2, 4).reshape(
            n, c * s * s, h // s, w // s)

    return f


def _out_side(n, k, s, d, p):
    return (n + 2 * p - d * (k - 1) - 1) // s + 1


@register("im2col")
def _im2col(kernel=(3, 3), stride=(1, 1), dilate=(1, 1), pad=(0, 0)):
    """Convolution patches as columns (reference :134): (N, C, H, W) ->
    (N, C kh kw, L), one strided slice of the padded input a kernel
    position."""
    kh, kw = kernel
    sh, sw = stride
    dh, dw = dilate
    ph, pw = pad

    def f(x):
        n, c, h, w = x.shape
        xp = torch.nn.functional.pad(x, (pw, pw, ph, ph))
        oh, ow = _out_side(h, kh, sh, dh, ph), _out_side(w, kw, sw, dw, pw)
        cols = [xp[:, :, i * dh:i * dh + oh * sh:sh,
                   j * dw:j * dw + ow * sw:sw].reshape(n, c, oh * ow)
                for i in range(kh) for j in range(kw)]
        return torch.stack(cols, 2).reshape(n, c * kh * kw, oh * ow)

    return f


@register("col2im")
def _col2im(output_size=(4, 4), kernel=(3, 3), stride=(1, 1), dilate=(1, 1),
            pad=(0, 0)):
    """Columns folded back into an image, overlaps summed (im2col's
    adjoint, reference :162): (N, C kh kw, L) -> (N, C, H, W)."""
    kh, kw = kernel
    sh, sw = stride
    dh, dw = dilate
    ph, pw = pad
    H, W = output_size

    def f(col):
        n = col.shape[0]
        c = col.shape[1] // (kh * kw)
        oh, ow = _out_side(H, kh, sh, dh, ph), _out_side(W, kw, sw, dw, pw)
        colr = col.reshape(n, c, kh * kw, oh, ow)
        out = torch.zeros((n, c, H + 2 * ph, W + 2 * pw), dtype=col.dtype,
                          device=col.device)
        for i in range(kh):
            for j in range(kw):
                out[:, :, i * dh:i * dh + oh * sh:sh,
                    j * dw:j * dw + ow * sw:sw] += colr[:, :, i * kw + j]
        return out[:, :, ph:ph + H, pw:pw + W]

    return f


@register("reverse")
def _reverse(axis=0):
    dims = [axis] if isinstance(axis, int) else list(axis)

    def f(x):
        return torch.flip(x, dims)

    return f


@register("batch_take")
def _batch_take():
    """``x[..., idx]`` a row (reference :200): x (..., n), idx (...)."""
    def f(x, idx):
        i = idx.long()
        i = torch.where(i < 0, i + x.shape[-1], i)
        return torch.gather(x, -1, i[..., None])[..., 0]

    return f


@register("argmax_channel")
def _argmax_channel():
    def f(x):
        return torch.argmax(x, dim=1).to(x.dtype)

    return f


@register("shape_array", differentiable=False)
def _shape_array():
    def f(x):
        return torch.tensor(x.shape, dtype=torch.int64, device=x.device)

    return f


@register("size_array", differentiable=False)
def _size_array():
    def f(x):
        return torch.tensor([x.numel()], dtype=torch.int64, device=x.device)

    return f


@register("arange_like", differentiable=False)
def _arange_like(start=0.0, step=1.0, axis=None):
    """``start + step * arange(n)`` in float32, cast to x's dtype, over x's
    shape (``axis`` None) or along ``axis`` (reference :224). The float32
    value is rounded once from the exact one (the double's, whose product
    of two float32 values is exact), as the reference's XLA program, which
    fuses the multiply-add, gives it."""
    st, sp = float(onp.float32(start)), float(onp.float32(step))

    def f(x):
        n = x.numel() if axis is None else x.shape[axis]
        r = torch.arange(n, dtype=torch.float32, device=x.device)
        r = (st + sp * r.double()).float().to(x.dtype)
        return r.reshape(x.shape) if axis is None else r

    return f


@register("allclose", differentiable=False)
def _allclose(rtol=1e-5, atol=1e-8, equal_nan=False):
    """A 0-d bool (reference :236)."""
    def f(a, b):
        dt = torch.promote_types(a.dtype, b.dtype)
        return torch.isclose(a.to(dt), b.to(dt), rtol=rtol, atol=atol,
                             equal_nan=equal_nan).all()

    return f


@register("index_copy")
def _index_copy():
    """Rows of ``new`` copied into ``old`` at ``index`` (reference :245).
    Where an index repeats, the last of its rows wins, as XLA's scatter on
    the CPU keeps it, on every device (a scatter-max of the positions,
    where CUDA's ``index_copy_`` keeps an arbitrary one); the winner alone
    takes the gradient."""
    def f(old, index, new):
        n = old.shape[0]
        i = index.long()
        i = torch.where(i < 0, i + n, i)
        pos = torch.arange(i.numel(), device=i.device)
        win = torch.full((n,), -1, dtype=pos.dtype, device=i.device)
        win = win.scatter_reduce(0, i, pos, reduce="amax")
        rows = new.index_select(0, win.clamp(min=0)).to(old.dtype)
        took = (win >= 0).reshape((n,) + (1,) * (old.dim() - 1))
        return torch.where(took, rows, old)

    return f


@register("quadratic")
def _quadratic(a=0.0, b=0.0, c=0.0):
    def f(x):
        return a * x * x + b * x + c

    return f


@register("softmin")
def _softmin(axis=-1):
    def f(x):
        return torch.softmax(-x, dim=axis)

    return f


@register("masked_log_softmax")
def _masked_log_softmax(axis=-1):
    """log_softmax over the unmasked entries, -inf at the masked ones (a
    fully masked row all -inf, its gradient zero; reference :280)."""
    def f(x, mask):
        m = mask.bool()
        ninf = torch.tensor(float("-inf"), dtype=x.dtype, device=x.device)
        out = torch.log_softmax(torch.where(m, x, ninf), dim=axis)
        return torch.where(m, out, ninf)

    return f


@register("softmax_cross_entropy")
def _softmax_cross_entropy():
    """The summed cross entropy of (N, C) logits against (N,) labels, shape
    (1,) (reference :291)."""
    def f(data, label):
        logp = torch.log_softmax(data, dim=-1)
        picked = torch.gather(logp, -1, label.long()[:, None])
        return -picked.sum().reshape((1,))

    return f


@register("amp_cast")
def _amp_cast(dtype="float16"):
    tgt = to_dtype(dtype_name(dtype))

    def f(x):
        return x.to(tgt)

    return f


@register("amp_multicast")
def _amp_multicast(num_outputs=1, cast_narrow=False):
    """Every operand cast to the widest operand's dtype by item size (the
    narrowest under ``cast_narrow``), the first on a tie (reference
    :312)."""
    def f(*xs):
        widths = [x.element_size() for x in xs]
        pick = (min if cast_narrow else max)(range(len(xs)),
                                             key=lambda i: widths[i])
        return tuple(x.to(xs[pick].dtype) for x in xs)

    return f


def _last_write(n, index, values, fill):
    """``fill`` (n,) with ``values[j]`` written at ``index[j]`` in order, the
    last write to a slot winning, as XLA's scatter on the CPU; the winner
    is the largest position j a slot (a scatter-max, the same on every
    device). Batched over leading dimensions."""
    pos = torch.arange(index.shape[-1], device=index.device).expand_as(index)
    win = torch.full(fill.shape[:-1] + (n,), -1, dtype=torch.long,
                     device=index.device)
    win = win.scatter_reduce(-1, index, pos, reduce="amax")
    took = win >= 0
    got = torch.gather(values, -1, win.clamp(min=0))
    return torch.where(took, got, fill)


@register("bipartite_matching", nout=2, differentiable=False)
def _bipartite_matching(threshold=0.5, is_ascend=False, topk=-1):
    """Greedy bipartite matching of a score matrix (N, M) or (B, N, M):
    rows in order of their best score claim their best free column
    (reference :326)."""

    def f(score):
        s3 = score if score.dim() == 3 else score[None]
        b, n_row, n_col = s3.shape
        dev = s3.device
        best = s3.min(-1).values if is_ascend else -s3.max(-1).values
        order = torch.argsort(best, dim=-1, stable=True)
        row_match = torch.full((b, n_row), -1, dtype=torch.long, device=dev)
        col_used = torch.zeros((b, n_col), dtype=torch.bool, device=dev)
        fill = float("inf") if is_ascend else float("-inf")
        bi = torch.arange(b, device=dev)
        limit = n_row if topk <= 0 else min(topk, n_row)
        for i in range(limit):
            r = order[:, i]
            row = s3[bi, r]                                  # (B, M)
            s = torch.where(col_used, torch.full_like(row, fill), row)
            c = s.argmin(-1) if is_ascend else s.argmax(-1)
            sc = row.gather(-1, c[:, None])[:, 0]
            ok = sc <= threshold if is_ascend else sc >= threshold
            row_match[bi, r] = torch.where(ok, c, torch.full_like(c, -1))
            col_used[bi, c] = col_used[bi, c] | ok
        valid = row_match >= 0
        rows = torch.arange(n_row, device=dev).expand(b, n_row)
        col_match = _last_write(
            n_col + 1, torch.where(valid, row_match, n_col),
            torch.where(valid, rows, -1),
            torch.full((b, n_col + 1), -1, dtype=torch.long,
                       device=dev))[:, :n_col]
        out = row_match.to(score.dtype), col_match.to(score.dtype)
        return out if score.dim() == 3 else (out[0][0], out[1][0])

    return f


@register("multibox_prior", differentiable=False)
def _multibox_prior(sizes=(1.0,), ratios=(1.0,), clip=False, steps=(-1, -1),
                    offsets=(0.5, 0.5)):
    """Anchors (1, h w A, 4) in corner form for a feature map (.., h, w):
    A = len(sizes) + len(ratios) - 1 a position (reference :370), each
    coordinate ``(i + offset) * step -+ half`` in float32, rounded after
    the product and after the sum."""

    def f(data):
        h, w = data.shape[-2], data.shape[-1]
        dev = data.device
        step_y = steps[0] if steps[0] > 0 else 1.0 / h
        step_x = steps[1] if steps[1] > 0 else 1.0 / w
        cy = (torch.arange(h, dtype=torch.float32, device=dev) +
              offsets[0]) * step_y
        cx = (torch.arange(w, dtype=torch.float32, device=dev) +
              offsets[1]) * step_x
        yy, xx = torch.meshgrid(cy, cx, indexing="ij")
        anchors = []
        # (sizes[0], each ratio), then (each further size, ratios[0])
        combos = [(sizes[0], r) for r in ratios] + \
                 [(s, ratios[0]) for s in sizes[1:]]
        for s, r in combos:
            aw = s * (r ** 0.5) / 2
            ah = s / (r ** 0.5) / 2
            anchors.append(torch.stack([xx - aw, yy - ah, xx + aw, yy + ah],
                                       -1))
        out = torch.stack(anchors, 2).reshape(1, -1, 4)
        return out.clamp(0.0, 1.0) if clip else out

    return f


@register("multibox_target", nout=3, differentiable=False)
def _multibox_target(overlap_threshold=0.5, negative_mining_ratio=-1.0,
                     variances=(0.1, 0.1, 0.2, 0.2)):
    """Match anchors to labels: (loc_target (B, 4N), loc_mask (B, 4N),
    cls_target (B, N)). anchors (1, N, 4); cls_preds (B, classes + 1, N);
    label (B, M, 5) rows [cls, x1, y1, x2, y2], -1 padded (reference
    :398)."""

    def f(anchors, cls_preds, label):
        anc = anchors.reshape(-1, 4)
        dev, dt = anc.device, anc.dtype
        var = torch.tensor(variances, dtype=dt, device=dev)
        b, m = label.shape[0], label.shape[1]
        n = anc.shape[0]
        valid = label[..., 0] >= 0                           # (B, M)
        gt = label[..., 1:5]
        iou = _pair_iou(anc[None], gt)                       # (B, N, M)
        iou = torch.where(valid[:, None, :], iou, torch.full_like(iou, -1.0))
        best_iou, best_gt = iou.amax(-1), iou.argmax(-1)   # first maxima
        pos = best_iou > overlap_threshold
        # every valid ground truth claims its best anchor, then the
        # threshold stage keeps the rest; a padded row writes back what
        # it read
        best_anchor = iou.argmax(1)                          # (B, M)
        js = torch.arange(m, device=dev).expand(b, m)
        best_gt = _last_write(
            n, best_anchor,
            torch.where(valid, js, best_gt.gather(1, best_anchor)), best_gt)
        pos = _last_write(
            n, best_anchor, valid | pos.gather(1, best_anchor), pos)
        g = gt.gather(1, best_gt[..., None].expand(b, n, 4))
        a_xy = (anc[:, :2] + anc[:, 2:]) / 2
        a_wh = (anc[:, 2:] - anc[:, :2]).clamp(min=1e-9)
        g_xy = (g[..., :2] + g[..., 2:]) / 2
        g_wh = (g[..., 2:] - g[..., :2]).clamp(min=1e-9)
        t = torch.cat([(g_xy - a_xy) / a_wh / var[:2],
                       torch.log(g_wh / a_wh) / var[2:]], -1)
        posf = pos[..., None]
        loc_t = torch.where(posf, t, torch.zeros_like(t)).reshape(b, -1)
        loc_m = torch.where(posf, torch.ones_like(t),
                            torch.zeros_like(t)).reshape(b, -1)
        cls_t = torch.where(pos, label[..., 0].gather(1, best_gt) + 1,
                            torch.zeros_like(best_iou))
        if negative_mining_ratio > 0:
            # keep the ratio * num_pos hardest negatives, ranked by their
            # largest non-background score; the others are ignored (-1)
            conf = cls_preds[:, 1:, :].amax(1)               # (B, N)
            neg_score = torch.where(pos, torch.full_like(conf, float("-inf")),
                                    conf)
            order = torch.argsort(-neg_score, dim=-1, stable=True)
            rank = torch.empty_like(order).scatter_(
                1, order, torch.arange(n, device=dev).expand(b, n))
            budget = negative_mining_ratio * pos.sum(-1, keepdim=True).to(
                torch.float32)
            keep_neg = ~pos & (rank.to(torch.float32) < budget)
            cls_t = torch.where(pos | keep_neg, cls_t,
                                torch.full_like(cls_t, -1.0))
        return loc_t, loc_m, cls_t

    return f


@register("multibox_detection", differentiable=False)
def _multibox_detection(clip=True, threshold=0.01, nms_threshold=0.5,
                        force_suppress=False, nms_topk=-1,
                        variances=(0.1, 0.1, 0.2, 0.2)):
    """Decode the predictions and run per-class NMS: (B, N, 6) rows [cls,
    score, x1, y1, x2, y2], the others -1 (reference :461)."""
    nms = get_op("box_nms").fn(
        overlap_thresh=nms_threshold, valid_thresh=threshold, topk=nms_topk,
        coord_start=2, score_index=1, id_index=0,
        force_suppress=force_suppress)

    def f(cls_prob, loc_pred, anchors):
        b, _, n = cls_prob.shape
        anc = anchors.reshape(-1, 4)
        a_xy = (anc[:, :2] + anc[:, 2:]) / 2
        a_wh = (anc[:, 2:] - anc[:, :2]).clamp(min=1e-9)
        loc = loc_pred.reshape(b, n, 4)
        v = torch.tensor(variances, dtype=loc.dtype, device=loc.device)
        xy = loc[..., :2] * v[:2] * a_wh + a_xy
        wh = torch.exp(loc[..., 2:] * v[2:]) * a_wh / 2
        boxes = torch.cat([xy - wh, xy + wh], -1)
        if clip:
            boxes = boxes.clamp(0.0, 1.0)
        score = cls_prob[:, 1:, :]                # the background row goes
        best, cls_id = score.amax(1), score.argmax(1).to(cls_prob.dtype)
        keep = best > threshold
        neg = torch.full_like(best, -1.0)
        rows = torch.cat([torch.where(keep, cls_id, neg)[..., None],
                          torch.where(keep, best, neg)[..., None], boxes], -1)
        return nms(rows)

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
