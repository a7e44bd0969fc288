"""Vision and detection operators of the port.

Counterpart of ``mxnet_tpu/ops/vision.py``: ``box_iou``, ``box_nms``,
``box_encode``, ``box_decode`` (:34-188), ``roi_pooling``, ``roi_align``
(:190-288), ``upsampling``, ``bilinear_resize_2d`` and ``moments``
(:290-355), the reference's formulas in plain torch on the operands'
device, with static shapes and no host read.

``box_nms`` keeps the reference's contract: the output has the input's
shape, kept rows first in score order, every other row -1. Its sweep (row
i survives when no kept row of a higher score suppresses it) runs on the
device as a fixed-point iteration of the whole keep mask: after k rounds
the first k rows are final, and a round that changes nothing ends it (one
host read a round, none a box; inside a CUDA graph capture every round
runs). With ``topk`` only the top-k candidates take part, so the
suppression matrix is (topk, topk), not (n, n): the reference discards the
others outright, so the result is the same.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from .registry import register

__all__ = []


def _to_corner(b, fmt):
    """(..., 4) boxes -> corner (x1, y1, x2, y2)."""
    if fmt == "corner":
        return b
    if fmt == "center":
        x, y, w, h = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
        return torch.stack([x - w / 2, y - h / 2, x + w / 2, y + h / 2], -1)
    raise MXNetError(f"unknown box format {fmt!r}")


def _to_center(b):
    xy = (b[..., :2] + b[..., 2:]) / 2
    wh = b[..., 2:] - b[..., :2]
    return torch.cat([xy, wh], -1)


def _area(b):
    return (b[..., 2] - b[..., 0]).clamp(min=0) * \
        (b[..., 3] - b[..., 1]).clamp(min=0)


def _pair_iou(a, b):
    """IoU of a (..., M, 4) against b (..., N, 4) -> (..., M, N), corner
    boxes."""
    tl = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    br = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (br - tl).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = _area(a)[..., :, None] + _area(b)[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


@register("box_iou")
def _box_iou(format="corner"):  # noqa: A002 — the reference's name
    def f(lhs, rhs):
        return _pair_iou(_to_corner(lhs, format), _to_corner(rhs, format))

    return f


def _nms_keep(valid, sup):
    """The greedy keep mask: row i is kept iff valid and no kept row j < i
    suppresses it (``sup[..., j, i]``). Fixed-point rounds over the whole
    mask (see the module docstring)."""
    k = valid.shape[-1]
    lower = sup.triu(1).to(torch.float32)
    keep = valid
    capturing = valid.is_cuda and torch.cuda.is_current_stream_capturing()
    for it in range(k):
        hit = torch.matmul(keep.to(torch.float32).unsqueeze(-2),
                           lower).squeeze(-2) > 0
        new = valid & ~hit
        if not capturing and it % 4 == 3 and torch.equal(new, keep):
            return new
        keep = new
    return keep


@register("box_nms", differentiable=False)
def _box_nms(overlap_thresh=0.5, valid_thresh=0.0, topk=-1, coord_start=2,
             score_index=1, id_index=-1, background_id=-1,
             force_suppress=False, in_format="corner", out_format="corner"):
    """Non-maximum suppression of (B, N, K) or (N, K) rows
    ``[.. id .. score .. x1 y1 x2 y2 ..]`` (reference :71)."""
    cs, si, ii = coord_start, score_index, id_index

    def f(data):
        if data.dim() not in (2, 3):
            raise MXNetError("box_nms expects (N, K) or (B, N, K)")
        rows = data if data.dim() == 3 else data.unsqueeze(0)
        n = rows.shape[1]
        score = rows[..., si]
        valid = score > valid_thresh
        if ii >= 0 and background_id >= 0:
            valid = valid & (rows[..., ii] != background_id)
        inf = torch.full_like(score, float("inf"))
        order = torch.argsort(torch.where(valid, -score, inf), dim=1,
                              stable=True)
        m = min(n, topk) if topk > 0 else n
        order = order[:, :m]
        top = torch.gather(rows, 1, order[..., None].expand(-1, -1,
                                                            rows.shape[2]))
        valid_s = torch.gather(valid, 1, order)
        boxes = _to_corner(top[..., cs:cs + 4], in_format)
        sup = _pair_iou(boxes, boxes) > overlap_thresh
        if not force_suppress:
            cls = top[..., ii] if ii >= 0 else torch.zeros_like(top[..., 0])
            sup = sup & (cls[..., :, None] == cls[..., None, :])
        keep = _nms_keep(valid_s, sup)
        if out_format != in_format:
            conv = boxes if out_format == "corner" else _to_center(boxes)
            top = torch.cat([top[..., :cs], conv.to(top.dtype),
                             top[..., cs + 4:]], -1)
        out = torch.where(keep[..., None], top, torch.full_like(top, -1.0))
        front = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)
        out = torch.gather(out, 1, front[..., None].expand_as(out))
        if m < n:
            out = torch.cat([out, out.new_full(
                (rows.shape[0], n - m, rows.shape[2]), -1.0)], 1)
        return out if data.dim() == 3 else out[0]

    return f


@register("box_encode", nout=2)
def _box_encode(means=(0.0, 0.0, 0.0, 0.0), stds=(0.1, 0.1, 0.2, 0.2)):
    """SSD anchor -> target encoding (reference :136): samples (B, N),
    matches (B, N), anchors (B, N, 4), refs (B, M, 4), corner boxes ->
    (targets (B, N, 4), masks (B, N, 4))."""
    def f(samples, matches, anchors, refs):
        mean = torch.tensor(means, dtype=anchors.dtype,
                            device=anchors.device)
        std = torch.tensor(stds, dtype=anchors.dtype, device=anchors.device)
        idx = matches.long()[..., None].expand(-1, -1, refs.shape[-1])
        gt = torch.gather(refs, 1, idx)
        a_xy = (anchors[..., :2] + anchors[..., 2:]) / 2
        a_wh = (anchors[..., 2:] - anchors[..., :2]).clamp(min=1e-9)
        g_xy = (gt[..., :2] + gt[..., 2:]) / 2
        g_wh = (gt[..., 2:] - gt[..., :2]).clamp(min=1e-9)
        t = torch.cat([(g_xy - a_xy) / a_wh, torch.log(g_wh / a_wh)], -1)
        t = (t - mean) / std
        mask = (samples > 0.5)[..., None].to(t.dtype)
        return torch.where(mask > 0, t, torch.zeros_like(t)), \
            mask.expand_as(t)

    return f


@register("box_decode")
def _box_decode(std0=0.1, std1=0.1, std2=0.2, std3=0.2, clip=-1.0,
                format="center"):  # noqa: A002
    """Deltas + anchors -> corner boxes (reference :164); ``format`` is the
    anchors'."""
    def f(data, anchors):
        std = torch.tensor([std0, std1, std2, std3], dtype=data.dtype,
                           device=data.device)
        a = anchors
        if format == "corner":
            a_xy = (a[..., :2] + a[..., 2:]) / 2
            a_wh = a[..., 2:] - a[..., :2]
        else:
            a_xy, a_wh = a[..., :2], a[..., 2:]
        d = data * std
        xy = d[..., :2] * a_wh + a_xy
        dwh = d[..., 2:]
        if clip > 0:
            dwh = dwh.clamp(max=clip)
        wh = torch.exp(dwh) * a_wh / 2
        return torch.cat([xy - wh, xy + wh], -1)

    return f


_ROI_CHUNK = 64     # ROIs a pass of roi_pooling's masked maxes


@register("roi_pooling")
def _roi_pooling(pooled_size=(7, 7), spatial_scale=1.0):
    """Max-pool each ROI onto a (ph, pw) grid (reference :193): data (B, C,
    H, W), rois (R, 5) ``[batch, x1, y1, x2, y2]``. A bin's window is a
    rectangle, so its max is taken along x, then along y; an empty bin is
    0. The bin sizes divide by device tensors: CUDA divides by a Python
    number as a multiply by its reciprocal, which moves a window's floor
    or ceil where the quotient should be whole."""
    ph, pw = pooled_size

    def bins(lo, size, n, extent, dtype, device):
        start = torch.floor(lo[:, None] + torch.arange(
            n, dtype=dtype, device=device) * size[:, None])
        stop = torch.ceil(lo[:, None] + torch.arange(
            1, n + 1, dtype=dtype, device=device) * size[:, None])
        pos = torch.arange(extent, dtype=dtype, device=device)
        return (pos >= start[..., None]) & (pos < stop[..., None])

    def f(data, rois):
        _, C, H, W = data.shape
        neg = torch.tensor(float("-inf"), dtype=data.dtype,
                           device=data.device)
        outs = []
        for r0 in range(0, rois.shape[0], _ROI_CHUNK):
            rr = rois[r0:r0 + _ROI_CHUNK]
            feat = data[rr[:, 0].long()]                    # (r, C, H, W)
            x1, y1, x2, y2 = (torch.round(rr[:, i + 1] * spatial_scale)
                              for i in range(4))
            rw = (x2 - x1 + 1).clamp(min=1.0)
            rh = (y2 - y1 + 1).clamp(min=1.0)
            my = bins(y1, rh / rh.new_full((), ph), ph, H, data.dtype,
                      data.device)
            mx = bins(x1, rw / rw.new_full((), pw), pw, W, data.dtype,
                      data.device)
            cols = torch.stack([torch.where(
                mx[:, None, None, j], feat, neg).amax(-1)
                for j in range(pw)], -1)                    # (r, C, H, pw)
            v = torch.stack([torch.where(
                my[:, None, i, :, None], cols, neg).amax(2)
                for i in range(ph)], 2)                     # (r, C, ph, pw)
            outs.append(torch.where(torch.isfinite(v), v,
                                    torch.zeros_like(v)))
        return torch.cat(outs) if outs else data.new_zeros((0, C, ph, pw))

    return f


@register("roi_align")
def _roi_align(pooled_size=(7, 7), spatial_scale=1.0, sample_ratio=2,
               position_sensitive=False, aligned=False):
    """Bilinear ROI align (reference :244): each bin the mean of
    ``sample_ratio``^2 bilinear taps, gathered for all ROIs at once."""
    if position_sensitive:
        raise MXNetError("roi_align: position_sensitive=True (PSRoIAlign) "
                         "is not implemented")
    ph, pw = pooled_size
    sr = max(int(sample_ratio), 1)

    def f(data, rois):
        _, C, H, W = data.shape
        off = 0.5 if aligned else 0.0
        x1, y1, x2, y2 = (rois[:, i + 1] * spatial_scale - off
                          for i in range(4))
        rw = x2 - x1 if aligned else (x2 - x1).clamp(min=1.0)
        rh = y2 - y1 if aligned else (y2 - y1).clamp(min=1.0)
        ty = torch.arange(ph * sr, dtype=rois.dtype, device=rois.device)
        tx = torch.arange(pw * sr, dtype=rois.dtype, device=rois.device)
        div = rois.new_tensor([ph, pw, sr])      # true division, as above
        gy = y1[:, None] + (ty + 0.5) * (rh / div[0])[:, None] / div[2]
        gx = x1[:, None] + (tx + 0.5) * (rw / div[1])[:, None] / div[2]
        y = gy[:, :, None].expand(-1, -1, pw * sr).reshape(len(rois), -1)
        x = gx[:, None, :].expand(-1, ph * sr, -1).reshape(len(rois), -1)
        y = y.clamp(0.0, H - 1.0)
        x = x.clamp(0.0, W - 1.0)
        y0, x0 = torch.floor(y).long(), torch.floor(x).long()
        y1i, x1i = (y0 + 1).clamp(max=H - 1), (x0 + 1).clamp(max=W - 1)
        wy = (y - y0).to(data.dtype)[..., None]
        wx = (x - x0).to(data.dtype)[..., None]
        b = rois[:, 0].long()[:, None]
        taps = (data[b, :, y0, x0] * (1 - wy) * (1 - wx) +
                data[b, :, y0, x1i] * (1 - wy) * wx +
                data[b, :, y1i, x0] * wy * (1 - wx) +
                data[b, :, y1i, x1i] * wy * wx)             # (R, T, C)
        taps = taps.permute(0, 2, 1).reshape(len(rois), C, ph, sr, pw, sr)
        return taps.mean(dim=(3, 5))

    return f


def _bilinear_grid(feat, out_h, out_w, align_corners=True):
    """Resize (..., H, W) -> (..., out_h, out_w), the reference's
    BilinearResize2D (align-corners by default)."""
    H, W = feat.shape[-2], feat.shape[-1]

    def coords(n_in, n_out):
        if n_out == 1:
            return torch.zeros(1, device=feat.device)
        if align_corners:
            return torch.linspace(0.0, n_in - 1.0, n_out,
                                  device=feat.device)
        step = n_in / n_out
        return ((torch.arange(n_out, device=feat.device) + 0.5) * step -
                0.5).clamp(0, n_in - 1)

    y, x = coords(H, out_h), coords(W, out_w)
    y0, x0 = torch.floor(y).long(), torch.floor(x).long()
    y1, x1 = (y0 + 1).clamp(max=H - 1), (x0 + 1).clamp(max=W - 1)
    wy = (y - y0).to(feat.dtype)[:, None]
    wx = (x - x0).to(feat.dtype)[None, :]
    r0, r1 = feat[..., y0, :], feat[..., y1, :]

    def row(r):
        return r[..., x0] * (1 - wx) + r[..., x1] * wx

    return row(r0) * (1 - wy) + row(r1) * wy


@register("bilinear_resize_2d")
def _bilinear_resize(height=0, width=0, scale_height=None, scale_width=None,
                     align_corners=True):
    def f(data):
        H, W = data.shape[-2], data.shape[-1]
        oh = height if height > 0 else int(round(H * (scale_height or 1.0)))
        ow = width if width > 0 else int(round(W * (scale_width or 1.0)))
        return _bilinear_grid(data, oh, ow, align_corners)

    return f


@register("upsampling")
def _upsampling(scale=2, sample_type="nearest", num_args=1):
    """UpSampling (reference :317): nearest repeats, bilinear through
    ``bilinear_resize_2d``'s grid."""
    s = int(scale)

    def f(data):
        if sample_type == "nearest":
            return data.repeat_interleave(s, -2).repeat_interleave(s, -1)
        if sample_type == "bilinear":
            H, W = data.shape[-2], data.shape[-1]
            return _bilinear_grid(data, H * s, W * s, align_corners=True)
        raise MXNetError(f"unknown sample_type {sample_type!r}")

    return f


@register("moments", nout=2)
def _moments(axes=None, keepdims=False):
    def f(data):
        ax = tuple(axes) if axes is not None else tuple(range(data.dim()))
        mean = data.mean(dim=ax, keepdim=keepdims)
        var = data.var(dim=ax, correction=0, keepdim=keepdims)
        return mean, var

    return f
