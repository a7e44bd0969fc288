"""The spatial-warping and deformable op tier of the port.

Counterpart of ``mxnet_tpu/ops/warp_ops.py``: ``bilinear_sampler`` (:80),
``grid_generator`` (:106, "affine" and "warp"), ``spatial_transformer``
(:133), ``correlation`` (:158), ``deformable_convolution`` (:271) and
``modulated_deformable_convolution`` (:283, both through
``_deform_conv_impl`` :207), ``psroi_pooling`` (:297) and
``deformable_psroi_pooling`` (:350), in plain torch on the operands'
device.

- One bilinear sampler, :func:`_sample2d` (the reference :50-70: four
  clamped corner gathers, each weighted by its bilinear weight times its
  in-image mask), serves the sampler, the spatial transformer and the
  deformable im2col. It is a ``gather`` over the flattened image, so
  autograd gives gradients through both the values (the gather's backward,
  a scatter-add: on the card its sums are not in the CPU's order) and the
  sampling coordinates (through the bilinear weights; ``floor`` passes
  none, as in the reference).
- The deformable convolutions sample each deformable group's channel block
  at that group's offset taps (the im2col with offsets, (B, C K, H' W'))
  and project the columns with one grouped ``torch.matmul``.
- ``correlation`` enumerates its (2 r + 1)^2 displacements and k^2 kernel
  taps in Python, each a strided slice of the two padded maps, a product
  and a channel sum, as the reference does.
- ``psroi_pooling``'s bins are rectangles, so a bin's masked mean is
  separable: a contraction over x with each ROI's column masks, then over
  y with its row masks (two ``einsum``s for all bins and ROIs at once).
  ``deformable_psroi_pooling`` computes every bin's shifted taps at once,
  one bilinear gather a sample.
- Where a quotient feeds a ``floor`` or ``ceil`` (ROI bins) it divides by a
  device tensor: CUDA divides by a Python number as a multiply by its
  reciprocal, which moves a bin's edge where the quotient should be whole.
"""
from __future__ import annotations

import torch
import torch.nn.functional as tF

from ..base import MXNetError
from .registry import register

__all__ = []


def _pair(v):
    if isinstance(v, (tuple, list)):
        return tuple(int(x) for x in v)
    return (int(v), int(v))


def _round_half_away(v):
    """C ``round()`` (half away from zero): ``torch.round`` rounds half to
    even and would move ROI edges that end in .5 by a pixel."""
    return torch.sign(v) * torch.floor(torch.abs(v) + 0.5)


def _sample2d(feat, y, x):
    """Bilinear samples of ``feat`` (N, C, H, W) at continuous (y, x) of
    shape (N, *S) -> (N, C, *S); a corner outside the image adds zero (the
    reference's ``between()`` checks)."""
    n, c, h, w = feat.shape
    shape = tuple(y.shape[1:])
    y = y.reshape(n, -1)
    x = x.reshape(n, -1)
    y0f = torch.floor(y)
    x0f = torch.floor(x)
    wy = (y - y0f).to(feat.dtype)
    wx = (x - x0f).to(feat.dtype)
    y0 = y0f.long()
    x0 = x0f.long()
    flat = feat.reshape(n, c, h * w)

    def corner(yi, xi, wt):
        ok = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
        v = torch.gather(flat, 2, idx[:, None, :].expand(n, c, idx.shape[1]))
        return v * (wt * ok.to(feat.dtype))[:, None, :]

    out = (corner(y0, x0, (1 - wy) * (1 - wx)) +
           corner(y0, x0 + 1, (1 - wy) * wx) +
           corner(y0 + 1, x0, wy * (1 - wx)) +
           corner(y0 + 1, x0 + 1, wy * wx))
    return out.reshape((n, c) + shape)


def _norm_grid_coords(grid, h, w):
    """A [-1, 1] grid (B, 2, H', W') -> pixel (y, x) coordinates."""
    x_real = (grid[:, 0] + 1) * (w - 1) / 2
    y_real = (grid[:, 1] + 1) * (h - 1) / 2
    return y_real, x_real


@register("bilinear_sampler")
def _bilinear_sampler(cudnn_off=None):
    """data (B, C, H, W) sampled at grid (B, 2, H', W') in [-1, 1]
    (channel 0 is x, channel 1 is y) -> (B, C, H', W')."""

    def f(data, grid):
        h, w = data.shape[-2:]
        y, x = _norm_grid_coords(grid.to(data.dtype), h, w)
        return _sample2d(data, y, x)

    return f


def _affine_grid(theta, target_shape, dtype):
    """theta (B, 6), the affine rows [[sx, shx, tx], [shy, sy, ty]] ->
    the sampling grid (B, 2, H, W) over the [-1, 1]^2 target raster."""
    th, tw = target_shape
    dev = theta.device
    xs = torch.linspace(-1.0, 1.0, tw, dtype=dtype, device=dev)
    ys = torch.linspace(-1.0, 1.0, th, dtype=dtype, device=dev)
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    base = torch.stack([xx, yy, torch.ones_like(xx)], 0).reshape(3, th * tw)
    out = torch.matmul(theta.reshape(-1, 2, 3).to(dtype), base)
    return out.reshape(-1, 2, th, tw)


@register("grid_generator")
def _grid_generator(transform_type="affine", target_shape=(0, 0)):
    """affine: data (B, 6) -> grid (B, 2, H, W) over ``target_shape``.
    warp: data, an optical flow (B, 2, H, W) -> the normalised grid of the
    (pixel + flow) positions."""
    tt = transform_type

    def f(data):
        if tt == "affine":
            th, tw = _pair(target_shape)
            if th < 2 or tw < 2:
                raise MXNetError(
                    f"grid_generator(affine) needs target_shape >= (2, 2), "
                    f"got {target_shape}")
            return _affine_grid(data, (th, tw), data.dtype)
        if tt == "warp":
            _, _, h, w = data.shape
            xs = torch.arange(w, dtype=data.dtype, device=data.device)
            ys = torch.arange(h, dtype=data.dtype, device=data.device)
            gx = (data[:, 0] + xs[None, None, :]) * (2.0 / (w - 1)) - 1.0
            gy = (data[:, 1] + ys[None, :, None]) * (2.0 / (h - 1)) - 1.0
            return torch.stack([gx, gy], 1)
        raise MXNetError(f"grid_generator: unknown transform_type {tt!r}")

    return f


@register("spatial_transformer")
def _spatial_transformer(target_shape=(0, 0), transform_type="affine",
                         sampler_type="bilinear", cudnn_off=None):
    """The affine grid from loc (B, 6), then bilinear sampling of data:
    the STN module as one op."""
    if transform_type != "affine":
        raise MXNetError("spatial_transformer supports transform_type="
                         f"'affine' only, got {transform_type!r}")
    if sampler_type != "bilinear":
        raise MXNetError("spatial_transformer supports sampler_type="
                         f"'bilinear' only, got {sampler_type!r}")
    th, tw = _pair(target_shape)
    if th < 2 or tw < 2:
        raise MXNetError("spatial_transformer needs target_shape >= (2, 2), "
                         f"got {target_shape}")

    def f(data, loc):
        grid = _affine_grid(loc, (th, tw), data.dtype)
        h, w = data.shape[-2:]
        y, x = _norm_grid_coords(grid, h, w)
        return _sample2d(data, y, x)

    return f


@register("correlation")
def _correlation(kernel_size=1, max_displacement=1, stride1=1, stride2=1,
                 pad_size=0, is_multiply=True):
    """FlowNet's correlation of two maps (B, C, H, W) -> (B, D^2, H', W'),
    D = 2 (max_displacement // stride2) + 1."""
    k = int(kernel_size)
    md, st1, st2 = int(max_displacement), int(stride1), int(stride2)
    pad = int(pad_size)
    if k % 2 == 0:
        raise MXNetError(f"correlation kernel_size must be odd, got {k}")
    radius = md // st2

    def f(data1, data2):
        _, c, h, w = data1.shape
        kr = (k - 1) // 2
        border = md + kr
        th = -(-(h + 2 * pad - 2 * border) // st1)
        tw = -(-(w + 2 * pad - 2 * border) // st1)
        if th <= 0 or tw <= 0:
            raise MXNetError(
                "correlation: output would be empty - increase pad_size or "
                "input size")
        p1 = tF.pad(data1, (pad, pad, pad, pad))
        p2 = tF.pad(data2, (pad, pad, pad, pad))

        def window(p, y0, x0):
            return p[:, :, y0:y0 + (th - 1) * st1 + 1:st1,
                     x0:x0 + (tw - 1) * st1 + 1:st1]

        sumelems = float(k * k * c)
        chans = []
        for dy in range(-radius, radius + 1):
            for dx in range(-radius, radius + 1):
                acc = None
                for i in range(k):
                    for j in range(k):
                        a = window(p1, md + i, md + j)
                        b = window(p2, md + i + dy * st2, md + j + dx * st2)
                        t = (a * b).sum(1) if is_multiply else \
                            (a - b).abs().sum(1)
                        acc = t if acc is None else acc + t
                chans.append(acc / sumelems)
        return torch.stack(chans, 1)

    return f


def _deform_conv_impl(kernel, stride, dilate, pad, num_filter, num_group,
                      num_deformable_group, no_bias, modulated):
    kh, kw = _pair(kernel)
    sh, sw = _pair(stride) if stride else (1, 1)
    dh, dw = _pair(dilate) if dilate else (1, 1)
    ph, pw = _pair(pad) if pad else (0, 0)
    ng, dg = int(num_group), int(num_deformable_group)
    taps = kh * kw

    def f(data, offset, *rest):
        # the reference's operand order: data, offset[, mask], weight[, bias]
        rest = list(rest)
        mask = rest.pop(0) if modulated else None
        weight = rest.pop(0)
        bias = rest.pop(0) if not no_bias else None
        b, c, h, w = data.shape
        if c % dg or c % ng or num_filter % ng:
            raise MXNetError(
                f"deformable conv: channels {c} / filters {num_filter} not "
                f"divisible by num_deformable_group {dg} / num_group {ng}")
        ho = (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1
        wo = (w + 2 * pw - dw * (kw - 1) - 1) // sw + 1
        dev = data.device
        # each tap's base position on the unpadded input, t = i kw + j
        ys = torch.arange(ho, device=dev)[None, :] * sh - ph + \
            (torch.arange(kh, device=dev) * dh)[:, None]          # (kh, Ho)
        xs = torch.arange(wo, device=dev)[None, :] * sw - pw + \
            (torch.arange(kw, device=dev) * dw)[:, None]          # (kw, Wo)
        base_y = ys[:, None, :, None].expand(kh, kw, ho, wo).reshape(
            taps, ho, wo)
        base_x = xs[None, :, None, :].expand(kh, kw, ho, wo).reshape(
            taps, ho, wo)
        # offsets (B, dg 2K, Ho, Wo): in each group channel 2t is tap t's
        # dy, 2t + 1 its dx
        offs = offset.reshape(b, dg, 2 * taps, ho, wo)
        y = base_y.to(data.dtype) + offs[:, :, 0::2]
        x = base_x.to(data.dtype) + offs[:, :, 1::2]
        col = _sample2d(data.reshape(b * dg, c // dg, h, w),
                        y.reshape(b * dg, taps, ho, wo),
                        x.reshape(b * dg, taps, ho, wo))
        col = col.reshape(b, dg, c // dg, taps, ho, wo)
        if modulated:
            col = col * mask.reshape(b, dg, 1, taps, ho, wo)
        col = col.reshape(b, ng, (c // ng) * taps, ho * wo)
        wg = weight.reshape(ng, num_filter // ng, (c // ng) * taps)
        out = torch.matmul(wg.to(col.dtype), col).reshape(b, num_filter,
                                                         ho, wo)
        if bias is not None:
            out = out + bias[None, :, None, None].to(out.dtype)
        return out

    return f


@register("deformable_convolution")
def _deformable_convolution(kernel=(3, 3), stride=(1, 1), dilate=(1, 1),
                            pad=(0, 0), num_filter=1, num_group=1,
                            num_deformable_group=1, workspace=1024,
                            no_bias=False, layout=None):
    """DCNv1: operands (data, offset, weight[, bias]); the offset has
    2 K num_deformable_group channels at the output's resolution."""
    return _deform_conv_impl(kernel, stride, dilate, pad, int(num_filter),
                             num_group, num_deformable_group, no_bias,
                             modulated=False)


@register("modulated_deformable_convolution")
def _modulated_deformable_convolution(kernel=(3, 3), stride=(1, 1),
                                      dilate=(1, 1), pad=(0, 0),
                                      num_filter=1, num_group=1,
                                      num_deformable_group=1,
                                      workspace=1024, no_bias=False,
                                      im2col_step=64, layout=None):
    """DCNv2: operands (data, offset, mask, weight[, bias]); each sampled
    tap is scaled by its mask (K num_deformable_group channels)."""
    return _deform_conv_impl(kernel, stride, dilate, pad, int(num_filter),
                             num_group, num_deformable_group, no_bias,
                             modulated=True)


def _roi_box(rois, spatial_scale, shift):
    """Each ROI's rounded, scaled (x1, y1, width, height) less ``shift``,
    its width and height at least 0.1."""
    x1 = _round_half_away(rois[:, 1]) * spatial_scale - shift
    y1 = _round_half_away(rois[:, 2]) * spatial_scale - shift
    x2 = (_round_half_away(rois[:, 3]) + 1.0) * spatial_scale - shift
    y2 = (_round_half_away(rois[:, 4]) + 1.0) * spatial_scale - shift
    return x1, y1, (x2 - x1).clamp(min=0.1), (y2 - y1).clamp(min=0.1)


def _groups(p, gs):
    """The position-sensitive group of each of the ``p`` bins."""
    return [min(max(i * gs // p, 0), gs - 1) for i in range(p)]


@register("psroi_pooling")
def _psroi_pooling(spatial_scale=1.0, output_dim=1, pooled_size=7,
                   group_size=0):
    """Position-sensitive ROI pooling (R-FCN): data (B, output_dim gs^2,
    H, W), rois (N, 5) -> (N, output_dim, P, P); each bin the mean of its
    own channel over the bin's integer pixel rectangle (0 when empty)."""
    P = int(pooled_size)
    gs = int(group_size) or P
    od = int(output_dim)
    g = _groups(P, gs)

    def f(data, rois):
        b, c, h, w = data.shape
        if c != od * gs * gs:
            raise MXNetError(
                f"psroi_pooling: data has {c} channels, needs "
                f"output_dim*group_size^2 = {od * gs * gs}")
        dt, dev = data.dtype, data.device
        x1, y1, rw, rh = _roi_box(rois.to(dt), spatial_scale, 0.0)
        div = torch.full((), P, dtype=dt, device=dev)
        bh, bw = rh / div, rw / div
        p = torch.arange(P, dtype=dt, device=dev)

        def masks(lo, size, extent):
            start = torch.floor(p * size[:, None] + lo[:, None]).clamp(
                0, extent)
            stop = torch.ceil((p + 1) * size[:, None] + lo[:, None]).clamp(
                0, extent)
            pos = torch.arange(extent, dtype=dt, device=dev)
            return ((pos >= start[..., None]) &
                    (pos < stop[..., None])).to(dt)             # (N, P, E)

        my, mx = masks(y1, bh, h), masks(x1, bw, w)
        gi = torch.tensor(g, device=dev)
        sel = data.reshape(b, od, gs, gs, h, w).index_select(
            2, gi).index_select(3, gi)                      # (B, od, P, P, H, W)
        cols = torch.einsum("bcpqhw,nqw->bncpqh", sel, mx)
        cols = cols[rois[:, 0].long(), torch.arange(rois.shape[0],
                                                    device=dev)]
        val = torch.einsum("ncpqh,nph->ncpq", cols, my)
        area = my.sum(-1)[:, :, None] * mx.sum(-1)[:, None, :]  # (N, P, P)
        val = val / area.clamp(min=1.0)[:, None]
        return torch.where(area[:, None] > 0, val, torch.zeros_like(val))

    return f


@register("deformable_psroi_pooling")
def _deformable_psroi_pooling(spatial_scale=1.0, output_dim=1, group_size=1,
                              pooled_size=7, part_size=0, sample_per_part=1,
                              trans_std=0.0, no_trans=False):
    """Deformable PSROI pooling (the Deformable R-FCN head): each bin moves
    by its part's normalised offset from ``trans`` (N, 2 num_classes, ps,
    ps) and averages ``sample_per_part``^2 bilinear taps."""
    P = int(pooled_size)
    gs = int(group_size)
    od = int(output_dim)
    ps = int(part_size) or P
    spp = int(sample_per_part)
    g = _groups(P, gs)
    part = [min(i * ps // P, ps - 1) for i in range(P)]

    def f(data, rois, trans=None):
        b, c, h, w = data.shape
        n = rois.shape[0]
        dt, dev = data.dtype, data.device
        use_trans = not no_trans and trans is not None
        x1, y1, rw, rh = _roi_box(rois.to(dt), spatial_scale, 0.5)
        div = torch.full((), P, dtype=dt, device=dev)
        bh, bw = rh / div, rw / div
        sdiv = torch.full((), spp, dtype=dt, device=dev)
        sbh, sbw = bh / sdiv, bw / sdiv
        gi = torch.tensor(g, device=dev)
        chans = (torch.arange(od, device=dev)[None, None, :] * gs * gs +
                 gi[:, None, None] * gs + gi[None, :, None])   # (P, P, od)
        p = torch.arange(P, dtype=dt, device=dev)
        hs = (p[None, :, None, None] * bh[:, None, None, None] +
              y1[:, None, None, None]).expand(n, P, P, od)
        ws = (p[None, None, :, None] * bw[:, None, None, None] +
              x1[:, None, None, None]).expand(n, P, P, od)
        if use_trans:
            # each bin moves by its part's offset, of its class's channels
            n_cls = int(trans.shape[1]) // 2
            cls = torch.arange(od, device=dev) // max(od // max(n_cls, 1), 1)
            pi = torch.tensor(part, device=dev)
            tr = trans.index_select(2, pi).index_select(3, pi)  # (N, 2n, P, P)
            tx = tr[:, 2 * cls].permute(0, 2, 3, 1) * trans_std
            ty = tr[:, 2 * cls + 1].permute(0, 2, 3, 1) * trans_std
            hs = hs + ty * rh[:, None, None, None]
            ws = ws + tx * rw[:, None, None, None]
        rb = rois[:, 0].long()[:, None, None, None]
        ch = chans[None]
        acc = cnt = None
        for ih in range(spp):
            for iw in range(spp):
                hh = hs + ih * sbh[:, None, None, None]
                ww = ws + iw * sbw[:, None, None, None]
                ok = ((ww >= -0.5) & (ww <= w - 0.5) &
                      (hh >= -0.5) & (hh <= h - 0.5)).to(dt)
                hcl = hh.clamp(0.0, h - 1.0)
                wcl = ww.clamp(0.0, w - 1.0)
                h0 = torch.floor(hcl).long()
                w0 = torch.floor(wcl).long()
                h1 = (h0 + 1).clamp(max=h - 1)
                w1 = (w0 + 1).clamp(max=w - 1)
                ay = (hcl - h0).to(dt)
                ax = (wcl - w0).to(dt)
                v = (data[rb, ch, h0, w0] * (1 - ay) * (1 - ax) +
                     data[rb, ch, h0, w1] * (1 - ay) * ax +
                     data[rb, ch, h1, w0] * ay * (1 - ax) +
                     data[rb, ch, h1, w1] * ay * ax)
                acc = v * ok if acc is None else acc + v * ok
                cnt = ok if cnt is None else cnt + ok
        out = torch.where(cnt > 0, acc / cnt.clamp(min=1.0),
                          torch.zeros_like(acc))
        return out.permute(0, 3, 1, 2)

    return f
