"""Dynamic-shape numpy manipulation ops and the last contrib ops.

Counterpart of ``mxnet_tpu/ops/npi_manip.py`` (less ``Custom``, which
comes with ROADMAP A10 (2), and the control-flow ops, which are
:mod:`mxnet_tpu_torch.numpy_extension.control_flow`'s):

- ``unique``, ``nonzero``, ``boolean_mask``, the tensor mask assignment,
  ``delete``, the three ``_npi_insert_*``, ``advanced_indexing*`` and
  ``calibrate_entropy`` have output shapes that follow their operands'
  values. The reference runs them on the host, outside ``jit``; here they
  run eagerly on their operands' device (``eager_only``: torch reads the
  sizes it needs back from the device) and raise :class:`MXNetError`
  inside a compiled program, where the reference's ``jit`` refuses them.
  Nothing is copied to the host by the ops themselves;
- ``Concat`` (``dim`` 1 by default), ``hawkesll`` (the reference's scan as
  a loop over the steps, differentiable), ``mrcnn_mask_target`` and
  ``rroi_align`` (gathers), and the ``_npi_eig``/``_npi_eigvals`` names of
  :mod:`.linalg_legacy`'s ops.
"""
from __future__ import annotations

import math

import torch

from .registry import register, register_alias


# ---------------------------------------------------------------------------
# dynamic-shape manipulation (reference :31-172)
# ---------------------------------------------------------------------------
@register("unique", nout=2, differentiable=False, eager_only=True)
def _unique(return_index=False, return_inverse=False, return_counts=False,
            axis=None, **a):
    """``numpy.unique``'s outputs, sorted; the index of each value's first
    occurrence is the least position its inverse index names."""
    def f(x):
        src = x.reshape(-1) if axis is None else x
        vals, inv, counts = torch.unique(src, sorted=True, return_inverse=True,
                                         return_counts=True, dim=axis)
        out = [vals]
        if return_index:
            n = src.shape[0 if axis is None else axis]
            pos = torch.arange(n, device=x.device)
            first = torch.full((vals.shape[0 if axis is None else axis],), n,
                               dtype=pos.dtype, device=x.device)
            out.append(first.scatter_reduce(0, inv, pos, "amin"))
        if return_inverse:
            out.append(inv.reshape(x.shape) if axis is None else inv)
        if return_counts:
            out.append(counts)
        return tuple(out) if len(out) > 1 else vals

    return f


register_alias("_npi_unique", "unique")


@register("nonzero", differentiable=False, eager_only=True)
def _nonzero(**a):
    """An (N, ndim) int32 array of the nonzero positions, row by row (the
    transpose of numpy's tuple)."""
    return lambda x: torch.nonzero(x).to(torch.int32)


register_alias("_npx_nonzero", "nonzero")


@register("boolean_mask", differentiable=False, eager_only=True)
def _boolean_mask(axis=0, **a):
    """The slices of ``data`` along ``axis`` where ``mask`` is nonzero."""
    return lambda data, mask: torch.index_select(
        data, axis, torch.nonzero(mask.reshape(-1)).reshape(-1))


register_alias("_contrib_boolean_mask", "boolean_mask")


def _mask_assign_scalar(value=0.0, **a):
    def f(data, mask):
        m = mask.bool().reshape(mask.shape + (1,) * (data.dim() - mask.dim()))
        return torch.where(m, torch.full((), value, dtype=data.dtype,
                                         device=data.device), data)

    return f


register("_npi_boolean_mask_assign_scalar", _mask_assign_scalar)


def _mask_assign_tensor(data, mask, value):
    out = data.clone()
    out[mask.bool()] = value.to(data.dtype)
    return out


register("_npi_boolean_mask_assign_tensor",
         lambda **a: _mask_assign_tensor, differentiable=False,
         eager_only=True)


def _flat_axis(x, axis):
    return (x.reshape(-1), 0) if axis is None else (x, axis % x.dim())


def _slice_positions(slc, n, device):
    """The positions a Python slice selects of ``n``, on ``device``."""
    start, stop, step = slc.indices(n)
    return torch.arange(start, stop, step, device=device)


@register("delete", differentiable=False, eager_only=True)
def _delete(start=None, stop=None, step=None, int_ind=None, axis=None, **a):
    """``numpy.delete``: ``x`` without the entries along ``axis`` (the
    flattened ``x`` when None) that an index operand, ``int_ind`` or the
    slice names."""
    def f(x, *obj):
        arr, ax = _flat_axis(x, axis)
        n = arr.shape[ax]
        keep = torch.ones(n, dtype=torch.bool, device=x.device)
        if obj:
            sel = obj[0].long()
        elif int_ind is not None:
            sel = torch.full((1,), int_ind, dtype=torch.long, device=x.device)
        else:
            sel = _slice_positions(slice(start, stop, step), n, x.device)
        keep[torch.where(sel < 0, sel + n, sel)] = False
        return torch.index_select(arr, ax, torch.nonzero(keep).reshape(-1))

    return f


register_alias("_npi_delete", "delete")


def _insert(x, index, values, axis):
    """``numpy.insert(x, index, values, axis)`` with ``index`` an int, a
    slice or a 1-d tensor of positions, and ``values`` a tensor."""
    arr, ax = _flat_axis(x, axis)
    n = arr.shape[ax]
    values = values.to(device=arr.device, dtype=arr.dtype)
    if isinstance(index, slice):
        index = _slice_positions(index, n, arr.device)
    if isinstance(index, int) or index.numel() == 1:
        # one position: every value goes in there (numpy's size-1 rule)
        scalar = isinstance(index, int) or index.dim() == 0
        at = int(index) if scalar else int(index.reshape(()))
        at = at + n if at < 0 else at
        v = values.reshape((1,) * (arr.dim() - values.dim()) +
                           tuple(values.shape))
        if scalar:
            v = v.movedim(0, ax)
        shape = list(arr.shape)
        shape[ax] = v.shape[ax]
        return torch.cat([arr.narrow(ax, 0, at), v.expand(shape),
                          arr.narrow(ax, at, n - at)], ax)
    idx = index.long().reshape(-1)
    idx = torch.where(idx < 0, idx + n, idx)
    k = idx.numel()
    srt, order = torch.sort(idx, stable=True)
    pos = torch.empty_like(idx).scatter_(
        0, order, srt + torch.arange(k, device=arr.device))
    old = torch.arange(n, device=arr.device)
    old = old + torch.searchsorted(srt, old, right=True)
    shape = list(arr.shape)
    shape[ax] = k
    new_shape = list(arr.shape)
    new_shape[ax] = n + k
    out = torch.empty(new_shape, dtype=arr.dtype, device=arr.device)
    out.index_copy_(ax, pos, values.expand(shape))
    out.index_copy_(ax, old, arr)
    return out


def _values(x, values, val):
    if values:
        return values[0]
    return torch.tensor(val, dtype=x.dtype).to(x.device)


@register("_npi_insert_scalar", differentiable=False, eager_only=True)
def _insert_scalar(int_ind=0, val=None, axis=None, **a):
    return lambda x, *values: _insert(x, int(int_ind),
                                      _values(x, values, val), axis)


@register("_npi_insert_slice", differentiable=False, eager_only=True)
def _insert_slice(start=None, stop=None, step=None, val=None, axis=None,
                  **a):
    return lambda x, *values: _insert(x, slice(start, stop, step),
                                      _values(x, values, val), axis)


@register("_npi_insert_tensor", differentiable=False, eager_only=True)
def _insert_tensor(axis=None, **a):
    return lambda x, values, index: _insert(x, index.long(), values, axis)


@register("advanced_indexing", differentiable=False, eager_only=True)
def _advanced_indexing(**a):
    """``x[idx]`` with an integer or a boolean index array."""
    return lambda x, idx: x[idx if idx.dtype == torch.bool else idx.long()]


register_alias("_npi_advanced_indexing", "advanced_indexing")


@register("advanced_indexing_multiple", differentiable=False,
          eager_only=True)
def _advanced_indexing_multiple(**a):
    """``x[idx0, idx1, ...]`` with broadcast integer index arrays."""
    return lambda x, *idxs: x[tuple(i.long() for i in idxs)]


register_alias("_npi_advanced_indexing_multiple",
               "advanced_indexing_multiple")

register_alias("_npi_eig", "linalg_eig")
register_alias("_npi_eigvals", "linalg_eigvals")

# ---------------------------------------------------------------------------
# legacy Concat (src/operator/nn/concat.cc): ``dim`` and variadic operands
# ---------------------------------------------------------------------------
register("Concat", lambda dim=1, num_args=0, **a:
         (lambda *xs: torch.cat(xs, dim=dim)))
register_alias("concat", "Concat")


# ---------------------------------------------------------------------------
# contrib ops (reference :241-392)
# ---------------------------------------------------------------------------
@register("hawkesll", nout=2)
def _hawkesll(**a):
    """The log-likelihood of a marked self-exciting Hawkes process
    (contrib/hawkes_ll.cc): mu, alpha, beta (K,), state (N, K), lags and
    marks (N, T), valid_length and max_time (N,); returns ``(loglik (N,),
    new_state)``. The reference's scan over the T steps, as a loop."""
    def f(mu, alpha, beta, state, lags, marks, valid_length, max_time):
        n, t_len = lags.shape
        k = mu.shape[0]
        marks_i = marks.long()
        valid = torch.arange(t_len, device=lags.device)[None, :] < \
            valid_length[:, None].to(torch.int32)
        classes = torch.arange(k, device=lags.device)
        rmem = state
        t_elapsed = torch.zeros(n, dtype=lags.dtype, device=lags.device)
        comp = torch.zeros(n, dtype=lags.dtype, device=lags.device)
        ll_sum = 0
        for t in range(t_len):
            lag, mark, ok = lags[:, t], marks_i[:, t], valid[:, t]
            rmem_d = rmem * torch.exp(-beta[None, :] * lag[:, None])
            lam = mu[mark] + alpha[mark] * torch.gather(
                rmem_d, 1, mark[:, None])[:, 0]
            ll = torch.where(ok, torch.log(torch.clamp_min(lam, 1e-30)),
                             torch.zeros_like(lam))
            one_hot = (mark[:, None] == classes[None, :]).to(rmem.dtype)
            rmem = torch.where(ok[:, None], rmem_d + one_hot, rmem)
            t_elapsed = torch.where(ok, t_elapsed + lag, t_elapsed)
            # this event's excitation integral over (t_event, max_time]
            contrib = (alpha[mark] / beta[mark]) * (1.0 - torch.exp(
                -beta[mark] * torch.clamp_min(max_time - t_elapsed, 0.0)))
            comp = comp + torch.where(ok, contrib, torch.zeros_like(contrib))
            ll_sum = ll_sum + ll
        comp_base = torch.sum(mu) * max_time
        comp_state = torch.sum((alpha / beta)[None, :] * state * (
            1.0 - torch.exp(-beta[None, :] * max_time[:, None])), dim=1)
        return ll_sum - comp_base - comp - comp_state, rmem

    return f


register_alias("_contrib_hawkesll", "hawkesll")


def _full(v, like):
    """A 0-d device tensor ``v`` of ``like``'s dtype: a divisor that CUDA
    divides by, where a host scalar would be a multiply by its reciprocal
    (the quotients here feed truncations)."""
    return torch.full((), v, dtype=like.dtype, device=like.device)


@register("mrcnn_mask_target", nout=2, differentiable=False)
def _mrcnn_mask_target(num_rois=1, mask_size=(28, 28), num_classes=1,
                       sample_ratio=2, **a):
    """Mask R-CNN's training targets (contrib/mrcnn_mask_target.cu): each
    ROI's matched ground-truth mask sampled at ``mask_size`` cell centres,
    and the one-hot class weights."""
    hm, wm = mask_size

    def f(rois, gt_masks, matches, cls_targets):
        b, r = rois.shape[:2]
        hg, wg = gt_masks.shape[-2:]
        bi = torch.arange(b, device=rois.device)[:, None]
        sel = gt_masks[bi, matches.long()]                    # (B, R, Hg, Wg)
        x0, y0, x1, y1 = rois.unbind(-1)
        cy = (torch.arange(hm, device=rois.device) + 0.5) / _full(hm, rois)
        cx = (torch.arange(wm, device=rois.device) + 0.5) / _full(wm, rois)
        ys = y0[..., None] + cy * (y1 - y0)[..., None]
        xs = x0[..., None] + cx * (x1 - x0)[..., None]
        yi = torch.clamp(ys.to(torch.int32), 0, hg - 1).long()
        xi = torch.clamp(xs.to(torch.int32), 0, wg - 1).long()
        ri = torch.arange(r, device=rois.device)[None, :, None, None]
        m_targets = sel[bi[:, :, None, None], ri, yi[..., :, None],
                        xi[..., None, :]]                      # (B, R, Hm, Wm)
        classes = torch.arange(num_classes, device=rois.device)
        weights = (cls_targets.long()[..., None] == classes).to(
            m_targets.dtype)
        m_out = m_targets[:, :, None] * weights[..., None, None]
        return m_out, torch.broadcast_to(weights[..., None, None],
                                         m_out.shape)

    return f


register_alias("_contrib_mrcnn_mask_target", "mrcnn_mask_target")


@register("rroi_align", differentiable=False)
def _rroi_align(pooled_size=(7, 7), spatial_scale=1.0, sampling_ratio=-1,
                **a):
    """Rotated ROI align (contrib RROIAlign): rois are ``(batch_index, cx,
    cy, w, h, angle in degrees)``; one bilinear sample per cell of a
    rotated grid."""
    ph, pw = pooled_size

    def f(data, rois):
        _, _, h, w = data.shape
        b = rois[:, 0].to(torch.int32).long()
        cx, cy, rw, rh = (rois[:, i] * spatial_scale for i in range(1, 5))
        ang = rois[:, 5] * math.pi / _full(180.0, rois)
        ys = (torch.arange(ph, device=data.device) + 0.5) / \
            _full(ph, rois) - 0.5
        xs = (torch.arange(pw, device=data.device) + 0.5) / \
            _full(pw, rois) - 0.5
        gy = (ys[None, :] * rh[:, None])[:, :, None].expand(-1, ph, pw)
        gx = (xs[None, :] * rw[:, None])[:, None, :].expand(-1, ph, pw)
        cos, sin = torch.cos(ang)[:, None, None], torch.sin(ang)[:, None, None]
        sx = cx[:, None, None] + gx * cos - gy * sin
        sy = cy[:, None, None] + gx * sin + gy * cos
        x0 = torch.clamp(torch.floor(sx).to(torch.int32), 0, w - 1)
        y0 = torch.clamp(torch.floor(sy).to(torch.int32), 0, h - 1)
        x1 = torch.clamp(x0 + 1, 0, w - 1)
        y1 = torch.clamp(y0 + 1, 0, h - 1)
        wx = torch.clamp(sx - x0, 0.0, 1.0)[:, None]
        wy = torch.clamp(sy - y0, 0.0, 1.0)[:, None]
        bb = b[:, None, None]

        def at(yy, xx):                                    # (R, C, Ph, Pw)
            return data[bb, :, yy.long(), xx.long()].permute(0, 3, 1, 2)

        return (at(y0, x0) * (1 - wy) * (1 - wx) + at(y0, x1) * (1 - wy) * wx
                + at(y1, x0) * wy * (1 - wx) + at(y1, x1) * wy * wx)

    return f


register_alias("_contrib_RROIAlign", "rroi_align")


def _kl_threshold(hist, hist_max, num_quant):
    """The KL-divergence-optimal |x| clipping threshold of a histogram (the
    reference's ``contrib.quantization._kl_threshold``, calibrate.cc
    GetOptimalThreshold): for each candidate bin count ``i`` the clipped
    distribution P is held against its ``num_quant``-level quantization Q,
    and the first ``i`` of least KL(P||Q) wins. Computed in float64 on the
    histogram's device; returns a 0-d tensor."""
    hist = hist.to(torch.float64)
    dev = hist.device
    num_bins = hist.shape[0]
    num_quant = min(num_quant, num_bins)
    step = max(1, (num_bins - num_quant) // 120)
    kls, ts = [], []
    for i in range(num_quant, num_bins + 1, step):
        p = hist[:i].clone()
        p[i - 1] += hist[i:].sum()
        factor = i / num_quant
        seg = [0] * i
        for j in range(num_quant):
            lo, hi = int(round(j * factor)), int(round((j + 1) * factor))
            hi = min(max(hi, lo + 1), i)
            seg[lo:hi] = [j] * (hi - lo)
        seg = torch.tensor(seg, device=dev)
        chunk = hist[:i]
        sums = torch.zeros(num_quant, dtype=torch.float64, device=dev) \
            .index_add_(0, seg, chunk)
        nz = torch.zeros(num_quant, dtype=torch.float64, device=dev) \
            .index_add_(0, seg, (chunk > 0).to(torch.float64))
        q = torch.where(chunk > 0, sums[seg] / nz[seg].clamp_min(1),
                        torch.zeros_like(chunk))
        ps, qs = p.sum(), q.sum()
        pn, qn = p / ps, q / qs
        kl = torch.sum(torch.where(
            pn > 0, pn * torch.log(pn.clamp_min(1e-12) / qn.clamp_min(1e-12)),
            torch.zeros_like(pn)))
        kls.append(torch.where((ps == 0) | (qs == 0),
                               torch.full_like(kl, math.inf), kl))
        ts.append(i / num_bins)
    kls = torch.stack(kls)
    best = torch.argmin(kls)        # the first of the least, as the loop's <
    t = torch.tensor(ts, dtype=torch.float64).to(dev)[best] * hist_max
    t = torch.where(torch.isinf(kls[best]), hist_max, t)
    return torch.where((hist.sum() == 0) | (hist_max == 0),
                       torch.ones_like(t), t)


@register("calibrate_entropy", nout=2, differentiable=False, eager_only=True)
def _calibrate_entropy(num_quantized_bins=255, **a):
    """The KL-optimal threshold of a histogram of |x| and its edges
    (quantization/calibrate.cc): returns ``(-t, t)`` as float32."""
    def f(hist, hist_edges):
        t = _kl_threshold(hist, hist_edges[-1].to(torch.float64),
                          max(1, num_quantized_bins // 2)).to(torch.float32)
        return -t, t

    return f


register_alias("_contrib_calibrate_entropy", "calibrate_entropy")
