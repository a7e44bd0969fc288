"""Detection transforms and image loaders of ``gluon.contrib.data.vision``
(reference: python/mxnet/gluon/contrib/data/vision: transforms/bbox/bbox.py
Blocks, dataloader.py ImageDataLoader:140 and ImageBboxDataLoader:364).

Counterpart of ``mxnet_tpu/gluon/contrib/data/vision.py``. The Blocks take
(image (H, W, C), bbox (N, 4+)) pairs; bbox columns are (xmin, ymin, xmax,
ymax, extra...) and the extra columns pass through. The geometry runs in
numpy on the host, per sample, and each Block returns NDArrays on the host;
a loader moves each batch to the device once. Draws come from Python's
``random`` module, as the reference's, so the same ``random.seed`` gives
the reference's samples bitwise. ``ImageBboxDataLoader`` pads each batch's
boxes to its widest count with -1.
"""
from __future__ import annotations

import random as _pyrandom

import numpy as onp

from ....base import MXNetError
from ....ndarray.ndarray import NDArray, array
from ...block import Block
from ...data import DataLoader

__all__ = ["ImageBboxRandomFlipLeftRight", "ImageBboxCrop",
           "ImageBboxRandomCropWithConstraints", "ImageBboxRandomExpand",
           "ImageBboxResize", "ImageDataLoader", "ImageBboxDataLoader"]


def _np_pair(img, bbox):
    i = img.asnumpy() if isinstance(img, NDArray) else onp.asarray(img)
    b = bbox.asnumpy() if isinstance(bbox, NDArray) else onp.asarray(bbox)
    if b.ndim != 2 or b.shape[1] < 4:
        raise MXNetError(
            f"bbox must be (N, 4+) (xmin, ymin, xmax, ymax, ...), got "
            f"shape {b.shape}")
    return i, b.astype("float32")


def _out(img, bbox):
    return array(onp.ascontiguousarray(img), device="cpu"), \
        array(onp.ascontiguousarray(bbox), device="cpu")


def _crop_bbox(bbox, crop, allow_outside_center):
    """Clip boxes to a (x, y, w, h) crop window, translate to its frame,
    and drop degenerate / outside-center boxes."""
    x0, y0, w, h = crop
    out = bbox.copy()
    out[:, 0] = onp.clip(bbox[:, 0], x0, x0 + w) - x0
    out[:, 1] = onp.clip(bbox[:, 1], y0, y0 + h) - y0
    out[:, 2] = onp.clip(bbox[:, 2], x0, x0 + w) - x0
    out[:, 3] = onp.clip(bbox[:, 3], y0, y0 + h) - y0
    keep = (out[:, 2] > out[:, 0]) & (out[:, 3] > out[:, 1])
    if not allow_outside_center:
        cx = (bbox[:, 0] + bbox[:, 2]) / 2
        cy = (bbox[:, 1] + bbox[:, 3]) / 2
        keep &= (cx >= x0) & (cx < x0 + w) & (cy >= y0) & (cy < y0 + h)
    return out[keep]


class ImageBboxRandomFlipLeftRight(Block):
    """Flip image + boxes horizontally with probability ``p``."""

    def __init__(self, p=0.5):
        super().__init__()
        self.p = p

    def forward(self, img, bbox):
        i, b = _np_pair(img, bbox)
        if _pyrandom.random() < self.p:
            w = i.shape[1]
            i = i[:, ::-1]
            xmin = w - b[:, 2]
            b[:, 2] = w - b[:, 0]
            b[:, 0] = xmin
        return _out(i, b)


class ImageBboxCrop(Block):
    """Crop to ``crop`` = (xmin, ymin, width, height); boxes are clipped,
    translated, and filtered (reference bbox.py:90)."""

    def __init__(self, crop, allow_outside_center=False):
        super().__init__()
        if len(crop) != 4 or crop[2] <= 0 or crop[3] <= 0:
            raise MXNetError("crop must be (xmin, ymin, width>0, height>0)")
        self._crop = tuple(int(c) for c in crop)
        self._allow = allow_outside_center

    def forward(self, img, bbox):
        i, b = _np_pair(img, bbox)
        x0, y0, w, h = self._crop
        if x0 + w >= i.shape[1] or y0 + h >= i.shape[0]:
            return _out(i, b)  # out-of-range crop: no-op (reference)
        return _out(i[y0:y0 + h, x0:x0 + w],
                    _crop_bbox(b, self._crop, self._allow))


class ImageBboxRandomCropWithConstraints(Block):
    """SSD-style random crop: sample windows until one attains a minimum
    IoU with some ground-truth box (reference bbox.py:146 over
    bbox_random_crop_with_constraints)."""

    def __init__(self, p=0.5, min_scale=0.3, max_scale=1.0,
                 max_aspect_ratio=2.0, constraints=None, max_trial=50):
        super().__init__()
        self.p = p
        self._min_scale = min_scale
        self._max_scale = max_scale
        self._max_ar = max_aspect_ratio
        # reference default constraint list incl. the unconstrained-max
        # entry (contrib/data/vision/transforms/bbox/utils.py:386)
        self._constraints = constraints or (
            (0.1, None), (0.3, None), (0.5, None), (0.7, None),
            (0.9, None), (None, 1))
        self._max_trial = max_trial

    def _sample_window(self, w, h):
        scale = _pyrandom.uniform(self._min_scale, self._max_scale)
        ar = _pyrandom.uniform(
            max(1 / self._max_ar, scale ** 2),
            min(self._max_ar, 1 / scale ** 2))
        cw = int(w * scale * (ar ** 0.5))
        ch = int(h * scale / (ar ** 0.5))
        if cw <= 0 or ch <= 0 or cw > w or ch > h:
            return None
        return (_pyrandom.randint(0, w - cw),
                _pyrandom.randint(0, h - ch), cw, ch)

    def forward(self, img, bbox):
        i, b = _np_pair(img, bbox)
        if _pyrandom.random() > self.p:
            return _out(i, b)
        h, w = i.shape[:2]
        if not len(b):
            # negative sample: still crop the image (reference
            # utils.py:408 — the scale distribution must match)
            win = self._sample_window(w, h)
            if win is None:
                return _out(i, b)
            cx, cy, cw, ch = win
            return _out(i[cy:cy + ch, cx:cx + cw], b)
        # one candidate per constraint (ALL boxes must satisfy the IoU
        # band, reference utils.py:414), plus the full image; then pick
        # uniformly among candidates whose crop keeps at least one box
        candidates = [(0, 0, w, h)]
        for min_iou, max_iou in self._constraints:
            lo = -onp.inf if min_iou is None else min_iou
            hi = onp.inf if max_iou is None else max_iou
            for _ in range(self._max_trial):
                win = self._sample_window(w, h)
                if win is None:
                    continue
                cx, cy, cw, ch = win
                ix1 = onp.maximum(b[:, 0], cx)
                iy1 = onp.maximum(b[:, 1], cy)
                ix2 = onp.minimum(b[:, 2], cx + cw)
                iy2 = onp.minimum(b[:, 3], cy + ch)
                inter = onp.maximum(ix2 - ix1, 0) * onp.maximum(
                    iy2 - iy1, 0)
                area = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
                union = area + cw * ch - inter
                iou = inter / onp.maximum(union, 1e-12)
                if lo <= iou.min() and iou.max() <= hi:
                    candidates.append(win)
                    break
        while candidates:
            win = candidates.pop(_pyrandom.randrange(len(candidates)))
            cx, cy, cw, ch = win
            kept = _crop_bbox(b, win, False)
            if not len(kept):
                continue
            return _out(i[cy:cy + ch, cx:cx + cw], kept)
        return _out(i, b)


class ImageBboxRandomExpand(Block):
    """Place the image on a larger ``fill``-valued canvas with probability
    ``p``; boxes translate with it (reference bbox.py:216)."""

    def __init__(self, p=0.5, max_ratio=4, fill=0, keep_ratio=True):
        super().__init__()
        self.p = p
        self._max_ratio = max_ratio
        self._fill = fill
        self._keep_ratio = keep_ratio

    def forward(self, img, bbox):
        i, b = _np_pair(img, bbox)
        if self._max_ratio <= 1 or _pyrandom.random() > self.p:
            return _out(i, b)
        h, w, c = i.shape
        rx = _pyrandom.uniform(1, self._max_ratio)
        ry = rx if self._keep_ratio else _pyrandom.uniform(
            1, self._max_ratio)
        nw, nh = int(w * rx), int(h * ry)
        ox = _pyrandom.randint(0, nw - w)
        oy = _pyrandom.randint(0, nh - h)
        canvas = onp.empty((nh, nw, c), i.dtype)
        fill = onp.asarray(self._fill, i.dtype)
        canvas[...] = fill.reshape(1, 1, -1) if fill.ndim else fill
        canvas[oy:oy + h, ox:ox + w] = i
        b = b.copy()
        b[:, (0, 2)] += ox
        b[:, (1, 3)] += oy
        return _out(canvas, b)


class ImageBboxResize(Block):
    """Resize image to (``width``, ``height``); boxes scale accordingly
    (reference bbox.py:297)."""

    def __init__(self, width, height, interp=1):
        super().__init__()
        self._size = (int(width), int(height))
        self._interp = interp

    def forward(self, img, bbox):
        from ....image import imresize

        i, b = _np_pair(img, bbox)
        h, w = i.shape[:2]
        out = imresize(i, self._size[0], self._size[1], self._interp)
        b = b.copy()
        b[:, (0, 2)] *= self._size[0] / w
        b[:, (1, 3)] *= self._size[1] / h
        return out, array(b, device="cpu")


class _TransformedPairDataset:
    def __init__(self, dataset, blocks):
        self._ds = dataset
        self._blocks = blocks

    def __len__(self):
        return len(self._ds)

    def __getitem__(self, idx):
        img, label = self._ds[idx]
        for blk in self._blocks:
            img, label = blk(img, label)
        return img, label


class ImageDataLoader(DataLoader):
    """Classification image loader (reference dataloader.py:140): dataset
    of (image, label) with optional per-sample transform, batched through
    the standard DataLoader."""

    def __init__(self, dataset, batch_size, transform_fn=None, shuffle=False,
                 last_batch=None, num_workers=0, **kwargs):
        ds = dataset.transform_first(transform_fn) if transform_fn else \
            dataset
        super().__init__(ds, batch_size=batch_size, shuffle=shuffle,
                         last_batch=last_batch, num_workers=num_workers,
                         **kwargs)


class ImageBboxDataLoader(DataLoader):
    """Detection loader (reference dataloader.py:364): applies the bbox
    transform Blocks per sample and pads each batch's label tensors to the
    widest box count (boxes padded with -1, the detection ignore value)."""

    def __init__(self, dataset, batch_size, bbox_transforms=(),
                 shuffle=False, last_batch=None, num_workers=0, **kwargs):
        ds = _TransformedPairDataset(dataset, list(bbox_transforms)) \
            if bbox_transforms else dataset
        super().__init__(ds, batch_size=batch_size, shuffle=shuffle,
                         last_batch=last_batch, num_workers=num_workers,
                         batchify_fn=_bbox_batchify, **kwargs)


def _bbox_batchify(samples):
    """Images stacked and boxes padded with -1 to the widest count, as
    host arrays (the loader moves them to the device)."""
    imgs, boxes = zip(*samples)
    imgs = onp.stack([i.asnumpy() if isinstance(i, NDArray) else
                      onp.asarray(i) for i in imgs])
    arrs = [b.asnumpy() if isinstance(b, NDArray) else onp.asarray(b)
            for b in boxes]
    width = max(a.shape[0] for a in arrs)
    cols = arrs[0].shape[-1]
    padded = onp.full((len(arrs), width, cols), -1.0, "float32")
    for j, a in enumerate(arrs):
        padded[j, :a.shape[0]] = a
    return imgs, padded
