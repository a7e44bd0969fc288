"""mx.image: image decoding, resizing, cropping, augmenters and
``ImageIter`` (reference: python/mxnet/image/image.py and detection.py).

Counterpart of ``mxnet_tpu/image/__init__.py``, the same host-side numpy
and PIL (the reference's OpenCV role). An image is an (H, W, C) array on the
host: each function returns an :class:`NDArray` on the CPU, as MXNet's
image functions do, and an ``ImageIter`` batch moves to the current
context once. Random draws come from ``mx.random.host_rng`` in the
reference's order, and ``mx.random.seed`` seeds it as the reference's, so
an augmented image after the same seed is the reference's bitwise.
``ImageIter`` shuffles with numpy's global generator, as the reference's.
"""
from __future__ import annotations

import numpy as onp

from ..base import MXNetError
from ..ndarray.ndarray import NDArray, array
from .. import io as _io
from .. import recordio as _recordio
from ..gluon.data.vision.transforms import _resize_np
from .. import random as _random

__all__ = ["imread", "imdecode", "imresize", "resize_short", "fixed_crop",
           "random_crop", "center_crop", "color_normalize", "scale_down",
           "copyMakeBorder", "random_size_crop", "imrotate", "random_rotate",
           "HorizontalFlipAug", "ResizeAug", "ForceResizeAug",
           "RandomCropAug", "CenterCropAug", "CastAug", "ColorNormalizeAug",
           "BrightnessJitterAug", "ContrastJitterAug", "SaturationJitterAug",
           "HueJitterAug", "RandomOrderAug", "ColorJitterAug", "LightingAug",
           "RandomGrayAug", "RandomSizedCropAug", "SequentialAug",
           "CreateAugmenter", "DetAugmenter", "DetBorrowAug",
           "DetHorizontalFlipAug", "DetRandomCropAug", "DetRandomPadAug",
           "DetRandomSelectAug", "CreateDetAugmenter", "ImageIter"]


def _np(img):
    return img.asnumpy() if isinstance(img, NDArray) else onp.asarray(img)


def _host(a):
    """An image as a C-ordered NDArray on the host (64-bit values narrowed
    to 32 bits), as the reference's arrays are: numpy reduces an array in
    the order of its memory, so a later ``mean`` rounds as the reference's
    only on the same layout."""
    return array(onp.ascontiguousarray(a), device="cpu")


def imread(filename, flag=1, to_rgb=True):
    from PIL import Image

    img = Image.open(filename)
    if flag:
        img = img.convert("RGB")
    return _host(onp.asarray(img))


def imdecode(buf, flag=1, to_rgb=True):
    import io as _pyio

    from PIL import Image

    if isinstance(buf, NDArray):
        buf = buf.asnumpy().tobytes()
    img = Image.open(_pyio.BytesIO(bytes(buf)))
    if flag:
        img = img.convert("RGB")
    return _host(onp.asarray(img))


def imresize(src, w, h, interp=1):
    return _host(_resize_np(_np(src), (w, h)))


def resize_short(src, size, interp=1):
    img = _np(src)
    h, w = img.shape[:2]
    if h > w:
        nw, nh = size, int(h * size / w)
    else:
        nw, nh = int(w * size / h), size
    return _host(_resize_np(img, (nw, nh)))


def fixed_crop(src, x0, y0, w, h, size=None, interp=1):
    img = _np(src)[y0:y0 + h, x0:x0 + w]
    if size is not None and (size[0] != w or size[1] != h):
        img = _resize_np(img, size)
    return _host(img)


def random_crop(src, size, interp=1):
    img = _np(src)
    h, w = img.shape[:2]
    cw, ch = size
    x0 = _random.host_rng.randint(0, max(1, w - cw + 1))
    y0 = _random.host_rng.randint(0, max(1, h - ch + 1))
    return fixed_crop(src, x0, y0, cw, ch), (x0, y0, cw, ch)


def center_crop(src, size, interp=1):
    img = _np(src)
    h, w = img.shape[:2]
    cw, ch = size
    x0 = max(0, (w - cw) // 2)
    y0 = max(0, (h - ch) // 2)
    return fixed_crop(src, x0, y0, cw, ch), (x0, y0, cw, ch)


def color_normalize(src, mean, std=None):
    img = _np(src).astype("float32")
    img = img - _np(mean)
    if std is not None:
        img = img / _np(std)
    return _host(img)


class Augmenter:
    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def __call__(self, src):
        raise NotImplementedError


class ResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size)
        self.size = size

    def __call__(self, src):
        return resize_short(src, self.size)


class ForceResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size)
        self.size = size

    def __call__(self, src):
        return imresize(src, self.size[0], self.size[1])


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size)
        self.size = size

    def __call__(self, src):
        return random_crop(src, self.size)[0]


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size)
        self.size = size

    def __call__(self, src):
        return center_crop(src, self.size)[0]


class HorizontalFlipAug(Augmenter):
    def __init__(self, p=0.5):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if _random.host_rng.rand() < self.p:
            return _host(_np(src)[:, ::-1].copy())
        return src


class CastAug(Augmenter):
    def __init__(self, typ="float32"):
        super().__init__(typ=typ)
        self.typ = typ

    def __call__(self, src):
        return _host(_np(src).astype(self.typ))


class ColorNormalizeAug(Augmenter):
    def __init__(self, mean, std):
        super().__init__()
        self.mean = mean
        self.std = std

    def __call__(self, src):
        return color_normalize(src, self.mean, self.std)


class _JitterAug(Augmenter):
    def __init__(self, jitter):
        super().__init__(jitter=jitter)
        self.jitter = jitter

    def _alpha(self):
        return 1.0 + _random.host_rng.uniform(-self.jitter, self.jitter)


class BrightnessJitterAug(_JitterAug):
    def __call__(self, src):
        return _host(_np(src).astype("float32") * self._alpha())


class ContrastJitterAug(_JitterAug):
    def __call__(self, src):
        img = _np(src).astype("float32")
        gray = img.mean()
        a = self._alpha()
        return _host(img * a + gray * (1 - a))


class SaturationJitterAug(_JitterAug):
    def __call__(self, src):
        img = _np(src).astype("float32")
        gray = img.mean(axis=-1, keepdims=True)
        a = self._alpha()
        return _host(img * a + gray * (1 - a))


class HueJitterAug(_JitterAug):
    """Hue rotation in YIQ space (reference: image.py HueJitterAug)."""

    def __call__(self, src):
        img = _np(src).astype("float32")
        alpha = _random.host_rng.uniform(-self.jitter, self.jitter)
        u, w = onp.cos(alpha * onp.pi), onp.sin(alpha * onp.pi)
        t_yiq = onp.array([[0.299, 0.587, 0.114],
                           [0.596, -0.274, -0.321],
                           [0.211, -0.523, 0.311]])
        t_rgb = onp.array([[1.0, 0.956, 0.621],
                           [1.0, -0.272, -0.647],
                           [1.0, -1.107, 1.705]])
        rot = onp.array([[1.0, 0.0, 0.0], [0.0, u, -w], [0.0, w, u]])
        t = t_rgb @ rot @ t_yiq
        return _host(img @ t.T.astype("float32"))


class RandomOrderAug(Augmenter):
    """Apply child augmenters in random order (reference: RandomOrderAug —
    the color-jitter pipeline shuffles per sample)."""

    def __init__(self, ts):
        super().__init__()
        self.ts = list(ts)

    def __call__(self, src):
        order = _random.host_rng.permutation(len(self.ts))
        for i in order:
            src = self.ts[i](src)
        return src


def ColorJitterAug(brightness, contrast, saturation):
    """Random-order brightness/contrast/saturation jitter (reference:
    image.py ColorJitterAug over RandomOrderAug)."""
    ts = []
    if brightness > 0:
        ts.append(BrightnessJitterAug(brightness))
    if contrast > 0:
        ts.append(ContrastJitterAug(contrast))
    if saturation > 0:
        ts.append(SaturationJitterAug(saturation))
    return RandomOrderAug(ts)


class LightingAug(Augmenter):
    """PCA-based RGB lighting noise (reference: LightingAug; AlexNet-style)."""

    def __init__(self, alphastd, eigval, eigvec):
        super().__init__()
        self.alphastd = alphastd
        self.eigval = onp.asarray(eigval, dtype="float32")
        self.eigvec = onp.asarray(eigvec, dtype="float32")

    def __call__(self, src):
        alpha = _random.host_rng.normal(0, self.alphastd, size=(3,))
        rgb = (self.eigvec * alpha * self.eigval).sum(axis=1)
        return _host(_np(src).astype("float32") + rgb.astype("float32"))


class RandomGrayAug(Augmenter):
    """Randomly convert to 3-channel grayscale (reference: RandomGrayAug)."""

    _W = onp.array([0.299, 0.587, 0.114], dtype="float32")

    def __init__(self, p=0.5):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if _random.host_rng.rand() < self.p:
            img = _np(src).astype("float32")
            gray = (img * self._W).sum(axis=-1, keepdims=True)
            return _host(onp.broadcast_to(gray, img.shape).copy())
        return src


class RandomSizedCropAug(Augmenter):
    """Random area+aspect crop then resize (reference: RandomSizedCropAug /
    inception-style)."""

    def __init__(self, size, area=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interp=2):
        super().__init__()
        self.size = size
        self.area = area if isinstance(area, tuple) else (area, 1.0)
        self.ratio = ratio

    def __call__(self, src):
        # one sampling implementation for both spellings (reference:
        # RandomSizedCropAug calls random_size_crop)
        return random_size_crop(src, self.size, self.area, self.ratio)[0]


# -- detection augmenters (reference: image/detection.py det_aug family) ----
class DetAugmenter:
    """Augmenter over (image, label) pairs; label rows [cls, x1, y1, x2, y2]
    in RELATIVE coords (reference: image/detection.py DetAugmenter)."""

    def __call__(self, src, label):
        raise NotImplementedError


class DetBorrowAug(DetAugmenter):
    """Lift an image-only augmenter into the detection pipeline."""

    def __init__(self, augmenter):
        self.augmenter = augmenter

    def __call__(self, src, label):
        return self.augmenter(src), label


class DetHorizontalFlipAug(DetAugmenter):
    def __init__(self, p=0.5):
        self.p = p

    def __call__(self, src, label):
        if _random.host_rng.rand() < self.p:
            img = _host(_np(src)[:, ::-1].copy())
            lab = onp.array(label, dtype="float32", copy=True)
            x1 = lab[:, 1].copy()
            lab[:, 1] = 1.0 - lab[:, 3]
            lab[:, 3] = 1.0 - x1
            return img, lab
        return src, onp.asarray(label, dtype="float32")


class DetRandomCropAug(DetAugmenter):
    """IoU-constrained random crop (SSD-style; reference:
    DetRandomCropAug). Boxes are clipped to the crop; boxes whose center
    falls outside are dropped (marked -1)."""

    def __init__(self, min_object_covered=0.1, aspect_ratio_range=(0.75,
                 1.33), area_range=(0.3, 1.0), max_attempts=20):
        self.min_object_covered = min_object_covered
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.max_attempts = max_attempts

    def __call__(self, src, label):
        img = _np(src)
        h, w = img.shape[:2]
        lab = onp.array(label, dtype="float32", copy=True)
        for _ in range(self.max_attempts):
            area = _random.host_rng.uniform(*self.area_range)
            ar = _random.host_rng.uniform(*self.aspect_ratio_range)
            cw = min(1.0, (area * ar) ** 0.5)
            ch = min(1.0, (area / ar) ** 0.5)
            cx = _random.host_rng.uniform(0, 1 - cw)
            cy = _random.host_rng.uniform(0, 1 - ch)
            valid = lab[:, 0] >= 0
            if valid.any():
                centers_x = (lab[valid, 1] + lab[valid, 3]) / 2
                centers_y = (lab[valid, 2] + lab[valid, 4]) / 2
                inside = ((centers_x >= cx) & (centers_x <= cx + cw) &
                          (centers_y >= cy) & (centers_y <= cy + ch))
                if not inside.any():
                    continue
                # coverage constraint (reference: min_object_covered):
                # every kept (center-inside) box must have enough of its
                # area inside the crop
                ix1 = onp.maximum(lab[valid, 1], cx)
                iy1 = onp.maximum(lab[valid, 2], cy)
                ix2 = onp.minimum(lab[valid, 3], cx + cw)
                iy2 = onp.minimum(lab[valid, 4], cy + ch)
                inter = onp.clip(ix2 - ix1, 0, None) * \
                    onp.clip(iy2 - iy1, 0, None)
                area = (lab[valid, 3] - lab[valid, 1]) * \
                    (lab[valid, 4] - lab[valid, 2])
                cov = onp.where(area > 0, inter / onp.maximum(area, 1e-12),
                                0.0)
                if (cov[inside] < self.min_object_covered).any():
                    continue
            x0, y0 = int(cx * w), int(cy * h)
            x1, y1 = int((cx + cw) * w), int((cy + ch) * h)
            crop = img[y0:y1, x0:x1]
            new = lab.copy()
            for i in range(new.shape[0]):
                if new[i, 0] < 0:
                    continue
                bcx = (new[i, 1] + new[i, 3]) / 2
                bcy = (new[i, 2] + new[i, 4]) / 2
                if not (cx <= bcx <= cx + cw and cy <= bcy <= cy + ch):
                    new[i] = -1.0
                    continue
                new[i, 1] = onp.clip((new[i, 1] - cx) / cw, 0, 1)
                new[i, 3] = onp.clip((new[i, 3] - cx) / cw, 0, 1)
                new[i, 2] = onp.clip((new[i, 2] - cy) / ch, 0, 1)
                new[i, 4] = onp.clip((new[i, 4] - cy) / ch, 0, 1)
            return _host(crop.copy()), new
        return src, lab


class DetRandomPadAug(DetAugmenter):
    """Random expand-and-pad (zoom out; reference: DetRandomPadAug)."""

    def __init__(self, aspect_ratio_range=(0.75, 1.33),
                 area_range=(1.0, 3.0), max_attempts=20,
                 pad_val=(127, 127, 127)):
        self.area_range = area_range
        self.aspect_ratio_range = aspect_ratio_range
        self.max_attempts = max_attempts
        self.pad_val = pad_val

    def __call__(self, src, label):
        img = _np(src)
        h, w = img.shape[:2]
        lab = onp.array(label, dtype="float32", copy=True)
        nw = nh = 0
        for _ in range(self.max_attempts):
            scale = _random.host_rng.uniform(*self.area_range)
            ar = _random.host_rng.uniform(*self.aspect_ratio_range)
            nw = int(w * (scale * ar) ** 0.5)
            nh = int(h * (scale / ar) ** 0.5)
            if nw >= w and nh >= h:
                break
        if nw < w or nh < h:
            return src, lab
        x0 = _random.host_rng.randint(0, nw - w + 1)
        y0 = _random.host_rng.randint(0, nh - h + 1)
        canvas = onp.empty((nh, nw) + img.shape[2:], img.dtype)
        canvas[...] = onp.asarray(self.pad_val, dtype=img.dtype)
        canvas[y0:y0 + h, x0:x0 + w] = img
        valid = lab[:, 0] >= 0
        lab[valid, 1] = (lab[valid, 1] * w + x0) / nw
        lab[valid, 3] = (lab[valid, 3] * w + x0) / nw
        lab[valid, 2] = (lab[valid, 2] * h + y0) / nh
        lab[valid, 4] = (lab[valid, 4] * h + y0) / nh
        return _host(canvas), lab


class DetRandomSelectAug(DetAugmenter):
    """Randomly pick one of several det augmenters (or skip)."""

    def __init__(self, aug_list, skip_prob=0.0):
        self.aug_list = list(aug_list)
        self.skip_prob = skip_prob

    def __call__(self, src, label):
        if _random.host_rng.rand() < self.skip_prob or not self.aug_list:
            return src, onp.asarray(label, dtype="float32")
        pick = _random.host_rng.randint(len(self.aug_list))
        return self.aug_list[pick](src, label)


def CreateDetAugmenter(data_shape, resize=0, rand_crop=0, rand_pad=0,
                       rand_mirror=False, mean=None, std=None, brightness=0,
                       contrast=0, saturation=0, pca_noise=0, hue=0,
                       inter_method=2, min_object_covered=0.1,
                       aspect_ratio_range=(0.75, 1.33),
                       area_range=(0.3, 3.0), pad_val=(127, 127, 127)):
    """Build the detection augmenter list (reference: image/detection.py
    CreateDetAugmenter)."""
    auglist = []
    if resize > 0:
        auglist.append(DetBorrowAug(ResizeAug(resize, inter_method)))
    if rand_crop > 0:
        crop = DetRandomCropAug(min_object_covered, aspect_ratio_range,
                                (area_range[0], min(1.0, area_range[1])))
        auglist.append(DetRandomSelectAug([crop], 1 - rand_crop))
    if rand_pad > 0:
        pad = DetRandomPadAug(aspect_ratio_range,
                              (max(1.0, area_range[0]), area_range[1]),
                              pad_val=pad_val)
        auglist.append(DetRandomSelectAug([pad], 1 - rand_pad))
    if rand_mirror:
        auglist.append(DetHorizontalFlipAug(0.5))
    if pca_noise > 0:
        eigval = onp.array([55.46, 4.794, 1.148])
        eigvec = onp.array([[-0.5675, 0.7192, 0.4009],
                            [-0.5808, -0.0045, -0.814],
                            [-0.5836, -0.6948, 0.4203]])
        auglist.append(DetBorrowAug(LightingAug(pca_noise, eigval, eigvec)))
    auglist.append(DetBorrowAug(ForceResizeAug((data_shape[2],
                                                data_shape[1]))))
    auglist.append(DetBorrowAug(CastAug()))
    if brightness or contrast or saturation:
        auglist.append(DetBorrowAug(ColorJitterAug(brightness, contrast,
                                                   saturation)))
    if hue:
        auglist.append(DetBorrowAug(HueJitterAug(hue)))
    if mean is True:
        mean = onp.array([123.68, 116.28, 103.53])
    if std is True:
        std = onp.array([58.395, 57.12, 57.375])
    if mean is not None:
        auglist.append(DetBorrowAug(ColorNormalizeAug(
            mean, std if std is not None else onp.ones(3))))
    return auglist


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, pca_noise=0, rand_gray=0,
                    inter_method=2):
    """Build the standard augmenter list (reference: image.py
    CreateAugmenter)."""
    auglist = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    crop_size = (data_shape[2], data_shape[1])
    if rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    auglist.append(CastAug())
    if brightness:
        auglist.append(BrightnessJitterAug(brightness))
    if contrast:
        auglist.append(ContrastJitterAug(contrast))
    if saturation:
        auglist.append(SaturationJitterAug(saturation))
    if pca_noise > 0:
        eigval = onp.array([55.46, 4.794, 1.148])
        eigvec = onp.array([[-0.5675, 0.7192, 0.4009],
                            [-0.5808, -0.0045, -0.814],
                            [-0.5836, -0.6948, 0.4203]])
        auglist.append(LightingAug(pca_noise, eigval, eigvec))
    if rand_gray > 0:
        auglist.append(RandomGrayAug(rand_gray))
    if mean is True:
        mean = onp.array([123.68, 116.28, 103.53])
    if std is True:
        std = onp.array([58.395, 57.12, 57.375])
    if mean is not None:
        auglist.append(ColorNormalizeAug(mean, std if std is not None
                                         else onp.ones(3)))
    return auglist


class ImageIter(_io.DataIter):
    """Image iterator over a .rec file or a .lst file and its images
    (reference: image.py ImageIter): records are read from the file as a
    batch needs them; each batch moves to the current context once."""

    def __init__(self, batch_size, data_shape, label_width=1,
                 path_imgrec=None, path_imglist=None, path_root="",
                 shuffle=False, aug_list=None, **kwargs):
        super().__init__(batch_size)
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self.auglist = aug_list if aug_list is not None else \
            CreateAugmenter(data_shape, **{k: v for k, v in kwargs.items()
                                           if k in ("resize", "rand_crop",
                                                    "rand_mirror", "mean",
                                                    "std")})
        self._records = []
        self._rec = None
        if path_imgrec:
            # the native reader indexes the file when it opens it
            self._rec = _recordio.MXRecordIO(path_imgrec, "r")
            self._records = list(range(self._rec.num_records))
        elif path_imglist:
            with open(path_imglist) as f:
                for line in f:
                    parts = line.strip().split("\t")
                    label = float(parts[1])
                    self._records.append((label, path_root + parts[-1]))
        else:
            raise MXNetError("need path_imgrec or path_imglist")
        self._from_rec = path_imgrec is not None
        self._shuffle = shuffle
        self._order = onp.arange(len(self._records))
        self.reset()

    def reset(self):
        self.cur = 0
        if self._shuffle:
            onp.random.shuffle(self._order)

    def _load(self, idx):
        if self._from_rec:
            header, img = _recordio.unpack_img(
                self._rec._read_at(self._records[idx]))
            label = header.label
        else:
            label, path = self._records[idx]
            img = _np(imread(path))
        for aug in self.auglist:
            img = aug(img)
        arr = _np(img).astype("float32")
        if arr.ndim == 3 and arr.shape[2] in (1, 3):
            arr = arr.transpose(2, 0, 1)
        return arr, label

    def __next__(self):
        if self.cur >= len(self._records):
            raise StopIteration
        n = min(self.batch_size, len(self._records) - self.cur)
        imgs = onp.zeros((self.batch_size,) + self.data_shape, "float32")
        labels = onp.zeros((self.batch_size,), "float32")
        for i in range(n):
            arr, label = self._load(self._order[self.cur + i])
            imgs[i] = arr
            labels[i] = label if onp.isscalar(label) else label[0] \
                if hasattr(label, "__len__") else float(label)
        self.cur += n
        return _io.DataBatch([array(imgs)], [array(labels)],
                             pad=self.batch_size - n)


def scale_down(src_size, size):
    """Shrink a crop size to fit inside the image, keeping aspect
    (reference: image.py scale_down:214)."""
    w, h = size
    sw, sh = src_size
    if sh < h:
        w, h = float(w * sh) / h, sh
    if sw < w:
        w, h = sw, float(h * sw) / w
    return int(w), int(h)


def copyMakeBorder(src, top, bot, left, right, border_type=0, value=0):
    """Pad an (H, W, C) image border (reference: image.py
    copyMakeBorder:249 over cv2). ``border_type`` 0 = constant fill,
    1 = replicate edge."""
    img = _np(src)
    pad_width = ((top, bot), (left, right)) + ((0, 0),) * (img.ndim - 2)
    if border_type == 1:
        out = onp.pad(img, pad_width, "edge")
    else:
        out = onp.pad(img, pad_width, "constant", constant_values=value)
    return _host(out)


def random_size_crop(src, size, area, ratio, interp=1, **kwargs):
    """Random crop with randomized area and aspect ratio, resized to
    ``size`` (reference: image.py random_size_crop:563). Returns
    (image, (x0, y0, w, h))."""
    if "min_area" in kwargs:  # legacy spelling (reference keeps it too)
        area = kwargs.pop("min_area")
    if kwargs:
        raise MXNetError(
            f"random_size_crop: unexpected arguments {sorted(kwargs)}")
    img = _np(src)
    h, w = img.shape[:2]
    src_area = h * w
    if isinstance(area, (int, float)):
        area = (area, 1.0)
    for _ in range(10):
        target_area = _random.host_rng.uniform(*area) * src_area
        log_ratio = (onp.log(ratio[0]), onp.log(ratio[1]))
        ar = onp.exp(_random.host_rng.uniform(*log_ratio))
        cw = int(round(onp.sqrt(target_area * ar)))
        ch = int(round(onp.sqrt(target_area / ar)))
        if cw <= w and ch <= h:
            x0 = _random.host_rng.randint(0, w - cw + 1)
            y0 = _random.host_rng.randint(0, h - ch + 1)
            out = fixed_crop(img, x0, y0, cw, ch, size, interp)
            return out, (x0, y0, cw, ch)
    # fallback: center crop at the (scaled-down) requested size
    cw, ch = scale_down((w, h), size)
    x0, y0 = (w - cw) // 2, (h - ch) // 2
    return fixed_crop(img, x0, y0, cw, ch, size, interp), \
        (x0, y0, cw, ch)


def imrotate(src, rotation_degrees, zoom_in=False, zoom_out=False):
    """Rotate CHW (or NCHW batch) float32 images by degrees (reference:
    image.py imrotate:618) via inverse affine + bilinear sampling; area
    outside the source fills with zeros. ``zoom_in`` scales so no padding
    shows; ``zoom_out`` so the full rotated frame fits."""
    if zoom_in and zoom_out:
        raise MXNetError("only one of zoom_in and zoom_out may be set")
    img = _np(src).astype("float32")
    batched = img.ndim == 4
    imgs = img if batched else img[None]
    n, c, h, w = imgs.shape
    degs = onp.broadcast_to(onp.asarray(_np(rotation_degrees),
                                        "float32").reshape(-1), (n,)) \
        if not onp.isscalar(rotation_degrees) else \
        onp.full((n,), float(rotation_degrees), "float32")
    out = onp.zeros_like(imgs)
    yy, xx = onp.mgrid[0:h, 0:w].astype("float32")
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    for i in range(n):
        rad = onp.deg2rad(float(degs[i]))
        cos, sin = onp.cos(rad), onp.sin(rad)
        # rotated-frame extents of the ACTUAL h x w rectangle: correct
        # for non-square images (a 90-deg zoom_in of a wide image must
        # zoom until the short side covers the long axis)
        ext = max((w * abs(cos) + h * abs(sin)) / w,
                  (w * abs(sin) + h * abs(cos)) / h)
        if zoom_in:
            s = 1.0 / ext
        elif zoom_out:
            s = ext
        else:
            s = 1.0
        # inverse map: output pixel -> source coords
        dx, dy = (xx - cx) * s, (yy - cy) * s
        sx = cos * dx + sin * dy + cx
        sy = -sin * dx + cos * dy + cy
        x0 = onp.floor(sx).astype(int)
        y0 = onp.floor(sy).astype(int)
        fx, fy = sx - x0, sy - y0
        for dyy in (0, 1):
            for dxx in (0, 1):
                wgt = (fy if dyy else 1 - fy) * (fx if dxx else 1 - fx)
                ys_, xs_ = y0 + dyy, x0 + dxx
                ok = (ys_ >= 0) & (ys_ < h) & (xs_ >= 0) & (xs_ < w)
                ysc = onp.clip(ys_, 0, h - 1)
                xsc = onp.clip(xs_, 0, w - 1)
                out[i] += imgs[i][:, ysc, xsc] * (wgt * ok)[None]
    res = out if batched else out[0]
    return _host(res)


def random_rotate(src, angle_limits, zoom_in=False, zoom_out=False):
    """Rotate by an angle drawn uniformly from ``angle_limits``
    (reference: image.py random_rotate)."""
    lo, hi = angle_limits
    img = _np(src)
    if img.ndim == 4:
        angles = _random.host_rng.uniform(lo, hi, size=(img.shape[0],))
        return imrotate(src, angles, zoom_in, zoom_out)
    return imrotate(src, float(_random.host_rng.uniform(lo, hi)),
                    zoom_in, zoom_out)


class SequentialAug(Augmenter):
    """Apply a list of augmenters in order (reference: image.py
    SequentialAug:787)."""

    def __init__(self, ts):
        super().__init__()
        self.ts = list(ts)

    def __call__(self, src):
        for aug in self.ts:
            src = aug(src)
        return src
