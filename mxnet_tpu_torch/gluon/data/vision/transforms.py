"""Vision transforms (reference: gluon/data/vision/transforms.py over
src/operator/image/*).

Counterpart of ``mxnet_tpu/gluon/data/vision/transforms.py``, the same
host-side numpy: a sample is transformed on the host (in a ``DataLoader``
worker where there is one), and the batch moves to the device once. The
random transforms draw from ``mx.random.host_rng``, which ``mx.random.seed``
seeds exactly as the reference's, so both packages draw the same
augmentations from one seed. A spawned worker's ``host_rng`` starts at
``RandomState(0)`` whatever the parent's seed, as in the reference (nothing
re-seeds it in a worker), so workers draw correlated augmentations.
"""
from __future__ import annotations

import numpy as onp

from ....ndarray.ndarray import NDArray
from ...block import Block
from ...nn.basic_layers import Sequential
from .... import random as _random


def _host(x):
    """Transforms operate host-side (numpy): one device transfer per batch
    happens in the DataLoader, not per sample."""
    return x.asnumpy() if isinstance(x, NDArray) else onp.asarray(x)

__all__ = ["Compose", "HybridCompose", "Cast", "ToTensor", "Normalize",
           "Resize", "CenterCrop", "RandomResizedCrop", "RandomCrop",
           "RandomFlipLeftRight", "RandomFlipTopBottom", "RandomBrightness",
           "RandomContrast", "RandomSaturation", "RandomLighting",
           "RandomApply", "HybridRandomApply"]


class Compose(Sequential):
    def __init__(self, transforms):
        super().__init__()
        self.add(*transforms)


class _Transform(Block):
    def __call__(self, x, *args):
        out = self.forward(x)
        return (out,) + args if args else out


class Cast(_Transform):
    def __init__(self, dtype="float32"):
        super().__init__()
        self._dtype = dtype

    def forward(self, x):
        return x.astype(self._dtype)


class ToTensor(_Transform):
    """HWC uint8 [0,255] -> CHW float32 [0,1] (reference: ToTensor op)."""

    def forward(self, x):
        a = _host(x).astype(onp.float32) / 255.0
        if a.ndim == 3:
            a = a.transpose(2, 0, 1)
        elif a.ndim == 4:
            a = a.transpose(0, 3, 1, 2)
        return (a)


class Normalize(_Transform):
    def __init__(self, mean=0.0, std=1.0):
        super().__init__()
        self._mean = onp.asarray(mean, dtype=onp.float32)
        self._std = onp.asarray(std, dtype=onp.float32)

    def forward(self, x):
        a = _host(x)
        c = a.shape[-3]  # CHW
        mean = self._mean.reshape(-1, 1, 1) if self._mean.ndim else self._mean
        std = self._std.reshape(-1, 1, 1) if self._std.ndim else self._std
        return ((a - mean) / std)


def _resize_np(a, size):
    """Nearest-neighbor resize on host (OpenCV role, src/io aug)."""
    h, w = a.shape[0], a.shape[1]
    ow, oh = (size, size) if isinstance(size, int) else size
    ri = (onp.arange(oh) * h / oh).astype(onp.int32)
    ci = (onp.arange(ow) * w / ow).astype(onp.int32)
    return a[ri][:, ci]


class Resize(_Transform):
    def __init__(self, size, keep_ratio=False, interpolation=1):
        super().__init__()
        self._size = size

    def forward(self, x):
        return (_resize_np(_host(x), self._size))


class CenterCrop(_Transform):
    def __init__(self, size, interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else size

    def forward(self, x):
        a = _host(x)
        h, w = a.shape[0], a.shape[1]
        cw, ch = self._size
        y0 = max(0, (h - ch) // 2)
        x0 = max(0, (w - cw) // 2)
        return (a[y0:y0 + ch, x0:x0 + cw])


class RandomCrop(_Transform):
    def __init__(self, size, pad=None, interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else size
        self._pad = pad

    def forward(self, x):
        a = _host(x)
        if self._pad:
            p = self._pad
            a = onp.pad(a, ((p, p), (p, p), (0, 0)), mode="constant")
        h, w = a.shape[0], a.shape[1]
        cw, ch = self._size
        y0 = _random.host_rng.randint(0, max(1, h - ch + 1))
        x0 = _random.host_rng.randint(0, max(1, w - cw + 1))
        return (a[y0:y0 + ch, x0:x0 + cw])


class RandomResizedCrop(_Transform):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else size
        self._scale = scale
        self._ratio = ratio

    def forward(self, x):
        a = _host(x)
        h, w = a.shape[0], a.shape[1]
        area = h * w
        for _ in range(10):
            target = _random.host_rng.uniform(*self._scale) * area
            ar = _random.host_rng.uniform(*self._ratio)
            cw = int(round(onp.sqrt(target * ar)))
            ch = int(round(onp.sqrt(target / ar)))
            if cw <= w and ch <= h:
                x0 = _random.host_rng.randint(0, w - cw + 1)
                y0 = _random.host_rng.randint(0, h - ch + 1)
                crop = a[y0:y0 + ch, x0:x0 + cw]
                return (_resize_np(crop, self._size))
        return (_resize_np(a, self._size))


class RandomFlipLeftRight(_Transform):
    def forward(self, x):
        if _random.host_rng.rand() < 0.5:
            return (_host(x)[:, ::-1].copy())
        return x


class RandomFlipTopBottom(_Transform):
    def forward(self, x):
        if _random.host_rng.rand() < 0.5:
            return (_host(x)[::-1].copy())
        return x


class _RandomJitter(_Transform):
    def __init__(self, amount):
        super().__init__()
        self._amount = amount

    def _factor(self):
        return 1.0 + _random.host_rng.uniform(-self._amount, self._amount)


class RandomBrightness(_RandomJitter):
    def forward(self, x):
        a = _host(x).astype(onp.float32)
        return (onp.clip(a * self._factor(), 0, 255).astype(x.dtype))


class RandomContrast(_RandomJitter):
    def forward(self, x):
        a = _host(x).astype(onp.float32)
        mean = a.mean()
        return (onp.clip((a - mean) * self._factor() + mean, 0, 255)
                       .astype(x.dtype))


class RandomSaturation(_RandomJitter):
    def forward(self, x):
        a = _host(x).astype(onp.float32)
        gray = a.mean(axis=-1, keepdims=True)
        f = self._factor()
        return (onp.clip(a * f + gray * (1 - f), 0, 255)
                       .astype(x.dtype))


class RandomLighting(_Transform):
    """AlexNet-style PCA lighting noise."""

    _eigval = onp.asarray([55.46, 4.794, 1.148], dtype=onp.float32)
    _eigvec = onp.asarray([[-0.5675, 0.7192, 0.4009],
                           [-0.5808, -0.0045, -0.8140],
                           [-0.5836, -0.6948, 0.4203]], dtype=onp.float32)

    def __init__(self, alpha=0.1):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        a = _host(x).astype(onp.float32)
        alpha = _random.host_rng.normal(0, self._alpha, size=(3,))
        rgb = (self._eigvec * alpha * self._eigval).sum(axis=1)
        return (onp.clip(a + rgb, 0, 255).astype(x.dtype))


class RandomApply(Sequential):
    """Apply the wrapped transforms with probability ``p`` (reference:
    transforms/__init__.py RandomApply:138)."""

    def __init__(self, transforms, p=0.5):
        super().__init__()
        if not isinstance(transforms, (list, tuple)):
            transforms = [transforms]
        self.add(*transforms)
        self.p = p

    def __call__(self, x, *args):
        if float(_random.host_rng.uniform()) < self.p:
            for block in self._modules.values():
                x = block(x)
        return (x,) + args if args else x


# every transform here is hybrid-capable; the reference split exists for
# the pre-Gluon2 Block/HybridBlock distinction
HybridCompose = Compose
HybridRandomApply = RandomApply
