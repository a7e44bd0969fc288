"""Seeded image record files and the detection dataset wrapper of
``chip_smoke.py``'s image phase. Imports neither JAX nor the JAX package,
so the card's machine and the DataLoader's spawned workers import it (to
unpickle :class:`SeededDetection`).

- :func:`photo` draws a photo-like image: a bilinear upsampling of a seeded
  8 x 8 thumbnail plus pixel noise, so a JPEG of it at quality 95 is of a
  photograph's size, not of pure noise's.
- :func:`pack_classification` and :func:`pack_detection` write indexed
  ``.rec`` files with the port's ``recordio``, each record from its own
  ``RandomState`` (records are made on a thread pool and written in
  order). A detection label has the reference's layout (MXNet's
  ``ImageDetIter``, ``im2rec --pack-label``): ``[2, 5]`` (the header's and
  an object's widths), then ``cls, xmin, ymin, xmax, ymax`` an object, the
  corners relative to the image's size.
"""
import concurrent.futures
import random

import numpy as onp


def photo(rs, h, w, noise=8):
    from PIL import Image

    small = Image.fromarray(rs.randint(0, 256, (8, 8, 3)).astype("uint8"))
    base = onp.asarray(small.resize((w, h), Image.BILINEAR), "int16")
    jitter = rs.randint(-noise, noise + 1, (h, w, 3)).astype("int16")
    return onp.clip(base + jitter, 0, 255).astype("uint8")


def _pack(prefix, n, make, threads=8):
    from mxnet_tpu_torch import recordio

    rec = recordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    with concurrent.futures.ThreadPoolExecutor(threads) as pool:
        for i, buf in enumerate(pool.map(make, range(n))):
            rec.write_idx(i, buf)
    rec.close()
    return prefix + ".rec"


def pack_classification(prefix, n, seed, side=(300, 500), classes=1000,
                        quality=95):
    """``n`` JPEGs of ``side[0]``-``side[1] - 1`` px a side, labels in
    ``[0, classes)``."""
    from mxnet_tpu_torch import recordio

    def make(i):
        rs = onp.random.RandomState(seed * 100003 + i)
        h, w = rs.randint(*side, size=2)
        label = float(rs.randint(classes))
        return recordio.pack_img(recordio.IRHeader(0, label, i),
                                 photo(rs, h, w), quality=quality)

    return _pack(prefix, n, make)


def pack_detection(prefix, n, seed, size=(500, 375), boxes=(1, 6),
                   classes=20, quality=95):
    """``n`` JPEGs of ``size`` (width, height), each with ``boxes[0]``-
    ``boxes[1]`` objects in the reference's detection label layout."""
    from mxnet_tpu_torch import recordio

    w, h = size

    def make(i):
        rs = onp.random.RandomState(seed * 100003 + i)
        k = rs.randint(boxes[0], boxes[1] + 1)
        xy = rs.uniform(0.0, 0.7, (k, 2))
        wh = rs.uniform(0.1, 0.3, (k, 2))
        objs = onp.concatenate([rs.randint(0, classes, (k, 1)), xy,
                                onp.minimum(xy + wh, 1.0)], axis=1)
        label = onp.concatenate([[2.0, 5.0], objs.ravel()])
        return recordio.pack_img(recordio.IRHeader(0, label, i),
                                 photo(rs, h, w), quality=quality)

    return _pack(prefix, n, make)


class SeededDetection:
    """(image, boxes) samples of an ``ImageRecordDataset`` of
    :func:`pack_detection`'s records: boxes (N, 5) as ``xmin, ymin, xmax,
    ymax`` in pixels and the class. Python's ``random`` is seeded by the
    sample's index first, so the bbox Blocks that follow draw the same for
    a sample in any worker and in the caller's process."""

    def __init__(self, dataset, seed):
        self.dataset = dataset
        self.seed = seed

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, i):
        random.seed(self.seed * 100003 + i)
        img, label = self.dataset[i]
        head, width = int(label[0]), int(label[1])
        objs = onp.asarray(label[head:], "float32").reshape(-1, width)
        h, w = img.shape[:2]
        corners = objs[:, 1:5] * onp.array([w, h, w, h], "float32")
        return img, onp.concatenate([corners, objs[:, :1]], axis=1)
