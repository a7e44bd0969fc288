"""Vision datasets (reference: python/mxnet/gluon/data/vision/datasets.py).

Counterpart of ``mxnet_tpu/gluon/data/vision/datasets.py``. Nothing
downloads: datasets load from local files when present (idx files, plain or
gz, for MNIST and FashionMNIST, pickled batches for CIFAR-10 — the standard
formats), and otherwise fall back to the reference's DETERMINISTIC synthetic
sample set (``_synthetic_images``, the same seeds) with the same
shapes/dtypes/label space, flagged by ``.synthetic``; each package's
synthetic set is bitwise the other's. ``ImageFolderDataset`` reads ``.npy``
files with numpy and PNG/JPEG files through PIL. ``ImageRecordDataset``
reads an indexed ``.rec`` file of ``recordio.pack_img`` records and
``ImageListDataset`` a ``.lst`` file or a list of its entries; both decode
through ``mx.image``, to (H, W, C) NDArrays on the host.
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as onp

from ..dataset import Dataset, RecordFileDataset
from ....base import MXNetError

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "ImageFolderDataset", "ImageRecordDataset", "ImageListDataset"]


def _synthetic_images(n, shape, num_classes, seed):
    """Deterministic class-separable synthetic data: each class has a distinct
    frequency pattern plus noise — linear probes reach high accuracy, so
    convergence tests are meaningful."""
    rng = onp.random.RandomState(seed)
    labels = rng.randint(0, num_classes, size=n).astype(onp.int32)
    h, w = shape[0], shape[1]
    yy, xx = onp.mgrid[0:h, 0:w].astype(onp.float32)
    images = onp.empty((n,) + shape, dtype=onp.uint8)
    for c in range(num_classes):
        pattern = (127 + 120 * onp.sin((c + 1) * xx / w * onp.pi) *
                   onp.cos((c + 1) * yy / h * onp.pi)).astype(onp.float32)
        idx = labels == c
        k = int(idx.sum())
        if k == 0:
            continue
        noise = rng.normal(0, 30, size=(k,) + shape).astype(onp.float32)
        base = pattern[..., None] if len(shape) == 3 else pattern
        images[idx] = onp.clip(base + noise, 0, 255).astype(onp.uint8)
    return images, labels


class _DownloadedDataset(Dataset):
    def __init__(self, root, train, transform):
        self._root = os.path.expanduser(root)
        self._train = train
        self._transform = transform
        self._data = None
        self._label = None
        self.synthetic = False
        self._get_data()

    def __getitem__(self, idx):
        # samples stay on the host (numpy): the DataLoader moves each batch
        # to the device once (reference: copy-worker role,
        # threaded_engine_perdevice.cc:138)
        img = self._data[idx]
        label = int(self._label[idx])
        if self._transform is not None:
            return self._transform(img, label)
        return img, label

    def __len__(self):
        return len(self._label)


class MNIST(_DownloadedDataset):
    """MNIST (reference: datasets.py MNIST; native iter src/io/iter_mnist.cc:260)."""

    _shape = (28, 28, 1)
    _num_classes = 10
    _files = {True: ("train-images-idx3-ubyte", "train-labels-idx1-ubyte"),
              False: ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte")}
    _synth_n = {True: 8192, False: 1024}

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "mnist"),
                 train=True, transform=None):
        super().__init__(root, train, transform)

    def _read_idx(self, img_path, lbl_path):
        opener = gzip.open if img_path.endswith(".gz") else open
        with opener(lbl_path, "rb") as f:
            magic, num = struct.unpack(">II", f.read(8))
            label = onp.frombuffer(f.read(), dtype=onp.uint8)
        with opener(img_path, "rb") as f:
            magic, num, rows, cols = struct.unpack(">IIII", f.read(16))
            data = onp.frombuffer(f.read(), dtype=onp.uint8)
            data = data.reshape(num, rows, cols, 1)
        return data, label.astype(onp.int32)

    def _get_data(self):
        img, lbl = self._files[self._train]
        for ext in ("", ".gz"):
            ip = os.path.join(self._root, img + ext)
            lp = os.path.join(self._root, lbl + ext)
            if os.path.exists(ip) and os.path.exists(lp):
                self._data, self._label = self._read_idx(ip, lp)
                return
        self.synthetic = True
        self._data, self._label = _synthetic_images(
            self._synth_n[self._train], self._shape, self._num_classes,
            seed=42 if self._train else 43)


class FashionMNIST(MNIST):
    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "fashion-mnist"),
                 train=True, transform=None):
        super().__init__(root, train, transform)


class CIFAR10(_DownloadedDataset):
    _shape = (32, 32, 3)
    _num_classes = 10
    _synth_n = {True: 8192, False: 1024}

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "cifar10"),
                 train=True, transform=None):
        super().__init__(root, train, transform)

    def _get_data(self):
        import pickle

        batch_dir = os.path.join(self._root, "cifar-10-batches-py")
        names = [f"data_batch_{i}" for i in range(1, 6)] if self._train \
            else ["test_batch"]
        paths = [os.path.join(batch_dir, n) for n in names]
        if all(os.path.exists(p) for p in paths):
            data, labels = [], []
            for p in paths:
                with open(p, "rb") as f:
                    d = pickle.load(f, encoding="bytes")
                data.append(d[b"data"].reshape(-1, 3, 32, 32)
                            .transpose(0, 2, 3, 1))
                labels.extend(d[b"labels"])
            self._data = onp.concatenate(data)
            self._label = onp.asarray(labels, dtype=onp.int32)
            return
        self.synthetic = True
        self._data, self._label = _synthetic_images(
            self._synth_n[self._train], self._shape, self._num_classes,
            seed=44 if self._train else 45)


class CIFAR100(CIFAR10):
    _num_classes = 100

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "cifar100"),
                 train=True, transform=None, fine_label=True):
        super().__init__(root, train, transform)

    def _get_data(self):
        self.synthetic = True
        self._data, self._label = _synthetic_images(
            self._synth_n[self._train], self._shape, self._num_classes,
            seed=46 if self._train else 47)


class ImageFolderDataset(Dataset):
    """Images arranged in class folders (reference: ImageFolderDataset).
    Requires PNG/JPEG decodable by PIL if available, else .npy files."""

    def __init__(self, root, flag=1, transform=None):
        self._root = os.path.expanduser(root)
        self._transform = transform
        self._exts = (".npy", ".png", ".jpg", ".jpeg")
        self.synsets = []
        self.items = []
        for folder in sorted(os.listdir(self._root)):
            path = os.path.join(self._root, folder)
            if not os.path.isdir(path):
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for fname in sorted(os.listdir(path)):
                if fname.lower().endswith(self._exts):
                    self.items.append((os.path.join(path, fname), label))

    def __getitem__(self, idx):
        path, label = self.items[idx]
        if path.endswith(".npy"):
            img = onp.load(path)
        else:
            from PIL import Image  # ImportError where PIL is missing

            img = onp.asarray(Image.open(path).convert("RGB"))
        if self._transform is not None:
            return self._transform(img, label)
        return img, label

    def __len__(self):
        return len(self.items)


class ImageRecordDataset(RecordFileDataset):
    """(image, label) samples from a packed RecordIO file (reference:
    vision/datasets.py ImageRecordDataset:238): the records are
    ``recordio.pack_img``'s, decoded by ``mx.image.imdecode``."""

    def __init__(self, filename, flag=1, transform=None):
        super().__init__(filename)
        self._flag = flag
        self._transform = transform

    def __getitem__(self, idx):
        from ....image import imdecode
        from ....recordio import unpack

        header, img_bytes = unpack(super().__getitem__(idx))
        img = imdecode(img_bytes, self._flag)
        label = header.label
        if self._transform is not None:
            return self._transform(img, label)
        return img, label


class ImageListDataset(Dataset):
    """(image, label) samples from an ``.lst`` file or an in-memory list
    (reference: vision/datasets.py ImageListDataset): entries are
    ``key\\tlabel...\\tpath`` lines or ``[label..., path]`` lists."""

    def __init__(self, root=".", imglist=None, flag=1):
        self._root = os.path.expanduser(root)
        self._flag = flag
        self._items = []  # (label array, path)
        if isinstance(imglist, str):
            with open(os.path.join(self._root, imglist)) as fin:
                for line in fin:
                    parts = line.strip().split("\t")
                    if len(parts) < 3:
                        continue
                    label = onp.asarray([float(v) for v in parts[1:-1]],
                                        "float32")
                    self._items.append(
                        (label, os.path.join(self._root, parts[-1])))
        elif isinstance(imglist, (list, tuple)):
            for entry in imglist:
                if not isinstance(entry[-1], str):
                    raise MXNetError(
                        "imglist entries must end with the image path")
                label = onp.asarray(
                    entry[:-1] if len(entry) > 2 else [entry[0]],
                    "float32").reshape(-1)
                self._items.append(
                    (label, os.path.join(self._root, entry[-1])))
        else:
            raise MXNetError(
                f"imglist must be a filename or list, got {type(imglist)}")

    def __getitem__(self, idx):
        from ....image import imread

        label, path = self._items[idx]
        img = imread(path, self._flag)
        return img, label[0] if label.size == 1 else label

    def __len__(self):
        return len(self._items)
