"""Inception v3 (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/inception.py``): the blocks
``_make_A`` ... ``_make_E`` of parallel branches joined by ``_Concurrent``
(E's inner split by ``_BranchSplit``), each convolution followed by
BatchNorm (epsilon 1e-3) and ReLU."""
from __future__ import annotations

import torch

from ... import nn
from ...block import HybridBlock
from ._utils import build

__all__ = ["Inception3", "inception_v3"]


def _conv(channels, kernel_size, strides=1, padding=0):
    out = nn.HybridSequential()
    out.add(nn.Conv2D(channels, kernel_size, strides, padding,
                      use_bias=False))
    out.add(nn.BatchNorm(epsilon=0.001))
    out.add(nn.Activation("relu"))
    return out


class _Concurrent(HybridBlock):
    """Its branches over the same input, concatenated along channels."""

    _tensor_body = True

    def __init__(self):
        super().__init__()
        self.branches = nn.HybridSequential()

    def add(self, block):
        self.branches.add(block)

    def forward(self, x):
        return torch.cat([b(x) for b in self.branches], 1)


def _make_A(pool_features):
    out = _Concurrent()
    out.add(_conv(64, 1))
    b = nn.HybridSequential()
    b.add(_conv(48, 1))
    b.add(_conv(64, 5, padding=2))
    out.add(b)
    b = nn.HybridSequential()
    b.add(_conv(64, 1))
    b.add(_conv(96, 3, padding=1))
    b.add(_conv(96, 3, padding=1))
    out.add(b)
    b = nn.HybridSequential()
    b.add(nn.AvgPool2D(pool_size=3, strides=1, padding=1))
    b.add(_conv(pool_features, 1))
    out.add(b)
    return out


def _make_B():
    out = _Concurrent()
    out.add(_conv(384, 3, strides=2))
    b = nn.HybridSequential()
    b.add(_conv(64, 1))
    b.add(_conv(96, 3, padding=1))
    b.add(_conv(96, 3, strides=2))
    out.add(b)
    b = nn.HybridSequential()
    b.add(nn.MaxPool2D(pool_size=3, strides=2))
    out.add(b)
    return out


def _make_C(channels_7x7):
    out = _Concurrent()
    out.add(_conv(192, 1))
    b = nn.HybridSequential()
    b.add(_conv(channels_7x7, 1))
    b.add(_conv(channels_7x7, (1, 7), padding=(0, 3)))
    b.add(_conv(192, (7, 1), padding=(3, 0)))
    out.add(b)
    b = nn.HybridSequential()
    b.add(_conv(channels_7x7, 1))
    b.add(_conv(channels_7x7, (7, 1), padding=(3, 0)))
    b.add(_conv(channels_7x7, (1, 7), padding=(0, 3)))
    b.add(_conv(channels_7x7, (7, 1), padding=(3, 0)))
    b.add(_conv(192, (1, 7), padding=(0, 3)))
    out.add(b)
    b = nn.HybridSequential()
    b.add(nn.AvgPool2D(pool_size=3, strides=1, padding=1))
    b.add(_conv(192, 1))
    out.add(b)
    return out


def _make_D():
    out = _Concurrent()
    b = nn.HybridSequential()
    b.add(_conv(192, 1))
    b.add(_conv(320, 3, strides=2))
    out.add(b)
    b = nn.HybridSequential()
    b.add(_conv(192, 1))
    b.add(_conv(192, (1, 7), padding=(0, 3)))
    b.add(_conv(192, (7, 1), padding=(3, 0)))
    b.add(_conv(192, 3, strides=2))
    out.add(b)
    b = nn.HybridSequential()
    b.add(nn.MaxPool2D(pool_size=3, strides=2))
    out.add(b)
    return out


class _BranchSplit(HybridBlock):
    """A convolution, then two parallel ones concatenated (E's inner)."""

    _tensor_body = True

    def __init__(self, pre):
        super().__init__()
        self.pre = pre
        self.left = _conv(384, (1, 3), padding=(0, 1))
        self.right = _conv(384, (3, 1), padding=(1, 0))

    def forward(self, x):
        x = self.pre(x)
        return torch.cat([self.left(x), self.right(x)], 1)


def _make_E():
    out = _Concurrent()
    out.add(_conv(320, 1))
    out.add(_BranchSplit(_conv(384, 1)))
    pre = nn.HybridSequential()
    pre.add(_conv(448, 1))
    pre.add(_conv(384, 3, padding=1))
    out.add(_BranchSplit(pre))
    b = nn.HybridSequential()
    b.add(nn.AvgPool2D(pool_size=3, strides=1, padding=1))
    b.add(_conv(192, 1))
    out.add(b)
    return out


class Inception3(HybridBlock):
    _tensor_body = True

    def __init__(self, classes=1000):
        super().__init__()
        self.features = nn.HybridSequential()
        self.features.add(_conv(32, 3, strides=2))
        self.features.add(_conv(32, 3))
        self.features.add(_conv(64, 3, padding=1))
        self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
        self.features.add(_conv(80, 1))
        self.features.add(_conv(192, 3))
        self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
        self.features.add(_make_A(32))
        self.features.add(_make_A(64))
        self.features.add(_make_A(64))
        self.features.add(_make_B())
        self.features.add(_make_C(128))
        self.features.add(_make_C(160))
        self.features.add(_make_C(160))
        self.features.add(_make_C(192))
        self.features.add(_make_D())
        self.features.add(_make_E())
        self.features.add(_make_E())
        self.features.add(nn.AvgPool2D(pool_size=8))
        self.features.add(nn.Dropout(0.5))
        self.output = nn.Dense(classes)

    def forward(self, x):
        x = self.features(x)
        return self.output(x.reshape(x.shape[0], -1))


def inception_v3(**kwargs):
    return build(Inception3, **kwargs)
