"""VGG (counterpart of ``mxnet_tpu/gluon/model_zoo/vision/vgg.py``), with
its ``batch_norm`` option."""
from __future__ import annotations

from ... import nn
from ...block import HybridBlock
from ._utils import build

__all__ = ["VGG", "vgg11", "vgg13", "vgg16", "vgg19"]

vgg_spec = {11: ([1, 1, 2, 2, 2], [64, 128, 256, 512, 512]),
            13: ([2, 2, 2, 2, 2], [64, 128, 256, 512, 512]),
            16: ([2, 2, 3, 3, 3], [64, 128, 256, 512, 512]),
            19: ([2, 2, 4, 4, 4], [64, 128, 256, 512, 512])}


class VGG(HybridBlock):
    _tensor_body = True

    def __init__(self, layers, filters, classes=1000, batch_norm=False):
        super().__init__()
        self.features = nn.HybridSequential()
        for i, num in enumerate(layers):
            for _ in range(num):
                self.features.add(nn.Conv2D(filters[i], kernel_size=3,
                                            padding=1))
                if batch_norm:
                    self.features.add(nn.BatchNorm())
                self.features.add(nn.Activation("relu"))
            self.features.add(nn.MaxPool2D(2, 2))
        self.features.add(nn.Flatten())
        self.features.add(nn.Dense(4096, activation="relu"))
        self.features.add(nn.Dropout(0.5))
        self.features.add(nn.Dense(4096, activation="relu"))
        self.features.add(nn.Dropout(0.5))
        self.output = nn.Dense(classes)

    def forward(self, x):
        return self.output(self.features(x))


def _vgg(num_layers, **kwargs):
    layers, filters = vgg_spec[num_layers]
    return build(VGG, layers, filters, **kwargs)


def vgg11(**kwargs):
    return _vgg(11, **kwargs)


def vgg13(**kwargs):
    return _vgg(13, **kwargs)


def vgg16(**kwargs):
    return _vgg(16, **kwargs)


def vgg19(**kwargs):
    return _vgg(19, **kwargs)
