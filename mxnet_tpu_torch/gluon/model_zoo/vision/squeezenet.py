"""SqueezeNet 1.0 and 1.1 (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/squeezenet.py``); its pools round their
output size up (``ceil_mode=True``)."""
from __future__ import annotations

import torch

from ... import nn
from ...block import HybridBlock
from ._utils import build

__all__ = ["SqueezeNet", "squeezenet1_0", "squeezenet1_1"]


class _Fire(HybridBlock):
    _tensor_body = True

    def __init__(self, squeeze, expand1x1, expand3x3):
        super().__init__()
        self.squeeze = nn.Conv2D(squeeze, kernel_size=1, activation="relu")
        self.expand1 = nn.Conv2D(expand1x1, kernel_size=1, activation="relu")
        self.expand3 = nn.Conv2D(expand3x3, kernel_size=3, padding=1,
                                 activation="relu")

    def forward(self, x):
        x = self.squeeze(x)
        return torch.cat([self.expand1(x), self.expand3(x)], 1)


class SqueezeNet(HybridBlock):
    _tensor_body = True

    def __init__(self, version="1.0", classes=1000):
        super().__init__()
        self.features = nn.HybridSequential()
        if version == "1.0":
            self.features.add(nn.Conv2D(96, 7, 2, activation="relu"))
            self.features.add(nn.MaxPool2D(3, 2, ceil_mode=True))
            self.features.add(_Fire(16, 64, 64))
            self.features.add(_Fire(16, 64, 64))
            self.features.add(_Fire(32, 128, 128))
            self.features.add(nn.MaxPool2D(3, 2, ceil_mode=True))
            self.features.add(_Fire(32, 128, 128))
            self.features.add(_Fire(48, 192, 192))
            self.features.add(_Fire(48, 192, 192))
            self.features.add(_Fire(64, 256, 256))
            self.features.add(nn.MaxPool2D(3, 2, ceil_mode=True))
            self.features.add(_Fire(64, 256, 256))
        else:
            self.features.add(nn.Conv2D(64, 3, 2, activation="relu"))
            self.features.add(nn.MaxPool2D(3, 2, ceil_mode=True))
            self.features.add(_Fire(16, 64, 64))
            self.features.add(_Fire(16, 64, 64))
            self.features.add(nn.MaxPool2D(3, 2, ceil_mode=True))
            self.features.add(_Fire(32, 128, 128))
            self.features.add(_Fire(32, 128, 128))
            self.features.add(nn.MaxPool2D(3, 2, ceil_mode=True))
            self.features.add(_Fire(48, 192, 192))
            self.features.add(_Fire(48, 192, 192))
            self.features.add(_Fire(64, 256, 256))
            self.features.add(_Fire(64, 256, 256))
        self.features.add(nn.Dropout(0.5))
        self.output = nn.HybridSequential()
        self.output.add(nn.Conv2D(classes, kernel_size=1, activation="relu"))
        self.output.add(nn.GlobalAvgPool2D())
        self.output.add(nn.Flatten())

    def forward(self, x):
        return self.output(self.features(x))


def squeezenet1_0(**kwargs):
    return build(SqueezeNet, "1.0", **kwargs)


def squeezenet1_1(**kwargs):
    return build(SqueezeNet, "1.1", **kwargs)
