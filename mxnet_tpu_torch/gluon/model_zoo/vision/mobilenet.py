"""MobileNet v1 and v2 with their width multipliers (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/mobilenet.py``). A depthwise
convolution is a grouped ``Conv2D`` with one group a channel (cuDNN's
grouped convolution on the card)."""
from __future__ import annotations

from ... import nn
from ...block import HybridBlock
from ._utils import build

__all__ = ["MobileNet", "MobileNetV2", "mobilenet1_0", "mobilenet0_75",
           "mobilenet0_5", "mobilenet0_25", "mobilenet_v2_1_0",
           "mobilenet_v2_0_5"]


def _conv_block(channels, kernel=3, stride=1, pad=1, num_group=1,
                active=True):
    out = nn.HybridSequential()
    out.add(nn.Conv2D(channels, kernel, stride, pad, groups=num_group,
                      use_bias=False))
    out.add(nn.BatchNorm())
    if active:
        out.add(nn.Activation("relu"))
    return out


def _dw_block(dw_channels, channels, stride):
    """Depthwise separable: a depthwise, then a pointwise convolution."""
    out = nn.HybridSequential()
    out.add(_conv_block(dw_channels, stride=stride, num_group=dw_channels))
    out.add(_conv_block(channels, kernel=1, pad=0))
    return out


class MobileNet(HybridBlock):
    _tensor_body = True

    def __init__(self, multiplier=1.0, classes=1000):
        super().__init__()
        m = multiplier
        self.features = nn.HybridSequential()
        self.features.add(_conv_block(int(32 * m), stride=2))
        dw_channels = [int(x * m) for x in
                       [32, 64] + [128] * 2 + [256] * 2 + [512] * 6 + [1024]]
        channels = [int(x * m) for x in
                    [64] + [128] * 2 + [256] * 2 + [512] * 6 + [1024] * 2]
        strides = [1, 2, 1, 2, 1, 2, 1, 1, 1, 1, 1, 2, 1]
        for dwc, c, s in zip(dw_channels, channels, strides):
            self.features.add(_dw_block(dwc, c, s))
        self.features.add(nn.GlobalAvgPool2D())
        self.features.add(nn.Flatten())
        self.output = nn.Dense(classes)

    def forward(self, x):
        return self.output(self.features(x))


class _LinearBottleneck(HybridBlock):
    _tensor_body = True

    def __init__(self, in_channels, channels, t, stride):
        super().__init__()
        self.use_shortcut = stride == 1 and in_channels == channels
        self.out = nn.HybridSequential()
        if t != 1:
            self.out.add(_conv_block(in_channels * t, kernel=1, pad=0))
        self.out.add(_conv_block(in_channels * t, stride=stride,
                                 num_group=in_channels * t))
        self.out.add(_conv_block(channels, kernel=1, pad=0, active=False))

    def forward(self, x):
        out = self.out(x)
        if self.use_shortcut:
            out = out + x
        return out


class MobileNetV2(HybridBlock):
    _tensor_body = True

    def __init__(self, multiplier=1.0, classes=1000):
        super().__init__()
        m = multiplier
        self.features = nn.HybridSequential()
        self.features.add(_conv_block(int(32 * m), stride=2))
        in_c = [int(x * m) for x in
                [32] + [16] + [24] * 2 + [32] * 3 + [64] * 4 + [96] * 3 +
                [160] * 3]
        channels = [int(x * m) for x in
                    [16] + [24] * 2 + [32] * 3 + [64] * 4 + [96] * 3 +
                    [160] * 3 + [320]]
        ts = [1] + [6] * 16
        strides = [1, 2, 1, 2, 1, 1, 2, 1, 1, 1, 1, 1, 1, 2, 1, 1, 1]
        for ic, c, t, s in zip(in_c, channels, ts, strides):
            self.features.add(_LinearBottleneck(ic, c, t, s))
        last = int(1280 * m) if m > 1.0 else 1280
        self.features.add(_conv_block(last, kernel=1, pad=0))
        self.features.add(nn.GlobalAvgPool2D())
        self.output = nn.Conv2D(classes, 1, use_bias=False)

    def forward(self, x):
        x = self.output(self.features(x))
        return x.reshape(x.shape[0], -1)


def mobilenet1_0(**kwargs):
    return build(MobileNet, 1.0, **kwargs)


def mobilenet0_75(**kwargs):
    return build(MobileNet, 0.75, **kwargs)


def mobilenet0_5(**kwargs):
    return build(MobileNet, 0.5, **kwargs)


def mobilenet0_25(**kwargs):
    return build(MobileNet, 0.25, **kwargs)


def mobilenet_v2_1_0(**kwargs):
    return build(MobileNetV2, 1.0, **kwargs)


def mobilenet_v2_0_5(**kwargs):
    return build(MobileNetV2, 0.5, **kwargs)
