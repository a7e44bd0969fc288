"""ResNet v1/v2 (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/resnet.py``:1-287).

The reference's architecture and parameter names, unchanged: ``features``
(the stem, four stages of ``BasicBlock``/``Bottleneck`` units and the global
average pool) and ``output`` (a ``Dense``). As in the reference, most layers
are built without their input widths, so their parameters are placeholders
until the first forward (or a loaded file) gives their shapes; the
convolutions start from ``Xavier``. The layers are built on the current
context (``with mx.cpu():`` for the host), or on ``ctx`` where
:func:`get_resnet` is given one.
"""
from __future__ import annotations

import contextlib

from ....base import MXNetError
from ....ops import nn as F
from ...block import HybridBlock
from ... import nn

__all__ = ["ResNetV1", "ResNetV2", "BasicBlockV1", "BasicBlockV2",
           "BottleneckV1", "BottleneckV2", "resnet18_v1", "resnet34_v1",
           "resnet50_v1", "resnet101_v1", "resnet152_v1", "resnet18_v2",
           "resnet34_v2", "resnet50_v2", "resnet101_v2", "resnet152_v2",
           "get_resnet"]


def _conv3x3(channels, stride, in_channels):
    return nn.Conv2D(channels, kernel_size=3, strides=stride, padding=1,
                     use_bias=False, in_channels=in_channels)


class BasicBlockV1(HybridBlock):
    _tensor_body = True

    def __init__(self, channels, stride, downsample=False, in_channels=0):
        super().__init__()
        self.body = nn.HybridSequential()
        self.body.add(_conv3x3(channels, stride, in_channels))
        self.body.add(nn.BatchNorm())
        self.body.add(nn.Activation("relu"))
        self.body.add(_conv3x3(channels, 1, channels))
        self.body.add(nn.BatchNorm())
        if downsample:
            self.downsample = nn.HybridSequential()
            self.downsample.add(nn.Conv2D(channels, kernel_size=1,
                                          strides=stride, use_bias=False,
                                          in_channels=in_channels))
            self.downsample.add(nn.BatchNorm())
        else:
            self.downsample = None

    def forward(self, x):
        out = self.body(x)
        residual = x if self.downsample is None else self.downsample(x)
        return F.activation(out + residual, act_type="relu")


class BottleneckV1(HybridBlock):
    _tensor_body = True

    def __init__(self, channels, stride, downsample=False, in_channels=0):
        super().__init__()
        self.body = nn.HybridSequential()
        self.body.add(nn.Conv2D(channels // 4, kernel_size=1, strides=stride))
        self.body.add(nn.BatchNorm())
        self.body.add(nn.Activation("relu"))
        self.body.add(_conv3x3(channels // 4, 1, channels // 4))
        self.body.add(nn.BatchNorm())
        self.body.add(nn.Activation("relu"))
        self.body.add(nn.Conv2D(channels, kernel_size=1, strides=1))
        self.body.add(nn.BatchNorm())
        if downsample:
            self.downsample = nn.HybridSequential()
            self.downsample.add(nn.Conv2D(channels, kernel_size=1,
                                          strides=stride, use_bias=False,
                                          in_channels=in_channels))
            self.downsample.add(nn.BatchNorm())
        else:
            self.downsample = None

    forward = BasicBlockV1.forward


class BasicBlockV2(HybridBlock):
    _tensor_body = True

    def __init__(self, channels, stride, downsample=False, in_channels=0):
        super().__init__()
        self.bn1 = nn.BatchNorm()
        self.conv1 = _conv3x3(channels, stride, in_channels)
        self.bn2 = nn.BatchNorm()
        self.conv2 = _conv3x3(channels, 1, channels)
        if downsample:
            self.downsample = nn.Conv2D(channels, 1, stride, use_bias=False,
                                        in_channels=in_channels)
        else:
            self.downsample = None

    def forward(self, x):
        residual = x
        x = F.activation(self.bn1(x), act_type="relu")
        if self.downsample is not None:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = F.activation(self.bn2(x), act_type="relu")
        x = self.conv2(x)
        return x + residual


class BottleneckV2(HybridBlock):
    _tensor_body = True

    def __init__(self, channels, stride, downsample=False, in_channels=0):
        super().__init__()
        self.bn1 = nn.BatchNorm()
        self.conv1 = nn.Conv2D(channels // 4, 1, 1, use_bias=False)
        self.bn2 = nn.BatchNorm()
        self.conv2 = _conv3x3(channels // 4, stride, channels // 4)
        self.bn3 = nn.BatchNorm()
        self.conv3 = nn.Conv2D(channels, 1, 1, use_bias=False)
        if downsample:
            self.downsample = nn.Conv2D(channels, 1, stride, use_bias=False,
                                        in_channels=in_channels)
        else:
            self.downsample = None

    def forward(self, x):
        residual = x
        x = F.activation(self.bn1(x), act_type="relu")
        if self.downsample is not None:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = F.activation(self.bn2(x), act_type="relu")
        x = self.conv2(x)
        x = F.activation(self.bn3(x), act_type="relu")
        x = self.conv3(x)
        return x + residual


def _make_layer(block, layers, channels, stride, in_channels=0):
    layer = nn.HybridSequential()
    layer.add(block(channels, stride, channels != in_channels,
                    in_channels=in_channels))
    for _ in range(layers - 1):
        layer.add(block(channels, 1, False, in_channels=channels))
    return layer


class ResNetV1(HybridBlock):
    _tensor_body = True

    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False):
        super().__init__()
        if len(layers) != len(channels) - 1:
            raise MXNetError("ResNetV1 needs one more channel width than "
                             f"stages: {layers}, {channels}")
        self.features = nn.HybridSequential()
        if thumbnail:
            self.features.add(_conv3x3(channels[0], 1, 0))
        else:
            self.features.add(nn.Conv2D(channels[0], 7, 2, 3, use_bias=False))
            self.features.add(nn.BatchNorm())
            self.features.add(nn.Activation("relu"))
            self.features.add(nn.MaxPool2D(3, 2, 1))
        for i, num_layer in enumerate(layers):
            stride = 1 if i == 0 else 2
            self.features.add(_make_layer(block, num_layer, channels[i + 1],
                                          stride, in_channels=channels[i]))
        self.features.add(nn.GlobalAvgPool2D())
        self.output = nn.Dense(classes, in_units=channels[-1])

    def forward(self, x):
        return self.output(self.features(x))


class ResNetV2(HybridBlock):
    _tensor_body = True

    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False):
        super().__init__()
        if len(layers) != len(channels) - 1:
            raise MXNetError("ResNetV2 needs one more channel width than "
                             f"stages: {layers}, {channels}")
        self.features = nn.HybridSequential()
        self.features.add(nn.BatchNorm(scale=False, center=False))
        if thumbnail:
            self.features.add(_conv3x3(channels[0], 1, 0))
        else:
            self.features.add(nn.Conv2D(channels[0], 7, 2, 3, use_bias=False))
            self.features.add(nn.BatchNorm())
            self.features.add(nn.Activation("relu"))
            self.features.add(nn.MaxPool2D(3, 2, 1))
        in_channels = channels[0]
        for i, num_layer in enumerate(layers):
            stride = 1 if i == 0 else 2
            self.features.add(_make_layer(block, num_layer, channels[i + 1],
                                          stride, in_channels=in_channels))
            in_channels = channels[i + 1]
        self.features.add(nn.BatchNorm())
        self.features.add(nn.Activation("relu"))
        self.features.add(nn.GlobalAvgPool2D())
        self.features.add(nn.Flatten())
        self.output = nn.Dense(classes, in_units=in_channels)

    def forward(self, x):
        return self.output(self.features(x))


resnet_spec = {18: ("basic_block", [2, 2, 2, 2], [64, 64, 128, 256, 512]),
               34: ("basic_block", [3, 4, 6, 3], [64, 64, 128, 256, 512]),
               50: ("bottle_neck", [3, 4, 6, 3],
                    [64, 256, 512, 1024, 2048]),
               101: ("bottle_neck", [3, 4, 23, 3],
                     [64, 256, 512, 1024, 2048]),
               152: ("bottle_neck", [3, 8, 36, 3],
                     [64, 256, 512, 1024, 2048])}
resnet_net_versions = [ResNetV1, ResNetV2]
resnet_block_versions = [{"basic_block": BasicBlockV1,
                          "bottle_neck": BottleneckV1},
                         {"basic_block": BasicBlockV2,
                          "bottle_neck": BottleneckV2}]


def get_resnet(version, num_layers, pretrained=False, ctx=None, root=None,
               **kwargs):
    """ResNet ``version`` (1 or 2) of depth ``num_layers`` (18, 34, 50, 101
    or 152); ``kwargs`` go to ``ResNetV1``/``ResNetV2`` (``classes``,
    ``thumbnail``). ``pretrained`` raises: no weights are fetched."""
    if num_layers not in resnet_spec:
        raise MXNetError(f"invalid resnet depth {num_layers}")
    block_type, layers, channels = resnet_spec[num_layers]
    if version not in (1, 2):
        raise MXNetError("resnet version must be 1 or 2")
    if pretrained:
        raise MXNetError("no pretrained weights in the zero-egress build; "
                         "load_parameters() from a local file instead")
    resnet_class = resnet_net_versions[version - 1]
    block_class = resnet_block_versions[version - 1][block_type]
    with ctx if ctx is not None else contextlib.nullcontext():
        return resnet_class(block_class, layers, channels, **kwargs)


def resnet18_v1(**kwargs):
    return get_resnet(1, 18, **kwargs)


def resnet34_v1(**kwargs):
    return get_resnet(1, 34, **kwargs)


def resnet50_v1(**kwargs):
    return get_resnet(1, 50, **kwargs)


def resnet101_v1(**kwargs):
    return get_resnet(1, 101, **kwargs)


def resnet152_v1(**kwargs):
    return get_resnet(1, 152, **kwargs)


def resnet18_v2(**kwargs):
    return get_resnet(2, 18, **kwargs)


def resnet34_v2(**kwargs):
    return get_resnet(2, 34, **kwargs)


def resnet50_v2(**kwargs):
    return get_resnet(2, 50, **kwargs)


def resnet101_v2(**kwargs):
    return get_resnet(2, 101, **kwargs)


def resnet152_v2(**kwargs):
    return get_resnet(2, 152, **kwargs)
