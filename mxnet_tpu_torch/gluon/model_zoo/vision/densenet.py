"""DenseNet 121/161/169/201 (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/densenet.py``)."""
from __future__ import annotations

import torch

from ... import nn
from ...block import HybridBlock
from ._utils import build

__all__ = ["DenseNet", "densenet121", "densenet161", "densenet169",
           "densenet201"]


def _make_dense_layer(growth_rate, bn_size, dropout):
    layer = nn.HybridSequential()
    layer.add(nn.BatchNorm())
    layer.add(nn.Activation("relu"))
    layer.add(nn.Conv2D(bn_size * growth_rate, kernel_size=1, use_bias=False))
    layer.add(nn.BatchNorm())
    layer.add(nn.Activation("relu"))
    layer.add(nn.Conv2D(growth_rate, kernel_size=3, padding=1,
                        use_bias=False))
    if dropout:
        layer.add(nn.Dropout(dropout))
    return layer


class _DenseBlock(HybridBlock):
    _tensor_body = True

    def __init__(self, num_layers, bn_size, growth_rate, dropout):
        super().__init__()
        self.net = nn.HybridSequential()
        for _ in range(num_layers):
            self.net.add(_make_dense_layer(growth_rate, bn_size, dropout))

    def forward(self, x):
        for layer in self.net:
            x = torch.cat([x, layer(x)], 1)
        return x


def _make_transition(num_output_features):
    out = nn.HybridSequential()
    out.add(nn.BatchNorm())
    out.add(nn.Activation("relu"))
    out.add(nn.Conv2D(num_output_features, kernel_size=1, use_bias=False))
    out.add(nn.AvgPool2D(pool_size=2, strides=2))
    return out


class DenseNet(HybridBlock):
    _tensor_body = True

    def __init__(self, num_init_features, growth_rate, block_config,
                 bn_size=4, dropout=0, classes=1000):
        super().__init__()
        self.features = nn.HybridSequential()
        self.features.add(nn.Conv2D(num_init_features, kernel_size=7,
                                    strides=2, padding=3, use_bias=False))
        self.features.add(nn.BatchNorm())
        self.features.add(nn.Activation("relu"))
        self.features.add(nn.MaxPool2D(pool_size=3, strides=2, padding=1))
        num_features = num_init_features
        for i, num_layers in enumerate(block_config):
            self.features.add(_DenseBlock(num_layers, bn_size, growth_rate,
                                          dropout))
            num_features += num_layers * growth_rate
            if i != len(block_config) - 1:
                num_features //= 2
                self.features.add(_make_transition(num_features))
        self.features.add(nn.BatchNorm())
        self.features.add(nn.Activation("relu"))
        self.features.add(nn.GlobalAvgPool2D())
        self.features.add(nn.Flatten())
        self.output = nn.Dense(classes, in_units=num_features)

    def forward(self, x):
        return self.output(self.features(x))


densenet_spec = {121: (64, 32, [6, 12, 24, 16]),
                 161: (96, 48, [6, 12, 36, 24]),
                 169: (64, 32, [6, 12, 32, 32]),
                 201: (64, 32, [6, 12, 48, 32])}


def _densenet(num_layers, **kwargs):
    init_f, growth, config = densenet_spec[num_layers]
    return build(DenseNet, init_f, growth, config, **kwargs)


def densenet121(**kwargs):
    return _densenet(121, **kwargs)


def densenet161(**kwargs):
    return _densenet(161, **kwargs)


def densenet169(**kwargs):
    return _densenet(169, **kwargs)


def densenet201(**kwargs):
    return _densenet(201, **kwargs)
