"""Core layers as ``torch.nn.Module``s (the subset the GPT family uses).

Counterpart of ``mxnet_tpu/gluon/nn/basic_layers.py``: ``Dense`` (:61),
``LayerNorm`` (:281), ``Embedding`` (:365) and ``HybridSequential`` (:56).
Parameter names and layouts are the reference's: ``Dense.weight`` is
(units, in_units), ``LayerNorm`` keeps ``gamma``/``beta``. Shapes are given
at construction: the reference's deferred shape inference is not ported.
"""
from __future__ import annotations

from ...base import MXNetError, to_dtype
from ...context import resolve_device
from ...ops import nn as F
from ..block import HybridBlock, new_parameter

__all__ = ["HybridSequential", "Dense", "LayerNorm", "Embedding"]


class HybridSequential(HybridBlock):
    """Children named ``"0"``, ``"1"``, ... in the order added."""

    def add(self, *blocks):
        for b in blocks:
            self.add_module(str(len(self._modules)), b)
        return self

    def forward(self, x, *args):
        for block in self._modules.values():
            x = block(x)
        return x

    def __len__(self):
        return len(self._modules)

    def __getitem__(self, i):
        return list(self._modules.values())[i]

    def __iter__(self):
        return iter(self._modules.values())


class Dense(HybridBlock):
    """Fully connected layer: y = x W^T + b, W of shape (units, in_units)."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0, device=None):
        super().__init__()
        if not in_units:
            raise MXNetError(
                "Dense needs in_units: deferred shape inference is not "
                "ported")
        if activation is not None:
            raise MXNetError("Dense(activation=...) is not ported")
        device = resolve_device(device)
        dtype = to_dtype(dtype)
        self._units = units
        self._flatten = flatten
        self.weight = new_parameter((units, in_units), dtype, device,
                                    weight_initializer)
        self.bias = new_parameter((units,), dtype, device,
                                  bias_initializer) if use_bias else None

    def forward(self, x):
        return F.fully_connected(x, self.weight, self.bias,
                                 flatten=self._flatten)


class LayerNorm(HybridBlock):
    """LayerNorm over ``axis`` with ``gamma``/``beta`` parameters."""

    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, dtype="float32", device=None):
        super().__init__()
        if not in_channels:
            raise MXNetError(
                "LayerNorm needs in_channels: deferred shape inference is "
                "not ported")
        device = resolve_device(device)
        dtype = to_dtype(dtype)
        self._axis = axis
        self._eps = epsilon
        self.gamma = new_parameter((in_channels,), dtype, device,
                                   gamma_initializer,
                                   "write" if scale else "null")
        self.beta = new_parameter((in_channels,), dtype, device,
                                  beta_initializer,
                                  "write" if center else "null")

    def forward(self, x):
        return F.layer_norm(x, self.gamma, self.beta, axis=self._axis,
                            eps=self._eps)


class Embedding(HybridBlock):
    """Lookup table of shape (input_dim, output_dim)."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, device=None):
        super().__init__()
        device = resolve_device(device)
        self._input_dim = input_dim
        self._output_dim = output_dim
        self.weight = new_parameter((input_dim, output_dim), to_dtype(dtype),
                                    device, weight_initializer)

    def forward(self, x):
        return F.embedding(x, self.weight)
