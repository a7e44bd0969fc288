"""Convolution and pooling layers.

Counterpart of ``mxnet_tpu/gluon/nn/conv_layers.py`` (:23-247): ``Conv1D``,
``Conv2D``, ``Conv3D`` (``_Conv``, with ``activation``), ``MaxPool1D/2D/3D``,
``AvgPool1D/2D/3D`` and the six global pools, over the ``convolution`` and
``pooling`` ops of :mod:`mxnet_tpu_torch.ops.nn` (torch's, cuDNN on the
card). A convolution's weight is (channels, in_channels / groups, *kernel)
in every layout and starts from ``Xavier`` unless given another
initializer; without ``in_channels`` its shape waits for the first forward
(the reference's ``_infer``, :57-69).

``Conv1DTranspose``, ``Conv2DTranspose`` and ``Conv3DTranspose`` (reference
:117-143) run the ``deconvolution`` op (torch's transposed convolution);
their weight is (in_channels, channels / groups, *kernel), and
``output_padding`` is the reference's ``adj``.

Not ported (they raise naming ROADMAP A9, which holds the deformable ops
they need): the deformable convolutions and ``PixelShuffle1D/2D/3D``.
"""
from __future__ import annotations

from ...base import MXNetError, to_dtype
from ...context import resolve_device
from ...ops import nn as F
from ..block import HybridBlock, new_parameter

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose", "Conv2DTranspose",
           "Conv3DTranspose", "MaxPool1D", "MaxPool2D", "MaxPool3D",
           "AvgPool1D", "AvgPool2D", "AvgPool3D", "GlobalMaxPool1D",
           "GlobalMaxPool2D", "GlobalMaxPool3D", "GlobalAvgPool1D",
           "GlobalAvgPool2D", "GlobalAvgPool3D", "DeformableConvolution",
           "ModulatedDeformableConvolution", "PixelShuffle1D",
           "PixelShuffle2D", "PixelShuffle3D"]


def _tup(x, n):
    if isinstance(x, (list, tuple)):
        return tuple(x)
    return (x,) * n


class _Conv(HybridBlock):
    _tensor_body = True

    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 dtype="float32", device=None, transpose=False,
                 output_padding=0):
        super().__init__()
        ndim = len(kernel_size)
        device = resolve_device(device)
        dtype = to_dtype(dtype)
        self._channels = channels
        self._kernel = kernel_size
        self._stride = _tup(strides, ndim)
        self._pad = _tup(padding, ndim)
        self._dilate = _tup(dilation, ndim)
        self._groups = groups
        self._layout = layout
        self._activation = activation
        self._transpose = transpose
        self._adj = _tup(output_padding, ndim)
        wshape = self._wshape(in_channels) if in_channels else \
            ((0, channels // groups) if transpose else (channels, 0)) + \
            kernel_size
        self.weight = new_parameter(wshape, dtype, device,
                                    weight_initializer or "xavier")
        self.bias = new_parameter((channels,), dtype, device,
                                  bias_initializer) if use_bias else None

    def _wshape(self, in_c):
        if self._transpose:
            return (in_c, self._channels // self._groups) + self._kernel
        return (self._channels, in_c // self._groups) + self._kernel

    def forward(self, x):
        if self.weight.is_deferred:
            self.weight._finish_deferred_init(
                self._wshape(x.shape[self._layout.index("C")]))
        if self._transpose:
            out = F.deconvolution(
                x, self.weight, self.bias, kernel=self._kernel,
                stride=self._stride, dilate=self._dilate, pad=self._pad,
                adj=self._adj, num_filter=self._channels,
                num_group=self._groups, layout=self._layout)
        else:
            out = F.convolution(
                x, self.weight, self.bias, kernel=self._kernel,
                stride=self._stride, dilate=self._dilate, pad=self._pad,
                num_filter=self._channels, num_group=self._groups,
                layout=self._layout)
        if self._activation is not None:
            out = F.activation(out, act_type=self._activation)
        return out


class Conv1D(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, layout="NCW", **kwargs):
        super().__init__(channels, _tup(kernel_size, 1), strides, padding,
                         dilation, groups, layout, **kwargs)


class Conv2D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", **kwargs):
        super().__init__(channels, _tup(kernel_size, 2), strides, padding,
                         dilation, groups, layout, **kwargs)


class Conv3D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), dilation=(1, 1, 1), groups=1,
                 layout="NCDHW", **kwargs):
        super().__init__(channels, _tup(kernel_size, 3), strides, padding,
                         dilation, groups, layout, **kwargs)


class Conv1DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 output_padding=0, dilation=1, groups=1, layout="NCW",
                 **kwargs):
        super().__init__(channels, _tup(kernel_size, 1), strides, padding,
                         dilation, groups, layout, transpose=True,
                         output_padding=output_padding, **kwargs)


class Conv2DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 output_padding=(0, 0), dilation=(1, 1), groups=1,
                 layout="NCHW", **kwargs):
        super().__init__(channels, _tup(kernel_size, 2), strides, padding,
                         dilation, groups, layout, transpose=True,
                         output_padding=output_padding, **kwargs)


class Conv3DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), output_padding=(0, 0, 0),
                 dilation=(1, 1, 1), groups=1, layout="NCDHW", **kwargs):
        super().__init__(channels, _tup(kernel_size, 3), strides, padding,
                         dilation, groups, layout, transpose=True,
                         output_padding=output_padding, **kwargs)


class _Pool(HybridBlock):
    _tensor_body = True

    def __init__(self, pool_size, strides, padding, global_pool, pool_type,
                 layout, count_include_pad=True, ceil_mode=False):
        super().__init__()
        self._kernel = pool_size
        self._stride = _tup(strides if strides is not None else pool_size,
                            len(pool_size))
        self._pad = _tup(padding, len(pool_size))
        self._global = global_pool
        self._type = pool_type
        self._layout = layout
        self._cip = count_include_pad
        self._ceil = ceil_mode

    def forward(self, x):
        return F.pooling(x, kernel=self._kernel, pool_type=self._type,
                         stride=self._stride, pad=self._pad,
                         global_pool=self._global,
                         count_include_pad=self._cip, layout=self._layout,
                         ceil_mode=self._ceil)


class MaxPool1D(_Pool):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 **kwargs):
        super().__init__(_tup(pool_size, 1), strides, padding, False, "max",
                         layout, **kwargs)


class MaxPool2D(_Pool):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", **kwargs):
        super().__init__(_tup(pool_size, 2), strides, padding, False, "max",
                         layout, **kwargs)


class MaxPool3D(_Pool):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", **kwargs):
        super().__init__(_tup(pool_size, 3), strides, padding, False, "max",
                         layout, **kwargs)


class AvgPool1D(_Pool):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 count_include_pad=True, **kwargs):
        super().__init__(_tup(pool_size, 1), strides, padding, False, "avg",
                         layout, count_include_pad, **kwargs)


class AvgPool2D(_Pool):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", count_include_pad=True, **kwargs):
        super().__init__(_tup(pool_size, 2), strides, padding, False, "avg",
                         layout, count_include_pad, **kwargs)


class AvgPool3D(_Pool):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", count_include_pad=True, **kwargs):
        super().__init__(_tup(pool_size, 3), strides, padding, False, "avg",
                         layout, count_include_pad, **kwargs)


class _GlobalPool(_Pool):
    def __init__(self, ndim, pool_type, layout, **kwargs):
        super().__init__((1,) * ndim, None, 0, True, pool_type, layout,
                         **kwargs)


class GlobalMaxPool1D(_GlobalPool):
    def __init__(self, layout="NCW", **kwargs):
        super().__init__(1, "max", layout, **kwargs)


class GlobalMaxPool2D(_GlobalPool):
    def __init__(self, layout="NCHW", **kwargs):
        super().__init__(2, "max", layout, **kwargs)


class GlobalMaxPool3D(_GlobalPool):
    def __init__(self, layout="NCDHW", **kwargs):
        super().__init__(3, "max", layout, **kwargs)


class GlobalAvgPool1D(_GlobalPool):
    def __init__(self, layout="NCW", **kwargs):
        super().__init__(1, "avg", layout, **kwargs)


class GlobalAvgPool2D(_GlobalPool):
    def __init__(self, layout="NCHW", **kwargs):
        super().__init__(2, "avg", layout, **kwargs)


class GlobalAvgPool3D(_GlobalPool):
    def __init__(self, layout="NCDHW", **kwargs):
        super().__init__(3, "avg", layout, **kwargs)


def _not_ported(name):
    class _Layer(HybridBlock):
        def __init__(self, *args, **kwargs):
            raise MXNetError(f"nn.{name} is not ported (ROADMAP A9)")

    _Layer.__name__ = _Layer.__qualname__ = name
    return _Layer


DeformableConvolution = _not_ported("DeformableConvolution")
ModulatedDeformableConvolution = _not_ported(
    "ModulatedDeformableConvolution")
PixelShuffle1D = _not_ported("PixelShuffle1D")
PixelShuffle2D = _not_ported("PixelShuffle2D")
PixelShuffle3D = _not_ported("PixelShuffle3D")
