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

``DeformableConvolution`` and ``ModulatedDeformableConvolution``
(reference :249-310) predict their offsets (and, v2, their sigmoid masks)
with an inner ``Conv2D`` named ``offset`` over the same input, then run the
``deformable_convolution`` / ``modulated_deformable_convolution`` op of
:mod:`mxnet_tpu_torch.ops.warp_ops` with ``weight`` and ``bias``.
``PixelShuffle1D/2D/3D`` (:313-357) fold channel blocks into space by a
reshape and a permutation.
"""
from __future__ import annotations

import math

import torch

from ...base import to_dtype
from ...context import resolve_device
from ...ops import nn as F
from ...ops.nn import _Door
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
                 output_padding=0, **kwargs):
        super().__init__(**kwargs)
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
                 layout, count_include_pad=True, ceil_mode=False, **kwargs):
        super().__init__(**kwargs)
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


_DEFORM = {False: _Door("deformable_convolution"),
           True: _Door("modulated_deformable_convolution")}


class DeformableConvolution(_Conv):
    """Deformable convolution v1 (reference :249): an inner regular
    convolution ``offset`` over the same input predicts the offsets, then
    the deformable convolution applies ``weight`` and ``bias`` at the
    offset taps."""

    _modulated = False

    def __init__(self, channels, kernel_size=(3, 3), strides=(1, 1),
                 padding=(0, 0), dilation=(1, 1), groups=1,
                 num_deformable_group=1, use_bias=True, in_channels=0,
                 activation=None, weight_initializer=None,
                 bias_initializer="zeros", offset_weight_initializer="zeros",
                 offset_bias_initializer="zeros", offset_use_bias=True,
                 dtype="float32", device=None, **kwargs):
        kernel_size = _tup(kernel_size, 2)
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, "NCHW", in_channels=in_channels,
                         activation=activation, use_bias=use_bias,
                         weight_initializer=weight_initializer,
                         bias_initializer=bias_initializer, dtype=dtype,
                         device=device, **kwargs)
        k = kernel_size[0] * kernel_size[1]
        per_pos = 3 if self._modulated else 2
        self._split = 2 * k * num_deformable_group   # offsets, then masks
        self._dg = num_deformable_group
        self.offset = Conv2D(per_pos * k * num_deformable_group,
                             kernel_size, strides, padding, dilation,
                             groups=1, in_channels=in_channels,
                             use_bias=offset_use_bias,
                             weight_initializer=offset_weight_initializer,
                             bias_initializer=offset_bias_initializer,
                             dtype=dtype, device=device)

    def forward(self, x):
        if self.weight.is_deferred:
            self.weight._finish_deferred_init(self._wshape(x.shape[1]))
        offs = self.offset(x)
        if self._modulated:
            args = [x, offs[:, :self._split],
                    torch.sigmoid(offs[:, self._split:])]
        else:
            args = [x, offs]
        args.append(self.weight)
        if self.bias is not None:
            args.append(self.bias)
        out = _DEFORM[self._modulated].fn(
            kernel=self._kernel, stride=self._stride, dilate=self._dilate,
            pad=self._pad, num_filter=self._channels, num_group=self._groups,
            num_deformable_group=self._dg, no_bias=self.bias is None)(*args)
        if self._activation is not None:
            out = F.activation(out, act_type=self._activation)
        return out


class ModulatedDeformableConvolution(DeformableConvolution):
    """Deformable convolution v2: the inner convolution also predicts a
    sigmoid mask a tap."""

    _modulated = True


class _PixelShuffle(HybridBlock):
    _tensor_body = True

    def __init__(self, factor, ndim, **kwargs):
        super().__init__(**kwargs)
        self._f = _tup(factor, ndim)
        self._ndim = ndim

    def forward(self, x):
        f, n = self._f, self._ndim
        b, c = x.shape[0], x.shape[1]
        spatial = tuple(x.shape[2:])
        cf = math.prod(f)
        # (B, C prod(f), *S) -> (B, C, *f, *S) -> (B, C, S1, f1, S2, f2, ..)
        out = x.reshape((b, c // cf) + f + spatial)
        perm = [0, 1]
        for i in range(n):
            perm += [2 + n + i, 2 + i]
        out = out.permute(perm)
        return out.reshape((b, c // cf) +
                           tuple(s * fi for s, fi in zip(spatial, f)))


class PixelShuffle1D(_PixelShuffle):
    """(B, C f, W) -> (B, C, W f)."""

    def __init__(self, factor, **kwargs):
        super().__init__(factor, 1, **kwargs)


class PixelShuffle2D(_PixelShuffle):
    """(B, C f1 f2, H, W) -> (B, C, H f1, W f2)."""

    def __init__(self, factor, **kwargs):
        super().__init__(factor, 2, **kwargs)


class PixelShuffle3D(_PixelShuffle):
    """(B, C f1 f2 f3, D, H, W) -> (B, C, D f1, H f2, W f3)."""

    def __init__(self, factor, **kwargs):
        super().__init__(factor, 3, **kwargs)
