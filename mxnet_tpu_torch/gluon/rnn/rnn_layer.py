"""Fused multi-layer ``RNN``, ``LSTM`` and ``GRU`` layers.

Counterpart of ``mxnet_tpu/gluon/rnn/rnn_layer.py:19-143``: one ``rnn`` op
a forward (:mod:`mxnet_tpu_torch.ops.rnn`), the whole stack of layers and
directions in it. Parameters keep the reference's names and shapes,
``l{layer}[_r]_{i2h,h2h}_{weight,bias}`` with (gates * hidden, in) weights,
so ``.params`` files load across the packages; layer 0's ``i2h_weight``
without ``input_size`` is a placeholder that the first forward fills (before
any capture, as every deferred layer's).

``forward(x, states=None)``: ``x`` is (T, N, C) in ``layout="TNC"`` or (N,
T, C) in ``"NTC"``; without ``states`` it starts from zeros and returns the
output only, with ``states`` (a list: ``[h]``, or ``[h, c]`` for LSTM, each
(layers * directions, N, hidden)) it returns ``(output, new_states)``.
``begin_state`` makes the zeros on the layer's device, as NDArrays (or
through ``func(shape, **kwargs)``). A state on another device than the
input raises. ``dropout`` is kept and passed to the op, which ignores it,
as the reference's does.
"""
from __future__ import annotations

import torch

from ...base import MXNetError, to_dtype
from ...context import resolve_device
from ...ndarray.ndarray import NDArray
from ...ops.nn import _Door
from ...ops.rnn import GATES
from ..block import HybridBlock, new_parameter

__all__ = ["RNN", "LSTM", "GRU"]

_RNN = _Door("rnn")


class _RNNLayer(HybridBlock):
    _tensor_body = True

    def __init__(self, mode, hidden_size, num_layers, layout, dropout,
                 bidirectional, input_size=0, dtype="float32",
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 device=None, **kwargs):
        super().__init__(**kwargs)
        if layout not in ("TNC", "NTC"):
            raise MXNetError(f"invalid layout {layout}")
        device = resolve_device(device)
        dtype = to_dtype(dtype)
        self._mode = mode
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._gates = GATES[mode]
        ng, nh = self._gates, hidden_size
        for layer in range(num_layers):
            for d in range(self._dir):
                suffix = f"l{layer}" + ("_r" if d else "")
                in_sz = input_size if layer == 0 else nh * self._dir
                setattr(self, f"{suffix}_i2h_weight", new_parameter(
                    (ng * nh, in_sz), dtype, device, i2h_weight_initializer))
                setattr(self, f"{suffix}_h2h_weight", new_parameter(
                    (ng * nh, nh), dtype, device, h2h_weight_initializer))
                setattr(self, f"{suffix}_i2h_bias", new_parameter(
                    (ng * nh,), dtype, device, i2h_bias_initializer))
                setattr(self, f"{suffix}_h2h_bias", new_parameter(
                    (ng * nh,), dtype, device, h2h_bias_initializer))

    def _weight_params(self):
        out = []
        for layer in range(self._num_layers):
            for d in range(self._dir):
                suffix = f"l{layer}" + ("_r" if d else "")
                out.extend(getattr(self, f"{suffix}_{name}") for name in
                           ("i2h_weight", "h2h_weight", "i2h_bias",
                            "h2h_bias"))
        return out

    def _infer(self, x):
        for d in range(self._dir):
            w = getattr(self, "l0" + ("_r" if d else "") + "_i2h_weight")
            if w.is_deferred:
                w._finish_deferred_init((w.shape[0], x.shape[-1]))

    def state_info(self, batch_size=0):
        n = self._num_layers * self._dir
        shape = (n, batch_size, self._hidden_size)
        if self._mode == "lstm":
            return [{"shape": shape}, {"shape": shape}]
        return [{"shape": shape}]

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """Zero states for ``batch_size`` rows on the layer's device (as
        NDArrays), or ``func(shape, **kwargs)`` each."""
        w = self.l0_h2h_weight
        return [NDArray(torch.zeros(info["shape"], dtype=w.dtype,
                                    device=w.device)) if func is None
                else func(info["shape"], **kwargs)
                for info in self.state_info(batch_size)]

    def forward(self, x, states=None):
        self._infer(x)
        explicit_states = states is not None
        x_t = x.transpose(0, 1) if self._layout == "NTC" else x
        if states is None:
            w = self.l0_h2h_weight
            states = [torch.zeros(info["shape"], dtype=w.dtype,
                                  device=x.device)
                      for info in self.state_info(x_t.shape[1])]
        if not isinstance(states, (list, tuple)):
            states = [states]
        args = [x_t, states[0]] + \
            ([states[1]] if self._mode == "lstm" else []) + \
            self._weight_params()
        out = _RNN.fn(mode=self._mode, num_layers=self._num_layers,
                      hidden_size=self._hidden_size,
                      bidirectional=self._dir == 2,
                      dropout=self._dropout)(*args)
        ys, new_states = out[0], list(out[1:])
        if self._layout == "NTC":
            ys = ys.transpose(0, 1)
        if explicit_states:
            return ys, new_states
        return ys

    def __repr__(self):
        return (f"{type(self).__name__}({self._hidden_size}, "
                f"layers={self._num_layers}, layout={self._layout})")


class RNN(_RNNLayer):
    """Elman RNN layers with ``activation`` ``"relu"`` or ``"tanh"``."""

    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False, **kwargs):
        super().__init__(f"rnn_{activation}", hidden_size, num_layers, layout,
                         dropout, bidirectional, **kwargs)


class LSTM(_RNNLayer):
    """LSTM layers (gates i, f, g, o)."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, **kwargs):
        super().__init__("lstm", hidden_size, num_layers, layout, dropout,
                         bidirectional, **kwargs)


class GRU(_RNNLayer):
    """GRU layers (gates r, z, n; cuDNN's reset of the hidden product)."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, **kwargs):
        super().__init__("gru", hidden_size, num_layers, layout, dropout,
                         bidirectional, **kwargs)
