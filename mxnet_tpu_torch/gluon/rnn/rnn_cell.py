"""Recurrent cells: one time step a call, and ``unroll`` over a sequence.

Counterpart of ``mxnet_tpu/gluon/rnn/rnn_cell.py:20-368``: ``RNNCell``,
``LSTMCell`` (gates i, f, g, o), ``GRUCell`` (r, z, n with the reset gate on
the hidden product and its bias, as the ``rnn`` op), ``LSTMPCell`` (a
projected recurrent state), the containers ``SequentialRNNCell`` (and its
other name ``HybridSequentialRNNCell``) and ``BidirectionalCell``, and the
modifiers ``DropoutCell``, ``ZoneoutCell``, ``ResidualCell`` and
``VariationalDropoutCell``. Parameter names are the reference's
(``i2h_weight``, ``h2h_weight``, ``i2h_bias``, ``h2h_bias``,
``h2r_weight``); ``i2h_weight`` without ``input_size`` waits for the first
step's input.

A cell is ``cell(x, states) -> (output, new_states)``, torch code over the
``ops.nn`` doors (NDArrays in, NDArrays out). ``unroll(length, inputs,
begin_state=None, layout="NTC", merge_outputs=None, valid_length=None)``
steps the cell ``length`` times (a hybridized cell replays one CUDA graph a
step on the card), stacks the outputs along the time axis unless
``merge_outputs`` is False, and zeroes the steps at and past each row's
``valid_length`` (the states are the last step's, as the reference's).
``BidirectionalCell`` runs its right cell over the whole padded sequence
flipped, not each row to its length, as the reference does.

Dropout in the cells is active while ``autograd.is_training()``, as the
reference's. ``VariationalDropoutCell`` keeps one mask a sequence in Python
attributes (``reset()``, which every ``unroll`` calls, clears them); a CUDA
graph would freeze them across replays, so a hybridized cell holding one
runs its steps eagerly, as the reference's runs a cell called with a list
of states, and a step captured inside another block's program raises.
"""
from __future__ import annotations

import torch

from ... import autograd as _ag
from ... import cached_op as _cached_op
from ...base import MXNetError, to_dtype
from ...context import current_context, resolve_device
from ...ndarray.ndarray import NDArray, unwrap, wrap
from ...ops import nn as F
from ...ops.nn import _Door
from ..block import HybridBlock, new_parameter

__all__ = ["RecurrentCell", "RNNCell", "LSTMCell", "GRUCell",
           "SequentialRNNCell", "HybridSequentialRNNCell", "DropoutCell",
           "ZoneoutCell", "ResidualCell", "BidirectionalCell",
           "VariationalDropoutCell", "LSTMPCell"]

_SEQ_MASK = _Door("sequence_mask")


def _holds_nd(*values):
    return any(isinstance(v, NDArray) for v in values) or any(
        isinstance(s, NDArray) for v in values if isinstance(v, (list, tuple))
        for s in v)


class RecurrentCell(HybridBlock):
    """Base of the cells: ``state_info``, ``begin_state``, ``reset`` and
    ``unroll``."""

    _tensor_body = True
    # True where a cell keeps per-sequence state in Python attributes
    _per_sequence_masks = False

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def _device_dtype(self):
        for p in self.parameters():
            return p.device, p.dtype
        return current_context().torch_device, torch.float32

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """Zero states for ``batch_size`` rows on the cell's device (as
        NDArrays), or ``func(shape, **kwargs)`` each."""
        device, dtype = self._device_dtype()
        return [NDArray(torch.zeros(info["shape"], dtype=dtype,
                                    device=device)) if func is None
                else func(info["shape"], **kwargs)
                for info in self.state_info(batch_size)]

    def reset(self):
        """Clear per-sequence state (variational dropout masks); containers
        pass it on to their cells."""
        for child in self.children():
            if isinstance(child, RecurrentCell):
                child.reset()

    def hybridize(self, active=True, **kwargs):
        super().hybridize(active, **kwargs)
        if any(getattr(m, "_per_sequence_masks", False)
               for m in self.modules()):
            self._active = False    # its masks live across calls

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        """Step over ``length`` time steps of ``inputs``; returns
        ``(outputs, states)``, outputs stacked along the time axis unless
        ``merge_outputs`` is False."""
        nd = _holds_nd(inputs, begin_state, valid_length)
        inputs, begin_state, valid_length = unwrap(
            (inputs, begin_state, valid_length))
        self.reset()    # fresh per-sequence state, nested cells included
        axis = layout.find("T")
        if begin_state is None:
            begin_state = unwrap(self.begin_state(
                inputs.shape[layout.find("N")]))
        states = begin_state
        outputs = []
        for t in range(length):
            out, states = self(inputs.select(axis, t), states)
            outputs.append(out)
        if merge_outputs is False:
            return (wrap((outputs, states)) if nd else (outputs, states))
        stacked = torch.stack(outputs, dim=axis)
        if valid_length is not None:
            tmajor = stacked.transpose(0, axis) if axis else stacked
            tmajor = _SEQ_MASK.fn(use_sequence_length=True, axis=0)(
                tmajor, valid_length)
            stacked = tmajor.transpose(0, axis) if axis else tmajor
        return wrap((stacked, states)) if nd else (stacked, states)


class _BaseCell(RecurrentCell):
    def __init__(self, hidden_size, ngates, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 dtype="float32", device=None, **kwargs):
        super().__init__(**kwargs)
        device = resolve_device(device)
        dtype = to_dtype(dtype)
        self._hidden_size = hidden_size
        rows = ngates * hidden_size
        self.i2h_weight = new_parameter((rows, input_size), dtype, device,
                                        i2h_weight_initializer)
        self.h2h_weight = new_parameter((rows, hidden_size), dtype, device,
                                        h2h_weight_initializer)
        self.i2h_bias = new_parameter((rows,), dtype, device,
                                      i2h_bias_initializer)
        self.h2h_bias = new_parameter((rows,), dtype, device,
                                      h2h_bias_initializer)

    def _infer(self, x):
        if self.i2h_weight.is_deferred:
            self.i2h_weight._finish_deferred_init(
                (self.i2h_weight.shape[0], x.shape[-1]))

    def _gates(self, x, h):
        """``x W_i2h^T + b_i2h`` and ``h W_h2h^T + b_h2h``."""
        self._infer(x)
        return (F.fully_connected(x, self.i2h_weight, self.i2h_bias,
                                  flatten=False),
                F.fully_connected(h, self.h2h_weight, self.h2h_bias,
                                  flatten=False))

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]


class RNNCell(_BaseCell):
    """Elman cell: ``act(x W_i2h^T + b + h W_h2h^T + b)``."""

    def __init__(self, hidden_size, activation="tanh", input_size=0,
                 **kwargs):
        super().__init__(hidden_size, 1, input_size, **kwargs)
        self._activation = activation

    def forward(self, x, states):
        h = states[0] if isinstance(states, (list, tuple)) else states
        gi, gh = self._gates(x, h)
        out = F.activation(gi + gh, act_type=self._activation)
        return out, [out]


def _lstm_step(gates, c, n):
    """One i, f, g, o LSTM update from the summed gate products."""
    i = torch.sigmoid(gates[..., :n])
    f = torch.sigmoid(gates[..., n:2 * n])
    g = torch.tanh(gates[..., 2 * n:3 * n])
    o = torch.sigmoid(gates[..., 3 * n:])
    c_new = f * c + i * g
    return o * torch.tanh(c_new), c_new


class LSTMCell(_BaseCell):
    """LSTM cell, gate order i, f, g, o."""

    def __init__(self, hidden_size, input_size=0, **kwargs):
        super().__init__(hidden_size, 4, input_size, **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size), "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size), "__layout__": "NC"}]

    def forward(self, x, states):
        h, c = states
        gi, gh = self._gates(x, h)
        h_new, c_new = _lstm_step(gi + gh, c, self._hidden_size)
        return h_new, [h_new, c_new]


class GRUCell(_BaseCell):
    """GRU cell, cuDNN's form: ``n = tanh(i2h_n + r * (h2h_n + b))``."""

    def __init__(self, hidden_size, input_size=0, **kwargs):
        super().__init__(hidden_size, 3, input_size, **kwargs)

    def forward(self, x, states):
        h = states[0]
        n = self._hidden_size
        gi, gh = self._gates(x, h)
        r = torch.sigmoid(gi[..., :n] + gh[..., :n])
        z = torch.sigmoid(gi[..., n:2 * n] + gh[..., n:2 * n])
        cand = torch.tanh(gi[..., 2 * n:] + r * gh[..., 2 * n:])
        h_new = (torch.ones_like(z) - z) * cand + z * h
        return h_new, [h_new]


class SequentialRNNCell(RecurrentCell):
    """Cells stacked: each step runs them in the order added, each taking
    its share of the states."""

    def add(self, cell):
        self.register_child(cell)

    def state_info(self, batch_size=0):
        info = []
        for cell in self.children():
            info.extend(cell.state_info(batch_size))
        return info

    def forward(self, x, states):
        next_states = []
        p = 0
        for cell in self.children():
            n = len(cell.state_info())
            x, new = cell(x, states[p:p + n])
            next_states.extend(new)
            p += n
        return x, next_states

    def __len__(self):
        return len(self._modules)


# every cell here is hybrid-capable; the reference kept a separate class
# for the pre-Gluon2 Block/HybridBlock split
HybridSequentialRNNCell = SequentialRNNCell


class _ModifierCell(RecurrentCell):
    def __init__(self, base_cell, **kwargs):
        super().__init__(**kwargs)
        self.base_cell = base_cell

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)


class VariationalDropoutCell(_ModifierCell):
    """Variational dropout (Gal & Ghahramani): one mask a sequence for the
    inputs, the first state and the outputs, reused at every step, drawn
    at the first training step after ``reset()``."""

    _per_sequence_masks = True

    def __init__(self, base_cell, drop_inputs=0.0, drop_states=0.0,
                 drop_outputs=0.0, **kwargs):
        super().__init__(base_cell, **kwargs)
        self._di, self._ds, self._do = drop_inputs, drop_states, drop_outputs
        self.reset()

    def reset(self):
        self._mask_i = self._mask_s = self._mask_o = None
        super().reset()

    def _mask(self, rate, like):
        # inverted-dropout mask with the keep-scale folded in
        if _cached_op.is_inlined():
            raise MXNetError(
                "VariationalDropoutCell keeps its masks across steps in "
                "Python and cannot be captured inside another block's "
                "program; hybridize the cell itself (its steps run "
                "eagerly) or leave the block eager")
        return F.dropout(torch.ones_like(like), rate, True)

    def forward(self, x, states):
        training = _ag.is_training()
        if training and self._di > 0:
            if self._mask_i is None:
                self._mask_i = self._mask(self._di, x)
            x = x * self._mask_i
        if training and self._ds > 0:
            if self._mask_s is None:
                self._mask_s = self._mask(self._ds, states[0])
            states = [states[0] * self._mask_s] + list(states[1:])
        out, new_states = self.base_cell(x, states)
        if training and self._do > 0:
            if self._mask_o is None:
                self._mask_o = self._mask(self._do, out)
            out = out * self._mask_o
        return out, new_states


class LSTMPCell(_BaseCell):
    """LSTM with a projected recurrent state (LSTMP, Sak et al. 2014): the
    cell state has ``hidden_size`` units, the recurrent and output state
    ``projection_size`` (``h2r_weight``)."""

    def __init__(self, hidden_size, projection_size, input_size=0,
                 h2r_weight_initializer=None, h2h_weight_initializer=None,
                 dtype="float32", device=None, **kwargs):
        super().__init__(hidden_size, 4, input_size, dtype=dtype,
                         h2h_weight_initializer=h2h_weight_initializer,
                         device=device, **kwargs)
        device = resolve_device(device)
        self._projection_size = projection_size
        # the recurrent operand is the projected state: a narrow h2h
        self.h2h_weight = new_parameter(
            (4 * hidden_size, projection_size), to_dtype(dtype), device,
            h2h_weight_initializer)
        self.h2r_weight = new_parameter(
            (projection_size, hidden_size), to_dtype(dtype), device,
            h2r_weight_initializer)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._projection_size),
                 "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def forward(self, x, states):
        r, c = states   # the projected recurrent state, the cell state
        gi, gh = self._gates(x, r)
        h, c_new = _lstm_step(gi + gh, c, self._hidden_size)
        r_new = F.fully_connected(h, self.h2r_weight, None, flatten=False)
        return r_new, [r_new, c_new]


class DropoutCell(RecurrentCell):
    """Dropout on the step's input, a fresh mask each step; no state."""

    def __init__(self, rate, **kwargs):
        super().__init__(**kwargs)
        self._rate = rate

    def state_info(self, batch_size=0):
        return []

    def forward(self, x, states):
        if self._rate > 0:
            x = F.dropout(x, self._rate)
        return x, states


class ZoneoutCell(_ModifierCell):
    """Zoneout of the outputs and states, as the reference's scaled
    dropout masks (a fresh one each step)."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0,
                 **kwargs):
        super().__init__(base_cell, **kwargs)
        self._zo = zoneout_outputs
        self._zs = zoneout_states

    def forward(self, x, states):
        out, new_states = self.base_cell(x, states)
        if _ag.is_training():
            if self._zo > 0:
                mask = F.dropout(torch.ones_like(out), self._zo, True) * \
                    (1 - self._zo)
                out = mask * out
            if self._zs > 0:
                new_states = [s_old + (s_new - s_old) *
                              (F.dropout(torch.ones_like(s_new), self._zs,
                                         True) * (1 - self._zs))
                              for s_old, s_new in zip(states, new_states)]
        return out, new_states


class ResidualCell(_ModifierCell):
    """The base cell's output plus the step's input."""

    def forward(self, x, states):
        out, new_states = self.base_cell(x, states)
        return out + x, new_states


class BidirectionalCell(RecurrentCell):
    """``l_cell`` forward in time and ``r_cell`` over the flipped sequence,
    outputs concatenated on the last axis; ``unroll`` only."""

    def __init__(self, l_cell, r_cell, **kwargs):
        super().__init__(**kwargs)
        self.l_cell = l_cell
        self.r_cell = r_cell

    def state_info(self, batch_size=0):
        return self.l_cell.state_info(batch_size) + \
            self.r_cell.state_info(batch_size)

    def forward(self, x, states):
        raise MXNetError("BidirectionalCell supports unroll() only")

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        nd = _holds_nd(inputs, begin_state, valid_length)
        inputs, begin_state, valid_length = unwrap(
            (inputs, begin_state, valid_length))
        if begin_state is None:
            begin_state = unwrap(self.begin_state(
                inputs.shape[layout.find("N")]))
        n_l = len(self.l_cell.state_info())
        l_out, l_states = self.l_cell.unroll(
            length, inputs, begin_state[:n_l], layout, True, valid_length)
        axis = layout.find("T")
        r_out, r_states = self.r_cell.unroll(
            length, torch.flip(inputs, (axis,)), begin_state[n_l:], layout,
            True, valid_length)
        out = torch.cat([l_out, torch.flip(r_out, (axis,))], dim=-1)
        states = list(l_states) + list(r_states)
        return wrap((out, states)) if nd else (out, states)
