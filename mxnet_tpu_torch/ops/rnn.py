"""The fused recurrent op ``rnn``: vanilla RNN (relu or tanh), LSTM and GRU.

Counterpart of ``mxnet_tpu/ops/rnn.py:22-112``, which runs each (layer,
direction) as a ``lax.scan`` of the step formulas below. The port runs the
same formulas in plain torch, one time step after another, on the CPU and
on the card alike, under torch's autograd, so gradients reach ``x``,
``h0``, ``c0`` and every weight. Eagerly a layer is T steps of a few
launches each; a hybridized block captures the whole recurrence, forward
and backward, into its CUDA graphs.

``fn(x, h0[, c0], *weights)``: ``x`` is (T, B, I), ``h0``/``c0`` are
(layers * directions, B, H), and the weights are flattened as ``[w_ih,
w_hh, b_ih, b_hh]`` per (layer, direction), direction fastest. It returns
``(out, h)``, or ``(out, h, c)`` for LSTM, ``out`` (T, B, directions * H)
with ``out[t]`` the output at input step ``t`` in both directions (the
reverse direction walks from T - 1 down and writes each step back to its
own position, as ``lax.scan(..., reverse=True)`` does).

Gate orders are the reference's (cuDNN's): LSTM ``i, f, g, o``; GRU
``r, z, n`` with ``n = tanh(i2h_n + r * (h2h_n + b_hh_n))``, the reset gate
multiplying the hidden product with its bias. The input products of a
whole sequence are one matrix product, made once before the loop and
unbound into its time steps (so the backward stacks their gradients in one
pass, where indexing would fill and add a whole-sequence tensor a step);
for LSTM and the vanilla RNN both biases are added there too (the
reference adds ``b_hh`` at each step: the same terms, one rounding
apart).

``dropout`` is accepted and ignored, as in the reference (no dropout
between layers). Every operand must lie on ``x``'s device: a state on
another device raises :class:`MXNetError` rather than being copied.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from .registry import register

__all__ = ["MODES", "GATES", "num_outputs"]

MODES = ("rnn_relu", "rnn_tanh", "lstm", "gru")
# gates a mode's weights stack: ``w_ih`` is (GATES[mode] * H, I)
GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}


def num_outputs(attrs):
    """The op's output count for ``attrs``: 3 for LSTM, else 2."""
    return 3 if attrs.get("mode", "lstm") == "lstm" else 2


def _steps(reverse, T):
    return range(T - 1, -1, -1) if reverse else range(T)


def _vanilla_layer(act, params, x, h, reverse):
    w_ih, w_hh, b_ih, b_hh = params
    xp = (torch.matmul(x, w_ih.t()) + b_ih + b_hh).unbind(0)
    w_hh_t = w_hh.t()
    ys = [None] * x.shape[0]
    for t in _steps(reverse, x.shape[0]):
        h = act(torch.addmm(xp[t], h, w_hh_t))
        ys[t] = h
    return torch.stack(ys), h, None


def _lstm_layer(params, x, h, c, reverse):
    w_ih, w_hh, b_ih, b_hh = params
    n = h.shape[-1]
    xp = (torch.matmul(x, w_ih.t()) + b_ih + b_hh).unbind(0)
    w_hh_t = w_hh.t()
    ys = [None] * x.shape[0]
    for t in _steps(reverse, x.shape[0]):
        gates = torch.addmm(xp[t], h, w_hh_t)
        s = torch.sigmoid(gates)     # i, f and o of it
        g = torch.tanh(gates[:, 2 * n:3 * n])
        c = s[:, n:2 * n] * c + s[:, :n] * g
        h = s[:, 3 * n:] * torch.tanh(c)
        ys[t] = h
    return torch.stack(ys), h, c


def _gru_layer(params, x, h, reverse):
    w_ih, w_hh, b_ih, b_hh = params
    n = h.shape[-1]
    gi = (torch.matmul(x, w_ih.t()) + b_ih).unbind(0)
    w_hh_t = w_hh.t()
    ys = [None] * x.shape[0]
    for t in _steps(reverse, x.shape[0]):
        gh = torch.addmm(b_hh, h, w_hh_t)
        rz = torch.sigmoid(gi[t][:, :2 * n] + gh[:, :2 * n])
        cand = torch.tanh(gi[t][:, 2 * n:] + rz[:, :n] * gh[:, 2 * n:])
        z = rz[:, n:]
        h = (1 - z) * cand + z * h
        ys[t] = h
    return torch.stack(ys), h, None


_VANILLA = {"rnn_relu": torch.relu, "rnn_tanh": torch.tanh}


def _check(mode, num_layers, ndir, x, states, weights):
    if mode not in MODES:
        raise MXNetError(f"rnn: mode must be one of {MODES}, got {mode!r}")
    want = 4 * num_layers * ndir
    if len(weights) != want:
        raise MXNetError(f"rnn: {num_layers} layer(s) x {ndir} "
                         f"direction(s) take {want} weight arrays "
                         f"[w_ih, w_hh, b_ih, b_hh] each, got {len(weights)}")
    for t in (*states, *weights):
        if t.device != x.device:
            raise MXNetError(f"rnn: an operand lies on {t.device}, the "
                             f"input on {x.device}; move it there first")


@register("rnn", sym_nout=num_outputs)
def _rnn(mode="lstm", num_layers=1, hidden_size=0, bidirectional=False,
         dropout=0.0):
    """``fn(x, h0[, c0], *weights)``; see the module docstring."""
    ndir = 2 if bidirectional else 1
    is_lstm = mode == "lstm"

    def f(x, h0, *rest):
        c0, weights = (rest[0], rest[1:]) if is_lstm else (None, rest)
        _check(mode, num_layers, ndir, x,
               (h0, c0) if is_lstm else (h0,), weights)
        outs = x
        h_finals, c_finals = [], []
        for layer in range(num_layers):
            layer_outs = []
            for d in range(ndir):
                li = layer * ndir + d
                params = weights[4 * li:4 * li + 4]
                if is_lstm:
                    ys, h, c = _lstm_layer(params, outs, h0[li], c0[li],
                                           d == 1)
                    c_finals.append(c)
                elif mode == "gru":
                    ys, h, _ = _gru_layer(params, outs, h0[li], d == 1)
                else:
                    ys, h, _ = _vanilla_layer(_VANILLA[mode], params, outs,
                                              h0[li], d == 1)
                layer_outs.append(ys)
                h_finals.append(h)
            outs = layer_outs[0] if ndir == 1 else \
                torch.cat(layer_outs, dim=-1)
        if is_lstm:
            return outs, torch.stack(h_finals), torch.stack(c_finals)
        return outs, torch.stack(h_finals)

    return f
