"""The LSTM language model of the reference's ``example/rnn/word_lm``.

Counterpart of ``mxnet_tpu/gluon/model_zoo/rnn_lm.py:13-54``: an
``Embedding``, dropout, an ``rnn.LSTM`` stack in ``NTC`` layout, dropout,
and a decoder. With ``tie_weights`` and ``embed_size == hidden_size`` the
decoder is the embedding's own table, ``out @ embedding.weight.T`` with no
bias; otherwise a ``Dense(vocab_size)``. Dropout is the ``dropout`` op on
the embedding and on the LSTM's output, active inside
``autograd.record()`` (or after ``train()``); the LSTM's own ``dropout`` is
ignored, as the reference's ``rnn`` op ignores it.

``forward(inputs, states=None)``: ``inputs`` (N, T) integer tokens; returns
the (N, T, vocab) logits, or ``(logits, new_states)`` with ``states``
(``begin_state(N)``: ``[h, c]``, each (layers, N, hidden)).
"""
from __future__ import annotations

from ...context import resolve_device
from ...ops import nn as F
from .. import nn, rnn
from ..block import HybridBlock

__all__ = ["RNNModel", "rnn_lm"]


class RNNModel(HybridBlock):
    _tensor_body = True

    def __init__(self, vocab_size=10000, embed_size=200, hidden_size=200,
                 num_layers=2, dropout=0.2, tie_weights=False, device=None,
                 **kwargs):
        super().__init__(**kwargs)
        device = resolve_device(device)
        self._dropout = dropout
        self.embedding = nn.Embedding(vocab_size, embed_size, device=device)
        self.lstm = rnn.LSTM(hidden_size, num_layers=num_layers,
                             layout="NTC", dropout=dropout, device=device)
        self._tie = tie_weights and embed_size == hidden_size
        if not self._tie:
            self.decoder = nn.Dense(vocab_size, flatten=False,
                                    in_units=hidden_size, device=device)
        self.hidden_size = hidden_size

    def begin_state(self, batch_size):
        return self.lstm.begin_state(batch_size)

    def forward(self, inputs, states=None):
        x = self.embedding(inputs)
        if self._dropout:
            x = F.dropout(x, self._dropout, self.training)
        if states is None:
            out = self.lstm(x)
            new_states = None
        else:
            out, new_states = self.lstm(x, states)
        if self._dropout:
            out = F.dropout(out, self._dropout, self.training)
        if self._tie:
            logits = F.matmul(out, self.embedding.weight.t())
        else:
            logits = self.decoder(out)
        if states is None:
            return logits
        return logits, new_states


def rnn_lm(**kwargs):
    """``RNNModel(**kwargs)``."""
    return RNNModel(**kwargs)
