"""gluon.rnn: the recurrent cells and the fused RNN/LSTM/GRU layers
(reference: ``mxnet_tpu/gluon/rnn``)."""
from .rnn_cell import (BidirectionalCell, DropoutCell, GRUCell,
                       HybridSequentialRNNCell, LSTMCell, LSTMPCell,
                       RecurrentCell, ResidualCell, RNNCell,
                       SequentialRNNCell, VariationalDropoutCell, ZoneoutCell)
from .rnn_layer import GRU, LSTM, RNN

__all__ = ["RecurrentCell", "RNNCell", "LSTMCell", "GRUCell",
           "SequentialRNNCell", "HybridSequentialRNNCell", "DropoutCell",
           "ZoneoutCell", "ResidualCell", "BidirectionalCell",
           "VariationalDropoutCell", "LSTMPCell", "RNN", "LSTM", "GRU"]
