"""Gluon recurrent layers and cells (port of ``mxnet_tpu/gluon/rnn/``)."""

from .rnn_layer import RNN, LSTM, GRU  # noqa: F401
from .rnn_cell import (RecurrentCell, HybridRecurrentCell, RNNCell,  # noqa
                       LSTMCell, GRUCell, SequentialRNNCell, DropoutCell,
                       BidirectionalCell, ResidualCell, ModifierCell)

__all__ = ["RNN", "LSTM", "GRU", "RecurrentCell", "HybridRecurrentCell",
           "RNNCell", "LSTMCell", "GRUCell", "SequentialRNNCell",
           "DropoutCell", "BidirectionalCell", "ResidualCell",
           "ModifierCell"]
