"""Contrib recurrent cells (port of ``mxnet_tpu/gluon/contrib/rnn/``)."""

from .rnn_cell import VariationalDropoutCell, LSTMPCell  # noqa: F401
from .conv_rnn_cell import (Conv1DRNNCell, Conv2DRNNCell,  # noqa: F401
                            Conv3DRNNCell, Conv1DLSTMCell,
                            Conv2DLSTMCell, Conv3DLSTMCell,
                            Conv1DGRUCell, Conv2DGRUCell, Conv3DGRUCell)
