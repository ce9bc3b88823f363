"""Symbolic RNN cells and bucketing I/O for BucketingModule workflows
(port of ``mxnet_tpu/rnn/``)."""

from .rnn_cell import (BaseRNNCell, RNNParams, RNNCell, LSTMCell,  # noqa
                       GRUCell, FusedRNNCell, SequentialRNNCell,
                       BidirectionalCell, DropoutCell, ResidualCell,
                       ModifierCell)
from .io import BucketSentenceIter  # noqa: F401
