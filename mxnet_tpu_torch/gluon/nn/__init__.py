"""Gluon layers (port of ``mxnet_tpu/gluon/nn/``, subset)."""

from .basic_layers import (Sequential, HybridSequential, Dense,  # noqa
                           Embedding, BatchNorm, LayerNorm, Flatten,
                           Activation)
from .conv_layers import (Conv1D, Conv2D, Conv3D, MaxPool1D,  # noqa
                          MaxPool2D, MaxPool3D, AvgPool1D, AvgPool2D,
                          AvgPool3D, GlobalMaxPool1D, GlobalMaxPool2D,
                          GlobalMaxPool3D, GlobalAvgPool1D,
                          GlobalAvgPool2D, GlobalAvgPool3D)
