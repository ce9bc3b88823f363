"""Gluon layers (port of ``mxnet_tpu/gluon/nn/``, subset)."""

from .basic_layers import (Sequential, HybridSequential, Dense,  # noqa
                           Dropout, Embedding, BatchNorm, InstanceNorm,
                           LayerNorm, Flatten, Lambda, HybridLambda,
                           Activation, LeakyReLU, PReLU, ELU, SELU, Swish,
                           GELU)
from .conv_layers import (Conv1D, Conv2D, Conv3D, MaxPool1D,  # noqa
                          MaxPool2D, MaxPool3D, AvgPool1D, AvgPool2D,
                          AvgPool3D, GlobalMaxPool1D, GlobalMaxPool2D,
                          GlobalMaxPool3D, GlobalAvgPool1D,
                          GlobalAvgPool2D, GlobalAvgPool3D)
from ..block import Block, HybridBlock, SymbolBlock  # noqa: F401
