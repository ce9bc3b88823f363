"""Gluon layers (port of ``mxnet_tpu/gluon/nn/``, subset)."""

from .basic_layers import Dense, Embedding, LayerNorm, Activation  # noqa
