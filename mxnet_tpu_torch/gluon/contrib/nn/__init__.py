"""Contrib layers (port of ``mxnet_tpu/gluon/contrib/nn/``, subset)."""

from .basic_layers import MultiHeadAttention  # noqa: F401
