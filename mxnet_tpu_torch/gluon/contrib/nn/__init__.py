"""Contrib layers (port of ``mxnet_tpu/gluon/contrib/nn/``, less MoEFFN)."""

from .basic_layers import (Concurrent, HybridConcurrent, Identity,  # noqa
                           MultiHeadAttention, SparseEmbedding,
                           SyncBatchNorm)
