"""Contrib layers (port of ``mxnet_tpu/gluon/contrib/nn/basic_layers.py``
less MoEFFN): Concurrent, HybridConcurrent, Identity, SparseEmbedding,
SyncBatchNorm and MultiHeadAttention."""

from __future__ import annotations

from ... import nn
from ...block import Block, HybridBlock
from .... import ndarray as nd

__all__ = ["Concurrent", "HybridConcurrent", "Identity", "SparseEmbedding",
           "SyncBatchNorm", "MultiHeadAttention"]


class Concurrent(nn.Sequential):
    """Runs each child on the same input and concatenates their outputs
    along *axis*."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def forward(self, x):
        out = [blk(x) for blk in self._children.values()]
        return nd.concat(*out, dim=self.axis)


class HybridConcurrent(nn.HybridSequential):
    """Hybridizable :class:`Concurrent`."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def hybrid_forward(self, F, x):
        out = [blk(x) for blk in self._children.values()]
        return F.concat(*out, dim=self.axis)


class Identity(HybridBlock):
    """Passes its input through (a branch of a Concurrent)."""

    def hybrid_forward(self, F, x):
        return x


class SparseEmbedding(Block):
    """An Embedding whose weight has a row-sparse gradient (reference:
    basic_layers.py:116): the Trainer's lazy optimizers update only the
    rows a batch touched."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, **kwargs):
        super().__init__(**kwargs)
        self._kwargs = {"input_dim": input_dim, "output_dim": output_dim}
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(input_dim, output_dim), dtype=dtype,
                init=weight_initializer, stype="row_sparse",
                grad_stype="row_sparse")

    def forward(self, x):
        weight = self.weight.row_sparse_data(x)
        return nd.Embedding(x, weight, **self._kwargs, sparse_grad=True)

    def __repr__(self):
        return "SparseEmbedding({input_dim} -> {output_dim})".format(
            **self._kwargs)


class SyncBatchNorm(nn.BatchNorm):
    """BatchNorm on axis 1 with the JAX layer's signature.  As there,
    outside a data-parallel mesh the statistics are the local batch's,
    which is the cross-device statistic on one device; *num_devices* is
    kept and unused."""

    def __init__(self, in_channels=0, num_devices=None, momentum=0.9,
                 epsilon=1e-5, **kwargs):
        super().__init__(axis=1, momentum=momentum, epsilon=epsilon,
                         in_channels=in_channels, **kwargs)
        self._num_devices = num_devices


class MultiHeadAttention(HybridBlock):
    """Multi-head scaled-dot-product attention: q/k/v/out projections
    around ``contrib.DotProductAttention``, which runs the Hopper flash
    kernel on CUDA tensors.

    Inputs and outputs are (batch, seq, units); ``num_heads`` must divide
    ``units``.  One argument: self-attention; three: (query, key, value).
    """

    def __init__(self, units, num_heads, causal=False, use_bias=True,
                 **kwargs):
        super().__init__(**kwargs)
        if units % num_heads:
            raise ValueError("units (%d) must be divisible by num_heads "
                             "(%d)" % (units, num_heads))
        self._units = units
        self._num_heads = num_heads
        self._causal = causal
        with self.name_scope():
            self.proj_query = nn.Dense(units, use_bias=use_bias,
                                       flatten=False, prefix="query_")
            self.proj_key = nn.Dense(units, use_bias=use_bias,
                                     flatten=False, prefix="key_")
            self.proj_value = nn.Dense(units, use_bias=use_bias,
                                       flatten=False, prefix="value_")
            self.proj_out = nn.Dense(units, use_bias=use_bias,
                                     flatten=False, prefix="out_")

    def _split(self, F, x):
        # (B, S, U) -> (B, H, S, U/H)
        x = F.Reshape(x, shape=(0, 0, self._num_heads, -1))
        return F.transpose(x, axes=(0, 2, 1, 3))

    def hybrid_forward(self, F, query, key=None, value=None):
        key = query if key is None else key
        value = key if value is None else value
        q = self._split(F, self.proj_query(query))
        k = self._split(F, self.proj_key(key))
        v = self._split(F, self.proj_value(value))
        att = F.contrib.DotProductAttention(q, k, v, causal=self._causal)
        # (B, H, S, d) -> (B, S, U)
        att = F.transpose(att, axes=(0, 2, 1, 3))
        att = F.Reshape(att, shape=(0, 0, -1))
        return self.proj_out(att)

    def extra_repr(self):
        return "units=%d, heads=%d, causal=%s" % (
            self._units, self._num_heads, self._causal)
