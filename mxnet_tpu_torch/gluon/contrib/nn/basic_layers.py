"""Contrib layers (port of ``mxnet_tpu/gluon/contrib/nn/basic_layers.py``,
subset: MultiHeadAttention)."""

from __future__ import annotations

from ... import nn
from ...block import HybridBlock

__all__ = ["MultiHeadAttention"]


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
