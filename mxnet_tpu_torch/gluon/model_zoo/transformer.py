"""Decoder-only transformer language model (port of
``mxnet_tpu/gluon/model_zoo/transformer.py``; the tensor-parallel sharding
preset is not ported).

Pre-norm GPT-style blocks over ``gluon.contrib.nn.MultiHeadAttention``,
whose attention runs the Hopper flash kernel on CUDA tensors.

Usage::

    net = get_transformer_lm(vocab=32000, dim=1024, heads=16, layers=12)
    logits = net(tokens)         # (B, S) ids -> (B, S, vocab)
"""

from __future__ import annotations

from ..block import HybridBlock
from .. import nn
from ..contrib.nn import MultiHeadAttention

__all__ = ["TransformerBlock", "TransformerLM", "get_transformer_lm"]


class TransformerBlock(HybridBlock):
    """One pre-norm block: x + MHA(LN(x)); x + MLP(LN(x))."""

    def __init__(self, dim, heads, mlp_ratio=4, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.ln1 = nn.LayerNorm()
            self.attn = MultiHeadAttention(dim, heads, causal=True,
                                           use_bias=False)
            self.ln2 = nn.LayerNorm()
            self.fc1 = nn.Dense(mlp_ratio * dim, activation="relu",
                                flatten=False)
            self.fc2 = nn.Dense(dim, flatten=False)

    def hybrid_forward(self, F, x):
        x = x + self.attn(self.ln1(x))
        return x + self.fc2(self.fc1(self.ln2(x)))


class TransformerLM(HybridBlock):
    """Token embedding + learned positions + N blocks + LM head.

    ``max_seq`` bounds the learned positional table; inputs may be any
    length up to it (the table is slice_like-d to the sequence).
    """

    def __init__(self, vocab=32000, dim=512, heads=8, layers=6,
                 max_seq=8192, mlp_ratio=4, **kwargs):
        super().__init__(**kwargs)
        self._dim = dim
        with self.name_scope():
            self.embed = nn.Embedding(vocab, dim)
            self.pos = self.params.get("pos_embed", shape=(1, max_seq, dim),
                                       init="normal")
            self.blocks = []
            for i in range(layers):
                blk = TransformerBlock(dim, heads, mlp_ratio,
                                       prefix="h%d_" % i)
                setattr(self, "h%d" % i, blk)
                self.blocks.append(blk)
            self.ln_f = nn.LayerNorm()
            self.head = nn.Dense(vocab, use_bias=False, flatten=False)

    def hybrid_forward(self, F, x, pos=None):
        h = self.embed(x)
        # (1, max_seq, D) -> (1, S, D), broadcast over batch
        p = F.slice_like(pos, h, axes=(1,))
        h = F.broadcast_add(h, p)
        for blk in self.blocks:
            h = blk(h)
        return self.head(self.ln_f(h))


def get_transformer_lm(vocab=32000, dim=512, heads=8, layers=6,
                       max_seq=8192, **kwargs):
    return TransformerLM(vocab=vocab, dim=dim, heads=heads, layers=layers,
                         max_seq=max_seq, **kwargs)
