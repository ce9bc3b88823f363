"""Elementwise binary ops (port of ``mxnet_tpu/ops/elemwise.py``, subset:
``broadcast_add`` with its aliases)."""

from __future__ import annotations

import torch

from .registry import register_op, alias


# no declared input names, like the JAX package's registration over
# jnp.add: a symbol composes it only from the inputs it is given
@register_op("broadcast_add", input_names=())
def _broadcast_add(lhs, rhs):
    return torch.add(lhs, rhs)


alias("elemwise_add", "broadcast_add")
alias("_plus", "broadcast_add")
