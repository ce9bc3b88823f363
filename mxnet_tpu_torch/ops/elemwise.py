"""Elementwise ops (port of ``mxnet_tpu/ops/elemwise.py``, subset:
``broadcast_add`` and ``broadcast_mul`` with their aliases, ``negative``
and ``_mul_scalar``)."""

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


@register_op("broadcast_mul", input_names=())
def _broadcast_mul(lhs, rhs):
    return torch.mul(lhs, rhs)


alias("elemwise_mul", "broadcast_mul")
alias("_mul", "broadcast_mul")


@register_op("negative")
def _negative(x):
    return torch.neg(x)


@register_op("_mul_scalar")
def _mul_scalar(x, scalar=1.0):
    return x * scalar
