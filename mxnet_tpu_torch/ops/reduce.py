"""Reductions (port of ``mxnet_tpu/ops/reduce.py``, subset: sum, mean).

MXNet semantics: ``axis=None`` reduces every axis; ``exclude=True``
reduces over every axis *not* listed; ``keepdims`` keeps reduced axes as
size 1.
"""

from __future__ import annotations

import torch

from .registry import register_op, alias


def _axes(x, axis, exclude):
    if axis is None:
        ax = tuple(range(x.dim()))
    elif isinstance(axis, int):
        ax = (axis,)
    else:
        ax = tuple(axis)
    ax = tuple(a % x.dim() for a in ax)
    if exclude:
        ax = tuple(a for a in range(x.dim()) if a not in ax)
    return ax


@register_op("sum")
def _sum(x, axis=None, keepdims=False, exclude=False):
    ax = _axes(x, axis, exclude)
    return torch.sum(x, dim=ax, keepdim=keepdims) if ax else x


@register_op("mean")
def _mean(x, axis=None, keepdims=False, exclude=False):
    ax = _axes(x, axis, exclude)
    return torch.mean(x, dim=ax, keepdim=keepdims) if ax else x


alias("sum_axis", "sum")
alias("mean_axis", "mean")
