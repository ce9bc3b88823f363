"""Reductions (port of ``mxnet_tpu/ops/reduce.py``).

MXNet semantics: ``axis=None`` reduces every axis; ``exclude=True``
reduces over every axis *not* listed; ``keepdims`` keeps reduced axes as
size 1.  A reduction over every axis gives a 0-d tensor, as ``jnp``'s
does.
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
    ax = tuple(a % x.dim() for a in ax) if x.dim() else ()
    if exclude:
        ax = tuple(a for a in range(x.dim()) if a not in ax)
    return ax


def _over(fn, name):
    """*fn* ``(x, dims) -> x`` reduced over the op's axes with keepdims;
    no axis left to reduce returns *x* itself, as ``jnp`` does for an
    empty axis tuple.  Dtypes follow ``jnp``: an integer sum or product
    keeps its dtype (bool counts in int32), an integer mean is float32."""
    def f(x, axis=None, keepdims=False, exclude=False):
        ax = _axes(x, axis, exclude)
        if not ax:
            return x
        dtype = x.dtype
        if not (x.is_floating_point() or x.is_complex()):
            if name in ("mean", "logsumexp"):
                x = x.to(torch.float32)
                dtype = torch.float32
            elif dtype == torch.bool and name not in ("max", "min"):
                dtype = torch.int32
        out = fn(x, ax).to(dtype)
        return out if keepdims else out.squeeze(ax)
    return f


def _prod(x, ax):
    for a in ax:
        x = torch.prod(x, dim=a, keepdim=True)
    return x


def _nan_as(x, value):
    if not x.is_floating_point():
        return x
    return torch.where(torch.isnan(x), torch.full_like(x, value), x)


def _logsumexp(x, ax):
    # jax.scipy.special.logsumexp: a max shift that ignores infinities,
    # then log(sum(exp(x - max))) + max
    m = torch.amax(x, dim=ax, keepdim=True).detach()
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    s = torch.sum(torch.exp(x - m), dim=ax, keepdim=True)
    return torch.log(s) + m


# each (x, dims) -> x reduced over dims, keepdim
_REDUCE = {
    "sum": lambda x, ax: torch.sum(x, dim=ax, keepdim=True),
    "mean": lambda x, ax: torch.mean(x, dim=ax, keepdim=True),
    "prod": _prod,
    "max": lambda x, ax: torch.amax(x, dim=ax, keepdim=True),
    "min": lambda x, ax: torch.amin(x, dim=ax, keepdim=True),
    "nansum": lambda x, ax: torch.sum(_nan_as(x, 0), dim=ax, keepdim=True),
    "nanprod": lambda x, ax: _prod(_nan_as(x, 1), ax),
    "logsumexp": _logsumexp,
}

for _name, _fn in _REDUCE.items():
    register_op(_name)(_over(_fn, _name))

alias("sum_axis", "sum")
alias("mean_axis", "mean")
alias("max_axis", "max")
alias("min_axis", "min")


@register_op("L2Normalization")
def _l2_normalization(x, eps=1e-10, mode="instance"):
    """x over the L2 norm of its instance (every axis but the first), its
    channel (axis 1) or its spatial extent (axes 2 onwards)."""
    if mode == "instance":
        axes = tuple(range(1, x.dim()))
    elif mode == "channel":
        axes = (1,)
    elif mode == "spatial":
        axes = tuple(range(2, x.dim()))
    else:
        raise ValueError(mode)
    norm = torch.sqrt(torch.sum(torch.square(x), dim=axes, keepdim=True)
                      + eps)
    return x / norm
