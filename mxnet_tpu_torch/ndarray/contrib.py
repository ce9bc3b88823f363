"""Imperative control flow and samplers of ``nd.contrib`` (port of
``mxnet_tpu/ndarray/contrib.py``), beside the ``_contrib_*`` ops
(``nd.contrib.DotProductAttention``) that ``ndarray/__init__.py``
installs here.

As in the reference, ``foreach``, ``while_loop`` and ``cond`` are plain
Python loops and branches over eager ops: every op inside is taped, so
autograd works, and trip counts may depend on the data.
"""

from __future__ import annotations

import numpy as _np

from .ndarray import array, imperative_invoke
from . import random as _random

__all__ = ["foreach", "while_loop", "cond", "rand_zipfian"]


def _stack(arrs):
    return imperative_invoke("stack", *arrs, axis=0)


def _as_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


def foreach(body, data, init_states):
    """``body(data_t, states) -> (outputs, new_states)`` over axis 0 of
    *data*; returns the stacked outputs and the final states."""
    data_l = _as_list(data)
    states = init_states
    data_scalar = not isinstance(data, (list, tuple))
    outputs = None
    outs_scalar = True
    for t in range(data_l[0].shape[0]):
        slices = [d[t] for d in data_l]
        outs, states = body(slices[0] if data_scalar else slices, states)
        outs_scalar = not isinstance(outs, (list, tuple))
        outs_l = _as_list(outs)
        if outputs is None:
            outputs = [[] for _ in outs_l]
        for acc, o in zip(outputs, outs_l):
            acc.append(o)
    stacked = [_stack(acc) for acc in (outputs or [])]
    result = stacked[0] if outs_scalar and len(stacked) == 1 else stacked
    return result, states


def while_loop(cond, func, loop_vars, max_iterations=None):
    """Run ``func(*loop_vars) -> (outputs, new_loop_vars)`` while
    ``cond(*loop_vars)`` holds (at most *max_iterations* times); returns
    the stacked outputs of the steps run and the final loop_vars."""
    lvars = _as_list(loop_vars)
    lscalar = not isinstance(loop_vars, (list, tuple))
    outputs = None
    steps = 0
    while bool(cond(*lvars).asnumpy().reshape(())):
        if max_iterations is not None and steps >= max_iterations:
            break
        outs, new_vars = func(*lvars)
        lvars = _as_list(new_vars)
        outs_l = _as_list(outs)
        if outputs is None:
            outputs = [[] for _ in outs_l]
        for acc, o in zip(outputs, outs_l):
            acc.append(o)
        steps += 1
    stacked = [_stack(acc) for acc in (outputs or [])]
    result = stacked[0] if len(stacked) == 1 else stacked
    return result, (lvars[0] if lscalar and len(lvars) == 1 else lvars)


def cond(pred, then_func, else_func):
    """``then_func()`` if the scalar NDArray *pred* is nonzero, else
    ``else_func()``."""
    if bool(pred.asnumpy().reshape(())):
        return then_func()
    return else_func()


def rand_zipfian(true_classes, num_sampled, range_max, ctx=None):
    """Log-uniform (Zipfian) candidate sampler: *num_sampled* candidates
    drawn with replacement from P(c) = (log(c + 2) - log(c + 1)) /
    log(range_max + 1); returns (samples, expected count of each true
    class, expected count of each sample), the expected count being
    P(c) * num_sampled.  The samples are int32 (the reference's int64
    narrowed, as ``nd.array`` narrows int64 data); the uniform draws
    come from ``nd.random`` on *ctx* (default: *true_classes*'
    context)."""
    ctx = ctx or true_classes.context
    log_range = _np.log(range_max + 1)
    u = _random.uniform(0, 1, (int(num_sampled),), ctx=ctx).asnumpy()
    sampled = (_np.exp(u.astype(_np.float64) * log_range) - 1).astype(
        _np.int64) % range_max

    def expected(cls):
        cls = _np.asarray(cls, _np.float64)
        p = _np.log((cls + 2.0) / (cls + 1.0)) / log_range
        return (p * num_sampled).astype(_np.float32)

    return (array(sampled, ctx=ctx),
            array(expected(true_classes.asnumpy()), ctx=ctx),
            array(expected(sampled), ctx=ctx))
