"""Gluon utilities (port of ``mxnet_tpu/gluon/utils.py``: split_data,
split_and_load, clip_global_norm), and carrying weights across from the
JAX package."""

from __future__ import annotations

import math
import warnings

import numpy as _np

from .. import ndarray as nd
from ..base import MXNetError, dtype_name
from ..ndarray import NDArray

__all__ = ["split_data", "split_and_load", "clip_global_norm",
           "load_jax_params"]


def split_data(data, num_slice, batch_axis=0, even_split=True):
    """*data* cut into *num_slice* slices along *batch_axis* (the last
    takes the remainder unless *even_split* demands none)."""
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise ValueError(
            "data with shape %s cannot be evenly split into %d slices "
            "along axis %d. Use a batch size that's multiple of %d or set "
            "even_split=False to allow uneven partitioning of data." %
            (str(data.shape), num_slice, batch_axis, num_slice))
    if num_slice == 1:
        return [data]
    step = size // num_slice
    return [data.slice_axis(batch_axis, i * step,
                            (i + 1) * step if i < num_slice - 1 else size)
            for i in range(num_slice)]


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """*data* (an NDArray or array-like) split into one slice per context
    of *ctx_list*, each placed on its context."""
    if not isinstance(data, NDArray):
        data = nd.array(data, ctx=ctx_list[0])
    if len(ctx_list) == 1:
        return [data.as_in_context(ctx_list[0])]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [s.as_in_context(ctx) for s, ctx in zip(slices, ctx_list)]


def clip_global_norm(arrays, max_norm, check_isfinite=True):
    """Scale *arrays* (rebinding each) so that their joint 2-norm is at
    most *max_norm*; returns the norm before scaling."""
    assert len(arrays) > 0
    total = 0.0
    for arr in arrays:
        total += float((arr * arr).sum().asscalar())
    total_norm = math.sqrt(total)
    if check_isfinite and not _np.isfinite(total_norm):
        warnings.warn("nan or inf is detected. Clipping results will be "
                      "undefined.", stacklevel=2)
    scale = max_norm / (total_norm + 1e-8)
    if scale < 1.0:
        for arr in arrays:
            arr *= scale
    return total_norm


def load_jax_params(net, params):
    """Set *net*'s parameters from ``{name: array}`` as the JAX package
    names them: the keys of its ``collect_params()`` (values taken with
    ``.data().asnumpy()``), or a JAX ``.params`` file loaded with
    ``nd.load`` (``arg:`` / ``aux:`` prefixes are dropped).

    Names, shapes and dtypes are checked: a missing or extra name, a
    shape that disagrees, or a dtype other than the parameter's raises
    ``MXNetError``.  Parameters whose shape was deferred take the given
    shape and are created on their initialization context."""
    given = {}
    for k, v in params.items():
        if k.startswith(("arg:", "aux:")):
            k = k[4:]
        if hasattr(v, "asnumpy"):     # an NDArray of either package
            v = v.asnumpy()
        given[k] = _np.asarray(v)
    mine = dict(net.collect_params().items())
    missing = sorted(set(mine) - set(given))
    extra = sorted(set(given) - set(mine))
    if missing or extra:
        raise MXNetError("load_jax_params: missing %s, extra %s"
                         % (missing, extra))
    for name, p in mine.items():
        arr = given[name]
        if dtype_name(arr.dtype) != p.dtype:
            raise MXNetError("load_jax_params: %s has dtype %s, the "
                             "parameter is %s" % (name, arr.dtype, p.dtype))
        if p.shape is not None and not (
                len(p.shape) == arr.ndim and
                all(a in (0, b) for a, b in zip(p.shape, arr.shape))):
            raise MXNetError("load_jax_params: %s has shape %s, the "
                             "parameter is %s" % (name, arr.shape, p.shape))
        if p._data is None and p._deferred_init is None:
            raise MXNetError("load_jax_params: %s is not initialized; call "
                             "net.initialize(ctx=...) first" % name)
        p.set_data(arr)
