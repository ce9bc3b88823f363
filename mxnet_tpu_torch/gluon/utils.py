"""Gluon utilities of the port: carrying weights across from the JAX
package."""

from __future__ import annotations

import numpy as _np

from ..base import MXNetError, dtype_name

__all__ = ["load_jax_params"]


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
