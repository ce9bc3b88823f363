"""Generate the ``nd.*`` op functions from the registry (port of
``mxnet_tpu/ndarray/register.py``): ``nd.<Op>(*input_arrays, out=None,
**params)``."""

from __future__ import annotations

from ..ops import registry as _reg
from .ndarray import imperative_invoke


def _make_fn(op):
    def fn(*inputs, out=None, name=None, **params):
        return imperative_invoke(op.name, *inputs, out=out, **params)

    fn.__name__ = op.name
    fn.__doc__ = op.doc
    return fn


def populate(namespace):
    """Install one function per registered op into *namespace*."""
    for name in _reg.list_ops():
        namespace[name] = _make_fn(_reg.get_op(name))
    return namespace


def populate_contrib(namespace):
    """``_contrib_*`` ops under their stripped names (``nd.contrib.X``)."""
    for name in _reg.list_ops():
        if name.startswith("_contrib_"):
            namespace.setdefault(name[len("_contrib_"):],
                                 _make_fn(_reg.get_op(name)))
    return namespace
