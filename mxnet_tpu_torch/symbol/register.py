"""Generate the ``sym.*`` op functions (port of
``mxnet_tpu/symbol/register.py``): ``sym.<Op>(*input_symbols, name=None,
**params)``."""

from __future__ import annotations

from ..ops import registry as _reg
from .symbol import _sym_invoke


def _make_fn(op):
    def fn(*inputs, name=None, attr=None, **params):
        return _sym_invoke(op.name, inputs, params, name=name, attr=attr)

    fn.__name__ = op.name
    fn.__doc__ = op.doc
    return fn


def populate(namespace):
    for name in _reg.list_ops():
        namespace[name] = _make_fn(_reg.get_op(name))
    return namespace


def populate_contrib(namespace):
    """``_contrib_*`` ops under their stripped names (``sym.contrib.X``)."""
    for name in _reg.list_ops():
        if name.startswith("_contrib_"):
            namespace.setdefault(name[len("_contrib_"):],
                                 _make_fn(_reg.get_op(name)))
    return namespace
