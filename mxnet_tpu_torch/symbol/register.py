"""Generate the ``sym.*`` op functions (port of
``mxnet_tpu/symbol/register.py``): ``sym.<Op>(*inputs, name=None,
attr=None, **params)``.  Symbol arguments are inputs, given by position
or by input name (``data=`` addresses an op's first input); other
positional arguments fill the op's parameters in order."""

from __future__ import annotations

from ..ops import registry as _reg
from .symbol import Symbol, _sym_invoke


def _make_fn(op):
    def fn(*args, name=None, attr=None, **kwargs):
        inputs = [a for a in args if isinstance(a, Symbol)]
        pos_params = [a for a in args if not isinstance(a, Symbol)]
        params = {k: v for k, v in kwargs.items()
                  if not isinstance(v, Symbol)}
        named = {k: v for k, v in kwargs.items() if isinstance(v, Symbol)}
        if pos_params:
            free = [p for p in op.param_names if p not in params]
            if len(pos_params) > len(free):
                raise TypeError("%s: too many positional arguments"
                                % op.name)
            params.update(zip(free, pos_params))
        if named:
            input_names = op.input_names_for(params)
            if "data" in named and "data" not in input_names \
                    and input_names and input_names[0] not in named:
                named[input_names[0]] = named.pop("data")
            merged = list(inputs)
            for nm in input_names[len(inputs):]:
                merged.append(named.pop(nm, None))
            while merged and merged[-1] is None:
                merged.pop()
            if named:
                raise TypeError("%s got unexpected Symbol kwargs %s "
                                "(inputs: %s)" % (op.name, sorted(named),
                                                  op.input_names))
            inputs = merged
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
