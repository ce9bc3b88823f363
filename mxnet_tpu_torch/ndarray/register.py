"""Generate the ``nd.*`` op functions from the registry (port of
``mxnet_tpu/ndarray/register.py``): ``nd.<Op>(*inputs, out=None,
**params)``.  Inputs may be passed positionally or by their declared
names (``nd.FullyConnected(data=x, weight=w, num_hidden=10)``); a
positional argument that is not an NDArray fills the op's next free
parameter (``nd.one_hot(indices, 4)``, ``nd.reshape(x, (0, -1))``).
``ctx=`` places the result of an op with no array input."""

from __future__ import annotations

from ..ops import registry as _reg
from .ndarray import NDArray, imperative_invoke


def _make_fn(op):
    def fn(*args, out=None, name=None, ctx=None, **kwargs):
        inputs = [a for a in args if isinstance(a, NDArray)]
        pos_params = [a for a in args if not isinstance(a, NDArray)]
        named = {k: v for k, v in kwargs.items() if isinstance(v, NDArray)}
        params = {k: v for k, v in kwargs.items()
                  if not isinstance(v, NDArray)}
        if pos_params:
            free = [p for p in op.param_names if p not in params]
            if len(pos_params) > len(free):
                raise TypeError("%s: too many positional arguments"
                                % op.name)
            params.update(zip(free, pos_params))
        for nm in op.input_names[len(inputs):]:
            if nm in named:
                inputs.append(named.pop(nm))
        if named:
            raise TypeError("%s got unexpected NDArray kwargs %s (inputs: "
                            "%s)" % (op.name, sorted(named), op.input_names))
        return imperative_invoke(op.name, *inputs, out=out, ctx=ctx,
                                 **params)

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
