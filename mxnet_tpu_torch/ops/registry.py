"""Operator registry (port of ``mxnet_tpu/ops/registry.py``, subset).

An op is a plain function ``fn(*tensors, **params)`` on ``torch.Tensor``s.
PyTorch runs eagerly, so there is no per-signature compile cache: the
registry only records each op's contract, which the symbol layer, the
executor and the generated ``nd``/``sym`` functions read.
"""

from __future__ import annotations

import inspect

__all__ = ["Op", "register_op", "get_op", "list_ops", "alias"]

_OPS: dict[str, "Op"] = {}


class Op:
    """A registered operator.

    name : canonical op name.
    fn : ``fn(*tensors, **params) -> tensor | tuple``.
    num_outputs : int or ``f(params) -> int``.
    num_visible_outputs : outputs surfaced to users (None: all).
    needs_rng : ``fn``'s first positional arg is a ``torch.Generator``.
    input_names : array-input names (default: positional params without
        defaults, the generator excluded).
    param_names : op parameter names (default: params with defaults, in
        order).  The JAX package registers some ops over a numpy function
        (``broadcast_add`` is ``jnp.add``), whose keywords (``out``,
        ``where``) are its parameter names; such an op declares them.
    active_inputs : optional ``f(params) -> input names`` for ops whose
        params drop an input (FullyConnected with ``no_bias``).
    """

    __slots__ = ("name", "fn", "num_outputs", "needs_rng", "doc",
                 "input_names", "num_visible_outputs", "param_names",
                 "aux_states", "active_inputs")

    def __init__(self, name, fn, num_outputs=1, needs_rng=False, doc=None,
                 input_names=None, num_visible_outputs=None,
                 param_names=None):
        self.name = name
        self.fn = fn
        self.num_outputs = num_outputs
        self.needs_rng = needs_rng
        self.doc = doc or fn.__doc__
        if input_names is None:
            input_names = _infer_input_names(fn, needs_rng)
        self.input_names = tuple(input_names)
        self.num_visible_outputs = num_visible_outputs
        if param_names is None:
            param_names = (
                p.name for p in inspect.signature(fn).parameters.values()
                if p.default is not inspect.Parameter.empty)
        self.param_names = tuple(param_names)
        # {input_idx: output_idx} of mutable auxiliary states (BatchNorm's
        # moving statistics), written back by the executor's caller
        self.aux_states = {}
        self.active_inputs = None

    def input_names_for(self, params):
        if self.active_inputs is None:
            return self.input_names
        return tuple(self.active_inputs(params))

    def n_out(self, params):
        if callable(self.num_outputs):
            return self.num_outputs(params)
        return self.num_outputs

    def n_visible(self, params):
        if self.num_visible_outputs is None:
            return self.n_out(params)
        if callable(self.num_visible_outputs):
            return self.num_visible_outputs(params)
        return self.num_visible_outputs

    def __repr__(self):
        return "Op(%s)" % self.name


def _infer_input_names(fn, needs_rng):
    names = []
    for p in inspect.signature(fn).parameters.values():
        if p.kind in (inspect.Parameter.POSITIONAL_ONLY,
                      inspect.Parameter.POSITIONAL_OR_KEYWORD) \
                and p.default is inspect.Parameter.empty:
            names.append(p.name)
        elif p.kind == inspect.Parameter.VAR_POSITIONAL:
            break
    if needs_rng and names:
        names = names[1:]
    return tuple(names)


def register_op(name, num_outputs=1, needs_rng=False, aliases=(),
                input_names=None, num_visible_outputs=None,
                param_names=None):
    """Decorator registering a function on tensors as an operator."""
    def _reg(fn):
        if name in _OPS:
            raise ValueError("op %r registered twice" % name)
        op = Op(name, fn, num_outputs, needs_rng, input_names=input_names,
                num_visible_outputs=num_visible_outputs,
                param_names=param_names)
        _OPS[name] = op
        for a in aliases:
            _OPS[a] = op
        return fn
    return _reg


def alias(name, target):
    _OPS[name] = _OPS[target]


def get_op(name):
    try:
        return _OPS[name]
    except KeyError:
        raise KeyError("operator %r is not registered" % (name,))


def list_ops():
    return sorted(_OPS)
