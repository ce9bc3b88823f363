"""Symbol — the symbolic graph API (port of ``mxnet_tpu/symbol/symbol.py``).

A Symbol is a small DAG of (op, params, inputs) nodes.  The JSON schema
(``nodes`` / ``arg_nodes`` / ``heads``, every attribute a string) is the
JAX package's, so a graph saved by either package loads in the other.

One difference in what is written: a one-element tuple is written as
``(1,)``, which parses back as a tuple.  The JAX package writes ``(1)``,
which parses back as the int 1; this package accepts both spellings.
A tuple of names is written quoted, and a control-flow op's subgraph as
its own graph JSON, so both read back (the JAX package writes a
subgraph as its repr, which no reader can rebuild).

Shape inference (``_infer_shapes``, which resolves deferred parameter
shapes at a block's first forward) runs per-op rules where parameter
shapes are deduced bottom-up (FullyConnected, Convolution,
Deconvolution, BatchNorm, LayerNorm, InstanceNorm, Embedding;
``shape_rule`` registers more), and
otherwise runs the op itself on ``meta`` tensors, which carry shapes and
no data.

``simple_bind`` / ``bind`` return an :class:`~mxnet_tpu_torch.executor.
Executor`; binding runs on ``ctx`` (default: the current context, the
card), and raises without CUDA unless the caller passes ``mx.cpu()``.
"""

from __future__ import annotations

import ast
import json
import os
import threading

import numpy as _np
import torch

from ..base import MXNetError, dtype_name, np_dtype
from ..ops import registry as _reg
from ..ops.nn import _tup

__all__ = ["Symbol", "AttrScope", "var", "Variable", "Group", "load",
           "load_json", "shape_rule"]


class _NameManager:
    _tls = threading.local()

    @classmethod
    def get(cls):
        if not hasattr(cls._tls, "inst"):
            cls._tls.inst = cls()
        return cls._tls.inst

    def __init__(self):
        self.counts = {}

    def fresh(self, hint):
        hint = hint.lower().lstrip("_")
        n = self.counts.get(hint, 0)
        self.counts[hint] = n + 1
        return "%s%d" % (hint, n)


class AttrScope:
    """Scoped symbol attributes: ops and variables created inside ``with
    AttrScope(ctx_group='dev1'):`` carry them (reference:
    python/mxnet/attribute.py)."""

    _tls = threading.local()

    def __init__(self, **attrs):
        self._attrs = attrs

    @classmethod
    def current_attrs(cls):
        merged = {}
        for scope in getattr(cls._tls, "stack", None) or ():
            merged.update(scope._attrs)
        return merged

    def __enter__(self):
        if not hasattr(self._tls, "stack"):
            self._tls.stack = []
        self._tls.stack.append(self)
        return self

    def __exit__(self, *exc):
        self._tls.stack.pop()


class Node:
    """One graph node: a variable (op is None) or an op invocation."""

    __slots__ = ("op", "name", "params", "inputs", "attrs")

    def __init__(self, op, name, params=None, inputs=(), attrs=None):
        self.op = op
        self.name = name
        self.params = dict(params or {})
        self.inputs = list(inputs)      # [(Node, out_idx), ...]
        self.attrs = dict(attrs or {})

    @property
    def is_var(self):
        return self.op is None

    def num_outputs(self):
        return 1 if self.is_var else self.op.n_out(self.params)


class Symbol:
    """An ordered list of graph output entries."""

    __slots__ = ("_outputs",)

    def __init__(self, outputs):
        self._outputs = list(outputs)   # [(Node, out_idx)]

    # -- composition -------------------------------------------------------
    def __getitem__(self, idx):
        if isinstance(idx, str):
            idx = self.list_outputs().index(idx)
        if isinstance(idx, slice):
            return Symbol(self._outputs[idx])
        return Symbol([self._outputs[idx]])

    def __len__(self):
        return len(self._outputs)

    def __iter__(self):
        for i in range(len(self._outputs)):
            yield self[i]

    @property
    def name(self):
        return self._outputs[0][0].name

    def attr(self, key):
        return self._outputs[0][0].attrs.get(key)

    def _set_attr(self, **kwargs):
        self._outputs[0][0].attrs.update(kwargs)

    # -- arithmetic (the NDArray operator set) -----------------------------
    def __add__(self, other):
        return _sym_binary("broadcast_add", "_plus_scalar", self, other)

    def __radd__(self, other):
        return self.__add__(other)

    def __sub__(self, other):
        return _sym_binary("broadcast_sub", "_minus_scalar", self, other)

    def __rsub__(self, other):
        return _sym_invoke("_rminus_scalar", [self], {"scalar": float(other)})

    def __mul__(self, other):
        return _sym_binary("broadcast_mul", "_mul_scalar", self, other)

    def __rmul__(self, other):
        return self.__mul__(other)

    def __truediv__(self, other):
        return _sym_binary("broadcast_div", "_div_scalar", self, other)

    def __rtruediv__(self, other):
        return _sym_invoke("_rdiv_scalar", [self], {"scalar": float(other)})

    def __pow__(self, other):
        return _sym_binary("broadcast_power", "_power_scalar", self, other)

    def __neg__(self):
        return _sym_invoke("negative", [self], {})

    def __eq__(self, other):
        return _sym_binary("broadcast_equal", "_equal_scalar", self, other)

    def __ne__(self, other):
        return _sym_binary("broadcast_not_equal", "_not_equal_scalar", self,
                           other)

    def __gt__(self, other):
        return _sym_binary("broadcast_greater", "_greater_scalar", self,
                           other)

    def __ge__(self, other):
        return _sym_binary("broadcast_greater_equal",
                           "_greater_equal_scalar", self, other)

    def __lt__(self, other):
        return _sym_binary("broadcast_lesser", "_lesser_scalar", self, other)

    def __le__(self, other):
        return _sym_binary("broadcast_lesser_equal", "_lesser_equal_scalar",
                           self, other)

    __hash__ = object.__hash__

    def __repr__(self):
        return "<Symbol %s>" % ", ".join(
            "%s[%d]" % (n.name, i) for n, i in self._outputs)

    # -- op methods (the NDArray method set) ------------------------------
    def sum(self, axis=None, keepdims=False):
        return _sym_invoke("sum", [self], {"axis": axis,
                                           "keepdims": keepdims})

    def mean(self, axis=None, keepdims=False):
        return _sym_invoke("mean", [self], {"axis": axis,
                                            "keepdims": keepdims})

    def max(self, axis=None, keepdims=False):
        return _sym_invoke("max", [self], {"axis": axis,
                                           "keepdims": keepdims})

    def min(self, axis=None, keepdims=False):
        return _sym_invoke("min", [self], {"axis": axis,
                                           "keepdims": keepdims})

    def prod(self, axis=None, keepdims=False):
        return _sym_invoke("prod", [self], {"axis": axis,
                                            "keepdims": keepdims})

    def reshape(self, *shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        shape = kwargs.get("shape", shape)
        return _sym_invoke("Reshape", [self],
                           {"shape": tuple(shape),
                            "reverse": kwargs.get("reverse", False)})

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (tuple, list)):
            axes = tuple(axes[0])
        return _sym_invoke("transpose", [self], {"axes": axes or None})

    def flatten(self):
        return _sym_invoke("Flatten", [self], {})

    def expand_dims(self, axis):
        return _sym_invoke("expand_dims", [self], {"axis": axis})

    def squeeze(self, axis=None):
        return _sym_invoke("squeeze", [self], {"axis": axis})

    def swapaxes(self, dim1, dim2):
        return _sym_invoke("SwapAxis", [self], {"dim1": dim1, "dim2": dim2})

    def slice_axis(self, axis, begin, end):
        return _sym_invoke("slice_axis", [self],
                           {"axis": axis, "begin": begin, "end": end})

    def clip(self, a_min=None, a_max=None):
        return _sym_invoke("clip", [self], {"a_min": a_min, "a_max": a_max})

    def dot(self, other, transpose_a=False, transpose_b=False):
        return _sym_invoke("dot", [self, other],
                           {"transpose_a": transpose_a,
                            "transpose_b": transpose_b})

    def exp(self):
        return _sym_invoke("exp", [self], {})

    def log(self):
        return _sym_invoke("log", [self], {})

    def sqrt(self):
        return _sym_invoke("sqrt", [self], {})

    def square(self):
        return _sym_invoke("square", [self], {})

    def abs(self):
        return _sym_invoke("abs", [self], {})

    def sign(self):
        return _sym_invoke("sign", [self], {})

    def relu(self):
        return _sym_invoke("relu", [self], {})

    def sigmoid(self):
        return _sym_invoke("sigmoid", [self], {})

    def tanh(self):
        return _sym_invoke("tanh", [self], {})

    def softmax(self, axis=-1):
        return _sym_invoke("softmax", [self], {"axis": axis})

    def log_softmax(self, axis=-1):
        return _sym_invoke("log_softmax", [self], {"axis": axis})

    def argmax(self, axis=None, keepdims=False):
        return _sym_invoke("argmax", [self], {"axis": axis,
                                              "keepdims": keepdims})

    def argmin(self, axis=None, keepdims=False):
        return _sym_invoke("argmin", [self], {"axis": axis,
                                              "keepdims": keepdims})

    def astype(self, dtype):
        return _sym_invoke("Cast", [self], {"dtype": dtype_name(dtype)})

    def take(self, indices, axis=0, mode="clip"):
        return _sym_invoke("take", [self, indices],
                           {"axis": axis, "mode": mode})

    def split(self, num_outputs, axis=1, squeeze_axis=False):
        return _sym_invoke("SliceChannel", [self],
                           {"num_outputs": num_outputs, "axis": axis,
                            "squeeze_axis": squeeze_axis})

    def norm(self, ord=2, axis=None, keepdims=False):
        return _sym_invoke("norm", [self], {"ord": ord, "axis": axis,
                                            "keepdims": keepdims})

    # -- graph queries -----------------------------------------------------
    def _topo(self):
        """Post-order DFS (nnvm's topological order)."""
        seen = set()
        order = []

        def visit(node):
            if id(node) in seen:
                return
            seen.add(id(node))
            for src, _i in node.inputs:
                visit(src)
            order.append(node)

        for n, _i in self._outputs:
            visit(n)
        return order

    def _aux_var_ids(self):
        aux = set()
        for node in self._topo():
            if node.is_var:
                continue
            for in_idx in node.op.aux_states:
                if in_idx < len(node.inputs):
                    src, _ = node.inputs[in_idx]
                    if src.is_var:
                        aux.add(id(src))
        return aux

    def list_arguments(self):
        aux = self._aux_var_ids()
        return [n.name for n in self._topo() if n.is_var and id(n) not in aux]

    def list_auxiliary_states(self):
        aux = self._aux_var_ids()
        return [n.name for n in self._topo() if n.is_var and id(n) in aux]

    def list_inputs(self):
        return [n.name for n in self._topo() if n.is_var]

    def get_internals(self):
        return Symbol([(node, i) for node in self._topo()
                       for i in range(node.num_outputs())])

    def get_children(self):
        node = self._outputs[0][0]
        if not node.inputs:
            return None
        return Symbol(list(node.inputs))

    # -- shape and type inference -----------------------------------------
    def infer_shape(self, *args, **kwargs):
        """(argument shapes, output shapes, auxiliary shapes) from the
        given argument shapes (positional in ``list_arguments`` order, or
        by name); raises when an argument stays unknown."""
        return self._infer_shape_impl(False, *args, **kwargs)

    def infer_shape_partial(self, *args, **kwargs):
        """As :meth:`infer_shape`, with None where a shape stays unknown."""
        return self._infer_shape_impl(True, *args, **kwargs)

    def _infer_shape_impl(self, partial, *args, **kwargs):
        known = {}
        for name, shp in zip(self.list_arguments(), args):
            if shp is not None:
                known[name] = tuple(shp)
        known.update({k: tuple(v) for k, v in kwargs.items()})
        node_sh, var_sh = _infer_shapes(self, known, partial=partial)
        return ([var_sh.get(n) for n in self.list_arguments()],
                [node_sh.get((id(n), i)) for n, i in self._outputs],
                [var_sh.get(n) for n in self.list_auxiliary_states()])

    def infer_type(self, *args, **kwargs):
        """(argument, output, auxiliary) numpy dtypes: the given ones, and
        float32 for everything else (the reference's behavior)."""
        known = {}
        for name, dt in zip(self.list_arguments(), args):
            if dt is not None:
                known[name] = np_dtype(dt)
        known.update({k: np_dtype(v) for k, v in kwargs.items()})
        f32 = _np.dtype("float32")
        return ([known.get(n, f32) for n in self.list_arguments()],
                [f32] * len(self._outputs),
                [known.get(n, f32) for n in self.list_auxiliary_states()])

    def list_outputs(self):
        names = []
        for node, idx in self._outputs:
            if node.is_var:
                names.append(node.name)
            elif node.num_outputs() == 1:
                names.append(node.name + "_output")
            else:
                names.append("%s_output%d" % (node.name, idx))
        return names

    # -- serialization -----------------------------------------------------
    def tojson(self):
        """Graph JSON in the reference's schema (values stringified like
        dmlc params)."""
        order = self._topo()
        nid = {id(n): i for i, n in enumerate(order)}
        nodes = []
        for n in order:
            entry = {
                "op": "null" if n.is_var else n.op.name,
                "name": n.name,
                "inputs": [[nid[id(s)], i, 0] for (s, i) in n.inputs],
            }
            attrs = {k: _stringify(v) for k, v in n.params.items()}
            attrs.update({"__%s__" % k: _stringify(v)
                          for k, v in n.attrs.items()})
            if attrs:
                entry["attrs"] = attrs
            nodes.append(entry)
        return json.dumps({
            "nodes": nodes,
            "arg_nodes": [nid[id(n)] for n in order if n.is_var],
            "node_row_ptr": list(range(len(order) + 1)),
            "heads": [[nid[id(n)], i, 0] for (n, i) in self._outputs],
            "attrs": {"mxnet_version": ["int", 10301],
                      "framework": ["str", "mxnet_tpu_torch"]},
        }, indent=2)

    def save(self, fname):
        """Write :meth:`tojson` to *fname* (beside it, then renamed over
        it, so a crash never leaves a torn graph)."""
        tmp = "%s.tmp%d" % (fname, os.getpid())
        with open(tmp, "w") as f:
            f.write(self.tojson())
        os.replace(tmp, fname)

    # -- binding -----------------------------------------------------------
    def simple_bind(self, ctx=None, grad_req="write", type_dict=None,
                    stype_dict=None, group2ctx=None, shared_arg_names=None,
                    shared_exec=None, shared_buffer=None, **kwargs):
        """An Executor with zero-filled arguments of the shapes inferred
        from *kwargs* (``data=(8, 20)``), on *ctx* (default: the current
        context)."""
        from ..executor import Executor
        return Executor._simple_bind(self, ctx, grad_req, type_dict, kwargs,
                                     shared_exec=shared_exec,
                                     group2ctx=group2ctx)

    def bind(self, ctx=None, args=None, args_grad=None, grad_req="write",
             aux_states=None, group2ctx=None, shared_exec=None):
        """An Executor over the given argument arrays (a list in
        ``list_arguments`` order, or a dict)."""
        from ..executor import Executor
        return Executor._bind(self, ctx, args, args_grad, grad_req,
                              aux_states, group2ctx=group2ctx)

    def eval(self, ctx=None, **kwargs):
        return self.bind(ctx, kwargs).forward()

    def tojson_str(self):
        return self.tojson()


def _stringify(v):
    if isinstance(v, str):
        return v
    if isinstance(v, Symbol):
        # a control-flow op's subgraph: its own graph JSON
        return v.tojson()
    if isinstance(v, (tuple, list)):
        if any(isinstance(x, str) for x in v):
            return repr(tuple(v))       # names: quoted, so they parse back
        if len(v) == 1:
            return "(%s,)" % (v[0],)
        return "(" + ", ".join(str(x) for x in v) + ")"
    return str(v)


def _parse_attr(v):
    if not isinstance(v, str):
        return v
    try:
        v = ast.literal_eval(v)
    except (ValueError, SyntaxError):
        if v in ("True", "False"):
            return v == "True"
        return v
    if isinstance(v, dict) and "nodes" in v and "heads" in v:
        return load_json(json.dumps(v))     # a subgraph's graph JSON
    return v


def var(name, attr=None, shape=None, lr_mult=None, wd_mult=None, dtype=None,
        init=None, **kwargs):
    """A variable symbol (attributes of the enclosing AttrScopes first)."""
    attrs = dict(AttrScope.current_attrs())
    attrs.update(attr or {})
    if shape is not None:
        attrs["__shape__"] = tuple(shape)
    if dtype is not None:
        attrs["__dtype__"] = dtype_name(dtype)
    if lr_mult is not None:
        attrs["__lr_mult__"] = lr_mult
    if wd_mult is not None:
        attrs["__wd_mult__"] = wd_mult
    if init is not None:
        attrs["__init__"] = init if isinstance(init, str) else \
            init.__class__.__name__
    attrs.update(kwargs)
    return Symbol([(Node(None, name, attrs=attrs), 0)])


Variable = var


def Group(symbols):
    outs = []
    for s in symbols:
        outs.extend(s._outputs)
    return Symbol(outs)


def load(fname):
    with open(fname) as f:
        return load_json(f.read())


def load_json(json_str):
    data = json.loads(json_str)
    nodes = []
    for entry in data["nodes"]:
        attrs = entry.get("attrs", entry.get("param", {})) or {}
        params = {}
        uattrs = {}
        for k, v in attrs.items():
            if k.startswith("__") and k.endswith("__"):
                uattrs[k[2:-2]] = _parse_attr(v)
            else:
                params[k] = _parse_attr(v)
        if entry["op"] == "null":
            node = Node(None, entry["name"], attrs=dict(params, **uattrs))
        else:
            node = Node(_reg.get_op(entry["op"]), entry["name"],
                        params=params, attrs=uattrs)
        node.inputs = [(nodes[i], j) for i, j, _ in entry["inputs"]]
        nodes.append(node)
    return Symbol([(nodes[i], j) for i, j, _ in data["heads"]])


def _sym_invoke(op_name, sym_inputs, params, name=None, attr=None):
    """Compose op *op_name* over *sym_inputs*.  A None entry, and every
    missing trailing input, becomes a fresh variable ``<name>_<input
    name>`` (reference behavior: ``sym.FullyConnected(x, num_hidden=8)``
    creates its weight).  The node and its new variables carry the
    enclosing AttrScopes' attributes."""
    op = _reg.get_op(op_name)
    params = {k: v for k, v in params.items() if v is not None}
    if name is None:
        name = _NameManager.get().fresh(op.name)
    input_names = op.input_names_for(params)
    scope_attrs = AttrScope.current_attrs()

    def fresh_var(i):
        nm = input_names[i] if i < len(input_names) else "in%d" % i
        return (Node(None, "%s_%s" % (name, nm), attrs=dict(scope_attrs)), 0)

    entries = []
    for i, s in enumerate(sym_inputs):
        if s is None:
            entries.append(fresh_var(i))
            continue
        if len(s._outputs) != 1:
            raise ValueError("op inputs must be single-output symbols")
        entries.append(s._outputs[0])
    for i in range(len(entries), len(input_names)):
        entries.append(fresh_var(i))
    node_attrs = dict(scope_attrs)
    node_attrs.update(attr or {})
    node = Node(op, name, params=params, inputs=entries, attrs=node_attrs)
    return Symbol([(node, i) for i in range(op.n_visible(params))])


def _sym_binary(op_name, scalar_op, lhs, rhs):
    if isinstance(rhs, Symbol):
        return _sym_invoke(op_name, [lhs, rhs], {})
    return _sym_invoke(scalar_op, [lhs], {"scalar": float(rhs)})


# ---------------------------------------------------------------------------
# shape inference
# ---------------------------------------------------------------------------

# rule(params, in_shapes) -> (in_shapes, out_shapes) for ops whose
# parameter shapes are deduced bottom-up (the reference's FInferShape);
# in_shapes entries may start as None
_SHAPE_RULES = {}


def shape_rule(name):
    """Register a shape rule for op *name* (decorator)."""
    def _reg_rule(fn):
        _SHAPE_RULES[name] = fn
        return fn
    return _reg_rule


def _as_shape(s):
    return (s,) if isinstance(s, int) else tuple(s)


@shape_rule("FullyConnected")
def _fc_shape(params, ins):
    data = ins[0]
    nh = int(params.get("num_hidden", 0))
    if data is None:
        return ins, [None]
    if params.get("flatten", True):
        in_units = 1
        for d in data[1:]:
            in_units *= d
        out = (data[0], nh)
    else:
        in_units = data[-1]
        out = tuple(data[:-1]) + (nh,)
    ins = list(ins)
    ins[1] = (nh, in_units)
    if len(ins) > 2:
        ins[2] = (nh,)
    return ins, [out]


@shape_rule("Convolution")
def _conv_shape(params, ins):
    """Convolution: weight (num_filter, C / num_group, *kernel), bias
    (num_filter,), and the output's spatial extent from stride, pad and
    dilation (mirrors ``mxnet_tpu/symbol/symbol.py`` ``_conv_shape``)."""
    kernel = _as_shape(params.get("kernel", ()))
    nd = len(kernel)
    nf = int(params.get("num_filter", 0))
    ng = int(params.get("num_group", 1))
    stride = _tup(params.get("stride"), nd, 1)
    dilate = _tup(params.get("dilate"), nd, 1)
    pad = _tup(params.get("pad"), nd, 0)
    data = ins[0]
    if data is None:
        return ins, [None]
    ins = list(ins)
    ins[1] = (nf, data[1] // ng) + kernel
    if len(ins) > 2:
        ins[2] = (nf,)
    spatial = tuple(
        (data[2 + i] + 2 * pad[i] - ((kernel[i] - 1) * dilate[i] + 1))
        // stride[i] + 1 for i in range(nd))
    return ins, [(data[0], nf) + spatial]


@shape_rule("Deconvolution")
def _deconv_shape(params, ins):
    """Deconvolution: weight (C, num_filter / num_group, *kernel), bias
    (num_filter,), each spatial extent (in - 1) * stride - 2 * pad +
    dilate * (kernel - 1) + 1 + adj (mirrors ``mxnet_tpu/symbol/
    symbol.py`` ``_deconv_shape``)."""
    kernel = _as_shape(params.get("kernel", ()))
    nd = len(kernel)
    nf = int(params.get("num_filter", 0))
    ng = int(params.get("num_group", 1))
    stride = _tup(params.get("stride"), nd, 1)
    dilate = _tup(params.get("dilate"), nd, 1)
    pad = _tup(params.get("pad"), nd, 0)
    adj = _tup(params.get("adj"), nd, 0)
    data = ins[0]
    if data is None:
        return ins, [None]
    ins = list(ins)
    ins[1] = (data[1], nf // ng) + kernel
    if len(ins) > 2:
        ins[2] = (nf,)
    spatial = tuple(
        (data[2 + i] - 1) * stride[i] - 2 * pad[i] +
        (kernel[i] - 1) * dilate[i] + 1 + adj[i] for i in range(nd))
    return ins, [(data[0], nf) + spatial]


@shape_rule("BatchNorm")
def _bn_shape(params, ins):
    """BatchNorm: gamma, beta and both moving statistics are (C,), C the
    data's extent on ``axis``; outputs (data, C, C, C, C)."""
    data = ins[0]
    if data is None:
        return ins, [None] * 5
    c = (data[int(params.get("axis", 1)) % len(data)],)
    ins = [data] + [c] * (len(ins) - 1)
    return ins, [data, c, c, c, c]


@shape_rule("LayerNorm")
def _ln_shape(params, ins):
    data = ins[0]
    if data is None:
        return ins, [None] * 3
    axis = int(params.get("axis", -1)) % len(data)
    ins = list(ins)
    ins[1] = ins[2] = (data[axis],)
    red = tuple(d for i, d in enumerate(data) if i != axis)
    return ins, [data, red, red]


@shape_rule("Embedding")
def _emb_shape(params, ins):
    ins = list(ins)
    ins[1] = (int(params["input_dim"]), int(params["output_dim"]))
    if ins[0] is None:
        return ins, [None]
    return ins, [tuple(ins[0]) + (int(params["output_dim"]),)]


def _chan_param_shape(params, ins, n_extra):
    """Inputs 1..n_extra are (C,), C the data's extent on ``axis``."""
    data = ins[0]
    if data is None:
        return ins, [None]
    c = (data[int(params.get("axis", 1)) % len(data)],)
    ins = list(ins)
    for i in range(1, min(1 + n_extra, len(ins))):
        ins[i] = c
    return ins, [data]


@shape_rule("InstanceNorm")
def _in_shape(params, ins):
    return _chan_param_shape(params, ins, 2)


@shape_rule("RNN")
def _rnn_shape(params, ins):
    """Fused RNN: the packed parameter vector's length and the state
    shapes (L * dirs, B, H) from the (T, B, F) data shape."""
    from ..ops.rnn import rnn_param_size
    mode = params.get("mode", "lstm")
    n_out = 1
    if params.get("state_outputs", False):
        n_out += 2 if mode == "lstm" else 1
    data = ins[0]
    if data is None:
        return ins, [None] * n_out
    h = int(params.get("state_size", 0))
    layers = int(params.get("num_layers", 1))
    bidir = bool(params.get("bidirectional", False))
    dirs = 2 if bidir else 1
    t, b, f = data
    ins = list(ins)
    ins[1] = (rnn_param_size(mode, f, h, layers, bidir),)
    state_shape = (layers * dirs, b, h)
    for i in range(2, len(ins)):
        ins[i] = state_shape
    return ins, [(t, b, h * dirs)] + [state_shape] * (n_out - 1)


# Detection ops: every output shape follows from the input shapes, so
# shape inference never runs them (on meta tensors MultiBoxDetection would
# still take its NMS loop and MultiBoxTarget its matching rounds).

@shape_rule("_contrib_MultiBoxPrior")
def _prior_shape(params, ins):
    """(1, H * W * (sizes + ratios - 1), 4) from data (N, C, H, W)."""
    from ..ops.detection import num_priors
    data = ins[0]
    if data is None:
        return ins, [None]
    a = num_priors(params.get("sizes", (1.0,)), params.get("ratios", (1.0,)))
    return ins, [(1, data[2] * data[3] * a, 4)]


@shape_rule("_contrib_MultiBoxTarget")
def _target_shape(params, ins):
    """(N, A * 4) twice and (N, A) from anchor (1, A, 4), label (N, G, 5)
    and cls_pred (N, C, A)."""
    anchor, label, cls_pred = ins
    a = anchor[1] if anchor is not None else \
        (cls_pred[2] if cls_pred is not None else None)
    n = label[0] if label is not None else \
        (cls_pred[0] if cls_pred is not None else None)
    if a is None or n is None:
        return ins, [None] * 3
    return ins, [(n, a * 4), (n, a * 4), (n, a)]


@shape_rule("_contrib_MultiBoxDetection")
def _detection_shape(params, ins):
    """(N, A, 6) from cls_prob (N, C, A)."""
    cls_prob = ins[0]
    if cls_prob is None:
        return ins, [None]
    return ins, [(cls_prob[0], cls_prob[2], 6)]


@shape_rule("_contrib_box_nms")
def _nms_shape(params, ins):
    return ins, [ins[0], ins[0]]


@shape_rule("_contrib_box_iou")
def _iou_shape(params, ins):
    lhs, rhs = ins
    if lhs is None or rhs is None:
        return ins, [None]
    return ins, [tuple(lhs[:-1]) + tuple(rhs[:-1])]


def _roi_shape(params, ins, default=None):
    """(R, C, ph, pw) from data (N, C, H, W) and rois (R, 5)."""
    from ..ops.detection import _seq
    data, rois = ins
    if data is None or rois is None:
        return ins, [None]
    ps = _seq(params.get("pooled_size", default))
    ph, pw = (ps * 2 if len(ps) == 1 else ps)[:2]
    return ins, [(rois[0], data[1], int(ph), int(pw))]


@shape_rule("_contrib_ROIAlign")
def _roi_align_shape(params, ins):
    return _roi_shape(params, ins, (7, 7))


@shape_rule("ROIPooling")
def _roi_pool_shape(params, ins):
    return _roi_shape(params, ins)


@shape_rule("_contrib_PSROIPooling")
def _psroi_shape(params, ins):
    data, rois = ins
    if data is None or rois is None:
        return ins, [None]
    k = int(params.get("pooled_size", 0))
    return ins, [(rois[0], int(params.get("output_dim", 0)), k, k)]


@shape_rule("_contrib_Proposal")
def _proposal_shape(params, ins):
    """(N * rpn_post_nms_top_n, 5), and the scores (N * post, 1) with
    output_score, from cls_prob (N, 2A, H, W)."""
    from ..ops.registry import get_op
    n_out = get_op("_contrib_Proposal").n_out(params)
    cls_prob = ins[0]
    if cls_prob is None:
        return ins, [None] * n_out
    rows = cls_prob[0] * int(params.get("rpn_post_nms_top_n", 300))
    return ins, [(rows, 5), (rows, 1)][:n_out]


def _infer_shapes(symbol, known_var_shapes, partial=False):
    """Propagate shapes through the graph.  Returns ({(node_id, out_idx):
    shape}, {var_name: shape}); raises MXNetError when an argument stays
    unknown (unless *partial*)."""
    order = symbol._topo()
    var_sh = dict(known_var_shapes)
    for n in order:
        if n.is_var and "__shape__" in n.attrs and n.name not in var_sh:
            var_sh[n.name] = _as_shape(n.attrs["__shape__"])
    node_sh = {}

    def in_shape(node, i):
        src, idx = node.inputs[i]
        if src.is_var:
            return var_sh.get(src.name)
        return node_sh.get((id(src), idx))

    def set_in_shape(node, i, shp):
        src, _ = node.inputs[i]
        if shp is None or not src.is_var:
            return
        prev = var_sh.get(src.name)
        if prev is not None and tuple(prev) != tuple(shp) and \
                not (len(prev) == len(shp) and
                     all(a in (0, b) for a, b in zip(prev, shp))):
            raise MXNetError("inferred shape %s for %s conflicts with %s"
                             % (shp, src.name, prev))
        var_sh[src.name] = tuple(shp)

    for _ in range(3):
        progress = False
        for node in order:
            if node.is_var:
                continue
            ins = [in_shape(node, i) for i in range(len(node.inputs))]
            rule = _SHAPE_RULES.get(node.op.name)
            if rule is not None:
                ins, outs = rule(node.params, ins)
                for i, shp in enumerate(ins):
                    set_in_shape(node, i, shp)
            elif all(s is not None and 0 not in s for s in ins):
                outs = _eval_shape_op(node, ins)
            elif node.op.name.startswith(("broadcast_", "elemwise_")) and \
                    any(s is not None for s in ins):
                # same shape both ways for elementwise (reference behavior)
                shp = next(s for s in ins if s is not None)
                for i in range(len(ins)):
                    set_in_shape(node, i, shp)
                outs = _eval_shape_op(node, [shp] * len(ins))
            else:
                outs = [None] * node.num_outputs()
            for i, o in enumerate(outs):
                if o is not None and (id(node), i) not in node_sh:
                    node_sh[(id(node), i)] = tuple(o)
                    progress = True
        if not progress:
            break

    if not partial:
        missing = [n.name for n in order if n.is_var and n.name not in var_sh]
        if missing:
            raise MXNetError("cannot infer shapes for arguments: %s"
                             % missing)
    return node_sh, var_sh


def _eval_shape_op(node, in_shapes):
    """Output shapes of one op, by running it on meta tensors."""
    ins = [torch.empty(tuple(s), dtype=torch.float32, device="meta")
           for s in in_shapes]
    if node.op.needs_rng:
        # a random op draws on its data's device: meta, so no draw happens
        ins.insert(0, torch.Generator())
    out = node.op.fn(*ins, **node.params)
    if not isinstance(out, tuple):
        out = (out,)
    return [tuple(o.shape) for o in out]
