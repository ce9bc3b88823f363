"""Symbol — the symbolic graph API (port of ``mxnet_tpu/symbol/symbol.py``,
subset).

A Symbol is a small DAG of (op, params, inputs) nodes.  The JSON schema
(``nodes`` / ``arg_nodes`` / ``heads``, every attribute a string) is the
JAX package's, so a graph saved by either package loads in the other.

One difference in what is written: a one-element tuple is written as
``(1,)``, which parses back as a tuple.  The JAX package writes ``(1)``,
which parses back as the int 1; this package accepts both spellings.

Shape inference (``_infer_shapes``, which resolves deferred parameter
shapes at a block's first forward) runs per-op rules where parameter
shapes are deduced bottom-up (FullyConnected, Convolution, BatchNorm,
LayerNorm, Embedding), and
otherwise runs the op itself on ``meta`` tensors, which carry shapes and
no data.
"""

from __future__ import annotations

import ast
import json
import os
import threading

import torch

from ..base import MXNetError, dtype_name
from ..ops import registry as _reg
from ..ops.nn import _tup

__all__ = ["Symbol", "var", "Variable", "Group", "load", "load_json"]


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

    @property
    def name(self):
        return self._outputs[0][0].name

    def __add__(self, other):
        if not isinstance(other, Symbol):
            raise TypeError("Symbol + %s is not ported" % type(other))
        return _sym_invoke("broadcast_add", [self, other], {})

    def __radd__(self, other):
        return self.__add__(other)

    def __mul__(self, other):
        if isinstance(other, Symbol):
            return _sym_invoke("broadcast_mul", [self, other], {})
        if isinstance(other, (int, float)):
            return _sym_invoke("_mul_scalar", [self],
                               {"scalar": float(other)})
        raise TypeError("Symbol * %s is not ported" % type(other))

    def __rmul__(self, other):
        return self.__mul__(other)

    def __neg__(self):
        return _sym_invoke("negative", [self], {})

    __hash__ = object.__hash__

    def __repr__(self):
        return "<Symbol %s>" % ", ".join(
            "%s[%d]" % (n.name, i) for n, i in self._outputs)

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


def _stringify(v):
    if isinstance(v, str):
        return v
    if isinstance(v, (tuple, list)):
        if len(v) == 1:
            return "(%s,)" % (v[0],)
        return "(" + ", ".join(str(x) for x in v) + ")"
    return str(v)


def _parse_attr(v):
    if not isinstance(v, str):
        return v
    try:
        return ast.literal_eval(v)
    except (ValueError, SyntaxError):
        if v in ("True", "False"):
            return v == "True"
        return v


def var(name, attr=None, shape=None, lr_mult=None, wd_mult=None, dtype=None,
        init=None, **kwargs):
    """A variable symbol."""
    attrs = dict(attr or {})
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
    """Compose op *op_name* over *sym_inputs*; a missing trailing input
    becomes a fresh variable ``<name>_<input name>`` (reference behavior:
    ``sym.FullyConnected(x, num_hidden=8)`` creates its weight)."""
    op = _reg.get_op(op_name)
    params = {k: v for k, v in params.items() if v is not None}
    if name is None:
        name = _NameManager.get().fresh(op.name)
    input_names = op.input_names_for(params)
    entries = []
    for s in sym_inputs:
        if len(s._outputs) != 1:
            raise ValueError("op inputs must be single-output symbols")
        entries.append(s._outputs[0])
    for nm in input_names[len(entries):]:
        entries.append((Node(None, "%s_%s" % (name, nm)), 0))
    node = Node(op, name, params=params, inputs=entries, attrs=attr)
    return Symbol([(node, i) for i in range(op.n_visible(params))])


# ---------------------------------------------------------------------------
# shape inference
# ---------------------------------------------------------------------------

def _as_shape(s):
    return (s,) if isinstance(s, int) else tuple(s)


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


def _bn_shape(params, ins):
    """BatchNorm: gamma, beta and both moving statistics are (C,), C the
    data's extent on ``axis``; outputs (data, C, C, C, C)."""
    data = ins[0]
    if data is None:
        return ins, [None] * 5
    c = (data[int(params.get("axis", 1)) % len(data)],)
    ins = [data] + [c] * (len(ins) - 1)
    return ins, [data, c, c, c, c]


def _ln_shape(params, ins):
    data = ins[0]
    if data is None:
        return ins, [None] * 3
    axis = int(params.get("axis", -1)) % len(data)
    ins = list(ins)
    ins[1] = ins[2] = (data[axis],)
    red = tuple(d for i, d in enumerate(data) if i != axis)
    return ins, [data, red, red]


def _emb_shape(params, ins):
    ins = list(ins)
    ins[1] = (int(params["input_dim"]), int(params["output_dim"]))
    if ins[0] is None:
        return ins, [None]
    return ins, [tuple(ins[0]) + (int(params["output_dim"]),)]


# rule(params, in_shapes) -> (in_shapes, out_shapes) for ops whose
# parameter shapes are deduced bottom-up (the reference's FInferShape)
_SHAPE_RULES = {"FullyConnected": _fc_shape, "Convolution": _conv_shape,
                "BatchNorm": _bn_shape, "LayerNorm": _ln_shape,
                "Embedding": _emb_shape}


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
