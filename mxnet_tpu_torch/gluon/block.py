"""Gluon Block / HybridBlock (port of ``mxnet_tpu/gluon/block.py``, subset).

A Block is a ``torch.nn.Module``: child blocks are its submodules, and
``__call__`` runs ``forward`` with PyTorch's hooks.  The gluon naming
scheme is kept (``transformerlm0_h0_dense0_weight``), so
``collect_params()`` yields the JAX package's names for the same model.
Gluon Parameters are not ``torch.nn.Parameter``s: they keep the gluon
surface (deferred shapes, ``data()``, ``set_data``).

``hybridize()`` plus a first forward traces ``hybrid_forward`` with
Symbol proxies into a cached graph (the JAX package's ``_CachedGraph``);
later forwards evaluate that graph with ``executor._build_eval``, the
train graph under ``autograd.is_training()`` and the infer graph
otherwise.  It is also what ``export`` writes.  Without ``hybridize`` the
forward runs ``hybrid_forward`` eagerly with ``F`` = the ``nd`` namespace.

Inside ``autograd.record()`` a forward runs with PyTorch's grad mode on,
so its ops are taped against the parameters' tensors (marked variables);
PyTorch's tape takes the place of the JAX package's per-graph
``jax.vjp``.  Outside it, forwards run under ``no_grad``.

Deferred parameter shapes are resolved by symbolic shape inference over
the traced graph at the first forward, as in the JAX package; where
inference cannot reach them (an RNN layer's packed weights), one eager
pass lets each child resolve its own.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

import torch

from .. import autograd
from .. import ndarray as nd
from ..context import cpu
from ..executor import _build_eval
from ..ndarray import NDArray
from .. import symbol as sym_mod
from ..symbol.symbol import _infer_shapes
from .parameter import Parameter, ParameterDict, DeferredInitializationError

__all__ = ["Block", "HybridBlock", "SymbolBlock"]


class _BlockScope:
    """Name scoping for Blocks (reference: block.py _BlockScope)."""

    _current = threading.local()

    def __init__(self, block):
        self._block = block
        self._counter = {}
        self._old_scope = None

    @staticmethod
    def create(prefix, params, hint):
        current = getattr(_BlockScope._current, "value", None)
        if current is None:
            if prefix is None:
                prefix = _name_unique(hint) + "_"
            if params is None:
                params = ParameterDict(prefix)
            else:
                params = ParameterDict(params.prefix, params)
            return prefix, params
        if prefix is None:
            count = current._counter.get(hint, 0)
            prefix = "%s%d_" % (hint, count)
            current._counter[hint] = count + 1
        if params is None:
            parent = current._block.params
            params = ParameterDict(parent.prefix + prefix, parent._shared)
        else:
            params = ParameterDict(params.prefix, params)
        return current._block.prefix + prefix, params

    def __enter__(self):
        if self._block._empty_prefix:
            return self
        self._old_scope = getattr(_BlockScope._current, "value", None)
        _BlockScope._current.value = self
        return self

    def __exit__(self, ptype, value, trace):
        if self._block._empty_prefix:
            return
        _BlockScope._current.value = self._old_scope


_GLOBAL_NAME_COUNTER = {}


def _name_unique(hint):
    n = _GLOBAL_NAME_COUNTER.get(hint, 0)
    _GLOBAL_NAME_COUNTER[hint] = n + 1
    return "%s%d" % (hint, n)


def _flatten(args):
    if isinstance(args, (NDArray, sym_mod.Symbol)):
        return [args], 0
    if args is None:        # an optional input left out (a loss's weight)
        return [None], -1
    flat, fmts = [], []
    for a in args:
        f, fmt = _flatten(a)
        flat.extend(f)
        fmts.append(fmt)
    return flat, fmts


def _regroup(args, fmt):
    if isinstance(fmt, int):
        return (None if fmt == -1 else args[0]), args[1:]
    ret = []
    for f in fmt:
        res, args = _regroup(args, f)
        ret.append(res)
    return ret, args


class Block(torch.nn.Module):
    """Base class of layers and models (reference: block.py Block)."""

    def __init__(self, prefix=None, params=None):
        super().__init__()
        self._empty_prefix = prefix == ""
        self._prefix, self._params = _BlockScope.create(
            prefix, params, self._alias())
        self._name = self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix
        self._scope = _BlockScope(self)
        self._children = OrderedDict()
        self._reg_params = {}

    def _alias(self):
        return self.__class__.__name__.lower()

    def __setattr__(self, name, value):
        if isinstance(value, Block):
            self._children[name] = value
        elif isinstance(value, Parameter):
            self._reg_params[name] = value
        super().__setattr__(name, value)

    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._name

    def name_scope(self):
        return self._scope

    @property
    def params(self):
        return self._params

    def collect_params(self):
        """All Parameters of this Block and its children."""
        ret = ParameterDict(self._params.prefix)
        ret.update(self.params)
        for child in self._children.values():
            ret.update(child.collect_params())
        return ret

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False, generator=None):
        """Initialize every parameter on *ctx* (default: the current
        context) from *generator* (see ``ParameterDict.initialize``)."""
        self.collect_params().initialize(init, ctx, verbose, force_reinit,
                                         generator=generator)

    def register_child(self, block, name=None):
        """Add *block* as a child, under *name* (default: its index)."""
        if name is None:
            name = str(len(self._children))
        setattr(self, name, block)

    def hybridize(self, active=True, **kwargs):
        for child in self._children.values():
            child.hybridize(active, **kwargs)

    def cast(self, dtype):
        """Cast every parameter of this block and its children to
        *dtype*."""
        for child in self._children.values():
            child.cast(dtype)
        for param in self.params.values():
            param.cast(dtype)

    def forward(self, *args):
        raise NotImplementedError

    # -- parameter files ----------------------------------------------------
    def _collect_params_with_prefix(self, prefix=""):
        """{structural name: Parameter}: attribute names joined by '.'
        ('0.weight', 'features.3.bias'), which name the same parameter
        in either package whatever the blocks' prefixes are."""
        if prefix:
            prefix += "."
        ret = {prefix + key: val for key, val in self._reg_params.items()}
        for name, child in self._children.items():
            ret.update(child._collect_params_with_prefix(prefix + name))
        return ret

    def save_parameters(self, filename):
        """Write the parameters to *filename* (``nd.save``) under their
        structural names; the JAX package reads the file as well."""
        params = self._collect_params_with_prefix()
        nd.save(filename, {key: val.data() for key, val in params.items()})

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False):
        """Set the parameters from a file of :meth:`save_parameters`
        (either package's).  A parameter not created yet takes the
        file's shape and is made on *ctx* (default: the current
        context); an existing one keeps its device."""
        loaded = nd.load(filename, ctx=cpu())
        params = self._collect_params_with_prefix()
        if not loaded and not params:
            return
        if not allow_missing:
            for name in params:
                if name not in loaded:
                    raise AssertionError("Parameter %r is missing in file %r"
                                         % (name, filename))
        for name, arr in loaded.items():
            if name not in params:
                if not ignore_extra:
                    raise AssertionError(
                        "Parameter %r loaded from file %r is not present "
                        "in this block" % (name, filename))
                continue
            params[name]._load_init(arr, ctx)

    save_params = save_parameters

    def load_params(self, filename, ctx=None, allow_missing=False,
                    ignore_extra=False):
        self.load_parameters(filename, ctx, allow_missing, ignore_extra)

    def summary(self, *inputs):
        """Run a forward on *inputs* and print the number of parameter
        values; returns the forward's output."""
        out = self(*inputs)
        n = sum(p.data().size for p in self.collect_params().values()
                if p._data is not None)
        print("Total params: %d" % n)
        return out


class _CachedGraph:
    """The traced graph of a hybridized block (the CachedOp equivalent)."""

    def __init__(self, block, flat_inputs):
        data_syms = [sym_mod.var("data%d" % i)
                     for i in range(len(flat_inputs))]
        param_syms = {n: p.var() for n, p in block._reg_params.items()}
        out = block.hybrid_forward(sym_mod, *data_syms, **param_syms)
        flat_out, self._out_fmt = _flatten(out)
        self.symbol = sym_mod.Group(flat_out) if len(flat_out) > 1 \
            else flat_out[0]
        self.input_names = ["data%d" % i for i in range(len(flat_inputs))]
        self.param_names = [a for a in self.symbol.list_arguments()
                            if a not in self.input_names]
        self.aux_names = list(self.symbol.list_auxiliary_states())
        self._eval_train = _build_eval(self.symbol, True)
        self._eval_infer = _build_eval(self.symbol, False)
        self._free = (None, {})

    def _free_args(self, params, flat_inputs):
        """Zeros for the graph arguments no Parameter backs (a fused RNN
        layer called without states creates its begin-state variables),
        at the shapes inference gives for these inputs, as ``simple_bind``
        fills an unbound argument."""
        free = [n for n in self.param_names if n not in params]
        key = tuple(tuple(x.shape) for x in flat_inputs)
        if free and self._free[0] != key:
            shapes = {n: tuple(x.shape)
                      for n, x in zip(self.input_names, flat_inputs)}
            shapes.update({n: params[n].shape for n in self.param_names
                           if n in params})
            arg_shapes, _, _ = self.symbol.infer_shape(**shapes)
            inferred = dict(zip(self.symbol.list_arguments(), arg_shapes))
            ref = next((params[n].data()._data for n in self.param_names
                        if n in params), flat_inputs[0]._data)
            self._free = (key, {n: torch.zeros(inferred[n], dtype=ref.dtype,
                                               device=ref.device)
                                for n in free})
        return self._free[1] if free else {}

    def run(self, block, flat_inputs):
        params = {p.name: p for p in block.collect_params().values()}
        arg_map = {n: x._data for n, x in zip(self.input_names, flat_inputs)}
        arg_map.update(self._free_args(params, flat_inputs))
        for n in self.param_names:
            if n in params:
                arg_map[n] = params[n].data()._data
        aux_map = {n: params[n].data()._data for n in self.aux_names}
        ev = self._eval_train if autograd.is_training() else self._eval_infer
        with torch.set_grad_enabled(autograd.is_recording()):
            outs, auxu = ev(arg_map, aux_map)
        with torch.no_grad():
            for n, v in auxu.items():
                params[n].data()._data.copy_(v)
        out, _ = _regroup([NDArray(o) for o in outs], self._out_fmt)
        return out


class HybridBlock(Block):
    """A Block that can be traced into a graph (reference: HybridBlock)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._active = False
        self._cached_graph = None

    def hybridize(self, active=True, **kwargs):
        self._active = active
        self._cached_graph = None
        super().hybridize(active, **kwargs)

    def register_child(self, block, name=None):
        super().register_child(block, name)
        self._cached_graph = None

    def cast(self, dtype):
        self._cached_graph = None
        super().cast(dtype)

    def infer_shape(self, *args):
        """Resolve deferred parameter shapes from these inputs' shapes,
        and create the parameters' data."""
        self._infer_attrs(*args)

    def _infer_attrs(self, *args):
        """Resolve deferred parameter shapes by shape inference over the
        symbolic trace at these input shapes, then create the data."""
        flat, _ = _flatten(args)
        data_shapes = {"data%d" % i: x.shape for i, x in enumerate(flat)
                       if x is not None}
        data_syms = [sym_mod.var("data%d" % i) for i in range(len(flat))]
        param_syms = {n: sym_mod.var(p.name)
                      for n, p in self._reg_params.items()}
        out = self.hybrid_forward(sym_mod, *data_syms, **param_syms)
        flat_out, _ = _flatten(out)
        symbol = sym_mod.Group(flat_out) if len(flat_out) > 1 \
            else flat_out[0]
        _, var_sh = _infer_shapes(symbol, data_shapes, partial=True)
        params = {p.name: p for p in self.collect_params().values()}
        for name, shape in var_sh.items():
            if name in params and shape is not None:
                params[name].shape = shape
        for p in params.values():
            if p._deferred_init is not None and p._known():
                p._finish_deferred_init()

    def _ensure_params(self, *args):
        params = list(self.collect_params().values())
        if any(p._deferred_init is not None for p in params):
            self._infer_attrs(*args)
            if any(p._deferred_init is not None for p in params) and args \
                    and all(isinstance(a, NDArray) for a in args):
                # shape inference could not resolve everything (an RNN
                # layer's packed weights): one eager pass lets each child
                # resolve its own shapes from its real input
                try:
                    with torch.no_grad():
                        self.hybrid_forward(
                            nd, *args, **{n: p.data() for n, p in
                                          self._reg_params.items()})
                except DeferredInitializationError:
                    pass
        for p in params:
            p._check_initialized()

    def forward(self, x, *args):
        """Symbol input: trace.  Hybridized: evaluate the cached graph.
        Otherwise: run ``hybrid_forward`` eagerly with F = nd."""
        if isinstance(x, sym_mod.Symbol):
            param_syms = {n: p.var() for n, p in self._reg_params.items()}
            return self.hybrid_forward(sym_mod, x, *args, **param_syms)
        self._ensure_params(x, *args)
        flat, _ = _flatten([x] + list(args))
        if self._active:
            if self._cached_graph is None or \
                    len(self._cached_graph.input_names) != len(flat):
                # traced anew for another input count (states given or not)
                self._cached_graph = _CachedGraph(self, flat)
            return self._cached_graph.run(self, flat)
        params = {n: p.data() for n, p in self._reg_params.items()}
        with torch.set_grad_enabled(autograd.is_recording()):
            return self.hybrid_forward(nd, x, *args, **params)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError

    def export(self, path, epoch=0):
        """Write ``path-symbol.json`` and ``path-NNNN.params`` (keys
        ``arg:<name>`` / ``aux:<name>``), the reference's checkpoint
        layout.  Needs ``hybridize()`` and one forward first."""
        if self._cached_graph is None:
            raise RuntimeError(
                "Please call hybridize and run forward at least once before "
                "calling export.")
        sym_file = "%s-symbol.json" % path
        self._cached_graph.symbol.save(sym_file)
        params = {p.name: p for p in self.collect_params().values()}
        arg_dict = {"arg:%s" % n: params[n].data()
                    for n in self._cached_graph.param_names}
        arg_dict.update({"aux:%s" % n: params[n].data()
                         for n in self._cached_graph.aux_names})
        nd.save("%s-%04d.params" % (path, epoch), arg_dict)
        return sym_file


class SymbolBlock(HybridBlock):
    """A Symbol run as a Block: its arguments other than *inputs* become
    parameters (its auxiliary states parameters with grad_req 'null'),
    and a forward evaluates the graph eagerly on them, taped under
    ``autograd.record()``."""

    @staticmethod
    def imports(symbol_file, input_names, param_file=None, ctx=None):
        """A SymbolBlock from an exported ``-symbol.json`` and, given,
        its ``.params`` file (``arg:``/``aux:`` keys, either package's),
        with the parameters made on *ctx* (default: the current
        context)."""
        symbol = sym_mod.load(symbol_file)
        if isinstance(input_names, str):
            input_names = [input_names]
        ret = SymbolBlock(symbol, [sym_mod.var(n) for n in input_names])
        if param_file is not None:
            loaded = {(k[4:] if k.startswith(("arg:", "aux:")) else k): v
                      for k, v in nd.load(param_file, ctx=cpu()).items()}
            for name, param in ret.collect_params().items():
                if name in loaded:
                    param._load_init(loaded[name], ctx)
        return ret

    def __init__(self, outputs, inputs, params=None):
        super().__init__(prefix="", params=params)
        if isinstance(outputs, (list, tuple)):
            outputs = outputs[0] if len(outputs) == 1 else \
                sym_mod.Group(outputs)
        if isinstance(inputs, sym_mod.Symbol):
            inputs = [inputs]
        self._symbol = outputs
        self._input_names = [i.name for i in inputs]
        self._aux_names = list(outputs.list_auxiliary_states())
        self._arg_names = [n for n in outputs.list_arguments()
                           if n not in self._input_names]
        for name in self._arg_names:
            self.params.get(name, allow_deferred_init=True,
                            grad_req="write")
        for name in self._aux_names:
            self.params.get(name, allow_deferred_init=True, grad_req="null")
        self._evals = {}

    def forward(self, *args):
        flat, _ = _flatten(list(args))
        params = dict(self.collect_params().items())
        arg_map = {n: x._data for n, x in zip(self._input_names, flat)}
        for name in self._arg_names:
            arg_map[name] = params[name].data()._data
        aux_map = {n: params[n].data()._data for n in self._aux_names}
        training = autograd.is_training()
        if training not in self._evals:
            self._evals[training] = _build_eval(self._symbol, training)
        with torch.set_grad_enabled(autograd.is_recording()):
            outs, auxu = self._evals[training](arg_map, aux_map)
        with torch.no_grad():
            for n, v in auxu.items():
                params[n].data()._data.copy_(v)
        outs = [NDArray(o) for o in outs]
        return outs[0] if len(outs) == 1 else outs

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError
