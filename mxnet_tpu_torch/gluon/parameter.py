"""Gluon Parameter / ParameterDict (port of ``mxnet_tpu/gluon/parameter.py``).

A Parameter holds one NDArray on one context (the port runs on one
device), and, unless its ``grad_req`` is 'null', a gradient buffer of
the same shape made with it: the data is then a marked variable of
``autograd`` whose gradient lands in that buffer.  Shapes may be
deferred: a ``0`` in a shape is filled by shape inference at the first
forward, when the parameter is created and initialized.  Random
initializers draw from the ``torch.Generator`` the caller passed to
``initialize``, else from the global stream that ``mx.random.seed`` sets.
"""

from __future__ import annotations

from collections import OrderedDict

import torch

from .. import autograd
from ..base import MXNetError, narrow_dtype, torch_dtype
from ..context import Context, cpu, current_context
from .. import ndarray as nd
from ..ndarray import NDArray
from .. import initializer as init_mod
from .. import symbol as sym_mod

__all__ = ["Parameter", "ParameterDict", "DeferredInitializationError"]


class DeferredInitializationError(MXNetError):
    """Parameter accessed before its shape was known."""


class Parameter:
    """A weight (or state) of a Block."""

    def __init__(self, name, grad_req="write", shape=None, dtype="float32",
                 lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False, differentiable=True,
                 stype="default", grad_stype="default"):
        self.name = name
        # storage types: the data is held dense either way; a row_sparse
        # grad_stype makes the Trainer hand lazy optimizers the gradient's
        # touched rows (trainer.py)
        self._stype = stype
        self._grad_stype = grad_stype
        self._differentiable = differentiable
        self._grad_req = grad_req if differentiable else "null"
        self._shape = tuple(shape) if shape is not None else None
        self.dtype = narrow_dtype(dtype)
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.init = init
        self._allow_deferred_init = allow_deferred_init
        self._data = None
        self._grad = None
        self._deferred_init = None
        self._var = None

    def __repr__(self):
        return "Parameter %s (shape=%s, dtype=%s)" % (
            self.name, self._shape, self.dtype)

    @property
    def shape(self):
        return self._shape

    @shape.setter
    def shape(self, new_shape):
        new_shape = tuple(new_shape)
        if self._shape is not None and not (
                len(self._shape) == len(new_shape) and
                all(a in (0, b) for a, b in zip(self._shape, new_shape))):
            raise AssertionError(
                "Expected shape %s is incompatible with given shape %s for "
                "Parameter %s" % (new_shape, self._shape, self.name))
        self._shape = new_shape

    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        if req not in ("write", "add", "null"):
            raise ValueError("grad_req must be 'write', 'add' or 'null', "
                             "got %r" % (req,))
        if not self._differentiable:
            req = "null"
        if self._grad_req == req:
            return
        self._grad_req = req
        if self._data is not None:
            self._init_grad()

    def _known(self):
        return self._shape is not None and all(s > 0 for s in self._shape)

    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False, generator=None):
        """Create and fill the data on *ctx* (default: the current
        context), now or, for a deferred shape, at the first forward."""
        if self._data is not None and not force_reinit:
            return
        if isinstance(ctx, (list, tuple)):
            if len(ctx) != 1:
                raise MXNetError("Parameter %s: one context per parameter "
                                 "(got %s)" % (self.name, ctx))
            ctx = ctx[0]
        ctx = Context(ctx) if ctx is not None else current_context()
        default_init = default_init or init_mod.Uniform()
        if not self._known():
            if self._allow_deferred_init:
                self._deferred_init = (init, ctx, default_init, generator)
                return
            raise ValueError("Cannot initialize Parameter %s because it has "
                             "invalid shape %s." % (self.name, self._shape))
        self._finish_init(init, ctx, default_init, generator)

    def _finish_init(self, init, ctx, default_init, generator):
        data = nd.zeros(self._shape, ctx=ctx, dtype=self.dtype)
        initializer = init or self.init or default_init
        if isinstance(initializer, str):
            initializer = init_mod.create(initializer)
        initializer(self.name, data, generator)
        self._data = data
        self._deferred_init = None
        self._init_grad()

    def _init_grad(self):
        """A zero gradient buffer, and the data marked as a variable of
        ``autograd`` by ``grad_req`` (no buffer for 'null')."""
        if self._grad_req == "null":
            self._grad = None
        else:
            self._grad = nd.zeros(self._shape, ctx=self._data.context,
                                  dtype=self.dtype)
        autograd.mark_variables([self._data], [self._grad], self._grad_req)

    def _finish_deferred_init(self):
        if self._deferred_init is None:
            raise DeferredInitializationError(
                "Parameter %s has not been initialized yet" % self.name)
        if not self._known():
            raise DeferredInitializationError(
                "Parameter %s awaiting shape inference" % self.name)
        self._finish_init(*self._deferred_init)

    def _check_initialized(self):
        if self._data is None:
            if self._deferred_init is not None:
                raise DeferredInitializationError(
                    "Parameter %s has not been initialized yet because "
                    "initialization was deferred. Actual initialization "
                    "happens during the first forward pass." % self.name)
            raise RuntimeError(
                "Parameter %s has not been initialized. You should "
                "initialize parameters with Block.collect_params()"
                ".initialize()" % self.name)

    def data(self, ctx=None):
        self._check_initialized()
        return self._data

    def list_data(self):
        return [self.data()]

    def row_sparse_data(self, row_id):
        """The data for the rows *row_id*: on one device, all of it (the
        JAX package fetches the whole weight too)."""
        return self.data()

    def grad(self, ctx=None):
        self._check_initialized()
        if self._grad is None:
            raise RuntimeError(
                "Cannot get gradient array for Parameter %s because "
                "grad_req='null'" % self.name)
        return self._grad

    def list_grad(self):
        return [self.grad()]

    def list_ctx(self):
        if self._data is None and self._deferred_init is not None:
            return [self._deferred_init[1]]
        self._check_initialized()
        return [self._data.context]

    def zero_grad(self):
        """Set the gradient buffer to zeros (for grad_req 'add')."""
        if self._grad is not None:
            self._grad._data.zero_()

    def set_data(self, data):
        """Copy *data* (NDArray, tensor or numpy) into the parameter,
        cast to its dtype, on its context."""
        self.shape = data.shape
        if self._data is None:
            self._finish_deferred_init()
        src = data._data if isinstance(data, NDArray) else \
            nd.array(data, ctx=self._data.context)._data
        with torch.no_grad():
            self._data._data.copy_(src.to(self._data._data.dtype))

    def _load_init(self, arr, ctx):
        """Set the data to *arr* from a file; a parameter not created yet
        takes *arr*'s shape and is made on *ctx* (default: the current
        context)."""
        if self._data is None and self._deferred_init is not None:
            self.shape = arr.shape
            self._finish_deferred_init()
        elif self._data is None:
            self._shape = tuple(arr.shape)
            self.initialize(ctx=ctx)
        self.set_data(arr)

    def cast(self, dtype):
        """Cast the data (and the gradient buffer) to *dtype*; the cast
        data is the marked variable from now on."""
        self.dtype = narrow_dtype(dtype)
        if self._data is None:
            return
        with torch.no_grad():
            self._data = NDArray(self._data._data.to(torch_dtype(self.dtype)))
        self._init_grad()

    def var(self):
        """The variable Symbol standing for this parameter in a trace."""
        if self._var is None:
            self._var = sym_mod.var(
                self.name, shape=self._shape if self._known() else None,
                lr_mult=self.lr_mult, wd_mult=self.wd_mult)
        return self._var


class ParameterDict:
    """Ordered dict of Parameters with prefix scoping."""

    def __init__(self, prefix="", shared=None):
        self._prefix = prefix
        self._params = OrderedDict()
        self._shared = shared

    def __repr__(self):
        return "ParameterDict %r (%d params)" % (self._prefix,
                                                 len(self._params))

    def __getitem__(self, key):
        return self._params[key]

    def __iter__(self):
        return iter(self._params)

    def __len__(self):
        return len(self._params)

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    @property
    def prefix(self):
        return self._prefix

    def get(self, name, **kwargs):
        """Get-or-create the parameter ``<prefix><name>``."""
        name = self._prefix + name
        param = self._params.get(name)
        if param is None and self._shared is not None:
            param = self._shared._params.get(name)
            if param is not None:
                self._params[name] = param
        if param is None:
            param = Parameter(name, **kwargs)
            self._params[name] = param
        return param

    def update(self, other):
        for k, v in other.items():
            if k in self._params and self._params[k] is not v:
                raise ValueError("Cannot update self with other because "
                                 "they have different Parameters with the "
                                 "same name %r" % k)
            self._params[k] = v

    def zero_grad(self):
        for p in self.values():
            p.zero_grad()

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False, generator=None):
        """Initialize every parameter on *ctx*.  One *generator* feeds
        all of them in order; without one they draw, in order, from the
        global stream that ``mx.random.seed`` sets."""
        init = init or init_mod.Uniform()
        for v in self.values():
            v.initialize(None, ctx, init, force_reinit=force_reinit,
                         generator=generator)

    def setattr(self, name, value):
        """Set attribute *name* of every parameter (``grad_req``,
        ``lr_mult``, ...)."""
        for p in self.values():
            setattr(p, name, value)

    def save(self, filename, strip_prefix=""):
        """Write every parameter's data to *filename* (``nd.save``), keyed
        by its name less *strip_prefix*."""
        arg_dict = {}
        for param in self.values():
            if not param.name.startswith(strip_prefix):
                raise ValueError("Prefix %r is to be striped before saving, "
                                 "but Parameter %r does not start with it"
                                 % (strip_prefix, param.name))
            arg_dict[param.name[len(strip_prefix):]] = param.data()
        nd.save(filename, arg_dict)

    def load(self, filename, ctx=None, allow_missing=False,
             ignore_extra=False, restore_prefix=""):
        """Set the parameters from a file of :meth:`save` (either
        package's), each name prefixed with *restore_prefix*; a parameter
        not created yet takes the file's shape and is made on *ctx*
        (default: the current context)."""
        # read onto the host; set_data copies onto each parameter's device
        loaded = {restore_prefix + k: v
                  for k, v in nd.load(filename, ctx=cpu()).items()}
        if not allow_missing:
            for name in self.keys():
                if name not in loaded:
                    raise IOError("Parameter %r is missing in file %r"
                                  % (name, filename))
        for name, arr in loaded.items():
            if name not in self._params:
                if not ignore_extra:
                    raise IOError("Parameter %r loaded from file %r is not "
                                  "present in this ParameterDict"
                                  % (name, filename))
                continue
            self[name]._load_init(arr, ctx)
