"""Optimizers (port of ``mxnet_tpu/optimizer/optimizer.py``, subset:
Optimizer, dense SGD with and without momentum, Updater).

Every ``update`` resolves the parameter's hyper-parameters (lr and wd
multipliers, update count) in Python and then runs one update op from
``ops/optimizer_ops.py``, which writes the weight and its state in place.
``Updater`` is the per-index state store, and its ``get_states`` /
``set_states`` blob is the JAX package's format 2, so optimizer state
crosses between the packages.

Not ported yet: multi-precision and row-sparse updates, learning-rate
schedulers, and the other optimizers (NAG, Adam, ...).
"""

from __future__ import annotations

import io
import pickle

from ..base import MXNetError
from .. import ndarray as nd
from ..context import cpu
from ..ndarray import NDArray

__all__ = ["Optimizer", "SGD", "Updater", "create", "register",
           "get_updater"]

_REGISTRY = {}

# the build-time hyper-parameters a format-2 states blob records
# (``mxnet_tpu/optimizer/tree_opt.py`` ``_HYPER_ATTRS``); the blob's
# ``hyper_sig`` lists their values in this order
_HYPER_ATTRS = ("rescale_grad", "clip_gradient", "momentum",
                "lazy_update", "multi_precision", "wd_lh", "gamma1",
                "gamma2", "epsilon", "centered", "clip_weights",
                "beta1", "beta2", "rho", "lamda1", "beta",
                "schedule_decay", "float_stable_eps")


def register(klass):
    """Register an Optimizer class under its lower-cased name."""
    _REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(name, **kwargs):
    """An optimizer by registered name ('sgd'), or *name* itself when it
    is an Optimizer already."""
    if isinstance(name, Optimizer):
        return name
    try:
        return _REGISTRY[name.lower()](**kwargs)
    except KeyError:
        raise MXNetError("optimizer %r is not ported; known: %s"
                         % (name, sorted(_REGISTRY)))


class Optimizer:
    """Base optimizer (reference: optimizer.py Optimizer:46).

    Subclasses implement ``create_state`` (None or a state NDArray per
    parameter) and ``update``; ``_bump`` gives the per-parameter update
    count and ``_fused`` runs the update op.
    """

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, begin_num_update=0,
                 multi_precision=False, param_dict=None):
        if multi_precision:
            raise MXNetError("multi_precision optimizers are not ported")
        self.lr, self.wd = learning_rate, wd
        self.rescale_grad, self.clip_gradient = rescale_grad, clip_gradient
        self.begin_num_update = self.num_update = begin_num_update
        self._index_update_count = {}
        self.multi_precision = multi_precision
        self.idx2name = dict(param_idx2name or {})
        self.param_dict = param_dict or {}
        self.lr_mult, self.wd_mult = {}, {}

    def set_learning_rate(self, lr):
        self.lr = lr

    @property
    def learning_rate(self):
        return self.lr

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        # decay applies to weights and norm scales; biases and betas get 0
        # unless set explicitly (reference set_wd_mult semantics)
        self.wd_mult = {n: 0.0 for n in self.idx2name.values()
                        if not n.endswith(("_weight", "_gamma"))}
        self.wd_mult.update(args_wd_mult)

    def _multiplier(self, index, table):
        """Multiplier for *index* from a {index-or-name: mult} table; a
        Parameter in param_dict speaks for itself."""
        if index in self.param_dict:
            p = self.param_dict[index]
            return p.lr_mult if table is self.lr_mult else p.wd_mult
        if index in table:
            return table[index]
        return table.get(self.idx2name.get(index), 1.0)

    def _get_lr(self, index):
        return self.learning_rate * self._multiplier(index, self.lr_mult)

    def _get_wd(self, index):
        return self.wd * self._multiplier(index, self.wd_mult)

    def _bump(self, index):
        """Advance and return this parameter's update count."""
        t = self._index_update_count.get(index, self.begin_num_update) + 1
        self._index_update_count[index] = t
        self.num_update = max(t, self.num_update)
        return t

    def create_state(self, index, weight):
        return None

    def _fused(self, op_name, weight, grad, states=(), **hyper):
        """Run one update op over [weight, *states], which it updates in
        place, with the rescale and clip knobs merged in."""
        hyper.setdefault("rescale_grad", self.rescale_grad)
        if self.clip_gradient is not None:
            hyper.setdefault("clip_gradient", self.clip_gradient)
        getattr(nd, op_name)(weight, grad, *states, **hyper)

    def update(self, index, weight, grad, state):
        raise NotImplementedError


@register
class SGD(Optimizer):
    """SGD with optional momentum, dense updates (reference: optimizer.py
    SGD:451)."""

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum, self.lazy_update = momentum, lazy_update

    def create_state(self, index, weight):
        if not self.momentum:
            return None
        return nd.zeros(weight.shape, ctx=weight.context,
                        dtype=weight._data.dtype)

    def update(self, index, weight, grad, state):
        self._bump(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        if state is not None:
            self._fused("sgd_mom_update", weight, grad, (state,), lr=lr,
                        wd=wd, momentum=self.momentum)
        else:
            self._fused("sgd_update", weight, grad, lr=lr, wd=wd)


def _to_np(s):
    if isinstance(s, NDArray):
        return ("nd", s.asnumpy())
    if isinstance(s, (tuple, list)):
        return ("tuple", [_to_np(x) for x in s])
    return ("raw", s)


def _from_np(s):
    kind, v = s
    if kind == "nd":
        return nd.array(v, ctx=cpu())
    if kind == "tuple":
        return tuple(_from_np(x) for x in v)
    return v


# the only globals a format-2 blob's numpy payload needs
_BLOB_GLOBALS = {("numpy", "ndarray"), ("numpy", "dtype"),
                 ("numpy.core.multiarray", "_reconstruct"),
                 ("numpy._core.multiarray", "_reconstruct"),
                 ("numpy.core.multiarray", "scalar"),
                 ("numpy._core.multiarray", "scalar")}


class _BlobUnpickler(pickle.Unpickler):
    """Unpickles a states blob, refusing every class but numpy's arrays
    and scalars: a blob that also holds a pickled optimizer
    (``dump_optimizer=True``) raises instead of importing its package."""

    def find_class(self, module, name):
        if (module, name) in _BLOB_GLOBALS:
            return super().find_class(module, name)
        raise MXNetError("optimizer states: the blob holds a %s.%s; only "
                         "numpy payloads are read (save the states with "
                         "dump_optimizer=False)" % (module, name))


def _on(state, ctx):
    """*state* moved to *ctx* (NDArrays, possibly in a tuple)."""
    if isinstance(state, NDArray):
        return state.as_in_context(ctx)
    if isinstance(state, tuple):
        return tuple(_on(s, ctx) for s in state)
    return state


class Updater:
    """Per-index state store applying an optimizer (reference:
    optimizer.py Updater:1504)."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}
        self.states_synced = {}

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = self.optimizer.create_state(index, weight)
            self.states_synced[index] = True
        elif not self.states_synced[index]:
            # loaded states wait on the host until their weight is known
            self.states[index] = _on(self.states[index], weight.context)
            self.states_synced[index] = True
        self.optimizer.update(index, weight, grad, self.states[index])

    def get_states(self):
        """The states as the JAX package's format-2 blob (pickled): numpy
        payload, the optimizer's class name and hyper-parameter
        signature."""
        blob = {"__format__": 2,
                "states": {k: _to_np(v) for k, v in self.states.items()},
                "opt_class": type(self.optimizer).__name__,
                "hyper_sig": [getattr(self.optimizer, a, None)
                              for a in _HYPER_ATTRS]}
        return pickle.dumps(blob)

    def set_states(self, states):
        """Load the states of a format-2 blob of :meth:`get_states` from
        either package; the updater keeps its own optimizer.  States stay on
        the host until their parameter's next update moves them to its
        device.  Only numpy arrays and scalars are unpickled."""
        data = _BlobUnpickler(io.BytesIO(states)).load() \
            if isinstance(states, (bytes, bytearray, memoryview)) else states
        if not (isinstance(data, dict) and data.get("__format__") == 2):
            raise MXNetError("optimizer states: only the format-2 blob is "
                             "ported")
        self.states = {k: _from_np(v) for k, v in data["states"].items()}
        self.states_synced = {k: False for k in self.states}


def get_updater(optimizer):
    return Updater(optimizer)
