"""Optimizers (port of ``mxnet_tpu/optimizer/optimizer.py``: the 16
optimizers of the JAX package, multi-precision, learning-rate
schedulers and ``Updater``).

Every ``update`` resolves the parameter's hyper-parameters (lr and wd
multipliers, update count) in Python and then runs one update op from
``ops/optimizer_ops.py``, which writes the weight and its states in
place.  An optimizer written in Python in the JAX package (DCASGD, SGLD,
Test) writes its result into the weight in place too: a Parameter's data
is a marked variable of ``autograd`` and must stay the same tensor.

Multi-precision (``multi_precision=True``): a 16-bit weight's state is
``(state, weight32)``, its optimizer state beside a float32 master copy.
SGD updates both through the ``mp_sgd*`` ops; every other optimizer
updates the master with the float32 gradient and writes the weight as the
master rounded to its dtype (``update_multi_precision``).

``Updater`` is the per-index state store, and its ``get_states`` /
``set_states`` blob is the JAX package's format 2, so optimizer state,
multi-precision tuples included, crosses between the packages.

Row-sparse gradients (``ndarray.sparse.RowSparseNDArray``): SGD with
``lazy_update`` and AdaGrad update only the gradient's rows
(``sparse.sgd_row_update``, ``sgd_mom_row_update``,
``adagrad_row_update``); every other optimizer, and SGD without
``lazy_update``, densifies the gradient first (the JAX package's Adam
and the other dense optimizers would read a row-sparse gradient's values
as a dense gradient).
"""

from __future__ import annotations

import io
import math
import pickle

import torch

from ..base import MXNetError
from .. import ndarray as nd
from ..context import cpu
from ..ndarray import NDArray

__all__ = ["Optimizer", "SGD", "Signum", "SignSGD", "FTML", "LBSGD",
           "DCASGD", "NAG", "SGLD", "Adam", "AdaGrad", "RMSProp",
           "AdaDelta", "Ftrl", "Adamax", "Nadam", "Test", "Updater",
           "create", "register", "get_updater", "states_mismatch"]

_REGISTRY = {}

# the build-time hyper-parameters a format-2 states blob records
# (``mxnet_tpu/optimizer/tree_opt.py`` ``_HYPER_ATTRS``); the blob's
# ``hyper_sig`` lists their values in this order
_HYPER_ATTRS = ("rescale_grad", "clip_gradient", "momentum",
                "lazy_update", "multi_precision", "wd_lh", "gamma1",
                "gamma2", "epsilon", "centered", "clip_weights",
                "beta1", "beta2", "rho", "lamda1", "beta",
                "schedule_decay", "float_stable_eps")

_LOW_PRECISION = (torch.float16, torch.bfloat16)


def register(klass):
    """Register an Optimizer class under its lower-cased name."""
    _REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(name, **kwargs):
    """An optimizer by registered name ('sgd', 'lbsgd', ...), or *name*
    itself when it is an Optimizer already."""
    if isinstance(name, Optimizer):
        return name
    try:
        klass = _REGISTRY[name.lower()]
    except KeyError:
        raise MXNetError("optimizer %r is not registered; known: %s"
                         % (name, sorted(_REGISTRY)))
    return klass(**kwargs)


def _zeros(weight, dtype=None):
    """Zeros shaped like *weight* on its device, in *dtype* (default: the
    weight's)."""
    return NDArray(torch.zeros(weight.shape, device=weight._data.device,
                               dtype=dtype or weight._data.dtype))


class _Mults:
    """A Parameter's learning-rate and weight-decay multipliers, which
    stand in for it in a pickled optimizer's ``param_dict``."""

    def __init__(self, lr_mult, wd_mult):
        self.lr_mult, self.wd_mult = lr_mult, wd_mult


class Optimizer:
    """Base optimizer (reference: optimizer.py Optimizer:46).

    Subclasses implement ``create_state`` (None, a state NDArray or a
    tuple of them per parameter) and ``update``; ``_bump`` gives the
    per-parameter update count and ``_fused`` runs the update op.
    """

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0, multi_precision=False,
                 param_dict=None):
        self.lr, self.wd = learning_rate, wd
        self.rescale_grad, self.clip_gradient = rescale_grad, clip_gradient
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            lr_scheduler.base_lr = learning_rate
        self.begin_num_update = self.num_update = begin_num_update
        self._index_update_count = {}
        self.multi_precision = multi_precision
        self.idx2name = dict(param_idx2name or {})
        self.param_dict = param_dict or {}
        self.lr_mult, self.wd_mult = {}, {}

    def __getstate__(self):
        # a pickled optimizer (a kvstore's SET_OPT, ``dump_optimizer``)
        # carries each Parameter's multipliers, not its device tensors
        state = dict(self.__dict__)
        state["param_dict"] = {i: _Mults(p.lr_mult, p.wd_mult)
                               for i, p in self.param_dict.items()}
        return state

    def set_learning_rate(self, lr):
        if self.lr_scheduler is not None:
            raise UserWarning("learning rate is owned by the attached "
                              "LRScheduler")
        self.lr = lr

    @property
    def learning_rate(self):
        sched = self.lr_scheduler
        return self.lr if sched is None else sched(self.num_update)

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

    # kept under the reference's internal name: subclasses there call it
    _update_count = _bump

    def create_state(self, index, weight):
        return None

    def create_state_multi_precision(self, index, weight):
        """``(state, weight32)`` for a 16-bit weight under
        multi_precision (the float32 master copied from the weight), else
        ``create_state``."""
        if self.multi_precision and weight._data.dtype in _LOW_PRECISION:
            w32 = NDArray(weight._data.float())
            return (self.create_state(index, w32), w32)
        return self.create_state(index, weight)

    def _knobs(self, clip_name="clip_gradient"):
        """The rescale and clip knobs every update op takes."""
        kw = {"rescale_grad": self.rescale_grad}
        if self.clip_gradient is not None:
            kw[clip_name] = self.clip_gradient
        return kw

    def _fused(self, op_name, weight, grad, states=(), **hyper):
        """Run one update op over [weight, *states], which it updates in
        place, with the rescale and clip knobs merged in (None states,
        such as a momentum of 0, are left out)."""
        for k, v in self._knobs().items():
            hyper.setdefault(k, v)
        getattr(nd, op_name)(weight, self._densify(grad),
                             *[s for s in states if s is not None], **hyper)

    def _clipped(self, grad):
        """The rescaled, clipped gradient tensor (the Python-side
        optimizers' first step)."""
        g = self._densify(grad)._data * self.rescale_grad
        if self.clip_gradient is not None:
            g = torch.clamp(g, -self.clip_gradient, self.clip_gradient)
        return g

    def update(self, index, weight, grad, state):
        raise NotImplementedError

    @staticmethod
    def _densify(grad):
        """A row-sparse gradient as a dense one; a dense one unchanged."""
        from ..ndarray import sparse as _sp
        if isinstance(grad, _sp.BaseSparseNDArray):
            return grad.todense()
        return grad

    @staticmethod
    def _is_mp(weight, state):
        return (isinstance(state, tuple) and len(state) == 2
                and isinstance(state[1], NDArray)
                and state[1]._data.dtype == torch.float32
                and weight._data.dtype != torch.float32)

    def update_multi_precision(self, index, weight, grad, state):
        """Update through the float32 master when *state* carries one:
        the master takes the float32 gradient and the weight becomes the
        master in its own dtype."""
        if not self.multi_precision or not self._is_mp(weight, state):
            return self.update(index, weight, grad, state)
        inner, w32 = state
        self.update(index, w32, grad.astype("float32"), inner)
        with torch.no_grad():
            weight._data.copy_(w32._data)


@register
class SGD(Optimizer):
    """SGD with optional momentum and fused multi-precision updates
    (reference: optimizer.py SGD:451)."""

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum, self.lazy_update = momentum, lazy_update

    def create_state(self, index, weight):
        return _zeros(weight) if self.momentum else None

    def update(self, index, weight, grad, state):
        self._bump(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        from ..ndarray import sparse as _sp
        if isinstance(grad, _sp.RowSparseNDArray) and self.lazy_update:
            # only the gradient's rows move (reference: sgd_update's
            # row_sparse path, lazy_update)
            kw = self._knobs()
            if state is not None:
                _sp.sgd_mom_row_update(weight, grad, state, lr=lr,
                                       momentum=self.momentum, wd=wd, **kw)
            else:
                _sp.sgd_row_update(weight, grad, lr=lr, wd=wd, **kw)
            return
        grad = self._densify(grad)
        if state is not None:
            self._fused("sgd_mom_update", weight, grad, (state,), lr=lr,
                        wd=wd, momentum=self.momentum)
        else:
            self._fused("sgd_update", weight, grad, lr=lr, wd=wd)

    def update_multi_precision(self, index, weight, grad, state):
        if not self._is_mp(weight, state):
            return self.update(index, weight, grad, state)
        self._bump(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        grad = self._densify(grad)
        mom, w32 = state
        if mom is not None:
            self._fused("mp_sgd_mom_update", weight, grad, (mom, w32),
                        lr=lr, wd=wd, momentum=self.momentum)
        else:
            self._fused("mp_sgd_update", weight, grad, (w32,), lr=lr, wd=wd)


@register
class Signum(Optimizer):
    """Sign-of-momentum updates (reference: optimizer.py Signum:920)."""

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum, self.wd_lh = momentum, wd_lh

    def create_state(self, index, weight):
        return _zeros(weight) if self.momentum else None

    def update(self, index, weight, grad, state):
        self._bump(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        if state is not None:
            self._fused("signum_update", weight, grad, (state,), lr=lr,
                        wd=wd, momentum=self.momentum, wd_lh=self.wd_lh)
        else:
            self._fused("signsgd_update", weight, grad, lr=lr, wd=wd)


@register
class SignSGD(Signum):
    """Signum without momentum."""

    def __init__(self, **kwargs):
        kwargs.setdefault("momentum", 0.0)
        super().__init__(**kwargs)


@register
class FTML(Optimizer):
    """Follow the moving leader (reference: optimizer.py FTML:830)."""

    def __init__(self, beta1=0.6, beta2=0.999, epsilon=1e-8, **kwargs):
        super().__init__(**kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return tuple(_zeros(weight, torch.float32) for _ in range(3))

    def update(self, index, weight, grad, state):
        t = self._bump(index)
        d, v, z = state
        nd.ftml_update(weight, grad, d, v, z, lr=self._get_lr(index),
                       wd=self._get_wd(index), beta1=self.beta1,
                       beta2=self.beta2, epsilon=self.epsilon, t=t,
                       **self._knobs("clip_grad"))


@register
class LBSGD(Optimizer):
    """Large-batch SGD: a warmup multiplier (linear, power2 or sqrt ramp
    from 1 to ``batch_scale`` over ``warmup_epochs``) or, with
    ``warmup_strategy='lars'``, the layer-wise trust ratio ||w|| /
    (||g|| + wd ||w||), on top of (momentum) SGD (reference:
    optimizer.py LBSGD:678).  The ratio is read back to the host, one
    parameter at a time; ``ParallelTrainer`` keeps it on the device."""

    def __init__(self, momentum=0.0, multi_precision=False,
                 warmup_strategy="linear", warmup_epochs=5, batch_scale=1,
                 updates_per_epoch=32, begin_epoch=0, num_epochs=60,
                 **kwargs):
        super().__init__(multi_precision=multi_precision, **kwargs)
        self.momentum = momentum
        self.warmup_strategy = warmup_strategy
        self.warmup_epochs = warmup_epochs
        self.batch_scale = batch_scale
        self.updates_per_epoch = updates_per_epoch
        self.init_updates = begin_epoch * updates_per_epoch
        self.num_epochs = num_epochs
        self.lbmult = 1.0

    def create_state(self, index, weight):
        return _zeros(weight) if self.momentum else None

    def _warmup_mult(self, nup):
        """Ramp 1 -> batch_scale over the warmup window."""
        span = self.warmup_epochs * self.updates_per_epoch
        top = float(self.batch_scale)
        if nup >= span:
            return top
        if span <= 1:
            return 1.0
        frac = {"linear": nup / span,
                "power2": (nup / span) ** 2,
                "sqrt": math.sqrt(nup / span)}.get(self.warmup_strategy)
        return 1.0 + (top - 1.0) * frac if frac is not None else 1.0

    @staticmethod
    def _lars_ratio(weight, g, wd):
        """Trust ratio ||w|| / (||g|| + wd ||w||) per layer; 1 where
        either norm is 0."""
        w2 = float((weight._data * weight._data).sum())
        g2 = float((g._data * g._data).sum())
        if not w2 or not g2:
            return 1.0
        return math.sqrt(w2 / (g2 + wd * w2 + 1e-18))

    def update(self, index, weight, grad, state):
        self._bump(index)
        wd = self._get_wd(index)
        if self.warmup_strategy == "lars":
            mult = self._lars_ratio(weight, grad, wd)
        else:
            mult = self._warmup_mult(self.num_update + self.init_updates)
        lr = self._get_lr(index) * mult
        if state is not None:
            self._fused("sgd_mom_update", weight, grad, (state,), lr=lr,
                        wd=wd, momentum=self.momentum)
        else:
            self._fused("sgd_update", weight, grad, lr=lr, wd=wd)


@register
class DCASGD(Optimizer):
    """Delay-compensated async SGD (reference: optimizer.py DCASGD:868):
    the gradient is corrected by lamda * g * g * (w - w_snapshot)."""

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum, self.lamda = momentum, lamda

    def create_state(self, index, weight):
        mom = _zeros(weight) if self.momentum else None
        return (mom, NDArray(weight._data.clone()))

    def update(self, index, weight, grad, state):
        self._bump(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        mom, snapshot = state
        with torch.no_grad():
            w = weight._data
            g = self._clipped(grad)
            g_comp = g + self.lamda * g * g * (w - snapshot._data)
            step = g_comp + wd * w
            if mom is not None:
                mom._data.copy_(self.momentum * mom._data - lr * step)
                w.add_(mom._data)
            else:
                w.sub_(lr * step)
            snapshot._data.copy_(w)


@register
class NAG(Optimizer):
    """Nesterov accelerated SGD (reference: optimizer.py NAG:938)."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        return _zeros(weight) if self.momentum else None

    def update(self, index, weight, grad, state):
        self._bump(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        if state is not None:
            self._fused("nag_mom_update", weight, grad, (state,), lr=lr,
                        wd=wd, momentum=self.momentum)
        else:
            self._fused("sgd_update", weight, grad, lr=lr, wd=wd)


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics: SGD plus N(0, lr) noise
    (reference: optimizer.py SGLD:976).  The noise is drawn from
    *generator*, or from a generator seeded 0 on the weight's device."""

    def __init__(self, generator=None, **kwargs):
        super().__init__(**kwargs)
        self.generator = generator

    def update(self, index, weight, grad, state):
        self._bump(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        w = weight._data
        if self.generator is None:
            self.generator = torch.Generator(device=w.device)
            self.generator.manual_seed(0)
        with torch.no_grad():
            noise = torch.randn(w.shape, generator=self.generator,
                                device=w.device, dtype=w.dtype) * \
                math.sqrt(lr)
            w.copy_(w - lr / 2 * (self._clipped(grad) + wd * w) + noise)


@register
class Adam(Optimizer):
    """Adam with the bias correction folded into lr (reference:
    optimizer.py Adam:1003)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    def update(self, index, weight, grad, state):
        t = self._bump(index)
        lr = self._get_lr(index) * \
            math.sqrt(1.0 - self.beta2 ** t) / (1.0 - self.beta1 ** t)
        mean, var = state
        self._fused("adam_update", weight, grad, (mean, var), lr=lr,
                    wd=self._get_wd(index), beta1=self.beta1,
                    beta2=self.beta2, epsilon=self.epsilon)


@register
class AdaGrad(Optimizer):
    """AdaGrad, with a lazy row update for a row-sparse gradient
    (reference: optimizer.py AdaGrad:1140 over _sparse_adagrad_update)."""

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return _zeros(weight)

    def update(self, index, weight, grad, state):
        self._bump(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        from ..ndarray import sparse as _sp
        if isinstance(grad, _sp.RowSparseNDArray):
            _sp.adagrad_row_update(weight, grad, state, lr=lr, wd=wd,
                                   epsilon=self.float_stable_eps,
                                   **self._knobs())
            return
        self._fused("_sparse_adagrad_update", weight, self._densify(grad),
                    (state,), lr=lr, wd=wd, epsilon=self.float_stable_eps)


@register
class RMSProp(Optimizer):
    """RMSProp, plain or centered (reference: optimizer.py RMSProp:1063)."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1, self.gamma2 = gamma1, gamma2
        self.centered, self.epsilon = centered, epsilon
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        if self.centered:
            return tuple(_zeros(weight, torch.float32) for _ in range(3))
        return _zeros(weight, torch.float32)

    def update(self, index, weight, grad, state):
        self._bump(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        extra = {"clip_weights": self.clip_weights} \
            if self.clip_weights else {}
        if self.centered:
            self._fused("rmspropalex_update", weight, grad, state, lr=lr,
                        wd=wd, gamma1=self.gamma1, gamma2=self.gamma2,
                        epsilon=self.epsilon, **extra)
        else:
            self._fused("rmsprop_update", weight, grad, (state,), lr=lr,
                        wd=wd, gamma1=self.gamma1, epsilon=self.epsilon,
                        **extra)


@register
class AdaDelta(Optimizer):
    """AdaDelta (reference: optimizer.py AdaDelta:1224; no lr)."""

    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho, self.epsilon = rho, epsilon

    def create_state(self, index, weight):
        return (_zeros(weight, torch.float32), _zeros(weight, torch.float32))

    def update(self, index, weight, grad, state):
        self._bump(index)
        self._fused("adadelta_update", weight, grad, state, rho=self.rho,
                    epsilon=self.epsilon, wd=self._get_wd(index))


@register
class Ftrl(Optimizer):
    """FTRL-proximal (reference: optimizer.py Ftrl:1160)."""

    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1, self.beta = lamda1, beta

    def create_state(self, index, weight):
        return (_zeros(weight, torch.float32),      # z
                _zeros(weight, torch.float32))      # n

    def update(self, index, weight, grad, state):
        self._bump(index)
        self._fused("ftrl_update", weight, grad, state,
                    lr=self._get_lr(index), wd=self._get_wd(index),
                    lamda1=self.lamda1, beta=self.beta)


@register
class Adamax(Optimizer):
    """Adam under the infinity norm (reference: optimizer.py
    Adamax:1264)."""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2 = beta1, beta2

    def create_state(self, index, weight):
        return (_zeros(weight, torch.float32), _zeros(weight, torch.float32))

    def update(self, index, weight, grad, state):
        t = self._bump(index)
        self._fused("adamax_update", weight, grad, state,
                    lr=self._get_lr(index), wd=self._get_wd(index),
                    beta1=self.beta1, beta2=self.beta2, t=t)


@register
class Nadam(Optimizer):
    """Nesterov Adam (reference: optimizer.py Nadam:1319)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.schedule_decay = schedule_decay

    def create_state(self, index, weight):
        return (_zeros(weight, torch.float32), _zeros(weight, torch.float32))

    def update(self, index, weight, grad, state):
        t = self._bump(index)
        self._fused("nadam_update", weight, grad, state,
                    lr=self._get_lr(index), wd=self._get_wd(index),
                    beta1=self.beta1, beta2=self.beta2,
                    epsilon=self.epsilon, t=t,
                    schedule_decay=self.schedule_decay)


@register
class Test(Optimizer):
    """The reference's test optimizer: w -= lr * rescale_grad * grad."""

    def create_state(self, index, weight):
        return _zeros(weight)

    def update(self, index, weight, grad, state):
        with torch.no_grad():
            weight._data.sub_(self.learning_rate *
                              (grad._data * self.rescale_grad))


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
            self.states[index] = \
                self.optimizer.create_state_multi_precision(index, weight)
            self.states_synced[index] = True
        elif not self.states_synced[index]:
            # loaded states wait on the host until their weight is known
            self.states[index] = _on(self.states[index], weight.context)
            self.states_synced[index] = True
        self.optimizer.update_multi_precision(index, weight, grad,
                                              self.states[index])

    def get_states(self, dump_optimizer=False):
        """The states as the JAX package's format-2 blob (pickled): numpy
        payload, the optimizer's class name and hyper-parameter
        signature; with *dump_optimizer* the optimizer itself too (such
        a blob is refused by :meth:`set_states`, which unpickles numpy
        payloads only)."""
        blob = {"__format__": 2,
                "states": {k: _to_np(v) for k, v in self.states.items()},
                "opt_class": type(self.optimizer).__name__,
                "hyper_sig": [getattr(self.optimizer, a, None)
                              for a in _HYPER_ATTRS]}
        if dump_optimizer:
            blob["optimizer"] = self.optimizer
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


def states_mismatch(blob, optimizer):
    """'' when *blob* (``Updater.get_states`` bytes, or the unpickled
    dict) was written by an optimizer of *optimizer*'s class and baked
    hyper-parameters; otherwise the reason it was not.  A blob without
    the format-2 header validates vacuously."""
    try:
        data = _BlobUnpickler(io.BytesIO(blob)).load() \
            if isinstance(blob, (bytes, bytearray, memoryview)) else blob
    except Exception as exc:
        return "unreadable optimizer-state blob (%s: %s)" % (
            type(exc).__name__, exc)
    if not (isinstance(data, dict) and data.get("__format__") == 2):
        return ""
    want_cls = type(optimizer).__name__
    if data.get("opt_class") != want_cls:
        return ("blob was written by optimizer class %r, current "
                "optimizer is %r" % (data.get("opt_class"), want_cls))
    cur = [getattr(optimizer, a, None) for a in _HYPER_ATTRS]
    saved = data.get("hyper_sig")
    if saved is not None and list(saved) != cur:
        diffs = [a for a, x, y in zip(_HYPER_ATTRS, saved, cur) if x != y]
        return ("hyper-param signature changed since the blob was "
                "written: %s" % ", ".join(diffs or ["<layout>"]))
    return ""
