"""The tree-level optimizer layer of the fused train step (port of
``mxnet_tpu/optimizer/tree_opt.py``).

``make_tree_update(optimizer)`` maps the optimizer's update op
(``ops/optimizer_ops.py``, the same ops the per-index ``Updater`` runs)
over a name-keyed tree of parameters, so ``Executor.init_fused_step`` can
put the update inside the step's one program.  The ops update weights and
states in place, so a state tree here is the ``Updater``'s own state
tensors: ``import_from_updater`` hands them out (creating what the
Updater has not seen, as its lazy-create rule does) and
``export_to_updater`` has nothing to copy back.

The per-step scalars (lr after the scheduler, multipliers and Adam's bias
correction; wd after multipliers; the update count t) are resolved on the
host by ``host_hyper`` with the code the legacy loop runs, and enter the
program as 0-dim device tensors, so a moving learning rate changes no
program.  The hyper-parameters an op takes as Python numbers (momentum,
rescale_grad, ...) are baked in; ``hyper_sig`` snapshots them, and a
changed snapshot rebuilds the program.

Not ported: row-sparse (ids, values) gradients (ROADMAP queue A item 12).
"""

from __future__ import annotations

import math

import torch

from ..base import MXNetError
from ..ndarray import NDArray
from . import optimizer as _opt

__all__ = ["supports_fused", "host_hyper", "hyper_sig", "init_tree_state",
           "tree_update", "make_tree_update", "export_to_updater",
           "import_from_updater", "nonfinite_any", "select_tree",
           "guarded_tree_update"]

# every hyper-parameter a builder bakes into the program as a Python
# number (lr, wd and t are not here: they enter as device tensors)
_HYPER_ATTRS = _opt._HYPER_ATTRS


def hyper_sig(optimizer):
    """Snapshot of the baked hyper-parameters; compare across steps to
    notice a mid-run change."""
    return tuple(getattr(optimizer, a, None) for a in _HYPER_ATTRS)


def _get_op(name):
    from ..ops.registry import get_op
    return get_op(name)


def _is_rsp(g):
    return isinstance(g, tuple) and len(g) == 2


def _dense(g):
    if _is_rsp(g):
        raise MXNetError("row-sparse gradients are not ported to "
                         "mxnet_tpu_torch (ROADMAP queue A item 12)")
    return g


def _knobs(opt, op):
    """Rescale and clip knobs, with ftml's ``clip_grad`` spelling."""
    kw = {"rescale_grad": opt.rescale_grad}
    if opt.clip_gradient is not None:
        key = "clip_grad" if "clip_grad" in op.param_names \
            else "clip_gradient"
        kw[key] = opt.clip_gradient
    return kw


def _is_mp(w, state):
    return (isinstance(state, tuple) and len(state) == 2
            and isinstance(state[1], torch.Tensor)
            and state[1].dtype == torch.float32
            and w.dtype != torch.float32)


# -- per-class update builders ----------------------------------------------
# Each returns upd(w, g, state, lr, wd, t), updating w and state in place.


def _make_sgd(opt):
    kn = _knobs(opt, _get_op("sgd_update"))

    def upd(w, g, state, lr, wd, t):
        g = _dense(g)
        mom = opt.momentum
        if _is_mp(w, state):
            m, w32 = state
            if m is not None:
                _get_op("mp_sgd_mom_update").fn(w, g, m, w32, lr=lr,
                                                momentum=mom, wd=wd, **kn)
            else:
                _get_op("mp_sgd_update").fn(w, g, w32, lr=lr, wd=wd, **kn)
        elif state is not None:
            _get_op("sgd_mom_update").fn(w, g, state, lr=lr, momentum=mom,
                                         wd=wd, **kn)
        else:
            _get_op("sgd_update").fn(w, g, lr=lr, wd=wd, **kn)

    return upd


def _make_simple(op_name, static_of, needs_t=False):
    """Builder for optimizers that are one dense op over (weight, *state)."""

    def make(opt):
        op = _get_op(op_name)
        hyper = dict(static_of(opt))
        hyper.update(_knobs(opt, op))
        takes_lr = "lr" in op.param_names

        def upd(w, g, state, lr, wd, t):
            states = state if isinstance(state, tuple) \
                else (() if state is None else (state,))
            kw = dict(hyper, wd=wd)
            if takes_lr:
                kw["lr"] = lr
            if needs_t:
                kw["t"] = t
            op.fn(w, _dense(g), *states, **kw)

        return upd

    return make


def _per_state(mom_make, plain_make):
    """NAG and Signum pick their op per update from ``state is not
    None``, as the legacy loop does (a momentum raised from 0 mid-run
    keeps the existing None states momentumless)."""

    def make(opt):
        mom_upd, plain_upd = mom_make(opt), plain_make(opt)

        def upd(w, g, state, lr, wd, t):
            if state is None:
                return plain_upd(w, g, None, lr, wd, t)
            return mom_upd(w, g, state, lr, wd, t)

        return upd

    return make


def _make_rmsprop(opt):
    extra = {"clip_weights": opt.clip_weights} if opt.clip_weights else {}
    if opt.centered:
        return _make_simple(
            "rmspropalex_update",
            lambda o: dict(gamma1=o.gamma1, gamma2=o.gamma2,
                           epsilon=o.epsilon, **extra))(opt)
    return _make_simple(
        "rmsprop_update",
        lambda o: dict(gamma1=o.gamma1, epsilon=o.epsilon, **extra))(opt)


_BUILDERS = {
    _opt.SGD: _make_sgd,
    _opt.AdaGrad: _make_simple(
        "_sparse_adagrad_update", lambda o: {"epsilon": o.float_stable_eps}),
    _opt.NAG: _per_state(
        _make_simple("nag_mom_update", lambda o: {"momentum": o.momentum}),
        _make_simple("sgd_update", lambda o: {})),
    _opt.Signum: _per_state(
        _make_simple("signum_update",
                     lambda o: {"momentum": o.momentum, "wd_lh": o.wd_lh}),
        _make_simple("signsgd_update", lambda o: {})),
    _opt.RMSProp: _make_rmsprop,
    _opt.Adam: _make_simple(
        "adam_update",
        lambda o: dict(beta1=o.beta1, beta2=o.beta2, epsilon=o.epsilon)),
    _opt.AdaDelta: _make_simple(
        "adadelta_update", lambda o: dict(rho=o.rho, epsilon=o.epsilon)),
    _opt.Ftrl: _make_simple(
        "ftrl_update", lambda o: dict(lamda1=o.lamda1, beta=o.beta)),
    _opt.Adamax: _make_simple(
        "adamax_update", lambda o: dict(beta1=o.beta1, beta2=o.beta2),
        needs_t=True),
    _opt.Nadam: _make_simple(
        "nadam_update",
        lambda o: dict(beta1=o.beta1, beta2=o.beta2, epsilon=o.epsilon,
                       schedule_decay=o.schedule_decay), needs_t=True),
    _opt.FTML: _make_simple(
        "ftml_update",
        lambda o: dict(beta1=o.beta1, beta2=o.beta2, epsilon=o.epsilon),
        needs_t=True),
}
_BUILDERS[_opt.SignSGD] = _BUILDERS[_opt.Signum]


def supports_fused(optimizer):
    """True when *optimizer*'s class maps onto the tree ops.  Exact class
    match on purpose: a subclass overriding ``update`` (LBSGD's LARS host
    readbacks, DCASGD, SGLD's draws) keeps the legacy loop."""
    return type(optimizer) in _BUILDERS


def _with_generic_mp(opt, upd):
    """The generic float32-master update of ``update_multi_precision``:
    update the master with the float32 gradient, write the weight."""

    def wrapped(w, g, state, lr, wd, t):
        if not (opt.multi_precision and _is_mp(w, state)):
            return upd(w, g, state, lr, wd, t)
        inner, w32 = state
        upd(w32, _dense(g).float(), inner, lr, wd, t)
        w.copy_(w32)

    return wrapped


def make_tree_update(optimizer):
    """``fn(grads, params, state, lrs, wds, ts) -> (params, state)``: the
    optimizer's op over name-keyed trees, with per-name lr, wd and t
    (numbers or 0-dim tensors), updating params and state in place."""
    try:
        upd = _BUILDERS[type(optimizer)](optimizer)
    except KeyError:
        raise ValueError(
            "optimizer %r has no tree-level mapping; the fused train step "
            "supports %s" % (type(optimizer).__name__,
                             sorted(c.__name__ for c in _BUILDERS)))
    if type(optimizer) is not _opt.SGD:
        upd = _with_generic_mp(optimizer, upd)

    def tree_update_fn(grads, params, state, lrs, wds, ts):
        with torch.no_grad():
            for n in params:
                upd(params[n], grads[n], state[n], lrs[n], wds[n], ts[n])
        return params, state

    return tree_update_fn


# -- non-finite guard ---------------------------------------------------------

def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        return [t for s in tree for t in _tensors(s)]
    return []


def nonfinite_any(tree):
    """0-dim bool tensor: any floating leaf of *tree* holds a NaN or Inf
    (integer leaves are finite by construction).  Stays on the device."""
    bad = None
    for leaf in _tensors(tree):
        if leaf.is_floating_point():
            b = ~torch.isfinite(leaf).all()
            bad = b if bad is None else bad | b
    return bad if bad is not None else torch.zeros((), dtype=torch.bool)


def select_tree(pred, if_true, if_false):
    """Per-leaf ``where(pred, t, f)`` over two trees of one structure
    (None passes through); bit-identical to the chosen side."""
    if isinstance(if_true, torch.Tensor):
        return torch.where(pred, if_true, if_false)
    if isinstance(if_true, dict):
        return {k: select_tree(pred, if_true[k], if_false[k])
                for k in if_true}
    if isinstance(if_true, (tuple, list)):
        return type(if_true)(select_tree(pred, a, b)
                             for a, b in zip(if_true, if_false))
    return if_false


def guarded_tree_update(tree_update_fn):
    """Wrap a tree update with the non-finite guard: ``fn(grads, params,
    state, lrs, wds, ts) -> (params, state, skipped)``, *skipped* an int32
    0/1 tensor; on a bad step params and state stay bit-identical."""

    def guarded(grads, params, state, lrs, wds, ts):
        bad = nonfinite_any(grads)
        leaves = _tensors(params) + _tensors(state)
        kept = [t.clone() for t in leaves]
        tree_update_fn(grads, params, state, lrs, wds, ts)
        with torch.no_grad():
            for t, old in zip(leaves, kept):
                t.copy_(torch.where(bad, old, t))
        return params, state, bad.to(torch.int32)

    return guarded


def tree_update(optimizer, step, grads, params, state, lrs=None, wds=None):
    """One optimizer sweep over a tree at update count *step* for every
    name; lrs/wds default to the optimizer's flat lr (with Adam's bias
    correction at *step*) and wd."""
    if lrs is None:
        lr = optimizer.learning_rate
        if type(optimizer) is _opt.Adam:
            lr = lr * math.sqrt(1.0 - optimizer.beta2 ** step) / \
                (1.0 - optimizer.beta1 ** step)
        lrs = {n: lr for n in params}
    if wds is None:
        wds = {n: optimizer.wd for n in params}
    return make_tree_update(optimizer)(grads, params, state, lrs, wds,
                                       {n: step for n in params})


def host_hyper(optimizer, names, idx_of):
    """Advance each name's update count and resolve this step's (t, lr,
    wd) per name as one legacy sweep does (Adam's bias correction from
    that name's own count).  Returns (ts, lrs, wds) of Python numbers."""
    ts, lrs, wds = {}, {}, {}
    for n in names:
        ts[n] = optimizer._bump(idx_of[n])
    adam = type(optimizer) is _opt.Adam
    for n in names:
        i = idx_of[n]
        lr = optimizer._get_lr(i)
        if adam:
            t = ts[n]
            lr = lr * math.sqrt(1.0 - optimizer.beta2 ** t) / \
                (1.0 - optimizer.beta1 ** t)
        lrs[n] = lr
        wds[n] = optimizer._get_wd(i)
    return ts, lrs, wds


# -- state trees and the legacy Updater ---------------------------------------

def _to_tensors(s):
    if isinstance(s, NDArray):
        return s._data
    if isinstance(s, (tuple, list)):
        return tuple(_to_tensors(x) for x in s)
    return s


def _to_nd(s):
    if isinstance(s, torch.Tensor):
        return NDArray(s)
    if isinstance(s, (tuple, list)):
        return tuple(_to_nd(x) for x in s)
    return s


def init_tree_state(optimizer, params, idx_of=None):
    """Fresh per-name states from ``create_state_multi_precision`` (the
    legacy nesting and zeros), as tensors; *params* are NDArrays."""
    return {n: _to_tensors(optimizer.create_state_multi_precision(
        idx_of[n] if idx_of is not None else n, w))
        for n, w in params.items()}


def import_from_updater(updater, optimizer, params, idx_of):
    """The name-keyed tree of the Updater's own state tensors (on each
    weight's device), creating fresh state for indices it has not seen."""
    state = {}
    for n, w in params.items():
        i = idx_of[n]
        if i not in updater.states:
            updater.states[i] = optimizer.create_state_multi_precision(i, w)
        elif not updater.states_synced.get(i, True):
            updater.states[i] = _opt._on(updater.states[i], w.context)
        updater.states_synced[i] = True
        state[n] = _to_tensors(updater.states[i])
    return state


def export_to_updater(tree_state, updater, idx_of):
    """Point the Updater's states at the tree's tensors (in the legacy
    per-index nesting), so ``get_states`` serializes them."""
    for n, s in tree_state.items():
        updater.states[idx_of[n]] = _to_nd(s)
        updater.states_synced[idx_of[n]] = True
