"""Module — symbolic training on one or more devices (port of
``mxnet_tpu/module/module.py``).

Each context gets one Executor over the whole graph; the batch is split
across contexts, gradients are summed into the first context's executor
and the updated weights copied back to the others (``_ExecGroup``).

``forward_backward_update`` runs the step as one program when it can
(``_fused_ok``, or ``MXNET_MODULE_FUSED_STEP=0`` to turn it off): on one
device the whole step — forward, backward, the optimizer's tree update
and the optional non-finite guard — is ``Executor.init_fused_step``'s
program, one CUDA graph on the card; on several devices each runs its
forward and backward and one tree update follows the gradient sum.  The
fused step's optimizer state is the ``Updater``'s own state tensors
(``optimizer/tree_opt.py``), so fused and legacy steps interleave on one
state and ``save_optimizer_states`` writes the legacy format.

A Module runs on ``current_context()`` (the card) unless given
``context=mx.cpu()``; binding raises without CUDA.

Not ported: distributed and server-side kvstores, ``update_on_kvstore``
and elastic membership (ROADMAP queue A item 14), job state and
checkpoint managers (item 15), ``group2ctxs`` (item 16).  A local
kvstore over several devices is the in-process gradient sum.
"""

from __future__ import annotations

import collections
import logging
import os

from .base_module import BaseModule, _as_list
from ..base import MXNetError
from ..config import get_env
from ..executor import _not_ported
from ..context import Context, cpu, current_context
from .. import ndarray as nd
from ..ndarray import NDArray
from .. import optimizer as opt
from ..initializer import InitDesc
from ..model import load_checkpoint, save_checkpoint
from ..observability import events as _obs_events
from ..optimizer import tree_opt

__all__ = ["Module"]


class _ExecGroup:
    """One executor per context over slices of the batch (reference:
    executor_group.py DataParallelExecutorGroup:143)."""

    def __init__(self, symbol, contexts, data_names, label_names,
                 data_shapes, label_shapes, grad_req, fixed_param_names,
                 inputs_need_grad, shared_group=None):
        self.symbol = symbol
        self.contexts = contexts
        self.data_names = list(data_names)
        self.label_names = list(label_names or [])
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.param_names = [n for n in self.arg_names
                            if n not in self.data_names and
                            n not in self.label_names]
        self.batch_size = data_shapes[0][1][0]
        if self.batch_size % len(contexts):
            raise MXNetError("batch size %d cannot be evenly split across "
                             "%d devices" % (self.batch_size, len(contexts)))
        self.slice_size = self.batch_size // len(contexts)
        reqs = {}
        for name in self.arg_names:
            if name in self.data_names:
                reqs[name] = "write" if inputs_need_grad else "null"
            elif name in self.label_names or \
                    name in (fixed_param_names or ()):
                reqs[name] = "null"
            else:
                reqs[name] = grad_req
        self.grad_req = reqs
        shapes = {name: (self.slice_size,) + tuple(shape[1:])
                  for name, shape in list(data_shapes) +
                  list(label_shapes or [])}
        self.execs = [
            symbol.simple_bind(ctx=ctx, grad_req=reqs,
                               shared_exec=shared_group.execs[i]
                               if shared_group else None, **shapes)
            for i, ctx in enumerate(contexts)]

    def _feeds(self, data_batch):
        """Per executor, {input name: its slice of the batch}."""
        arrays = list(zip(self.data_names, _as_list(data_batch.data)))
        arrays += [(n, a) for n, a in zip(self.label_names,
                                          _as_list(data_batch.label))
                   if n in self.execs[0].arg_dict]
        feeds = []
        for i in range(len(self.execs)):
            lo, hi = i * self.slice_size, (i + 1) * self.slice_size
            feeds.append({n: a[lo:hi] if len(self.execs) > 1 and
                          a.shape[0] == self.batch_size else a
                          for n, a in arrays})
        return feeds

    def forward(self, data_batch, is_train=False):
        for ex, feed in zip(self.execs, self._feeds(data_batch)):
            ex.forward(is_train=is_train, **feed)

    def forward_backward(self, data_batch):
        for ex, feed in zip(self.execs, self._feeds(data_batch)):
            ex.forward_backward(**feed)

    def backward(self, out_grads=None):
        for ex in self.execs:
            ex.backward(out_grads)

    def get_outputs(self, merge_multi_context=True):
        if len(self.execs) == 1:
            return list(self.execs[0].outputs)
        if not merge_multi_context:
            return [list(ex.outputs) for ex in self.execs]
        return [nd.concatenate([ex.outputs[i].as_in_context(
            self.contexts[0]) for ex in self.execs], axis=0)
            for i in range(len(self.execs[0].outputs))]

    def reduce_grads(self):
        """Sum the gradients of every executor into each one (the local
        kvstore's push and pull)."""
        if len(self.execs) == 1:
            return
        for name in self.param_names:
            if self.grad_req[name] == "null":
                continue
            total = self.execs[0].grad_dict[name]
            for ex in self.execs[1:]:
                total._data = total._data + \
                    ex.grad_dict[name]._data.to(total._data.device)
            for ex in self.execs[1:]:
                total.copyto(ex.grad_dict[name])

    def broadcast_params(self):
        for table, names in (("arg_dict", self.param_names),
                             ("aux_dict", self.aux_names)):
            for name in names:
                src = getattr(self.execs[0], table)[name]
                for ex in self.execs[1:]:
                    src.copyto(getattr(ex, table)[name])


class Module(BaseModule):
    """A Symbol trained and run as a module (reference: module.py
    Module:60)."""

    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, work_load_list=None,
                 fixed_param_names=None, state_names=None,
                 group2ctxs=None, compression_params=None):
        super().__init__(logger=logger)
        if group2ctxs:
            raise _not_ported("group2ctxs model parallelism", "item 16")
        if context is None:
            context = current_context()
        if isinstance(context, Context):
            context = [context]
        self._context = list(context)
        self._symbol = symbol
        self._data_names = list(data_names or [])
        self._label_names = list(label_names or [])
        self._fixed_param_names = list(fixed_param_names or [])
        self._exec_group = None
        self._arg_params = None
        self._aux_params = None
        self._params_dirty = False
        self._optimizer = None
        self._updater = None
        self._kvstore = None
        self._grad_req = "write"
        self._monitor = None
        self._preload_opt_states = None
        # the fused step: a context dict, False once setup found a
        # blocker, None when not built
        self._fused = None
        # the fused step's state tree (the Updater's tensors); None:
        # import again before the next fused step
        self._fused_state = None
        # non-finite guard: explicit config (None: the env knobs)
        self._guard = None
        self._guard_skipped = 0
        self._guard_consec = 0
        self._guard_pending = collections.deque()
        self._step_seq = 0
        self._forward_pad = 0

    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """A Module over the checkpoint ``prefix``/*epoch* (parameters set
        at bind; optimizer states at ``init_optimizer``)."""
        sym, args, auxs = load_checkpoint(prefix, epoch, ctx=cpu())
        mod = Module(symbol=sym, **kwargs)
        mod._arg_params = args
        mod._aux_params = auxs
        mod.params_initialized = True
        if load_optimizer_states:
            mod._preload_opt_states = "%s-%04d.states" % (prefix, epoch)
        return mod

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        """``prefix-symbol.json``, ``prefix-NNNN.params`` and, with
        *save_optimizer_states*, ``prefix-NNNN.states`` (the reference's
        layout)."""
        arg_params, aux_params = self.get_params()
        save_checkpoint(prefix, epoch, self._symbol, arg_params, aux_params)
        if save_optimizer_states:
            self.save_optimizer_states("%s-%04d.states" % (prefix, epoch))

    def save_optimizer_states(self, fname):
        """The Updater's states as its format-2 blob (whichever path
        trained them: the fused step updates the Updater's tensors)."""
        assert self.optimizer_initialized
        tmp = "%s.tmp%d" % (fname, os.getpid())
        with open(tmp, "wb") as f:
            f.write(self._updater.get_states())
        os.replace(tmp, fname)

    def load_optimizer_states(self, fname):
        """Load states saved by :meth:`save_optimizer_states` (of either
        package) after checking they belong to this optimizer."""
        assert self.optimizer_initialized
        with open(fname, "rb") as f:
            self._apply_updater_states(f.read())

    def _apply_updater_states(self, blob):
        from ..resilience import StateMismatchError
        reason = opt.states_mismatch(blob, self._optimizer)
        self._fused_state = None
        if reason:
            if get_env("MXNET_OPTSTATE_MISMATCH").lower() == "reinit":
                self.logger.warning(
                    "optimizer state blob does not match the current "
                    "optimizer (%s); re-initializing optimizer state "
                    "(MXNET_OPTSTATE_MISMATCH=reinit)", reason)
                self._updater.states.clear()
                self._updater.states_synced.clear()
                return False
            raise StateMismatchError(
                "refusing to load optimizer state: %s (set "
                "MXNET_OPTSTATE_MISMATCH=reinit to warn and start from "
                "fresh state instead)" % reason)
        self._updater.set_states(blob)
        return True

    def job_state(self):
        raise _not_ported("job state (mid-epoch resume)", "item 15")

    def load_job_state(self, frag):
        raise _not_ported("job state (mid-epoch resume)", "item 15")

    def elastic_tick(self, train_data=None):
        raise _not_ported("elastic membership (dist stores)", "item 14")

    def resync_from_kvstore(self):
        raise _not_ported("elastic membership (dist stores)", "item 14")

    # -- properties --------------------------------------------------------
    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self._symbol.list_outputs()

    @property
    def data_shapes(self):
        assert self.binded
        return self._data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        return list(zip(self.output_names,
                        [o.shape for o in self._exec_group.get_outputs()]))

    # -- binding -----------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False,
             shared_module=None, grad_req="write"):
        if self.binded and not force_rebind:
            self.logger.warning("Already bound, ignoring bind()")
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._grad_req = grad_req

        def _norm(shapes):
            if shapes is None:
                return None
            return [(s.name, tuple(s.shape)) if hasattr(s, "name")
                    else (s[0], tuple(s[1])) for s in shapes]

        self._data_shapes = _norm(data_shapes)
        self._label_shapes = _norm(label_shapes)
        shared_group = shared_module._exec_group if shared_module is not \
            None else None
        self._exec_group = _ExecGroup(
            self._symbol, self._context, self._data_names,
            self._label_names, self._data_shapes, self._label_shapes,
            grad_req if for_training else "null",
            self._fixed_param_names, inputs_need_grad,
            shared_group=shared_group)
        if shared_module is not None and shared_module.params_initialized:
            group = self._exec_group
            if all(n in sx.arg_dict and ex.arg_dict[n] is sx.arg_dict[n]
                   for ex, sx in zip(group.execs, shared_group.execs)
                   for n in group.param_names):
                self.params_initialized = True
            else:
                self.logger.warning(
                    "shared_module bind: not all parameters could be "
                    "aliased (shape mismatch or missing); call init_params "
                    "on this module")
        # a rebind voids the fused program built on the old executors
        self._fused = None
        self._fused_state = None
        self.binded = True
        if self._arg_params is not None:
            self._set_exec_params(self._arg_params, self._aux_params)

    # -- parameters --------------------------------------------------------
    def init_params(self, initializer=None, arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        if self.params_initialized and not force_init:
            return
        assert self.binded, "call bind before initializing the parameters"
        from .. import initializer as init_mod
        if initializer is None:
            initializer = init_mod.Uniform(0.01)
        ex0 = self._exec_group.execs[0]
        for name in self._exec_group.param_names:
            arr = ex0.arg_dict[name]
            if arg_params is not None and name in arg_params:
                arg_params[name].copyto(arr)
            elif arg_params is not None and not allow_missing:
                raise RuntimeError("Parameter %r is missing from arg_params "
                                   "and allow_missing is False" % name)
            else:
                initializer(InitDesc(name), arr)
        for name in self._exec_group.aux_names:
            arr = ex0.aux_dict[name]
            if aux_params is not None and name in aux_params:
                aux_params[name].copyto(arr)
            else:
                initializer(InitDesc(name), arr)
        self._exec_group.broadcast_params()
        self.params_initialized = True
        self._params_dirty = False

    def _set_exec_params(self, arg_params, aux_params):
        ex0 = self._exec_group.execs[0]
        for name, arr in (arg_params or {}).items():
            if name in ex0.arg_dict:
                arr.copyto(ex0.arg_dict[name])
        for name, arr in (aux_params or {}).items():
            if name in ex0.aux_dict:
                arr.copyto(ex0.aux_dict[name])
        self._exec_group.broadcast_params()
        self.params_initialized = True

    def get_params(self):
        assert self.binded and self.params_initialized
        ex0 = self._exec_group.execs[0]
        return ({n: ex0.arg_dict[n].copy()
                 for n in self._exec_group.param_names},
                {n: ex0.aux_dict[n].copy()
                 for n in self._exec_group.aux_names})

    # -- optimizer ---------------------------------------------------------
    @staticmethod
    def _create_kvstore(kvstore, num_device):
        """None: a local or device store is the in-process gradient sum
        here (and pointless on one device); a distributed store or a
        store object is not ported."""
        if kvstore and (not isinstance(kvstore, str) or "dist" in kvstore):
            raise _not_ported("distributed and object kvstores (%r)"
                              % (kvstore,), "item 14")
        return None

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        """Create the optimizer (gradients rescaled by 1/batch size unless
        *optimizer_params* says otherwise) and its Updater."""
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            return
        self._fused = None
        self._fused_state = None
        self._kvstore = self._create_kvstore(kvstore, len(self._context))
        if isinstance(optimizer, str):
            idx2name = dict(enumerate(self._exec_group.param_names))
            optimizer_params = dict(optimizer_params)
            optimizer_params.setdefault(
                "rescale_grad", 1.0 / self._exec_group.batch_size)
            optimizer = opt.create(optimizer, param_idx2name=idx2name,
                                   **optimizer_params)
        self._optimizer = optimizer
        self._updater = opt.get_updater(optimizer)
        if self._preload_opt_states:
            with open(self._preload_opt_states, "rb") as f:
                self._apply_updater_states(f.read())
            self._preload_opt_states = None
        self.optimizer_initialized = True

    # -- execution ---------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        if is_train is None:
            is_train = self.for_training
        self._forward_pad = 0
        if not is_train:
            data_batch = self._pad_remainder_batch(data_batch)
        self._exec_group.forward(data_batch, is_train)

    def _pad_remainder_batch(self, data_batch):
        """A ragged last inference batch zero-padded up to the bound batch
        size (its outputs trimmed by :meth:`get_outputs`) instead of a
        rebind to a new shape."""
        data = _as_list(data_batch.data)
        if not data or not getattr(data[0], "shape", None):
            return data_batch
        n = data[0].shape[0]
        bs = self._exec_group.batch_size
        if n >= bs:
            return data_batch
        from ..io import DataBatch

        def _pad(arrs):
            out = []
            for a in arrs:
                a = a if isinstance(a, NDArray) else nd.array(a, ctx=cpu())
                filler = nd.zeros((bs - n,) + tuple(a.shape[1:]),
                                  ctx=a.context, dtype=a.dtype)
                out.append(nd.concatenate([a, filler], axis=0))
            return out

        labels = _as_list(data_batch.label)
        self._forward_pad = bs - n
        return DataBatch(data=_pad(data), label=_pad(labels) if labels
                         else None, pad=data_batch.pad,
                         index=data_batch.index)

    def forward_backward(self, data_batch):
        """Forward on the tape and backward per device.  A subclass that
        overrides ``forward`` or ``backward`` gets them composed, so its
        override runs."""
        assert self.binded and self.params_initialized
        self._forward_pad = 0
        cls = type(self)
        if cls.forward is not Module.forward or \
                cls.backward is not Module.backward:
            self.forward(data_batch, is_train=True)
            self.backward()
            return
        self._exec_group.forward_backward(data_batch)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        self._exec_group.backward(out_grads)

    def update(self):
        """Sum the gradients across devices and run the Updater over every
        parameter (reference: module.py update:644)."""
        assert self.binded and self.params_initialized and \
            self.optimizer_initialized
        self._params_dirty = True
        group = self._exec_group
        group.reduce_grads()
        ex0 = group.execs[0]
        for i, name in enumerate(group.param_names):
            if group.grad_req[name] != "null":
                self._updater(i, ex0.grad_dict[name], ex0.arg_dict[name])
        group.broadcast_params()

    # -- non-finite guard ----------------------------------------------------
    def set_nonfinite_guard(self, enabled=True, max_consecutive=None,
                            action="raise", checkpoint_manager=None):
        """Skip steps whose loss or gradients hold NaN/Inf, leaving
        weights, optimizer state and auxiliary states as they were.
        *max_consecutive* bad steps in a row fire *action*: "raise"
        (:class:`~mxnet_tpu_torch.resilience.DivergenceError`) or a
        callable taking this module (None: ``MXNET_GUARD_MAX_BAD_STEPS``;
        0 only counts).  The "rollback" action needs checkpoint managers,
        which are not ported (ROADMAP queue A item 15)."""
        if action == "rollback" or checkpoint_manager is not None:
            raise _not_ported("the guard's rollback action", "item 15")
        self.drain_guard_readbacks(_cfg=self._guard_cfg())
        if enabled:
            if max_consecutive is None:
                max_consecutive = get_env("MXNET_GUARD_MAX_BAD_STEPS")
            self._guard = {"enabled": True,
                           "max_consecutive": max_consecutive or 0,
                           "action": action}
        else:
            self._guard = {"enabled": False}
        self._guard_consec = 0
        self._fused = None
        return self

    @property
    def nonfinite_skipped(self):
        """Training steps the guard skipped (deferred readbacks drained)."""
        self.drain_guard_readbacks()
        return self._guard_skipped

    def _guard_cfg(self):
        if self._guard is not None:
            return self._guard if self._guard["enabled"] else None
        if get_env("MXNET_GUARD_NONFINITE"):
            return {"enabled": True,
                    "max_consecutive": get_env("MXNET_GUARD_MAX_BAD_STEPS"),
                    "action": "raise"}
        return None

    def _account_guard(self, skipped, guard):
        """Account one fused step's skipped flag: at once, or parked and
        read at most ``MXNET_GUARD_READBACK_LAG`` steps later (FIFO)."""
        lag = max(0, get_env("MXNET_GUARD_READBACK_LAG"))
        if lag <= 0:
            self._note_guard(int(skipped), guard)
            return
        self._guard_pending.append((skipped.clone(), self._step_seq))
        while len(self._guard_pending) > lag:
            flag, step = self._guard_pending.popleft()
            self._note_guard(int(flag), guard, step=step)

    def drain_guard_readbacks(self, _cfg=None):
        """Read every deferred skipped flag now (a pending divergence
        action fires here)."""
        if not self._guard_pending:
            return
        cfg = _cfg or self._guard_cfg() or {
            "enabled": True, "max_consecutive": 0, "action": "raise"}
        while self._guard_pending:
            flag, step = self._guard_pending.popleft()
            self._note_guard(int(flag), cfg, step=step)

    def _grads_nonfinite(self):
        """The legacy path's guard check: any NaN/Inf in a gradient or an
        output of any device."""
        group = self._exec_group
        arrays = [ex.grad_dict[n] for ex in group.execs
                  for n in group.param_names
                  if group.grad_req[n] != "null"] + \
            [o for ex in group.execs for o in ex.outputs]
        return bool(tree_opt.nonfinite_any([a._data for a in arrays]))

    def _note_guard(self, skipped, guard, step=None):
        if step is None:
            step = self._step_seq
        if not skipped:
            self._guard_consec = 0
            return
        self._guard_skipped += 1
        self._guard_consec += 1
        _obs_events.emit("guard", step=step, consecutive=self._guard_consec,
                         total_skipped=self._guard_skipped)
        self.logger.warning(
            "non-finite loss/gradients: optimizer update skipped (%d "
            "consecutive, %d total)", self._guard_consec,
            self._guard_skipped)
        limit = guard.get("max_consecutive") or 0
        if limit and self._guard_consec >= limit:
            self._guard_consec = 0
            action = guard.get("action", "raise")
            _obs_events.emit("guard", divergence=True, step=step,
                             action=action if isinstance(action, str)
                             else "callable",
                             total_skipped=self._guard_skipped)
            if callable(action):
                action(self)
                return
            from ..resilience import DivergenceError
            raise DivergenceError(
                "training diverged: %d consecutive steps had non-finite "
                "loss/gradients (%d skipped in total); lower the learning "
                "rate or inspect the data pipeline"
                % (limit, self._guard_skipped))

    # -- the fused train step ----------------------------------------------
    def forward_backward_update(self, data_batch):
        """One training step: fused when ``_fused_ok`` (one program on one
        device, one tree update after the gradient sum on several), else
        ``forward_backward`` + ``update``.

        On the fused path the gradients live inside the program:
        ``grad_dict`` is not refreshed."""
        assert self.binded and self.params_initialized and \
            self.optimizer_initialized
        self._forward_pad = 0
        self._step_seq += 1
        guard = self._guard_cfg()
        if not self._fused_ok():
            self._legacy_step(data_batch, guard)
            return
        if self._fused is None:
            self._setup_fused()
        if self._fused is False:
            self._legacy_step(data_batch, guard)
            return
        if self._fused["hyper"] != tree_opt.hyper_sig(self._optimizer) or \
                self._fused["guard"] != (guard is not None):
            # a baked hyper-parameter changed, or the guard was toggled:
            # build again (the state tree stays valid)
            self.drain_guard_readbacks()
            self._setup_fused()
        if self._fused_state is None:
            self._import_fused_state()
        if self._fused["mode"] == "full":
            self._run_fused_full(data_batch)
        else:
            self._run_fused_partial(data_batch)

    def _legacy_step(self, data_batch, guard):
        self.drain_guard_readbacks()
        aux_snap = self._snapshot_aux() if guard is not None else None
        self.forward_backward(data_batch)
        if guard is not None and self._grads_nonfinite():
            self._restore_aux(aux_snap)
            self._note_guard(1, guard)
            return
        self.update()
        if guard is not None:
            self._note_guard(0, guard)

    def _snapshot_aux(self):
        """The auxiliary tensors of each executor (a forward rebinds them,
        so holding the handles keeps the old values)."""
        return [{n: a._data for n, a in ex.aux_dict.items()}
                for ex in self._exec_group.execs]

    def _restore_aux(self, snapshot):
        for ex, snap in zip(self._exec_group.execs, snapshot):
            for n, data in snap.items():
                ex.aux_dict[n]._data = data

    def _fused_ok(self):
        if not get_env("MXNET_MODULE_FUSED_STEP"):
            return False
        cls = type(self)
        if cls.forward_backward is not Module.forward_backward \
                or cls.update is not Module.update \
                or cls.forward is not Module.forward \
                or cls.backward is not Module.backward:
            # a subclass customizing a stage keeps the composed path, so
            # its override runs
            return False
        if self._monitor is not None or self.inputs_need_grad:
            return False
        if self._grad_req != "write":
            return False
        return tree_opt.supports_fused(self._optimizer)

    def _setup_fused(self):
        group = self._exec_group
        names = [n for n in group.param_names if group.grad_req[n] != "null"]
        if not names:
            self._fused = False
            return
        guard = self._guard_cfg() is not None
        tree_update = tree_opt.make_tree_update(self._optimizer)
        self._fused = {
            "names": names, "guard": guard,
            "idx": {n: i for i, n in enumerate(group.param_names)},
            "hyper": tree_opt.hyper_sig(self._optimizer),
            "mode": "full" if len(group.execs) == 1 else "partial",
            "tree": tree_opt.guarded_tree_update(tree_update)
            if guard and len(group.execs) > 1 else tree_update,
            "program": None}

    def _import_fused_state(self):
        ex0 = self._exec_group.execs[0]
        self._fused_state = tree_opt.import_from_updater(
            self._updater, self._optimizer,
            {n: ex0.arg_dict[n] for n in self._fused["names"]},
            self._fused["idx"])
        self._fused["program"] = None

    @property
    def fused_step(self):
        """The fused step's program (``Executor.FusedStep``: its
        ``captures`` and ``replays``), or None."""
        return self._fused["program"] if self._fused else None

    def _run_fused_full(self, data_batch):
        ctx = self._fused
        group = self._exec_group
        ex = group.execs[0]
        ex._pending = None      # a stale forward's record is not replayed
        if ctx["program"] is None:
            ctx["program"] = ex.init_fused_step(
                ctx["tree"], ctx["names"], self._fused_state,
                guard_nonfinite=ctx["guard"])
        batch = group._feeds(data_batch)[0]
        ts, lrs, wds = tree_opt.host_hyper(self._optimizer, ctx["names"],
                                           ctx["idx"])
        outs, skipped = ctx["program"](batch, lrs, wds, ts)
        ex.outputs = [NDArray(o) for o in outs]
        self._params_dirty = True
        if ctx["guard"]:
            self._account_guard(skipped, self._guard_cfg())

    def _run_fused_partial(self, data_batch):
        ctx = self._fused
        group = self._exec_group
        ex0 = group.execs[0]
        aux_snap = self._snapshot_aux() if ctx["guard"] else None
        group.forward_backward(data_batch)
        group.reduce_grads()
        names = ctx["names"]
        grads = {n: ex0.grad_dict[n]._data for n in names}
        params = {n: ex0.arg_dict[n]._data for n in names}
        ts, lrs, wds = tree_opt.host_hyper(self._optimizer, names,
                                           ctx["idx"])
        res = ctx["tree"](grads, params, self._fused_state, lrs, wds, ts)
        group.broadcast_params()
        self._params_dirty = True
        if ctx["guard"]:
            skipped = int(res[2])
            if skipped:
                self._restore_aux(aux_snap)
            self._note_guard(skipped, self._guard_cfg())

    # -- outputs -------------------------------------------------------------
    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        outs = self._exec_group.get_outputs(merge_multi_context)
        pad = self._forward_pad
        if pad and merge_multi_context:
            bs = self._exec_group.batch_size
            outs = [o[:bs - pad] if o.shape and o.shape[0] == bs else o
                    for o in outs]
        return outs

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.params_initialized and \
            self.inputs_need_grad
        grads = []
        for name in self._data_names:
            per_dev = [ex.grad_dict[name] for ex in self._exec_group.execs]
            if len(per_dev) == 1 or not merge_multi_context:
                grads.append(per_dev[0] if merge_multi_context else per_dev)
            else:
                grads.append(nd.concatenate(
                    [g.as_in_context(self._context[0]) for g in per_dev],
                    axis=0))
        return grads

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        outputs = self.get_outputs()
        eval_metric.update(labels, outputs[:len(labels)]
                           if labels else outputs)

    def install_monitor(self, mon):
        assert self.binded
        self._monitor = mon
        for ex in self._exec_group.execs:
            mon.install(ex)

    def reshape(self, data_shapes, label_shapes=None):
        assert self.binded
        arg_params, aux_params = self.get_params()
        self.bind(data_shapes, label_shapes, self.for_training,
                  self.inputs_need_grad, force_rebind=True)
        self._set_exec_params(arg_params, aux_params)
