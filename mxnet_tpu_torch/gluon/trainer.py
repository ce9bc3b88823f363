"""Gluon Trainer (port of ``mxnet_tpu/gluon/trainer.py``; reference:
python/mxnet/gluon/trainer.py Trainer:27, _init_kvstore:158, step:254,
allreduce_grads:282, update:314).

``step(batch_size)`` rescales the gradients by ``1 / batch_size`` and
applies the optimizer to every parameter whose ``grad_req`` is not
'null'.  Where the gradients are summed and the optimizer runs depends
on the kvstore, made at the first step:

* one device and a store name ('device', 'local', 'nccl', ...) or None:
  no store; one ``Updater`` applies the optimizer here, as before;
* a distributed store ('dist_sync', 'dist_async'): every parameter is
  initialized on the servers from rank 0's weights, and with
  ``update_on_kvstore`` (the default for dist) the optimizer is shipped
  to the servers, each step pushes the gradients, waits at a barrier and
  pulls the updated weights; without it the step pulls the summed
  gradients and updates here.  The rescale is ``1 / (batch_size x
  num_workers)``: the servers sum every worker's gradient sum, so the
  mean is over the global batch;
* a store object (``mx.kv.create(...)``): as a distributed store, its
  updater in the store.

``compression_params`` (2-bit, with error feedback) is handed to the
store.  Optimizer state is saved and loaded in the JAX package's format-2
blob, so either package resumes from the other's ``save_states``.
"""

from __future__ import annotations

import os
import warnings

from ..base import MXNetError
from .. import optimizer as opt
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]


class Trainer:
    """Applies an optimizer to a set of Parameters (reference:
    trainer.py Trainer:27).  The parameters' context must resolve to a
    device: a gpu context raises without CUDA."""

    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None):
        if isinstance(params, (dict, ParameterDict)):
            params = list(params.values())
        if not isinstance(params, (list, tuple)):
            raise ValueError("First argument must be a list or dict of "
                             "Parameters, got %s." % (type(params),))
        self._params = []
        for param in params:
            if not isinstance(param, Parameter):
                raise ValueError("First argument must be a list or dict of "
                                 "Parameters, got list of %s."
                                 % (type(param),))
            self._params.append(param)
        self._compression_params = compression_params
        self._contexts = self._check_contexts()
        self._init_optimizer(optimizer, optimizer_params or {})
        self._scale = self._optimizer.rescale_grad
        self._kvstore_type = kvstore
        self._kvstore = None
        self._kv_initialized = False
        self._update_on_kvstore = update_on_kvstore
        self._shipped_rescale = None

    def _check_contexts(self):
        contexts = []
        for param in self._params:
            if param._data is None and param._deferred_init is None:
                continue
            for ctx in param.list_ctx():
                ctx.torch_device    # a gpu context raises without CUDA
                if ctx not in contexts:
                    contexts.append(ctx)
        if len(contexts) > 1:
            raise MXNetError("the port's Trainer runs on one context; the "
                             "parameters are on %s" % contexts)
        return contexts

    def _init_optimizer(self, optimizer, optimizer_params):
        param_dict = {i: param for i, param in enumerate(self._params)}
        if isinstance(optimizer, opt.Optimizer):
            if optimizer_params:
                raise ValueError("optimizer_params must be None if optimizer "
                                 "is an Optimizer instance")
            self._optimizer = optimizer
            self._optimizer.param_dict = param_dict
        else:
            self._optimizer = opt.create(optimizer, param_dict=param_dict,
                                         **optimizer_params)
        self._updater = opt.get_updater(self._optimizer)

    def _init_kvstore(self):
        """Make the store of ``kvstore`` (see the module docstring) and
        register every initialized parameter with it (rank 0's weights,
        pulled back by every worker).  With ``update_on_kvstore`` the
        optimizer goes to the store at the first ``update``, carrying
        that step's rescale (``_set_rescale``)."""
        from .. import kvstore as kvs
        kv = self._kvstore_type
        if isinstance(kv, kvs.KVStoreBase):
            self._kvstore = kv
        elif isinstance(kv, str) and "dist" in kv:
            self._kvstore = kvs.create(kv)
        elif self._compression_params is not None:
            raise MXNetError("compression_params needs a distributed "
                             "kvstore or a store object; with %r the "
                             "Trainer sends no gradient" % (kv,))
        if self._kvstore is not None:
            if self._update_on_kvstore is None:
                self._update_on_kvstore = True
            if self._compression_params is not None:
                self._kvstore.set_gradient_compression(
                    self._compression_params)
            for i, param in enumerate(self._params):
                if param._data is None:
                    continue
                self._kvstore.init(i, param.data())
                self._kvstore.pull(i, out=param.list_data())
        elif self._update_on_kvstore:
            raise MXNetError("update_on_kvstore needs a kvstore; with %r "
                             "the Trainer has none" % (kv,))
        self._kv_initialized = True

    def _ship_optimizer(self):
        """With ``update_on_kvstore``, hand the optimizer to the store
        once, with the rescale it carries now."""
        if self._kvstore is not None and self._update_on_kvstore and \
                self._shipped_rescale is None:
            self._kvstore.set_optimizer(self._optimizer)
            self._shipped_rescale = self._optimizer.rescale_grad

    def _dist(self):
        return self._kvstore is not None and \
            "dist" in getattr(self._kvstore, "type", "")

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    @property
    def optimizer(self):
        return self._optimizer

    def _set_rescale(self, batch_size):
        """Rescale gradients by ``1 / (batch_size x workers)``, the
        workers of a distributed store (1 otherwise), and ship the
        optimizer to the store if it is not there yet.  A distributed
        store's servers keep the rescale they were shipped."""
        if not self._kv_initialized:
            self._init_kvstore()
        workers = self._kvstore.num_workers if self._dist() else 1
        self._optimizer.rescale_grad = self._scale / (batch_size * workers)
        if self._dist() and self._shipped_rescale not in \
                (None, self._optimizer.rescale_grad):
            warnings.warn(
                "the batch size changed since the optimizer went to the "
                "kvstore (update_on_kvstore): the store keeps rescaling "
                "gradients by %g, not %g" % (self._shipped_rescale,
                                             self._optimizer.rescale_grad))
            self._shipped_rescale = self._optimizer.rescale_grad
        self._ship_optimizer()

    def step(self, batch_size, ignore_stale_grad=False):
        """Reduce the gradients, then update every parameter with
        gradients rescaled by 1/batch_size, over the global batch for a
        distributed store (reference: trainer.py step:254).  As in the
        JAX package, no gradient is checked for staleness, so
        *ignore_stale_grad* changes nothing."""
        self.allreduce_grads()
        self.update(batch_size, ignore_stale_grad)

    def _live(self):
        return [(i, p) for i, p in enumerate(self._params)
                if p.grad_req != "null" and p._data is not None]

    def _wire_grad(self, param):
        """A parameter's gradient as it is pushed: a row-sparse
        parameter's as its touched rows (found on the host)."""
        from ..ndarray import sparse as _sp
        grad = param.grad()
        if param._grad_stype == "row_sparse":
            return _sp.compress_rowsparse(grad)
        return grad

    def allreduce_grads(self):
        """Sum the gradients through the kvstore when the optimizer runs
        here (push, then pull the sums into the gradient buffers); with
        no store, or with ``update_on_kvstore``, nothing to do here."""
        if not self._kv_initialized:
            self._init_kvstore()
        if self._kvstore is None or self._update_on_kvstore:
            return
        live = self._live()
        for i, param in live:
            self._kvstore.push(i, self._wire_grad(param))
        for i, param in live:
            self._kvstore.pull(i, out=param.list_grad())

    def update(self, batch_size, ignore_stale_grad=False):
        """Apply the optimizer to every parameter with a gradient.  With
        ``update_on_kvstore`` the store applies it: push the gradients,
        a barrier for a distributed store, pull the weights.  Here, a
        parameter of ``grad_stype`` 'row_sparse' (``Embedding(
        sparse_grad=True)``) hands an optimizer with a lazy row update (SGD
        and AdaGrad, not under multi-precision) only its gradient's
        touched rows, found on the host (``sparse.compress_rowsparse``):
        rows the batch did not touch keep their weight and state bit for
        bit.  Every other optimizer takes the dense gradient."""
        from ..ndarray import sparse as _sp
        self._set_rescale(batch_size)
        if self._kvstore is not None and self._update_on_kvstore:
            live = self._live()
            for i, param in live:
                self._kvstore.push(i, self._wire_grad(param))
            if self._dist():
                self._kvstore.barrier()
            for i, param in live:
                self._kvstore.pull(i, out=param.list_data())
            return
        lazy_ok = isinstance(self._optimizer, (opt.SGD, opt.AdaGrad)) \
            and not getattr(self._optimizer, "multi_precision", False)
        for i, param in self._live():
            grad = param.grad()
            if param._grad_stype == "row_sparse" and lazy_ok:
                grad = _sp.compress_rowsparse(grad)
            self._updater(i, grad, param.data())

    def _states_updater(self):
        if self._kvstore is not None and self._update_on_kvstore:
            return None
        return self._updater

    def save_states(self, fname):
        """Write the optimizer states (format-2 blob) to *fname*, beside
        it first and then renamed over it; with ``update_on_kvstore``
        the store's states (``KVStore.save_optimizer_states``)."""
        if not self._kv_initialized:
            self._init_kvstore()
        self._ship_optimizer()
        if self._states_updater() is None:
            self._kvstore.save_optimizer_states(fname)
            return
        tmp = "%s.tmp%d" % (fname, os.getpid())
        with open(tmp, "wb") as f:
            f.write(self._updater.get_states())
        os.replace(tmp, fname)

    def load_states(self, fname):
        """Read optimizer states written by ``save_states`` of either
        package; the trainer keeps its own optimizer."""
        if not self._kv_initialized:
            self._init_kvstore()
        self._ship_optimizer()
        if self._states_updater() is None:
            self._kvstore.load_optimizer_states(fname)
            return
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())
