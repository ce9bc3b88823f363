"""Gluon Trainer (port of ``mxnet_tpu/gluon/trainer.py``, subset: one
device).

``step(batch_size)`` rescales the gradients by ``1 / batch_size`` and
applies the optimizer to every parameter whose ``grad_req`` is not
'null', through one ``Updater``.  With one context there is nothing to
reduce, so ``allreduce_grads`` does nothing.  Optimizer state is saved
and loaded in the JAX package's format-2 blob, so either package resumes
from the other's ``save_states``.  Distributed kvstores are not ported.
"""

from __future__ import annotations

import os

from ..base import MXNetError
from .. import optimizer as opt
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]

# kvstore values that mean one device and no store
_ONE_DEVICE_KVSTORES = ("device", "local", None)


class Trainer:
    """Applies an optimizer to a set of Parameters (reference:
    trainer.py Trainer:27).  The parameters' context must resolve to a
    device: a gpu context raises without CUDA.  A distributed or other
    kvstore, ``compression_params`` and ``update_on_kvstore=True`` raise
    as not ported."""

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
        if kvstore not in _ONE_DEVICE_KVSTORES:
            raise MXNetError("kvstore %r is not ported: the port's Trainer "
                             "runs on one device (kvstore one of %s)"
                             % (kvstore, _ONE_DEVICE_KVSTORES))
        if compression_params is not None:
            raise MXNetError("compression_params is not ported: one device "
                             "sends no gradient")
        if update_on_kvstore:
            raise MXNetError("update_on_kvstore is not ported: the port's "
                             "Trainer runs the optimizer itself")
        self._contexts = self._check_contexts()
        self._init_optimizer(optimizer, optimizer_params or {})
        self._scale = self._optimizer.rescale_grad

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

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    @property
    def optimizer(self):
        return self._optimizer

    def step(self, batch_size, ignore_stale_grad=False):
        """Reduce the gradients (nothing to do on one device), then
        update every parameter with gradients rescaled by 1/batch_size
        (reference: trainer.py step:254).  As in the JAX package, no
        gradient is checked for staleness, so *ignore_stale_grad* changes
        nothing."""
        self.allreduce_grads()
        self.update(batch_size, ignore_stale_grad)

    def allreduce_grads(self):
        """Sum gradients across devices: one device holds the only copy,
        so there is nothing to sum."""

    def update(self, batch_size, ignore_stale_grad=False):
        """Apply the optimizer to every parameter with a gradient.  A
        parameter of ``grad_stype`` 'row_sparse' (``Embedding(
        sparse_grad=True)``) hands an optimizer with a lazy row update (SGD
        and AdaGrad, not under multi-precision) only its gradient's
        touched rows, found on the host (``sparse.compress_rowsparse``):
        rows the batch did not touch keep their weight and state bit for
        bit.  Every other optimizer takes the dense gradient."""
        from ..ndarray import sparse as _sp
        self._optimizer.rescale_grad = self._scale / batch_size
        lazy_ok = isinstance(self._optimizer, (opt.SGD, opt.AdaGrad)) \
            and not getattr(self._optimizer, "multi_precision", False)
        for i, param in enumerate(self._params):
            if param.grad_req == "null" or param._data is None:
                continue
            grad = param.grad()
            if param._grad_stype == "row_sparse" and lazy_ok:
                grad = _sp.compress_rowsparse(grad)
            self._updater(i, grad, param.data())

    def save_states(self, fname):
        """Write the optimizer states (format-2 blob) to *fname*, beside
        it first and then renamed over it."""
        tmp = "%s.tmp%d" % (fname, os.getpid())
        with open(tmp, "wb") as f:
            f.write(self._updater.get_states())
        os.replace(tmp, fname)

    def load_states(self, fname):
        """Read optimizer states written by ``save_states`` of either
        package; the trainer keeps its own optimizer."""
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())
