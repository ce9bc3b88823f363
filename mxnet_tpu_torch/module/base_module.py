"""BaseModule — the high-level train, score and predict loops (port of
``mxnet_tpu/module/base_module.py``).

Not ported: checkpoint managers, mid-epoch resume and job state, the
supervisor heartbeat and elastic membership (ROADMAP queue A item 15).
``fit`` runs without them when their knobs are off and raises when one is
set.
"""

from __future__ import annotations

import logging
import time

from .. import metric as metric_mod
from .. import ndarray as nd
from ..base import MXNetError
from ..model import BatchEndParam

__all__ = ["BaseModule"]


def _as_list(obj):
    if obj is None:
        return []
    if isinstance(obj, (list, tuple)):
        return list(obj)
    return [obj]


class BaseModule:
    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.inputs_need_grad = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self._symbol = None

    # -- abstract interface ------------------------------------------------
    def forward(self, data_batch, is_train=None):
        raise NotImplementedError

    def backward(self, out_grads=None):
        raise NotImplementedError

    def update(self):
        raise NotImplementedError

    def get_outputs(self, merge_multi_context=True):
        raise NotImplementedError

    def update_metric(self, eval_metric, labels):
        raise NotImplementedError

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False,
             shared_module=None, grad_req="write"):
        raise NotImplementedError

    def init_params(self, initializer=None, arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        raise NotImplementedError

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        raise NotImplementedError

    def get_params(self):
        raise NotImplementedError

    def install_monitor(self, mon):
        raise NotImplementedError

    @property
    def symbol(self):
        return self._symbol

    # -- composite steps ---------------------------------------------------
    def forward_backward(self, data_batch):
        self.forward(data_batch, is_train=True)
        self.backward()

    def forward_backward_update(self, data_batch):
        """One training step (Module runs it as one program when it can)."""
        self.forward_backward(data_batch)
        self.update()

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init, allow_extra=allow_extra)

    @staticmethod
    def _fire(callbacks, param):
        for cb in _as_list(callbacks):
            cb(param)

    def _eval_batches(self, eval_data, num_batch, reset):
        """Inference batches, each with a lazy getter of its outputs
        trimmed of the batch's pad rows."""
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        for idx, batch in enumerate(eval_data):
            if idx == num_batch:
                return
            self.forward(batch, is_train=False)
            keep = -(batch.pad or 0) or None
            yield idx, batch, \
                lambda k=keep: [o[:k] for o in self.get_outputs()]

    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, score_end_callback=None, reset=True,
              epoch=0, sparse_row_id_fn=None):
        """Run *eval_metric* over *eval_data*; returns its name-value
        pairs."""
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)
        eval_metric.reset()
        seen = 0
        for idx, batch, _ in self._eval_batches(eval_data, num_batch,
                                                reset):
            self.update_metric(eval_metric, batch.label)
            seen = idx + 1
            self._fire(batch_end_callback, BatchEndParam(
                epoch=epoch, nbatch=idx, eval_metric=eval_metric,
                locals=locals()))
        if score_end_callback:
            self._fire(score_end_callback, BatchEndParam(
                epoch=epoch, nbatch=seen, eval_metric=eval_metric,
                locals=locals()))
        return eval_metric.get_name_value()

    def iter_predict(self, eval_data, num_batch=None, reset=True):
        for idx, batch, outs in self._eval_batches(eval_data, num_batch,
                                                   reset):
            yield outs(), idx, batch

    def predict(self, eval_data, num_batch=None, merge_batches=True,
                reset=True, always_output_list=False,
                sparse_row_id_fn=None):
        """The outputs over *eval_data*, pad rows trimmed, concatenated
        over batches (or a list per batch)."""
        collected = [[o.copy() for o in outs()]
                     for _, _, outs in self._eval_batches(
                         eval_data, num_batch, reset)]
        if not collected or not merge_batches:
            return collected
        if len({len(outs) for outs in collected}) != 1:
            raise MXNetError("Cannot merge batches, as num of outputs is "
                             "not the same in mini-batches")
        merged = [nd.concatenate(list(column)) for column in zip(*collected)]
        if len(merged) == 1 and not always_output_list:
            return merged[0]
        return merged

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", optimizer="sgd",
            optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=None, arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None,
            monitor=None, sparse_row_id_fn=None,
            checkpoint_manager=None, resume_from=None,
            checkpoint_every_n_batches=None, device_prefetch=None):
        """The training loop (reference: base_module.py fit:410): bind,
        init params and optimizer, then per epoch one
        ``forward_backward_update`` and metric update per batch with the
        batch-end callbacks, the epoch-end callbacks, and a score of
        *eval_data*.  ``device_prefetch`` (or ``MXNET_DEVICE_PREFETCH``)
        wraps *train_data* in a :class:`~..io.DevicePrefetcher` of that
        depth onto the module's first context for the loop."""
        assert num_epoch is not None, "please specify number of epochs"
        if checkpoint_manager is not None or resume_from is not None or \
                checkpoint_every_n_batches:
            raise MXNetError("fit's checkpoint manager, resume and job "
                             "state are not ported to mxnet_tpu_torch "
                             "(ROADMAP queue A item 15)")
        from ..io.device_prefetch import maybe_wrap
        ctx = getattr(self, "_context", None)     # a list, or one Context
        if isinstance(ctx, (list, tuple)):
            ctx = ctx[0] if ctx else None
        train_data, created_prefetcher = maybe_wrap(
            train_data, device_prefetch, device=ctx)
        try:
            self._fit_loop(
                train_data, eval_data, eval_metric, epoch_end_callback,
                batch_end_callback, kvstore, optimizer, optimizer_params,
                eval_end_callback, eval_batch_end_callback, initializer,
                arg_params, aux_params, allow_missing, force_rebind,
                force_init, begin_epoch, num_epoch, validation_metric,
                monitor)
        finally:
            if created_prefetcher:
                # the ring (depth x batch bytes on the device) and its
                # producer thread end with the loop
                train_data.close()

    def _fit_loop(self, train_data, eval_data, eval_metric,
                  epoch_end_callback, batch_end_callback, kvstore,
                  optimizer, optimizer_params, eval_end_callback,
                  eval_batch_end_callback, initializer, arg_params,
                  aux_params, allow_missing, force_rebind, force_init,
                  begin_epoch, num_epoch, validation_metric, monitor):
        from .. import initializer as init_mod
        if initializer is None:
            initializer = init_mod.Uniform(0.01)
        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        if monitor is not None:
            self.install_monitor(monitor)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)
        if validation_metric is None:
            validation_metric = eval_metric
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)

        for epoch in range(begin_epoch, num_epoch):
            epoch_start = time.perf_counter()
            eval_metric.reset()
            for nbatch, data_batch in enumerate(train_data):
                if monitor is not None:
                    monitor.tic()
                self.forward_backward_update(data_batch)
                self.update_metric(eval_metric, data_batch.label)
                if monitor is not None:
                    monitor.toc_print()
                self._fire(batch_end_callback, BatchEndParam(
                    epoch=epoch, nbatch=nbatch, eval_metric=eval_metric,
                    locals=locals()))
            drain = getattr(self, "drain_guard_readbacks", None)
            if drain is not None:
                drain()
            for name, val in eval_metric.get_name_value():
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            self.logger.info("Epoch[%d] Time cost=%.3f", epoch,
                             time.perf_counter() - epoch_start)
            snapshot = self.get_params()
            self.set_params(*snapshot)
            for cb in _as_list(epoch_end_callback):
                cb(epoch, self.symbol, *snapshot)
            if eval_data is not None:
                res = self.score(eval_data, validation_metric,
                                 score_end_callback=eval_end_callback,
                                 batch_end_callback=eval_batch_end_callback,
                                 epoch=epoch)
                for name, val in res:
                    self.logger.info("Epoch[%d] Validation-%s=%f", epoch,
                                     name, val)
            train_data.reset()
