"""BucketingModule — one Module per bucket key, all sharing one parameter
set (port of ``mxnet_tpu/module/bucketing_module.py``).

Each bucket key binds its own Module (an executor per sequence length)
on the default bucket's arrays (``bind(shared_module=...)``): every
bucket's parameter NDArray is the default bucket's object, so an update
through any bucket is what every other bucket reads.  The optimizer and
its Updater are created once and borrowed by every bucket.  A bucket
seen before is not bound again (``switch_bucket``).

As in the reference, a bucketing step is ``forward_backward`` +
``update`` (``BaseModule.forward_backward_update``): no bucket runs the
fused step, so there is no CUDA graph per bucket.
"""

from __future__ import annotations

import logging

from ..executor import _not_ported
from .base_module import BaseModule
from .module import Module

__all__ = ["BucketingModule"]


class BucketingModule(BaseModule):
    def __init__(self, sym_gen, default_bucket_key=None, logger=logging,
                 context=None, work_load_list=None,
                 fixed_param_names=None, state_names=None,
                 group2ctxs=None, compression_params=None):
        super().__init__(logger=logger)
        assert default_bucket_key is not None
        if group2ctxs:
            raise _not_ported("group2ctxs model parallelism", "item 16")
        self._sym_gen = sym_gen
        self._default_bucket_key = default_bucket_key
        self._context = context
        self._fixed_param_names = fixed_param_names
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None
        self._grad_req = "write"
        self._monitor = None

    def _reset_bind(self):
        self.binded = False
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None

    @property
    def data_names(self):
        if self.binded:
            return self._curr_module.data_names
        _, data_names, _ = self._call_sym_gen(self._default_bucket_key)
        return data_names

    @property
    def output_names(self):
        if self.binded:
            return self._curr_module.output_names
        symbol, _, _ = self._call_sym_gen(self._default_bucket_key)
        return symbol.list_outputs()

    @property
    def data_shapes(self):
        assert self.binded
        return self._curr_module.data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._curr_module.label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        return self._curr_module.output_shapes

    @property
    def symbol(self):
        assert self.binded
        return self._curr_module._symbol

    def _call_sym_gen(self, bucket_key):
        out = self._sym_gen(bucket_key)
        if isinstance(out, tuple):
            return out
        return out, ("data",), ("softmax_label",)

    def _new_module(self, bucket_key):
        symbol, data_names, label_names = self._call_sym_gen(bucket_key)
        return Module(symbol, data_names=data_names,
                      label_names=label_names, logger=self.logger,
                      context=self._context,
                      fixed_param_names=self._fixed_param_names)

    def get_params(self):
        assert self.params_initialized
        # every bucket shares the default bucket's arrays
        return self._buckets[self._default_bucket_key].get_params()

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        assert self.binded, "call bind before set_params"
        if self.params_initialized and not force_init:
            self.logger.warning(
                "Parameters already initialized and force_init=False; "
                "set_params call ignored")
            return
        default_mod = self._buckets[self._default_bucket_key]
        if not allow_missing:
            have = set(arg_params or {})
            missing = [n for n in default_mod._exec_group.param_names
                       if n not in have]
            if missing:
                raise RuntimeError(
                    "set_params missing parameters %s and allow_missing "
                    "is False" % missing)
        default_mod._set_exec_params(arg_params, aux_params)
        self.params_initialized = True

    def init_params(self, initializer=None, arg_params=None,
                    aux_params=None, allow_missing=False,
                    force_init=False, allow_extra=False):
        if self.params_initialized and not force_init:
            return
        assert self.binded
        self._buckets[self._default_bucket_key].init_params(
            initializer=initializer, arg_params=arg_params,
            aux_params=aux_params, allow_missing=allow_missing,
            force_init=force_init, allow_extra=allow_extra)
        self.params_initialized = True

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False,
             shared_module=None, grad_req="write"):
        if self.binded and not force_rebind:
            self.logger.warning("Already bound, ignoring bind()")
            return
        assert shared_module is None, \
            "shared_module for BucketingModule is not supported"
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._grad_req = grad_req
        module = self._new_module(self._default_bucket_key)
        module.bind(data_shapes, label_shapes, for_training,
                    inputs_need_grad, force_rebind=False,
                    grad_req=grad_req)
        self._buckets = {self._default_bucket_key: module}
        self._curr_module = module
        self._curr_bucket_key = self._default_bucket_key
        self.binded = True

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        """Bind the Module of *bucket_key* on the default bucket's arrays,
        or take the one bound before."""
        assert self.binded, "call bind before switching bucket"
        if bucket_key not in self._buckets:
            default_mod = self._buckets[self._default_bucket_key]
            module = self._new_module(bucket_key)
            module.bind(data_shapes, label_shapes, self.for_training,
                        self.inputs_need_grad, shared_module=default_mod,
                        grad_req=self._grad_req)
            # one optimizer and Updater for every bucket
            if default_mod.optimizer_initialized:
                self._borrow_optimizer(module, default_mod)
            if self._monitor is not None:
                module.install_monitor(self._monitor)
            self._buckets[bucket_key] = module
        self._curr_module = self._buckets[bucket_key]
        self._curr_bucket_key = bucket_key

    @staticmethod
    def _borrow_optimizer(module, shared_module):
        module._optimizer = shared_module._optimizer
        module._updater = shared_module._updater
        module._kvstore = shared_module._kvstore
        module._update_on_kvstore = shared_module._update_on_kvstore
        module.optimizer_initialized = True

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            return
        default_mod = self._buckets[self._default_bucket_key]
        default_mod.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                                   optimizer_params=optimizer_params,
                                   force_init=force_init)
        for key, mod in self._buckets.items():
            if key != self._default_bucket_key:
                self._borrow_optimizer(mod, default_mod)
        self.optimizer_initialized = True

    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        self.switch_bucket(data_batch.bucket_key, data_batch.provide_data,
                           data_batch.provide_label)
        self._curr_module.forward(data_batch, is_train=is_train)

    def forward_backward(self, data_batch):
        assert self.binded and self.params_initialized
        self.switch_bucket(data_batch.bucket_key, data_batch.provide_data,
                           data_batch.provide_label)
        self._curr_module.forward_backward(data_batch)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        self._curr_module.backward(out_grads)

    def update(self):
        assert self.binded and self.params_initialized and \
            self.optimizer_initialized
        self._curr_module.update()

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._curr_module.get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._curr_module.get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        assert self.binded and self.params_initialized
        self._curr_module.update_metric(eval_metric, labels, pre_sliced)

    def install_monitor(self, mon):
        assert self.binded
        self._monitor = mon
        for mod in self._buckets.values():
            mod.install_monitor(mon)

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False,
                        checkpoint_manager=None):
        """The default bucket's symbol and the shared parameters (and the
        shared Updater's states), the Module checkpoint layout."""
        if checkpoint_manager is not None:
            raise _not_ported("checkpoint managers", "item 15")
        self._buckets[self._default_bucket_key].save_checkpoint(
            prefix, epoch, save_optimizer_states)
