"""SequentialModule — modules chained one after another (port of
``mxnet_tpu/module/sequential_module.py``).

Each child binds against the previous child's output shapes; data flows
through the chain on forward and gradients flow back in reverse on
backward (the later children bind with ``inputs_need_grad``).  Children
added with ``take_labels=True`` receive the batch's labels.
"""

from __future__ import annotations

import logging

from ..io import DataBatch, DataDesc
from .base_module import BaseModule

__all__ = ["SequentialModule"]


class SequentialModule(BaseModule):
    META_TAKE_LABELS = "take_labels"
    META_AUTO_WIRING = "auto_wiring"

    def __init__(self, logger=logging):
        super().__init__(logger=logger)
        self._modules = []
        self._metas = []
        self._label_shapes = None
        self._meta_keys = {self.META_TAKE_LABELS, self.META_AUTO_WIRING}

    def add(self, module, **kwargs):
        for key in kwargs:
            assert key in self._meta_keys, \
                "unknown meta %r (known: %s)" % (key, self._meta_keys)
        self._modules.append(module)
        self._metas.append(kwargs)
        self.binded = False
        self.params_initialized = False
        self.optimizer_initialized = False
        return self

    @property
    def data_names(self):
        return self._modules[0].data_names if self._modules else []

    @property
    def output_names(self):
        return self._modules[-1].output_names if self._modules else []

    @property
    def data_shapes(self):
        assert self.binded
        return self._modules[0].data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        return self._modules[-1].output_shapes

    def get_params(self):
        assert self.binded and self.params_initialized
        arg_params, aux_params = {}, {}
        for module in self._modules:
            arg, aux = module.get_params()
            arg_params.update(arg)
            aux_params.update(aux)
        return arg_params, aux_params

    def init_params(self, initializer=None, arg_params=None,
                    aux_params=None, allow_missing=False,
                    force_init=False, allow_extra=False):
        if self.params_initialized and not force_init:
            return
        assert self.binded
        for module in self._modules:
            module.init_params(initializer=initializer,
                               arg_params=arg_params,
                               aux_params=aux_params, allow_missing=True,
                               force_init=force_init, allow_extra=True)
        self.params_initialized = True

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False,
             shared_module=None, grad_req="write"):
        if self.binded and not force_rebind:
            return
        assert len(self._modules) > 0
        assert shared_module is None, \
            "shared_module is not supported for SequentialModule"
        self._label_shapes = label_shapes
        my_data_shapes = data_shapes
        anybody_ever_needs_label = False
        for i, (module, meta) in enumerate(zip(self._modules,
                                               self._metas)):
            meta_labels = meta.get(self.META_TAKE_LABELS, False)
            if meta_labels:
                anybody_ever_needs_label = True
            module.bind(
                data_shapes=my_data_shapes,
                label_shapes=label_shapes if meta_labels else None,
                for_training=for_training,
                # later modules need input gradients to continue the chain
                inputs_need_grad=(inputs_need_grad if i == 0
                                  else for_training),
                force_rebind=force_rebind, grad_req=grad_req)
            # the next module takes this one's outputs: their shapes by
            # shape inference (no output exists before a forward)
            sym = getattr(module, "symbol", None)
            if sym is not None:
                in_shapes = {d.name: d.shape for d in
                             (DataDesc(*s) if not isinstance(s, DataDesc)
                              else s for s in my_data_shapes)}
                _, out_shapes, _ = sym.infer_shape(**in_shapes)
                my_data_shapes = [
                    DataDesc(name, shape) for name, shape in
                    zip(sym.list_outputs(), out_shapes)]
            else:
                my_data_shapes = [
                    DataDesc(name, shape) for name, shape in
                    zip(module.output_names,
                        [d.shape if hasattr(d, "shape") else d[1]
                         for d in module.output_shapes])]
        if not anybody_ever_needs_label:
            self._label_shapes = None
        self.binded = True
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        assert self.binded and self.params_initialized
        for module in self._modules:
            module.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                                  optimizer_params=optimizer_params,
                                  force_init=force_init)
        self.optimizer_initialized = True

    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        batch = data_batch
        for i, module in enumerate(self._modules):
            module.forward(batch, is_train=is_train)
            if i == len(self._modules) - 1:
                break
            batch = DataBatch(data=module.get_outputs(),
                              label=data_batch.label,
                              pad=getattr(data_batch, "pad", 0))

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        for i, module in reversed(list(enumerate(self._modules))):
            module.backward(out_grads=out_grads)
            if i == 0:
                break
            out_grads = module.get_input_grads()

    def update(self):
        assert self.binded and self.params_initialized and \
            self.optimizer_initialized
        for module in self._modules:
            module.update()

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._modules[-1].get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.inputs_need_grad
        return self._modules[0].get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        assert self.binded and self.params_initialized
        for meta, module in zip(self._metas, self._modules):
            if meta.get(self.META_TAKE_LABELS, False):
                module.update_metric(eval_metric, labels)
        # the tail scores even without the labels meta (the common use,
        # where only the head takes labels)
        if not any(m.get(self.META_TAKE_LABELS, False)
                   for m in self._metas):
            self._modules[-1].update_metric(eval_metric, labels)

    def install_monitor(self, mon):
        assert self.binded
        for module in self._modules:
            module.install_monitor(mon)
