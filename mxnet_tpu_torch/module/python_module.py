"""PythonModule and PythonLossModule — modules written in Python (port of
``mxnet_tpu/module/python_module.py``).

``PythonModule`` keeps the bind and parameter bookkeeping of a module
with no parameters whose computation is Python; ``PythonLossModule``
makes a Python loss and gradient function the tail of a module chain
(usually inside a ``SequentialModule``).  Its gradient function gets the
scores and labels as NDArrays on the scores' device.
"""

from __future__ import annotations

import logging

from .. import ndarray as nd
from ..io import DataDesc
from .base_module import BaseModule

__all__ = ["PythonModule", "PythonLossModule"]


class PythonModule(BaseModule):
    """Subclass and implement forward and backward (and
    ``_compute_output_shapes`` when the outputs differ from the
    inputs)."""

    def __init__(self, data_names, label_names, output_names,
                 logger=logging):
        super().__init__(logger=logger)
        self._data_names = list(data_names)
        self._label_names = list(label_names or [])
        self._output_names = list(output_names)
        self._data_shapes = None
        self._label_shapes = None
        self._output_shapes = None

    @property
    def data_names(self):
        return self._data_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        return self._output_shapes

    def get_params(self):
        return {}, {}

    def init_params(self, initializer=None, arg_params=None,
                    aux_params=None, allow_missing=False,
                    force_init=False, allow_extra=False):
        self.params_initialized = True

    def update(self):
        pass

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        self.optimizer_initialized = True

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False,
             shared_module=None, grad_req="write"):
        if self.binded and not force_rebind:
            self.logger.warning("Already bound, ignoring bind()")
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        assert grad_req == "write"
        self._data_shapes = [
            d if isinstance(d, DataDesc) else DataDesc(*d)
            for d in data_shapes]
        self._label_shapes = ([
            d if isinstance(d, DataDesc) else DataDesc(*d)
            for d in label_shapes] if label_shapes else None)
        self._output_shapes = self._compute_output_shapes()
        self.binded = True

    def _compute_output_shapes(self):
        """Default: the outputs mirror the inputs one to one."""
        assert len(self._data_shapes) == len(self._output_names)
        return [DataDesc(name, d.shape) for name, d in
                zip(self._output_names, self._data_shapes)]

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        if self._label_shapes is None:
            return
        eval_metric.update(labels, self.get_outputs())


class PythonLossModule(PythonModule):
    """A loss in Python: forward keeps the scores, backward calls
    *grad_func(scores, labels)* (default: the softmax cross-entropy
    gradient, softmax(scores) - one_hot(labels))."""

    def __init__(self, name="pyloss", data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 grad_func=None):
        super().__init__(data_names, label_names,
                         [name + "_output"], logger=logger)
        self._name = name
        assert len(data_names) == 1
        self._scores = None
        self._labels = None
        self._scores_grad = None
        self._grad_func = grad_func

    def _compute_output_shapes(self):
        return [DataDesc(self._name + "_output",
                         self._data_shapes[0].shape)]

    def forward(self, data_batch, is_train=None):
        self._scores = data_batch.data[0]
        if is_train is None:
            is_train = self.for_training
        if is_train and data_batch.label:
            # labels come from the host iterator: to the scores' device
            self._labels = data_batch.label[0].as_in_context(
                self._scores.context)

    def get_outputs(self, merge_multi_context=True):
        assert merge_multi_context
        return [self._scores]

    def backward(self, out_grads=None):
        assert out_grads is None, \
            "PythonLossModule is a loss head; out_grads not accepted"
        assert self.for_training
        if self._grad_func is not None:
            grad = self._grad_func(self._scores, self._labels)
            if not isinstance(grad, nd.NDArray):
                grad = nd.array(grad, ctx=self._scores.context)
            self._scores_grad = grad
        else:
            prob = nd.softmax(self._scores)
            onehot = nd.one_hot(self._labels, prob.shape[1])
            self._scores_grad = prob - onehot

    def get_input_grads(self, merge_multi_context=True):
        assert merge_multi_context
        return [self._scores_grad]

    def install_monitor(self, mon):
        raise NotImplementedError()
