"""Gluon losses (port of ``mxnet_tpu/gluon/loss.py``, subset: Loss and
SoftmaxCrossEntropyLoss).

Reduction semantics are the reference's: elementwise loss, then the
optional ``sample_weight`` (broadcast) and scalar ``weight``, then the
mean over every axis except ``batch_axis``.
"""

from __future__ import annotations

from .block import HybridBlock

__all__ = ["Loss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss"]


class Loss(HybridBlock):
    """Base class: holds the global ``weight`` scale and the batch axis
    the reduction keeps."""

    def __init__(self, weight, batch_axis, **kwargs):
        super().__init__(**kwargs)
        self._weight = weight
        self._batch_axis = batch_axis

    def __repr__(self):
        return "{}(batch_axis={}, w={})".format(
            type(self).__name__, self._batch_axis, self._weight)

    def _scale(self, F, loss, sample_weight):
        """Per-element ``sample_weight`` (broadcast), then the scalar
        ``weight``."""
        if sample_weight is not None:
            loss = F.broadcast_mul(loss, sample_weight)
        if self._weight is not None:
            loss = loss * self._weight
        return loss

    def _per_sample(self, F, loss, sample_weight):
        """Scale, then collapse everything but the batch axis."""
        loss = self._scale(F, loss, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        raise NotImplementedError


class SoftmaxCrossEntropyLoss(Loss):
    """Cross entropy over ``axis``: integer labels gather through pick
    (``sparse_label=True``), dense labels contract against the whole
    log-probability row.  ``from_logits=True`` takes *pred* as
    log-probabilities already."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        logp = pred if self._from_logits else \
            F.log_softmax(pred, axis=self._axis)
        if self._sparse_label:
            raw = -F.pick(logp, label, axis=self._axis, keepdims=True)
        else:
            raw = -F.sum(logp * F.reshape_like(label, logp),
                         axis=self._axis, keepdims=True)
        return self._per_sample(F, raw, sample_weight)


SoftmaxCELoss = SoftmaxCrossEntropyLoss
