"""Gluon losses (port of ``mxnet_tpu/gluon/loss.py``).

Reduction semantics are the reference's: elementwise loss, then the
optional ``sample_weight`` (broadcast) and scalar ``weight``, then the
mean over every axis except ``batch_axis``.
"""

from __future__ import annotations

from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "L1Loss", "SigmoidBinaryCrossEntropyLoss",
           "SigmoidBCELoss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss",
           "KLDivLoss", "CTCLoss", "HuberLoss", "HingeLoss",
           "SquaredHingeLoss",
           "LogisticLoss", "TripletLoss"]


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

    def _elementwise(self, F, pred, label):
        raise NotImplementedError

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        # by default: the label takes pred's shape, the formula, reduce
        raw = self._elementwise(F, pred, F.reshape_like(label, pred))
        return self._per_sample(F, raw, sample_weight)


class L2Loss(Loss):
    """Half the squared error."""

    def __init__(self, weight=1.0, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def _elementwise(self, F, pred, label):
        return 0.5 * F.square(pred - label)


class L1Loss(Loss):
    """The absolute error."""

    def __init__(self, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def _elementwise(self, F, pred, label):
        return F.abs(pred - label)


class SigmoidBinaryCrossEntropyLoss(Loss):
    """Binary cross entropy on logits (default) or on probabilities
    (``from_sigmoid=True``), the positive class weighted by
    *pos_weight*."""

    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_sigmoid = from_sigmoid

    def hybrid_forward(self, F, pred, label, sample_weight=None,
                       pos_weight=None):
        label = F.reshape_like(label, pred)
        if self._from_sigmoid:
            eps = 1e-12         # away from log(0)
            hit = F.log(pred + eps) * label
            if pos_weight is not None:
                hit = F.broadcast_mul(hit, pos_weight)
            miss = F.log(1. - pred + eps) * (1. - label)
            raw = -(hit + miss)
        elif pos_weight is None:
            # max(x, 0) - x * z + log1p(exp(-|x|)), safe from overflow
            softplus_neg_abs = F.Activation(-F.abs(pred),
                                            act_type="softrelu")
            raw = F.relu(pred) - pred * label + softplus_neg_abs
        else:
            # the log1p term weighted by 1 + (pos_weight - 1) * z
            lw = 1. + F.broadcast_mul(pos_weight - 1., label)
            softplus = F.Activation(-F.abs(pred), act_type="softrelu") + \
                F.relu(-pred)
            raw = pred - pred * label + F.broadcast_mul(lw, softplus)
        return self._per_sample(F, raw, sample_weight)


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


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


class KLDivLoss(Loss):
    """KL(label || pred), *pred* log-probabilities by default
    (``from_logits``); the label's entropy term keeps the minimum at
    zero."""

    def __init__(self, from_logits=True, axis=-1, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._axis = axis

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        logp = pred if self._from_logits else \
            F.log_softmax(pred, axis=self._axis)
        raw = label * (F.log(label + 1e-12) - logp)
        return self._per_sample(F, raw, sample_weight)


class CTCLoss(Loss):
    """The CTCLoss op with blank the last class (the reference's
    warp-ctc binding), over batch-major (``layout`` "NTC") or time-major
    ("TNC") activations and labels laid out "NT" or "TN"; the optional
    length tensors become the op's gated inputs."""

    def __init__(self, layout="NTC", label_layout="NT", weight=None,
                 **kwargs):
        if layout not in ("NTC", "TNC") or label_layout not in ("NT", "TN"):
            raise ValueError("CTCLoss: layout must be NTC or TNC and "
                             "label_layout NT or TN, got %r, %r"
                             % (layout, label_layout))
        self._layout = layout
        self._label_layout = label_layout
        super().__init__(weight, label_layout.find("N"), **kwargs)

    def hybrid_forward(self, F, pred, label, pred_lengths=None,
                       label_lengths=None, sample_weight=None):
        if self._layout == "NTC":           # the op takes time-major data
            pred = F.SwapAxis(pred, dim1=0, dim2=1)
        if self._batch_axis == 1:
            label = F.SwapAxis(label, dim1=0, dim2=1)
        extra = [t for t in (pred_lengths, label_lengths) if t is not None]
        raw = F.CTCLoss(pred, label, *extra,
                        use_data_lengths=pred_lengths is not None,
                        use_label_lengths=label_lengths is not None,
                        blank_label="last")
        return self._scale(F, raw, sample_weight)


class HuberLoss(Loss):
    """Quadratic within *rho* of the target, linear beyond."""

    def __init__(self, rho=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._rho = rho

    def _elementwise(self, F, pred, label):
        err = F.abs(pred - label)
        quad = (0.5 / self._rho) * F.square(err)
        lin = err - 0.5 * self._rho
        return F.where(err > self._rho, lin, quad)


class HingeLoss(Loss):
    """max(0, margin - pred * label) for labels in {-1, 1}."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def _elementwise(self, F, pred, label):
        return F.relu(self._margin - pred * label)


class SquaredHingeLoss(Loss):
    """max(0, margin - pred * label) ** 2."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def _elementwise(self, F, pred, label):
        return F.square(F.relu(self._margin - pred * label))


class LogisticLoss(Loss):
    """Binary cross entropy on logits, labels in {-1, 1} ("signed") or
    {0, 1} ("binary")."""

    def __init__(self, weight=None, batch_axis=0, label_format="signed",
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._label_format = label_format

    def _elementwise(self, F, pred, label):
        if self._label_format == "signed":
            label = (label + 1.0) / 2.0
        softplus_neg_abs = F.Activation(-F.abs(pred), act_type="softrelu")
        return F.relu(pred) - pred * label + softplus_neg_abs


class TripletLoss(Loss):
    """max(0, margin + |a - p|^2 - |a - n|^2), the distances summed over
    the non-batch axes before the hinge."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, positive, negative,
                       sample_weight=None):
        d_pos = F.square(F.reshape_like(positive, pred) - pred)
        d_neg = F.square(F.reshape_like(negative, pred) - pred)
        gap = F.sum(d_pos - d_neg, axis=self._batch_axis, exclude=True)
        return self._scale(F, F.relu(gap + self._margin), sample_weight)
