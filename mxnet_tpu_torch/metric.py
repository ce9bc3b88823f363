"""Evaluation metrics (port of ``mxnet_tpu/metric.py``).

Each update reduces the batch where its predictions live: on the card
the label is moved there, the sums are taken in float64 on the device,
and only the sums are read back (one small readback a batch).  The
reference reads whole predictions to the host; a full-width LM batch of
probabilities is 2.1 GB, which takes seconds to read back.  ``CustomMetric``
(and ``np``) hands numpy arrays to its function, as the reference does.
"""

from __future__ import annotations

import math

import numpy as _np
import torch

from .ndarray import NDArray

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "TopKAccuracy",
           "F1", "MCC", "MAE", "MSE", "RMSE", "CrossEntropy",
           "NegativeLogLikelihood", "PearsonCorrelation", "Perplexity",
           "Loss", "Torch", "Caffe", "CustomMetric", "np", "create",
           "register"]

_REGISTRY = {}


def _t(x, device=None):
    """*x* as a detached tensor (on *device* when given)."""
    if isinstance(x, NDArray):
        x = x._data
    elif not isinstance(x, torch.Tensor):
        x = torch.from_numpy(_np.asarray(x))
    x = x.detach()
    return x if device is None else x.to(device)


def _read(*sums):
    """The device sums as Python numbers, in one readback."""
    return torch.stack([s.to(torch.float64) for s in sums]).tolist()


def check_label_shapes(labels, preds, shape=False):
    got = (labels.shape, preds.shape) if shape else (len(labels),
                                                    len(preds))
    if got[0] != got[1]:
        raise ValueError("Shape of labels {} does not match shape of "
                         "predictions {}".format(*got))


def _pairs(labels, preds, class_axis=None):
    """(label, pred) tensors on the pred's device; with *class_axis*,
    scores carrying a class axis the labels lack are argmaxed, and both
    flatten to int32 vectors."""
    if isinstance(labels, NDArray):
        labels = [labels]
    if isinstance(preds, NDArray):
        preds = [preds]
    for label, pred in zip(labels, preds):
        p = _t(pred)
        l = _t(label, p.device)
        if class_axis is not None:
            if p.dim() > 1 and p.numel() != l.numel():
                p = p.argmax(dim=class_axis)
            l = l.to(torch.int32).reshape(-1)
            p = p.to(torch.int32).reshape(-1)
        yield l, p


class EvalMetric:
    """Accumulator protocol: ``update`` folds one batch into
    (sum_metric, num_inst); ``get`` reports sum / num."""

    def __init__(self, name, output_names=None, label_names=None,
                 **kwargs):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self.reset()

    def __str__(self):
        return "EvalMetric: {}".format(dict(self.get_name_value()))

    def get_config(self):
        return dict(self._kwargs, metric=type(self).__name__,
                    name=self.name, output_names=self.output_names,
                    label_names=self.label_names)

    def update_dict(self, label, pred):
        def pick(table, names):
            if names is None:
                return list(table.values())
            return [table[n] for n in names if n in table]
        self.update(pick(label, self.label_names),
                    pick(pred, self.output_names))

    def update(self, labels, preds):
        raise NotImplementedError

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def get(self):
        value = (self.sum_metric / self.num_inst if self.num_inst
                 else float("nan"))
        return (self.name, value)

    def get_name_value(self):
        name, value = self.get()
        names = name if isinstance(name, list) else [name]
        values = value if isinstance(value, list) else [value]
        return list(zip(names, values))


def register(klass=None, name=None, aliases=()):
    """Register a metric class under its lower-cased name and aliases."""
    if klass is None:
        return lambda k: register(k, name, aliases)
    for key in (name or klass.__name__,) + tuple(aliases):
        _REGISTRY[key.lower()] = klass
    return klass


def create(metric, *args, **kwargs):
    """A metric from a name, a list of them (composite), a callable
    (custom) or an EvalMetric."""
    if callable(metric) and not isinstance(metric, type):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        composite = CompositeEvalMetric()
        for child in metric:
            composite.add(create(child, *args, **kwargs))
        return composite
    try:
        klass = _REGISTRY[metric.lower()]
    except KeyError:
        raise KeyError("metric %r is not registered; known: %s"
                       % (metric, sorted(_REGISTRY)))
    return klass(*args, **kwargs)


@register
class CompositeEvalMetric(EvalMetric):
    def __init__(self, metrics=None, name="composite", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)
        self.metrics = [create(m) for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric))

    def get_metric(self, index):
        return self.metrics[index]

    def update(self, labels, preds):
        for metric in self.metrics:
            metric.update(labels, preds)

    def reset(self):
        for metric in getattr(self, "metrics", []):
            metric.reset()

    def get(self):
        names, values = [], []
        for metric in self.metrics:
            name, value = metric.get()
            names += name if isinstance(name, list) else [name]
            values += value if isinstance(value, (list, tuple)) \
                else [value]
        return (names, values)


@register(aliases=("acc",))
class Accuracy(EvalMetric):
    def __init__(self, axis=1, name="accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, axis=axis)
        self.axis = axis

    def update(self, labels, preds):
        check_label_shapes([labels] if isinstance(labels, NDArray)
                           else labels,
                           [preds] if isinstance(preds, NDArray) else preds)
        for l, p in _pairs(labels, preds, class_axis=self.axis):
            hits, = _read((p == l).sum())
            self.sum_metric += int(hits)
            self.num_inst += l.numel()


@register(aliases=("top_k_accuracy", "top_k_acc"))
class TopKAccuracy(EvalMetric):
    def __init__(self, top_k=1, name="top_k_accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, top_k=top_k)
        self.top_k = top_k
        self.name += "_%d" % top_k

    def update(self, labels, preds):
        for l, p in _pairs(labels, preds):
            l = l.to(torch.int32).reshape(-1)
            if p.dim() == 1:
                hits = (p.to(torch.int32) == l).sum()
            else:
                top = torch.topk(p, self.top_k, dim=-1).indices
                hits = (top == l[:, None]).sum()
            self.sum_metric += int(_read(hits)[0])
            self.num_inst += p.shape[0]


class _BinaryConfusion(EvalMetric):
    """Shared tp / fp / tn / fn counts of binary classifiers."""

    def reset(self):
        super().reset()
        self._tp = self._fp = self._tn = self._fn = 0.0

    def update(self, labels, preds):
        for l, p in _pairs(labels, preds, class_axis=1):
            tp, fp, tn, fn = _read(((p == 1) & (l == 1)).sum(),
                                   ((p == 1) & (l == 0)).sum(),
                                   ((p == 0) & (l == 0)).sum(),
                                   ((p == 0) & (l == 1)).sum())
            self._tp += tp
            self._fp += fp
            self._tn += tn
            self._fn += fn
        self.sum_metric = self._score()
        self.num_inst = 1

    def _score(self):
        raise NotImplementedError


@register
class F1(_BinaryConfusion):
    def __init__(self, name="f1", output_names=None, label_names=None,
                 average="macro"):
        super().__init__(name, output_names, label_names)
        self.average = average

    def _score(self):
        precision = self._tp / max(self._tp + self._fp, 1e-12)
        recall = self._tp / max(self._tp + self._fn, 1e-12)
        return 2 * precision * recall / max(precision + recall, 1e-12)


@register
class MCC(_BinaryConfusion):
    def __init__(self, name="mcc", output_names=None, label_names=None,
                 average="macro"):
        super().__init__(name, output_names, label_names)

    def _score(self):
        terms = ((self._tp + self._fp) * (self._tp + self._fn) *
                 (self._tn + self._fp) * (self._tn + self._fn))
        denom = math.sqrt(terms) if terms > 0 else 1.0
        return (self._tp * self._tn - self._fp * self._fn) / denom


class _Regression(EvalMetric):
    """Per-batch error of regression metrics, in float64."""

    @staticmethod
    def _error(d):
        raise NotImplementedError

    def update(self, labels, preds):
        for l, p in _pairs(labels, preds):
            if l.dim() == p.dim() - 1:
                l = l[..., None]
            d = l.to(torch.float64) - p.to(torch.float64)
            self.sum_metric += self._error(d)
            self.num_inst += 1


@register
class MAE(_Regression):
    def __init__(self, name="mae", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    _error = staticmethod(lambda d: _read(d.abs().mean())[0])


@register
class MSE(_Regression):
    def __init__(self, name="mse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    _error = staticmethod(lambda d: _read((d * d).mean())[0])


@register
class RMSE(_Regression):
    def __init__(self, name="rmse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    _error = staticmethod(lambda d: math.sqrt(_read((d * d).mean())[0]))


def _picked(l, p):
    """The probability each row of *p* (rows over its last axis) gives
    its label, in float64; ids clamped into the class range."""
    flat = p.reshape(-1, p.shape[-1])
    ids = l.reshape(-1).to(torch.int64).clamp(0, flat.shape[1] - 1)
    return flat.gather(1, ids[:, None])[:, 0].to(torch.float64), ids


@register(aliases=("ce",))
class CrossEntropy(EvalMetric):
    def __init__(self, eps=1e-12, name="cross-entropy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, eps=eps)
        self.eps = eps

    def update(self, labels, preds):
        for l, p in _pairs(labels, preds):
            assert l.numel() == p.shape[0]
            picked, _ = _picked(l, p)
            self.sum_metric += _read(-torch.log(picked + self.eps).sum())[0]
            self.num_inst += l.numel()


@register(aliases=("nll_loss",))
class NegativeLogLikelihood(CrossEntropy):
    def __init__(self, eps=1e-12, name="nll-loss", output_names=None,
                 label_names=None):
        super().__init__(eps, name, output_names, label_names)


@register(aliases=("pearsonr",))
class PearsonCorrelation(EvalMetric):
    def __init__(self, name="pearsonr", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        for l, p in _pairs(labels, preds):
            r = torch.corrcoef(torch.stack([p.reshape(-1), l.reshape(-1)])
                               .to(torch.float64))[0, 1]
            self.sum_metric += _read(r)[0]
            self.num_inst += 1


@register
class Perplexity(EvalMetric):
    """exp of the mean negative log-likelihood of the labels, with an
    optional ignored padding label."""

    def __init__(self, ignore_label=None, axis=-1, name="perplexity",
                 output_names=None, label_names=None):
        super().__init__(name, output_names, label_names,
                         ignore_label=ignore_label)
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        for l, p in _pairs(labels, preds):
            picked, ids = _picked(l, p)
            n = ids.numel()
            if self.ignore_label is not None:
                pad = l.reshape(-1).to(torch.int64) == self.ignore_label
                picked = torch.where(pad, torch.ones_like(picked), picked)
                nll, n_pad = _read(
                    -torch.log(torch.clamp(picked, min=1e-10)).sum(),
                    pad.sum())
                n -= int(n_pad)
            else:
                nll, = _read(-torch.log(torch.clamp(picked,
                                                    min=1e-10)).sum())
            self.sum_metric += nll
            self.num_inst += n

    def get(self):
        if not self.num_inst:
            return (self.name, float("nan"))
        return (self.name, math.exp(self.sum_metric / self.num_inst))


@register
class Loss(EvalMetric):
    """Mean of raw loss outputs (no labels involved)."""

    def __init__(self, name="loss", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, _, preds):
        if isinstance(preds, NDArray):
            preds = [preds]
        for pred in preds:
            p = _t(pred)
            self.sum_metric += _read(p.to(torch.float64).sum())[0]
            self.num_inst += p.numel()


class Torch(Loss):
    def __init__(self, name="torch", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)


class Caffe(Loss):
    def __init__(self, name="caffe", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)


@register
class CustomMetric(EvalMetric):
    """Wrap a ``feval(label, pred) -> value | (sum, num)`` over numpy
    arrays."""

    def __init__(self, feval, name=None, allow_extra_outputs=False,
                 output_names=None, label_names=None):
        if name is None:
            name = feval.__name__
            if "<" in name:
                name = "custom(%s)" % name
        super().__init__(name, output_names, label_names)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        if not self._allow_extra_outputs:
            check_label_shapes(labels, preds)
        for l, p in _pairs(labels, preds):
            result = self._feval(l.cpu().numpy(), p.cpu().numpy())
            if isinstance(result, tuple):
                self.sum_metric += result[0]
                self.num_inst += result[1]
            else:
                self.sum_metric += result
                self.num_inst += 1


def np(numpy_feval, name=None, allow_extra_outputs=False):
    """A CustomMetric over a plain numpy function."""
    def feval(label, pred):
        return numpy_feval(label, pred)
    feval.__name__ = numpy_feval.__name__
    return CustomMetric(feval, name, allow_extra_outputs)
