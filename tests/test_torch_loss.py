"""The port's SoftmaxCrossEntropyLoss against the JAX package's.

Same numpy predictions and labels through both losses, eager and
hybridized: the per-sample loss, and its gradient with respect to the
prediction under ``autograd.record()``, agree at f32 rtol 1e-5 /
atol 1e-6 (log_softmax and a mean, summed in another order).
"""

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag
from mxnet_tpu import gluon as jgluon

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import gluon as tgluon

TOL = dict(rtol=1e-5, atol=1e-6)

# (loss kwargs, pred shape, label kind, with sample_weight)
CASES = [
    (dict(), (4, 7), "sparse", False),
    (dict(), (2, 5, 7), "sparse", False),                  # LM-shaped
    (dict(sparse_label=False), (4, 7), "dense", False),
    (dict(from_logits=True), (4, 7), "sparse", False),
    (dict(weight=0.5), (4, 7), "sparse", True),
    (dict(axis=1, batch_axis=1), (5, 3, 4), "sparse_axis1", False),
    (dict(sparse_label=False, weight=2.0), (2, 5, 7), "dense", True),
]


def _inputs(shape, kind, with_sw, seed):
    rng = np.random.RandomState(seed)
    pred = rng.standard_normal(shape).astype(np.float32)
    if kind == "sparse":
        label = rng.randint(0, shape[-1], shape[:-1]).astype(np.float32)
    elif kind == "sparse_axis1":
        label = rng.randint(0, shape[1],
                            (shape[0],) + shape[2:]).astype(np.float32)
    else:
        label = rng.dirichlet(np.ones(shape[-1]),
                              shape[:-1]).astype(np.float32)
    sw = rng.uniform(0.5, 1.5, shape[:-1] + (1,)).astype(np.float32) \
        if with_sw else None
    return pred, label, sw


def _run(mx, ag, gluon, kwargs, pred, label, sw, hybridize):
    ctx = mx.cpu()
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss(**kwargs)
    if hybridize:
        loss_fn.hybridize()
    p = mx.nd.array(pred, ctx=ctx)
    p.attach_grad()
    args = [p, mx.nd.array(label, ctx=ctx)]
    if sw is not None:
        args.append(mx.nd.array(sw, ctx=ctx))
    with ag.record():
        loss = loss_fn(*args)
    loss.backward()
    return loss.asnumpy(), p.grad.asnumpy()


@pytest.mark.parametrize("hybridize", [False, True])
@pytest.mark.parametrize("i", range(len(CASES)))
def test_softmax_ce_matches_jax(i, hybridize):
    kwargs, shape, kind, with_sw = CASES[i]
    pred, label, sw = _inputs(shape, kind, with_sw, seed=i)
    jl, jg = _run(jmx, jag, jgluon, kwargs, pred, label, sw, hybridize)
    tl, tg = _run(tmx, tag, tgluon, kwargs, pred, label, sw, hybridize)
    assert tl.shape == jl.shape
    np.testing.assert_allclose(tl, jl, **TOL)
    np.testing.assert_allclose(tg, jg, **TOL)


def test_lm_loss_is_mean_nll_per_sample():
    pred, label, _ = _inputs((2, 5, 7), "sparse", False, seed=9)
    loss = tgluon.loss.SoftmaxCrossEntropyLoss()(
        tmx.nd.array(pred, ctx=tmx.cpu()), tmx.nd.array(label, ctx=tmx.cpu()))
    logp = pred - np.log(np.exp(pred).sum(-1, keepdims=True))
    nll = -np.take_along_axis(logp, label.astype(int)[..., None], -1)
    np.testing.assert_allclose(loss.asnumpy(), nll.mean(axis=(1, 2)),
                               rtol=1e-5)
    assert tgluon.loss.SoftmaxCELoss is tgluon.loss.SoftmaxCrossEntropyLoss


@pytest.mark.parametrize("hybridize", [False, True])
def test_softmax_ce_out_of_range_labels_match_jax(hybridize):
    """Labels [5, -1] over 4 classes: the reference's pick reads NaN for
    5 and the last class for -1, so the losses are [nan, finite]."""
    pred = np.random.RandomState(0).standard_normal((2, 4)).astype(
        np.float32)
    label = np.array([5, -1], np.float32)
    jl, _ = _run(jmx, jag, jgluon, {}, pred, label, None, hybridize)
    tl, _ = _run(tmx, tag, tgluon, {}, pred, label, None, hybridize)
    assert np.isnan(tl[0]) and np.isnan(jl[0])
    logp = pred[1] - np.log(np.exp(pred[1]).sum())
    np.testing.assert_allclose(tl[1], -logp[-1], **TOL)
    np.testing.assert_allclose(tl[1], jl[1], **TOL)
