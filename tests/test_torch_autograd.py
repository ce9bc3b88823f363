"""The port's autograd against the JAX package's on the same small graphs.

Both packages run one graph of the ported ops (FullyConnected,
broadcast_mul/add, scalar multiply, negative, softmax, log_softmax, pick,
mean, sum) on the same numpy inputs under ``autograd.record()``, then
``backward``; gradients agree at f32 rtol 1e-5 / atol 1e-6 (the same
formulas, summed in another order).  Also: the recording and training
flags, ``pause``, ``grad_req`` 'write' / 'add' / 'null', head gradients,
and gluon Parameters' gradient buffers.
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


def _data(seed=0):
    rng = np.random.RandomState(seed)
    return dict(x=rng.standard_normal((3, 5)).astype(np.float32),
                w=rng.standard_normal((4, 5)).astype(np.float32),
                b=rng.standard_normal((4,)).astype(np.float32),
                s=rng.standard_normal((3, 4)).astype(np.float32),
                lab=np.array([0, 3, 1], np.float32))


def _graph(mx, a):
    """A loss over every ported op of the training path."""
    h = mx.nd.FullyConnected(a["x"], a["w"], a["b"], num_hidden=4)
    h = mx.nd.broadcast_mul(h, a["s"]) * 0.5
    logp = mx.nd.log_softmax(h, axis=-1)
    nll = -mx.nd.pick(logp, a["lab"], axis=-1, keepdims=True)
    p = mx.nd.softmax(h, axis=-1)
    return mx.nd.mean(nll, axis=0, exclude=True) + \
        mx.nd.sum(p * h, axis=-1)


def _run(mx, ag, data, reqs, passes=1, head_grad=None):
    ctx = mx.cpu()
    arrs = {k: mx.nd.array(v, ctx=ctx) for k, v in data.items()}
    for name, req in reqs.items():
        arrs[name].attach_grad(req)
    for _ in range(passes):
        with ag.record():
            out = _graph(mx, arrs)
        out.backward(None if head_grad is None
                     else mx.nd.array(head_grad, ctx=ctx))
    return out.asnumpy(), {n: arrs[n].grad.asnumpy() for n in reqs}


@pytest.mark.parametrize("reqs", [
    {"x": "write", "w": "write", "b": "write", "s": "write"},
    {"x": "add", "w": "write", "b": "null"},
    {"w": "add", "s": "add"}], ids=["write", "mixed", "add"])
@pytest.mark.parametrize("passes", [1, 2])
def test_backward_matches_jax_by_grad_req(reqs, passes):
    data = _data()
    jout, jg = _run(jmx, jag, data, reqs, passes)
    tout, tg = _run(tmx, tag, data, reqs, passes)
    np.testing.assert_allclose(tout, jout, **TOL)
    for name, req in reqs.items():
        np.testing.assert_allclose(tg[name], jg[name], **TOL)
        if req == "null":
            assert not tg[name].any()
    if passes == 2 and reqs.get("w") == "add":
        # 'add' sums both passes, 'write' keeps the last one
        _, once = _run(tmx, tag, data, {"w": "write"}, 1)
        np.testing.assert_allclose(tg["w"], 2 * once["w"], **TOL)


def test_head_gradient_matches_jax():
    data = _data(1)
    hg = np.random.RandomState(2).standard_normal(3).astype(np.float32)
    reqs = {"w": "write", "x": "write"}
    _, jg = _run(jmx, jag, data, reqs, head_grad=hg)
    _, tg = _run(tmx, tag, data, reqs, head_grad=hg)
    for name in reqs:
        np.testing.assert_allclose(tg[name], jg[name], **TOL)


def test_recording_and_training_flags():
    assert not tag.is_recording() and not tag.is_training()
    with tag.record():
        assert tag.is_recording() and tag.is_training()
        with tag.pause():
            assert not tag.is_recording() and not tag.is_training()
            with tag.train_mode():
                assert tag.is_training() and not tag.is_recording()
        with tag.predict_mode():
            assert not tag.is_training() and tag.is_recording()
    with tag.record(train_mode=False):
        assert tag.is_recording() and not tag.is_training()
    assert not tag.is_recording() and not tag.is_training()
    assert tag.set_recording(True) is False
    assert tag.set_training(True) is False
    assert tag.set_recording(False) is True
    assert tag.set_training(False) is True


@pytest.mark.parametrize("mx,ag", [(jmx, jag), (tmx, tag)],
                         ids=["jax", "port"])
def test_pause_and_unrecorded_ops_pass_no_gradient(mx, ag):
    x = mx.nd.array(np.array([1.0, 2.0, 3.0], np.float32), ctx=mx.cpu())
    x.attach_grad()
    with ag.record():
        y = x * 2.0
        with ag.pause():
            z = x * 3.0
        out = mx.nd.sum(y + z)
    out.backward()
    np.testing.assert_allclose(x.grad.asnumpy(), [2.0, 2.0, 2.0])
    # outside record nothing is taped: backward leaves the buffer alone
    out2 = mx.nd.sum(x * 5.0)
    out2.backward()
    np.testing.assert_allclose(x.grad.asnumpy(), [2.0, 2.0, 2.0])


def test_ndarray_surface_matches_jax():
    a = np.array([[1.5, -2.0], [0.25, 4.0]], np.float32)
    j = jmx.nd.array(a, ctx=jmx.cpu())
    t = tmx.nd.array(a, ctx=tmx.cpu())
    for f in (lambda m: -m, lambda m: m * 3.0, lambda m: 2.0 * m,
              lambda m: m * m, lambda m: m.mean(), lambda m: m.detach()):
        np.testing.assert_allclose(f(t).asnumpy(), f(j).asnumpy())
    one = tmx.nd.array(np.array([7.0], np.float32), ctx=tmx.cpu())
    assert one.asscalar() == 7.0 and one.wait_to_read() is one
    with pytest.raises(ValueError):
        t.asscalar()
    t.attach_grad()
    with tag.record():
        d = t.detach() * 2.0
    assert not d._data.requires_grad


def _dense(mx, gluon, w, b):
    net = gluon.nn.Dense(2, in_units=3, prefix="dense_")
    net.initialize(ctx=mx.cpu())
    net.weight.set_data(mx.nd.array(w, ctx=mx.cpu()))
    net.bias.set_data(mx.nd.array(b, ctx=mx.cpu()))
    return net


@pytest.mark.parametrize("req", ["write", "add", "null"])
def test_parameter_grad_buffers_match_jax(req):
    rng = np.random.RandomState(4)
    w = rng.standard_normal((2, 3)).astype(np.float32)
    b = rng.standard_normal(2).astype(np.float32)
    xs = [rng.standard_normal((4, 3)).astype(np.float32) for _ in range(2)]
    grads = []
    for mx, ag, gluon in ((jmx, jag, jgluon), (tmx, tag, tgluon)):
        net = _dense(mx, gluon, w, b)
        net.weight.grad_req = req
        for x in xs:
            with ag.record():
                out = mx.nd.sum(net(mx.nd.array(x, ctx=mx.cpu())))
            out.backward()
        if req == "null":
            with pytest.raises(RuntimeError, match="grad_req='null'"):
                net.weight.grad()
            grads.append(net.bias.grad().asnumpy())
        else:
            grads.append(net.weight.grad().asnumpy())
        params = net.collect_params()
        if req != "null":
            assert len(net.weight.list_grad()) == 1
        assert net.weight.list_ctx() == [mx.cpu()]
        assert len(net.weight.list_data()) == 1
        params.zero_grad()
        assert not net.bias.grad().asnumpy().any()
    np.testing.assert_allclose(grads[1], grads[0], **TOL)
