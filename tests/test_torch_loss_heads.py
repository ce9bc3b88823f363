"""The port's loss-head ops against the JAX package's, on the same numpy
inputs (fixed seed): SoftmaxOutput over its parameter grid,
LinearRegressionOutput, MAERegressionOutput, LogisticRegressionOutput,
BlockGrad and make_loss.

Each head's forward and its gradient (through ``torch.autograd.grad``
in the port, ``jax.vjp`` of the reference op in the JAX package, with a
random head gradient that both must ignore) agree within f32 rtol 1e-6 /
atol 1e-7: the same arithmetic, softmax summed in another order.  The
label's gradient is zero in both.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch.ops import registry as treg

import mxnet_tpu_torch as tmx

TOL = dict(rtol=1e-6, atol=1e-7)
HEADS = ("SoftmaxOutput", "Softmax", "LinearRegressionOutput",
         "MAERegressionOutput", "LogisticRegressionOutput", "BlockGrad",
         "stop_gradient", "make_loss", "MakeLoss")


@pytest.mark.parametrize("name", HEADS)
def test_contract_matches_jax(name):
    jop, top = jreg.get_op(name), treg.get_op(name)
    assert top.name == jop.name
    assert top.input_names == jop.input_names
    assert top.param_names == jop.param_names
    assert top.n_out({}) == jop.n_out({})


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes are tiny: one intra-op thread, so that the parallel test
    run does not oversubscribe the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grads(name, inputs, params, cot):
    """(forward, input gradients) of op *name* in both packages."""
    jfn = jreg.get_op(name).fn
    out, vjp = jax.vjp(lambda *a: jfn(*a, **params),
                       *[jnp.asarray(a) for a in inputs])
    jgrads = vjp(jnp.asarray(cot.reshape(out.shape)))
    ts = [torch.tensor(a, requires_grad=True) for a in inputs]
    tout = treg.get_op(name).fn(*ts, **params)
    tgrads = [None] * len(ts)
    if tout.requires_grad:          # BlockGrad's output is off the tape
        tgrads = torch.autograd.grad(tout, ts,
                                     torch.tensor(cot.reshape(tout.shape)),
                                     allow_unused=True)
    tgrads = [np.zeros_like(a) if g is None else g.numpy()
              for g, a in zip(tgrads, inputs)]
    return (np.asarray(out), [np.asarray(g) for g in jgrads],
            tout.detach().numpy(), tgrads)


SOFTMAX_SHAPES = [
    ("2d", dict(), (6, 5), (6,)),
    ("4d flattened", dict(), (3, 2, 2, 2), (3,)),
    ("multi_output", dict(multi_output=True), (2, 4, 3, 2), (2, 3, 2)),
    ("preserve_shape", dict(preserve_shape=True), (2, 3, 7), (2, 3)),
]
SOFTMAX_GRID = [
    dict(grad_scale=g, normalization=n, use_ignore=u, smooth_alpha=a)
    for g, n, u, a in itertools.product((1.0, 0.5), ("null", "batch",
                                                      "valid"),
                                        (False, True), (0.0, 0.1))]


@pytest.mark.parametrize("shape", SOFTMAX_SHAPES, ids=lambda s: s[0])
@pytest.mark.parametrize("params", SOFTMAX_GRID,
                         ids=lambda p: "-".join("%s=%s" % kv
                                                for kv in p.items()))
def test_softmax_output_matches_jax(shape, params):
    _, extra, dshape, lshape = shape
    rs = np.random.RandomState(0)
    data = rs.randn(*dshape).astype(np.float32)
    n_class = dshape[1] if extra.get("multi_output") else \
        (dshape[-1] if extra.get("preserve_shape") else
         int(np.prod(dshape[1:])))
    label = rs.randint(0, n_class, lshape).astype(np.float32)
    label.flat[0] = -1.0            # the ignored label, one row
    params = dict(params, ignore_label=-1.0, **extra)
    out = jreg.get_op("SoftmaxOutput").fn(jnp.asarray(data),
                                          jnp.asarray(label), **params)
    cot = rs.randn(*np.shape(out)).astype(np.float32)
    jo, jg, to, tg = _grads("SoftmaxOutput", [data, label], params, cot)
    np.testing.assert_allclose(to, jo, **TOL)
    np.testing.assert_allclose(tg[0], jg[0], **TOL)
    assert not tg[1].any() and not np.asarray(jg[1]).any()


@pytest.mark.parametrize("name", ["LinearRegressionOutput",
                                  "MAERegressionOutput",
                                  "LogisticRegressionOutput"])
@pytest.mark.parametrize("grad_scale", [1.0, 0.25])
@pytest.mark.parametrize("label_shape", [(6, 3), (18,)],
                         ids=["same", "flat"])
def test_regression_outputs_match_jax(name, grad_scale, label_shape):
    rs = np.random.RandomState(1)
    data = rs.randn(6, 3).astype(np.float32)
    label = rs.rand(*label_shape).astype(np.float32)
    cot = rs.randn(6, 3).astype(np.float32)
    jo, jg, to, tg = _grads(name, [data, label],
                            {"grad_scale": grad_scale}, cot)
    np.testing.assert_allclose(to, jo, **TOL)
    np.testing.assert_allclose(tg[0], jg[0], **TOL)
    assert not tg[1].any() and not np.asarray(jg[1]).any()


def test_block_grad_zeroes_the_gradient():
    rs = np.random.RandomState(2)
    x = rs.randn(4, 3).astype(np.float32)
    cot = rs.randn(4, 3).astype(np.float32)
    for name in ("BlockGrad", "stop_gradient"):
        jo, jg, to, tg = _grads(name, [x], {}, cot)
        np.testing.assert_array_equal(to, jo)
        assert not tg[0].any() and not np.asarray(jg[0]).any()
    # inside a graph: only the unblocked branch carries gradient
    a = tmx.sym.var("a")
    out = tmx.sym.make_loss(tmx.sym.sum(a * a + tmx.sym.BlockGrad(a * 3)))
    ex = out.bind(tmx.cpu(), {"a": tmx.nd.array(x, ctx=tmx.cpu())},
                  args_grad={"a": tmx.nd.zeros((4, 3), ctx=tmx.cpu())})
    ex.forward(is_train=True)
    ex.backward()
    np.testing.assert_allclose(ex.grad_dict["a"].asnumpy(), 2 * x, **TOL)


def test_make_loss_is_a_head():
    """make_loss passes its value through and takes the head gradient
    (ones by default) as its own."""
    rs = np.random.RandomState(3)
    x = rs.randn(5).astype(np.float32)
    cot = rs.randn(5).astype(np.float32)
    for name in ("make_loss", "MakeLoss"):
        jo, jg, to, tg = _grads(name, [x], {}, cot)
        np.testing.assert_array_equal(to, jo)
        np.testing.assert_allclose(tg[0], jg[0], **TOL)
    import mxnet_tpu as jmx
    outs = {}
    for pkg, mx in (("jax", jmx), ("port", tmx)):
        a = mx.sym.var("a")
        loss = mx.sym.MakeLoss(mx.sym.sum(mx.sym.square(a)))
        ex = loss.simple_bind(mx.cpu(), a=(5,))
        ex.arg_dict["a"][:] = x
        ex.forward(is_train=True)
        ex.backward()
        outs[pkg] = (ex.outputs[0].asnumpy(), ex.grad_dict["a"].asnumpy())
    for j, t in zip(outs["jax"], outs["port"]):
        np.testing.assert_allclose(t, j, **TOL)


# -- tests/test_autograd.py's two loss-head cases, mirrored ----------------

def test_stop_gradient_op():
    from mxnet_tpu_torch import autograd, nd
    x = nd.array([2.0], ctx=tmx.cpu())
    x.attach_grad()
    with autograd.record():
        y = nd.BlockGrad(x * 3) * x
    y.backward()
    np.testing.assert_allclose(x.grad.asnumpy(), [6.0])


def test_softmax_output_ce_grad():
    """Through the tape, SoftmaxOutput's gradient is softmax - onehot,
    equal to the JAX package's."""
    import mxnet_tpu as jmx
    rs = np.random.RandomState(4)
    d = rs.randn(4, 5).astype(np.float32)
    got = {}
    for pkg, mx in (("jax", jmx), ("port", tmx)):
        data = mx.nd.array(d, ctx=mx.cpu())
        label = mx.nd.array([0, 1, 2, 3], ctx=mx.cpu(), dtype="float32")
        data.attach_grad()
        with mx.autograd.record():
            out = mx.nd.SoftmaxOutput(data, label)
        out.backward()
        got[pkg] = (out.asnumpy(), data.grad.asnumpy())
    sm, grad = got["port"]
    oh = np.eye(5, dtype=np.float32)[[0, 1, 2, 3]]
    np.testing.assert_allclose(grad, sm - oh, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(grad, got["jax"][1], **TOL)
