"""``mx.operator`` and the ``Custom`` op of mxnet_tpu_torch against the JAX
package on the CPU (mirrors tests/test_custom_op.py): the same user
operators registered in both packages give the same outputs (within
1e-5 x max(1, max |JAX|)) and gradients (within 1e-4 x max |g|),
imperatively, in a bound Symbol and between native ops; an unregistered
op raises in both.  A Module over a graph with a ``Custom`` node takes
the legacy step (the user's Python may read back to the host) and
trains."""

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

PKGS = {"jax": jmx, "port": tmx}


def _register(mx):
    op_mod = mx.operator

    @op_mod.register("sqr")
    class SqrProp(op_mod.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=True)

        def create_operator(self, ctx, in_shapes, in_dtypes):
            class Sqr(op_mod.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    self.assign(out_data[0], req[0], in_data[0] * in_data[0])

                def backward(self, req, out_grad, in_data, out_data,
                             in_grad, aux):
                    self.assign(in_grad[0], req[0],
                                2 * in_data[0] * out_grad[0])
            return Sqr()

    @op_mod.register("twoout")
    class TwoOutProp(op_mod.CustomOpProp):
        """Two inputs, two outputs: (a+b, a*b)."""

        def list_arguments(self):
            return ["a", "b"]

        def list_outputs(self):
            return ["s", "p"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0], in_shape[0]], []

        def create_operator(self, ctx, in_shapes, in_dtypes):
            class TwoOut(op_mod.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    a, b = in_data
                    self.assign(out_data[0], req[0], a + b)
                    self.assign(out_data[1], req[1], a * b)

                def backward(self, req, out_grad, in_data, out_data,
                             in_grad, aux):
                    a, b = in_data
                    gs, gp = out_grad
                    self.assign(in_grad[0], req[0], gs + gp * b)
                    self.assign(in_grad[1], req[1], gs + gp * a)
            return TwoOut()


for _mx in PKGS.values():
    _register(_mx)


def _kw(mx):
    return {"ctx": tmx.cpu()} if mx is tmx else {}


def _close(got, want, tol=1e-5, scale=None):
    got, want = np.asarray(got), np.asarray(want)
    s = scale if scale is not None else max(1.0, np.abs(want).max())
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * s


def _both(fn):
    return fn(tmx), fn(jmx)


def test_custom_imperative_forward():
    x = np.array([[1.0, 2.0], [3.0, 4.0]], np.float32)
    got, want = _both(lambda mx: mx.nd.Custom(
        mx.nd.array(x, **_kw(mx)), op_type="sqr").asnumpy())
    _close(got, want)
    _close(got, x * x)


def test_custom_imperative_gradient():
    x0 = np.array([1.0, -2.0, 3.0], np.float32)

    def run(mx):
        x = mx.nd.array(x0, **_kw(mx))
        x.attach_grad()
        with mx.autograd.record():
            loss = mx.nd.sum(mx.nd.Custom(x, op_type="sqr"))
        loss.backward()
        return x.grad.asnumpy()

    got, want = _both(run)
    _close(got, want, 1e-4, np.abs(want).max())


def test_custom_symbolic_executor():
    x = np.array([[0.5, -1.5]], np.float32)

    def run(mx):
        sym = mx.sym.Custom(mx.sym.var("data"), op_type="sqr", name="csq")
        exe = sym.simple_bind(data=x.shape, grad_req="write", **_kw(mx))
        out = exe.forward(is_train=True, data=mx.nd.array(x, **_kw(mx)))
        exe.backward(out_grads=[mx.nd.ones(x.shape, **_kw(mx))])
        return out[0].asnumpy(), exe.grad_dict["data"].asnumpy()

    (o, g), (wo, wg) = _both(run)
    _close(o, wo)
    _close(g, wg, 1e-4, np.abs(wg).max())


def test_custom_multi_output():
    a = np.array([1.0, 2.0], np.float32)
    b = np.array([3.0, 5.0], np.float32)
    got, want = _both(lambda mx: [o.asnumpy() for o in mx.nd.Custom(
        mx.nd.array(a, **_kw(mx)), mx.nd.array(b, **_kw(mx)),
        op_type="twoout")])
    for g, w in zip(got, want):
        _close(g, w)


def test_custom_multi_output_gradient():
    def run(mx):
        a = mx.nd.array(np.array([1.0, 2.0], np.float32), **_kw(mx))
        b = mx.nd.array(np.array([3.0, 5.0], np.float32), **_kw(mx))
        a.attach_grad()
        b.attach_grad()
        with mx.autograd.record():
            s, p = mx.nd.Custom(a, b, op_type="twoout")
            loss = mx.nd.sum(s) + mx.nd.sum(p * p)
        loss.backward()
        return a.grad.asnumpy(), b.grad.asnumpy()

    got, want = _both(run)
    for g, w in zip(got, want):
        _close(g, w, 1e-4, np.abs(w).max())


def test_custom_inside_a_graph():
    x = np.array([[0.3, -0.7]], np.float32)

    def run(mx):
        h = mx.sym.tanh(mx.sym.var("data"))
        out = mx.sym.sum(mx.sym.Custom(h, op_type="sqr"))
        exe = out.simple_bind(data=x.shape, grad_req="write", **_kw(mx))
        o = exe.forward(is_train=True, data=mx.nd.array(x, **_kw(mx)))
        exe.backward(out_grads=[mx.nd.ones((), **_kw(mx))])
        return o[0].asnumpy(), exe.grad_dict["data"].asnumpy()

    (o, g), (wo, wg) = _both(run)
    _close(o, wo)
    _close(g, wg, 1e-4, np.abs(wg).max())


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_custom_unregistered_raises(pkg):
    mx = PKGS[pkg]
    with pytest.raises(mx.MXNetError):
        mx.nd.Custom(mx.nd.ones((2,), **_kw(mx)), op_type="nope_not_there")


def test_module_with_custom_takes_the_legacy_step_and_trains():
    rs = np.random.RandomState(0)
    x = rs.randn(64, 6).astype(np.float32)
    y = (x[:, 0] * x[:, 1] > 0).astype(np.float32)
    mx = tmx
    h = mx.sym.FullyConnected(mx.sym.var("data"), num_hidden=8, name="fc1")
    h = mx.sym.Custom(h, op_type="sqr", name="sq")
    out = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(h, num_hidden=2,
                                                     name="fc2"),
                               mx.sym.var("softmax_label"), name="sm")
    mod = mx.mod.Module(out, context=mx.cpu())
    losses = []

    def record(param):
        p = mod.get_outputs()[0].asnumpy()
        lab = param.locals["data_batch"].label[0].asnumpy().astype(int)
        losses.append(-np.log(p[np.arange(len(lab)), lab] + 1e-12).mean())

    mx.random.seed(0)
    mod.fit(mx.io.NDArrayIter(x, y, batch_size=16), num_epoch=3,
            optimizer="sgd", optimizer_params={"learning_rate": 0.05},
            initializer=mx.init.Xavier(), batch_end_callback=record)
    assert mod._needs_legacy_step() and mod.fused_step is None
    assert np.mean(losses[-4:]) < np.mean(losses[:4])
