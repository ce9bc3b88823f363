"""``autograd.grad`` (with and without ``create_graph``) and the custom
``autograd.Function`` of the PyTorch port, against ``jax.grad`` (of
``jax.grad``) and the JAX package's autograd on the same inputs (fixed
numpy seed); the cases of tests/test_autograd.py that use them mirrored,
with their tolerances.  Gradients are held to rtol 1e-5 (f32 of
differently ordered sums)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, nd

CPU = mx.cpu()
RTOL = 1e-5


def _a(x):
    return nd.array(x, ctx=CPU)


# -- tests/test_autograd.py, mirrored -----------------------------------------

def test_functional_grad():
    x = _a([1.0, 2.0, 3.0])
    x.attach_grad()
    with autograd.record():
        y = (x ** 3).sum()
    g = autograd.grad(y, x)
    np.testing.assert_allclose(g.asnumpy(), 3 * x.asnumpy() ** 2, rtol=1e-5)
    # x.grad untouched by functional grad
    np.testing.assert_allclose(x.grad.asnumpy(), np.zeros(3))


def test_grad_interior():
    x = _a([2.0])
    x.attach_grad()
    with autograd.record():
        u = x * x
        y = (u * 5).sum()
    gu = autograd.grad(y, u)
    np.testing.assert_allclose(gu.asnumpy(), [5.0])


def test_custom_function():
    class Sigmoid(autograd.Function):
        def forward(self, x):
            y = nd.sigmoid(x)
            self.save_for_backward(y)
            return y

        def backward(self, dy):
            y, = self.saved_tensors
            return dy * y * (1 - y)

    x = _a([0.5, -1.0])
    x.attach_grad()
    with autograd.record():
        y = Sigmoid()(x)
    y.backward()
    s = 1 / (1 + np.exp(-x.asnumpy()))
    np.testing.assert_allclose(x.grad.asnumpy(), s * (1 - s), rtol=1e-5)


def test_dropout_respects_mode():
    x = nd.ones((100, 100), ctx=CPU)
    out = nd.Dropout(x, p=0.5)
    np.testing.assert_allclose(out.asnumpy(), x.asnumpy())
    with autograd.record():
        out = nd.Dropout(x, p=0.5)
    frac = (out.asnumpy() == 0).mean()
    assert 0.4 < frac < 0.6


# -- against jax.grad ---------------------------------------------------------

FUNCS = [
    ("cube_sum", lambda m, x: (x ** 3).sum(),
     lambda x: jnp.sum(x ** 3)),
    ("tanh_exp", lambda m, x: (m.tanh(x) * m.exp(x)).sum(),
     lambda x: jnp.sum(jnp.tanh(x) * jnp.exp(x))),
    ("softrelu_sq", lambda m, x: (m.softrelu(x) ** 2).mean(),
     lambda x: jnp.mean(jax.nn.softplus(x) ** 2)),
    ("sin_norm", lambda m, x: m.norm(m.sin(x) * x),
     lambda x: jnp.sqrt(jnp.sum((jnp.sin(x) * x) ** 2))),
    ("logsumexp", lambda m, x: m.logsumexp(x * x, axis=1).sum(),
     lambda x: jnp.sum(jax.scipy.special.logsumexp(x * x, axis=1))),
]


def _x():
    return np.random.RandomState(0).randn(3, 4).astype(np.float32)


@pytest.mark.parametrize("port_f,jax_f", [(p, j) for _, p, j in FUNCS],
                         ids=[n for n, _, _ in FUNCS])
def test_grad_matches_jax_grad(port_f, jax_f):
    x = _x()
    tx = _a(x)
    tx.attach_grad()
    with autograd.record():
        y = port_f(nd, tx)
    g = autograd.grad(y, tx)
    np.testing.assert_allclose(g.asnumpy(), np.asarray(jax.grad(jax_f)(x)),
                               rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize("port_f,jax_f", [(p, j) for _, p, j in FUNCS],
                         ids=[n for n, _, _ in FUNCS])
def test_grad_of_grad_matches_jax(port_f, jax_f):
    """d/dx sum(g(x) * v) with g = grad f, create_graph=True, against
    jax.grad of the same function of jax.grad."""
    x = _x()
    v = np.random.RandomState(1).randn(3, 4).astype(np.float32)
    tx = _a(x)
    tx.attach_grad()
    with autograd.record():
        y = port_f(nd, tx)
        g = autograd.grad(y, tx, create_graph=True)
        z = (g * _a(v)).sum()
    z.backward()
    want_g = jax.grad(jax_f)(x)
    want = jax.grad(lambda a: jnp.sum(jax.grad(jax_f)(a) * v))(x)
    np.testing.assert_allclose(g.asnumpy(), np.asarray(want_g), rtol=RTOL,
                               atol=1e-6)
    np.testing.assert_allclose(tx.grad.asnumpy(), np.asarray(want),
                               rtol=RTOL, atol=1e-6)


def test_grad_of_grad_matches_the_jax_package():
    x = _x()
    out = []
    for pkg, ag in ((nd, autograd), (jmx.nd, jmx.autograd)):
        a = pkg.array(x, ctx=CPU) if pkg is nd else pkg.array(x)
        a.attach_grad()
        with ag.record():
            y = (pkg.sin(a) * a * a).sum()
            g = ag.grad(y, a, create_graph=True)
            z = (g * g).sum()
        z.backward()
        out.append((g.asnumpy(), a.grad.asnumpy()))
    for t, j in zip(*out):
        np.testing.assert_allclose(t, j, rtol=RTOL, atol=1e-6)


def test_grad_several_heads_and_variables():
    x, w = _x(), np.random.RandomState(2).randn(4, 2).astype(np.float32)
    hg = np.random.RandomState(3).randn(3, 2).astype(np.float32)
    res = []
    for pkg, ag in ((nd, autograd), (jmx.nd, jmx.autograd)):
        arr = (lambda v: pkg.array(v, ctx=CPU)) if pkg is nd else pkg.array
        a, b = arr(x), arr(w)
        a.attach_grad()
        b.attach_grad()
        unused = arr(np.ones(2, np.float32))
        unused.attach_grad()
        with ag.record():
            y1 = pkg.dot(a, b)
            y2 = (a * a).sum()
        gs = ag.grad([y1, y2], [a, b, unused], head_grads=[arr(hg), None])
        res.append([g.asnumpy() for g in gs])
    for t, j in zip(*res):
        np.testing.assert_allclose(t, j, rtol=RTOL, atol=1e-6)
    assert not res[0][2].any()


def test_grad_needs_an_array_on_the_tape():
    x = _a([1.0])
    with autograd.record():
        y = x * 2
    with pytest.raises(ValueError, match="not on the tape"):
        autograd.grad(y, x)


def test_custom_function_matches_the_jax_package_and_composes():
    def make(ag, pkg):
        class Cube(ag.Function):
            def forward(self, x, w):
                self.save_for_backward(x, w)
                return x * x * x * w, x + w

            def backward(self, dy, dz):
                x, w = self.saved_tensors
                return dy * 3 * x * x * w + dz, dy * x * x * x + dz
        return Cube

    x = _x()
    w = np.random.RandomState(4).randn(3, 4).astype(np.float32)
    res = []
    for pkg, ag in ((nd, autograd), (jmx.nd, jmx.autograd)):
        arr = (lambda v: pkg.array(v, ctx=CPU)) if pkg is nd else pkg.array
        a, b = arr(x), arr(w)
        a.attach_grad()
        b.attach_grad()
        with ag.record():
            y, z = make(ag, pkg)()(pkg.tanh(a), b)
            loss = (y * 2 + z * z).sum()
        loss.backward()
        res.append((loss.asnumpy(), a.grad.asnumpy(), b.grad.asnumpy()))
    for t, j in zip(*res):
        np.testing.assert_allclose(t, j, rtol=RTOL, atol=1e-6)
    # outside record() a Function is its forward, untaped
    out = make(autograd, nd)()(_a(x), _a(w))
    assert not out[0]._data.requires_grad
