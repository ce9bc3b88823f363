"""The port's NDArray against the JAX package's: the cases of
tests/test_ndarray.py mirrored (on ``ctx=mx.cpu()``), then the reference
semantics the port keeps where PyTorch's differ, each compared with the
JAX package on the same inputs (fixed numpy seed).  Values are exact
unless a tolerance is stated (rtol 1e-5 where the reference's own test
states one)."""

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import nd

CPU = mx.cpu()


def _a(x, dtype=None):
    return nd.array(x, ctx=CPU, dtype=dtype)


# -- tests/test_ndarray.py, mirrored -----------------------------------------

def test_creation():
    a = nd.zeros((3, 4), ctx=CPU)
    assert a.shape == (3, 4) and a.dtype == np.float32
    assert a.asnumpy().sum() == 0
    b = nd.ones((2,), ctx=CPU, dtype="int32")
    assert b.dtype == np.int32
    c = nd.full((2, 2), 7.0, ctx=CPU)
    np.testing.assert_allclose(c.asnumpy(), np.full((2, 2), 7.0))
    d = _a(np.arange(6).reshape(2, 3))
    assert d.shape == (2, 3) and d.dtype == np.int32
    e = nd.arange(0, 10, 2, ctx=CPU)
    np.testing.assert_array_equal(e.asnumpy(),
                                  jmx.nd.arange(0, 10, 2).asnumpy())
    assert e.dtype == np.float32
    assert nd.empty((2, 3), ctx=CPU).shape == (2, 3)
    np.testing.assert_array_equal(nd.arange(3, ctx=CPU, repeat=2).asnumpy(),
                                  [0, 0, 1, 1, 2, 2])


def test_float64_coerced_to_float32():
    assert _a(np.random.RandomState(0).rand(3, 3)).dtype == np.float32


def test_arith():
    a = _a([[1., 2.], [3., 4.]])
    b = _a([[10., 20.], [30., 40.]])
    np.testing.assert_allclose((a + b).asnumpy(), [[11, 22], [33, 44]])
    np.testing.assert_allclose((b - a).asnumpy(), [[9, 18], [27, 36]])
    np.testing.assert_allclose((a * b).asnumpy(), [[10, 40], [90, 160]])
    np.testing.assert_allclose((b / a).asnumpy(), [[10, 10], [10, 10]])
    np.testing.assert_allclose((a + 1).asnumpy(), [[2, 3], [4, 5]])
    np.testing.assert_allclose((1 + a).asnumpy(), [[2, 3], [4, 5]])
    np.testing.assert_allclose((2 - a).asnumpy(), [[1, 0], [-1, -2]])
    np.testing.assert_allclose((a ** 2).asnumpy(), [[1, 4], [9, 16]])
    np.testing.assert_allclose((-a).asnumpy(), [[-1, -2], [-3, -4]])
    np.testing.assert_allclose((a == 1).asnumpy(), [[1, 0], [0, 0]])
    np.testing.assert_allclose((a > 2).asnumpy(), [[0, 0], [1, 1]])


def test_inplace():
    a = nd.ones((2, 2), ctx=CPU)
    a += 1
    np.testing.assert_allclose(a.asnumpy(), np.full((2, 2), 2.0))
    a *= 3
    np.testing.assert_allclose(a.asnumpy(), np.full((2, 2), 6.0))
    a /= 2
    np.testing.assert_allclose(a.asnumpy(), np.full((2, 2), 3.0))
    a -= 1
    np.testing.assert_allclose(a.asnumpy(), np.full((2, 2), 2.0))


def test_indexing():
    a = _a(np.arange(12).reshape(3, 4))
    np.testing.assert_allclose(a[1].asnumpy(), [4, 5, 6, 7])
    np.testing.assert_allclose(a[1:3].asnumpy(), [[4, 5, 6, 7],
                                                  [8, 9, 10, 11]])
    np.testing.assert_allclose(a[1, 2].asnumpy(), 6)
    a[0] = 100.0
    assert a.asnumpy()[0].tolist() == [100] * 4
    a[1, 1] = -1
    assert a.asnumpy()[1, 1] == -1


def test_shape_ops():
    a = _a(np.arange(24).reshape(2, 3, 4))
    assert a.reshape(6, 4).shape == (6, 4)
    assert a.reshape((-1, 4)).shape == (6, 4)
    assert a.reshape(0, -1).shape == (2, 12)
    assert a.reshape(-3, 4).shape == (6, 4)
    assert a.transpose().shape == (4, 3, 2)
    assert a.T.shape == (4, 3, 2)
    assert a.transpose((1, 0, 2)).shape == (3, 2, 4)
    assert a.swapaxes(0, 2).shape == (4, 3, 2)
    assert a.expand_dims(1).shape == (2, 1, 3, 4)
    assert a.flatten().shape == (2, 12)
    assert nd.concatenate([a, a], axis=0).shape == (4, 3, 4)
    parts = a.split(3, axis=1)
    assert len(parts) == 3 and parts[0].shape == (2, 1, 4)
    assert nd.moveaxis(a, 0, -1).shape == (3, 4, 2)


def test_reduce_ops():
    x = np.random.RandomState(1).rand(3, 4, 5).astype(np.float32)
    a = _a(x)
    np.testing.assert_allclose(a.sum().asnumpy(), x.sum(), rtol=1e-5)
    np.testing.assert_allclose(a.sum(axis=1).asnumpy(), x.sum(1), rtol=1e-5)
    np.testing.assert_allclose(a.mean(axis=(0, 2)).asnumpy(),
                               x.mean((0, 2)), rtol=1e-5)
    np.testing.assert_allclose(a.max(axis=0).asnumpy(), x.max(0), rtol=1e-5)
    np.testing.assert_allclose(nd.sum(a, axis=1, keepdims=True).asnumpy(),
                               x.sum(1, keepdims=True), rtol=1e-5)
    np.testing.assert_allclose(nd.sum(a, axis=1, exclude=True).asnumpy(),
                               x.sum(axis=(0, 2)), rtol=1e-5)


def test_dot():
    rs = np.random.RandomState(2)
    a = rs.rand(4, 5).astype(np.float32)
    b = rs.rand(5, 3).astype(np.float32)
    np.testing.assert_allclose(nd.dot(_a(a), _a(b)).asnumpy(), a.dot(b),
                               rtol=1e-5)
    np.testing.assert_allclose(
        nd.dot(_a(a), _a(b.T), transpose_b=True).asnumpy(), a.dot(b),
        rtol=1e-5)
    x = rs.rand(2, 4, 5).astype(np.float32)
    y = rs.rand(2, 5, 3).astype(np.float32)
    np.testing.assert_allclose(nd.batch_dot(_a(x), _a(y)).asnumpy(),
                               np.matmul(x, y), rtol=1e-5)


def test_astype_copy():
    a = _a([[1.5, 2.5]])
    b = a.astype("int32")
    assert b.dtype == np.int32
    c = a.copy()
    c += 1
    assert a.asnumpy()[0, 0] == 1.5
    d = nd.zeros((1, 2), ctx=CPU, dtype="int32")
    a.copyto(d)
    assert d.dtype == np.int32 and d.asnumpy().tolist() == [[1, 2]]


def test_context():
    a = nd.zeros((2, 2), ctx=CPU)
    assert a.context.device_type == "cpu"
    b = a.as_in_context(mx.cpu(0))
    assert b.context == mx.cpu(0)


def test_save_load(tmp_path):
    fname = str(tmp_path / "arrs")
    d = {"w": nd.random.normal(shape=(3, 3), ctx=CPU),
         "b": nd.ones((3,), ctx=CPU)}
    nd.save(fname, d)
    loaded = nd.load(fname, ctx=CPU)
    assert set(loaded) == {"w", "b"}
    np.testing.assert_array_equal(loaded["w"].asnumpy(), d["w"].asnumpy())
    lst = [nd.ones((2,), ctx=CPU), nd.zeros((3,), ctx=CPU)]
    nd.save(fname, lst)
    loaded = nd.load(fname, ctx=CPU)
    assert isinstance(loaded, list) and len(loaded) == 2
    np.testing.assert_allclose(loaded[0].asnumpy(), [1, 1])


def test_save_bytes_crosses_packages():
    arrs = {"w": _a(np.random.RandomState(3).rand(2, 3)),
            "i": _a(np.arange(4, dtype=np.int32))}
    raw = nd.save_bytes(arrs)
    back = jmx.nd.load_bytes(raw)
    for k in arrs:
        np.testing.assert_array_equal(back[k].asnumpy(), arrs[k].asnumpy())
    again = nd.load_bytes(jmx.nd.save_bytes(back), ctx=CPU)
    for k in arrs:
        np.testing.assert_array_equal(again[k].asnumpy(), arrs[k].asnumpy())
        assert again[k].dtype == arrs[k].dtype


def test_topk_sort():
    x = np.array([[3., 1., 2.], [0., 5., 4.]], np.float32)
    a = _a(x)
    np.testing.assert_allclose(a.sort(axis=1).asnumpy(), np.sort(x, 1))
    np.testing.assert_allclose(
        a.topk(axis=1, k=2, ret_typ="value").asnumpy(), [[3, 2], [5, 4]])
    np.testing.assert_allclose(a.argmax(axis=1).asnumpy(), [0, 1])


def test_take_onehot():
    w = _a(np.arange(12).reshape(4, 3))
    idx = _a([0, 2], dtype="int32")
    np.testing.assert_allclose(nd.take(w, idx).asnumpy(),
                               [[0, 1, 2], [6, 7, 8]])
    np.testing.assert_allclose(nd.one_hot(idx, 4).asnumpy(),
                               [[1, 0, 0, 0], [0, 0, 1, 0]])


def test_wait_to_read_sync():
    a = nd.random.normal(shape=(100, 100), ctx=CPU)
    nd.dot(a, a).wait_to_read()
    nd.waitall()
    mx.nd.waitall()


def test_broadcast():
    a = _a([[1.], [2.]])
    assert nd.broadcast_to(a, (2, 3)).shape == (2, 3)
    b = nd.broadcast_add(a, _a([[10., 20., 30.]]))
    np.testing.assert_allclose(b.asnumpy(), [[11, 21, 31], [12, 22, 32]])


def test_where_clip():
    cond = _a([[1., 0.], [0., 1.]])
    x = nd.ones((2, 2), ctx=CPU)
    y = nd.zeros((2, 2), ctx=CPU) - 1
    np.testing.assert_allclose(nd.where(cond, x, y).asnumpy(),
                               [[1, -1], [-1, 1]])
    np.testing.assert_allclose(nd.clip(_a([-2., 0.5, 9.]), 0.0,
                                       1.0).asnumpy(), [0, 0.5, 1])


# -- the reference's semantics, held against the JAX package -----------------

def _both(fn, *arrays, **kw):
    """fn(nd module, *NDArrays) in each package; both results as numpy."""
    t = fn(nd, *[_a(x, **kw) for x in arrays])
    j = fn(jmx.nd, *[jmx.nd.array(x, **kw) for x in arrays])
    return t, j


def _same(t, j):
    tn, jn = t.asnumpy(), j.asnumpy()
    assert tn.shape == jn.shape and tn.dtype == jn.dtype, (tn, jn)
    np.testing.assert_array_equal(tn, jn)


A23 = np.arange(6, dtype=np.float32).reshape(2, 3)


@pytest.mark.parametrize("key", [5, -5, (1, 7), (slice(None), -9),
                                 (Ellipsis, 4), slice(-7, 9),
                                 (None, 1), (1, slice(None, None, -1))],
                         ids=str)
def test_getitem_clamps_out_of_range(key):
    _same(*_both(lambda m, a: a[key], A23))
    assert _a(A23)[5].asnumpy().tolist() == [3, 4, 5]


def test_getitem_by_index_array_clamps():
    idx = np.array([5, -1, -7], np.int32)
    t = _a(A23)[_a(idx)]
    j = jmx.nd.array(A23)[jmx.nd.array(idx)]
    _same(t, j)


@pytest.mark.parametrize("key", [5, -5, 1, (0, 9), (slice(None), 1),
                                 (slice(None), -4), slice(1, None)],
                         ids=str)
def test_setitem_drops_out_of_range(key):
    t, j = _a(A23), jmx.nd.array(A23)
    t[key] = 7.0
    j[key] = 7.0
    _same(t, j)


def test_setitem_index_array_and_array_value():
    t, j = _a(A23), jmx.nd.array(A23)
    idx = np.array([1, 4], np.int32)
    val = np.array([[9., 8., 7.], [6., 5., 4.]], np.float32)
    t[_a(idx)] = _a(val)
    j[jmx.nd.array(idx)] = jmx.nd.array(val)
    _same(t, j)


def test_setitem_and_inplace_rebind_never_write_views():
    for pkg in (nd, jmx.nd):
        a = pkg.array(A23, ctx=CPU) if pkg is nd else pkg.array(A23)
        b = a.reshape(3, 2)
        c = a[0]
        d = a.T
        a[0] = 5
        a += 1
        assert b.asnumpy().tolist() == [[0, 1], [2, 3], [4, 5]]
        assert c.asnumpy().tolist() == [0, 1, 2]
        assert d.asnumpy().tolist() == [[0, 3], [1, 4], [2, 5]]
        assert a.asnumpy().tolist() == [[6, 6, 6], [4, 5, 6]]


def test_setitem_cuts_the_array_from_the_tape():
    for pkg, ag in ((nd, mx.autograd), (jmx.nd, jmx.autograd)):
        x = pkg.array([1.0, 2.0], ctx=CPU) if pkg is nd else \
            pkg.array([1.0, 2.0])
        x.attach_grad()
        with ag.record():
            y = x * 3
            y[0] = 0.0
            z = y * x
        z.backward()
        # y is off the tape: only z's direct use of x reaches x
        np.testing.assert_allclose(x.grad.asnumpy(), [0.0, 6.0])


def test_take_clips_and_one_hot_zeroes():
    w = np.arange(12, dtype=np.float32).reshape(4, 3)
    idx = np.array([5, -1], np.float32)
    t, j = _both(lambda m, w, i: m.take(w, i), w, idx)
    _same(t, j)
    assert t.asnumpy().tolist() == [[9, 10, 11], [0, 1, 2]]
    t, j = _both(lambda m, i: m.one_hot(i, 4), np.array([5, -1, 2],
                                                       np.float32))
    _same(t, j)
    assert t.asnumpy()[:2].sum() == 0


@pytest.mark.parametrize("expr", [
    lambda m, a, b: a == b, lambda m, a, b: a != b, lambda m, a, b: a > b,
    lambda m, a, b: a >= 1, lambda m, a, b: a < 1, lambda m, a, b: a <= b,
    lambda m, a, b: m.logical_not(a), lambda m, a, b: a.argmax(axis=1),
    lambda m, a, b: a.argmin(), lambda m, a, b: a.argsort(),
    lambda m, a, b: a.topk(k=2), lambda m, a, b: a % b,
    lambda m, a, b: a % 2, lambda m, a, b: 2 % b, lambda m, a, b: a / 2,
    lambda m, a, b: 2 / b, lambda m, a, b: a ** 2, lambda m, a, b: 2 ** a,
    lambda m, a, b: abs(a - b), lambda m, a, b: a.sum(),
    lambda m, a, b: m.norm(a), lambda m, a, b: a.norm(axis=1),
    lambda m, a, b: a.mean(), lambda m, a, b: a.prod(axis=0),
])
def test_dtypes_and_values_follow_the_reference(expr):
    a = np.array([[-3., 3., 0.], [1., 2., -1.]], np.float32)
    b = np.array([[2., 2., 1.], [-2., 1., 3.]], np.float32)
    _same(*_both(expr, a, b))
    _same(*_both(expr, a.astype(np.int32), b.astype(np.int32)))


def test_floor_mod_int_div_and_zero_d_reductions():
    m = (_a([-3., 3.]) % 2).asnumpy()
    assert m.tolist() == [1.0, 1.0]
    assert (_a([1, 2], dtype="int32") / 2).dtype == np.float32
    a = _a(A23)
    assert a.sum().shape == () and nd.norm(a).shape == ()
    assert a.max().shape == () and a.argmax().shape == ()


def test_round_gamma_rcbrt_logical_not():
    x = np.array([-0.5, 0.5, 1.5, 2.5, -2.5], np.float32)
    t, j = _both(lambda m, a: m.round(a), x)
    _same(t, j)
    assert np.signbit(t.asnumpy()[0]) and t.asnumpy().tolist()[1:] == \
        [0, 2, 2, -2]
    t, j = _both(lambda m, a: m.gamma(a), np.array([-0.5], np.float32))
    np.testing.assert_allclose(t.asnumpy(), j.asnumpy(), rtol=1e-6)
    assert abs(t.asnumpy()[0] - 3.5449077) < 1e-5
    t, j = _both(lambda m, a: m.rcbrt(a), np.array([8., -27.], np.float32))
    np.testing.assert_allclose(t.asnumpy(), [0.5, -1 / 3], rtol=1e-6)
    np.testing.assert_allclose(t.asnumpy(), j.asnumpy(), rtol=1e-6)
    t, j = _both(lambda m, a: m.logical_not(a),
                 np.array([0, 3], np.int32))
    _same(t, j)


def test_eq_returns_an_array_and_arrays_stay_hashable():
    a, b = _a([1.0]), _a([1.0])
    assert isinstance(a == b, nd.NDArray)
    assert {a: 1, b: 2}[a] == 1
    # `in` tests identity first; index() compares with ==, which is a
    # one-element array here, truthy when equal (as in the reference)
    assert a in [a] and [b, a].index(a) == 0
    ja, jb = jmx.nd.array([1.0]), jmx.nd.array([1.0])
    assert [jb, ja].index(ja) == 0
    with pytest.raises(ValueError):
        bool(_a([1.0, 2.0]) == _a([1.0, 2.0]))
    assert bool(a == b)


def test_python_protocol():
    a = _a(A23)
    assert len(a) == 2 and a.ndim == 2 and a.size == 6
    assert [r.asnumpy().tolist() for r in a] == A23.tolist()
    assert float(_a([2.5])) == 2.5 and int(_a([3.0])) == 3
    assert _a([1.5]).item() == 1.5 and a.tolist() == A23.tolist()
    assert a.stype == "default" and a.asnpy().tolist() == A23.tolist()
    with pytest.raises(TypeError):
        len(_a(np.float32(1.0)))


def test_random_seed_repeats_and_moments():
    mx.random.seed(3)
    x = nd.random.uniform(-1, 3, shape=(200000,), ctx=CPU).asnumpy()
    mx.random.seed(3)
    y = nd.random.uniform(-1, 3, shape=(200000,), ctx=CPU).asnumpy()
    np.testing.assert_array_equal(x, y)
    from mxnet_tpu_torch.test_utils import moments_within
    ok, text = moments_within(x.astype(np.float64), 1.0, 16.0 / 12)
    assert ok, text
    z = nd.random.normal(1.0, 2.0, shape=(200000,), ctx=CPU).asnumpy()
    ok, text = moments_within(z.astype(np.float64), 1.0, 4.0)
    assert ok, text
    assert nd.random.randint(0, 5, shape=(3,), ctx=CPU).dtype == np.int32


def test_creation_defaults_to_the_card():
    # no CUDA here: the default context raises instead of using the CPU
    for call in (lambda: nd.ones((2,)), lambda: nd.arange(3),
                 lambda: nd.full((2,), 1.0), lambda: nd.empty((2,)),
                 lambda: nd.random.uniform(shape=(2,)),
                 lambda: nd._zeros(shape=(2,))):
        with pytest.raises(mx.MXNetError, match="CUDA"):
            call()


# -- nd.contrib and nd.random -------------------------------------------------

def test_contrib_foreach_while_loop_cond_match_jax():
    data = np.random.RandomState(4).randn(4, 3).astype(np.float32)
    init = np.ones(3, np.float32)
    res = []
    for pkg in (nd, jmx.nd):
        arr = (lambda v: pkg.array(v, ctx=CPU)) if pkg is nd else pkg.array

        def body(x, state):
            new = state * 2 + x
            return new * 3, new

        outs, state = pkg.contrib.foreach(body, arr(data), arr(init))
        wouts, wvars = pkg.contrib.while_loop(
            lambda i, s: i < 3, lambda i, s: (s * 2, [i + 1, s + i]),
            [arr(np.float32(0.0)), arr(init)], max_iterations=10)
        c = pkg.contrib.cond(arr(np.float32(1.0)), lambda: arr(init) * 5,
                             lambda: arr(init))
        res.append([outs.asnumpy(), state.asnumpy(), wouts.asnumpy(),
                    wvars[0].asnumpy(), wvars[1].asnumpy(), c.asnumpy()])
    for t, j in zip(*res):
        np.testing.assert_allclose(t, j, rtol=1e-6)
        assert t.shape == j.shape


def test_contrib_foreach_is_taped():
    x = _a(np.arange(6, dtype=np.float32).reshape(3, 2))
    x.attach_grad()
    with mx.autograd.record():
        outs, _ = nd.contrib.foreach(lambda d, s: (d * s, s + d), x,
                                     _a(np.ones(2, np.float32)))
        outs.sum().backward()
    jx = jmx.nd.array(np.arange(6, dtype=np.float32).reshape(3, 2))
    jx.attach_grad()
    with jmx.autograd.record():
        jouts, _ = jmx.nd.contrib.foreach(lambda d, s: (d * s, s + d), jx,
                                          jmx.nd.ones((2,)))
        jouts.sum().backward()
    np.testing.assert_allclose(x.grad.asnumpy(), jx.grad.asnumpy())


def test_rand_zipfian_counts_follow_the_reference_formula():
    true = _a(np.array([0, 5, 99], np.float32))
    s, et, es = nd.contrib.rand_zipfian(true, 64, 100)
    js, jet, jes = jmx.nd.contrib.rand_zipfian(
        jmx.nd.array(np.array([0, 5, 99], np.float32)), 64, 100)
    assert s.shape == js.shape == (64,) and s.dtype == np.int32
    np.testing.assert_allclose(et.asnumpy(), jet.asnumpy(), rtol=1e-6)
    assert et.dtype == jet.dtype and es.shape == jes.shape
    sv = s.asnumpy()
    assert sv.min() >= 0 and sv.max() < 100
    p = np.log((sv + 2.0) / (sv + 1.0)) / np.log(101) * 64
    np.testing.assert_allclose(es.asnumpy(), p.astype(np.float32),
                               rtol=1e-6)


@pytest.mark.parametrize("call", [
    lambda m, c: m.random.uniform(-1, 1, shape=(2, 3), **c),
    lambda m, c: m.random.normal(0, 2, shape=(4,), **c),
    lambda m, c: m.random.randn(shape=(2,), **c),
    lambda m, c: m.random.gamma(2.0, 1.5, shape=(3,), **c),
    lambda m, c: m.random.exponential(2.0, shape=(3,), **c),
    lambda m, c: m.random.poisson(3.0, shape=(5,), **c),
    lambda m, c: m.random.negative_binomial(3, 0.4, shape=(2,), **c),
    lambda m, c: m.random.generalized_negative_binomial(2.0, 0.5,
                                                       shape=(2,), **c),
    lambda m, c: m.random.randint(-3, 5, shape=(6,), **c),
    lambda m, c: m.random.bernoulli(0.3, shape=(3,), **c),
], ids=["uniform", "normal", "randn", "gamma", "exponential", "poisson",
        "negative_binomial", "generalized_negative_binomial", "randint",
        "bernoulli"])
def test_nd_random_shapes_and_dtypes_match_jax(call):
    t = call(nd, {"ctx": CPU})
    j = call(jmx.nd, {})
    assert t.shape == j.shape and t.dtype == j.dtype


def test_nd_random_with_array_parameters_and_samplers():
    low, high = _a([0.0, 10.0]), _a([1.0, 11.0])
    u = nd.random.uniform(low, high, shape=(1000,)).asnumpy()
    assert u.shape == (2, 1000)
    assert (u[0] >= 0).all() and (u[0] < 1).all() and (u[1] >= 10).all()
    m = nd.random.multinomial(_a([[0.0, 1.0, 0.0]]), shape=(5,))
    assert m.dtype == np.int32 and (m.asnumpy() == 1).all()
    rows = np.arange(12, dtype=np.float32).reshape(6, 2)
    sh = nd.random.shuffle(_a(rows)).asnumpy()
    assert sorted(map(tuple, sh)) == sorted(map(tuple, rows))
    out = nd.zeros((3, 2), ctx=CPU)
    nd.random.normal(shape=(3, 2), ctx=CPU, out=out)
    assert out.asnumpy().std() > 0
