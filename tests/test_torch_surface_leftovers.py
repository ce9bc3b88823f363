"""User-surface names the port lacked (ROADMAP queue A item 17b), each
called the same way in the JAX package and in the port on the CPU:
``base``'s type tuples and dtype names, ``Context.device_typeid`` and
``empty_cache``, ``Parameter.reset_ctx``/``ParameterDict.reset_ctx``,
``gluon.Constant``/``ParameterDict.get_constant`` and the helpers of
``mx.test_utils``.  Floating results agree within 1e-6.
"""

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import test_utils as jtu
from mxnet_tpu_torch import test_utils as ttu

PKGS = {"jax": jmx, "port": tmx}
TU = {"jax": jtu, "port": ttu}


def _ctx(pkg):
    return {"ctx": tmx.cpu()} if pkg == "port" else {}


def test_base_type_tuples_and_dtype_names():
    from mxnet_tpu import base as jb
    from mxnet_tpu_torch import base as tb
    for name in ("string_types", "numeric_types", "integer_types",
                 "DTYPE_NAMES"):
        assert getattr(tb, name) == getattr(jb, name), name
    for v, kind in ((3, "integer_types"), (np.int8(1), "integer_types"),
                    (2.5, "numeric_types"), (np.float32(1), "numeric_types"),
                    ("a", "string_types")):
        assert isinstance(v, getattr(tb, kind)) == \
            isinstance(v, getattr(jb, kind))


def test_context_device_typeid_and_empty_cache():
    for mx in PKGS.values():
        assert mx.cpu().device_typeid == 1
        assert mx.Context("gpu", 0).device_typeid == 2
        assert mx.cpu().empty_cache() is None


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_parameter_reset_ctx(pkg):
    mx = PKGS[pkg]
    net = mx.gluon.nn.Dense(3, in_units=2, prefix="rc_")
    net.initialize(mx.init.One(), **_ctx(pkg))
    params = net.collect_params()
    params.reset_ctx(mx.cpu())
    params["rc_weight"].reset_ctx(mx.cpu())
    assert params["rc_weight"].list_ctx() == [mx.cpu()]
    np.testing.assert_array_equal(params["rc_weight"].data().asnumpy(),
                                  np.ones((3, 2)))
    # a deferred parameter is made on the context it was reset to
    lazy = mx.gluon.nn.Dense(3, prefix="rd_")
    lazy.initialize(**_ctx(pkg))
    lazy.collect_params().reset_ctx(mx.cpu())
    out = lazy(mx.nd.ones((1, 4), **_ctx(pkg)))
    assert out.shape == (1, 3)
    assert lazy.weight.list_ctx() == [mx.cpu()]


def test_constant_and_get_constant():
    got = {}
    for pkg, mx in PKGS.items():
        value = np.arange(6, dtype=np.float32).reshape(2, 3)
        const = mx.gluon.Constant("c0", value)
        pd = mx.gluon.ParameterDict("p_")
        c1 = pd.get_constant("c1", value * 2)
        assert pd.get_constant("c1") is c1
        with pytest.raises(KeyError):
            pd.get_constant("missing")
        for c in (const, c1):
            assert c.grad_req == "null"
            c.initialize(**_ctx(pkg))
        got[pkg] = (const.data().asnumpy(), c1.data().asnumpy(),
                    str(const.dtype))
    for a, b in zip(got["port"], got["jax"]):
        if isinstance(a, str):
            assert a == b
        else:
            np.testing.assert_array_equal(a, b)


def test_test_utils_comparisons():
    for pkg, mx in PKGS.items():
        tu = TU[pkg]
        assert tu.same([1, 2], np.array([1, 2]))
        assert not tu.same([1, 2], [1, 3])
        assert tu.almost_equal([1.0, 2.0], [1.0, 2.0 + 1e-7])
        assert not tu.almost_equal([1.0], [1.1])
        tu.assert_almost_equal(np.float32([1, 2]), np.float32([1, 2]))
        with pytest.raises(AssertionError):
            tu.assert_almost_equal([1.0], [1.5], names=("x", "y"))
        with mx.cpu():
            assert tu.default_context() == mx.cpu()


def test_test_utils_random_helpers():
    got = {}
    for pkg, mx in PKGS.items():
        tu = TU[pkg]
        np.random.seed(4)
        shape = tu.rand_shape_nd(3, dim=5)
        dense = tu.rand_ndarray((4, 3), **_ctx(pkg))
        rsp = tu.rand_ndarray((6, 2), "row_sparse", density=0.5,
                              **_ctx(pkg))
        arrs = tu.random_arrays((2, 2), (3,))
        got[pkg] = (shape, dense.asnumpy(), rsp.stype, rsp.asnumpy(),
                    arrs[0], arrs[1])
    for a, b in zip(got["port"], got["jax"]):
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b


def test_numeric_grad_helper():
    loc = {"x": np.array([1.0, 2.0, 3.0])}
    for tu in TU.values():
        g = tu.numeric_grad(lambda d: float(np.sum(d["x"] ** 2)),
                            dict(loc), eps=1e-4)
        np.testing.assert_allclose(g["x"], 2 * loc["x"], rtol=1e-6)


def _fc_symbol(mx):
    x, w = mx.sym.var("x"), mx.sym.var("w")
    return mx.sym.FullyConnected(x, w, num_hidden=3, no_bias=True)


def test_check_symbolic_forward_backward_and_consistency():
    rs = np.random.RandomState(2)
    loc = {"x": rs.randn(2, 4).astype(np.float32),
           "w": rs.randn(3, 4).astype(np.float32)}
    og = rs.randn(2, 3).astype(np.float32)
    want_fwd = loc["x"] @ loc["w"].T
    want_bwd = {"x": og @ loc["w"], "w": og.T @ loc["x"]}
    results = {}
    for pkg, mx in PKGS.items():
        tu = TU[pkg]
        sym = _fc_symbol(mx)
        kw = _ctx(pkg)
        outs = tu.check_symbolic_forward(sym, loc, [want_fwd], **kw)
        grads = tu.check_symbolic_backward(sym, loc, [og], want_bwd, **kw)
        res = tu.check_consistency(sym, shapes={"x": (2, 4), "w": (3, 4)},
                                   backends=["cpu"])
        results[pkg] = (outs[0].asnumpy(), grads["w"].asnumpy(), res)
    np.testing.assert_allclose(results["port"][0], results["jax"][0],
                               atol=1e-6)
    np.testing.assert_allclose(results["port"][1], results["jax"][1],
                               atol=1e-6)
    (po, pg, _, _), (jo, jg, _, _) = results["port"][2][0], \
        results["jax"][2][0]
    np.testing.assert_allclose(po[0], jo[0], atol=1e-6)
    for n in ("x", "w"):
        np.testing.assert_allclose(pg[n], jg[n], atol=1e-6)


def test_check_numeric_gradient_port():
    """The port's finite-difference check in float64 (the JAX package's
    needs ``jax.experimental.enable_x64``, which this jax lacks: ROADMAP's
    caveats), on a tanh of a product and on a graph with a wrong
    gradient, which it must catch."""
    rs = np.random.RandomState(3)
    loc = {"x": rs.randn(2, 4), "w": rs.randn(3, 4)}
    ttu.check_numeric_gradient(tmx.sym.tanh(_fc_symbol(tmx)), loc,
                               ctx=tmx.cpu())
    # BlockGrad passes values but no gradient: the check must fail
    bad = tmx.sym.BlockGrad(_fc_symbol(tmx)) * _fc_symbol(tmx)
    with pytest.raises(AssertionError):
        ttu.check_numeric_gradient(bad, loc, ctx=tmx.cpu())
