"""Symbol and Executor of the port against the JAX package: the 17 cases
of ``tests/test_symbol.py`` mirrored, each run in both packages on the
same numpy inputs (fixed seed) where it computes.

Tolerances: graph queries and shapes are equal; forward values and
gradients agree at f32 rtol 1e-5 / atol 1e-6 (the same arithmetic,
summed in another order); Dropout is held by its moments (the two
packages' random streams differ).
"""

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError

PKGS = {"jax": jmx, "port": tmx}
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes are tiny: one intra-op thread, so that the parallel test
    run does not oversubscribe the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mlp(mx):
    sym = mx.sym
    data = sym.var("data")
    fc1 = sym.FullyConnected(data=data, num_hidden=16, name="fc1")
    act = sym.Activation(fc1, act_type="relu", name="relu1")
    fc2 = sym.FullyConnected(act, num_hidden=10, name="fc2")
    return sym.SoftmaxOutput(fc2, name="softmax")


def _both(fn):
    """fn(mx) in each package -> {pkg: result}."""
    return {k: fn(mx) for k, mx in PKGS.items()}


def test_list_arguments():
    out = _mlp(tmx)
    assert out.list_arguments() == [
        "data", "fc1_weight", "fc1_bias", "fc2_weight", "fc2_bias",
        "softmax_label"]
    assert out.list_outputs() == ["softmax_output"]
    assert out.list_arguments() == _mlp(jmx).list_arguments()
    assert out.list_inputs() == _mlp(jmx).list_inputs()


def test_compose_no_bias():
    got = _both(lambda mx: mx.sym.FullyConnected(
        mx.sym.var("data"), num_hidden=4, no_bias=True,
        name="fc").list_arguments())
    assert got["port"] == got["jax"] == ["data", "fc_weight"]


def test_infer_shape():
    got = _both(lambda mx: _mlp(mx).infer_shape(data=(32, 784),
                                                softmax_label=(32,)))
    arg_shapes, out_shapes, aux_shapes = got["port"]
    assert arg_shapes[1] == (16, 784)
    assert arg_shapes[3] == (10, 16)
    assert out_shapes == [(32, 10)]
    assert aux_shapes == []
    assert got["port"] == got["jax"]
    # partial inference leaves the unknown None; infer_type defaults f32
    part = _both(lambda mx: _mlp(mx).infer_shape_partial(data=(4, 8)))
    assert part["port"] == part["jax"]
    types = _both(lambda mx: _mlp(mx).infer_type(data="float16"))
    assert types["port"] == types["jax"]
    with pytest.raises(MXNetError):
        _mlp(tmx).infer_shape(data=(4, 8))


def test_infer_shape_conv():
    def run(mx):
        data = mx.sym.var("data")
        conv = mx.sym.Convolution(data, kernel=(3, 3), num_filter=8,
                                  pad=(1, 1), name="conv")
        pool = mx.sym.Pooling(conv, kernel=(2, 2), stride=(2, 2),
                              pool_type="max")
        return pool.infer_shape(data=(2, 3, 8, 8))
    got = _both(run)
    args, outs, _ = got["port"]
    assert args[1] == (8, 3, 3, 3)
    assert outs == [(2, 8, 4, 4)]
    assert got["port"] == got["jax"]


def test_batchnorm_aux():
    def run(mx):
        bn = mx.sym.BatchNorm(mx.sym.var("data"), name="bn")
        return (bn.list_arguments(), bn.list_auxiliary_states(),
                bn.infer_shape(data=(4, 3, 8, 8)))
    got = _both(run)
    args, aux, (_, _, aux_shapes) = got["port"]
    assert args == ["data", "bn_gamma", "bn_beta"]
    assert aux == ["bn_moving_mean", "bn_moving_var"]
    assert aux_shapes == [(3,), (3,)]
    assert got["port"] == got["jax"]


def test_json_roundtrip():
    out = _mlp(tmx)
    back = tmx.sym.load_json(out.tojson())
    assert back.list_arguments() == out.list_arguments()
    assert back.list_outputs() == out.list_outputs()
    assert back.infer_shape(data=(4, 32), softmax_label=(4,)) == \
        out.infer_shape(data=(4, 32), softmax_label=(4,))
    # the graph crosses to the JAX package and back
    jback = jmx.sym.load_json(out.tojson())
    assert jback.list_arguments() == out.list_arguments()
    tback = tmx.sym.load_json(_mlp(jmx).tojson())
    assert tback.list_arguments() == out.list_arguments()


def test_save_load(tmp_path):
    f = str(tmp_path / "net.json")
    out = _mlp(tmx)
    out.save(f)
    assert tmx.sym.load(f).list_arguments() == out.list_arguments()
    assert jmx.sym.load(f).list_arguments() == out.list_arguments()


def test_group_and_getitem():
    def run(mx):
        with mx.name.NameManager():     # both packages count from 0
            a, b = mx.sym.var("a"), mx.sym.var("b")
            g = mx.sym.Group([a + b, a * b])
        return len(g), len(g[0]), g.list_outputs(), \
            [s.list_outputs() for s in g]
    got = _both(run)
    assert got["port"][:2] == (2, 1)
    assert got["port"] == got["jax"]


def test_get_internals():
    names = _mlp(tmx).get_internals().list_outputs()
    assert "fc1_output" in names
    assert names == _mlp(jmx).get_internals().list_outputs()
    children = _mlp(tmx).get_children().list_outputs()
    assert children == _mlp(jmx).get_children().list_outputs()


@pytest.mark.parametrize("expr", [
    "2 * a + b * b - 3", "a / b", "3 / a", "a ** 2", "a ** b", "1 - a",
    "a - b", "-a", "a == b", "a != 2", "a > b", "a >= 2", "a < b",
    "a <= 2", "(a + 1) / (b - 5)"])
def test_symbol_arith_forward(expr):
    x = np.array([1.0, 2.0, 4.0], np.float32)
    y = np.array([3.0, 2.0, 1.0], np.float32)

    def run(mx):
        a, b = mx.sym.var("a"), mx.sym.var("b")
        c = eval(expr)
        ex = c.bind(mx.cpu(), {"a": mx.nd.array(x, ctx=mx.cpu()),
                               "b": mx.nd.array(y, ctx=mx.cpu())})
        return ex.forward()[0].asnumpy()
    got = _both(run)
    np.testing.assert_allclose(got["port"], got["jax"], **TOL)
    if expr == "2 * a + b * b - 3":
        np.testing.assert_allclose(got["port"], 2 * x + y * y - 3)


def _bound_mlp(mx, rng_seed, batch, feat):
    ex = _mlp(mx).simple_bind(ctx=mx.cpu(), data=(batch, feat),
                              softmax_label=(batch,))
    rng = np.random.RandomState(rng_seed)
    w1 = rng.randn(16, feat).astype(np.float32) * .1
    w2 = rng.randn(10, 16).astype(np.float32) * .1
    ex.arg_dict["fc1_weight"][:] = w1
    ex.arg_dict["fc2_weight"][:] = w2
    x = rng.randn(batch, feat).astype(np.float32)
    y = rng.randint(0, 10, (batch,)).astype(np.float32)
    return ex, x, y


def test_executor_forward_backward():
    def run(mx):
        ex, x, y = _bound_mlp(mx, 0, 8, 20)
        outs = ex.forward(is_train=True, data=x, softmax_label=y)
        ex.backward()
        return outs[0].asnumpy(), {n: g.asnumpy()
                                   for n, g in ex.grad_dict.items()}
    got = _both(run)
    out, grads = got["port"]
    np.testing.assert_allclose(out.sum(), 8.0, rtol=1e-5)
    assert np.abs(grads["fc2_bias"]).sum() > 0
    assert grads["data"].shape == (8, 20)
    np.testing.assert_allclose(out, got["jax"][0], **TOL)
    for n, g in grads.items():
        np.testing.assert_allclose(g, got["jax"][1][n], err_msg=n, **TOL)


def test_executor_grad_req():
    def run(mx):
        a = mx.sym.var("a")
        loss = mx.sym.make_loss((a * a).sum())
        ex = loss.bind(mx.cpu(), {"a": mx.nd.array([2.0], ctx=mx.cpu())},
                       args_grad={"a": mx.nd.zeros((1,), ctx=mx.cpu())},
                       grad_req="add")
        for _ in range(2):
            ex.forward(is_train=True)
            ex.backward()
        return ex.grad_dict["a"].asnumpy()
    got = _both(run)
    np.testing.assert_allclose(got["port"], [8.0])
    np.testing.assert_allclose(got["port"], got["jax"])
    # 'null' leaves no gradient; a backward without a forward raises
    ex = tmx.sym.make_loss(tmx.sym.var("a") * 2).bind(
        tmx.cpu(), {"a": tmx.nd.ones((2,), ctx=tmx.cpu())},
        args_grad={"a": tmx.nd.zeros((2,), ctx=tmx.cpu())}, grad_req="null")
    ex.forward(is_train=True)
    ex.backward()
    assert not ex.grad_dict["a"].asnumpy().any()
    with pytest.raises(MXNetError):
        ex.backward()


def test_executor_forward_backward_fused():
    def run(mx):
        ex, x, _ = _bound_mlp(mx, 1, 4, 12)
        y = np.zeros((4,), np.float32)
        outs = ex.forward_backward(data=x, softmax_label=y)
        g1 = ex.grad_dict["fc1_weight"].asnumpy().copy()
        ex2 = _mlp(mx).simple_bind(ctx=mx.cpu(), data=(4, 12),
                                   softmax_label=(4,))
        ex2.arg_dict["fc1_weight"][:] = ex.arg_dict["fc1_weight"].asnumpy()
        ex2.arg_dict["fc2_weight"][:] = ex.arg_dict["fc2_weight"].asnumpy()
        ex2.forward(is_train=True, data=x, softmax_label=y)
        ex2.backward()
        return outs[0].shape, g1, ex2.grad_dict["fc1_weight"].asnumpy()
    got = _both(run)
    shape, g1, g2 = got["port"]
    assert shape == (4, 10)
    np.testing.assert_allclose(g2, g1, **TOL)
    np.testing.assert_allclose(g1, got["jax"][1], **TOL)


def test_simple_bind_shared_exec():
    out = _mlp(tmx)
    ex = out.simple_bind(ctx=tmx.cpu(), data=(4, 12), softmax_label=(4,))
    ex.arg_dict["fc1_weight"][:] = 1.0
    ex2 = out.simple_bind(ctx=tmx.cpu(), data=(8, 12), softmax_label=(8,),
                          shared_exec=ex)
    assert ex2.arg_dict["fc1_weight"] is ex.arg_dict["fc1_weight"]
    assert ex2.arg_dict["data"] is not ex.arg_dict["data"]
    # reshape keeps the arrays whose shape did not change
    ex3 = ex.reshape(data=(2, 12), softmax_label=(2,))
    assert ex3.arg_dict["fc2_weight"] is ex.arg_dict["fc2_weight"]
    assert ex3.arg_dict["data"].shape == (2, 12)


def test_executor_dropout_train_vs_infer():
    from mxnet_tpu_torch.test_utils import moments_within
    got = {}
    for pkg, mx in PKGS.items():
        out = mx.sym.Dropout(mx.sym.var("data"), p=0.5, name="drop")
        ex = out.simple_bind(ctx=mx.cpu(), data=(50, 50))
        x = np.ones((50, 50), np.float32)
        np.testing.assert_allclose(
            ex.forward(is_train=False, data=x)[0].asnumpy(), x)
        got[pkg] = ex.forward(is_train=True, data=x)[0].asnumpy()
        assert (got[pkg] == 0).mean() > 0.3
    # each element is 0 or 2 with p 1/2: mean 1, variance 1
    for pkg in PKGS:
        ok, text = moments_within(got[pkg].ravel().astype(np.float64),
                                  1.0, 1.0)
        assert ok, (pkg, text)


def test_variable_shape_attr():
    def run(mx):
        a = mx.sym.var("a", shape=(3, 4))
        c = mx.sym.broadcast_add(a, mx.sym.var("b"))
        return c.infer_shape()
    got = _both(run)
    args, outs, _ = got["port"]
    assert args == [(3, 4), (3, 4)]
    assert outs == [(3, 4)]
    assert got["port"] == got["jax"]


def test_name_prefix_and_manager_scopes():
    mx = tmx
    with mx.name.Prefix("blockA_"):
        s1 = mx.sym.FullyConnected(mx.sym.Variable("d"), num_hidden=3)
    assert s1.name.startswith("blockA_")
    s2 = mx.sym.FullyConnected(mx.sym.Variable("d"), num_hidden=3)
    assert not s2.name.startswith("blockA_")
    with mx.name.NameManager():
        s3 = mx.sym.FullyConnected(mx.sym.Variable("d"), num_hidden=3)
    assert s3.name == "fullyconnected0"
    assert mx.attribute.AttrScope is mx.AttrScope
    with mx.AttrScope(ctx_group="dev1"):
        s4 = mx.sym.FullyConnected(mx.sym.Variable("d"), num_hidden=3,
                                   name="fc")
    assert s4.attr("ctx_group") == "dev1"
    assert s4.get_internals()[1].attr("ctx_group") == "dev1"


def test_fluent_methods_match_jax():
    x = np.random.RandomState(4).randn(2, 3, 4).astype(np.float32)
    cases = ["sum(axis=1)", "mean()", "max(axis=2, keepdims=True)",
             "reshape((6, 4))", "transpose((2, 0, 1))", "flatten()",
             "expand_dims(0)", "swapaxes(0, 2)", "slice_axis(1, 0, 2)",
             "clip(-0.5, 0.5)", "exp()", "abs()", "sigmoid()",
             "softmax()", "argmax(axis=2)", "astype('float16')",
             "norm()", "square()"]
    for case in cases:
        def run(mx):
            d = mx.sym.var("d")
            out = eval("d." + case)
            return out.eval(mx.cpu(), d=mx.nd.array(x, ctx=mx.cpu())
                            )[0].asnumpy()
        got = _both(run)
        assert got["port"].dtype == got["jax"].dtype, case
        np.testing.assert_allclose(got["port"].astype(np.float32),
                                   got["jax"].astype(np.float32),
                                   err_msg=case, **TOL)


def test_bind_runs_on_the_card_unless_given_the_cpu():
    """Without a context the executor goes to the current context, the
    card: without CUDA that raises."""
    if torch.cuda.is_available():
        pytest.skip("this checks the CPU-only behavior")
    with pytest.raises(MXNetError):
        _mlp(tmx).simple_bind(data=(2, 3), softmax_label=(2,))
    with pytest.raises(MXNetError):
        tmx.mod.Module(_mlp(tmx)).bind([("data", (2, 3))],
                                       [("softmax_label", (2,))])
