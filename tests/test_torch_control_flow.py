"""The port's symbolic control flow (``sym.contrib.foreach``,
``while_loop``, ``cond``; the ``_foreach``, ``_while_loop``, ``_cond`` and
``_subgraph_exec`` ops) against the JAX package's, on the CPU
(tests/test_control_flow.py's cases mirrored).  Gradients are held to the
JAX executor's backward, a ``jax.vjp`` of the JAX ops (the reference's
finite-difference helper needs ``jax.experimental.enable_x64``, which
jax 0.9 lacks).  Tolerance: float32 rtol 1e-5 / atol 1e-6.
"""

import json
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

TOL = dict(rtol=1e-5, atol=1e-6)
PKGS = (jmx, tmx)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(mx, symbol, args, grads=(), out_grads=None):
    """(outputs, {name: gradient}) of one forward (and backward when
    *grads* names arguments) of *symbol* bound on the CPU."""
    arrays = {k: mx.nd.array(v, ctx=mx.cpu()) for k, v in args.items()}
    g = {k: mx.nd.zeros(v.shape, ctx=mx.cpu()) for k, v in args.items()
         if k in grads}
    exe = symbol.bind(ctx=mx.cpu(), args=arrays, args_grad=g or None,
                      grad_req={k: ("write" if k in grads else "null")
                                for k in args})
    outs = [o.asnumpy() for o in exe.forward(is_train=bool(grads))]
    if grads:
        exe.backward([mx.nd.array(c, ctx=mx.cpu()) for c in out_grads])
    return outs, {k: v.asnumpy() for k, v in exe.grad_dict.items()
                  if k in grads}


def _both(build, args, grads=(), seed=0):
    """Build with each package's ``sym``, run, and hold the port's
    outputs and gradients to the JAX package's."""
    res = []
    for mx in PKGS:
        symbol = build(mx.sym)
        cots = None
        if grads:
            shapes = symbol.infer_shape(**{k: v.shape
                                           for k, v in args.items()})[1]
            rs = np.random.RandomState(seed)
            cots = [rs.randn(*s).astype(np.float32) for s in shapes]
        res.append(_run(mx, symbol, args, grads, cots))
    (jo, jg), (to, tg) = res
    assert len(to) == len(jo)
    for a, b in zip(to, jo):
        np.testing.assert_allclose(a, b, **TOL)
    for k in grads:
        np.testing.assert_allclose(tg[k], jg[k], **TOL)
    return to, tg


def test_foreach_cumsum():
    def build(sym):
        outs, _ = sym.contrib.foreach(
            lambda x, st: (x + st[0], [x + st[0]]), sym.var("data"),
            [sym.var("s0")])
        return outs
    x = np.arange(12).reshape(4, 3).astype(np.float32)
    out, _ = _both(build, {"data": x, "s0": np.zeros(3, np.float32)})
    np.testing.assert_allclose(out[0], np.cumsum(x, axis=0))


def test_foreach_closure_gradient():
    """A weight the body captures gets its gradient through the loop
    (tests/test_control_flow.py's closure-gradient case, with the JAX
    executor's vjp in place of finite differences)."""
    def build(sym):
        w = sym.var("w")
        outs, finals = sym.contrib.foreach(
            lambda x, st: (x * w + st[0], [x * w + st[0]]),
            sym.var("data"), [sym.var("s0")])
        return sym.Group([outs, finals[0]])
    rs = np.random.RandomState(0)
    _both(build, {"data": rs.randn(3, 2).astype(np.float32),
                  "w": rs.randn(2).astype(np.float32),
                  "s0": rs.randn(2).astype(np.float32)},
          grads=("w", "data", "s0"))


def test_foreach_multiple_outputs_and_states():
    def build(sym):
        outs, finals = sym.contrib.foreach(
            lambda x, st: ([x + st[0], x * st[1]], [st[0] + x, st[1] * 1.0]),
            sym.var("data"), [sym.var("a"), sym.var("b")])
        return sym.Group(list(outs) + list(finals))
    out, _ = _both(build, {"data": np.ones((3, 2), np.float32),
                           "a": np.zeros(2, np.float32),
                           "b": np.full((2,), 2.0, np.float32)})
    np.testing.assert_allclose(out[0][:, 0], [1, 2, 3])
    np.testing.assert_allclose(out[2], [3, 3])


def test_foreach_rnn_cell_body_gradients():
    """An Elman cell as the loop body, with its weights in the closure."""
    def build(sym):
        def body(x, st):
            h = sym.tanh(sym.FullyConnected(x, sym.var("wx"), sym.var("b"),
                                            num_hidden=5) +
                         sym.FullyConnected(st[0], sym.var("wh"),
                                            no_bias=True, num_hidden=5))
            return h, [h]
        outs, finals = sym.contrib.foreach(body, sym.var("data"),
                                           [sym.var("h0")])
        return sym.Group([outs, finals[0]])
    rs = np.random.RandomState(1)
    args = {"data": rs.randn(6, 2, 4).astype(np.float32),
            "h0": np.zeros((2, 5), np.float32),
            "wx": rs.randn(5, 4).astype(np.float32) * 0.5,
            "wh": rs.randn(5, 5).astype(np.float32) * 0.5,
            "b": rs.randn(5).astype(np.float32)}
    _both(build, args, grads=("data", "wx", "wh", "b", "h0"))


def test_while_loop_masked_steps():
    """All max_iterations steps run with a mask: rows not executed are
    zeros and the loop variables stop when cond turns false."""
    def build(sym):
        outs, finals = sym.contrib.while_loop(
            lambda i, s: i < 5, lambda i, s: (s, [i + 1, s + i]),
            [sym.var("i"), sym.var("s")], max_iterations=8)
        return sym.Group([outs, finals[0], finals[1]])
    out, _ = _both(build, {"i": np.zeros(1, np.float32),
                           "s": np.zeros(1, np.float32)})
    np.testing.assert_allclose(out[0].ravel(), [0, 0, 1, 3, 6, 0, 0, 0])
    assert float(out[1]) == 5 and float(out[2]) == 10


def test_while_loop_gradient_with_closure():
    def build(sym):
        w = sym.var("w")
        outs, finals = sym.contrib.while_loop(
            lambda i, s: i < 3, lambda i, s: (s * w, [i + 1, s * w + 1]),
            [sym.var("i"), sym.var("s")], max_iterations=5)
        return sym.Group([outs, finals[1]])
    rs = np.random.RandomState(2)
    _both(build, {"i": np.zeros(1, np.float32),
                  "s": rs.randn(3).astype(np.float32),
                  "w": rs.randn(3).astype(np.float32)}, grads=("s", "w"))


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_cond_both_branches(sign):
    def build(sym):
        x = sym.var("x")
        return sym.contrib.cond(sym.sum(x) > 0, lambda: x * 2,
                                lambda: x - 1)
    val = sign * np.ones(3, np.float32)
    out, _ = _both(build, {"x": val}, grads=("x",))
    np.testing.assert_allclose(out[0], 2 * val if sign > 0 else val - 1)


def test_cond_branch_not_taken_with_an_infinite_derivative():
    """The else branch, log(x), has an infinite derivative at x = 0 and is
    not taken: the gradient is the then branch's alone, as ``lax.cond``
    gives it.  Selecting with ``where`` over both branches alone would
    give NaN there."""
    def build(sym):
        x = sym.var("x")
        return sym.contrib.cond(sym.sum(x) > 0, lambda: x * 2,
                                lambda: sym.log(x))
    x = np.array([0.0, 1.0, 2.0], np.float32)
    _, grads = _both(build, {"x": x}, grads=("x",))
    assert np.isfinite(grads["x"]).all()
    t = torch.tensor(x, requires_grad=True)
    bare = torch.where(torch.tensor(True), t * 2, torch.log(t))
    (g,) = torch.autograd.grad(bare.sum(), t)
    assert torch.isnan(g[0])


def test_control_flow_graph_json_round_trips_in_the_port():
    """Subgraph parameters are written as nested graph JSON and read back
    as Symbols; the loaded graph computes what the original does."""
    s = tmx.sym
    w = s.var("w")
    fo, _ = s.contrib.foreach(lambda x, st: (x * w + st[0], [x + st[0]]),
                              s.var("data"), [s.var("s0")])
    wo, _ = s.contrib.while_loop(lambda i: i < 3,
                                 lambda i: (i * 2, [i + 1]),
                                 [s.var("i")], max_iterations=4)
    co = s.contrib.cond(s.sum(w) > 0, lambda: w * 3, lambda: w - 1)
    g = s.Group([fo, wo, co])
    loaded = s.load_json(g.tojson())
    assert loaded.tojson() == g.tojson()
    assert loaded.list_arguments() == g.list_arguments()
    args = {"data": np.arange(6, dtype=np.float32).reshape(3, 2),
            "w": np.array([0.5, -2.0], np.float32),
            "s0": np.ones(2, np.float32), "i": np.zeros(1, np.float32)}
    want, _ = _run(tmx, g, args)
    got, _ = _run(tmx, loaded, args)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    node = [n for n in json.loads(g.tojson())["nodes"]
            if n["op"] == "_foreach"][0]
    assert json.loads(node["attrs"]["subgraph"])["heads"]


def test_reference_json_holds_no_subgraph():
    """The JAX package writes a subgraph parameter as the Symbol's repr,
    so its control-flow JSON cannot be read back by either package
    (ROADMAP queue C caveats); the port's cannot run in the JAX package
    either, whose reader leaves the nested graph a dict."""
    s = jmx.sym
    fo, _ = s.contrib.foreach(lambda x, st: (x + st[0], [x + st[0]]),
                              s.var("data"), [s.var("s0")])
    node = [n for n in json.loads(fo.tojson())["nodes"]
            if n["op"] == "_foreach"][0]
    assert node["attrs"]["subgraph"].startswith("<Symbol")
    t = tmx.sym
    po, _ = t.contrib.foreach(lambda x, st: (x + st[0], [x + st[0]]),
                              t.var("data"), [t.var("s0")])
    jsym = s.load_json(po.tojson())
    jnode = [n for n in jsym._topo() if not n.is_var][0]
    assert isinstance(jnode.params["subgraph"], dict)


def test_subgraph_exec_runs_a_captured_symbol():
    s = tmx.sym
    sub = s.FullyConnected(s.var("a"), s.var("w"), no_bias=True,
                           num_hidden=3) * 2
    from mxnet_tpu_torch.symbol.symbol import _sym_invoke
    out = _sym_invoke("_subgraph_exec", [s.var("x"), s.var("wt")],
                      {"subgraph": sub, "input_names": ("a", "w"),
                       "n_outputs": 1})
    rs = np.random.RandomState(3)
    x, w = rs.randn(2, 4).astype(np.float32), rs.randn(3, 4).astype(
        np.float32)
    got, _ = _run(tmx, out, {"x": x, "wt": w})
    np.testing.assert_allclose(got[0], 2 * x @ w.T, **TOL)


def test_foreach_rnn_trains_through_the_module_fused_step():
    """A foreach RNN inside a Module: the fused step (one program; one
    CUDA graph on the card) and the legacy forward_backward + update give
    the same weights from the same start."""
    s = tmx.sym

    # shape inference does not look into the body: the closure's weights
    # and the begin state carry their shapes
    wx = s.var("rnn_i2h_weight", shape=(8, 2))
    bx = s.var("rnn_i2h_bias", shape=(8,))
    wh = s.var("rnn_h2h_weight", shape=(8, 8))

    def body(x, st):
        h = s.tanh(s.FullyConnected(x, wx, bx, num_hidden=8) +
                   s.FullyConnected(st[0], wh, no_bias=True, num_hidden=8))
        return h, [h]
    data = s.swapaxes(s.var("data"), dim1=0, dim2=1)
    _, last = s.contrib.foreach(body, data, [s.var("h0", shape=(4, 8))])
    net = s.SoftmaxOutput(s.FullyConnected(last[0], num_hidden=3,
                                           name="fc"),
                          s.var("softmax_label"), name="sm")
    rs = np.random.RandomState(4)
    x = rs.randn(4, 5, 2).astype(np.float32)
    y = rs.randint(0, 3, 4).astype(np.float32)
    it = tmx.io.NDArrayIter(x, y, batch_size=4)
    batch = next(iter(it))
    weights = {}
    results = []
    for fused in ("1", "0"):
        mod = tmx.mod.Module(net, context=tmx.cpu(),
                             fixed_param_names=["h0"])
        mod.bind(it.provide_data, it.provide_label)
        if not weights:
            mod.init_params(tmx.init.Xavier())
            weights.update(mod.get_params()[0])
        mod.init_params(arg_params=weights, force_init=True)
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params={"learning_rate": 0.5,
                                             "momentum": 0.9})
        os.environ["MXNET_MODULE_FUSED_STEP"] = fused
        try:
            for _ in range(3):
                mod.forward_backward_update(batch)
        finally:
            os.environ.pop("MXNET_MODULE_FUSED_STEP", None)
        if fused == "1":
            assert mod.fused_step is not None
        results.append(mod.get_params()[0])
    for n in results[0]:
        np.testing.assert_allclose(results[0][n].asnumpy(),
                                   results[1][n].asnumpy(), **TOL)
    assert not np.allclose(results[0]["rnn_i2h_weight"].asnumpy(),
                           weights["rnn_i2h_weight"].asnumpy())
