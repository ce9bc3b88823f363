"""``mx.subgraph`` of mxnet_tpu_torch against the JAX package on the CPU
(mirrors tests/test_subgraph.py): the same graphs partitioned by the same
properties in both packages give the same structure (which nodes a
``_subgraph_exec`` swallows), and the port's partitioned graph gives the
JAX package's outputs and gradients (outputs within 1e-5 x max(1,
max |JAX|), gradients within 1e-4 x max |g|).
"""

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

PKGS = {"jax": jmx, "port": tmx}


def _ctx(mx):
    return tmx.cpu() if mx is tmx else jmx.cpu()


def _count_ops(sym, op_name):
    return sum(1 for n in sym._topo()
               if not n.is_var and n.op.name == op_name)


def _ops(sym):
    return sorted(n.op.name for n in sym._topo() if not n.is_var)


def _net(mx):
    data = mx.sym.var("data")
    w = mx.sym.var("w")
    fc = mx.sym.FullyConnected(data, w, num_hidden=8, no_bias=True,
                               name="fc")
    a = mx.sym.Activation(fc, act_type="relu")
    b = a + 1.0
    c = b * 2.0
    return mx.sym.FullyConnected(c, num_hidden=3, name="fc2")


def _values(mx, sym, data_shape, seed=1):
    shapes = dict(zip(sym.list_arguments(),
                      sym.infer_shape(data=data_shape)[0]))
    rs = np.random.RandomState(seed)
    return {n: rs.randn(*s).astype(np.float32) for n, s in shapes.items()}


def _run(mx, sym, vals, grads=True):
    ctx = _ctx(mx)
    args = {n: mx.nd.array(v, ctx=ctx) for n, v in vals.items()}
    kw = {"args_grad": {n: mx.nd.zeros(v.shape, ctx=ctx)
                        for n, v in vals.items()}} if grads else {}
    ex = sym.bind(ctx, args, **kw)
    outs = ex.forward(is_train=grads)
    res = [o.asnumpy() for o in outs]
    if grads:
        ex.backward([mx.nd.ones(o.shape, ctx=ctx) for o in outs])
        res += [ex.grad_dict[n].asnumpy() for n in sorted(vals)]
    return res, len(outs)


def _close(got, want, n_out):
    for k, (g, w) in enumerate(zip(got, want)):
        if k < n_out:
            assert np.abs(g - w).max() <= 1e-5 * max(1.0, np.abs(w).max())
        else:
            assert np.abs(g - w).max() <= 1e-4 * max(np.abs(w).max(), 1e-30)


def _partitioned(build, prop):
    out = {}
    for key, mx in PKGS.items():
        net = build(mx)
        p = prop(mx) if callable(prop) else prop
        out[key] = (net, mx.subgraph.partition_graph(net, p))
    return out


def test_partition_fuses_elemwise_chain_and_preserves_outputs():
    parts = _partitioned(_net, "MXTPU_FUSE")
    for net, part in parts.values():
        assert _count_ops(part, "_subgraph_exec") == 1
        assert _count_ops(part, "Activation") == 0
        assert _count_ops(part, "_plus_scalar") == 0
        assert sorted(part.list_arguments()) == sorted(net.list_arguments())
    assert _ops(parts["port"][1]) == _ops(parts["jax"][1])
    vals = _values(jmx, parts["jax"][0], (4, 6))
    want, n = _run(jmx, parts["jax"][1], vals, grads=False)
    got, _ = _run(tmx, parts["port"][1], vals, grads=False)
    ref, _ = _run(tmx, parts["port"][0], vals, grads=False)
    _close(got, want, n)
    _close(got, ref, n)


def test_partition_gradients_flow_through_subgraph():
    parts = _partitioned(_net, "MXTPU_FUSE")
    vals = _values(jmx, parts["jax"][0], (4, 6))
    want, n = _run(jmx, parts["jax"][1], vals)
    got, _ = _run(tmx, parts["port"][1], vals)
    ref, _ = _run(tmx, parts["port"][0], vals)
    _close(got, want, n)
    _close(got, ref, n)


def _convex(mx):
    data = mx.sym.var("data")
    y = mx.sym.Activation(data, act_type="relu", name="r1")
    z = mx.sym.FullyConnected(y, num_hidden=4, no_bias=True, name="fcm")
    return mx.sym.Activation(y, act_type="relu", name="r2") + z


def test_partition_respects_convexity():
    parts = _partitioned(_convex, "MXTPU_FUSE")
    assert _ops(parts["port"][1]) == _ops(parts["jax"][1])
    vals = _values(jmx, parts["jax"][0], (2, 4))
    want, n = _run(jmx, parts["jax"][1], vals)
    got, _ = _run(tmx, parts["port"][1], vals)
    _close(got, want, n)


def test_env_var_backend_applies_at_bind(monkeypatch):
    net = _net(tmx)
    vals = _values(tmx, net, (4, 6))
    monkeypatch.setenv("MXNET_SUBGRAPH_BACKEND", "MXTPU_FUSE")
    ex = net.bind(tmx.cpu(), {n: tmx.nd.array(v, ctx=tmx.cpu())
                              for n, v in vals.items()})
    assert _count_ops(ex._symbol, "_subgraph_exec") == 1
    got = ex.forward()[0].asnumpy()
    monkeypatch.delenv("MXNET_SUBGRAPH_BACKEND")
    want, n = _run(jmx, _net(jmx), vals, grads=False)
    _close([got], want, n)


def _rewrite_prop(calls):
    def make(mx):
        sg = mx.subgraph

        class _Prop(sg.SubgraphProperty):
            def create_subgraph_selector(self):
                class _S(sg.SubgraphSelector):
                    def select(self, node):
                        return (not node.is_var) and \
                            node.op.name == "Activation"
                return _S()

            def rewrite_subgraph(self, sub, sid):
                calls.append(len(sub._outputs))
                return sub
        sg.register_subgraph_property("TEST_PROP", _Prop)
        assert "TEST_PROP" in sg.list_subgraph_backends()
        return "TEST_PROP"
    return make


def _two_acts(mx):
    data = mx.sym.var("data")
    return mx.sym.Activation(mx.sym.Activation(data, act_type="relu"),
                             act_type="tanh")


def test_custom_property_rewrite_hook():
    calls = []
    parts = _partitioned(_two_acts, _rewrite_prop(calls))
    assert calls == [1, 1]
    for _, part in parts.values():
        assert _count_ops(part, "_subgraph_exec") == 1
    x = np.random.RandomState(0).randn(3, 5).astype(np.float32)
    got, _ = _run(tmx, parts["port"][1], {"data": x}, grads=False)
    np.testing.assert_allclose(got[0], np.tanh(np.maximum(x, 0)),
                               rtol=1e-5, atol=1e-6)


def _select_all(mx):
    sg = mx.subgraph

    class _All(sg.SubgraphProperty):
        def create_subgraph_selector(self):
            class _S(sg.SubgraphSelector):
                def select(self, node):
                    return True
            return _S()
    return _All()


def _bn(mx):
    data = mx.sym.var("data")
    bn = mx.sym.BatchNorm(data, name="bn")
    return mx.sym.Activation(bn, act_type="relu") + 1.0


def test_batchnorm_aux_nodes_not_absorbed():
    parts = _partitioned(_bn, _select_all)
    for _, part in parts.values():
        assert _count_ops(part, "BatchNorm") == 1
    assert _ops(parts["port"][1]) == _ops(parts["jax"][1])


def _shared(mx):
    data = mx.sym.var("data")
    n1 = mx.sym.Activation(data, act_type="relu", name="n1")
    fc = mx.sym.FullyConnected(n1, num_hidden=4, no_bias=True, name="fc")
    a = mx.sym.Activation(fc + 1.0, act_type="relu", name="n2")
    b = mx.sym.Activation(n1, act_type="sigmoid", name="n3")
    return mx.sym.Group([a, b])


def test_partition_no_duplicate_computation_across_components():
    parts = _partitioned(_shared, "MXTPU_FUSE")
    top = [n.op.name for n in parts["port"][1]._topo() if not n.is_var]
    assert top.count("Activation") == 0 and "_subgraph_exec" in top
    assert _ops(parts["port"][1]) == _ops(parts["jax"][1])
    vals = _values(jmx, parts["jax"][0], (2, 4))
    want, n = _run(jmx, parts["jax"][1], vals)
    got, _ = _run(tmx, parts["port"][1], vals)
    _close(got, want, n)


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_select_input_vetoes_growth(pkg):
    mx = PKGS[pkg]
    sg = mx.subgraph

    class _Prop(sg.SubgraphProperty):
        def create_subgraph_selector(self):
            class _S(sg.SubgraphSelector):
                def select(self, node):
                    return (not node.is_var) and \
                        node.op.name == "Activation"

                def select_input(self, node, input_node):
                    return False
            return _S()

    part = sg.partition_graph(_two_acts(mx), _Prop())
    assert _count_ops(part, "_subgraph_exec") == 0
    assert _count_ops(part, "Activation") == 2
