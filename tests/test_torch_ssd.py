"""SSD-300 (VGG16-reduced) on the PyTorch port against the JAX package:
``chip_smoke.py``'s copy of the graph functions of
``examples/ssd_model.py`` and ``examples/train_ssd.py`` against the
examples' own (argument names, auxiliary states, outputs and shapes),
and, at 1/8 of every convolution's width, one training step's loss and
every parameter gradient against ``jax.vjp`` of the JAX graph from the
same weights, carried across by ``gluon.load_jax_params``.

Tolerances: the loss within 1e-5 of max(1, |loss|), each parameter's
gradient within 1e-4 of its max |g|; the matched targets equal.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.executor import _build_eval as jbuild

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.gluon import load_jax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "examples"))

import chip_smoke  # noqa: E402
import ssd_model  # noqa: E402
import train_ssd  # noqa: E402

TOL_LOSS, TOL_GRAD = 1e-5, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    # the suite runs files in parallel processes: few intra-op threads a
    # process keep them from oversubscribing the cores
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_names():
    """Auto-generated names count per process: each test builds its graphs
    in a fresh name scope of each package, so the names compared do not
    depend on what other tests in this process built."""
    with jmx.name.NameManager(), tmx.name.NameManager():
        yield


def _same_graph(jsym, tsym, shapes):
    assert tsym.list_arguments() == jsym.list_arguments()
    assert tsym.list_auxiliary_states() == jsym.list_auxiliary_states()
    assert tsym.list_outputs() == jsym.list_outputs()
    ja, jo, jx = jsym.infer_shape(**shapes)
    ta, to, tx = tsym.infer_shape(**shapes)
    assert [tuple(s) for s in ta] == [tuple(s) for s in ja]
    assert [tuple(s) for s in to] == [tuple(s) for s in jo]
    return dict(zip(tsym.list_arguments(), [tuple(s) for s in ta])), \
        [tuple(s) for s in to]


def test_ssd300_graphs_match_the_example():
    _, outs = _same_graph(ssd_model.build_ssd300_infer(num_classes=20),
                          chip_smoke.build_ssd300_infer(tmx, 20),
                          dict(data0=(2, 3, 300, 300)))
    assert outs == [(2, 8732, 6)]
    _, outs = _same_graph(ssd_model.build_ssd300_train(num_classes=20),
                          chip_smoke.build_ssd300_train(tmx, 20),
                          dict(data0=(2, 3, 300, 300), label=(2, 3, 5)))
    assert outs == [(2 * 8732, 21), (2, 8732 * 4), (1, 8732, 4)]
    assert chip_smoke.SSD_ANCHORS == 8732
    assert chip_smoke.SSD_SIZES == ssd_model._SIZES
    assert chip_smoke.SSD_RATIOS == ssd_model._RATIOS


def test_train_ssd_graph_and_data_match_the_example():
    _same_graph(train_ssd.build_ssd(3, 4),
                chip_smoke.build_ssd_example(tmx, 3, 4),
                dict(data=(2, 3, 64, 64), label=(2, 1, 5)))
    jx, jy = train_ssd.synthetic_detection_set(16)
    tx, ty = chip_smoke.ssd_example_data(np, 16)
    np.testing.assert_array_equal(tx, jx)
    np.testing.assert_array_equal(ty, jy)


def _weights(shapes, seed=0):
    rs = np.random.RandomState(seed)
    out = {}
    for name, shape in shapes.items():
        if name in ("data0", "label"):
            continue
        fan_in = int(np.prod(shape[1:])) if len(shape) > 1 else 1
        scale = np.sqrt(2.0 / fan_in) if name.endswith("weight") else 0.05
        out[name] = (rs.standard_normal(shape) * scale).astype(np.float32)
    return out


def _batch(rs, b, g=3):
    x = rs.standard_normal((b, 3, 300, 300)).astype(np.float32)
    y = np.full((b, g, 5), -1.0, np.float32)
    for i in range(b):
        k = 1 + i % g
        c = rs.uniform(0.25, 0.75, (k, 2))
        wh = rs.uniform(0.1, 0.5, (k, 2))
        y[i, :k, 0] = rs.randint(0, 20, k)
        y[i, :k, 1:3] = c - wh / 2
        y[i, :k, 3:5] = c + wh / 2
    return x, y


def test_small_ssd_training_step_matches_jax():
    """SSD-300 at 1/8 width, batch 2: the JAX graph's loss and parameter
    gradients (``jax.vjp`` with ones on the two loss heads) against the
    port's (a SymbolBlock whose weights come through load_jax_params,
    ``autograd.record`` and ``backward`` with the same head gradients)."""
    div = 8
    jsym = chip_smoke.build_ssd300_train(jmx, 20, div)
    tsym = chip_smoke.build_ssd300_train(tmx, 20, div)
    x, y = _batch(np.random.RandomState(1), 2)
    shapes, outs = _same_graph(jsym, tsym, dict(data0=x.shape, label=y.shape))
    weights = _weights(shapes)

    ev = jbuild(jsym, True)

    def jfwd(params):
        args = dict(params, data0=jnp.asarray(x), label=jnp.asarray(y))
        return tuple(ev(args, {}, jax.random.PRNGKey(0))[0])

    jouts, vjp = jax.vjp(jfwd, {k: jnp.asarray(v) for k, v in
                                weights.items()})
    cots = (jnp.ones(outs[0]), jnp.ones(outs[1]), jnp.zeros(outs[2]))
    jgrads = vjp(cots)[0]

    net = tmx.gluon.SymbolBlock(tsym, [tmx.sym.var("data0"),
                                       tmx.sym.var("label")])
    net.initialize(ctx=tmx.cpu())
    load_jax_params(net, weights)
    xd, yd = tmx.nd.array(x, ctx=tmx.cpu()), tmx.nd.array(y, ctx=tmx.cpu())
    with tmx.autograd.record():
        touts = net(xd, yd)
    tmx.autograd.backward(touts[:2], [tmx.nd.ones(outs[0], ctx=tmx.cpu()),
                                      tmx.nd.ones(outs[1], ctx=tmx.cpu())])
    for t, j in zip(touts, jouts):
        np.testing.assert_allclose(t.asnumpy(), np.asarray(j), rtol=0,
                                   atol=1e-5 * max(1.0, float(
                                       np.abs(np.asarray(j)).max())))

    # the targets the loss reads, matched again from the anchors
    from mxnet_tpu_torch.ops import detection
    anchor = torch.from_numpy(np.asarray(jouts[2]))
    cls_t = torch.from_numpy(np.asarray(jouts[0])).reshape(2, 8732, 21) \
        .transpose(1, 2)
    tgt = detection._multibox_target(anchor, torch.from_numpy(y), cls_t)[2]
    def loss(outs):
        cls_prob, loc_loss = (torch.from_numpy(np.asarray(o, np.float64))
                              for o in outs[:2])
        return chip_smoke.ssd_loss(torch, cls_prob, loc_loss, tgt).item()
    losses = [loss(jouts), loss([t.asnumpy() for t in touts])]
    assert int((tgt >= 1).sum()) > 0
    assert abs(losses[1] - losses[0]) <= TOL_LOSS * max(1.0, abs(losses[0]))

    params = net.collect_params()
    assert sorted(params.keys()) == sorted(jgrads)
    for name, j in jgrads.items():
        j = np.asarray(j)
        g = params[name].grad().asnumpy()
        err = np.abs(g - j).max() / max(np.abs(j).max(), 1e-30)
        assert err <= TOL_GRAD, (name, err)
