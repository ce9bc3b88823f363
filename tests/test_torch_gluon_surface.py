"""The gluon user surface of the PyTorch port against the JAX
package: the new layers, the losses, parameter files in both directions,
``SymbolBlock.imports``, ``split_and_load``, ``clip_global_norm`` and the
new initializers, on the same numpy inputs and weights (fixed seeds).

The cases of tests/test_gluon.py's test_losses, test_sigmoid_bce_pos_weight,
test_split_and_load, test_clip_global_norm and
test_export_symbolblock_imports are mirrored with their tolerances.
Layer and loss outputs are held to the JAX package's within 1e-6 of
max(1, max |output|) (f32 libm and summation order); parameter files to
bit-equal values.
"""

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon, nd
from mxnet_tpu_torch.gluon import nn

CPU = mx.cpu()
TOL = 1e-6


def _a(x):
    return nd.array(x, ctx=CPU)


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    scale = max(1.0, float(np.max(np.abs(want))) if want.size else 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


# -- tests/test_gluon.py, mirrored -------------------------------------------

def test_losses():
    pred = _a([[1.0, -1.0], [-1.0, 1.0]])
    label = _a([0, 1])
    l = gluon.loss.SoftmaxCrossEntropyLoss()(pred, label)
    expected = -np.log(np.exp(1) / (np.exp(1) + np.exp(-1)))
    np.testing.assert_allclose(l.asnumpy(), [expected] * 2, rtol=1e-5)
    l2 = gluon.loss.L2Loss()(_a([1.0, 2.0]), _a([0.0, 0.0]))
    np.testing.assert_allclose(l2.asnumpy(), [0.5, 2.0], rtol=1e-5)
    l1 = gluon.loss.L1Loss()(_a([1.0, -2.0]), _a([0.0, 0.0]))
    np.testing.assert_allclose(l1.asnumpy(), [1.0, 2.0], rtol=1e-5)
    bce = gluon.loss.SigmoidBinaryCrossEntropyLoss()(_a([0.0]), _a([1.0]))
    np.testing.assert_allclose(bce.asnumpy(), [np.log(2)], rtol=1e-5)
    h = gluon.loss.HuberLoss()(_a([2.0]), _a([0.0]))
    np.testing.assert_allclose(h.asnumpy(), [1.5], rtol=1e-5)


def test_sigmoid_bce_pos_weight():
    rs = np.random.RandomState(3)
    x = rs.randn(4, 3).astype("float32")
    z = (rs.rand(4, 3) > 0.5).astype("float32")
    w = np.array([2.0, 0.5, 3.0], "float32")
    s = 1 / (1 + np.exp(-x))
    want = (-(w * z * np.log(s) + (1 - z) * np.log(1 - s))).mean(1)
    bce = gluon.loss.SigmoidBinaryCrossEntropyLoss
    logit = bce()(_a(x), _a(z), None, _a(w))
    np.testing.assert_allclose(logit.asnumpy(), want, rtol=1e-4)
    prob = bce(from_sigmoid=True)(_a(s.astype("float32")), _a(z), None,
                                  _a(w))
    np.testing.assert_allclose(prob.asnumpy(), want, rtol=1e-3)
    ones = bce()(_a(x), _a(z), None, _a(np.ones(3, "float32")))
    base = bce()(_a(x), _a(z))
    np.testing.assert_allclose(ones.asnumpy(), base.asnumpy(), rtol=1e-5)


def test_split_and_load():
    data = nd.arange(0, 16, ctx=CPU).reshape(8, 2)
    parts = gluon.split_data(data, 4)
    assert len(parts) == 4 and parts[0].shape == (2, 2)
    loaded = gluon.split_and_load(data, [mx.cpu(), mx.cpu()])
    assert len(loaded) == 2
    want = jmx.gluon.split_data(jmx.nd.arange(0, 16).reshape(8, 2), 4)
    for p, w in zip(parts, want):
        np.testing.assert_array_equal(p.asnumpy(), w.asnumpy())
    uneven = gluon.split_data(nd.arange(0, 10, ctx=CPU), 3,
                              even_split=False)
    assert [u.shape[0] for u in uneven] == [3, 3, 4]
    with pytest.raises(ValueError):
        gluon.split_data(nd.arange(0, 10, ctx=CPU), 3)
    host = gluon.split_and_load(np.arange(6.0).reshape(3, 2), [mx.cpu()])
    assert host[0].shape == (3, 2) and host[0].dtype == np.float32


def test_clip_global_norm():
    arrays = [nd.ones((2, 2), ctx=CPU) * 3, nd.ones((2,), ctx=CPU) * 4]
    norm = gluon.clip_global_norm(arrays, 1.0)
    total = sum(float((a * a).sum().asscalar()) for a in arrays)
    assert abs(total - 1.0) < 1e-3
    jarrays = [jmx.nd.ones((2, 2)) * 3, jmx.nd.ones((2,)) * 4]
    assert norm == jmx.gluon.clip_global_norm(jarrays, 1.0)
    for a, j in zip(arrays, jarrays):
        np.testing.assert_array_equal(a.asnumpy(), j.asnumpy())


def _mlp(pkg, prefix):
    net = pkg.gluon.nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(pkg.gluon.nn.Dense(8, activation="relu"),
                pkg.gluon.nn.Dense(3))
    return net


def test_export_symbolblock_imports(tmp_path):
    net = _mlp(mx, "mlp_")
    net.initialize(ctx=CPU)
    net.hybridize()
    x = nd.random.normal(shape=(2, 5), ctx=CPU)
    ref = net(x).asnumpy()
    path = str(tmp_path / "model")
    net.export(path)
    net2 = gluon.SymbolBlock.imports(path + "-symbol.json", ["data0"],
                                     path + "-0000.params", ctx=CPU)
    np.testing.assert_allclose(net2(x).asnumpy(), ref, rtol=1e-5, atol=1e-6)
    # the JAX package's export imports into the port as well
    jnet = _mlp(jmx, "jmlp_")
    jnet.initialize(ctx=jmx.cpu())
    jnet.hybridize()
    xj = np.random.RandomState(4).randn(2, 5).astype("float32")
    jref = jnet(jmx.nd.array(xj)).asnumpy()
    jpath = str(tmp_path / "jmodel")
    jnet.export(jpath)
    net3 = gluon.SymbolBlock.imports(jpath + "-symbol.json", ["data0"],
                                     jpath + "-0000.params", ctx=CPU)
    _close(net3(_a(xj)).asnumpy(), jref)


# -- layers ------------------------------------------------------------------

LAYERS = [
    ("InstanceNorm", lambda g: g.nn.InstanceNorm(scale=True), (2, 3, 4, 5)),
    ("LeakyReLU", lambda g: g.nn.LeakyReLU(0.1), (3, 4)),
    ("PReLU", lambda g: g.nn.PReLU(), (3, 4)),
    ("ELU", lambda g: g.nn.ELU(0.7), (3, 4)),
    ("SELU", lambda g: g.nn.SELU(), (3, 4)),
    ("Swish", lambda g: g.nn.Swish(), (3, 4)),
    ("Swish-beta", lambda g: g.nn.Swish(beta=2.0), (3, 4)),
    ("GELU", lambda g: g.nn.GELU(), (3, 4)),
    ("HybridLambda", lambda g: g.nn.HybridLambda("tanh"), (3, 4)),
    ("HybridLambda-fn", lambda g: g.nn.HybridLambda(
        lambda F, x: F.relu(x) * 2), (3, 4)),
    ("Lambda", lambda g: g.nn.Lambda("exp"), (3, 4)),
    ("Dropout-predict", lambda g: g.nn.Dropout(0.5), (3, 4)),
]


@pytest.mark.parametrize("hybridize", [False, True])
@pytest.mark.parametrize("make,shape", [(m, s) for _, m, s in LAYERS],
                         ids=[n for n, _, _ in LAYERS])
def test_layer_matches_jax(make, shape, hybridize):
    x = np.random.RandomState(5).randn(*shape).astype("float32")
    tl, jl = make(gluon), make(jmx.gluon)
    jl.initialize(ctx=jmx.cpu())
    tl.initialize(ctx=CPU)
    if hybridize and isinstance(tl, gluon.HybridBlock):
        tl.hybridize()
        jl.hybridize()
    want = jl(jmx.nd.array(x)).asnumpy()      # (creates deferred weights)
    for tp, jp in zip(tl.collect_params().values(),
                      jl.collect_params().values()):
        tp.set_data(jp.data().asnumpy())
    _close(tl(_a(x)).asnumpy(), want)


def test_dropout_layer_in_training():
    layer = nn.Dropout(0.4)
    layer.initialize(ctx=CPU)
    x = nd.ones((1000, 1000), ctx=CPU)
    mx.random.seed(0)
    with autograd.record():
        y = layer(x)
    out = y.asnumpy()
    kept = out != 0
    from mxnet_tpu_torch.test_utils import moments_within
    ok, text = moments_within(kept.reshape(-1).astype(np.float64), 0.6,
                              0.24)
    assert ok, text
    np.testing.assert_array_equal(out[kept], np.float32(1 / 0.6))
    mx.random.seed(0)
    with autograd.record():
        again = layer(x)
    np.testing.assert_array_equal(again.asnumpy(), out)
    np.testing.assert_array_equal(layer(x).asnumpy(), x.asnumpy())
    # along axes: one draw per row
    with autograd.record():
        rows = nn.Dropout(0.5, axes=(1,))(nd.ones((50, 8), ctx=CPU))
    r = rows.asnumpy()
    assert np.all((r == r[:, :1]))


LOSSES = [
    ("L2Loss", lambda L: L.L2Loss(), 2),
    ("L2Loss-w", lambda L: L.L2Loss(weight=0.5), 2),
    ("L1Loss", lambda L: L.L1Loss(), 2),
    ("SigmoidBCE", lambda L: L.SigmoidBinaryCrossEntropyLoss(), 2),
    ("SigmoidBCE-prob", lambda L: L.SigmoidBinaryCrossEntropyLoss(
        from_sigmoid=True), 2),
    ("SoftmaxCE-dense", lambda L: L.SoftmaxCrossEntropyLoss(
        sparse_label=False), 2),
    ("KLDivLoss", lambda L: L.KLDivLoss(), 2),
    ("KLDivLoss-logits", lambda L: L.KLDivLoss(from_logits=False), 2),
    ("HuberLoss", lambda L: L.HuberLoss(rho=0.7), 2),
    ("HingeLoss", lambda L: L.HingeLoss(), 2),
    ("SquaredHingeLoss", lambda L: L.SquaredHingeLoss(margin=0.5), 2),
    ("LogisticLoss", lambda L: L.LogisticLoss(), 2),
    ("LogisticLoss-binary", lambda L: L.LogisticLoss(
        label_format="binary"), 2),
    ("TripletLoss", lambda L: L.TripletLoss(margin=0.3), 3),
]


@pytest.mark.parametrize("with_weight", [False, True])
@pytest.mark.parametrize("make,n_in", [(m, n) for _, m, n in LOSSES],
                         ids=[n for n, _, _ in LOSSES])
def test_loss_matches_jax(make, n_in, with_weight):
    rs = np.random.RandomState(6)
    tloss, jloss = make(gluon.loss), make(jmx.gluon.loss)
    # labels in [0, 1); predictions logits, or probabilities from_sigmoid
    arrays = [rs.rand(4, 5).astype("float32") for _ in range(n_in)]
    if not getattr(tloss, "_from_sigmoid", False):
        arrays[0] = rs.randn(4, 5).astype("float32")
    sw = rs.rand(4, 1).astype("float32")
    targs = [_a(a) for a in arrays] + ([_a(sw)] if with_weight else [])
    jargs = [jmx.nd.array(a) for a in arrays] + \
        ([jmx.nd.array(sw)] if with_weight else [])
    _close(tloss(*targs).asnumpy(), jloss(*jargs).asnumpy())


def test_loss_gradients_match_jax():
    rs = np.random.RandomState(7)
    p = rs.randn(4, 5).astype("float32")
    y = rs.rand(4, 5).astype("float32")
    tp = _a(p)
    tp.attach_grad()
    with autograd.record():
        tl = gluon.loss.HuberLoss()(tp, _a(y)) + \
            gluon.loss.LogisticLoss()(tp, _a(y))
    tl.backward()
    jp = jmx.nd.array(p)
    jp.attach_grad()
    with jmx.autograd.record():
        jl = jmx.gluon.loss.HuberLoss()(jp, jmx.nd.array(y)) + \
            jmx.gluon.loss.LogisticLoss()(jp, jmx.nd.array(y))
    jl.backward()
    _close(tp.grad.asnumpy(), jp.grad.asnumpy())


# -- parameter files across the packages -------------------------------------

def _convnet(pkg):
    g = pkg.gluon
    net = g.nn.HybridSequential(prefix="cn_")
    with net.name_scope():
        net.add(g.nn.Conv2D(4, 3, in_channels=2), g.nn.BatchNorm(),
                g.nn.Activation("relu"), g.nn.Flatten(), g.nn.Dense(3))
    return net


def test_save_parameters_crosses_both_ways(tmp_path):
    x = np.random.RandomState(8).randn(2, 2, 6, 6).astype("float32")
    jnet = _convnet(jmx)
    jnet.initialize(jmx.init.Xavier(), ctx=jmx.cpu())
    jout = jnet(jmx.nd.array(x)).asnumpy()
    jpath = str(tmp_path / "j.params")
    jnet.save_parameters(jpath)
    tnet = _convnet(mx)
    tnet.load_parameters(jpath, ctx=CPU)
    _close(tnet(_a(x)).asnumpy(), jout, tol=1e-5)
    tparams = tnet._collect_params_with_prefix()
    for name, jp in jnet._collect_params_with_prefix().items():
        np.testing.assert_array_equal(tparams[name].data().asnumpy(),
                                      jp.data().asnumpy())
    # and back: the port's file into a fresh JAX net
    tpath = str(tmp_path / "t.params")
    tnet.save_parameters(tpath)
    jnet2 = _convnet(jmx)
    jnet2.load_parameters(tpath, ctx=jmx.cpu())
    for name, jp in jnet2._collect_params_with_prefix().items():
        np.testing.assert_array_equal(jp.data().asnumpy(),
                                      tparams[name].data().asnumpy())


def test_load_parameters_checks_names(tmp_path):
    net = _mlp(mx, "a_")
    net.initialize(ctx=CPU)
    net(nd.ones((1, 5), ctx=CPU))
    path = str(tmp_path / "p.params")
    net.save_parameters(path)
    other = nn.HybridSequential(prefix="b_")
    with other.name_scope():
        other.add(nn.Dense(8, activation="relu"))
    with pytest.raises(AssertionError, match="not present"):
        other.load_parameters(path, ctx=CPU)
    other.load_parameters(path, ctx=CPU, ignore_extra=True)
    np.testing.assert_array_equal(other[0].weight.data().asnumpy(),
                                  net[0].weight.data().asnumpy())
    bigger = _mlp(mx, "c_")
    with bigger.name_scope():
        bigger.add(nn.Dense(2))
    with pytest.raises(AssertionError, match="missing"):
        bigger.load_parameters(path, ctx=CPU)


def test_parameter_dict_save_load_crosses(tmp_path):
    jnet = _mlp(jmx, "pd_")
    jnet.initialize(ctx=jmx.cpu())
    jnet(jmx.nd.ones((1, 5)))
    path = str(tmp_path / "pd.params")
    jnet.collect_params().save(path, strip_prefix="pd_")
    tnet = _mlp(mx, "pd_")
    tnet.collect_params().load(path, ctx=CPU, restore_prefix="pd_")
    for (n, tp), jp in zip(tnet.collect_params().items(),
                           jnet.collect_params().values()):
        np.testing.assert_array_equal(tp.data().asnumpy(),
                                      jp.data().asnumpy())
    tpath = str(tmp_path / "pd2.params")
    tnet.collect_params().save(tpath)
    jnet.collect_params().load(tpath, ctx=jmx.cpu())


def test_summary_and_infer_shape(capsys):
    net = _mlp(mx, "s_")
    net.initialize(ctx=CPU)
    net.infer_shape(nd.ones((2, 5), ctx=CPU))
    assert net[0].weight.shape == (8, 5)
    net.summary(nd.ones((2, 5), ctx=CPU))
    assert "Total params: %d" % (8 * 5 + 8 + 3 * 8 + 3) in \
        capsys.readouterr().out


# -- initializers ------------------------------------------------------------

def _filled(init, shape, name="w_weight"):
    arr = nd.zeros(shape, ctx=CPU)
    gen = torch.Generator()
    gen.manual_seed(0)
    init(name, arr, gen)
    return arr.asnumpy()


def test_orthogonal():
    w = _filled(mx.init.Orthogonal(scale=1.0), (4, 6)).astype(np.float64)
    np.testing.assert_allclose(w @ w.T, np.eye(4), atol=1e-5)
    w = _filled(mx.init.Orthogonal(rand_type="normal", scale=2.0), (6, 3))
    np.testing.assert_allclose(w.T.astype(np.float64) @ w, 4 * np.eye(3),
                               atol=1e-4)


@pytest.mark.parametrize("make,shape,name", [
    (lambda i: i.Bilinear(), (2, 1, 4, 4), "up_weight"),
    (lambda i: i.Mixed([".*bias", ".*"], [i.One(), i.Constant(0.5)]),
     (3,), "x_bias"),
    (lambda i: i.Mixed([".*bias", ".*"], [i.One(), i.Constant(0.5)]),
     (3,), "x_weight"),
], ids=["Bilinear", "Mixed-bias", "Mixed-weight"])
def test_deterministic_initializers_match_jax(make, shape, name):
    got = _filled(make(mx.init), shape, name)
    jarr = jmx.nd.zeros(shape)
    make(jmx.init)(name, jarr)
    np.testing.assert_array_equal(got, jarr.asnumpy())


def test_lstm_bias():
    # (the JAX package's LSTMBias writes into a read-only asnumpy() copy
    # and raises, so this one is held to its definition)
    np.testing.assert_array_equal(
        _filled(mx.init.LSTMBias(forget_bias=1.5), (8,), "lstm_bias"),
        [0, 0, 1.5, 1.5, 0, 0, 0, 0])


def test_init_desc_and_register():
    desc = mx.init.InitDesc("layer_weight",
                            attrs={"__init__": mx.init.Constant(2.0).dumps()})
    np.testing.assert_array_equal(_filled(mx.init.Zero(), (2,), desc),
                                  [2.0, 2.0])

    @mx.init.register
    class Threes(mx.init.Initializer):
        def _init_weight(self, name, arr, generator):
            arr._data.fill_(3.0)

    np.testing.assert_array_equal(
        _filled(mx.init.create("threes"), (2,)), [3.0, 3.0])
    with pytest.raises(ValueError):
        _filled(mx.init.Mixed(["a.*"], [mx.init.One()]), (2,), "b_weight")
