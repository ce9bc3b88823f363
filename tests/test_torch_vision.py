"""The port's ResNet slice as a whole, against the JAX package.

Small models (batch 2, 32 x 32 images, classes 10): ``resnet18_v1`` and
``resnet18_v2`` with the thumbnail stem, ``resnet50_v1`` with the conv7
ImageNet stem, each built in both packages with the same explicit
``prefix=``.  The JAX net's weights cross to the port by
``gluon.load_jax_params`` (running statistics included), and the port
must then give, eagerly and hybridized:

- the JAX package's logits (the JAX net hybridized);
- its running statistics after one training forward (resnet50_v1, all
  106 of them, at 128 x 128);
- its parameters after one SGD-momentum step (resnet18_v1);
- checkpoints with the same ``arg:``/``aux:`` keys, served by the port's
  ``ModelRegistry`` and by the JAX package's.

float32 throughout; values are held to 1e-5 of max(1, max |reference|)
of each array: the two differ in summation order only.  The running
statistics of resnet50_v1 are held to 2e-4: training-mode BatchNorm
amplifies f32 rounding from layer to layer, and against the same graph
evaluated in float64 the JAX package's statistics differ by up to 9e-5
and the port's by up to 2e-5 (at 128 x 128, where stage 4 normalizes 32
elements a channel; at 32 x 32 it normalizes 2, and f32 noise moves
them by 0.2 in both packages).
"""

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import serve as jserve
from mxnet_tpu.gluon.model_zoo import vision as jvision

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import gluon as tgluon
from mxnet_tpu_torch.gluon import load_jax_params
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision

TOL, TOL_STATS = 1e-5, 2e-4
BATCH, IMAGE, CLASSES = 2, 32, 10
STATS_IMAGE = 128
MODELS = {
    "resnet18_v1": dict(thumbnail=True),
    "resnet18_v2": dict(thumbnail=True),
    "resnet50_v1": {},
}
LR, MOMENTUM = 0.1, 0.9


def _kwargs(name):
    return dict(MODELS[name], classes=CLASSES, prefix="net_")


def _images(seed, rows=BATCH):
    return np.random.RandomState(seed).standard_normal(
        (rows, 3, IMAGE, IMAGE)).astype(np.float32)


LABELS = np.array([3.0, 7.0], np.float32)


def _close(got, want, what, tol=TOL):
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, scale)


def _port_net(name, jparams, hybridize):
    net = tvision.get_model(name, **_kwargs(name))
    net.initialize(ctx=tmx.cpu())
    load_jax_params(net, jparams)
    if hybridize:
        net.hybridize()
    return net


@pytest.fixture(scope="module")
def jax_models():
    """Each JAX model: its initial weights (numpy), and its hybridized
    logits on one batch in inference."""
    out = {}
    for name in MODELS:
        net = jvision.get_model(name, **_kwargs(name))
        net.initialize(ctx=jmx.cpu())
        net.hybridize()
        logits = net(jmx.nd.array(_images(0), ctx=jmx.cpu())).asnumpy()
        out[name] = dict(net=net, logits=logits, params={
            k: v.data().asnumpy() for k, v in net.collect_params().items()})
    return out


def test_resnet50_v1_parameters_and_names_match_jax(jax_models):
    jparams = jax_models["resnet50_v1"]["params"]
    net = _port_net("resnet50_v1", jparams, False)
    mine = net.collect_params()
    assert list(mine.keys()) == list(jparams.keys())
    trainable = [n for n, p in mine.items() if p.grad_req != "null"]
    stats = [n for n, p in mine.items() if p.grad_req == "null"]
    assert (len(trainable), len(stats)) == (161, 106)
    assert sum(int(np.prod(mine[n].shape)) for n in trainable) == \
        int(sum(jparams[n].size for n in trainable))
    for n, p in mine.items():
        np.testing.assert_array_equal(p.data().asnumpy(), jparams[n])


@pytest.mark.parametrize("hybridize", [False, True],
                         ids=["eager", "hybridized"])
@pytest.mark.parametrize("name", list(MODELS))
def test_forward_matches_jax(jax_models, name, hybridize):
    ref = jax_models[name]
    net = _port_net(name, ref["params"], hybridize)
    got = net(tmx.nd.array(_images(0), ctx=tmx.cpu())).asnumpy()
    assert got.shape == (BATCH, CLASSES)
    _close(got, ref["logits"], name)


@pytest.mark.parametrize("hybridize", [False, True],
                         ids=["eager", "hybridized"])
def test_running_stats_after_one_training_forward(jax_models, hybridize):
    """All 106 running statistics of resnet50_v1 after one forward in
    train mode (biased batch variance, momentum 0.9), every one moved."""
    ref = jax_models["resnet50_v1"]
    net = _port_net("resnet50_v1", ref["params"], hybridize)
    jnet = jvision.get_model("resnet50_v1", **_kwargs("resnet50_v1"))
    jnet.initialize(ctx=jmx.cpu())
    jnet.hybridize()
    for k, p in jnet.collect_params().items():
        p.set_data(jmx.nd.array(ref["params"][k], ctx=jmx.cpu()))
    x = np.random.RandomState(1).standard_normal(
        (BATCH, 3, STATS_IMAGE, STATS_IMAGE)).astype(np.float32)
    with jag.train_mode():
        jnet(jmx.nd.array(x, ctx=jmx.cpu())).asnumpy()
    with tag.train_mode():
        net(tmx.nd.array(x, ctx=tmx.cpu())).asnumpy()
    want = {k: v.data().asnumpy() for k, v in jnet.collect_params().items()
            if k.endswith(("running_mean", "running_var"))}
    assert len(want) == 106
    mine = net.collect_params()
    moved = 0
    for k, w in want.items():
        _close(mine[k].data().asnumpy(), w, k, TOL_STATS)
        moved += not np.array_equal(w, ref["params"][k])
    assert moved == 106


@pytest.fixture(scope="module")
def jax_step(jax_models):
    """resnet18_v1's parameters after one SGD-momentum step in the JAX
    package (hybridized), from the shared initial weights."""
    params = jax_models["resnet18_v1"]["params"]
    jnet = jvision.get_model("resnet18_v1", **_kwargs("resnet18_v1"))
    jnet.initialize(ctx=jmx.cpu())
    jnet.hybridize()
    for k, p in jnet.collect_params().items():
        p.set_data(jmx.nd.array(params[k], ctx=jmx.cpu()))
    trainer = jgluon.Trainer(jnet.collect_params(), "sgd",
                             {"learning_rate": LR, "momentum": MOMENTUM})
    loss_fn = jgluon.loss.SoftmaxCrossEntropyLoss()
    with jag.record():
        loss = loss_fn(jnet(jmx.nd.array(_images(2), ctx=jmx.cpu())),
                       jmx.nd.array(LABELS, ctx=jmx.cpu()))
    loss.backward()
    trainer.step(BATCH)
    return loss.asnumpy(), {k: v.data().asnumpy()
                            for k, v in jnet.collect_params().items()}


@pytest.mark.parametrize("hybridize", [False, True],
                         ids=["eager", "hybridized"])
def test_sgd_momentum_step_matches_jax(jax_models, jax_step, hybridize):
    """record -> SoftmaxCrossEntropyLoss -> backward -> Trainer.step: the
    loss and every parameter (running statistics too) after the step."""
    net = _port_net("resnet18_v1", jax_models["resnet18_v1"]["params"],
                    hybridize)
    trainer = tgluon.Trainer(net.collect_params(), "sgd",
                             {"learning_rate": LR, "momentum": MOMENTUM})
    loss_fn = tgluon.loss.SoftmaxCrossEntropyLoss()
    with tag.record():
        loss = loss_fn(net(tmx.nd.array(_images(2), ctx=tmx.cpu())),
                       tmx.nd.array(LABELS, ctx=tmx.cpu()))
    loss.backward()
    trainer.step(BATCH)
    want_loss, want = jax_step
    _close(loss.asnumpy(), want_loss, "loss")
    mine = net.collect_params()
    assert list(mine.keys()) == list(want.keys())
    for k, w in want.items():
        _close(mine[k].data().asnumpy(), w, k)


def test_space_to_depth_stem_matches_jax():
    """The s2d stem block (space_to_depth, 4x4 conv, leading slice),
    eager and hybridized, and the s2d model's parameter names."""
    jstem = jvision.SpaceToDepthStem(8, prefix="stem_")
    jstem.initialize(ctx=jmx.cpu())
    x = _images(3)
    want = jstem(jmx.nd.array(x, ctx=jmx.cpu())).asnumpy()
    params = {k: v.data().asnumpy() for k, v in
              jstem.collect_params().items()}
    for hybridize in (False, True):
        stem = tvision.SpaceToDepthStem(8, prefix="stem_")
        stem.initialize(ctx=tmx.cpu())
        load_jax_params(stem, params)
        if hybridize:
            stem.hybridize()
        got = stem(tmx.nd.array(x, ctx=tmx.cpu())).asnumpy()
        assert got.shape == (BATCH, 8, IMAGE // 2, IMAGE // 2)
        _close(got, want, "s2d stem")
    kw = dict(classes=CLASSES, stem="s2d", prefix="net_")
    jnames = list(jvision.get_model("resnet18_v1", **kw)
                  .collect_params().keys())
    net = tvision.get_model("resnet18_v1", **kw)
    assert list(net.collect_params().keys()) == jnames
    net.initialize(ctx=tmx.cpu())
    net.hybridize()
    assert net(tmx.nd.array(x, ctx=tmx.cpu())).shape == (BATCH, CLASSES)


def test_get_model_surface(tmp_path):
    assert tvision.get_model("ResNet50-v1", classes=3).output._units == 3
    with pytest.raises(ValueError, match="not found"):
        tvision.get_model("vgg9000")
    # pretrained weights load from the local model directory, as in the
    # JAX package; a missing file raises there as here
    with pytest.raises(FileNotFoundError, match="no network egress"):
        tvision.get_model("resnet18_v1", pretrained=True,
                          root=str(tmp_path))
    with pytest.raises(ValueError, match="pretrained"):
        tvision.get_resnet(1, 18, pretrained=True)


def test_export_keys_match_and_both_registries_serve_it(jax_models,
                                                        tmp_path):
    """The port's export of resnet18_v1 has the JAX export's checkpoint
    keys; the port's registry serves it at rungs (1, 2) in inference (a
    padded row changes no real row), and so does the JAX registry."""
    ref = jax_models["resnet18_v1"]
    jprefix = str(tmp_path / "jax")
    ref["net"].export(jprefix, 0)
    net = _port_net("resnet18_v1", ref["params"], True)
    net(tmx.nd.array(_images(0), ctx=tmx.cpu()))
    prefix = str(tmp_path / "port")
    net.export(prefix, 0)
    keys = set(tmx.nd.load(prefix + "-0000.params", ctx=tmx.cpu()))
    assert keys == set(jmx.nd.load(jprefix + "-0000.params"))
    assert sum(k.startswith("aux:") for k in keys) == sum(
        n.endswith(("running_mean", "running_var")) for n in ref["params"])

    x = _images(4)
    shapes = {"data0": (1, 3, IMAGE, IMAGE)}
    preg = tmx.serve.ModelRegistry()
    preg.load_checkpoint("r18", prefix, 0, data_shapes=shapes,
                         ladder=tmx.serve.BucketLadder(batches=(1, 2)),
                         ctx=tmx.cpu())
    both = preg.predict("r18", x)[0].asnumpy()
    one = preg.predict("r18", x[:1])[0].asnumpy()
    want = net(tmx.nd.array(x, ctx=tmx.cpu())).asnumpy()
    _close(both, want, "port registry, 2 rows")
    _close(one, want[:1], "port registry, 1 row")
    jreg = jserve.ModelRegistry()
    jreg.load_checkpoint("r18", prefix, 0, data_shapes=shapes,
                         ladder=jserve.BucketLadder(batches=(2,)),
                         ctx=jmx.cpu())
    _close(jreg.predict("r18", x)[0].asnumpy(), both, "JAX registry")


# (layer name, constructor kwargs, input shape)
LAYERS = [
    ("Conv1D", dict(channels=4, kernel_size=3, strides=2, padding=1,
                    activation="relu"), (2, 3, 9)),
    ("Conv2D", dict(channels=6, kernel_size=(3, 2), dilation=(2, 1),
                    groups=3, use_bias=False), (2, 3, 8, 7)),
    ("Conv3D", dict(channels=2, kernel_size=2, padding=1), (1, 2, 4, 5, 3)),
    ("MaxPool1D", dict(pool_size=3, strides=2, ceil_mode=True), (2, 3, 10)),
    ("MaxPool2D", dict(pool_size=3, strides=2, padding=1), (2, 3, 9, 8)),
    ("MaxPool3D", dict(), (1, 2, 4, 6, 4)),
    ("AvgPool1D", dict(pool_size=2, padding=1, count_include_pad=False),
     (2, 3, 7)),
    ("AvgPool2D", dict(pool_size=3, strides=2, padding=1, ceil_mode=True,
                       count_include_pad=False), (2, 3, 10, 9)),
    ("AvgPool3D", dict(pool_size=(2, 2, 1)), (1, 2, 4, 4, 3)),
    ("GlobalMaxPool1D", dict(), (2, 3, 5)),
    ("GlobalMaxPool2D", dict(), (2, 3, 5, 4)),
    ("GlobalMaxPool3D", dict(), (1, 2, 3, 4, 3)),
    ("GlobalAvgPool1D", dict(), (2, 3, 5)),
    ("GlobalAvgPool2D", dict(), (2, 3, 5, 4)),
    ("GlobalAvgPool3D", dict(), (1, 2, 3, 4, 3)),
    ("Flatten", dict(), (2, 3, 4)),
    ("BatchNorm", dict(axis=1, momentum=0.8, epsilon=1e-3, in_channels=3),
     (4, 3, 5)),
]


@pytest.mark.parametrize("hybridize", [False, True],
                         ids=["eager", "hybridized"])
@pytest.mark.parametrize("name,kwargs,shape", LAYERS,
                         ids=[entry[0] for entry in LAYERS])
def test_layer_matches_jax(name, kwargs, shape, hybridize):
    """Each conv, pooling, BatchNorm and Flatten layer in a (Hybrid)
    Sequential, the parameter names and the forward (BatchNorm in train
    mode, with its running statistics after) as the JAX package's."""
    from mxnet_tpu.gluon import nn as jnn
    from mxnet_tpu_torch.gluon import nn as tnn
    x = np.random.RandomState(5).standard_normal(shape).astype(np.float32)
    nets = []
    for pkg, nn in (("jax", jnn), ("port", tnn)):
        seq = (nn.HybridSequential if hybridize else nn.Sequential)(
            prefix="seq_")
        with seq.name_scope():
            seq.add(getattr(nn, name)(**kwargs))
        nets.append(seq)
    jnet, net = nets
    jnet.initialize(ctx=jmx.cpu())
    net.initialize(ctx=tmx.cpu())
    if hybridize:
        jnet.hybridize()
        net.hybridize()
    if name == "BatchNorm":     # its statistics before the forward
        jparams = {k: v.data().asnumpy() for k, v in
                   jnet.collect_params().items()}
    with jag.train_mode():
        want = jnet(jmx.nd.array(x, ctx=jmx.cpu())).asnumpy()
    if name != "BatchNorm":     # deferred shapes are known now
        jparams = {k: v.data().asnumpy() for k, v in
                   jnet.collect_params().items()}
    load_jax_params(net, jparams)
    with tag.train_mode():
        got = net(tmx.nd.array(x, ctx=tmx.cpu())).asnumpy()
    assert got.shape == want.shape
    _close(got, want, name)
    for k, v in jnet.collect_params().items():
        _close(net.collect_params()[k].data().asnumpy(), v.data().asnumpy(),
               k)
    assert len(net) == 1 and list(net)[0] is net[0]


def test_batch_norm_cast_keeps_statistics_in_float32():
    from mxnet_tpu_torch.gluon import nn as tnn
    seq = tnn.HybridSequential(prefix="m_")
    with seq.name_scope():
        seq.add(tnn.Conv2D(4, 3, padding=1), tnn.BatchNorm())
    seq.initialize(ctx=tmx.cpu())
    x = tmx.nd.array(np.ones((2, 3, 5, 5), np.float32), ctx=tmx.cpu(),
                     dtype="bfloat16")
    seq.cast("bfloat16")
    out = seq(x)
    dtypes = {k: p.data().dtype.name for k, p in
              seq.collect_params().items()}
    assert out.dtype.name == "bfloat16"
    assert dtypes["m_conv2d0_weight"] == "bfloat16"
    assert {v for k, v in dtypes.items() if "batchnorm" in k} == \
        {"float32"}


@pytest.mark.parametrize("init,std", [
    (tmx.init.Xavier(rnd_type="gaussian", factor_type="in", magnitude=2),
     np.sqrt(2.0 / 288)),
    (tmx.init.Xavier(), np.sqrt(3.0 / ((288 + 576) / 2)) / np.sqrt(3)),
    (tmx.init.MSRAPrelu(factor_type="out", slope=0.0),
     np.sqrt(2.0 / 576)),
    (tmx.init.Constant(0.25), 0.0),
])
def test_initializers(init, std):
    """Xavier (fans counting the kernel's 3 x 3), MSRAPrelu and Constant
    on a (64, 32, 3, 3) conv weight, from an explicit generator: the
    spread each promises, and the same draw from the same seed."""
    import torch
    arrs = []
    for _ in range(2):
        arr = tmx.nd.zeros((64, 32, 3, 3), ctx=tmx.cpu())
        gen = torch.Generator()
        gen.manual_seed(7)
        with tmx.init.using_generator(init, gen):
            init("conv0_weight", arr)
        arrs.append(arr.asnumpy())
    np.testing.assert_array_equal(arrs[0], arrs[1])
    if std:
        assert abs(arrs[0].std() / std - 1.0) < 0.05
    else:
        assert (arrs[0] == 0.25).all()
    assert type(tmx.init.create(type(init).__name__)) is type(init)
