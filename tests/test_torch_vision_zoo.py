"""The vision model zoo of the PyTorch port against the JAX package's.

- The registries: the same factory names.
- Every model's parameter names, and at full width (1000 classes,
  224 x 224, Inception-v3 299 x 299) every parameter shape, by symbolic
  shape inference in both packages, with the parameter counts.
- Forward parity at a small input (classes 10; 32-64 pixels): alexnet,
  vgg11, vgg11_bn, squeezenet1_1 and mobilenet0_25 (squeezenet1_0,
  mobilenet_v2_0_25, densenet121 and inception_v3 in
  test_torch_vision_zoo_deep.py), the JAX net
  hybridized, its weights carried by ``gluon.load_jax_params`` with an
  explicit ``prefix=``, the port eager and hybridized, logits within
  1e-5 of max(1, max |JAX|) and within 1e-4 of max |JAX| (the nets are
  He-initialized so that the logits are not vanishingly small).
- ``get_model(name, pretrained=True, root=d)`` loads ``d/<name>.params``
  in both packages, and a missing file raises the same
  FileNotFoundError; ``get_resnet(pretrained=True)`` raises in both; the
  store's probe retries transient read errors.
"""

import os

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.gluon.model_zoo import vision as jvision

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.gluon import load_jax_params
from mxnet_tpu_torch.gluon.model_zoo import model_store
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision

TOL, TOL_REL = 1e-5, 1e-4
MODELS = sorted(n for n in jvision._factories if not n.startswith("get_"))
# one model of each family at full width: (name, image side)
FULL = [("alexnet", 224), ("vgg16", 224), ("squeezenet1_1", 224),
        ("mobilenet1_0", 224), ("mobilenet_v2_1_0", 224),
        ("densenet121", 224), ("inception_v3", 299), ("resnet50_v1", 224)]
# forward parity: (name, image side); the deeper nets, whose JAX graphs
# take longest to compile, are in test_torch_vision_zoo_deep.py
SMALL = [("alexnet", 64), ("vgg11", 32), ("vgg11_bn", 32),
         ("squeezenet1_1", 64), ("mobilenet0_25", 32)]
CLASSES = 10


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs files in parallel processes: one intra-op thread a
    # process keeps them from oversubscribing the cores
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_factory_names_equal():
    assert sorted(tvision._factories) == sorted(jvision._factories)
    assert len(MODELS) == 34


@pytest.mark.parametrize("name", MODELS)
def test_parameter_names_equal(name):
    t = tvision.get_model(name, prefix="m_")
    j = jvision.get_model(name, prefix="m_")
    tp, jp = t.collect_params(), j.collect_params()
    assert list(tp.keys()) == list(jp.keys())
    assert [p.shape for p in tp.values()] == [p.shape for p in jp.values()]


def _arg_shapes(mx, vision, name, side):
    net = vision.get_model(name, prefix="m_")
    out = net(mx.sym.var("data"))
    arg, _, aux = out.infer_shape(data=(1, 3, side, side))
    shapes = dict(zip(out.list_arguments(), arg))
    shapes.update(zip(out.list_auxiliary_states(), aux))
    shapes.pop("data")
    return shapes


@pytest.mark.parametrize("name,side", FULL, ids=[n for n, _ in FULL])
def test_full_width_shapes_equal(name, side):
    t = _arg_shapes(tmx, tvision, name, side)
    j = _arg_shapes(jmx, jvision, name, side)
    assert t == j
    count = sum(int(np.prod(s)) for s in t.values())
    assert count == sum(int(np.prod(s)) for s in j.values())
    assert count > 1e6


_JAX = {}


def _jax_logits(name, side):
    """The JAX net (hybridized, He-initialized, seed 0), its weights and
    its logits on a seeded batch of 2; computed once a model."""
    if name not in _JAX:
        jmx.random.seed(0)
        net = jvision.get_model(name, classes=CLASSES, prefix="net_")
        net.initialize(jmx.init.Xavier(rnd_type="gaussian",
                                       factor_type="in", magnitude=2))
        net.hybridize()
        x = np.random.RandomState(1).standard_normal(
            (2, 3, side, side)).astype(np.float32)
        want = net(jmx.nd.array(x)).asnumpy()
        params = {k: v.data().asnumpy()
                  for k, v in net.collect_params().items()}
        _JAX[name] = (x, params, want)
    return _JAX[name]


@pytest.mark.parametrize("hybridize", [False, True])
@pytest.mark.parametrize("name,side", SMALL, ids=[n for n, _ in SMALL])
def test_forward_matches_jax(name, side, hybridize):
    x, params, want = _jax_logits(name, side)
    net = tvision.get_model(name, classes=CLASSES, prefix="net_")
    net.initialize(ctx=tmx.cpu())
    load_jax_params(net, params)
    if hybridize:
        net.hybridize()
    got = net(tmx.nd.array(x, ctx=tmx.cpu())).asnumpy()
    assert got.shape == (2, CLASSES)
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    assert scale > 1e-3, scale
    assert err <= TOL * max(1.0, scale) and err <= TOL_REL * scale, \
        (err, scale)


def test_pretrained_loads_the_local_file_in_both_packages(tmp_path):
    """The repair: the port's get_model(pretrained=True, root=) loads
    ``<root>/<name>.params`` as the JAX package's does (it raised).  A
    file saved by the JAX package gives the port the weights
    ``load_jax_params`` gives it, and so the same logits."""
    root = str(tmp_path)
    jnet = jvision.get_model("alexnet", classes=CLASSES)
    jnet.initialize(jmx.init.Xavier())
    jnet(jmx.nd.zeros((1, 3, 64, 64)))
    jnet.save_parameters(os.path.join(root, "alexnet.params"))
    jparams = {k: v.data().asnumpy() for k, v in
               jnet._collect_params_with_prefix().items()}
    jnet2 = jvision.get_model("alexnet", classes=CLASSES, pretrained=True,
                              root=root)
    for k, v in jnet2._collect_params_with_prefix().items():
        np.testing.assert_array_equal(v.data().asnumpy(), jparams[k])
    with tmx.cpu():
        tnet = tvision.get_model("alexnet", classes=CLASSES,
                                 pretrained=True, root=root)
    ref = tvision.get_model("alexnet", classes=CLASSES,
                            prefix=jnet.prefix)
    ref.initialize(ctx=tmx.cpu())
    load_jax_params(ref, {k: v.data().asnumpy()
                          for k, v in jnet.collect_params().items()})
    x = tmx.nd.array(np.random.RandomState(2).standard_normal(
        (1, 3, 64, 64)).astype(np.float32), ctx=tmx.cpu())
    np.testing.assert_array_equal(tnet(x).asnumpy(), ref(x).asnumpy())
    # a file the port saved loads back the same way
    root2 = tmp_path / "port"
    root2.mkdir()
    tnet.save_parameters(str(root2 / "alexnet.params"))
    with tmx.cpu():
        again = tvision.get_model("alexnet", classes=CLASSES,
                                  pretrained=True, root=str(root2))
    np.testing.assert_array_equal(again(x).asnumpy(), ref(x).asnumpy())


def test_pretrained_missing_and_get_resnet_raise_in_both(tmp_path):
    for vision in (jvision, tvision):
        with pytest.raises(FileNotFoundError, match="no network egress"):
            vision.get_model("alexnet", pretrained=True, root=str(tmp_path))
        with pytest.raises(ValueError, match="pretrained"):
            vision.get_resnet(1, 18, pretrained=True)
        with pytest.raises(ValueError, match="not found"):
            vision.get_model("resnet9000")


def test_model_store_retries_transient_reads(tmp_path, monkeypatch):
    root = str(tmp_path)
    with open(os.path.join(root, "net.params"), "wb") as f:
        f.write(b"weights")
    real_probe = model_store._probe
    state = {"fails": 2}

    def flaky_probe(path):
        if state["fails"] > 0:
            state["fails"] -= 1
            raise OSError("nfs flake")
        return real_probe(path)

    sleeps = []
    monkeypatch.setattr(model_store, "_probe", flaky_probe)
    monkeypatch.setattr(model_store, "_sleep", sleeps.append)
    assert model_store.get_model_file("net", root=root).endswith(
        "net.params")
    assert len(sleeps) == 2
    sleeps.clear()
    with pytest.raises(FileNotFoundError, match="no network egress"):
        model_store.get_model_file("absent", root=root)
    assert sleeps == []


def test_model_store_default_dir_and_purge(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_HOME", str(tmp_path))
    mdir = tmp_path / "models"
    mdir.mkdir()
    (mdir / "a.params").write_bytes(b"x")
    (mdir / "keep.txt").write_bytes(b"x")
    assert model_store.get_model_file("a") == str(mdir / "a.params")
    model_store.purge()
    assert sorted(os.listdir(mdir)) == ["keep.txt"]
