"""Forward parity of the deeper vision models of the PyTorch port
against the JAX package's, at a small input (classes 10): squeezenet1_0
(64 x 64), mobilenet_v2_0_25 and densenet121 (32 x 32) and inception_v3
(75 x 75, its smallest input), as in test_torch_vision_zoo.py: the JAX
net hybridized and He-initialized, its weights carried by
``gluon.load_jax_params`` with an explicit ``prefix=``, the port eager
and hybridized, logits within 1e-5 of max(1, max |JAX|) and 1e-4 of
max |JAX|.  Kept apart because the JAX graphs of these nets take the
longest to compile.
"""

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.gluon.model_zoo import vision as jvision

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.gluon import load_jax_params
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision

TOL, TOL_REL = 1e-5, 1e-4
SMALL = [("squeezenet1_0", 64), ("mobilenet_v2_0_25", 32),
         ("densenet121", 32), ("inception_v3", 75)]
CLASSES = 10


_JAX = {}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs files in parallel processes: one intra-op thread a
    # process keeps them from oversubscribing the cores
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
