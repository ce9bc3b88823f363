"""The port's slice as a whole: train the transformer LM.

One tiny LM (vocab 50, dim 32, 4 heads, 2 layers, seq 24, batch 2) is
built in both packages with the same prefix; the port takes the JAX
weights through ``gluon.load_jax_params``.  Both take three steps of the
gluon loop (``autograd.record`` -> SoftmaxCrossEntropyLoss ->
``backward`` -> ``Trainer.step``, SGD lr 0.01, momentum 0.9), hybridized
and eager.  The loss at every step and every parameter after step 3
agree at f32 rtol 1e-4 / atol 1e-5: the same arithmetic, summed in
another order (attention's gradient is blockwise in the port and a
``jax.vjp`` of the chunked forward in the JAX package), which moves the
last few bits of a step and is carried into the next.

Optimizer state crosses too: one package takes two steps and saves its
parameters and ``save_states``; the other loads both and takes step 3,
which matches the first package's own step 3.
"""

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.gluon.model_zoo.transformer import \
    get_transformer_lm as jax_lm

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import gluon as tgluon
from mxnet_tpu_torch.gluon.model_zoo.transformer import \
    get_transformer_lm as port_lm
from mxnet_tpu_torch.ops import attention as tatt

CFG = dict(vocab=50, dim=32, heads=4, layers=2, max_seq=24,
           prefix="trainlm0_")
BATCH, SEQ, STEPS = 2, 24, 3
OPT = {"learning_rate": 0.01, "momentum": 0.9}
TOL = dict(rtol=1e-4, atol=1e-5)

PKG = {"jax": (jmx, jag, jgluon, jax_lm), "port": (tmx, tag, tgluon, port_lm)}


def _batch():
    rng = np.random.RandomState(0)
    x = rng.randint(0, CFG["vocab"], (BATCH, SEQ)).astype(np.float32)
    y = rng.randint(0, CFG["vocab"], (BATCH, SEQ)).astype(np.float32)
    return x, y


class _Loop:
    """One package's LM, loss and trainer, driven as a user would."""

    def __init__(self, pkg, params, hybridize):
        mx, self.ag, gluon, lm = PKG[pkg]
        self.mx, self.ctx = mx, mx.cpu()
        self.net = lm(**CFG)
        self.net.initialize(ctx=self.ctx)
        if params is not None:
            if pkg == "port":
                tgluon.load_jax_params(self.net, params)
            else:
                for k, p in self.net.collect_params().items():
                    p.set_data(jmx.nd.array(params[k], ctx=self.ctx))
        if hybridize:
            self.net.hybridize()
        self.loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
        self.trainer = gluon.Trainer(self.net.collect_params(), "sgd",
                                     dict(OPT))

    def step(self, x, y):
        mx = self.mx
        with self.ag.record():
            loss = self.loss_fn(self.net(mx.nd.array(x, ctx=self.ctx)),
                                mx.nd.array(y, ctx=self.ctx))
        loss.backward()
        self.trainer.step(BATCH)
        return loss.asnumpy()

    def params(self):
        return {k: p.data().asnumpy()
                for k, p in self.net.collect_params().items()}


@pytest.fixture(scope="module")
def init_params():
    net = jax_lm(**CFG)
    net.initialize(ctx=jmx.cpu())
    net(jmx.nd.array(_batch()[0], ctx=jmx.cpu()))
    return {k: p.data().asnumpy() for k, p in net.collect_params().items()}


@pytest.mark.parametrize("hybridize", [True, False],
                         ids=["hybridized", "eager"])
def test_three_sgd_steps_match_jax(init_params, hybridize):
    x, y = _batch()
    jax_loop = _Loop("jax", init_params, hybridize)
    port = _Loop("port", init_params, hybridize)
    counts = (tatt.flash_fwd.launches, tatt.flash_bwd_dkdv.launches,
              tatt.flash_bwd_dq.launches)
    losses = []
    for _ in range(STEPS):
        jl, tl = jax_loop.step(x, y), port.step(x, y)
        assert tl.shape == (BATCH,)
        np.testing.assert_allclose(tl, jl, **TOL)
        losses.append(tl.mean())
    assert losses[-1] < losses[0]
    want = jax_loop.params()
    got = port.params()
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)
        assert not np.array_equal(got[k], init_params[k]) or \
            k.endswith("_beta"), k
    # the CPU run launched no kernel
    assert (tatt.flash_fwd.launches, tatt.flash_bwd_dkdv.launches,
            tatt.flash_bwd_dq.launches) == counts


@pytest.mark.parametrize("first", ["jax", "port"])
def test_optimizer_state_carries_across(init_params, tmp_path, first):
    x, y = _batch()
    second = "port" if first == "jax" else "jax"
    a = _Loop(first, init_params, hybridize=True)
    for _ in range(2):
        a.step(x, y)
    states = str(tmp_path / "sgd.states")
    a.trainer.save_states(states)
    after_two = a.params()
    b = _Loop(second, after_two, hybridize=True)
    b.trainer.load_states(states)
    want_loss = a.step(x, y)
    got_loss = b.step(x, y)
    np.testing.assert_allclose(got_loss, want_loss, **TOL)
    want, got = a.params(), b.params()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)
    # without the momentum, step 3 lands elsewhere
    c = _Loop(second, after_two, hybridize=True)
    c.step(x, y)
    fresh = c.params()
    assert any(not np.allclose(fresh[k], want[k], **TOL) for k in want)


def test_trainer_surface():
    net = port_lm(**dict(CFG, prefix="surflm0_"))
    net.initialize(ctx=tmx.cpu())
    tr = tgluon.Trainer(net.collect_params(), "sgd", dict(OPT))
    assert tr.learning_rate == 0.01
    tr.set_learning_rate(0.02)
    assert tr.optimizer.learning_rate == 0.02
    tr.allreduce_grads()
    params = net.collect_params()
    for kwargs in (dict(kvstore="dist_sync"), dict(kvstore="nccl"),
                   dict(compression_params={"type": "2bit"}),
                   dict(update_on_kvstore=True)):
        with pytest.raises(tmx.MXNetError, match="not ported"):
            tgluon.Trainer(params, "sgd", **kwargs)
    for kvstore in ("device", "local", None):
        tgluon.Trainer(params, "sgd", kvstore=kvstore,
                       update_on_kvstore=False)
