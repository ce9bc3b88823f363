"""``examples/train_dcgan.py`` on the PyTorch port against the JAX
package: the example's own generator (a ``Conv2DTranspose`` stack, ngf
16, nz 16, 16 x 16 images) and discriminator, hybridized, and three
iterations of its two-Trainer gluon loop (adam lr 2e-4, beta1 0.5,
SigmoidBCE, ``fake.detach()`` for the discriminator step), from the same
weights (the JAX nets' N(0, 0.02) draws carried by
``gluon.load_jax_params``) on the same seeded batches.

Each iteration's D and G losses within 1e-5 of max(1, |loss|); after
the three iterations every weight and running statistic within 1e-5 of
max(1, max |JAX|), and the generator's images within 1e-5.  Two arrays
are left out: the bias of the discriminator's second convolution, which
feeds a BatchNorm, and that BatchNorm's running mean.  BatchNorm takes
each channel's mean out, so the bias's exact gradient is zero and both
packages hand adam f32 noise, which it scales to a step of +-lr either
way; the running mean averages batch means that carry the bias.  The
outputs do not depend on either.
"""

import contextlib
import os
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.gluon import load_jax_params

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples"))
from train_dcgan import (build_discriminator, build_generator,  # noqa
                         real_batch)

TOL = 1e-5
STEPS, BATCH, NZ = 3, 8, 16
# the convolution bias in front of a BatchNorm and that BatchNorm's
# running mean (see the docstring)
NOISE = ("disc_conv2d1_bias", "disc_batchnorm0_running_mean")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs files in parallel processes: one intra-op thread a
    # process keeps them from oversubscribing the cores
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _nets(mx):
    gen = build_generator(mx, nz=NZ)
    disc = build_discriminator(mx)
    return gen, disc


def _loop(mx, gen, disc, steps):
    """The example's loop (examples/train_dcgan.py:75-115) for *steps*
    iterations; returns the D and G losses and four generated images."""
    gluon, autograd, nd = mx.gluon, mx.autograd, mx.nd
    loss_fn = gluon.loss.SigmoidBinaryCrossEntropyLoss()
    t_gen = gluon.Trainer(gen.collect_params(), "adam",
                          {"learning_rate": 2e-4, "beta1": 0.5})
    t_disc = gluon.Trainer(disc.collect_params(), "adam",
                           {"learning_rate": 2e-4, "beta1": 0.5})
    rng = np.random.RandomState(0)
    ones = nd.array(np.ones((BATCH,), np.float32))
    zeros = nd.array(np.zeros((BATCH,), np.float32))
    losses = []
    for _ in range(steps):
        real = nd.array(real_batch(rng, BATCH))
        z = nd.array(rng.randn(BATCH, NZ, 1, 1).astype(np.float32))
        with autograd.record():
            out_r = disc(real).reshape((BATCH,))
            fake = gen(z)
            out_f = disc(fake.detach()).reshape((BATCH,))
            d_loss = loss_fn(out_r, ones) + loss_fn(out_f, zeros)
        d_loss.backward()
        t_disc.step(BATCH)
        with autograd.record():
            out_f = disc(gen(z)).reshape((BATCH,))
            g_loss = loss_fn(out_f, ones)
        g_loss.backward()
        t_gen.step(BATCH)
        losses.append((float(nd.mean(d_loss).asnumpy()),
                       float(nd.mean(g_loss).asnumpy())))
    img = gen(nd.array(rng.randn(4, NZ, 1, 1).astype(np.float32))).asnumpy()
    return losses, img


@pytest.fixture(scope="module")
def runs():
    jmx.random.seed(0)
    jgen, jdisc = _nets(jmx)
    for net in (jgen, jdisc):
        net.initialize(jmx.init.Normal(0.02))
        net.hybridize()
    # materialize the deferred shapes, then copy the weights over
    jdisc(jgen(jmx.nd.zeros((1, NZ, 1, 1))))
    start = [{k: v.data().asnumpy() for k, v in n.collect_params().items()}
             for n in (jgen, jdisc)]
    tgen, tdisc = _nets(tmx)
    for net, params in zip((tgen, tdisc), start):
        net.initialize(ctx=tmx.cpu())
        load_jax_params(net, params)
        net.hybridize()
    out = {}
    for name, mx, nets, scope in (
            ("jax", jmx, (jgen, jdisc), contextlib.nullcontext()),
            ("port", tmx, (tgen, tdisc), tmx.cpu())):
        with scope:
            losses, img = _loop(mx, *nets, STEPS)
        params = {}
        for n in nets:
            params.update({k: v.data().asnumpy()
                           for k, v in n.collect_params().items()})
        out[name] = (losses, img, params)
    return out


def test_generator_is_a_transposed_convolution_stack(runs):
    gen, _ = _nets(tmx)
    kinds = [type(b).__name__ for b in gen]
    assert kinds.count("Conv2DTranspose") == 3
    assert runs["port"][1].shape == (4, 1, 16, 16)
    assert np.isfinite(runs["port"][1]).all()


@pytest.mark.parametrize("step", range(STEPS))
def test_losses_match_jax(runs, step):
    (jd, jg), (td, tg) = runs["jax"][0][step], runs["port"][0][step]
    assert abs(td - jd) <= TOL * max(1.0, abs(jd)), (td, jd)
    assert abs(tg - jg) <= TOL * max(1.0, abs(jg)), (tg, jg)


def test_weights_and_images_match_jax(runs):
    jparams, tparams = runs["jax"][2], runs["port"][2]
    assert sorted(jparams) == sorted(tparams)
    assert set(NOISE) <= set(jparams)
    for k, want in jparams.items():
        if k in NOISE:
            continue
        err = float(np.abs(tparams[k] - want).max())
        assert err <= TOL * max(1.0, float(np.abs(want).max())), (k, err)
    want = runs["jax"][1]
    err = float(np.abs(runs["port"][1] - want).max())
    assert err <= TOL * max(1.0, float(np.abs(want).max())), err
