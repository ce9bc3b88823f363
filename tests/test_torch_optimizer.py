"""The port's SGD against the JAX package's.

The update ops (``sgd_update``, ``sgd_mom_update``) with rescale, clip
and weight decay, and the ``SGD`` optimizer with per-parameter lr/wd
multipliers over three updates, on the same numpy weights and
gradients: f32 rtol 1e-6 / atol 1e-7 (the same formula, term by term,
in f32).  The port's ops write in place; the JAX package's return new
arrays.  ``Updater`` states cross between the packages in format 2.
"""

import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import optimizer as jopt
from mxnet_tpu.ops import registry as jreg

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.ops import registry as treg

TOL = dict(rtol=1e-6, atol=1e-7)

KNOBS = [dict(lr=0.1),
         dict(lr=0.05, wd=0.01, rescale_grad=0.125),
         dict(lr=0.2, rescale_grad=2.0, clip_gradient=0.5),
         dict(lr=0.2, wd=0.1, rescale_grad=0.5, clip_gradient=0.3)]


def _arrays(n, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal((4, 6)).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("knobs", KNOBS, ids=["plain", "wd", "clip",
                                              "all"])
def test_sgd_update_matches_jax_in_place(knobs):
    w, g = _arrays(2)
    want = jreg.get_op("sgd_update").fn(jnp.asarray(w), jnp.asarray(g),
                                        **knobs)
    tw = torch.from_numpy(w.copy())
    got = treg.get_op("sgd_update").fn(tw, torch.from_numpy(g), **knobs)
    assert got is tw
    np.testing.assert_allclose(tw.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("knobs", KNOBS, ids=["plain", "wd", "clip",
                                              "all"])
def test_sgd_mom_update_matches_jax_in_place(knobs):
    w, g, m = _arrays(3, seed=1)
    jw, jm = jreg.get_op("sgd_mom_update").fn(
        jnp.asarray(w), jnp.asarray(g), jnp.asarray(m), momentum=0.9,
        **knobs)
    tw, tm = torch.from_numpy(w.copy()), torch.from_numpy(m.copy())
    gw, gm = treg.get_op("sgd_mom_update").fn(tw, torch.from_numpy(g), tm,
                                              momentum=0.9, **knobs)
    assert gw is tw and gm is tm
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **TOL)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), **TOL)


def test_update_of_a_tape_leaf_runs_without_grad():
    w = tmx.nd.array(np.ones(3, np.float32), ctx=tmx.cpu())
    w.attach_grad()
    g = tmx.nd.array(np.full(3, 2.0, np.float32), ctx=tmx.cpu())
    tmx.nd.sgd_update(w, g, lr=0.5)
    np.testing.assert_allclose(w.asnumpy(), [0.0, 0.0, 0.0])
    assert w._data.requires_grad and w._data.grad_fn is None


def _sgd_run(mx, opt_mod, momentum, steps=3):
    """Three updates of two parameters (a weight with lr_mult 2, a bias
    that set_wd_mult exempts from decay) through one Updater."""
    names = {0: "fc_weight", 1: "fc_bias"}
    opt = opt_mod.create("sgd", learning_rate=0.1, momentum=momentum,
                         wd=0.01, rescale_grad=0.5, clip_gradient=1.5,
                         param_idx2name=names)
    opt.set_lr_mult({"fc_weight": 2.0})
    opt.set_wd_mult({})
    upd = opt_mod.get_updater(opt)
    w = _arrays(2, seed=3)
    ws = [mx.nd.array(a, ctx=mx.cpu()) for a in w]
    for step in range(steps):
        grads = _arrays(2, seed=10 + step)
        for i in (0, 1):
            upd(i, mx.nd.array(grads[i], ctx=mx.cpu()), ws[i])
    return [x.asnumpy() for x in ws], upd


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_optimizer_matches_jax_over_three_updates(momentum):
    jw, jupd = _sgd_run(jmx, jopt, momentum)
    tw, tupd = _sgd_run(tmx, topt, momentum)
    for a, b in zip(tw, jw):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    assert tupd.optimizer.num_update == jupd.optimizer.num_update == 3
    if momentum:
        for i in (0, 1):
            np.testing.assert_allclose(tupd.states[i].asnumpy(),
                                       jupd.states[i].asnumpy(),
                                       rtol=1e-6, atol=1e-6)
    else:
        assert tupd.states == {0: None, 1: None}


def test_updater_states_cross_both_ways():
    _, jupd = _sgd_run(jmx, jopt, 0.9)
    _, tupd = _sgd_run(tmx, topt, 0.9)
    jblob, tblob = pickle.loads(jupd.get_states()), \
        pickle.loads(tupd.get_states())
    assert tblob["__format__"] == jblob["__format__"] == 2
    assert tblob["opt_class"] == jblob["opt_class"] == "SGD"
    assert tblob["hyper_sig"] == jblob["hyper_sig"]
    # the port reads the JAX blob, the JAX package reads the port's
    into_port = topt.get_updater(topt.create("sgd", momentum=0.9))
    into_port.set_states(jupd.get_states())
    into_jax = jopt.get_updater(jopt.create("sgd", momentum=0.9))
    into_jax.set_states(tupd.get_states())
    for i in (0, 1):
        np.testing.assert_allclose(into_port.states[i].asnumpy(),
                                   jupd.states[i].asnumpy(), **TOL)
        np.testing.assert_allclose(np.asarray(into_jax.states[i].asnumpy()),
                                   tupd.states[i].asnumpy(), **TOL)
    assert into_port.states_synced == {0: False, 1: False}


def test_updater_refuses_a_blob_that_holds_an_optimizer():
    # the JAX package can pickle its optimizer object into the blob; the
    # port reads numpy payloads only and never imports that package
    _, jupd = _sgd_run(jmx, jopt, 0.9)
    into_port = topt.get_updater(topt.create("sgd", momentum=0.9))
    with pytest.raises(tmx.MXNetError, match="dump_optimizer=False"):
        into_port.set_states(jupd.get_states(dump_optimizer=True))
    assert into_port.states == {}


def test_create_refuses_what_is_not_ported():
    with pytest.raises(tmx.MXNetError, match="not ported"):
        topt.create("adam")
    with pytest.raises(tmx.MXNetError, match="multi_precision"):
        topt.create("sgd", multi_precision=True)
    sgd = topt.SGD(learning_rate=0.3)
    assert topt.create(sgd) is sgd
    sgd.set_learning_rate(0.7)
    assert sgd.learning_rate == 0.7
