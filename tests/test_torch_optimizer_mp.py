"""The port's update ops, optimizers, multi-precision and learning-rate
schedulers against the JAX package's.

Every update op of ``mxnet_tpu/ops/optimizer_ops.py`` runs on the same
numpy weight, gradient and states in both packages (the port's writes in
place); all 16 optimizers take three updates of two parameters through an
``Updater``; ``LBSGD`` runs each warmup strategy and LARS.  Float32
results agree to rtol 1e-5 / atol 1e-6: the same formula, term by term,
in float32 (a few ops divide by a square root, which may round its last
bit apart).

Multi-precision: a bfloat16 weight keeps a float32 master.  The masters
agree at the float32 limit above (the update reads the bf16 gradient,
exact in both, and runs in float32), and each bf16 weight is its master
rounded to bf16 in both packages.  States, multi-precision tuples
included, cross between the packages in the format-2 blob.
"""

import pickle

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import lr_scheduler as jlrs
from mxnet_tpu import optimizer as jopt
from mxnet_tpu.ops import registry as jreg

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import lr_scheduler as tlrs
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.ops import registry as treg

TOL = dict(rtol=1e-5, atol=1e-6)
BF16 = ml_dtypes.bfloat16

# op name -> (number of states, its hyper-parameters beyond the knobs,
# states that must be positive)
OPS = {
    "sgd_update": (0, dict(lr=0.1, wd=0.01), False),
    "sgd_mom_update": (1, dict(lr=0.1, momentum=0.9, wd=0.01), False),
    "nag_mom_update": (1, dict(lr=0.1, momentum=0.9, wd=0.01), False),
    "mp_sgd_update": (1, dict(lr=0.1, wd=0.01), False),
    "mp_sgd_mom_update": (2, dict(lr=0.1, momentum=0.9, wd=0.01), False),
    "adam_update": (2, dict(lr=0.01, beta1=0.8, beta2=0.99, wd=0.01), True),
    "rmsprop_update": (1, dict(lr=0.01, gamma1=0.9, wd=0.01,
                               clip_weights=0.8), True),
    "rmspropalex_update": (3, dict(lr=0.01, gamma1=0.9, gamma2=0.8,
                                   wd=0.01, clip_weights=0.8), True),
    "ftrl_update": (2, dict(lr=0.1, lamda1=0.05, beta=1.5, wd=0.01), True),
    "ftml_update": (3, dict(lr=0.01, beta1=0.6, beta2=0.99, t=3, wd=0.01),
                    True),
    "signsgd_update": (0, dict(lr=0.1, wd=0.01), False),
    "signum_update": (1, dict(lr=0.1, momentum=0.9, wd=0.01, wd_lh=0.02),
                      False),
    "_sparse_adagrad_update": (1, dict(lr=0.1, epsilon=1e-6, wd=0.01), True),
    "adadelta_update": (2, dict(rho=0.8, epsilon=1e-5, wd=0.01), True),
    "adamax_update": (2, dict(lr=0.01, beta1=0.8, beta2=0.9, t=2, wd=0.01),
                      True),
    "nadam_update": (2, dict(lr=0.01, beta1=0.8, beta2=0.9, t=2,
                             schedule_decay=0.01, wd=0.01), True),
}

KNOBS = {"plain": {}, "knobs": dict(rescale_grad=0.5, clip_gradient=0.7)}


def _arrays(n, seed=0, shape=(4, 6)):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _op_inputs(name, seed):
    n_states, hyper, positive = OPS[name]
    w, g, *states = _arrays(2 + n_states, seed)
    if positive:
        states = [np.abs(s) + 0.1 for s in states]
    if name.startswith("mp_"):
        # a bf16 weight, its float32 master last
        states[-1] = w
        w = w.astype(BF16)
        g = g.astype(BF16)
    return w, g, states, hyper


@pytest.mark.parametrize("knobs", sorted(KNOBS))
@pytest.mark.parametrize("name", sorted(OPS))
def test_update_op_matches_jax_in_place(name, knobs):
    w, g, states, hyper = _op_inputs(name, seed=sorted(OPS).index(name))
    kw = dict(hyper, **KNOBS[knobs])
    if name == "ftml_update" and "clip_gradient" in kw:
        kw["clip_grad"] = kw.pop("clip_gradient")
    want = jreg.get_op(name).fn(jnp.asarray(w), jnp.asarray(g),
                                *[jnp.asarray(s) for s in states], **kw)
    if not isinstance(want, tuple):
        want = (want,)
    tensors = [torch.from_numpy(np.asarray(a).copy()) if a.dtype != BF16
               else torch.from_numpy(a.view(np.int16).copy()).view(
                   torch.bfloat16) for a in [w] + states]
    tg = torch.from_numpy(g.view(np.int16).copy()).view(torch.bfloat16) \
        if g.dtype == BF16 else torch.from_numpy(g)
    got = treg.get_op(name).fn(tensors[0], tg, *tensors[1:], **kw)
    if not isinstance(got, tuple):
        got = (got,)
    assert len(got) == len(want) == len(tensors)
    for t, o, j in zip(tensors, got, want):
        assert o is t                      # written in place
        np.testing.assert_allclose(t.float().numpy(),
                                   np.asarray(j, np.float32), **TOL)
    if name.startswith("mp_"):
        # the bf16 weight is its master rounded, bit for bit
        assert torch.equal(tensors[0], tensors[-1].to(torch.bfloat16))


def test_adagrad_update_is_an_alias():
    assert treg.get_op("adagrad_update") is \
        treg.get_op("_sparse_adagrad_update")


def test_update_ops_take_a_device_lr():
    """ParallelTrainer's LARS rates stay on the device: lr may be a 0-dim
    tensor, with the result of the same lr as a float."""
    w, g, m = _arrays(3, seed=5)
    a = [torch.from_numpy(x.copy()) for x in (w, m)]
    b = [torch.from_numpy(x.copy()) for x in (w, m)]
    op = treg.get_op("sgd_mom_update").fn
    op(a[0], torch.from_numpy(g), a[1], lr=torch.tensor(0.25),
       momentum=0.9)
    op(b[0], torch.from_numpy(g), b[1], lr=0.25, momentum=0.9)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


# optimizer name -> constructor arguments
OPTIMIZERS = {
    "sgd": dict(learning_rate=0.1, momentum=0.9),
    "signum": dict(learning_rate=0.01, momentum=0.9, wd_lh=0.01),
    "signsgd": dict(learning_rate=0.01),
    "ftml": dict(learning_rate=0.01, beta1=0.6, beta2=0.99),
    "lbsgd": dict(learning_rate=0.1, momentum=0.9),
    "dcasgd": dict(learning_rate=0.1, momentum=0.9, lamda=0.1),
    "nag": dict(learning_rate=0.1, momentum=0.9),
    "sgld": dict(learning_rate=0.1),
    "adam": dict(learning_rate=0.01),
    "adagrad": dict(learning_rate=0.1, eps=1e-6),
    "rmsprop": dict(learning_rate=0.01, clip_weights=2.0),
    "rmsprop_centered": dict(learning_rate=0.01, centered=True),
    "adadelta": dict(rho=0.9),
    "ftrl": dict(learning_rate=0.1, lamda1=0.01),
    "adamax": dict(learning_rate=0.01),
    "nadam": dict(learning_rate=0.01),
    "test": dict(learning_rate=0.1),
}


def _run(mx, opt_mod, name, kw, dtype="float32", steps=3,
         multi_precision=False):
    """Three updates of two parameters through one Updater (a weight with
    lr_mult 2, a bias without decay), rescale and clip on."""
    names = {0: "fc_weight", 1: "fc_bias"}
    opt = opt_mod.create(name.split("_")[0], param_idx2name=names, wd=0.01,
                         rescale_grad=0.5, clip_gradient=1.5,
                         multi_precision=multi_precision, **kw)
    opt.set_lr_mult({"fc_weight": 2.0})
    opt.set_wd_mult({})
    upd = opt_mod.get_updater(opt)
    ws = [mx.nd.array(a, ctx=mx.cpu(), dtype=dtype)
          for a in _arrays(2, seed=3)]
    for step in range(steps):
        grads = _arrays(2, seed=10 + step)
        for i in (0, 1):
            upd(i, mx.nd.array(grads[i], ctx=mx.cpu(), dtype=dtype), ws[i])
    return ws, upd


def _np(a):
    return np.asarray(a.asnumpy(), dtype=np.float32)


def _states(s):
    """The NDArrays of a state (None, one, or a tuple), flattened."""
    if s is None:
        return []
    if isinstance(s, tuple):
        return [x for part in s for x in _states(part)]
    return [s]


SGLD_SEED = 7


@pytest.fixture
def shared_noise(monkeypatch):
    """SGLD's JAX draws replaced by the port's: a torch generator seeded
    as the port's draws the same N(0, 1) values, scaled as the JAX
    package scales them, so the parity compares everything but the
    draw."""
    import mxnet_tpu.ndarray.random as jrandom
    gen = torch.Generator()
    gen.manual_seed(SGLD_SEED)

    def normal(loc=0.0, scale=1.0, shape=(), dtype="float32", **kw):
        z = torch.randn(shape, generator=gen) * scale + loc
        return jmx.nd.array(z.numpy(), dtype=dtype)
    monkeypatch.setattr(jrandom, "normal", normal)


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_jax_over_three_updates(name, shared_noise):
    kw = OPTIMIZERS[name]
    jw, jupd = _run(jmx, jopt, name, kw)
    if name == "sgld":
        gen = torch.Generator()
        gen.manual_seed(SGLD_SEED)
        kw = dict(kw, generator=gen)
    tw, tupd = _run(tmx, topt, name, kw)
    for a, b in zip(tw, jw):
        np.testing.assert_allclose(_np(a), _np(b), **TOL)
    assert tupd.optimizer.num_update == jupd.optimizer.num_update
    assert type(tupd.optimizer).__name__ == type(jupd.optimizer).__name__
    for i in (0, 1):
        ts, js = _states(tupd.states[i]), _states(jupd.states[i])
        assert len(ts) == len(js)
        for a, b in zip(ts, js):
            np.testing.assert_allclose(_np(a), _np(b), **TOL)


def test_every_reference_optimizer_is_registered():
    assert sorted(topt.optimizer._REGISTRY) == sorted(
        k for k in jopt.optimizer._reg.keys())
    assert len(topt.optimizer._REGISTRY) == 16


@pytest.mark.parametrize("strategy", ["linear", "power2", "sqrt", "lars"])
@pytest.mark.parametrize("multi_precision", [False, True])
def test_lbsgd_warmups_match_jax(strategy, multi_precision):
    kw = dict(learning_rate=0.1, momentum=0.9, warmup_strategy=strategy,
              warmup_epochs=2, batch_scale=4, updates_per_epoch=2)
    dtype = "bfloat16" if multi_precision else "float32"
    jw, jupd = _run(jmx, jopt, "lbsgd", kw, dtype=dtype, steps=5,
                    multi_precision=multi_precision)
    tw, tupd = _run(tmx, topt, "lbsgd", kw, dtype=dtype, steps=5,
                    multi_precision=multi_precision)
    for i in (0, 1):
        ts, js = _states(tupd.states[i]), _states(jupd.states[i])
        assert [str(s.dtype) for s in ts] == [str(s.dtype) for s in js]
        for a, b in zip(ts, js):
            np.testing.assert_allclose(_np(a), _np(b), **TOL)
        if not multi_precision:
            np.testing.assert_allclose(_np(tw[i]), _np(jw[i]), **TOL)
    if multi_precision:
        # the bf16 weight is its float32 master rounded
        assert tw[0].asnumpy().dtype == BF16
        np.testing.assert_array_equal(
            tw[0].asnumpy(), _np(tupd.states[0][1]).astype(BF16))


@pytest.mark.parametrize("name", ["sgd", "sgd_nomom", "adam", "nag"])
def test_multi_precision_matches_jax(name):
    """bf16 weights: SGD runs the mp_sgd ops, every other optimizer the
    float32-master fallback; masters at the float32 limit, the bf16
    weights equal."""
    kw = dict(OPTIMIZERS.get(name, {"learning_rate": 0.1}))
    opt_name = "sgd" if name == "sgd_nomom" else name
    jw, jupd = _run(jmx, jopt, opt_name, kw, dtype="bfloat16",
                    multi_precision=True)
    tw, tupd = _run(tmx, topt, opt_name, kw, dtype="bfloat16",
                    multi_precision=True)
    for i in (0, 1):
        inner_t, w32_t = tupd.states[i]
        inner_j, w32_j = jupd.states[i]
        assert w32_t.dtype == np.float32
        np.testing.assert_allclose(_np(w32_t), _np(w32_j), **TOL)
        for a, b in zip(_states(inner_t), _states(inner_j)):
            np.testing.assert_allclose(_np(a), _np(b), **TOL)
        assert tw[i].asnumpy().dtype == BF16
        np.testing.assert_array_equal(tw[i].asnumpy(),
                                      _np(w32_t).astype(BF16))


def test_multi_precision_leaves_float32_weights_alone():
    opt = topt.create("sgd", momentum=0.9, multi_precision=True)
    w = tmx.nd.array(np.ones(3, np.float32), ctx=tmx.cpu())
    state = opt.create_state_multi_precision(0, w)
    assert isinstance(state, tmx.nd.NDArray)       # no master for f32


def test_multi_precision_states_cross_both_ways():
    kw = OPTIMIZERS["sgd"]
    _, jupd = _run(jmx, jopt, "sgd", kw, dtype="bfloat16",
                   multi_precision=True)
    _, tupd = _run(tmx, topt, "sgd", kw, dtype="bfloat16",
                   multi_precision=True)
    tblob = pickle.loads(tupd.get_states())
    jblob = pickle.loads(jupd.get_states())
    assert tblob["hyper_sig"] == jblob["hyper_sig"]
    assert tblob["states"][0][0] == "tuple"
    into_port = topt.get_updater(topt.create("sgd", momentum=0.9,
                                             multi_precision=True))
    into_port.set_states(jupd.get_states())
    into_jax = jopt.get_updater(jopt.create("sgd", momentum=0.9,
                                            multi_precision=True))
    into_jax.set_states(tupd.get_states())
    for i in (0, 1):
        for a, b in zip(into_port.states[i], jupd.states[i]):
            np.testing.assert_array_equal(_np(a), _np(b))
        for a, b in zip(into_jax.states[i], tupd.states[i]):
            np.testing.assert_array_equal(_np(a), _np(b))
    # the port's loaded (mom, weight32) tuple drives its next update
    w = tmx.nd.array(_np(tupd.states[0][1]).astype(BF16), ctx=tmx.cpu(),
                     dtype="bfloat16")
    into_port(0, tmx.nd.array(np.ones((4, 6), np.float32), ctx=tmx.cpu(),
                              dtype="bfloat16"), w)
    assert isinstance(into_port.states[0], tuple)


def _schedulers(mod):
    return {
        "factor": mod.FactorScheduler(step=3, factor=0.5,
                                      stop_factor_lr=1e-3, base_lr=0.1),
        "factor_warmup": mod.FactorScheduler(
            step=2, factor=0.7, base_lr=0.2, warmup_steps=4,
            warmup_begin_lr=0.01),
        "multifactor": mod.MultiFactorScheduler(step=[2, 5, 9], factor=0.3,
                                                base_lr=0.1),
        "poly": mod.PolyScheduler(max_update=12, base_lr=0.1, pwr=3,
                                  final_lr=0.001, warmup_steps=2),
        "cosine": mod.CosineScheduler(max_update=10, base_lr=0.1,
                                      final_lr=0.01, warmup_steps=3,
                                      warmup_mode="constant",
                                      warmup_begin_lr=0.02),
    }


@pytest.mark.parametrize("kind", sorted(_schedulers(tlrs)))
def test_lr_scheduler_matches_jax(kind):
    t, j = _schedulers(tlrs)[kind], _schedulers(jlrs)[kind]
    for n in range(0, 16):
        assert t(n) == j(n), (kind, n)
    # pure: any order, twice
    assert [t(n) for n in (7, 2, 7)] == [j(7), j(2), j(7)]


def test_lr_scheduler_errors_match_jax():
    for mod in (tlrs, jlrs):
        with pytest.raises(ValueError):
            mod.FactorScheduler(step=0)
        with pytest.raises(ValueError):
            mod.MultiFactorScheduler(step=[3, 2])
        with pytest.raises(ValueError):
            mod.PolyScheduler(max_update=2, warmup_steps=2)
        with pytest.raises(ValueError):
            mod.LRScheduler(warmup_mode="cubic")


def test_optimizer_reads_its_lr_scheduler():
    """The scheduler takes the optimizer's learning_rate as base_lr, is
    read at the update count, and owns the rate."""
    for mod, opt_mod, mx in ((tlrs, topt, tmx), (jlrs, jopt, jmx)):
        sched = mod.FactorScheduler(step=1, factor=0.5, base_lr=1.0)
        opt = opt_mod.create("sgd", learning_rate=0.4, lr_scheduler=sched)
        assert sched.base_lr == 0.4
        upd = opt_mod.get_updater(opt)
        w = mx.nd.array(np.zeros(2, np.float32), ctx=mx.cpu())
        for _ in range(3):
            upd(0, mx.nd.array(np.ones(2, np.float32), ctx=mx.cpu()), w)
        # updates at counts 1, 2, 3: lr 0.4, 0.2, 0.1
        np.testing.assert_allclose(_np(w), [-0.7, -0.7], rtol=1e-6)
        with pytest.raises(UserWarning):
            opt.set_learning_rate(0.1)
