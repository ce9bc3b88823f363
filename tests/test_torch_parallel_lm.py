"""The port's ``ParallelTrainer`` on the transformer LM against the JAX
package's, on the CPU, at ``tools/benchmark_lm.py``'s CPU size (dim 64,
4 heads, 2 layers, seq 128, vocab 64, batch 2, int32 ids).

Both packages train the same LM from the same weights for three steps
through every update op of the trainer's table (``_OPT_OPS``), bf16
compute weights with float32 masters (``tools/benchmark_lm.py``'s
north-star configuration: sgd, lr 0.01, momentum 0.9), ``remat`` 'full'
and 'dots', ``grad_clip`` and an ``lr_scheduler``.  Losses, weights,
optimizer states and masters agree within 1e-5 x max(1, max |x|) in
float32; under multi_precision within 2**-8 x max(1, max |x|): the LM has
no BatchNorm and every weight moves by lr x its gradient, so the two
packages' bf16 roundings stay within one unit of 2**-8 of the largest
value (measured: 8e-5 after three steps).
"""

import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import lr_scheduler as jlrs
from mxnet_tpu.gluon.model_zoo.transformer import \
    get_transformer_lm as jax_lm
from mxnet_tpu.parallel.data_parallel import ParallelTrainer as JTrainer
from mxnet_tpu.parallel.mesh import make_mesh as jmesh
from mxnet_tpu.ops import registry as jreg

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import lr_scheduler as tlrs
from mxnet_tpu_torch.gluon.model_zoo.transformer import \
    get_transformer_lm as port_lm
from mxnet_tpu_torch.parallel import ParallelTrainer, make_mesh

F32_TOL = 1e-5
MP_TOL = 2.0 ** -8
STEPS = 3
CFG = dict(vocab=64, dim=64, heads=4, layers=2, max_seq=128, prefix="lm_")
BATCH, SEQ = 2, 128
SGD_MOM = {"learning_rate": 0.01, "momentum": 0.9}


def _batch():
    rng = np.random.RandomState(0)
    x = rng.randint(0, CFG["vocab"], (BATCH, SEQ)).astype(np.int32)
    y = rng.randint(0, CFG["vocab"], (BATCH, SEQ)).astype(np.float32)
    return x, y


_WEIGHTS = {}


def _weights():
    if not _WEIGHTS:
        jmx.random.seed(0)
        net = jax_lm(**CFG)
        net.initialize()
        net(jmx.nd.array(_batch()[0], dtype="int32"))
        _WEIGHTS.update({k: p.data().asnumpy()
                         for k, p in net.collect_params().items()})
    return _WEIGHTS


def _trainers(optimizer, opt_params, mp, sched=None, **kw):
    x = _batch()[0]
    jnet = jax_lm(**CFG)
    jnet.initialize()
    jnet(jmx.nd.array(x, dtype="int32"))
    for k, p in jnet.collect_params().items():
        p.set_data(jmx.nd.array(_weights()[k]))
    tnet = port_lm(**CFG)
    tnet.initialize(ctx=tmx.cpu())
    tnet(tmx.nd.array(x, ctx=tmx.cpu(), dtype="int32"))
    tmx.gluon.load_jax_params(tnet, _weights())
    jp, tp = dict(opt_params), dict(opt_params)
    if sched is not None:
        jp["lr_scheduler"] = sched(jlrs)
        tp["lr_scheduler"] = sched(tlrs)
    jtr = JTrainer(jnet, jmx.gluon.loss.SoftmaxCrossEntropyLoss(),
                   optimizer=optimizer, optimizer_params=jp,
                   mesh=jmesh({"dp": 1}, [jax.devices("cpu")[0]]),
                   multi_precision=mp, **kw)
    ttr = ParallelTrainer(tnet, tmx.gluon.loss.SoftmaxCrossEntropyLoss(),
                          optimizer=optimizer, optimizer_params=tp,
                          mesh=make_mesh({"dp": 1}, [torch.device("cpu")]),
                          multi_precision=mp, **kw)
    return jtr, ttr


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, dtype=np.float32)


def _close(got, want, tol, what):
    got, want = _f32(got), _f32(want)
    err = np.abs(got - want).max()
    lim = tol * max(1.0, float(np.abs(want).max()))
    assert err <= lim, "%s: max err %g > %g" % (what, err, lim)


def _factor(mod):
    return mod.FactorScheduler(step=1, factor=0.5, base_lr=1.0)


# case -> (optimizer, its parameters, multi_precision, scheduler, kwargs)
CASES = {
    "sgd": ("sgd", {"learning_rate": 0.01}, False, None, {}),
    "sgd_mom": ("sgd", SGD_MOM, False, None, {}),
    "nag": ("nag", SGD_MOM, False, None, {}),
    "adam": ("adam", {"learning_rate": 0.001}, False, None, {}),
    # rmsprop's first steps move every weight by about 4.5 lr whatever its
    # gradient's size; at lr 0.001 that moves an fc1 unit's input across
    # zero in one package only (a ReLU flip, see chip_smoke.py phase 5)
    "rmsprop": ("rmsprop", {"learning_rate": 1e-4}, False, None, {}),
    "rmspropalex": ("rmspropalex", {"learning_rate": 0.001}, False, None,
                    {}),
    "ftrl": ("ftrl", {"learning_rate": 0.1}, False, None, {}),
    "ftml": ("ftml", {"learning_rate": 0.001}, False, None, {}),
    "signum": ("signum", {"learning_rate": 0.001, "momentum": 0.9}, False,
               None, {}),
    "signsgd": ("signsgd", {"learning_rate": 0.001}, False, None, {}),
    "adadelta": ("adadelta", {}, False, None, {}),
    "adamax": ("adamax", {"learning_rate": 0.002}, False, None, {}),
    "nadam": ("nadam", {"learning_rate": 0.001}, False, None, {}),
    "lars": ("lars", dict(SGD_MOM, eta=0.01), False, None, {}),
    "remat_full": ("sgd", SGD_MOM, False, None, {"remat": "full"}),
    "remat_dots": ("sgd", SGD_MOM, False, None, {"remat": "dots"}),
    "grad_clip": ("sgd", SGD_MOM, False, None, {"grad_clip": 0.5}),
    "lr_scheduler": ("sgd", SGD_MOM, False, _factor, {}),
    "mp_sgd_mom": ("sgd", SGD_MOM, True, None, {}),
    "mp_remat_dots": ("sgd", SGD_MOM, True, None, {"remat": "dots"}),
    "mp_grad_clip": ("sgd", SGD_MOM, True, None, {"grad_clip": 0.5}),
    "mp_lbsgd": ("lbsgd", dict(SGD_MOM, eta=0.01), True, None, {}),
}


@pytest.fixture
def jax_adadelta_without_lr(monkeypatch):
    """The JAX trainer passes lr to every update op, and adadelta takes
    none (``mxnet_tpu/parallel/data_parallel.py:513`` raises TypeError);
    the reference side drops it here, the port's trainer does not pass
    it."""
    op = jreg.get_op("adadelta_update")
    fn = op.fn

    def without_lr(*args, lr=None, **kw):
        return fn(*args, **kw)
    monkeypatch.setattr(op, "fn", without_lr)


@pytest.mark.parametrize("case", sorted(CASES))
def test_lm_trainer_matches_jax(case, jax_adadelta_without_lr):
    optimizer, opt_params, mp, sched, kw = CASES[case]
    jtr, ttr = _trainers(optimizer, opt_params, mp, sched, **kw)
    x, y = _batch()
    tol = MP_TOL if mp else F32_TOL
    for _ in range(STEPS):
        jl = float(np.asarray(jtr.fit_batch(
            jmx.nd.array(x, dtype="int32"), jmx.nd.array(y))))
        tl = float(ttr.fit_batch(
            tmx.nd.array(x, ctx=tmx.cpu(), dtype="int32"),
            tmx.nd.array(y, ctx=tmx.cpu())))
        assert abs(tl - jl) <= tol * max(1.0, abs(jl)), (tl, jl)
    assert ttr.param_names == jtr.param_names
    for n in jtr.param_names:
        _close(ttr._params[n], jtr._params[n], tol, n)
        assert len(ttr._opt_state[n]) == len(jtr._opt_state[n])
        for a, b in zip(ttr._opt_state[n], jtr._opt_state[n]):
            _close(a, b, tol, n)
    if sched is not None:
        assert ttr._current_lr() == jtr._current_lr() == 0.5 ** 2


def _recompute_all(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    return CheckpointPolicy.PREFER_RECOMPUTE


def test_lm_remat_recomputes_and_keeps_the_gradient():
    """'full', 'dots' and a policy callable keep no activation on the
    step's own tape (the checkpoint holds what it saves) and give the
    gradients of the plain step exactly: the recomputed forward is the
    same arithmetic."""
    x, y = _batch()
    xd = torch.from_numpy(x)
    yd = torch.from_numpy(y)
    grads, kept = {}, {}
    for remat in (None, "full", "dots", _recompute_all):
        _, ttr = _trainers("sgd", SGD_MOM, False, remat=remat)
        ttr._ensure_built(xd, yd)
        saved = []

        def pack(t):
            saved.append(t.numel())
            return t
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss, g, _ = ttr._value_and_grad(ttr._device_batch(xd),
                                             ttr._label_batch(yd))
        grads[remat], kept[remat] = (loss, g), sum(saved)
    assert kept[None] > 0
    for remat in ("full", "dots", _recompute_all):
        assert kept[remat] < kept[None] / 10, (remat, kept)
        assert torch.equal(grads[remat][0], grads[None][0])
        for n, g in grads[None][1].items():
            assert torch.equal(grads[remat][1][n], g), (remat, n)
