"""The port's ``ParallelTrainer`` against the JAX package's, on the CPU.

Both packages train the same net from the same weights (carried with
``gluon.load_jax_params``) on the same numpy batch, each trainer on a
dp = 1 mesh of the CPU, for three steps: a thumbnail ResNet-18 (classes
10, 32 x 32, batch 4) here and the transformer LM at
``tools/benchmark_lm.py``'s CPU size in tests/test_torch_parallel_lm.py.
After the steps the losses, the weights, every optimizer state (the
float32 masters among them) and the running statistics agree:

- float32: within 1e-5 x max(1, max |x|) per array.  The two packages
  compute the same functions in another summation order; a ReLU unit
  whose input lies within float32 noise of zero would take the other
  branch and move a row of gradients (chip_smoke.py phase 5 counts such
  flips), which this net, these weights and this batch do not have.
- multi_precision: within MP_TOL = 16 x 2**-8 x max(1, max |x|).  bf16
  rounds each activation and gradient to 2**-8 relative, and the
  packages round in other places (the JAX BatchNorm normalizes in bf16,
  the port in float32 with one rounding).  A BatchNorm beta's gradient is
  a sum over the batch that cancels, so its rounding is large against
  its value, and LARS moves a zero beta (trust ratio 1) by the full lr:
  three steps of lr 0.1 measured up to 11 x 2**-8 on a beta, and the
  limit is the next power of two.
"""

import functools

import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu.parallel.data_parallel import ParallelTrainer as JTrainer
from mxnet_tpu.parallel.mesh import make_mesh as jmesh

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision
from mxnet_tpu_torch.parallel import ParallelTrainer, make_mesh

F32_TOL = 1e-5
MP_TOL = 16 * 2.0 ** -8
STEPS = 3
BATCH, IMAGE, CLASSES = 4, 32, 10
# bench.py's north-star LARS (bench.py:250-256); weight decay is covered
# by test_coalesced_apply_matches_per_tensor and the update-op tests
LARS = {"learning_rate": 0.1, "eta": 0.001, "momentum": 0.9}
# plain SGD at a step size that lowers the loss by a third in three
# steps; at lr 0.01 the net memorizes the four images in one step (loss
# 3.06 -> 0.006), and float32 noise is amplified through that collapse
SGD = {"learning_rate": 3e-4}
SGD_MOM = {"learning_rate": 3e-4, "momentum": 0.9}


def jax_mesh():
    return jmesh({"dp": 1}, [jax.devices("cpu")[0]])


def port_mesh():
    return make_mesh({"dp": 1}, [torch.device("cpu")])


@functools.lru_cache(maxsize=None)
def _batch(seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(BATCH, 3, IMAGE, IMAGE).astype(np.float32)
    y = rng.randint(0, CLASSES, (BATCH,)).astype(np.float32)
    return x, y


def _jax_net():
    net = jvision.get_model("resnet18_v1", classes=CLASSES, thumbnail=True,
                            prefix="r18_")
    net.initialize(jmx.init.Xavier(rnd_type="gaussian"))
    net(jmx.nd.array(_batch()[0]))
    return net


@functools.lru_cache(maxsize=None)
def _weights():
    jmx.random.seed(0)
    return {k: p.data().asnumpy()
            for k, p in _jax_net().collect_params().items()}


def _nets():
    """The thumbnail ResNet-18 in both packages, same names and weights."""
    jnet = _jax_net()
    for k, p in jnet.collect_params().items():
        p.set_data(jmx.nd.array(_weights()[k]))
    tnet = tvision.get_model("resnet18_v1", classes=CLASSES, thumbnail=True,
                             prefix="r18_")
    tnet.initialize(ctx=tmx.cpu())
    tnet(tmx.nd.array(_batch()[0], ctx=tmx.cpu()))
    tmx.gluon.load_jax_params(tnet, _weights())
    return jnet, tnet


def _trainers(optimizer, opt_params, mp, **kw):
    jnet, tnet = _nets()
    jtr = JTrainer(jnet, jmx.gluon.loss.SoftmaxCrossEntropyLoss(),
                   optimizer=optimizer, optimizer_params=dict(opt_params),
                   mesh=jax_mesh(), multi_precision=mp, **kw)
    ttr = ParallelTrainer(tnet, tmx.gluon.loss.SoftmaxCrossEntropyLoss(),
                          optimizer=optimizer,
                          optimizer_params=dict(opt_params),
                          mesh=port_mesh(), multi_precision=mp, **kw)
    return jtr, ttr


def _steps(jtr, ttr, x, y, n=STEPS):
    jl, tl = [], []
    for _ in range(n):
        jl.append(float(np.asarray(jtr.fit_batch(jmx.nd.array(x),
                                                 jmx.nd.array(y)))))
        tl.append(float(ttr.fit_batch(tmx.nd.array(x, ctx=tmx.cpu()),
                                      tmx.nd.array(y, ctx=tmx.cpu()))))
    return jl, tl


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, dtype=np.float32)


def assert_close(got, want, tol, what):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max() if got.size else 0.0
    lim = tol * max(1.0, float(np.abs(want).max()) if want.size else 1.0)
    assert err <= lim, "%s: max err %g > %g" % (what, err, lim)


def assert_same_state(jtr, ttr, tol):
    """Weights, optimizer states and running statistics, name by name."""
    assert ttr.param_names == jtr.param_names
    assert ttr.aux_names == jtr.aux_names
    for n in jtr.param_names:
        assert str(ttr._params[n].dtype).split(".")[-1] == \
            str(jtr._params[n].dtype)
        assert_close(ttr._params[n], jtr._params[n], tol, n)
        assert len(ttr._opt_state[n]) == len(jtr._opt_state[n]), n
        for i, (a, b) in enumerate(zip(ttr._opt_state[n],
                                       jtr._opt_state[n])):
            assert_close(a, b, tol, "%s state %d" % (n, i))
    for n in jtr.aux_names:
        assert_close(ttr._aux[n], jtr._aux[n], tol, n)


# coalesce_small: None (LARS coalesces by default), False and True (sgd
# with momentum asks for it)
RESNET_CASES = {
    "sgd": ("sgd", SGD, False, {}),
    "sgd_mom": ("sgd", SGD_MOM, False, {}),
    "sgd_mom_coalesced": ("sgd", SGD_MOM, False, {"coalesce_small": True}),
    "lbsgd": ("lbsgd", LARS, False, {}),
    "lbsgd_per_tensor": ("lbsgd", LARS, False, {"coalesce_small": False}),
    "lbsgd_remat_dots": ("lbsgd", LARS, False, {"remat": "dots"}),
    "mp_sgd": ("sgd", SGD, True, {}),
    "mp_sgd_mom": ("sgd", SGD_MOM, True, {}),
    "mp_lbsgd": ("lbsgd", LARS, True, {}),
    "mp_lbsgd_per_tensor": ("lbsgd", LARS, True, {"coalesce_small": False}),
}


@pytest.mark.parametrize("case", sorted(RESNET_CASES))
def test_resnet_trainer_matches_jax(case):
    optimizer, opt_params, mp, kw = RESNET_CASES[case]
    jtr, ttr = _trainers(optimizer, opt_params, mp, **kw)
    jl, tl = _steps(jtr, ttr, *_batch())
    tol = MP_TOL if mp else F32_TOL
    for a, b in zip(tl, jl):
        assert abs(a - b) <= tol * max(1.0, abs(b)), (tl, jl)
    assert_same_state(jtr, ttr, tol)
    assert ttr._num_update == jtr._num_update == STEPS
    assert ttr.dispatch_count == STEPS
    if mp:
        # BatchNorm's running statistics stay float32 aux, as in the JAX
        # step, while its data, gamma and beta are bf16
        assert all(a.dtype == torch.float32 for a in ttr._aux.values())
        for n in ttr.param_names:
            assert ttr._params[n].dtype == torch.bfloat16
            # the compute weight is its float32 master rounded
            assert torch.equal(ttr._params[n],
                               ttr._opt_state[n][-1].to(torch.bfloat16))
    # LARS coalesces the small arrays by default, sgd only on request
    coalesced = kw.get("coalesce_small", optimizer == "lbsgd")
    assert bool(ttr._small) == bool(coalesced)


def test_evaluate_predict_and_sync_match_jax():
    jtr, ttr = _trainers("sgd", SGD_MOM, False)
    x, y = _batch()
    _steps(jtr, ttr, x, y, n=2)
    xe, ye = _batch(seed=1)
    je = float(np.asarray(jtr.evaluate_batch(jmx.nd.array(xe),
                                             jmx.nd.array(ye))))
    te = float(ttr.evaluate_batch(tmx.nd.array(xe, ctx=tmx.cpu()),
                                  tmx.nd.array(ye, ctx=tmx.cpu())))
    assert abs(te - je) <= F32_TOL * max(1.0, abs(je))
    jp = jtr.predict_batch(jmx.nd.array(xe)).asnumpy()
    tp = ttr.predict_batch(tmx.nd.array(xe, ctx=tmx.cpu())).asnumpy()
    assert tp.shape == (BATCH, CLASSES)
    assert_close(tp, jp, F32_TOL, "predict")
    # inference evaluation leaves the running statistics alone
    assert_same_state(jtr, ttr, F32_TOL)
    jtr.sync_params()
    ttr.sync_params()
    jparams = jtr.net.collect_params()
    for n, p in ttr.net.collect_params().items():
        assert_close(p.data().asnumpy(), jparams[n].data().asnumpy(),
                     F32_TOL, n)
        want = ttr._aux[n] if n in ttr._aux else ttr._params[n]
        np.testing.assert_array_equal(p.data().asnumpy(), want.numpy())


def test_sync_params_writes_the_float32_masters():
    _, ttr = _trainers("lbsgd", LARS, True)
    x, y = _batch()
    ttr.fit_batch(tmx.nd.array(x, ctx=tmx.cpu()),
                  tmx.nd.array(y, ctx=tmx.cpu()))
    ttr.sync_params()
    for n, p in ttr.net.collect_params().items():
        if n in ttr._aux:
            continue
        assert p.data().dtype == np.float32
        np.testing.assert_array_equal(p.data().asnumpy(),
                                      ttr._opt_state[n][-1].numpy())


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoints_cross_both_ways(tmp_path, writer):
    """A multi-precision LARS checkpoint written by one package loads into
    the other bit for bit (params, momenta, masters, aux, num_update);
    the next step then agrees at the mp limit."""
    x, y = _batch()
    jtr, ttr = _trainers("lbsgd", LARS, True)
    _steps(jtr, ttr, x, y, n=2)
    src, dst = (ttr, jtr) if writer == "port" else (jtr, ttr)
    src.save_checkpoint(str(tmp_path / "ck"), 1)
    # a fresh reader of the other package, built by one step
    fj, ft = _trainers("lbsgd", LARS, True)
    _steps(fj, ft, *_batch(seed=2), n=1)
    reader = ft if writer == "jax" else fj
    reader.load_checkpoint(str(tmp_path / "ck"), 1)
    assert reader._num_update == 2
    for n in src.param_names:
        np.testing.assert_array_equal(_f32(reader._params[n]),
                                      _f32(src._params[n]))
        for a, b in zip(reader._opt_state[n], src._opt_state[n]):
            np.testing.assert_array_equal(_f32(a), _f32(b))
    for n in src.aux_names:
        np.testing.assert_array_equal(_f32(reader._aux[n]),
                                      _f32(src._aux[n]))
    if writer == "port":
        _steps(reader, ttr, x, y, n=1)
        assert_same_state(reader, ttr, MP_TOL)
    else:
        _steps(jtr, reader, x, y, n=1)
        assert_same_state(jtr, reader, MP_TOL)


def _small_net(pkg):
    nn = pkg.gluon.nn
    net = nn.HybridSequential(prefix="small_")
    with net.name_scope():
        net.add(nn.Dense(16, activation="relu"), nn.BatchNorm(),
                nn.Dense(4))
    net.initialize(ctx=pkg.cpu())
    net(pkg.nd.array(np.zeros((1, 8), np.float32), ctx=pkg.cpu()))
    return net


@pytest.mark.parametrize("momentum,mp", [(0.0, False), (0.9, False),
                                         (0.9, True)])
def test_checkpoint_resume_is_exact(tmp_path, momentum, mp):
    """Mirror of the JAX package's test_parallel_modes.py:160: a trainer
    restored from a checkpoint (params, optimizer state, aux, update
    count) repeats the original's next losses bit for bit."""
    rs = np.random.RandomState(0)
    x = tmx.nd.array(rs.randn(16, 8).astype(np.float32), ctx=tmx.cpu())
    y = tmx.nd.array(rs.randint(0, 4, (16,)).astype(np.float32),
                     ctx=tmx.cpu())
    params = {"learning_rate": 0.1}
    if momentum:
        params["momentum"] = momentum

    def make():
        return ParallelTrainer(_small_net(tmx),
                               tmx.gluon.loss.SoftmaxCrossEntropyLoss(),
                               optimizer="sgd", optimizer_params=params,
                               mesh=port_mesh(), multi_precision=mp)

    t1 = make()
    for _ in range(5):
        t1.fit_batch(x, y)
    t1.save_checkpoint(str(tmp_path / "ck"), 3)
    ref = [float(t1.fit_batch(x, y)) for _ in range(3)]
    t2 = make()            # fresh, differently initialized
    t2.fit_batch(x, y)     # build, then restore over it
    t2.load_checkpoint(str(tmp_path / "ck"), 3)
    got = [float(t2.fit_batch(x, y)) for _ in range(3)]
    assert got == ref
    assert t2._num_update == 8


def test_checkpoint_load_refuses_another_architecture(tmp_path):
    _, ttr = _trainers("sgd", SGD_MOM, False)
    x, y = _batch()
    ttr.fit_batch(tmx.nd.array(x, ctx=tmx.cpu()),
                  tmx.nd.array(y, ctx=tmx.cpu()))
    other = ParallelTrainer(_small_net(tmx),
                            tmx.gluon.loss.SoftmaxCrossEntropyLoss(),
                            optimizer="sgd", optimizer_params=SGD_MOM,
                            mesh=port_mesh())
    rs = np.random.RandomState(0)
    other.fit_batch(tmx.nd.array(rs.randn(4, 8).astype(np.float32),
                                 ctx=tmx.cpu()),
                    tmx.nd.array(np.zeros(4, np.float32), ctx=tmx.cpu()))
    other.save_checkpoint(str(tmp_path / "o"), 0)
    before = {n: t.clone() for n, t in ttr._params.items()}
    with pytest.raises(ValueError, match="checkpoint has"):
        ttr.load_checkpoint(str(tmp_path / "o"), 0)
    assert all(torch.equal(before[n], t) for n, t in ttr._params.items())


def _conv_bn_net(pkg, prefix):
    nn = pkg.gluon.nn
    net = nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(nn.Conv2D(8, 3, padding=1), nn.BatchNorm(),
                nn.Activation("relu"), nn.Dense(5))
    net.initialize(pkg.init.Xavier(rnd_type="gaussian"), ctx=pkg.cpu())
    net(pkg.nd.array(np.zeros((1, 3, 8, 8), np.float32), ctx=pkg.cpu()))
    return net


@pytest.mark.parametrize("optimizer,mp,momentum", [("lbsgd", True, 0.9),
                                                   ("lbsgd", False, 0.0),
                                                   ("sgd", False, 0.9)])
def test_coalesced_apply_matches_per_tensor(optimizer, mp, momentum):
    """Mirror of the JAX package's test_parallel_modes.py:206: the
    coalesced apply of the small arrays computes the per-tensor update in
    float32; only the order of the norms' sums differs, so the two agree
    within float32 rounding (1e-5 x max(1, max |x|) after four steps)."""
    rs = np.random.RandomState(3)
    x = tmx.nd.array(rs.randn(16, 3, 8, 8).astype(np.float32),
                     ctx=tmx.cpu())
    y = tmx.nd.array(rs.randint(0, 5, (16,)).astype(np.float32),
                     ctx=tmx.cpu())
    params = {"learning_rate": 0.05, "eta": 0.01, "wd": 1e-4}
    if momentum:
        params["momentum"] = momentum
    nets = [_conv_bn_net(tmx, "cb%d_" % i) for i in range(2)]
    for a, b in zip(nets[0].collect_params().values(),
                    nets[1].collect_params().values()):
        b.set_data(a.data())
    ta, tb = (ParallelTrainer(net, tmx.gluon.loss.SoftmaxCrossEntropyLoss(),
                              optimizer=optimizer, optimizer_params=params,
                              mesh=port_mesh(), multi_precision=mp,
                              coalesce_small=c)
              for net, c in zip(nets, (False, True)))
    la = [float(ta.fit_batch(x, y)) for _ in range(4)]
    lb = [float(tb.fit_batch(x, y)) for _ in range(4)]
    np.testing.assert_allclose(lb, la, rtol=F32_TOL, atol=F32_TOL)
    assert not ta._small and len(tb._small) >= 2
    for na, nb in zip(ta.param_names, tb.param_names):
        assert_close(tb._params[nb], ta._params[na], F32_TOL, nb)
        for a, b in zip(ta._opt_state[na], tb._opt_state[nb]):
            assert_close(b, a, F32_TOL, nb)


def test_coalesced_arrays_are_views_of_flat_buffers():
    _, ttr = _trainers("lbsgd", LARS, True)
    x, y = _batch()
    ttr.fit_batch(tmx.nd.array(x, ctx=tmx.cpu()),
                  tmx.nd.array(y, ctx=tmx.cpu()))
    small = ttr._small
    assert all(ttr._params[n].numel() <= 8192 for n in small)
    assert sum(ttr._params[n].numel() for n in small) == \
        ttr._flat_w.numel()
    for n in small:
        assert ttr._params[n].untyped_storage().data_ptr() == \
            ttr._flat_w.untyped_storage().data_ptr()
        assert ttr._opt_state[n][-1].untyped_storage().data_ptr() == \
            ttr._flat_w32.untyped_storage().data_ptr()


def test_not_ported_paths_raise():
    x, y = _batch()
    with pytest.raises(tmx.MXNetError, match="param_specs.*not ported"):
        ParallelTrainer(_small_net(tmx), None, param_specs={"w": None},
                        mesh=port_mesh())
    tr = ParallelTrainer(_small_net(tmx), None, mesh=port_mesh())
    with pytest.raises(tmx.MXNetError, match="fit.*not ported"):
        tr.fit(None)
    with pytest.raises(RuntimeError, match="fit_batch"):
        tr.predict_batch(x)
    with pytest.raises(RuntimeError, match="fit_batch"):
        tr.load_checkpoint("nowhere")
    cpu = torch.device("cpu")
    with pytest.raises(tmx.MXNetError, match="not ported"):
        make_mesh({"dp": 2}, [cpu, cpu])
    with pytest.raises(tmx.MXNetError, match="not ported"):
        make_mesh({"dp": 1, "tp": 1}, [cpu])
    with pytest.raises(ValueError, match="do not cover"):
        make_mesh({"dp": 2}, [cpu])
    mesh = make_mesh({"dp": -1}, [cpu])
    assert mesh.shape == {"dp": 1} and mesh.device == cpu


class _FrozenArg(tmx.gluon.HybridBlock):
    """A graph argument with no Parameter behind it whose shape inference
    cannot find (``dot`` has no shape rule): it cannot be zero-filled."""

    def hybrid_forward(self, F, x):
        return F.dot(x, F.var("begin_state"))


@pytest.mark.parametrize("fault", ["frozen", "mp_adam", "coalesce_adam",
                                   "unknown", "remat"])
def test_trainer_refuses_what_it_cannot_run(fault):
    x = tmx.nd.array(np.zeros((2, 8), np.float32), ctx=tmx.cpu())
    y = tmx.nd.array(np.zeros(2, np.float32), ctx=tmx.cpu())
    loss = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    kw = {"frozen": {}, "mp_adam": dict(optimizer="adam",
                                        multi_precision=True),
          "coalesce_adam": dict(optimizer="adam", coalesce_small=True),
          "unknown": dict(optimizer="lamb"), "remat": dict(remat="some")}
    err = {"frozen": (tmx.MXNetError, "cannot infer shapes"),
           "mp_adam": (ValueError, "multi_precision"),
           "coalesce_adam": (ValueError, "coalesce_small"),
           "unknown": (ValueError, "not supported"),
           "remat": (ValueError, "remat")}[fault]
    net = _FrozenArg() if fault == "frozen" else _small_net(tmx)
    with pytest.raises(err[0], match=err[1]):
        ParallelTrainer(net, loss, mesh=port_mesh(),
                        **kw[fault]).fit_batch(x, y)


def test_device_batch_keeps_integer_ids_and_labels():
    tr = ParallelTrainer(_small_net(tmx), None, mesh=port_mesh(),
                         multi_precision=True)
    ids = tmx.nd.array(np.arange(6).reshape(2, 3) + 257, ctx=tmx.cpu(),
                       dtype="int32")
    assert tr._device_batch(ids).dtype == torch.int32
    assert torch.equal(tr._device_batch(ids), ids._data)
    x = tmx.nd.array(np.full((2, 3), 257.0, np.float32), ctx=tmx.cpu())
    assert tr._device_batch(x).dtype == torch.bfloat16
    assert tr._label_batch(x).dtype == torch.float32
