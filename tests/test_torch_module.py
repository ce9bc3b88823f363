"""The port's Module against the JAX package's: the 9 cases of
``tests/test_module.py`` mirrored, the cases of ``tests/test_fused_step.py``
that need neither distributed stores nor group2ctx, checkpoints and
optimizer-state files crossing both ways, and the slice as a whole: a
tiny transformer LM trained through ``Module.fit`` in both packages from
the same weights.

Tolerances: the fused step against the legacy loop, and the port against
the JAX package, agree at f32 rtol 1e-5 / atol 1e-6 per parameter (the
same arithmetic; the JAX package compiles the step into one XLA program,
which reassociates the last bits); the LM at rtol 1e-4 / atol 1e-5 after
three steps (attention's gradient is blockwise in the port and a vjp of
the chunked forward in the JAX package, and the difference carries into
the next step); float16 multi-precision at 2e-3.
"""

import os
import struct

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import nd, sym
from mxnet_tpu_torch import optimizer as opt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.io import DataBatch, MNISTIter, NDArrayIter
from mxnet_tpu_torch.optimizer import tree_opt

PKGS = {"jax": jmx, "port": tmx}
TOL = {"float32": dict(rtol=1e-5, atol=1e-6),
       "float16": dict(rtol=2e-3, atol=2e-3)}
LM_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes are tiny: one intra-op thread, so that the parallel test
    run does not oversubscribe the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cpu_nd(mx, x):
    return mx.nd.array(x, ctx=mx.cpu())


def _mlp_sym(mx=tmx, num_hidden=32, num_classes=4):
    s = mx.sym
    net = s.FullyConnected(s.var("data"), num_hidden=num_hidden, name="fc1")
    net = s.Activation(net, act_type="relu")
    net = s.FullyConnected(net, num_hidden=num_classes, name="fc2")
    return s.SoftmaxOutput(net, name="softmax")


def _lenet_sym():
    c1 = sym.Convolution(sym.var("data"), kernel=(3, 3), num_filter=8,
                         name="conv1")
    a1 = sym.Activation(c1, act_type="tanh")
    p1 = sym.Pooling(a1, pool_type="max", kernel=(2, 2), stride=(2, 2))
    fc1 = sym.FullyConnected(sym.Flatten(p1), num_hidden=32, name="fc1")
    a2 = sym.Activation(fc1, act_type="tanh")
    fc2 = sym.FullyConnected(a2, num_hidden=10, name="fc2")
    return sym.SoftmaxOutput(fc2, name="softmax")


def _toy_data(n=256, dim=16, classes=4, seed=0):
    rng = np.random.RandomState(seed)
    centers = rng.randn(classes, dim) * 3
    labels = rng.randint(0, classes, n)
    data = centers[labels] + rng.randn(n, dim)
    return data.astype(np.float32), labels.astype(np.float32)


# -- the cases of tests/test_module.py --------------------------------------

def test_module_fit_toy():
    data, labels = _toy_data()
    train = NDArrayIter(data, labels, batch_size=32, shuffle=True)
    mod = tmx.Module(_mlp_sym(), context=tmx.cpu())
    mod.fit(train, num_epoch=5, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1})
    score = mod.score(NDArrayIter(data, labels, batch_size=32), "acc")
    assert score[0][1] > 0.9, score
    assert mod._fused["mode"] == "full"


def test_module_predict():
    data, labels = _toy_data(n=64)
    mod = tmx.Module(_mlp_sym(), context=tmx.cpu())
    mod.fit(NDArrayIter(data, labels, batch_size=16), num_epoch=2,
            optimizer="sgd")
    preds = mod.predict(NDArrayIter(data, labels, batch_size=16))
    assert preds.shape == (64, 4)
    # a padded last batch is trimmed
    preds = mod.predict(NDArrayIter(data[:40], labels[:40], batch_size=16))
    assert preds.shape == (40, 4)
    outs = list(mod.iter_predict(NDArrayIter(data, labels, batch_size=16)))
    assert len(outs) == 4 and outs[0][0][0].shape == (16, 4)


def test_module_checkpoint(tmp_path):
    data, labels = _toy_data(n=64)
    train = NDArrayIter(data, labels, batch_size=16)
    mod = tmx.Module(_mlp_sym(), context=tmx.cpu())
    mod.fit(train, num_epoch=1, optimizer="sgd")
    prefix = str(tmp_path / "model")
    mod.save_checkpoint(prefix, 1)
    mod2 = tmx.Module.load(prefix, 1, context=tmx.cpu())
    mod2.bind(train.provide_data, train.provide_label, for_training=False)
    p1 = mod.predict(NDArrayIter(data, labels, batch_size=16)).asnumpy()
    p2 = mod2.predict(NDArrayIter(data, labels, batch_size=16)).asnumpy()
    np.testing.assert_allclose(p1, p2, rtol=1e-5, atol=1e-6)


def test_module_epoch_end_checkpoint(tmp_path):
    data, labels = _toy_data(n=64)
    mod = tmx.Module(_mlp_sym(), context=tmx.cpu())
    prefix = str(tmp_path / "cb")
    mod.fit(NDArrayIter(data, labels, batch_size=16), num_epoch=2,
            epoch_end_callback=tmx.callback.do_checkpoint(prefix))
    _, a, _ = tmx.model.load_checkpoint(prefix, 2, ctx=tmx.cpu())
    assert "fc1_weight" in a
    _, ja, _ = jmx.model.load_checkpoint(prefix, 2)
    np.testing.assert_array_equal(ja["fc1_weight"].asnumpy(),
                                  a["fc1_weight"].asnumpy())


def test_module_input_grads():
    data, labels = _toy_data(n=32)
    got = {}
    for pkg, mx in PKGS.items():
        mod = mx.Module(_mlp_sym(mx), context=mx.cpu())
        train = mx.io.NDArrayIter(data, labels, batch_size=8)
        mod.bind(train.provide_data, train.provide_label,
                 inputs_need_grad=True)
        mod.init_params(arg_params=_mlp_init(mx, 16, 32))
        mod.init_optimizer()
        mod.forward_backward(next(iter(train)))
        got[pkg] = mod.get_input_grads()[0].asnumpy()
    assert got["port"].shape == (8, 16)
    assert np.abs(got["port"]).sum() > 0
    np.testing.assert_allclose(got["port"], got["jax"], **TOL["float32"])


def test_module_multi_device():
    """Data parallel over two CPU contexts: the batch is split, the
    gradients summed, and the fused tree update follows."""
    data, labels = _toy_data(n=128)
    train = NDArrayIter(data, labels, batch_size=32, shuffle=True)
    mod = tmx.Module(_mlp_sym(), context=[tmx.cpu(0), tmx.cpu(1)])
    mod.fit(train, num_epoch=3, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1})
    score = mod.score(NDArrayIter(data, labels, batch_size=32), "acc")
    assert score[0][1] > 0.8
    assert mod._fused["mode"] == "partial"


def _write_synth_mnist(tmp_path, n=512, seed=0):
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 10, n).astype(np.uint8)
    images = (rng.rand(n, 12, 12) * 40).astype(np.uint8)
    for i, k in enumerate(labels):
        r, c = divmod(int(k), 4)
        images[i, 3 * r:3 * r + 4, 3 * c:3 * c + 4] = 220
    img = str(tmp_path / "train-images-idx3-ubyte")
    lbl = str(tmp_path / "train-labels-idx1-ubyte")
    with open(img, "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 12, 12))
        f.write(images.tobytes())
    with open(lbl, "wb") as f:
        f.write(struct.pack(">II", 2049, n))
        f.write(labels.tobytes())
    return img, lbl


def test_lenet_mnist_end_to_end(tmp_path):
    img, lbl = _write_synth_mnist(tmp_path)
    train = MNISTIter(image=img, label=lbl, batch_size=32, shuffle=True)
    val = MNISTIter(image=img, label=lbl, batch_size=32, shuffle=False)
    mod = tmx.Module(_lenet_sym(), context=tmx.cpu())
    mod.fit(train, eval_data=val, num_epoch=6, optimizer="sgd",
            initializer=tmx.init.Xavier(),
            optimizer_params={"learning_rate": 0.5, "momentum": 0.9})
    score = mod.score(val, "acc")
    assert score[0][1] > 0.9, score


class _RaggedIter:
    def __init__(self, arrays):
        self._batches = [DataBatch(data=[nd.array(a, ctx=tmx.cpu())])
                         for a in arrays]

    def reset(self):
        pass

    def __iter__(self):
        return iter(self._batches)


def test_module_predict_ragged_remainder_single_compile():
    """A ragged last inference batch is zero-padded to the bound batch and
    its outputs trimmed: no rebind, and each partial's rows equal the
    same rows forwarded in a full batch."""
    dim, bs = 16, 8
    net = sym.FullyConnected(sym.var("data"), num_hidden=32, name="fc1")
    net = sym.Activation(net, act_type="relu")
    net = sym.softmax(sym.FullyConnected(net, num_hidden=4, name="fc2"))
    mod = tmx.Module(net, label_names=None, context=tmx.cpu())
    mod.bind(data_shapes=[("data", (bs, dim))], for_training=False)
    mod.init_params()
    ex = mod._exec_group.execs[0]
    rs = np.random.RandomState(0)
    for n in (5, 3, 1, 7, 2, 6):
        x = rs.randn(n, dim).astype(np.float32)
        mod.forward(DataBatch(data=[nd.array(x, ctx=tmx.cpu())]))
        out = mod.get_outputs()[0]
        assert out.shape == (n, 4)
        buf = np.zeros((bs, dim), np.float32)
        buf[:n] = x
        mod.forward(DataBatch(data=[nd.array(buf, ctx=tmx.cpu())]))
        assert np.array_equal(out.asnumpy(),
                              mod.get_outputs()[0].asnumpy()[:n])
    assert mod._exec_group.execs[0] is ex      # never rebound
    arrays = [rs.randn(bs, dim).astype(np.float32),
              rs.randn(bs, dim).astype(np.float32),
              rs.randn(3, dim).astype(np.float32)]
    assert mod.predict(_RaggedIter(arrays)).shape == (2 * bs + 3, 4)


def test_module_train_forward_not_padded():
    dim, bs = 16, 8
    mod = tmx.Module(_mlp_sym(), context=tmx.cpu())
    data, labels = _toy_data(n=32)
    train = NDArrayIter(data, labels, batch_size=bs)
    mod.bind(train.provide_data, train.provide_label)
    mod.init_params()
    mod.forward(DataBatch(data=[nd.zeros((bs, dim), ctx=tmx.cpu())],
                          label=[nd.zeros((bs,), ctx=tmx.cpu())]),
                is_train=True)
    assert mod.get_outputs()[0].shape[0] == bs


# -- the cases of tests/test_fused_step.py ----------------------------------

def _mlp(mx=tmx):
    return _mlp_sym(mx, num_hidden=16)


def _mlp_init(mx=tmx, dim=8, hidden=16, seed=0):
    rng = np.random.RandomState(seed)
    return {"fc1_weight": _cpu_nd(mx, rng.randn(hidden, dim)
                                  .astype(np.float32) * 0.1),
            "fc1_bias": _cpu_nd(mx, np.zeros(hidden, np.float32)),
            "fc2_weight": _cpu_nd(mx, rng.randn(4, hidden)
                                  .astype(np.float32) * 0.1),
            "fc2_bias": _cpu_nd(mx, np.zeros(4, np.float32))}


def _toy_batches(mx=tmx, n_batches=4, batch=16, dim=8, seed=0):
    rng = np.random.RandomState(seed + 100)
    X = rng.randn(n_batches * batch, dim).astype(np.float32)
    Y = rng.randint(0, 4, n_batches * batch).astype(np.float32)
    return [mx.io.DataBatch(
        data=[_cpu_nd(mx, X[i * batch:(i + 1) * batch])],
        label=[_cpu_nd(mx, Y[i * batch:(i + 1) * batch])])
        for i in range(n_batches)]


def _run_module(fused, symbol, init_args, batches, optimizer, opt_params,
                n_steps, data_shape=(16, 8), contexts=None, mx=tmx,
                aux_args=None):
    os.environ["MXNET_MODULE_FUSED_STEP"] = "1" if fused else "0"
    try:
        mod = mx.Module(symbol, context=contexts or mx.cpu())
        mod.bind([("data", data_shape)],
                 [("softmax_label", (data_shape[0],))])
        mod.init_params(arg_params={k: v.copy()
                                    for k, v in init_args.items()},
                        aux_params=aux_args)
        mod.init_optimizer(kvstore=None, optimizer=optimizer,
                           optimizer_params=dict(opt_params))
        for i in range(n_steps):
            mod.forward_backward_update(batches[i % len(batches)])
    finally:
        os.environ.pop("MXNET_MODULE_FUSED_STEP", None)
    return mod


def _params(mod):
    a, x = mod.get_params()
    out = {k: v.asnumpy() for k, v in a.items()}
    out.update({"aux:" + k: v.asnumpy() for k, v in x.items()})
    return out


def _assert_close(a, b, **tol):
    a = a if isinstance(a, dict) else _params(a)
    b = b if isinstance(b, dict) else _params(b)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_allclose(a[k], b[k], err_msg=k, **tol)


FUSED_CASES = [
    ("sgd", {"learning_rate": 0.1}),
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}),
    ("adam", {"learning_rate": 0.01}),
    ("adagrad", {"learning_rate": 0.1}),
    ("rmsprop", {"learning_rate": 0.01}),
    ("nag", {"learning_rate": 0.1, "momentum": 0.9}),
]


@pytest.mark.parametrize("optimizer,opt_params", FUSED_CASES)
def test_fused_matches_legacy(optimizer, opt_params):
    """The fused step against the legacy loop in the port, and both
    against the JAX package's fused step."""
    legacy = _run_module(False, _mlp(), _mlp_init(), _toy_batches(),
                         optimizer, opt_params, n_steps=6)
    fused = _run_module(True, _mlp(), _mlp_init(), _toy_batches(),
                        optimizer, opt_params, n_steps=6)
    assert fused._fused and fused._fused["mode"] == "full"
    _assert_close(legacy, fused, **TOL["float32"])
    jax_mod = _run_module(True, _mlp(jmx), _mlp_init(jmx),
                          _toy_batches(jmx), optimizer, opt_params,
                          n_steps=6, mx=jmx)
    _assert_close(fused, jax_mod, **TOL["float32"])


def test_fused_mp_sgd_tree_matches_legacy_updater():
    rng = np.random.RandomState(5)
    w0 = (rng.randn(6, 4) * 0.5).astype(np.float16)
    grads = [(rng.randn(6, 4) * 0.1).astype(np.float16) for _ in range(4)]
    kw = dict(learning_rate=0.1, momentum=0.9, wd=1e-3,
              multi_precision=True, rescale_grad=0.5, clip_gradient=1.0)
    opt_l = opt.create("sgd", **kw)
    upd = opt.get_updater(opt_l)
    w_l = nd.array(w0.copy(), ctx=tmx.cpu())
    for g in grads:
        upd(0, nd.array(g, ctx=tmx.cpu()), w_l)
    opt_f = opt.create("sgd", **kw)
    assert tree_opt.supports_fused(opt_f)
    w_f = nd.array(w0.copy(), ctx=tmx.cpu())
    idx = {"w": 0}
    params = {"w": w_f._data}
    state = tree_opt.init_tree_state(opt_f, {"w": w_f}, idx)
    fn = tree_opt.make_tree_update(opt_f)
    for g in grads:
        ts, lrs, wds = tree_opt.host_hyper(opt_f, ["w"], idx)
        fn({"w": torch.from_numpy(g)}, params, state, lrs, wds, ts)
    np.testing.assert_array_equal(w_f.asnumpy(), w_l.asnumpy())
    np.testing.assert_array_equal(state["w"][1].numpy(),
                                  upd.states[0][1].asnumpy())


def test_host_hyper_keeps_per_index_counts():
    import math
    o = opt.create("adam", learning_rate=0.01)
    o._index_update_count = {0: 5}
    o.num_update = 5
    ts, lrs, _ = tree_opt.host_hyper(o, ["a", "b"], {"a": 0, "b": 1})
    assert ts == {"a": 6, "b": 1}
    for n in ("a", "b"):
        t = ts[n]
        want = 0.01 * math.sqrt(1.0 - o.beta2 ** t) / (1.0 - o.beta1 ** t)
        assert abs(lrs[n] - want) < 1e-12


def test_fused_sparse_embedding_is_not_ported():
    """Row-sparse Embedding gradients are ported now (queue A item 12c):
    the bind gives the weight a row-sparse gradient container of the ids'
    slot count, not a dense table, and the fused step takes its pairs."""
    e = sym.Embedding(sym.var("data"), input_dim=10, output_dim=4,
                      sparse_grad=True, name="emb")
    out = sym.SoftmaxOutput(sym.FullyConnected(sym.mean(e, axis=1),
                                               num_hidden=3, name="fc"),
                            name="softmax")
    ex = out.simple_bind(ctx=tmx.cpu(), data=(5, 6), softmax_label=(5,))
    g = ex.grad_dict["emb_weight"]
    assert g.stype == "row_sparse" and g.shape == (10, 4)
    mod = tmx.Module(out, context=tmx.cpu())
    mod.bind([("data", (5, 6))], [("softmax_label", (5,))])
    mod.init_params()
    mod.init_optimizer(optimizer="sgd", optimizer_params={"momentum": 0.9})
    batch = tmx.io.DataBatch(
        [tmx.nd.array(np.arange(30).reshape(5, 6) % 7, ctx=tmx.cpu())],
        [tmx.nd.array(np.arange(5) % 3, ctx=tmx.cpu())])
    w0 = mod.get_params()[0]["emb_weight"].asnumpy()
    mod.forward_backward_update(batch)
    assert mod.fused_step is not None
    w1 = mod.get_params()[0]["emb_weight"].asnumpy()
    np.testing.assert_array_equal(w1[7:], w0[7:])       # ids 7-9 unseen
    assert not np.array_equal(w1[:7], w0[:7])


def test_fused_resume_interop_both_directions(tmp_path):
    """save -> load -> resume crosses the fused/legacy boundary and the
    package boundary both ways and lands on the same parameters."""
    opt_params = {"learning_rate": 0.01}
    batches = {k: _toy_batches(mx, seed=2) for k, mx in PKGS.items()}
    init = {k: _mlp_init(mx, seed=2) for k, mx in PKGS.items()}
    trained = {}
    for pkg, mx in PKGS.items():
        for fused in (True, False):
            mod = _run_module(fused, _mlp(mx), init[pkg], batches[pkg],
                              "adam", opt_params, n_steps=3, mx=mx)
            f = str(tmp_path / ("%s-%d.states" % (pkg, fused)))
            mod.save_optimizer_states(f)
            trained[(pkg, fused)] = (mod, f)
    _assert_close(trained[("port", True)][0], trained[("port", False)][0],
                  **TOL["float32"])

    def resume(mx, fused, src):
        mod0, states = trained[src]
        args, _ = mod0.get_params()
        args = {k: _cpu_nd(mx, v.asnumpy()) for k, v in args.items()}
        os.environ["MXNET_MODULE_FUSED_STEP"] = "1" if fused else "0"
        try:
            mod = mx.Module(_mlp(mx), context=mx.cpu())
            mod.bind([("data", (16, 8))], [("softmax_label", (16,))])
            mod.init_params(arg_params=args)
            mod.init_optimizer(optimizer="adam",
                               optimizer_params=dict(opt_params))
            mod.load_optimizer_states(states)
            pkg = "jax" if mx is jmx else "port"
            for i in range(3, 6):
                mod.forward_backward_update(batches[pkg][i % 4])
        finally:
            os.environ.pop("MXNET_MODULE_FUSED_STEP", None)
        return mod

    ref = resume(tmx, True, ("port", True))
    for mx, fused, src in ((tmx, False, ("port", True)),
                           (tmx, True, ("port", False)),
                           (tmx, True, ("jax", True)),
                           (jmx, True, ("port", True)),
                           (jmx, True, ("port", False))):
        _assert_close(resume(mx, fused, src), ref, **TOL["float32"])


def test_fused_states_serialize_in_legacy_format(tmp_path):
    import pickle
    fused = _run_module(True, _mlp(), _mlp_init(seed=3),
                        _toy_batches(seed=3), "adam",
                        {"learning_rate": 0.01}, n_steps=4)
    legacy = _run_module(False, _mlp(), _mlp_init(seed=3),
                         _toy_batches(seed=3), "adam",
                         {"learning_rate": 0.01}, n_steps=4)
    f = str(tmp_path / "o.states")
    fused.save_optimizer_states(f)
    with open(f, "rb") as fh:
        blob = pickle.loads(fh.read())
    assert blob["__format__"] == 2 and blob["opt_class"] == "Adam"
    payload = blob["states"]
    assert set(payload) == set(legacy._updater.states)
    for i, s in legacy._updater.states.items():
        kind, entries = payload[i]
        assert kind == "tuple"
        for got, want in zip(entries, s):
            np.testing.assert_allclose(got[1], want.asnumpy(),
                                       **TOL["float32"])
    # the JAX package's Updater reads the file
    upd = jmx.optimizer.get_updater(jmx.optimizer.create("adam"))
    upd.set_states(open(f, "rb").read())
    assert set(upd.states) == set(payload)


def test_fused_step_is_one_program_per_bound_shape():
    """After its first step the fused path builds nothing and calls no
    per-parameter update: the same program runs every step."""
    mod = _run_module(True, _mlp(), _mlp_init(seed=4), _toy_batches(seed=4),
                      "sgd", {"learning_rate": 0.1, "momentum": 0.9},
                      n_steps=2)
    program = mod.fused_step
    calls = []
    real = mod._updater.__call__
    mod._updater.__call__ = lambda *a: (calls.append(a), real(*a))
    os.environ["MXNET_MODULE_FUSED_STEP"] = "1"
    try:
        mod.forward_backward_update(_toy_batches(seed=4)[0])
    finally:
        os.environ.pop("MXNET_MODULE_FUSED_STEP", None)
    assert mod.fused_step is program and not calls
    assert program.captures == 0       # the CPU runs the program eagerly


def test_fused_disabled_by_env_falls_back():
    mod = _run_module(False, _mlp(), _mlp_init(seed=6), _toy_batches(seed=6),
                      "sgd", {"learning_rate": 0.1}, n_steps=2)
    assert mod._fused is None
    assert mod._updater.states


def test_subclass_forward_backward_overrides_fall_back():
    calls = {"backward": 0}

    class ClipModule(tmx.Module):
        def backward(self, out_grads=None):
            calls["backward"] += 1
            super().backward(out_grads)

    os.environ["MXNET_MODULE_FUSED_STEP"] = "1"
    try:
        mod = ClipModule(_mlp(), context=tmx.cpu())
        mod.bind([("data", (16, 8))], [("softmax_label", (16,))])
        mod.init_params(arg_params=_mlp_init(seed=11))
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params={"learning_rate": 0.1})
        assert not mod._fused_ok()
        for b in _toy_batches(seed=11)[:3]:
            mod.forward_backward_update(b)
    finally:
        os.environ.pop("MXNET_MODULE_FUSED_STEP", None)
    assert mod._fused is None
    assert calls["backward"] == 3


def test_fused_unsupported_optimizer_falls_back():
    assert not tree_opt.supports_fused(opt.create("lbsgd"))
    assert not tree_opt.supports_fused(opt.create("sgld"))
    mod = _run_module(True, _mlp(), _mlp_init(seed=7), _toy_batches(seed=7),
                      "lbsgd", {"learning_rate": 0.1}, n_steps=2)
    assert mod._fused is None


def test_fused_multi_device_partial_matches_single_device():
    ref = _run_module(False, _mlp(), _mlp_init(seed=8), _toy_batches(seed=8),
                      "sgd", {"learning_rate": 0.1, "momentum": 0.9},
                      n_steps=4)
    par = _run_module(True, _mlp(), _mlp_init(seed=8), _toy_batches(seed=8),
                      "sgd", {"learning_rate": 0.1, "momentum": 0.9},
                      n_steps=4, contexts=[tmx.cpu(0), tmx.cpu(1)])
    assert par._fused and par._fused["mode"] == "partial"
    _assert_close(ref, par, **TOL["float32"])


def _bn_net(mx=tmx):
    s = mx.sym
    c = s.Convolution(s.var("data"), kernel=(3, 3), num_filter=4,
                      name="conv")
    a = s.Activation(s.BatchNorm(c, name="bn"), act_type="relu")
    fc = s.FullyConnected(s.Flatten(a), num_hidden=3, name="fc")
    return s.SoftmaxOutput(fc, name="softmax")


def test_fused_batchnorm_aux_and_mixed_interleave():
    """BatchNorm's moving statistics update inside the fused step, and
    fused steps interleaved with legacy ones share one optimizer state;
    the JAX package's fused run agrees."""
    rng = np.random.RandomState(9)
    X = rng.randn(64, 1, 8, 8).astype(np.float32)
    Y = rng.randint(0, 3, 64).astype(np.float32)
    seed = tmx.Module(_bn_net(), context=tmx.cpu())
    seed.bind([("data", (16, 1, 8, 8))], [("softmax_label", (16,))])
    seed.init_params(tmx.init.Xavier())
    args, aux = seed.get_params()

    def run(schedule, mx=tmx):
        batches = [mx.io.DataBatch(
            data=[_cpu_nd(mx, X[i * 16:(i + 1) * 16])],
            label=[_cpu_nd(mx, Y[i * 16:(i + 1) * 16])]) for i in range(4)]
        mod = mx.Module(_bn_net(mx), context=mx.cpu())
        mod.bind([("data", (16, 1, 8, 8))], [("softmax_label", (16,))])
        mod.init_params(
            arg_params={k: _cpu_nd(mx, v.asnumpy()) for k, v in args.items()},
            aux_params={k: _cpu_nd(mx, v.asnumpy()) for k, v in aux.items()})
        mod.init_optimizer(optimizer="sgd", optimizer_params={
            "learning_rate": 0.1, "momentum": 0.9})
        try:
            for i, fused in enumerate(schedule):
                os.environ["MXNET_MODULE_FUSED_STEP"] = "1" if fused else "0"
                mod.forward_backward_update(batches[i % 4])
        finally:
            os.environ.pop("MXNET_MODULE_FUSED_STEP", None)
        return mod

    legacy = run([False] * 6)
    fused = run([True] * 6)
    mixed = run([True, False, True, False, True, False])
    _assert_close(legacy, fused, **TOL["float32"])
    _assert_close(legacy, mixed, **TOL["float32"])
    _assert_close(fused, run([True] * 6, jmx), rtol=1e-4, atol=1e-5)
    assert not np.array_equal(_params(fused)["aux:bn_moving_mean"],
                              aux["bn_moving_mean"].asnumpy())


def test_fused_rebuilds_on_hyper_mutation():
    def run(fused):
        mod = _run_module(fused, _mlp(), _mlp_init(seed=11),
                          _toy_batches(seed=11), "sgd",
                          {"learning_rate": 0.1, "momentum": 0.9},
                          n_steps=3)
        mod._optimizer.rescale_grad = 0.5
        mod._optimizer.momentum = 0.5
        os.environ["MXNET_MODULE_FUSED_STEP"] = "1" if fused else "0"
        try:
            for b in _toy_batches(seed=11)[:3]:
                mod.forward_backward_update(b)
        finally:
            os.environ.pop("MXNET_MODULE_FUSED_STEP", None)
        return mod
    legacy, fused = run(False), run(True)
    assert fused._fused["hyper"][0] == 0.5
    _assert_close(legacy, fused, **TOL["float32"])


def test_fused_step_draws_anew_when_num_update_stalls():
    """Each fused step draws new Dropout masks, whatever a shared
    optimizer's stalled num_update says: at lr 0 two steps on one batch
    give different outputs."""
    s = sym
    net = s.Dropout(s.FullyConnected(s.var("data"), num_hidden=16,
                                     name="fc1"), p=0.5)
    net = s.SoftmaxOutput(s.FullyConnected(net, num_hidden=4, name="fc2"),
                          name="softmax")
    mod = _run_module(True, net, _mlp_init(seed=12), _toy_batches(seed=12),
                      "sgd", {"learning_rate": 0.0}, n_steps=1)
    mod._optimizer.num_update = 100
    outs = []
    os.environ["MXNET_MODULE_FUSED_STEP"] = "1"
    try:
        for _ in range(2):
            mod.forward_backward_update(_toy_batches(seed=12)[1])
            outs.append(mod.get_outputs()[0].asnumpy().copy())
    finally:
        os.environ.pop("MXNET_MODULE_FUSED_STEP", None)
    assert mod._optimizer.num_update == 100
    assert not np.array_equal(outs[0], outs[1])


@pytest.mark.parametrize("optimizer", ["nag", "signum"])
def test_fused_momentum_raised_from_zero_mid_run(optimizer):
    def run(fused):
        mod = _run_module(fused, _mlp(), _mlp_init(seed=14),
                          _toy_batches(seed=14), optimizer,
                          {"learning_rate": 0.05, "momentum": 0.0},
                          n_steps=2)
        mod._optimizer.momentum = 0.9
        os.environ["MXNET_MODULE_FUSED_STEP"] = "1" if fused else "0"
        try:
            for b in _toy_batches(seed=14)[2:]:
                mod.forward_backward_update(b)
        finally:
            os.environ.pop("MXNET_MODULE_FUSED_STEP", None)
        return mod
    _assert_close(run(False), run(True), **TOL["float32"])


def test_nonfinite_guard_skips_the_step_bit_exactly():
    """A batch with a NaN leaves weights, momenta and BatchNorm's moving
    statistics bit-identical on the fused and the legacy path; the
    divergence action fires after max_consecutive bad steps."""
    rng = np.random.RandomState(15)
    X = rng.randn(16, 1, 8, 8).astype(np.float32)
    Y = rng.randint(0, 3, 16).astype(np.float32)
    bad = X.copy()
    bad[0, 0, 0, 0] = np.nan
    good_b = DataBatch(data=[nd.array(X, ctx=tmx.cpu())],
                       label=[nd.array(Y, ctx=tmx.cpu())])
    bad_b = DataBatch(data=[nd.array(bad, ctx=tmx.cpu())],
                      label=[nd.array(Y, ctx=tmx.cpu())])
    for fused in ("1", "0"):
        os.environ["MXNET_MODULE_FUSED_STEP"] = fused
        try:
            mod = tmx.Module(_bn_net(), context=tmx.cpu())
            mod.bind([("data", (16, 1, 8, 8))], [("softmax_label", (16,))])
            mod.init_params(tmx.init.Xavier())
            mod.init_optimizer(optimizer="sgd", optimizer_params={
                "learning_rate": 0.1, "momentum": 0.9})
            mod.set_nonfinite_guard(True, max_consecutive=2)
            mod.forward_backward_update(good_b)
            before = _params(mod)
            moms = [s.asnumpy() for s in mod._updater.states.values()
                    if s is not None]
            mod.forward_backward_update(bad_b)
            assert mod.nonfinite_skipped == 1
            _assert_close(_params(mod), before, rtol=0, atol=0)
            for m, s in zip(moms, [s for s in mod._updater.states.values()
                                   if s is not None]):
                np.testing.assert_array_equal(s.asnumpy(), m)
            from mxnet_tpu_torch.resilience import DivergenceError
            with pytest.raises(DivergenceError):
                mod.forward_backward_update(bad_b)
        finally:
            os.environ.pop("MXNET_MODULE_FUSED_STEP", None)


def test_not_ported_paths_raise():
    with pytest.raises(MXNetError, match="item 16"):
        tmx.Module(_mlp(), context=tmx.cpu(), group2ctxs={"a": tmx.cpu()})
    mod = tmx.Module(_mlp(), context=tmx.cpu())
    mod.bind([("data", (16, 8))], [("softmax_label", (16,))])
    mod.init_params()
    with pytest.raises(MXNetError, match="item 14"):
        mod.init_optimizer(kvstore="dist_sync")
    with pytest.raises(MXNetError, match="item 14"):
        mod.elastic_tick()
    with pytest.raises(MXNetError, match="item 15"):
        mod.job_state()
    data, labels = _toy_data(n=32, dim=8)
    # the device prefetcher is ported (queue A item 13): fit trains
    mod.fit(NDArrayIter(data, labels, batch_size=16), num_epoch=1,
            device_prefetch=2)
    with pytest.raises(MXNetError, match="item 15"):
        mod.fit(NDArrayIter(data, labels, batch_size=16), num_epoch=1,
                resume_from="latest")


# -- checkpoints across the packages --------------------------------------

@pytest.mark.parametrize("src", ["jax", "port"])
def test_checkpoint_and_states_cross_packages(tmp_path, src):
    """A Module checkpoint with optimizer states written by one package
    loads into the other, whose next step equals the writer's."""
    dst = "port" if src == "jax" else "jax"
    batches = {k: _toy_batches(mx, seed=16) for k, mx in PKGS.items()}
    opt_params = {"learning_rate": 0.1, "momentum": 0.9}
    prefix = str(tmp_path / "x")
    writer = _run_module(True, _mlp(PKGS[src]), _mlp_init(PKGS[src], seed=16),
                         batches[src], "sgd", opt_params, n_steps=2,
                         mx=PKGS[src])
    writer.save_checkpoint(prefix, 2, save_optimizer_states=True)
    mx = PKGS[dst]
    kw = {"context": mx.cpu()}
    reader = mx.Module.load(prefix, 2, load_optimizer_states=True, **kw)
    reader.bind([("data", (16, 8))], [("softmax_label", (16,))])
    reader.init_optimizer(kvstore=None, optimizer="sgd",
                          optimizer_params=dict(opt_params))
    os.environ["MXNET_MODULE_FUSED_STEP"] = "1"
    try:
        writer.forward_backward_update(batches[src][2])
        reader.forward_backward_update(batches[dst][2])
    finally:
        os.environ.pop("MXNET_MODULE_FUSED_STEP", None)
    _assert_close(reader, writer, **TOL["float32"])


# -- the slice as a whole: a tiny transformer LM through Module.fit ----------

LM_CFG = dict(vocab=50, dim=64, heads=4, layers=2, max_seq=16,
              prefix="modlm0_")
LM_BATCH, LM_SEQ, LM_STEPS = 2, 16, 3


def _lm_module(mx, lm, params):
    net = lm(**LM_CFG)
    logits = net(mx.sym.var("data"))
    out = mx.sym.SoftmaxOutput(logits, mx.sym.var("softmax_label"),
                               preserve_shape=True, normalization="valid",
                               name="softmax")
    mod = mx.mod.Module(out, context=mx.cpu())
    return mod, {k: _cpu_nd(mx, v) for k, v in params.items()}


def test_transformer_lm_module_fit_matches_jax():
    from mxnet_tpu.gluon.model_zoo.transformer import get_transformer_lm \
        as jax_lm
    from mxnet_tpu_torch.gluon.model_zoo.transformer import \
        get_transformer_lm as port_lm
    rng = np.random.RandomState(17)
    x = rng.randint(2, LM_CFG["vocab"], (LM_BATCH * LM_STEPS, LM_SEQ))
    y = np.roll(x, 3, axis=1)
    y[:, :3] = 1
    x, y = x.astype(np.float32), y.astype(np.float32)
    net = jax_lm(**LM_CFG)
    net.initialize(jmx.init.Xavier(), ctx=jmx.cpu())
    net(jmx.nd.array(x[:LM_BATCH], ctx=jmx.cpu()))
    params = {k: p.data().asnumpy() for k, p in net.collect_params().items()}
    got = {}
    for pkg, mx, lm in (("jax", jmx, jax_lm), ("port", tmx, port_lm)):
        mod, args = _lm_module(mx, lm, params)
        seen = []
        mod.fit(mx.io.NDArrayIter(x, y, batch_size=LM_BATCH),
                eval_metric="perplexity", num_epoch=1, arg_params=args,
                optimizer="sgd",
                optimizer_params={"learning_rate": 0.05, "momentum": 0.9},
                batch_end_callback=lambda p: seen.append(
                    p.eval_metric.get()[1]))
        score = mod.score(mx.io.NDArrayIter(x, y, batch_size=LM_BATCH),
                          "perplexity")
        got[pkg] = (_params(mod), seen, score)
        if pkg == "port":
            assert mod._fused["mode"] == "full"
    _assert_close(got["port"][0], got["jax"][0], **LM_TOL)
    np.testing.assert_allclose(got["port"][1], got["jax"][1], rtol=1e-5)
    np.testing.assert_allclose(got["port"][2][0][1], got["jax"][2][0][1],
                               rtol=1e-5)
    assert got["port"][1][-1] < got["port"][1][0]


# -- ParallelTrainer: graph arguments with no Parameter behind them --------

def _state_net(mx):
    """Dense(4) plus a begin-state variable with no Parameter: a frozen
    graph argument, zero-filled at the shape inference gives it."""
    class StateNet(mx.gluon.HybridBlock):
        def __init__(self):
            super().__init__(prefix="statenet_")
            with self.name_scope():
                self.fc = mx.gluon.nn.Dense(4, in_units=6)

        def hybrid_forward(self, F, x):
            return self.fc(x) + F.var("statenet_begin_state")
    net = StateNet()
    net.initialize(ctx=mx.cpu())
    return net


def test_parallel_trainer_frozen_begin_state_matches_jax():
    import jax
    from mxnet_tpu.parallel.data_parallel import ParallelTrainer as JTrainer
    from mxnet_tpu.parallel.mesh import make_mesh as jmesh
    from mxnet_tpu_torch.parallel import ParallelTrainer, make_mesh
    rs = np.random.RandomState(18)
    w = rs.randn(4, 6).astype(np.float32) * 0.3
    trainers = {}
    for pkg, mx in PKGS.items():
        net = _state_net(mx)
        net.fc.weight.set_data(_cpu_nd(mx, w))
        mesh = jmesh({"dp": 1}, [jax.devices("cpu")[0]]) if pkg == "jax" \
            else make_mesh({"dp": 1}, [torch.device("cpu")])
        cls = JTrainer if pkg == "jax" else ParallelTrainer
        trainers[pkg] = cls(net, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                            optimizer="sgd", mesh=mesh,
                            optimizer_params={"learning_rate": 0.1,
                                              "momentum": 0.9})
    losses = {k: [] for k in PKGS}
    for batch in (8, 8, 8, 4):      # the last step changes the geometry
        x = rs.randn(batch, 6).astype(np.float32)
        y = rs.randint(0, 4, batch).astype(np.float32)
        for pkg, mx in PKGS.items():
            losses[pkg].append(float(np.asarray(trainers[pkg].fit_batch(
                _cpu_nd(mx, x), _cpu_nd(mx, y)))))
    np.testing.assert_allclose(losses["port"], losses["jax"],
                               **TOL["float32"])
    ttr, jtr = trainers["port"], trainers["jax"]
    assert ttr._frozen == jtr._frozen == {"statenet_begin_state"}
    assert ttr._opt_state["statenet_begin_state"] == ()
    state = ttr._params["statenet_begin_state"]
    assert tuple(state.shape) == (4, 4) and not state.any()
    for n in ttr.param_names:
        np.testing.assert_allclose(ttr._params[n].numpy(),
                                   np.asarray(jtr._params[n]), err_msg=n,
                                   **TOL["float32"])
