"""gluon.Trainer and Module on a kvstore in the port: the cases of
``tests/test_examples.py:40-110`` on ``mxnet_tpu_torch``
(``examples/train_mnist.py --kv-store dist_sync`` through
``tools/launch.py``, run on the port, converging on every worker;
``Module`` with ``kvstore='local'`` over two contexts and with None),
then a ``Trainer(kvstore='dist_sync')`` job of two CPU workers against
one process's steps on the joined batch (within 1e-6 of max |w|, the
workers bit-equal to each other), also through ``allreduce_grads`` and
``update`` called on their own, a store object against the JAX
package's Trainer on the same weights, and ``Module.fit`` on
``dist_sync`` taking the legacy step.  Ports come from the OS; every subprocess has
its own timeout.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = mx.cpu()
PROC_TIMEOUT = 120


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env(n_workers, **extra):
    env = dict(os.environ)
    env.update({"DMLC_PS_ROOT_URI": "127.0.0.1",
                "DMLC_PS_ROOT_PORT": str(_free_port()),
                "DMLC_NUM_WORKER": str(n_workers), "JAX_PLATFORMS": "cpu"})
    env.pop("DMLC_ROLE", None)
    env.update({k: str(v) for k, v in extra.items()})
    return env


def _job(script, n_workers=2, **fmt):
    """One server (the bootstrap: ``import mxnet_tpu_torch`` under
    DMLC_ROLE=server re-execs into the server) and *n_workers* workers
    running *script*; every worker's RESULT record, by rank."""
    env = _env(n_workers)
    code = script.format(repo=ROOT, **fmt)
    server = subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path.insert(0, %r); "
         "import mxnet_tpu_torch" % ROOT],
        env=dict(env, DMLC_ROLE="server"), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE)
    workers = [subprocess.Popen(
        [sys.executable, "-c", code],
        env=dict(env, DMLC_ROLE="worker", DMLC_WORKER_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for r in range(n_workers)]
    recs = []
    try:
        for w in workers:
            out, err = w.communicate(timeout=PROC_TIMEOUT)
            assert w.returncode == 0, err.decode()[-3000:]
            line = [ln for ln in out.decode().splitlines()
                    if ln.startswith("RESULT ")][0]
            recs.append(json.loads(line[len("RESULT "):]))
        server.wait(timeout=30)
    finally:
        for p in workers + [server]:
            if p.poll() is None:
                p.kill()
                p.wait()
    return recs


# -- tests/test_examples.py:40-110 ---------------------------------------------

_MNIST_ON_PORT = r"""
import sys
sys.path.insert(0, {repo!r})
sys.path.insert(0, {repo!r} + "/examples")
import mxnet_tpu_torch as mx       # a server role re-execs here
# the example imports the package by its reference name
sys.modules["mxnet_tpu"] = mx
import train_mnist
sys.argv = ["train_mnist.py"] + {args!r}
with mx.cpu():
    sys.exit(train_mnist.main())
"""


def test_train_mnist_dist_sync_converges():
    """dist_lenet's analogue: tools/launch.py starts one server and two
    workers, each running examples/train_mnist.py on the port (server-side
    optimizer), and each must reach 0.9 train accuracy."""
    args = ["--network", "mlp", "--kv-store", "dist_sync",
            "--num-epochs", "2", "--num-examples", "2048",
            "--disp-batches", "50", "--min-accuracy", "0.9"]
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("DMLC_ROLE", None)
    r = subprocess.run(
        [sys.executable, "tools/launch.py", "-n", "2", "--",
         sys.executable, "-c", _MNIST_ON_PORT.format(repo=ROOT, args=args)],
        cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=PROC_TIMEOUT)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    accs = [float(ln.split()[-1]) for ln in r.stdout.splitlines()
            if ln.startswith("final train accuracy")]
    assert len(accs) == 2 and min(accs) >= 0.9, r.stdout[-2000:]


def _fc_module(pkg, hidden, dim, contexts):
    data = pkg.sym.var("data")
    fc = pkg.sym.FullyConnected(data=data, num_hidden=hidden, name="fc")
    out = pkg.sym.SoftmaxOutput(data=fc, name="softmax")
    rng = np.random.RandomState(0)
    x = rng.randn(8, dim).astype(np.float32)
    y = rng.randint(0, hidden, (8,)).astype(np.float32)
    it = pkg.io.NDArrayIter(data=x, label=y, batch_size=8,
                            label_name="softmax_label")
    mod = pkg.mod.Module(out, **contexts)
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params()
    return mod, next(iter(it))


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_module_kvstore_local_multi_device(pkg):
    """``init_optimizer(kvstore='local')`` over two contexts routes
    through the store (update_on_kvstore), and the replicas agree."""
    mxp = jmx if pkg == "jax" else mx
    mod, batch = _fc_module(mxp, 4, 6,
                            {"context": [mxp.cpu(0), mxp.cpu(1)]})
    mod.init_optimizer(kvstore="local",
                       optimizer_params={"learning_rate": 0.1})
    assert mod._kvstore is not None and mod._update_on_kvstore
    w0 = mod.get_params()[0]["fc_weight"].asnumpy().copy()
    for _ in range(3):
        mod.forward_backward(batch)
        mod.update()
    w1 = mod.get_params()[0]["fc_weight"].asnumpy()
    assert not np.allclose(w0, w1), "kvstore update path did not train"
    e0, e1 = mod._exec_group.execs
    np.testing.assert_allclose(e0.arg_dict["fc_weight"].asnumpy(),
                               e1.arg_dict["fc_weight"].asnumpy(),
                               rtol=1e-6)


def test_module_local_store_fused_and_store_steps_interleave():
    """Over two contexts with the local store, the fused step and the
    store's push/update/pull interleave on one state: fused, store,
    fused from the same start equals three store steps within 1e-6."""
    got = []
    for mix in (("fused", "store", "fused"), ("store",) * 3):
        mx.random.seed(3)
        mod, batch = _fc_module(mx, 4, 6,
                                {"context": [mx.cpu(0), mx.cpu(1)]})
        mod.init_optimizer(kvstore="local", optimizer_params={
            "learning_rate": 0.1, "momentum": 0.9})
        for how in mix:
            if how == "fused":
                mod.forward_backward_update(batch)
                assert mod._fused["mode"] == "partial"
            else:
                mod.forward_backward(batch)
                mod.update()
        got.append(mod.get_params()[0]["fc_weight"].asnumpy())
    np.testing.assert_allclose(got[0], got[1], atol=1e-6)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_module_kvstore_none_still_trains(pkg):
    mxp = jmx if pkg == "jax" else mx
    ctx = {"context": mx.cpu()} if pkg == "port" else {}
    mod, batch = _fc_module(mxp, 3, 5, ctx)
    mod.init_optimizer(kvstore=None, optimizer_params={"learning_rate": 0.1})
    assert mod._kvstore is None
    w0 = mod.get_params()[0]["fc_weight"].asnumpy().copy()
    mod.forward_backward(batch)
    mod.update()
    assert not np.allclose(w0, mod.get_params()[0]["fc_weight"].asnumpy())


# -- gluon.Trainer on a store -------------------------------------------------

def _mlp(seed):
    mx.random.seed(seed)
    net = mx.gluon.nn.HybridSequential(prefix="tn_")
    with net.name_scope():
        net.add(mx.gluon.nn.Dense(6, in_units=5, activation="relu"),
                mx.gluon.nn.Dense(3, in_units=6))
    net.initialize(mx.init.Uniform(0.5), ctx=CPU)
    return net


def _data():
    rs = np.random.RandomState(0)
    return (rs.randn(8, 5).astype(np.float32),
            rs.randint(0, 3, 8).astype(np.float32))


def _train(net, trainer, x, y, steps, batch, call="step", pkg=mx):
    """*steps* steps through ``trainer.step``, or with *call* 'split'
    through ``allreduce_grads`` then ``update``, or 'update' alone; *pkg*
    the package of *net* (the JAX package's arrays on its default
    device)."""
    kw = {"ctx": CPU} if pkg is mx else {}
    loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    for _ in range(steps):
        with pkg.autograd.record():
            loss = loss_fn(net(pkg.nd.array(x, **kw)),
                           pkg.nd.array(y, **kw))
        loss.backward()
        if call == "step":
            trainer.step(batch)
        else:
            if call == "split":
                trainer.allreduce_grads()
            trainer.update(batch)
    return {n: p.data().asnumpy() for n, p in net.collect_params().items()}


_TRAINER_WORKER = r"""
import os, sys, json
sys.path.insert(0, {repo!r})
sys.path.insert(0, {repo!r} + "/tests")
import mxnet_tpu_torch as mx
from test_torch_kvstore_train import _data, _mlp, _train
rank = int(os.environ["DMLC_WORKER_RANK"])
x, y = _data()
# the store is made at the first step, after its forward: the workers
# start from one seed, as a data-parallel job does
net = _mlp(1)
tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                      {{"learning_rate": 0.1, "momentum": 0.9, "wd": 0.01}},
                      kvstore="dist_sync", update_on_kvstore={uok})
half = slice(4 * rank, 4 * rank + 4)
w = _train(net, tr, x[half], y[half], 2, 4, {call!r})
print("RESULT " + json.dumps({{n: v.tolist() for n, v in w.items()}}),
      flush=True)
tr._kvstore.barrier()
if rank == 0:
    tr._kvstore.stop_server()
"""


@pytest.mark.parametrize("uok", [True, False])
def test_dist_sync_trainer_equals_the_joined_batch(uok):
    """Two CPU workers, each on half the batch, two steps of momentum
    SGD through ``Trainer(kvstore='dist_sync')`` (the optimizer on the
    server, or here on the pulled gradient sums): bit-equal to each
    other, and one process's two steps on the joined batch from the same
    weights within 1e-6 of max |w|."""
    _check_joined_batch(_job(_TRAINER_WORKER, uok=uok, call="step"))


@pytest.mark.parametrize("uok,call", [(False, "split"), (True, "update")])
def test_dist_sync_trainer_update_rescales_as_step(uok, call):
    """``allreduce_grads(); update(bs)`` (the clipping pattern, optimizer
    here) and ``update(bs)`` alone from the first step (optimizer on the
    server) rescale over the global batch as ``step(bs)`` does: the same
    joined-batch result."""
    _check_joined_batch(_job(_TRAINER_WORKER, uok=uok, call=call))


def _check_joined_batch(recs):
    x, y = _data()
    net = _mlp(1)
    want = _train(net, mx.gluon.Trainer(
        net.collect_params(), "sgd",
        {"learning_rate": 0.1, "momentum": 0.9, "wd": 0.01}), x, y, 2, 8)
    for name, w in want.items():
        a, b = (np.asarray(r[name], np.float32) for r in recs)
        np.testing.assert_array_equal(a, b)
        assert np.abs(a - w).max() <= 1e-6 * max(1.0, np.abs(w).max()), \
            name


def _jax_twin(net):
    """*net*'s architecture in the JAX package, with *net*'s weights."""
    twin = jmx.gluon.nn.HybridSequential(prefix="tn_")
    with twin.name_scope():
        twin.add(jmx.gluon.nn.Dense(6, in_units=5, activation="relu"),
                 jmx.gluon.nn.Dense(3, in_units=6))
    twin.initialize()
    src = net.collect_params()
    for name, p in twin.collect_params().items():
        p.set_data(jmx.nd.array(src[name].data().asnumpy()))
    return twin


def test_trainer_local_store_object():
    """A store object: the weights live in it, its Updater runs on
    push, and two momentum-SGD steps equal the JAX package's Trainer
    handed its own 'local' store object, on the same weights and batch,
    within 1e-6."""
    x, y = _data()
    opt_params = {"learning_rate": 0.1, "momentum": 0.9}
    net = _mlp(2)
    twin = _jax_twin(net)
    want = _train(twin, jmx.gluon.Trainer(
        twin.collect_params(), "sgd", dict(opt_params),
        kvstore=jmx.kv.create("local")), x, y, 2, 8, pkg=jmx)
    kv = mx.kv.create("local")
    tr = mx.gluon.Trainer(net.collect_params(), "sgd", dict(opt_params),
                          kvstore=kv)
    got = _train(net, tr, x, y, 2, 8)
    assert tr._kvstore is kv and tr._update_on_kvstore
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=1e-6)


_MODULE_WORKER = r"""
import os, sys, json
sys.path.insert(0, {repo!r})
import numpy as np
import mxnet_tpu_torch as mx
rank = int(os.environ["DMLC_WORKER_RANK"])
data = mx.sym.var("data")
fc = mx.sym.FullyConnected(data, num_hidden=3, name="fc")
out = mx.sym.SoftmaxOutput(fc, name="softmax")
rs = np.random.RandomState(0)
x = rs.randn(64, 5).astype(np.float32)
y = (x[:, 0] > 0).astype(np.float32) + (x[:, 1] > 0)
it = mx.io.NDArrayIter(x[rank::2], y[rank::2], batch_size=8,
                       label_name="softmax_label")
mod = mx.mod.Module(out, context=mx.cpu())
mod.fit(it, num_epoch=3, kvstore="dist_sync", optimizer="sgd",
        optimizer_params={{"learning_rate": 0.5, "momentum": 0.9}})
rec = {{"fused_none": mod.fused_step is None and mod._fused is None,
        "legacy": not mod._fused_ok(),
        "rescale": mod._optimizer.rescale_grad,
        "w": mod.get_params()[0]["fc_weight"].asnumpy().tolist(),
        "acc": dict(mod.score(it, "acc"))["accuracy"]}}
print("RESULT " + json.dumps(rec), flush=True)
mod._kvstore.barrier()
if rank == 0:
    mod._kvstore.stop_server()
"""


def test_module_fit_dist_sync_takes_the_legacy_step():
    """``Module.fit(kvstore='dist_sync')`` on two workers: every step is
    the legacy one (host RPCs), the gradients are rescaled over the
    global batch (1 / (8 x 2)), and both workers end on the same weights
    and learn."""
    recs = _job(_MODULE_WORKER)
    for r in recs:
        assert r["fused_none"] and r["legacy"]
        assert r["rescale"] == 1.0 / 16
        assert r["acc"] > 0.6
    np.testing.assert_array_equal(recs[0]["w"], recs[1]["w"])
