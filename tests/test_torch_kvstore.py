"""The KVStore of the port: the cases of ``tests/test_kvstore.py`` (but
its ``ParallelTrainer`` and mesh-collective cases, which wait for the
trainer over several devices, and its server-profiling case, whose
profiler is not ported) and the two kvstore cases of
``tests/test_sparse.py`` on ``mxnet_tpu_torch``, with every array on the
CPU (``ctx=mx.cpu()``).  The local and device store cases feed the same
seeded inputs to both packages' stores and hold the port's values to the
JAX package's; the 2-bit codes of both packages' op and of the port's
dist worker agree; the port's workers run through the JAX package's
server.

Every server and socket takes a port the OS assigns (the reference's
tests hold fixed ones and may run beside these), and every subprocess
has its own timeout.
"""

import os
import pickle
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import nd
from mxnet_tpu_torch._kvstore_impl import (
    _MSG_BARRIER, _MSG_CMD, _MSG_DEADQUERY, _MSG_HEARTBEAT, _MSG_INIT,
    _MSG_PULL, _MSG_PUSH, _MSG_SET_OPT, KVStoreServer, RPCTimeoutError,
    SyncTimeoutError, _connect_retry, _recv_frame, _rpc_call, _send_frame)
from mxnet_tpu_torch.ndarray import sparse
from mxnet_tpu_torch.observability import metrics
from mxnet_tpu_torch.resilience import chaos

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = mx.cpu()
PROC_TIMEOUT = 90


def _free_port(n=1):
    """A port p such that p .. p + n - 1 were all free a moment ago."""
    for _ in range(200):
        socks = []
        try:
            s = socket.socket()
            s.bind(("127.0.0.1", 0))
            socks.append(s)
            p = s.getsockname()[1]
            for k in range(1, n):
                t = socket.socket()
                t.bind(("127.0.0.1", p + k))
                socks.append(t)
            return p
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise RuntimeError("no run of %d free ports" % n)


def _dist_env(port, n_workers, **extra):
    env = dict(os.environ)
    env.update({"DMLC_PS_ROOT_URI": "127.0.0.1",
                "DMLC_PS_ROOT_PORT": str(port),
                "DMLC_NUM_WORKER": str(n_workers),
                "JAX_PLATFORMS": "cpu"})
    env.pop("DMLC_ROLE", None)
    env.update({k: str(v) for k, v in extra.items()})
    return env


def _server_proc(env, kv_type, package="mxnet_tpu_torch", server_id=0):
    return subprocess.Popen(
        [sys.executable, "-c",
         "import sys; sys.path.insert(0, %r);"
         "from %s.kvstore_server import run_server;"
         "run_server(%r)" % (ROOT, package, kv_type)],
        env=dict(env, DMLC_ROLE="server", DMLC_SERVER_ID=str(server_id)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def _worker_proc(env, rank, script, **fmt):
    return subprocess.Popen(
        [sys.executable, "-c", script.format(repo=ROOT, **fmt)],
        env=dict(env, DMLC_ROLE="worker", DMLC_WORKER_RANK=str(rank)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def _finish(workers, servers=()):
    """Every worker's stdout (each must exit 0 in time), then the
    servers reaped; a process past its timeout is killed."""
    outs = []
    try:
        for w in workers:
            stdout, stderr = w.communicate(timeout=PROC_TIMEOUT)
            assert w.returncode == 0, stderr.decode()[-3000:]
            outs.append(stdout.decode())
        for s in servers:
            s.wait(timeout=30)
    finally:
        for p in list(workers) + list(servers):
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def _result(out):
    line = [ln for ln in out.splitlines() if ln.startswith("RESULT")][0]
    return eval(line.split(" ", 2)[2])


# -- wire framing and connect ------------------------------------------------

def test_wire_frame_roundtrip():
    """Raw-buffer wire framing: dtypes, 0-d scalars, empty and
    multi-tensor frames all round-trip."""
    cases = [
        np.arange(12, dtype=np.float32).reshape(3, 4),
        np.array(7.0, np.float32),
        np.arange(5, dtype=np.int64),
        np.zeros((0, 3), np.float32),
        np.asfortranarray(np.arange(6.).reshape(2, 3)),
        np.arange(4, dtype=np.uint8),
    ]
    a, b = socket.socketpair()
    try:
        _send_frame(a, 42, {"key": "w", "n": 3}, cases)
        kind, meta, tensors = _recv_frame(b)
        assert kind == 42 and meta == {"key": "w", "n": 3}
        assert len(tensors) == len(cases)
        for got, want in zip(tensors, cases):
            assert got.shape == want.shape and got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
        _send_frame(b, 7)
        kind, meta, tensors = _recv_frame(a)
        assert kind == 7 and meta == {} and tensors == []
    finally:
        a.close()
        b.close()


def test_connect_retry_survives_refused_first_attempt():
    """A fresh socket per attempt: a listener that binds 1 s late is
    reached well before the deadline."""
    port = _free_port()
    ready = threading.Event()

    def late_bind():
        time.sleep(1.0)
        srv = socket.socket()
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind(("127.0.0.1", port))
        srv.listen(4)
        ready.set()
        srv.accept()
        srv.close()

    t = threading.Thread(target=late_bind, daemon=True)
    t.start()
    t0 = time.time()
    sock = _connect_retry("127.0.0.1", port, deadline=time.monotonic() + 30)
    try:
        assert ready.is_set()
        assert time.time() - t0 < 15
    finally:
        sock.close()
        t.join(timeout=5)


def test_connect_retry_deadline_raises():
    port = _free_port()
    t0 = time.time()
    with pytest.raises(OSError):
        _connect_retry("127.0.0.1", port, deadline=time.monotonic() + 1.0)
    assert time.time() - t0 < 10


# -- the local and device stores ---------------------------------------------
#
# Each case runs the same seeded inputs through the JAX package's store
# and the port's (``PKGS``): the port's pulled values equal the JAX
# package's within 1e-6 (sums of three float32 values, or one SGD step,
# the same order in both), and the reference test's own values hold.

PKGS = {"jax": jmx, "port": mx}
CLOSE = dict(rtol=1e-6, atol=1e-6)


def _nd(pkg, x):
    """Host array *x* as an NDArray of *pkg* (the port's on the CPU)."""
    kw = {"ctx": CPU} if pkg == "port" else {}
    return PKGS[pkg].nd.array(np.asarray(x, np.float32), **kw)


def _both(case):
    """``case(pkg)`` for both packages, checked equal; the port's."""
    got = {pkg: case(pkg) for pkg in PKGS}
    for a, b in zip(got["port"], got["jax"]):
        np.testing.assert_allclose(a, b, **CLOSE)
    return got["port"]


def test_local_push_pull():
    w0, w1 = np.random.RandomState(1).randn(2, 2, 3).astype(np.float32)

    def case(pkg):
        kv = PKGS[pkg].kv.create("local")
        kv.init(3, _nd(pkg, w0))
        out = _nd(pkg, np.zeros((2, 3)))
        kv.pull(3, out=out)
        first = out.asnumpy().copy()
        # push REPLACES without an updater (kvstore_local.h PushImpl)
        kv.push(3, _nd(pkg, w1))
        kv.pull(3, out=out)
        return first, out.asnumpy()

    first, pushed = _both(case)
    np.testing.assert_array_equal(first, w0)
    np.testing.assert_array_equal(pushed, w1)


def test_local_push_multiple_values():
    vals = np.random.RandomState(2).randn(3, 4).astype(np.float32)

    def case(pkg):
        kv = PKGS[pkg].kv.create("local")
        kv.init("w", _nd(pkg, np.zeros(4)))
        kv.push("w", [_nd(pkg, v) for v in vals])
        out = _nd(pkg, np.zeros(4))
        kv.pull("w", out=out)
        return (out.asnumpy(),)

    total, = _both(case)
    np.testing.assert_allclose(total, vals.sum(0), **CLOSE)


def test_local_updater():
    rs = np.random.RandomState(3)
    w0, g = rs.randn(2, 5).astype(np.float32)

    def case(pkg):
        kv = PKGS[pkg].kv.create("local")
        kv.init(9, _nd(pkg, w0))
        updates = []

        def updater(key, grad, weight):
            updates.append(key)
            weight -= 0.1 * grad

        kv.set_updater(updater)
        kv.push(9, _nd(pkg, g))
        assert updates == [9]
        out = _nd(pkg, np.zeros(5))
        kv.pull(9, out=out)
        custom = out.asnumpy()
        # an optimizer's Updater: two steps of momentum SGD with wd
        kv.set_optimizer(PKGS[pkg].optimizer.create(
            "sgd", learning_rate=0.1, momentum=0.9, wd=0.01))
        for _ in range(2):
            kv.push(9, _nd(pkg, g))
        kv.pull(9, out=out)
        return custom, out.asnumpy()

    custom, _ = _both(case)
    np.testing.assert_allclose(custom, w0 - 0.1 * g, **CLOSE)


def test_list_key_value():
    keys = [5, 7, 11]
    vals = np.random.RandomState(4).randn(3, 2).astype(np.float32)

    def case(pkg):
        kv = PKGS[pkg].kv.create("local")
        kv.init(keys, [_nd(pkg, v) for v in vals])
        kv.push(keys, [_nd(pkg, 2 * v) for v in vals])
        outs = [_nd(pkg, np.zeros(2)) for _ in keys]
        kv.pull(keys, out=outs)
        return [o.asnumpy() for o in outs]

    for got, v in zip(_both(case), vals):
        np.testing.assert_array_equal(got, 2 * v)


def _rsp_zeros(pkg, shape):
    kw = {"ctx": CPU} if pkg == "port" else {}
    return PKGS[pkg].nd.sparse.zeros("row_sparse", shape, **kw)


def test_row_sparse_pull():
    w = np.random.RandomState(5).randn(4, 3).astype(np.float32)

    def case(pkg):
        kv = PKGS[pkg].kv.create("local")
        kv.init("emb", _nd(pkg, w))
        out = _rsp_zeros(pkg, (4, 3))
        kv.row_sparse_pull("emb", out=out, row_ids=_nd(pkg, [1, 3]))
        return (out.asnumpy(),)

    dense, = _both(case)
    np.testing.assert_array_equal(dense[[1, 3]], w[[1, 3]])
    np.testing.assert_array_equal(dense[[0, 2]], 0)


@pytest.mark.parametrize("name", ["nccl", "tpu", "device",
                                  "local_allreduce_cpu",
                                  "local_allreduce_device"])
def test_device_store_reduces_values(name):
    """The reference's mesh case on one device: the 'nccl' store (and
    'tpu', the JAX package's name for it) sums the pushed values as the
    JAX package's store of that name does; several cards would reduce
    with torch.cuda.comm.reduce_add."""
    vals = np.random.RandomState(6).randn(4, 6).astype(np.float32)

    def case(pkg):
        kv = PKGS[pkg].kv.create(name)
        # the JAX package names its 'nccl' store 'tpu'
        assert pkg == "jax" or kv.type == name
        kv.init("g", _nd(pkg, np.zeros(6)))
        kv.push("g", [_nd(pkg, v) for v in vals])
        out = _nd(pkg, np.zeros(6))
        kv.pull("g", out=out)
        return (out.asnumpy(),)

    total, = _both(case)
    np.testing.assert_allclose(total, vals.sum(0), **CLOSE)


def test_create_rejects_unknown_names():
    with pytest.raises(mx.MXNetError):
        mx.kv.create("bogus")
    with pytest.raises(TypeError):
        mx.kv.create(3)


def test_gradient_compression_ops():
    from mxnet_tpu_torch.ops.quantization import pack_2bit, unpack_2bit
    g = nd.array([0.6, -0.7, 0.1, 0.0, 1.2], ctx=CPU)
    r = nd.zeros((5,), ctx=CPU)
    codes, new_r = nd.imperative_invoke("_contrib_quantize_2bit", g, r,
                                        threshold=0.5)
    np.testing.assert_allclose(codes.asnumpy(), [1, -1, 0, 0, 1])
    np.testing.assert_allclose(new_r.asnumpy(), [0.1, -0.2, 0.1, 0.0, 0.7],
                               rtol=1e-5)
    packed, n = pack_2bit(codes.asnumpy())
    np.testing.assert_allclose(unpack_2bit(packed, n), codes.asnumpy())


def test_gradient_compression_codes_match_the_jax_package():
    """The packed 2-bit codes of one seeded gradient are the JAX
    package's, byte for byte."""
    from mxnet_tpu.ops import quantization as jq
    from mxnet_tpu_torch.ops import quantization as tq
    codes = np.random.RandomState(5).randint(-1, 2, 1001).astype(np.int8)
    tp, tn = tq.pack_2bit(codes)
    jp, jn = jq.pack_2bit(codes)
    assert tn == jn and np.asarray(tp).tobytes() == np.asarray(jp).tobytes()
    np.testing.assert_array_equal(tq.unpack_2bit(tp, tn), codes)


def test_worker_compression_matches_the_op():
    """A dist worker's ``compress_2bit`` (what its push sends) gives the
    packed codes of both packages' ``_contrib_quantize_2bit`` on one
    seeded gradient and residual, and their residual within 1e-6."""
    from mxnet_tpu_torch._kvstore_impl import compress_2bit
    from mxnet_tpu_torch.ops.quantization import pack_2bit
    rs = np.random.RandomState(9)
    g = rs.randn(1001).astype(np.float32)
    r = (0.3 * rs.randn(1001)).astype(np.float32)
    packed, n, res = compress_2bit(g, r, 0.5)
    assert n == 1001
    for pkg in PKGS:
        codes, new_r = PKGS[pkg].nd.imperative_invoke(
            "_contrib_quantize_2bit", _nd(pkg, g), _nd(pkg, r),
            threshold=0.5)
        want = pack_2bit(codes.asnumpy().astype(np.int8))[0]
        assert np.asarray(packed).tobytes() == np.asarray(want).tobytes()
        np.testing.assert_allclose(res, new_r.asnumpy(), rtol=0, atol=1e-6)


def test_quantize_dequantize_int8():
    data = nd.array(np.linspace(-1, 1, 16).astype(np.float32), ctx=CPU)
    q, mn, mx_ = nd.imperative_invoke(
        "_contrib_quantize", data, nd.array([-1.0], ctx=CPU),
        nd.array([1.0], ctx=CPU), out_type="int8")
    back = nd.imperative_invoke("_contrib_dequantize", q, mn, mx_)
    np.testing.assert_allclose(back.asnumpy(), data.asnumpy(), atol=0.02)


# -- the two kvstore cases of tests/test_sparse.py ---------------------------

def test_rowsparse_pull_duplicate_ids_no_double_count():
    w = np.random.RandomState(7).randn(6, 2).astype(np.float32)

    def case(pkg):
        kv = PKGS[pkg].kv.create("local")
        kv.init("w", _nd(pkg, w))
        out = _rsp_zeros(pkg, (6, 2))
        kv.row_sparse_pull("w", out=out, row_ids=_nd(pkg, [2, 2, 4]))
        return (out.todense().asnumpy(),)

    dense, = _both(case)
    np.testing.assert_array_equal(dense[[2, 4]], w[[2, 4]])
    np.testing.assert_array_equal(dense[[0, 1, 3, 5]], 0)


def test_kvstore_local_rowsparse_push_pull():
    g = np.zeros((8, 2), np.float32)
    g[[2, 5]] = np.random.RandomState(8).randn(2, 2)

    def case(pkg):
        kv = PKGS[pkg].kv.create("local")
        kv.init("emb", _nd(pkg, np.zeros((8, 2))))
        kv.push("emb", PKGS[pkg].nd.sparse.compress_rowsparse(_nd(pkg, g)))
        out = _rsp_zeros(pkg, (8, 2))
        kv.row_sparse_pull("emb", out=out, row_ids=_nd(pkg, [2, 5, 6]))
        return (out.todense().asnumpy(),)

    dense, = _both(case)
    np.testing.assert_array_equal(dense, g)


# -- the parameter server, multi-process ---------------------------------------

_WORKER_SCRIPT = r"""
import os, sys
sys.path.insert(0, {repo!r})
import numpy as np
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import nd
c = mx.cpu()
rank = int(os.environ["DMLC_WORKER_RANK"])
kv = mx.kv.create(os.environ["KV_TYPE"])
kv.init("w", nd.zeros((4,), ctx=c))
if "async" in os.environ["KV_TYPE"]:
    # async applies through the server-side optimizer as pushes arrive:
    # grads of -(rank + 1) with SGD lr 1 make w = 1 + 2 = 3 in any order
    kv.set_optimizer(mx.optimizer.create(
        "sgd", learning_rate=1.0, rescale_grad=1.0, wd=0.0))
    kv.push("w", nd.ones((4,), ctx=c) * -(rank + 1))
else:
    kv.push("w", nd.ones((4,), ctx=c) * (rank + 1))
kv.barrier()
out = nd.zeros((4,), ctx=c)
kv.pull("w", out=out)
print("RESULT", rank, (out.asnumpy().tolist(), out.asnumpy().tobytes().hex()),
      flush=True)
kv.barrier()
if rank == 0:
    kv.stop_server()
"""


def _run_dist(kv_type, n_workers, package="mxnet_tpu_torch"):
    """Server (of *package*) + N port workers on localhost (reference:
    tools/launch.py --launcher local)."""
    env = _dist_env(_free_port(), n_workers, KV_TYPE=kv_type)
    server = _server_proc(env, kv_type, package)
    workers = [_worker_proc(env, r, _WORKER_SCRIPT)
               for r in range(n_workers)]
    return [_result(o) for o in _finish(workers, [server])]


@pytest.mark.parametrize("kv_type", ["dist_sync", "dist_async"])
def test_dist_kvstore(kv_type):
    """sync: both pushes aggregated before the apply, 1 + 2 = 3 on every
    worker; async: applied as they arrive, 3 after the barrier
    (reference: tests/nightly/dist_sync_kvstore.py)."""
    want = np.full(4, 3.0, np.float32).tobytes().hex()
    for vals, hexed in _run_dist(kv_type, 2):
        np.testing.assert_allclose(vals, [3.0] * 4)
        assert hexed == want


def test_dist_sync_through_the_jax_server():
    """The frame format is shared: the port's workers push and pull
    through the JAX package's server (no optimizer) and get the bytes of
    float32 [3, 3, 3, 3], as through the port's (``test_dist_kvstore``)."""
    want = np.full(4, 3.0, np.float32).tobytes().hex()
    for _, hexed in _run_dist("dist_sync", 2, package="mxnet_tpu"):
        assert hexed == want


_MULTISERVER_WORKER = r"""
import os, sys
sys.path.insert(0, {repo!r})
import numpy as np
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import nd
from mxnet_tpu_torch.ndarray import sparse
c = mx.cpu()
rank = int(os.environ["DMLC_WORKER_RANK"])
kv = mx.kv.create("dist_sync")
big = nd.array(np.arange(20, dtype=np.float32).reshape(4, 5), ctx=c)
kv.init("big", big)           # 20 elts > bound=10 -> sharded, 2 servers
kv.init("small", nd.zeros((3,), ctx=c))
# big sparse key: sparse keys are never sharded, their pushes ride the
# compact rsp wire to one hash-picked server
kv.init("emb", sparse.zeros("row_sparse", (6, 4), ctx=c))
kv.push("big", nd.ones((4, 5), ctx=c) * (rank + 1))
kv.push("small", nd.ones((3,), ctx=c) * (rank + 1))
grad = sparse.RowSparseNDArray(nd.ones((2, 4), ctx=c) * (rank + 1),
                               nd.array(np.array([1, 4], np.int32), ctx=c),
                               (6, 4))
kv.push("emb", grad)
kv.barrier()
out_b = nd.zeros((4, 5), ctx=c)
out_s = nd.zeros((3,), ctx=c)
kv.pull("big", out=out_b)
kv.pull("small", out=out_s)
out_e = sparse.zeros("row_sparse", (6, 4), ctx=c)
kv.row_sparse_pull("emb", out=out_e, row_ids=nd.array([1, 4], ctx=c))
print("RESULT", rank, (out_b.asnumpy().ravel().tolist(),
                       out_s.asnumpy().tolist(),
                       out_e.todense().asnumpy().ravel().tolist()),
      flush=True)
kv.barrier()
if rank == 0:
    kv.stop_server()
"""


def test_dist_multi_server_sharding():
    port = _free_port(2)
    env = _dist_env(port, 2, DMLC_NUM_SERVER=2,
                    MXNET_KVSTORE_BIGARRAY_BOUND=10)
    servers = [_server_proc(env, "dist_sync", server_id=s)
               for s in range(2)]
    workers = [_worker_proc(env, r, _MULTISERVER_WORKER) for r in range(2)]
    want = np.zeros((6, 4), np.float32)
    want[[1, 4]] = 3.0
    for out in _finish(workers, servers):
        big_vals, small_vals, emb_vals = _result(out)
        np.testing.assert_allclose(big_vals, [3.0] * 20)
        np.testing.assert_allclose(small_vals, [3.0] * 3)
        np.testing.assert_allclose(emb_vals, want.ravel())


_VICTIM_WORKER = r"""
import os, sys, time
sys.path.insert(0, {repo!r})
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import nd
kv = mx.kv.create("dist_async")
kv.push("w", nd.ones((4,), ctx=mx.cpu()) * -1.0)   # server sgd lr 1: w += 1
time.sleep({alive})                                  # heartbeats flow
# exit WITHOUT stop_server: a crash (heartbeats cease)
"""


class _EnvPatch:
    def __init__(self, env):
        self.env = env

    def __enter__(self):
        self.old = {k: os.environ.get(k) for k in self.env}
        os.environ.update(self.env)

    def __exit__(self, *exc):
        for k, v in self.old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def test_dist_dead_node_detection_and_rejoin():
    """Heartbeat failure detection and a stateless async rejoin."""
    env = _dist_env(_free_port(), 1, MXNET_KVSTORE_HEARTBEAT_INTERVAL=0.2)
    server = _server_proc(env, "dist_async")
    kv = None
    try:
        with _EnvPatch({k: env[k] for k in (
                "DMLC_PS_ROOT_URI", "DMLC_PS_ROOT_PORT", "DMLC_NUM_WORKER",
                "MXNET_KVSTORE_HEARTBEAT_INTERVAL")}):
            kv = mx.kv.create("dist_async")
        kv.init("w", nd.zeros((4,), ctx=CPU))
        kv.set_optimizer(mx.optimizer.create(
            "sgd", learning_rate=1.0, rescale_grad=1.0, wd=0.0))
        _finish([_worker_proc(env, 1, _VICTIM_WORKER, alive=1.0)])
        # the victim registered (timeout -1 counts every known node)
        assert kv.num_dead_node(timeout=-1) >= 2
        time.sleep(1.5)
        assert kv.num_dead_node(timeout=1.0) >= 1
        assert kv.num_dead_node(node_id=1, timeout=1.0) == 1
        # rejoin: the same rank reconnects statelessly and trains on; its
        # heartbeats refresh the node id while it lives (asked once its
        # push has applied, not after a wall-clock guess)
        rejoin = _worker_proc(env, 1, _VICTIM_WORKER, alive=3.0)
        deadline = time.monotonic() + PROC_TIMEOUT
        while kv.server_stats()["applies"] < 2 and \
                time.monotonic() < deadline:
            time.sleep(0.1)
        assert kv.num_dead_node(node_id=1, timeout=1.0) == 0
        out = nd.zeros((4,), ctx=CPU)
        kv.pull("w", out=out)
        np.testing.assert_allclose(out.asnumpy(), [2.0] * 4)
        _finish([rejoin])
    finally:
        if kv is not None:
            kv.stop_server()
        try:
            server.wait(timeout=30)
        finally:
            if server.poll() is None:
                server.kill()


_NO_CUDA_SERVER = r"""
import sys
sys.path.insert(0, {repo!r})
import torch
touched = []
real = torch.cuda._lazy_init
def _refuse():
    touched.append(1)
    raise RuntimeError("the kvstore server initialized CUDA")
torch.cuda._lazy_init = _refuse
from mxnet_tpu_torch.kvstore_server import run_server
run_server("dist_sync")
print("CUDA", bool(touched), torch.cuda.is_initialized(), flush=True)
"""

_OPT_WORKER = r"""
import os, sys
sys.path.insert(0, {repo!r})
import numpy as np
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import nd
from mxnet_tpu_torch.ndarray import sparse
c = mx.cpu()
rank = int(os.environ["DMLC_WORKER_RANK"])
kv = mx.kv.create("dist_sync")
kv.set_optimizer(mx.optimizer.create("sgd", learning_rate=0.5,
                                     momentum=0.9))
kv.init("w", nd.ones((3, 2), ctx=c))
kv.init("e", nd.zeros((5, 2), ctx=c))
kv.push("w", nd.ones((3, 2), ctx=c) * (rank + 1))
kv.push("e", sparse.RowSparseNDArray(
    nd.ones((2, 2), ctx=c), nd.array(np.array([1, 1], np.int32), ctx=c),
    (5, 2)))
kv.barrier()
w = nd.zeros((3, 2), ctx=c)
kv.pull("w", out=w)
e = sparse.zeros("row_sparse", (5, 2), ctx=c)
kv.row_sparse_pull("e", out=e, row_ids=nd.array([1, 2], ctx=c))
print("RESULT", rank, (w.asnumpy().tolist(), e.asnumpy().tolist()),
      flush=True)
kv.barrier()
if rank == 0:
    kv.stop_server()
"""


def test_server_never_initializes_cuda():
    """The server is a host process: a dist_sync job with a server-side
    momentum SGD, dense and row-sparse pushes (a repeated row id among
    them) and a row_sparse_pull never reaches ``torch.cuda._lazy_init``
    in the server."""
    env = _dist_env(_free_port(), 2, KV_TYPE="dist_sync")
    server = subprocess.Popen(
        [sys.executable, "-c", _NO_CUDA_SERVER.format(repo=ROOT)],
        env=dict(env, DMLC_ROLE="server", _MXTPU_SERVER_BOOT="1"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    workers = [_worker_proc(env, r, _OPT_WORKER) for r in range(2)]
    outs = _finish(workers)
    stdout, stderr = server.communicate(timeout=30)
    assert server.returncode == 0, stderr.decode()[-2000:]
    assert "CUDA False False" in stdout.decode(), stdout.decode()
    for out in outs:
        w, e = _result(out)
        # SGD with momentum, first step: w - lr * (g0 + g1) = 1 - 1.5
        np.testing.assert_allclose(w, np.full((3, 2), -0.5))
        # row 1 took both workers' two entries: 4 x 1 x 0.5
        np.testing.assert_allclose(e[1], [-2.0, -2.0])
        np.testing.assert_allclose(e[2], [0.0, 0.0])


# -- distributed fault tolerance (in-process servers) -----------------------

def _sgd_blob():
    return np.frombuffer(pickle.dumps(mx.optimizer.create(
        "sgd", learning_rate=1.0, rescale_grad=1.0, wd=0.0)), np.uint8)


def _spawn_server(sync_mode, num_workers, **kw):
    kw.setdefault("port", 0)
    srv = KVStoreServer(sync_mode=sync_mode, num_workers=num_workers, **kw)
    t = threading.Thread(target=srv.run, daemon=True)
    t.start()
    return srv, t


def _stop_inproc_server(srv, t):
    srv._stop.set()
    try:
        srv.sock.close()
    except OSError:
        pass
    t.join(timeout=10)


def _cli(port):
    return socket.create_connection(("127.0.0.1", port), timeout=30)


def _worker_env(monkeypatch, port, **extra):
    monkeypatch.setenv("DMLC_PS_ROOT_URI", "127.0.0.1")
    monkeypatch.setenv("DMLC_PS_ROOT_PORT", str(port))
    monkeypatch.setenv("DMLC_NUM_WORKER", "1")
    monkeypatch.delenv("DMLC_NUM_SERVER", raising=False)
    monkeypatch.delenv("DMLC_WORKER_RANK", raising=False)
    for k, v in extra.items():
        monkeypatch.setenv(k, str(v))


def test_push_dedup_applies_exactly_once():
    """A retried (rank, seq, incarnation) push is answered from the dedup
    window; a new incarnation with the same (rank, seq) applies."""
    srv, t = _spawn_server(False, 1)
    c = _cli(srv.port)
    try:
        _rpc_call(c, _MSG_SET_OPT, None, (_sgd_blob(),))
        _rpc_call(c, _MSG_INIT, {"key": "w"}, (np.zeros(4, np.float32),))
        grad = np.ones(4, np.float32) * -1
        hits0 = metrics.counter("kvstore_dedup_hits_total").value
        m1, _ = _rpc_call(c, _MSG_PUSH, {"key": "w", "req": [0, 1, 77]},
                          (grad,))
        m2, _ = _rpc_call(c, _MSG_PUSH, {"key": "w", "req": [0, 1, 77]},
                          (grad,))
        assert "dup" not in m1 and m2.get("dup") is True
        out = _rpc_call(c, _MSG_PULL, {"key": "w"})[1][0]
        np.testing.assert_allclose(out, np.ones(4))
        with srv.lock:
            assert srv.applies == 1
        assert metrics.counter("kvstore_dedup_hits_total").value == hits0 + 1
        m3, _ = _rpc_call(c, _MSG_PUSH, {"key": "w", "req": [0, 1, 88]},
                          (grad,))
        assert "dup" not in m3
        out = _rpc_call(c, _MSG_PULL, {"key": "w"})[1][0]
        np.testing.assert_allclose(out, np.full(4, 2.0))
        with srv.lock:
            assert srv.applies == 2
    finally:
        c.close()
        _stop_inproc_server(srv, t)


def test_dedup_window_bounded(monkeypatch):
    monkeypatch.setenv("MXNET_KVSTORE_DEDUP_WINDOW", "8")
    srv, t = _spawn_server(False, 1)
    c = _cli(srv.port)
    try:
        _rpc_call(c, _MSG_SET_OPT, None, (_sgd_blob(),))
        _rpc_call(c, _MSG_INIT, {"key": "w"}, (np.zeros(2, np.float32),))
        for seq in range(1, 30):
            _rpc_call(c, _MSG_PUSH, {"key": "w", "req": [0, seq, 5]},
                      (np.ones(2, np.float32),))
        with srv.lock:
            assert len(srv.dedup[(0, 5)]) <= 8
    finally:
        c.close()
        _stop_inproc_server(srv, t)


def test_sync_timeout_typed_error_names_laggard(monkeypatch):
    monkeypatch.setenv("MXNET_KVSTORE_SYNC_TIMEOUT", "0.6")
    monkeypatch.setenv("MXNET_KVSTORE_EVICT_TIMEOUT", "60")
    srv, t = _spawn_server(True, 2)
    c = _cli(srv.port)
    try:
        before = metrics.counter("kvstore_sync_timeouts_total").value
        _rpc_call(c, _MSG_HEARTBEAT, {"node": "worker1"})   # alive...
        with pytest.raises(SyncTimeoutError) as ei:
            _rpc_call(c, _MSG_PUSH, {"key": "w", "req": [0, 1, 1]},
                      (np.ones(2, np.float32),))
        assert "[1]" in str(ei.value)
        assert metrics.counter(
            "kvstore_sync_timeouts_total").value == before + 1
    finally:
        c.close()
        _stop_inproc_server(srv, t)


def test_eviction_unblocks_survivors_and_shrinks_dead_listing(monkeypatch):
    monkeypatch.setenv("MXNET_KVSTORE_SYNC_TIMEOUT", "1.0")
    monkeypatch.setenv("MXNET_KVSTORE_EVICT_TIMEOUT", "0.3")
    srv, t = _spawn_server(True, 2)
    c = _cli(srv.port)
    try:
        ev0 = metrics.counter("kvstore_evictions_total").value
        _rpc_call(c, _MSG_HEARTBEAT, {"node": "worker1"})   # then dies
        time.sleep(0.5)
        _rpc_call(c, _MSG_HEARTBEAT, {"node": "worker0"})   # survivor
        t0 = time.time()
        m, _ = _rpc_call(c, _MSG_PUSH, {"key": "w", "req": [0, 1, 1]},
                         (np.full(3, 5.0, np.float32),))
        assert m["status"] == "ok"
        assert time.time() - t0 < 6
        with srv.lock:
            assert srv.evicted == {1}
        out = _rpc_call(c, _MSG_PULL, {"key": "w"})[1][0]
        np.testing.assert_allclose(out, 5.0)
        assert metrics.counter("kvstore_evictions_total").value == ev0 + 1
        dq, _ = _rpc_call(c, _MSG_DEADQUERY, {"timeout": 0.2})
        assert dq["evicted"] == [1]
        assert "worker1" not in dq["dead"]
        _rpc_call(c, _MSG_BARRIER, {"rank": 0, "round": 1,
                                    "req": [0, 2, 1]})
        _rpc_call(c, _MSG_HEARTBEAT, {"node": "worker1"})   # rejoin
        with srv.lock:
            assert srv.evicted == set()
    finally:
        c.close()
        _stop_inproc_server(srv, t)


def test_server_snapshot_restore_and_dedup_persistence(tmp_path,
                                                       monkeypatch):
    """A restarted server restores store, optimizer state and dedup
    window from its snapshot."""
    monkeypatch.setenv("MXNET_KVSTORE_SNAPSHOT_PREFIX",
                       str(tmp_path / "kvsnap"))
    monkeypatch.setenv("MXNET_KVSTORE_SNAPSHOT_EVERY", "1")
    srv, t = _spawn_server(False, 1)
    c = _cli(srv.port)
    try:
        _rpc_call(c, _MSG_SET_OPT, None, (_sgd_blob(),))
        _rpc_call(c, _MSG_INIT, {"key": "w"}, (np.zeros(4, np.float32),))
        grad = np.ones(4, np.float32) * -1
        _rpc_call(c, _MSG_PUSH, {"key": "w", "req": [0, 1, 7]}, (grad,))
        _rpc_call(c, _MSG_PUSH, {"key": "w", "req": [0, 2, 7]}, (grad,))
        srv._ckpt.wait()
        tok_a = srv.epoch_token
    finally:
        c.close()
        _stop_inproc_server(srv, t)
    srv2, t2 = _spawn_server(False, 1)
    c2 = _cli(srv2.port)
    try:
        out = _rpc_call(c2, _MSG_PULL, {"key": "w"})[1][0]
        np.testing.assert_allclose(out, np.full(4, 2.0))
        with srv2.lock:
            assert srv2.applies == 2
            assert srv2.epoch_token == tok_a + 1
        m, _ = _rpc_call(c2, _MSG_PUSH, {"key": "w", "req": [0, 2, 7]},
                         (grad,))
        assert m.get("dup") is True
        out = _rpc_call(c2, _MSG_PULL, {"key": "w"})[1][0]
        np.testing.assert_allclose(out, np.full(4, 2.0))
        _rpc_call(c2, _MSG_PUSH, {"key": "w", "req": [0, 3, 7]}, (grad,))
        out = _rpc_call(c2, _MSG_PULL, {"key": "w"})[1][0]
        np.testing.assert_allclose(out, np.full(4, 3.0))
        # the newest two snapshots are kept
        assert len(srv2._ckpt.epochs()) == 2
    finally:
        c2.close()
        _stop_inproc_server(srv2, t2)


def test_rpc_timeout_typed_error():
    lst = socket.socket()
    lst.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    lst.bind(("127.0.0.1", 0))
    lst.listen(1)
    c = socket.create_connection(("127.0.0.1", lst.getsockname()[1]),
                                 timeout=5)
    c.settimeout(0.5)
    try:
        t0 = time.time()
        with pytest.raises(RPCTimeoutError):
            _rpc_call(c, _MSG_PULL, {"key": "x"})
        assert time.time() - t0 < 5
    finally:
        c.close()
        lst.close()


def test_rpc_retry_resends_same_id_after_dropped_reply(monkeypatch):
    """netchaos drops the reply of a computed push; the worker times
    out, reconnects, resends the same id and the dedup window answers:
    exactly one apply."""
    srv, t = _spawn_server(False, 1)
    _worker_env(monkeypatch, srv.port, MXNET_KVSTORE_RPC_TIMEOUT=1,
                MXNET_KVSTORE_CONNECT_TIMEOUT=20)
    kv = mx.kv.create("dist_async")
    try:
        kv.set_optimizer(mx.optimizer.create(
            "sgd", learning_rate=1.0, rescale_grad=1.0, wd=0.0))
        kv.init("w", nd.zeros((4,), ctx=CPU))
        chaos.configure(net_drop_reply=1)
        try:
            kv.push("w", nd.ones((4,), ctx=CPU) * -1)
            assert chaos.fired("net_drop_reply") == 1
        finally:
            chaos.reset()
        out = nd.zeros((4,), ctx=CPU)
        kv.pull("w", out=out)
        np.testing.assert_allclose(out.asnumpy(), np.ones(4))
        with srv.lock:
            assert srv.applies == 1
    finally:
        kv.stop_server()
        _stop_inproc_server(srv, t)


def test_worker_reinit_after_server_restart(monkeypatch):
    """A heartbeat epoch-token change: the worker re-inits the keys the
    new incarnation lost."""
    srv, t = _spawn_server(False, 1)
    port = srv.port
    _worker_env(monkeypatch, port, MXNET_KVSTORE_HEARTBEAT_INTERVAL=0.1,
                MXNET_KVSTORE_RPC_TIMEOUT=5,
                MXNET_KVSTORE_CONNECT_TIMEOUT=30)
    kv = None
    srv2 = t2 = None
    try:
        kv = mx.kv.create("dist_async")
        kv.init("w", nd.full((4,), 3.0, ctx=CPU))
        restarts0 = metrics.counter(
            "kvstore_server_restarts_detected_total").value
        _stop_inproc_server(srv, t)
        srv2, t2 = _spawn_server(False, 1, port=port)
        deadline = time.time() + 20
        while time.time() < deadline:
            with srv2.lock:
                if "w" in srv2.store:
                    break
            time.sleep(0.1)
        with srv2.lock:
            assert "w" in srv2.store, "worker never re-inited lost key"
        out = nd.zeros((4,), ctx=CPU)
        kv.pull("w", out=out)
        np.testing.assert_allclose(out.asnumpy(), np.full(4, 3.0))
        assert metrics.counter(
            "kvstore_server_restarts_detected_total").value > restarts0
    finally:
        if kv is not None:
            kv.stop_server()
        if srv2 is not None:
            _stop_inproc_server(srv2, t2)


def test_heartbeat_failures_counted_and_bounded(monkeypatch, caplog):
    """Heartbeats to a dead server are counted and WARN once per outage."""
    import logging
    srv, t = _spawn_server(False, 1)
    _worker_env(monkeypatch, srv.port,
                MXNET_KVSTORE_HEARTBEAT_INTERVAL=0.05,
                MXNET_KVSTORE_RPC_TIMEOUT=2,
                MXNET_KVSTORE_CONNECT_TIMEOUT=10)
    kv = mx.kv.create("dist_async")
    try:
        before = metrics.counter("kvstore_heartbeat_failures_total").value
        with caplog.at_level(logging.WARNING,
                             logger="mxnet_tpu_torch._kvstore_impl"):
            _stop_inproc_server(srv, t)
            deadline = time.time() + 10
            while time.time() < deadline and metrics.counter(
                    "kvstore_heartbeat_failures_total").value < before + 3:
                time.sleep(0.05)
        assert metrics.counter(
            "kvstore_heartbeat_failures_total").value >= before + 3
        warns = [r for r in caplog.records
                 if "heartbeat to server" in r.getMessage()
                 and r.levelno == logging.WARNING]
        assert len(warns) == 1, warns
    finally:
        kv.stop_server()


def test_abandoned_sync_round_fails_every_contributor(monkeypatch):
    monkeypatch.setenv("MXNET_KVSTORE_SYNC_TIMEOUT", "0.8")
    monkeypatch.setenv("MXNET_KVSTORE_EVICT_TIMEOUT", "60")
    srv, t = _spawn_server(True, 3)     # rank 2 never pushes
    c0, c1 = _cli(srv.port), _cli(srv.port)
    results = {}

    def push(rank, conn):
        try:
            _rpc_call(conn, _MSG_PUSH, {"key": "w", "req": [rank, 1, 1]},
                      (np.ones(2, np.float32),))
            results[rank] = "ok"
        except SyncTimeoutError:
            results[rank] = "timeout"
        except Exception as e:
            results[rank] = repr(e)
    try:
        _rpc_call(c0, _MSG_HEARTBEAT, {"node": "worker2"})   # alive
        ts = [threading.Thread(target=push, args=(0, c0)),
              threading.Thread(target=push, args=(1, c1))]
        for th in ts:
            th.start()
        for th in ts:
            th.join(timeout=30)
        assert results == {0: "timeout", 1: "timeout"}, results
        with srv.lock:
            assert srv.applies == 0
    finally:
        c0.close()
        c1.close()
        _stop_inproc_server(srv, t)


def test_server_profiler_commands_name_their_item():
    """The server's profiler:* commands wait on the port's profiler
    (queue A item 15): they answer with an error saying so."""
    srv, t = _spawn_server(True, 1)
    c = _cli(srv.port)
    try:
        for head in ("profiler:set_config", "profiler:set_state",
                     "profiler:dump"):
            with pytest.raises(mx.MXNetError, match="item 15"):
                _rpc_call(c, _MSG_CMD, {"head": head, "body": {}})
        # the channel stays usable
        st, _ = _rpc_call(c, _MSG_CMD, {"head": "stats"})
        assert st["applies"] == 0
    finally:
        c.close()
        _stop_inproc_server(srv, t)


def test_two_bit_compression_over_the_wire(monkeypatch):
    """A compressed dist push carries 2-bit codes with error feedback:
    the server applies threshold x codes, and the residual carries the
    rest into the next push (reference: gradient_compression.cc)."""
    srv, t = _spawn_server(True, 1)
    _worker_env(monkeypatch, srv.port)
    kv = mx.kv.create("dist_sync")
    try:
        kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
        kv.init("g", nd.zeros((5,), ctx=CPU))
        out = nd.zeros((5,), ctx=CPU)
        g = np.array([0.6, -0.7, 0.1, 0.0, 1.2], np.float32)
        kv.push("g", nd.array(g, ctx=CPU))
        kv.pull("g", out=out)
        np.testing.assert_allclose(out.asnumpy(), [0.5, -0.5, 0, 0, 0.5])
        kv.push("g", nd.array(g, ctx=CPU))
        kv.pull("g", out=out)
        # residual [0.1, -0.2, 0.1, 0, 0.7] + g crosses again where >= 0.5
        np.testing.assert_allclose(out.asnumpy(), [0.5, -0.5, 0, 0, 0.5])
        np.testing.assert_allclose(kv._residual["g"],
                                   [0.2, -0.4, 0.2, 0.0, 1.4], rtol=1e-6)
    finally:
        kv.stop_server()
        _stop_inproc_server(srv, t)
