"""The serving fleet of the port: replica RPC surface, router failover,
circuit breaker, hedging, rolling deploy, warm start — the cases of
``tests/test_fleet.py`` on ``mxnet_tpu_torch`` — and the port held
against the JAX package: the same frame bytes, a port router in front of
a JAX replica and a JAX router in front of a port replica, the breaker
and the error codes alike, and one real two-process ``Fleet`` on the
CPU through a replica kill, a replace and a rolling deploy.

Replicas run in-process on ephemeral ports (scripted fake replicas for
the transport faults) and every model is on the CPU (``ctx=mx.cpu()``).
"""

import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import _kvstore_impl as jkv
from mxnet_tpu import serve as jserve
from mxnet_tpu.serve import replica as jreplica
from mxnet_tpu.serve import router as jrouter

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import _kvstore_impl as tkv
from mxnet_tpu_torch import model as model_mod
from mxnet_tpu_torch import sym
from mxnet_tpu_torch._kvstore_impl import (_connect_retry, _frame_bytes,
                                           _recv_frame, _send_frame)
from mxnet_tpu_torch.gluon.model_zoo.transformer import get_transformer_lm
from mxnet_tpu_torch.observability import events as obs_events
from mxnet_tpu_torch.observability import metrics as obs_metrics
from mxnet_tpu_torch.ops import _cuda
from mxnet_tpu_torch.resilience import chaos, servechaos
from mxnet_tpu_torch.serve import (BucketLadder, CircuitBreaker, Fleet,
                                   ModelRegistry, ReplicaDraining,
                                   ReplicaServer, Router, ServeError)
from mxnet_tpu_torch.serve import replica as replica_mod
from mxnet_tpu_torch.serve.fleet import parse_exposition
from mxnet_tpu_torch.serve.replica import (MSG_CANCEL, MSG_DRAIN, MSG_LOAD,
                                           MSG_PREDICT, MSG_REPLY, MSG_STATS)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIM = 6
BATCHES = (1, 2)
CPU = mx.cpu()


def _mlp(hidden=8):
    data = sym.var("data")
    net = sym.FullyConnected(data, num_hidden=hidden, name="h")
    return sym.softmax(net)


def _params_for(net, seed=0):
    rs = np.random.RandomState(seed)
    arg_shapes, _, _ = net.infer_shape(data=(1, DIM))
    return {n: mx.nd.array(rs.randn(*s).astype(np.float32) * 0.1, ctx=CPU)
            for n, s in zip(net.list_arguments(), arg_shapes)
            if n != "data"}


def _eager_refs(net, params, x):
    """x's rows zero-padded through the eager forward at every rung they
    could have been coalesced onto."""
    refs = []
    rows = x.shape[0]
    for b in BATCHES:
        if b < rows:
            continue
        padded = np.zeros((b, DIM), x.dtype)
        padded[:rows] = x
        args = dict(params)
        args["data"] = mx.nd.array(padded, ctx=CPU)
        ex = net.bind(CPU, args)
        refs.append(ex.forward()[0].asnumpy()[:rows])
    return refs


def _matches(out, refs):
    return any(np.array_equal(out, r) for r in refs)


def _rpc(sock, kind, meta, tensors=()):
    _send_frame(sock, kind, meta, tensors)
    k, m, t = _recv_frame(sock)
    assert k == MSG_REPLY
    return m, [np.array(x) for x in t]


def _connect(port):
    s = _connect_retry("127.0.0.1", port, time.monotonic() + 10)
    s.settimeout(30)
    return s


def _dead_port():
    """A port with nothing listening (dead-at-connect)."""
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _load(reg, net, params, name="m", ladder=BATCHES):
    reg.load(name, net, params, data_shapes={"data": (1, DIM)},
             ladder=BucketLadder(batches=ladder), ctx=CPU)


class FakeReplica:
    """Scripted wire-level replica for transport-fault drills:
    ``dead_mid_reply`` reads the request then closes; ``torn_reply``
    sends a half frame then closes; ``slow_ok`` answers PREDICT with
    canned tensors after a delay (and everything else with a bare ok) —
    the hedging straggler."""

    def __init__(self, behavior, reply=None, delay=0.0):
        self.behavior = behavior
        self.reply = reply
        self.delay = delay
        self.kinds = []         # every message kind received
        self._stop = threading.Event()
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind(("127.0.0.1", 0))
        self.port = self.sock.getsockname()[1]
        self.sock.listen(8)
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        self.sock.settimeout(0.2)
        while not self._stop.is_set():
            try:
                conn, _ = self.sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            t = threading.Thread(target=self._serve, args=(conn,),
                                 daemon=True)
            t.start()

    def _serve(self, conn):
        try:
            while True:
                kind, meta, tensors = _recv_frame(conn)
                self.kinds.append(kind)
                if self.behavior == "dead_mid_reply":
                    conn.close()
                    return
                if self.behavior == "torn_reply":
                    frame = _frame_bytes(
                        MSG_REPLY, {"status": "ok", "outputs": 1},
                        [np.zeros((1, DIM), np.float32)])
                    conn.sendall(frame[:12])
                    conn.close()
                    return
                # slow_ok
                if kind == MSG_PREDICT:
                    time.sleep(self.delay)
                    conn.sendall(_frame_bytes(
                        MSG_REPLY, {"status": "ok", "outputs": 1},
                        [self.reply]))
                else:
                    conn.sendall(_frame_bytes(MSG_REPLY,
                                              {"status": "ok"}, ()))
        except (ConnectionError, OSError, ValueError):
            return

    def stop(self):
        self._stop.set()
        try:
            self.sock.close()
        except OSError:
            pass


# ---------------------------------------------------------------------------
# shared in-process replica
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def kit(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fleet_kit")
    net = _mlp()
    params_v1 = _params_for(net, seed=0)
    params_v2 = _params_for(net, seed=1)
    prefix = str(tmp / "m")
    model_mod.save_checkpoint(prefix, 1, net, params_v1, {})
    model_mod.save_checkpoint(prefix, 2, net, params_v2, {})
    return {"net": net, "params_v1": params_v1, "params_v2": params_v2,
            "prefix": prefix, "tmp": tmp}


@pytest.fixture(scope="module")
def live_replica(kit):
    registry = ModelRegistry()
    _load(registry, kit["net"], kit["params_v1"])
    registry.batcher("m", max_wait_ms=1.0)
    rep = ReplicaServer(registry, http_port=0, ctx=CPU).start()
    yield rep
    rep.stop()
    registry.close()


@pytest.fixture
def armed():
    """Chaos on, the hard exit replaced by a recorder (a raise)."""
    class Exited(Exception):
        pass

    codes = []

    def _exit(code):
        codes.append(code)
        raise Exited(code)

    saved = servechaos._exit
    servechaos._exit = _exit
    try:
        yield codes, Exited
    finally:
        servechaos._exit = saved
        chaos.reset()


# ---------------------------------------------------------------------------
# circuit breaker
# ---------------------------------------------------------------------------

class TestCircuitBreaker:
    def test_open_half_open_close_cycle(self):
        clk = [0.0]
        b = CircuitBreaker(failures=2, cooldown=1.0, clock=lambda: clk[0])
        assert b.state == "closed" and b.allow()
        b.record_failure()
        assert b.state == "closed" and b.allow()
        b.record_failure()
        assert b.state == "open"
        assert not b.allow()
        clk[0] += 0.5
        assert not b.allow()            # still cooling
        clk[0] += 0.6
        assert b.state == "half_open"
        assert b.allow()                # the ONE trial
        assert not b.allow()            # trial in flight
        b.record_success()
        assert b.state == "closed" and b.allow()

    def test_half_open_failure_reopens(self):
        clk = [0.0]
        b = CircuitBreaker(failures=1, cooldown=1.0, clock=lambda: clk[0])
        b.record_failure()
        assert b.state == "open"
        clk[0] += 1.1
        assert b.allow()
        b.record_failure()              # trial failed
        assert b.state == "open"
        assert not b.allow()
        clk[0] += 1.1
        assert b.allow()
        b.record_success()
        assert b.state == "closed"

    def test_force_open_ejection(self):
        clk = [0.0]
        b = CircuitBreaker(failures=5, cooldown=1.0, clock=lambda: clk[0])
        b.force_open()
        assert b.state == "open" and not b.allow()
        clk[0] += 1.1
        assert b.allow()                # half-open rejoin trial

    @pytest.mark.parametrize("failures,cooldown", [(1, 0.5), (2, 1.0),
                                                   (3, 2.5)])
    def test_same_states_as_the_jax_breaker(self, failures, cooldown):
        """A seeded script of clock steps and calls gives both packages'
        breakers the same answers and states at every step."""
        rs = np.random.RandomState(failures)
        script = [(["allow", "success", "failure", "force_open",
                    "state"][rs.randint(5)], float(rs.rand() * cooldown))
                  for _ in range(200)]
        trace = {}
        for pkg, cls in (("port", CircuitBreaker),
                         ("jax", jrouter.CircuitBreaker)):
            clk = [0.0]
            b = cls(failures=failures, cooldown=cooldown,
                    clock=lambda: clk[0])
            out = []
            for call, dt in script:
                clk[0] += dt
                if call == "allow":
                    out.append(b.allow())
                elif call == "success":
                    b.record_success()
                elif call == "failure":
                    b.record_failure()
                elif call == "force_open":
                    b.force_open()
                out.append(b.state)
            trace[pkg] = out
        assert trace["port"] == trace["jax"]
        assert {"closed", "open", "half_open"} <= set(trace["port"])


# ---------------------------------------------------------------------------
# replica RPC surface
# ---------------------------------------------------------------------------

class TestReplicaRPC:
    def test_predict_roundtrip_bit_equal(self, kit, live_replica):
        rs = np.random.RandomState(7)
        x = rs.randn(2, DIM).astype(np.float32)
        refs = _eager_refs(kit["net"], kit["params_v1"], x)
        s = _connect(live_replica.port)
        try:
            meta, outs = _rpc(s, MSG_PREDICT,
                              {"model": "m", "inputs": ["data"],
                               "req": ["t-rt", 1, 1]}, [x])
        finally:
            s.close()
        assert meta["status"] == "ok"
        assert _matches(outs[0], refs)

    def test_idempotent_retry_exactly_once(self, live_replica):
        rs = np.random.RandomState(8)
        x = rs.randn(1, DIM).astype(np.float32)
        meta = {"model": "m", "inputs": ["data"], "req": ["t-idem", 1, 1]}
        s = _connect(live_replica.port)
        try:
            m1, o1 = _rpc(s, MSG_PREDICT, meta, [x])
            before = live_replica.predicts_dispatched
            m2, o2 = _rpc(s, MSG_PREDICT, meta, [x])    # retried id
        finally:
            s.close()
        assert m1["status"] == "ok" and m2["status"] == "ok"
        assert m2.get("dup") is True and "dup" not in m1
        assert live_replica.predicts_dispatched == before
        assert np.array_equal(o1[0], o2[0])

    def test_retry_on_fresh_connection_still_dedups(self, live_replica):
        rs = np.random.RandomState(9)
        x = rs.randn(1, DIM).astype(np.float32)
        meta = {"model": "m", "inputs": ["data"], "req": ["t-idem2", 5, 3]}
        s1 = _connect(live_replica.port)
        try:
            m1, o1 = _rpc(s1, MSG_PREDICT, meta, [x])
        finally:
            s1.close()      # the router reconnects on retry
        before = live_replica.predicts_dispatched
        s2 = _connect(live_replica.port)
        try:
            m2, o2 = _rpc(s2, MSG_PREDICT, meta, [x])
        finally:
            s2.close()
        assert m2.get("dup") is True
        assert live_replica.predicts_dispatched == before
        assert np.array_equal(o1[0], o2[0])

    def test_cancel_pins_window(self, live_replica):
        """A CANCEL for an id that never arrived pins the window: a LATE
        arrival of that id answers 'cancelled' from cache and is never
        dispatched (the hedge-loser contract)."""
        rs = np.random.RandomState(10)
        x = rs.randn(1, DIM).astype(np.float32)
        req = ["t-cancel", 1, 1]
        s = _connect(live_replica.port)
        try:
            m, _ = _rpc(s, MSG_CANCEL, {"req": req})
            assert m["status"] == "ok"
            before = live_replica.predicts_dispatched
            m2, _ = _rpc(s, MSG_PREDICT,
                         {"model": "m", "inputs": ["data"], "req": req},
                         [x])
        finally:
            s.close()
        assert m2["status"] == "err" and m2["code"] == "cancelled"
        assert live_replica.predicts_dispatched == before

    def test_stats_rpc(self, live_replica):
        s = _connect(live_replica.port)
        try:
            m, _ = _rpc(s, MSG_STATS, {})
        finally:
            s.close()
        assert m["status"] == "ok"
        assert m["predicts_dispatched"] >= 1
        assert m["compile_count"] == {"m": len(BATCHES)}
        # the port's additions: what the process ran on the card
        assert m["kernels"]["flash_fwd"] == {"wrapper": 0, "graph": 0}
        assert m["nvcc_seconds"] == 0.0 and m["peak_memory_bytes"] is None

    def test_unknown_model_typed(self, live_replica):
        s = _connect(live_replica.port)
        try:
            m, _ = _rpc(s, MSG_PREDICT,
                        {"model": "ghost", "inputs": ["data"],
                         "req": ["t-ghost", 1, 1]},
                        [np.zeros((1, DIM), np.float32)])
        finally:
            s.close()
        assert m["status"] == "err" and m["code"] == "serve"


# ---------------------------------------------------------------------------
# HTTP probe endpoint
# ---------------------------------------------------------------------------

def _get(port, path):
    try:
        with urllib.request.urlopen("http://127.0.0.1:%d%s" % (port, path),
                                    timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


class TestHttpProbe:
    def test_metrics_exposition(self, live_replica):
        status, body = _get(live_replica.http_port, "/metrics")
        assert status == 200
        parsed = parse_exposition(body)
        assert "mxnet_serve_requests_total" in parsed
        assert "mxnet_fleet_replica_requests_total" in parsed

    def test_healthz_readyz(self, live_replica):
        status, body = _get(live_replica.http_port, "/healthz")
        assert status == 200 and json.loads(body)["live"] is True
        status, body = _get(live_replica.http_port, "/readyz")
        assert status == 200
        payload = json.loads(body)
        assert payload["ready"] is True
        assert payload["models"] == {"m": "ready"}

    def test_unknown_path_404(self, live_replica):
        status, _ = _get(live_replica.http_port, "/nope")
        assert status == 404


# ---------------------------------------------------------------------------
# router failover
# ---------------------------------------------------------------------------

class TestRouterFailover:
    def test_dead_at_connect(self, kit, live_replica):
        router = Router([("127.0.0.1", _dead_port()),
                         ("127.0.0.1", live_replica.port)],
                        probe=False, retries=3)
        try:
            rs = np.random.RandomState(11)
            x = rs.randn(1, DIM).astype(np.float32)
            out = router.predict("m", {"data": x})
            assert _matches(out[0], _eager_refs(kit["net"],
                                                kit["params_v1"], x))
        finally:
            router.close()

    def test_dead_mid_reply(self, kit, live_replica):
        fake = FakeReplica("dead_mid_reply")
        router = Router([("127.0.0.1", fake.port),
                         ("127.0.0.1", live_replica.port)],
                        probe=False, retries=3)
        try:
            rs = np.random.RandomState(12)
            x = rs.randn(2, DIM).astype(np.float32)
            out = router.predict("m", {"data": x})
            assert _matches(out[0], _eager_refs(kit["net"],
                                                kit["params_v1"], x))
            assert MSG_PREDICT in fake.kinds    # it really was tried
        finally:
            router.close()
            fake.stop()

    def test_torn_reply_frame(self, kit, live_replica):
        fake = FakeReplica("torn_reply")
        router = Router([("127.0.0.1", fake.port),
                         ("127.0.0.1", live_replica.port)],
                        probe=False, retries=3)
        try:
            rs = np.random.RandomState(13)
            x = rs.randn(1, DIM).astype(np.float32)
            out = router.predict("m", {"data": x})
            assert _matches(out[0], _eager_refs(kit["net"],
                                                kit["params_v1"], x))
        finally:
            router.close()
            fake.stop()

    def test_all_dead_typed_error(self):
        router = Router([("127.0.0.1", _dead_port()),
                         ("127.0.0.1", _dead_port())],
                        probe=False, retries=3)
        try:
            with pytest.raises(ServeError):
                router.predict("m", np.zeros((1, DIM), np.float32))
        finally:
            router.close()

    def test_breaker_opens_after_repeated_failures(self, live_replica):
        dead = ("127.0.0.1", _dead_port())
        router = Router([dead, ("127.0.0.1", live_replica.port)],
                        probe=False, retries=2)
        try:
            rs = np.random.RandomState(14)
            # round-robin only offers the dead replica every other
            # request; 6 predicts guarantee >= 3 transport failures
            for _ in range(6):
                router.predict("m", rs.randn(1, DIM).astype(np.float32))
            dead_handle = router.replicas()["%s:%d" % dead]
            assert dead_handle.breaker.state in ("open", "half_open")
        finally:
            router.close()

    def test_partition_cuts_one_replica_and_fails_over(self, kit,
                                                       live_replica):
        """``fleet_partition_at`` with a port filter cuts the router's
        sends to one replica only: the request fails over, the other
        replica's traffic never counts."""
        rep2 = ReplicaServer(live_replica.registry, ctx=CPU).start()
        router = Router([("127.0.0.1", rep2.port),
                         ("127.0.0.1", live_replica.port)],
                        probe=False, retries=3)
        chaos.configure(fleet_partition_at=1, fleet_partition_for=100,
                        fleet_partition_port=rep2.port)
        try:
            rs = np.random.RandomState(20)
            for _ in range(4):
                x = rs.randn(1, DIM).astype(np.float32)
                out = router.predict("m", {"data": x})
                assert _matches(out[0], _eager_refs(kit["net"],
                                                    kit["params_v1"], x))
            assert rep2.requests_received == 0
        finally:
            chaos.reset()
            router.close()
            rep2.stop()


# ---------------------------------------------------------------------------
# heartbeat ejection / rejoin
# ---------------------------------------------------------------------------

class TestEjectRejoin:
    def test_eject_on_staleness_then_rejoin(self, live_replica):
        # second server over the SAME (warm) registry — stopping it does
        # not touch the module fixture
        rep2 = ReplicaServer(live_replica.registry, http_port=0,
                             ctx=CPU).start()
        router = Router([("127.0.0.1", rep2.port)], probe=False,
                        eject_timeout=0.2, probe_interval=0.05)
        try:
            router.probe_once()
            handle = next(iter(router.replicas().values()))
            assert handle.eligible("m")
            port = rep2.port
            rep2.stop()
            time.sleep(0.3)
            router.probe_once()     # stale past the eject timeout
            assert handle.ejected and not handle.eligible("m")
            assert handle.breaker.state in ("open", "half_open")
            # same port comes back (the replica process restarted)
            rep3 = ReplicaServer(live_replica.registry, port=port,
                                 http_port=0, ctx=CPU).start()
            try:
                deadline = time.monotonic() + 5
                while handle.ejected and time.monotonic() < deadline:
                    router.probe_once()
                    time.sleep(0.05)
                assert not handle.ejected
                assert handle.eligible("m")
            finally:
                rep3.stop()
        finally:
            router.close()


# ---------------------------------------------------------------------------
# hedging
# ---------------------------------------------------------------------------

def _hedged():
    return obs_metrics.snapshot()["fleet_requests_hedged_total"]["value"]


class TestHedging:
    def test_hedge_wins_and_loser_cancelled(self, kit, live_replica):
        """Primary is a straggler: the hedge fires after the hedge delay,
        the fast secondary's typed answer wins, the loser gets a CANCEL
        through the idempotency window, and each replica saw the request
        AT MOST once."""
        canned = np.full((1, DIM), 99.0, np.float32)
        fake = FakeReplica("slow_ok", reply=canned, delay=1.0)
        router = Router([("127.0.0.1", fake.port),
                         ("127.0.0.1", live_replica.port)],
                        probe=False, hedge_ms=40, retries=3)
        try:
            before_real = live_replica.requests_received
            rs = np.random.RandomState(15)
            x = rs.randn(1, DIM).astype(np.float32)
            out = router.predict("m", {"data": x})
            assert _matches(out[0], _eager_refs(kit["net"],
                                                kit["params_v1"], x))
            assert not np.array_equal(out[0], canned)
            assert _hedged() >= 1
            assert live_replica.requests_received == before_real + 1
            assert fake.kinds.count(MSG_PREDICT) == 1
            deadline = time.monotonic() + 5
            while MSG_CANCEL not in fake.kinds and \
                    time.monotonic() < deadline:
                time.sleep(0.02)
            assert MSG_CANCEL in fake.kinds
        finally:
            router.close()
            fake.stop()

    def test_no_hedge_when_primary_fast(self, live_replica):
        fake = FakeReplica("slow_ok", reply=np.zeros((1, DIM), np.float32),
                           delay=1.0)
        # live replica first: it answers well inside the hedge delay, so
        # the straggler never sees the request
        router = Router([("127.0.0.1", live_replica.port),
                         ("127.0.0.1", fake.port)],
                        probe=False, hedge_ms=5000, retries=2)
        try:
            before = _hedged()
            rs = np.random.RandomState(16)
            router.predict("m", rs.randn(1, DIM).astype(np.float32))
            assert _hedged() == before
            assert MSG_PREDICT not in fake.kinds
        finally:
            router.close()
            fake.stop()


# ---------------------------------------------------------------------------
# rolling deploy (in-process): zero dropped requests under load
# ---------------------------------------------------------------------------

def _replica_of(kit, params="params_v1", **kw):
    reg = ModelRegistry()
    _load(reg, kit["net"], kit[params])
    reg.batcher("m", max_wait_ms=1.0)
    return reg, ReplicaServer(reg, ctx=CPU, **kw).start()


class TestRollingDeploy:
    def test_zero_drop_with_concurrent_submitters(self, kit):
        regs, reps = zip(*[_replica_of(kit) for _ in range(2)])
        router = Router([("127.0.0.1", r.port) for r in reps],
                        probe=False, retries=4)
        rs = np.random.RandomState(17)
        xs = [rs.randn(rs.randint(1, 3), DIM).astype(np.float32)
              for _ in range(8)]
        refs = {i: (_eager_refs(kit["net"], kit["params_v1"], x)
                    + _eager_refs(kit["net"], kit["params_v2"], x))
                for i, x in enumerate(xs)}
        stop = threading.Event()
        failures = []
        answered = [0]
        lock = threading.Lock()

        def submitter(tid):
            n = 0
            while not stop.is_set():
                i = (tid + n) % len(xs)
                n += 1
                try:
                    out = router.predict("m", {"data": xs[i]})
                except Exception as exc:    # noqa: BLE001 - recorded
                    with lock:
                        failures.append("submitter %d: %r" % (tid, exc))
                    return
                if not _matches(out[0], refs[i]):
                    with lock:
                        failures.append(
                            "submitter %d: request %d not bit-equal to "
                            "v1 or v2 at any rung" % (tid, i))
                    return
                with lock:
                    answered[0] += 1

        threads = [threading.Thread(target=submitter, args=(t,),
                                    daemon=True) for t in range(4)]
        try:
            for t in threads:
                t.start()
            time.sleep(0.3)     # traffic flowing
            for key in sorted(router.replicas()):
                router.set_draining(key, True)
                stats, _ = router.control(key, MSG_DRAIN, {"timeout": 10})
                assert stats["timed_out"] is False
                assert stats["waited_requests"] >= 0
                rmeta, _ = router.control(
                    key, MSG_LOAD,
                    {"model": "m", "prefix": kit["prefix"], "epoch": 2,
                     "data_shapes": {"data": [1, DIM]},
                     "batches": list(BATCHES)})
                assert rmeta["status"] == "ok"
                router.set_draining(key, False)
                router.probe_once()
            time.sleep(0.3)     # post-deploy traffic
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=30)
            router.close()
            for rep in reps:
                rep.stop()
            for reg in regs:
                reg.close()
        assert not failures, failures
        assert answered[0] > 20

    def test_draining_replica_rerouted_not_errored(self, kit, live_replica):
        """A submit racing the drain gets the distinct 'draining' shed
        code and the router reroutes it instead of surfacing a typed
        error."""
        reg2, rep2 = _replica_of(kit)
        router = Router([("127.0.0.1", rep2.port),
                         ("127.0.0.1", live_replica.port)],
                        probe=False, retries=3)
        try:
            router.control("127.0.0.1:%d" % rep2.port, MSG_DRAIN,
                           {"timeout": 5})
            rs = np.random.RandomState(18)
            x = rs.randn(1, DIM).astype(np.float32)
            out = router.predict("m", {"data": x})   # rerouted
            assert _matches(out[0], _eager_refs(kit["net"],
                                                kit["params_v1"], x))
        finally:
            router.close()
            rep2.stop()
            reg2.close()

    def test_drain_resume_returns_replica_to_service(self, kit):
        """The aborted-deploy recovery path: a drained replica resumed
        via DRAIN{resume} serves again."""
        reg, rep = _replica_of(kit)
        router = Router([("127.0.0.1", rep.port)], probe=False, retries=2)
        try:
            key = "127.0.0.1:%d" % rep.port
            stats, _ = router.control(key, MSG_DRAIN, {"timeout": 5})
            assert stats["timed_out"] is False
            with pytest.raises(ReplicaDraining):
                router.predict("m", np.zeros((1, DIM), np.float32))
            rmeta, _ = router.control(key, MSG_DRAIN, {"resume": True})
            assert rmeta["resumed"] == ["m"]
            assert rep.draining is False
            rs = np.random.RandomState(19)
            x = rs.randn(1, DIM).astype(np.float32)
            out = router.predict("m", {"data": x})
            assert _matches(out[0], _eager_refs(kit["net"],
                                                kit["params_v1"], x))
            assert reg.health("m")["state"] == "ready"
        finally:
            router.close()
            rep.stop()
            reg.close()

    def test_all_draining_surfaces_typed(self, kit):
        reg, rep = _replica_of(kit)
        router = Router([("127.0.0.1", rep.port)], probe=False, retries=2)
        try:
            router.control("127.0.0.1:%d" % rep.port, MSG_DRAIN,
                           {"timeout": 5})
            with pytest.raises(ReplicaDraining):
                router.predict("m", np.zeros((1, DIM), np.float32))
        finally:
            router.close()
            rep.stop()
            reg.close()


# ---------------------------------------------------------------------------
# warm start: replicas share one kernel build directory
# ---------------------------------------------------------------------------

def _fake_nvcc(tmp_path):
    """An executable that stands in for nvcc: it writes ``-o``'s file."""
    path = tmp_path / "nvcc"
    path.write_text("#!%s\nimport sys\n"
                    "open(sys.argv[sys.argv.index('-o') + 1], 'w')"
                    ".write('lib')\nprint('ptxas info: built')\n"
                    % sys.executable)
    path.chmod(0o755)
    return str(path)


class TestWarmStart:
    def test_second_load_builds_no_kernel(self, kit, tmp_path,
                                          monkeypatch):
        """With a shared build directory the second process's kernel is
        already there: zero NEW files, zero nvcc seconds, and the second
        registry builds one program a rung as the first did."""
        cache_dir = str(tmp_path / "kernels")
        monkeypatch.setenv("MXNET_COMPILE_CACHE_DIR", cache_dir)
        monkeypatch.setenv("NVCC", _fake_nvcc(tmp_path))
        first = _cuda.build("flash_fwd")
        assert first["seconds"] > 0 and \
            os.path.dirname(first["path"]) == cache_dir
        files = sorted(os.listdir(cache_dir))
        spent = _cuda.nvcc_seconds()
        second = _cuda.build("flash_fwd")
        assert second["seconds"] == 0.0 and second["path"] == first["path"]
        assert sorted(os.listdir(cache_dir)) == files
        assert _cuda.nvcc_seconds() == spent
        regs = [ModelRegistry() for _ in range(2)]
        try:
            preds = [r.load("wm", kit["net"], kit["params_v1"],
                            data_shapes={"data": (1, DIM)},
                            ladder=BucketLadder(batches=BATCHES), ctx=CPU)
                     for r in regs]
            assert [p.compile_count for p in preds] == [len(BATCHES)] * 2
        finally:
            for r in regs:
                r.close()

    def test_fleet_shares_the_parents_build_directory(self, tmp_path,
                                                      monkeypatch):
        fleet = Fleet([], replicas=1, workdir=str(tmp_path), ctx=CPU,
                      router_kwargs={"probe": False})
        try:
            assert fleet.compile_cache_dir == _cuda.BUILD_DIR
        finally:
            fleet.stop()
        monkeypatch.setenv("MXNET_COMPILE_CACHE_DIR", str(tmp_path / "k"))
        fleet = Fleet([], replicas=1, workdir=str(tmp_path), ctx=CPU,
                      router_kwargs={"probe": False})
        try:
            assert fleet.compile_cache_dir == str(tmp_path / "k")
            spec = json.load(open(fleet._write_spec("r", [])))
            assert spec == {"name": "r", "models": [], "ctx": "cpu"}
        finally:
            fleet.stop()


# ---------------------------------------------------------------------------
# drain event (machine-readable drain record)
# ---------------------------------------------------------------------------

class TestDrainEvent:
    def test_drain_complete_event_carries_counts(self, kit, tmp_path,
                                                 monkeypatch):
        path = str(tmp_path / "events.jsonl")
        monkeypatch.setenv("MXNET_OBS", "serve")
        monkeypatch.setenv("MXNET_OBS_PATH", path)
        obs_events.configure()
        try:
            reg = ModelRegistry()
            # two rungs: a 1-row submit does NOT fill the top rung, so
            # the long coalescing window parks it in the queue until
            # drain() flips the batcher to dispatch-now
            _load(reg, kit["net"], kit["params_v1"])
            reg.batcher("m", max_wait_ms=500.0)
            fut = reg.submit("m", np.zeros((1, DIM), np.float32))
            assert reg.drain("m", timeout=10) is True
            fut.result(10)
            reg.unload("m", drain=True)
            evs = obs_events.read_events(path)
        finally:
            obs_events.configure()
        completes = [e for e in evs if e.get("ev") == "serve"
                     and e.get("kind") == "drain_complete"]
        assert len(completes) == 2      # drain() + unload(drain=True)
        drain_ev = completes[0]
        assert drain_ev["mode"] == "drain"
        assert drain_ev["waited_requests"] == 1
        assert drain_ev["timed_out"] is False
        unload_ev = completes[1]
        assert unload_ev["mode"] == "unload"
        assert unload_ev["timed_out"] is False

    def test_batcher_drain_stats_surface(self, kit):
        reg = ModelRegistry()
        _load(reg, kit["net"], kit["params_v1"], ladder=(1,))
        b = reg.batcher("m", max_wait_ms=1.0)
        assert b.last_drain_stats is None
        assert b.drain(timeout=5)
        assert b.last_drain_stats == {"waited_requests": 0,
                                      "timed_out": False}
        reg.unload("m", drain=False)


# ---------------------------------------------------------------------------
# misc plumbing, and the port against the JAX package
# ---------------------------------------------------------------------------

def test_parse_exposition():
    text = ("# HELP mxnet_a help\n"
            "# TYPE mxnet_a counter\n"
            "mxnet_a 3\n"
            "mxnet_b 1.5\n"
            "mxnet_h_bucket{le=\"0.1\"} 2\n")
    parsed = parse_exposition(text)
    assert parsed["mxnet_a"] == 3.0
    assert parsed["mxnet_b"] == 1.5


def test_fleet_event_category_registered():
    assert "fleet" in obs_events._CATEGORIES


def test_error_code_mapping():
    from mxnet_tpu_torch.serve.buckets import (DeadlineExceededError,
                                               OverloadError)
    assert replica_mod.error_code(OverloadError("x")) == "overload"
    assert replica_mod.error_code(ReplicaDraining("x")) == "draining"
    assert replica_mod.error_code(DeadlineExceededError("x")) == "deadline"
    assert replica_mod.error_code(ValueError("x")) == "internal"
    assert replica_mod.error_class("overload") is OverloadError
    assert replica_mod.error_class("draining") is ReplicaDraining


def test_error_codes_and_classes_alike_across_packages():
    from mxnet_tpu.serve import buckets as jb
    from mxnet_tpu.serve import kvpool as jkp
    from mxnet_tpu_torch.serve import buckets as tb
    from mxnet_tpu_torch.serve import kvpool as tkp
    pairs = [(jb.OverloadError, tb.OverloadError),
             (jb.DeadlineExceededError, tb.DeadlineExceededError),
             (jb.RequestCancelled, tb.RequestCancelled),
             (jb.ServeError, tb.ServeError),
             (jreplica.ReplicaDraining, ReplicaDraining),
             (jkp.KVPoolExhausted, tkp.KVPoolExhausted),
             (TimeoutError, TimeoutError), (ValueError, ValueError),
             (KeyError, KeyError)]
    for jcls, tcls in pairs:
        assert jreplica.error_code(jcls("x")) == \
            replica_mod.error_code(tcls("x"))
    for code in ("draining", "overload", "deadline", "cancelled",
                 "timeout", "serve", "internal", "unknown"):
        assert jreplica.error_class(code).__name__ == \
            replica_mod.error_class(code).__name__


def _seeded_messages():
    rs = np.random.RandomState(3)
    tensors = [rs.randn(3, 5).astype(np.float32),
               rs.randint(-9, 9, (4,)).astype(np.int32),
               rs.randn(2, 2, 2).astype(np.float64),
               rs.randint(0, 255, (7,)).astype(np.uint8),
               np.float32(2.5), np.zeros((0, 3), np.float32),
               rs.randn(300, 300).astype(np.float32)]     # > coalesce size
    return [(MSG_PREDICT, {"model": "m", "inputs": ["a", "b"],
                           "req": ["r", 7, 11]}, tensors[:2]),
            (MSG_REPLY, {"status": "ok", "outputs": 5}, tensors[2:]),
            (MSG_STATS, {}, ()), (MSG_REPLY, None, [tensors[0]])]


@pytest.mark.parametrize("i", range(4))
def test_frame_bytes_equal_the_jax_packages(i):
    kind, meta, tensors = _seeded_messages()[i]
    ours = tkv._frame_bytes(kind, meta, tensors)
    assert ours == jkv._frame_bytes(kind, meta, tensors)
    assert tkv._MAX_FRAME == jkv._MAX_FRAME
    assert tkv._COALESCE_BYTES == jkv._COALESCE_BYTES
    # and it parses back through both packages' readers
    for reader in (tkv._recv_frame, jkv._recv_frame):
        a, b = socket.socketpair()
        sender = threading.Thread(target=tkv._send_frame,
                                  args=(a, kind, meta, tensors))
        sender.start()      # a frame past the socket buffer blocks
        try:
            k, m, ts = reader(b)
        finally:
            sender.join(30)
            a.close()
            b.close()
        assert k == kind and m == (meta or {})
        assert len(ts) == len(tensors)
        for got, want in zip(ts, tensors):
            assert got.dtype == np.asarray(want).dtype
            assert np.array_equal(got, np.asarray(want))


# the interop LM: 2 layers at dim 64, exported by the port, loaded by both
LM = dict(vocab=50, dim=64, heads=4, layers=2, max_seq=16,
          prefix="fleetlm0_")
LM_SEQ = 8
LM_RUNGS = (1, 2)
LM_ATOL = 1e-5


@pytest.fixture(scope="module")
def lm_prefix(tmp_path_factory):
    import torch
    d = tmp_path_factory.mktemp("fleet_lm")
    net = get_transformer_lm(**LM)
    gen = torch.Generator().manual_seed(5)
    net.initialize(ctx=CPU, generator=gen)
    net.hybridize()
    net(mx.nd.array(np.zeros((1, LM_SEQ), np.float32), ctx=CPU))
    out = str(d / "lm")
    net.export(out, 0)
    return out


def _lm_tokens(rows, seed):
    return np.random.RandomState(seed).randint(
        0, LM["vocab"], (rows, LM_SEQ)).astype(np.float32)


def _lm_registry(pkg, prefix):
    serve, ctx = (jserve, jmx.cpu()) if pkg == "jax" else (mx.serve, CPU)
    reg = serve.ModelRegistry()
    reg.load_checkpoint("lm", prefix, 0, data_shapes={"data0": (1, LM_SEQ)},
                        ladder=serve.BucketLadder(batches=LM_RUNGS), ctx=ctx)
    reg.batcher("lm", max_wait_ms=1.0)
    return reg


@pytest.mark.parametrize("router_pkg,replica_pkg",
                         [("port", "jax"), ("jax", "port")])
def test_router_and_replica_of_the_two_packages_interoperate(
        lm_prefix, router_pkg, replica_pkg):
    """One package's router in front of the other's replica: each answer
    is bit-equal to the replica package's own in-process predict of the
    same rows, and within 1e-5 x max(1, max|logit|) of the other
    package's."""
    regs = {pkg: _lm_registry(pkg, lm_prefix) for pkg in ("jax", "port")}
    server_cls = jreplica.ReplicaServer if replica_pkg == "jax" \
        else ReplicaServer
    rep = server_cls(regs[replica_pkg]).start()
    router_cls = jrouter.Router if router_pkg == "jax" else Router
    router = router_cls([("127.0.0.1", rep.port)], probe=False)
    try:
        for rows, seed in ((1, 30), (2, 31), (1, 32)):
            x = _lm_tokens(rows, seed)
            got = router.predict("lm", {"data0": x})[0]
            own = regs[replica_pkg].predict("lm", x)[0].asnumpy()
            other = regs[router_pkg].predict("lm", x)[0].asnumpy()
            assert got.shape == (rows, LM_SEQ, LM["vocab"])
            assert np.array_equal(got, own)
            scale = max(1.0, float(np.abs(other).max()))
            assert float(np.abs(got - other).max()) <= LM_ATOL * scale
    finally:
        router.close()
        rep.stop()
        for reg in regs.values():
            reg.close()


# ---------------------------------------------------------------------------
# the fleet chaos keys
# ---------------------------------------------------------------------------

def test_replica_kill_at_exits_137_before_dispatch(armed, live_replica):
    codes, exited = armed
    chaos.configure(replica_kill_at=2)
    servechaos.on_replica_request("r")
    with pytest.raises(exited):
        servechaos.on_replica_request("r")
    assert codes == [137]
    servechaos.on_replica_request("r")      # only the K-th kills
    assert codes == [137]


def test_slow_replica_sleeps_the_first_n(armed, monkeypatch):
    slept = []
    monkeypatch.setattr(servechaos.time, "sleep", slept.append)
    chaos.configure(slow_replica_ms=250, slow_replica_for=2)
    for _ in range(3):
        servechaos.on_replica_request("r")
    assert slept == [0.25, 0.25]


def test_fleet_chaos_keys_idle_when_unarmed(armed):
    codes, _ = armed
    chaos.configure(decode_tick_raise_at=99)
    for _ in range(3):
        servechaos.on_replica_request("r")
        servechaos.on_replica_decode("r")
        servechaos.on_router_send("r", port=1)
    assert codes == []


# ---------------------------------------------------------------------------
# a real fleet of two replica processes on the CPU
# ---------------------------------------------------------------------------

def test_replica_without_cuda_and_without_ctx_refuses_to_start(
        kit, tmp_path):
    """The process entry serves on cuda:0 unless its spec says "ctx":
    "cpu": without CUDA it raises before any READY line."""
    spec = {"name": "r", "models": [{
        "name": "m", "prefix": kit["prefix"], "epoch": 1,
        "data_shapes": {"data": [1, DIM]}, "batches": list(BATCHES)}]}
    path = tmp_path / "spec.json"
    path.write_text(json.dumps(spec))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-c", "import sys; from mxnet_tpu_torch.serve."
         "replica import main; sys.exit(main())", "--spec", str(path)],
        capture_output=True, text=True, timeout=120, env=env, cwd=ROOT)
    assert out.returncode != 0
    assert "REPLICA READY" not in out.stdout
    assert "CUDA" in out.stderr


def test_two_process_fleet_kill_replace_deploy(kit, tmp_path):
    """Two replica processes on the CPU: a replica armed with
    ``replica_kill_at=2`` dies with 137 holding a request and the router
    fails it over; ``replace`` brings a successor; ``deploy`` moves both
    onto epoch 2 under concurrent traffic with zero dropped requests,
    answers v1-or-v2 during and v2 only after; every dispatch is
    counted exactly once across the replicas' STATS."""
    spec = {"name": "m", "prefix": kit["prefix"], "epoch": 1,
            "data_shapes": {"data": [1, DIM]}, "batches": list(BATCHES)}
    rs = np.random.RandomState(21)
    xs = [rs.randn(rs.randint(1, 3), DIM).astype(np.float32)
          for _ in range(6)]
    v1 = [_eager_refs(kit["net"], kit["params_v1"], x) for x in xs]
    v2 = [_eager_refs(kit["net"], kit["params_v2"], x) for x in xs]
    fleet = Fleet([spec], replicas=2, workdir=str(tmp_path),
                  max_wait_ms=1.0, ctx=CPU,
                  router_kwargs={"probe_interval": 0.2,
                                 "eject_timeout": 1.0})
    answered = [0]
    try:
        fleet.start()
        view = fleet.scrape()
        assert view["ready"] == view["size"] == 2
        # (a) arm one replica and let traffic kill it
        armed_key = fleet.replace(
            fleet.keys()[0],
            extra_env={"MXNET_CHAOS": "replica_kill_at=2"})
        for i in range(6):
            out = fleet.router.predict("m", {"data": xs[i]})
            assert _matches(out[0], v1[i])
            answered[0] += 1
        assert fleet.record(armed_key)["proc"].wait(30) == 137
        fleet.replace(armed_key)
        fleet.wait_routable(2)
        # (b) rolling deploy under two submitters
        stop = threading.Event()
        failures, after = [], []

        def submitter(tid):
            n = 0
            while not stop.is_set():
                i = (tid + n) % len(xs)
                n += 1
                try:
                    out = fleet.router.predict("m", {"data": xs[i]})
                except Exception as exc:    # noqa: BLE001 - recorded
                    failures.append(repr(exc))
                    return
                if not _matches(out[0], v1[i] + v2[i]):
                    failures.append("request %d matches neither" % i)
                answered[0] += 1

        threads = [threading.Thread(target=submitter, args=(t,),
                                    daemon=True) for t in range(2)]
        for t in threads:
            t.start()
        try:
            successors = fleet.deploy([dict(spec, epoch=2)])
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=60)
        assert not failures, failures
        assert sorted(successors) == fleet.keys()
        assert [r["timed_out"] for r in fleet.drain_records] == \
            [False] * len(fleet.drain_records)
        for i, x in enumerate(xs):
            out = fleet.router.predict("m", {"data": x})
            after.append(_matches(out[0], v2[i]))
            answered[0] += 1
        assert all(after)
        # exactly once: every answered request was dispatched once; the
        # killed replica dispatched K - 1 = 1 before it died
        live = [fleet.stats(k) for k in fleet.keys()]
        reaped = [r["final_stats"] for r in fleet.reaped()
                  if r["final_stats"] is not None]
        assert [r["rc"] for r in fleet.reaped()].count(137) == 1
        dispatched = sum(s["predicts_dispatched"] for s in live + reaped)
        assert dispatched + 1 == answered[0]
        assert sum(s["dup_hits"] for s in live + reaped) == 0
        assert all(s["nvcc_seconds"] == 0.0 for s in live + reaped)
    finally:
        fleet.stop()
    assert all(r["proc"].poll() is not None for r in fleet.reaped())
