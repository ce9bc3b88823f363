"""The device prefetcher of the PyTorch port
(``mxnet_tpu_torch/io/device_prefetch.py``), the ``fit(device_prefetch=)``
/ ``MXNET_DEVICE_PREFETCH`` wiring and the guard's deferred readbacks:
the cases of ``tests/test_device_prefetch.py`` that need no job state,
on a CPU target.  The card's copy-stream ordering is held by chip_smoke
phase 12 (f) and ``tests/test_torch_cuda.py``.

As in the JAX package's cases, training draws from mx.random's stream,
which the Module initializer draws from too."""

import hashlib

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import sym
from mxnet_tpu_torch.io import (DataBatch, DevicePrefetcher, NDArrayIter,
                                PrefetchingIter)
from mxnet_tpu_torch.io.device_prefetch import maybe_wrap
from mxnet_tpu_torch.observability import metrics as obs_metrics


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("MXNET_GUARD_READBACK_LAG", raising=False)
    monkeypatch.delenv("MXNET_DEVICE_PREFETCH", raising=False)


def _seed(s):
    mx.random.seed(s)


def _mlp():
    data = sym.var("data")
    net = sym.FullyConnected(data, num_hidden=16, name="fc1")
    net = sym.Activation(net, act_type="relu")
    net = sym.FullyConnected(net, num_hidden=4, name="fc2")
    return sym.SoftmaxOutput(net, name="softmax")


def _toy_data(n=64, nan_batch=None, batch=16):
    rng = np.random.RandomState(0)
    X = rng.randn(n, 8).astype(np.float32)
    Y = rng.randint(0, 4, n).astype(np.float32)
    if nan_batch is not None:
        X[nan_batch * batch:(nan_batch + 1) * batch] = np.nan
    return X, Y


def _toy_iter(n=64, batch=16, shuffle=False, nan_batch=None):
    X, Y = _toy_data(n, nan_batch, batch)
    return NDArrayIter(X, Y, batch_size=batch, shuffle=shuffle)


def _build_mod(seed=42, guard=False, max_consecutive=0):
    _seed(seed)
    mod = mx.Module(_mlp(), context=mx.cpu())
    mod.bind([("data", (16, 8))], [("softmax_label", (16,))])
    mod.init_params(mx.init.Xavier())
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.1,
                                         "momentum": 0.9})
    if guard:
        mod.set_nonfinite_guard(max_consecutive=max_consecutive)
    return mod


def _state_sha(mod):
    h = hashlib.sha256()
    args, auxs = mod.get_params()
    for k in sorted(args):
        h.update(k.encode())
        h.update(args[k].asnumpy().tobytes())
    for k in sorted(auxs):
        h.update(k.encode())
        h.update(auxs[k].asnumpy().tobytes())
    h.update(mod._updater.get_states())
    return h.hexdigest()


def _bad_batch():
    rng = np.random.RandomState(0)
    return DataBatch(
        data=[mx.nd.array(np.full((16, 8), np.nan, np.float32),
                          ctx=mx.cpu())],
        label=[mx.nd.array(rng.randint(0, 4, (16,)).astype(np.float32),
                           ctx=mx.cpu())])


# ---------------------------------------------------------------------------
# residency and elision
# ---------------------------------------------------------------------------

def test_batches_device_resident_and_bit_equal():
    plain = _toy_iter()
    pf = DevicePrefetcher(_toy_iter(), depth=3, device=mx.cpu())
    try:
        n = 0
        for a, b in zip(plain, pf):
            for x, y in zip(a.data + a.label, b.data + b.label):
                assert isinstance(y._data, torch.Tensor)
                assert y._data.device == torch.device("cpu")
                np.testing.assert_array_equal(x.asnumpy(), y.asnumpy())
            n += 1
        assert n == 4
    finally:
        pf.close()


def test_device_resident_batch_is_passed_through_and_counted():
    """A batch already on the target is handed on as it is (no copy) and
    counted in device_put_elided_total, data and label each step; the
    step loop then trains from it."""
    elided = obs_metrics.REGISTRY.get("device_put_elided_total")
    inner = list(_toy_iter())
    e0 = elided.value
    pf = DevicePrefetcher(_toy_iter(), depth=4, device="cpu")
    try:
        batches = [b for b in pf]
    finally:
        pf.close()
    assert elided.value - e0 == 2 * len(batches) == 8
    mod = _build_mod()
    for b, ref in zip(batches, inner):
        np.testing.assert_array_equal(b.data[0].asnumpy(),
                                      ref.data[0].asnumpy())
        mod.forward_backward_update(b)


def test_host_array_batches_are_wrapped_not_copied_twice():
    """Inner iterators that hand out numpy arrays get NDArrays on the
    target; the producer thread, not the consumer, does the wrap."""
    class Numpy:
        batch_size = 4
        provide_data = []
        provide_label = []

        def __init__(self):
            self.n = 0

        def reset(self):
            self.n = 0

        def next(self):
            if self.n == 2:
                raise StopIteration
            self.n += 1
            return DataBatch(data=[np.full((4, 2), self.n, np.float32)],
                             label=[np.zeros((4,), np.float32)])

    pf = DevicePrefetcher(Numpy(), depth=2, device=mx.cpu())
    try:
        got = [b.data[0].asnumpy()[0, 0] for b in pf]
    finally:
        pf.close()
    assert got == [1.0, 2.0]


def test_without_cuda_the_default_target_raises():
    with pytest.raises(mx.MXNetError, match="CUDA"):
        DevicePrefetcher(_toy_iter(), depth=2)
    if not torch.cuda.is_available():
        with pytest.raises(mx.MXNetError, match="CUDA"):
            DevicePrefetcher(_toy_iter(), depth=2,
                             device=torch.device("cuda"))


# ---------------------------------------------------------------------------
# three-way bit-exact equivalence
# ---------------------------------------------------------------------------

def _run_job(monkeypatch, wrap_depth=None, guard_lag=None, steps=8,
             nan_at=3):
    """One training job: toy iterator (optionally device-prefetched) with
    a NaN batch at step *nan_at*, guard armed, Accuracy updated per
    step.  Returns (state sha, skipped count, metric value)."""
    if guard_lag is not None:
        monkeypatch.setenv("MXNET_GUARD_READBACK_LAG", str(guard_lag))
    else:
        monkeypatch.delenv("MXNET_GUARD_READBACK_LAG", raising=False)
    mod = _build_mod(guard=True)
    it = _toy_iter(nan_batch=nan_at - 1)
    pf = None
    if wrap_depth:
        it = pf = DevicePrefetcher(it, depth=wrap_depth, device=mx.cpu())
    metric = mx.metric.create("acc")
    try:
        done = 0
        while done < steps:
            for batch in it:
                mod.forward_backward_update(batch)
                mod.update_metric(metric, batch.label)
                done += 1
                if done >= steps:
                    break
            it.reset()
        mod.drain_guard_readbacks()
    finally:
        if pf is not None:
            pf.close()
    return _state_sha(mod), mod.nonfinite_skipped, metric.get()


def test_three_way_bit_exact_equivalence(monkeypatch):
    """The same job through the plain iterator, the DevicePrefetcher, and
    the prefetcher with deferred guard readbacks: identical state and
    metrics.  The input pipeline and the readback lag change WHEN work
    happens, never WHAT is computed."""
    a = _run_job(monkeypatch)
    b = _run_job(monkeypatch, wrap_depth=2)
    c = _run_job(monkeypatch, wrap_depth=3, guard_lag=2)
    assert a == b == c
    assert a[1] == 2                     # the NaN batch, once an epoch


# ---------------------------------------------------------------------------
# deferred guard readbacks
# ---------------------------------------------------------------------------

def test_guard_readback_lag_defers_then_drains(monkeypatch):
    monkeypatch.setenv("MXNET_GUARD_READBACK_LAG", "3")
    mod = _build_mod(guard=True)
    bad = _bad_batch()
    for _ in range(3):
        mod.forward_backward_update(bad)
    assert len(mod._guard_pending) == 3
    assert mod._guard_skipped == 0
    mod.drain_guard_readbacks()
    assert len(mod._guard_pending) == 0
    assert mod._guard_skipped == 3


def test_guard_divergence_fires_within_lag_bound(monkeypatch):
    from mxnet_tpu_torch.resilience import DivergenceError
    lag, limit = 3, 2
    monkeypatch.setenv("MXNET_GUARD_READBACK_LAG", str(lag))
    mod = _build_mod(guard=True, max_consecutive=limit)
    bad = _bad_batch()
    fired_at = None
    with pytest.raises(DivergenceError):
        for i in range(limit + lag + 2):
            fired_at = i
            mod.forward_backward_update(bad)
    assert fired_at is not None and fired_at <= limit + lag


def test_guard_reconfigure_drains_under_old_config(monkeypatch):
    monkeypatch.setenv("MXNET_GUARD_READBACK_LAG", "4")
    mod = _build_mod(guard=True)
    mod.forward_backward_update(_bad_batch())
    assert len(mod._guard_pending) == 1
    mod.set_nonfinite_guard(enabled=False)
    assert len(mod._guard_pending) == 0
    assert mod._guard_skipped == 1


def test_guard_event_blames_dispatch_time_step(monkeypatch, tmp_path):
    from mxnet_tpu_torch.observability import events
    monkeypatch.setenv("MXNET_GUARD_READBACK_LAG", "3")
    monkeypatch.setenv("MXNET_OBS", "guard")
    monkeypatch.setenv("MXNET_OBS_PATH", str(tmp_path / "ev.jsonl"))
    events.configure()
    try:
        mod = _build_mod(guard=True)
        rng = np.random.RandomState(0)
        good = DataBatch(
            data=[mx.nd.array(rng.randn(16, 8).astype(np.float32),
                              ctx=mx.cpu())],
            label=[mx.nd.array(rng.randint(0, 4, (16,)).astype(np.float32),
                               ctx=mx.cpu())])
        bad = DataBatch(data=_bad_batch().data, label=good.label)
        mod.forward_backward_update(good)
        mod.forward_backward_update(bad)
        bad_step = mod._step_seq
        for _ in range(4):
            mod.forward_backward_update(good)
        mod.drain_guard_readbacks()
        guard_evs = [e for e in events.read_events(
            str(tmp_path / "ev.jsonl")) if e["ev"] == "guard"]
    finally:
        monkeypatch.delenv("MXNET_OBS", raising=False)
        monkeypatch.delenv("MXNET_OBS_PATH", raising=False)
        events.configure()
    assert len(guard_evs) == 1
    assert guard_evs[0]["step"] == bad_step


# ---------------------------------------------------------------------------
# fit()/env wiring
# ---------------------------------------------------------------------------

def test_fit_device_prefetch_knob_bit_exact(monkeypatch):
    def run(**kwargs):
        _seed(21)
        mod = mx.Module(_mlp(), context=mx.cpu())
        mod.fit(_toy_iter(), num_epoch=2, optimizer="sgd",
                optimizer_params={"learning_rate": 0.1}, **kwargs)
        return _state_sha(mod)

    plain = run()
    explicit = run(device_prefetch=2)
    monkeypatch.setenv("MXNET_DEVICE_PREFETCH", "3")
    via_env = run()
    disabled = run(device_prefetch=0)
    assert plain == explicit == via_env == disabled


def test_fit_three_batches_with_and_without_the_prefetcher():
    """The phase 12 (f) check on the CPU: three batches of fit with
    device_prefetch=2 and 0 from one set of weights and one order give
    bit-equal parameters, momenta and running statistics."""
    def net():
        data = sym.var("data")
        x = sym.Convolution(data, kernel=(3, 3), num_filter=4, pad=(1, 1),
                            name="c1")
        x = sym.BatchNorm(x, name="bn1")
        x = sym.Activation(x, act_type="relu")
        x = sym.Pooling(x, global_pool=True, pool_type="avg",
                        kernel=(1, 1))
        x = sym.FullyConnected(x, num_hidden=4, name="fc")
        return sym.SoftmaxOutput(x, name="softmax")

    rng = np.random.RandomState(3)
    X = rng.randn(24, 3, 8, 8).astype(np.float32)
    Y = rng.randint(0, 4, 24).astype(np.float32)

    def run(depth):
        _seed(5)
        mod = mx.Module(net(), context=mx.cpu())
        mod.fit(NDArrayIter(X, Y, batch_size=8), num_epoch=1,
                optimizer="sgd", device_prefetch=depth,
                optimizer_params={"learning_rate": 0.1, "momentum": 0.9})
        return _state_sha(mod)

    assert run(2) == run(0)


def test_fit_closes_the_prefetcher_it_made(monkeypatch):
    made = []
    real = DevicePrefetcher.close

    def spy(self):
        made.append(self)
        return real(self)

    monkeypatch.setattr(DevicePrefetcher, "close", spy)
    _seed(1)
    mod = mx.Module(_mlp(), context=mx.cpu())
    mod.fit(_toy_iter(), num_epoch=1, device_prefetch=2)
    assert len(made) == 1 and not made[0]._thread.is_alive()


def test_maybe_wrap_semantics(monkeypatch):
    it = _toy_iter()
    out, created = maybe_wrap(it, None, device=mx.cpu())
    assert out is it and not created
    monkeypatch.setenv("MXNET_DEVICE_PREFETCH", "2")
    out, created = maybe_wrap(it, None, device=mx.cpu())
    assert isinstance(out, DevicePrefetcher) and created
    out.close()
    out, created = maybe_wrap(_toy_iter(), 0, device=mx.cpu())
    assert not created
    pf = DevicePrefetcher(_toy_iter(), depth=2, device=mx.cpu())
    try:
        out, created = maybe_wrap(pf, True)
        assert out is pf and not created
    finally:
        pf.close()
    out, created = maybe_wrap(_toy_iter(), 2, decode_only=True)
    assert created and isinstance(out, PrefetchingIter)
    assert not isinstance(out, DevicePrefetcher)
    out.close()
    host_pf = PrefetchingIter(_toy_iter())
    try:
        out, created = maybe_wrap(host_pf, 2, decode_only=True)
        assert out is host_pf and not created
    finally:
        host_pf.close()


def test_close_stops_producer_and_reset_revives():
    pf = DevicePrefetcher(_toy_iter(), depth=2, device=mx.cpu())
    pf.next()
    thread = pf._thread
    pf.close()
    thread.join(timeout=5)
    assert not thread.is_alive()
    with pytest.raises(RuntimeError, match="after close"):
        pf.next()
    pf.reset()
    assert len(list(pf)) == 4
    pf.close()


def test_producer_exception_reaches_consumer_then_stops():
    class Exploding:
        batch_size = 16
        provide_data = []
        provide_label = []

        def __init__(self):
            self.n = 0

        def reset(self):
            pass

        def next(self):
            self.n += 1
            if self.n > 1:
                raise RuntimeError("decode failed")
            return DataBatch(
                data=[np.zeros((16, 8), np.float32)],
                label=[np.zeros((16,), np.float32)])

    pf = DevicePrefetcher(Exploding(), depth=2, device=mx.cpu())
    try:
        pf.next()
        with pytest.raises(RuntimeError, match="decode failed"):
            pf.next()
        with pytest.raises(StopIteration):
            pf.next()
    finally:
        pf.close()


def test_ring_instruments_observe_each_delivery():
    wait = obs_metrics.REGISTRY.get("input_wait_seconds")
    stalled = obs_metrics.REGISTRY.get("steps_input_stalled_total")
    occ = obs_metrics.REGISTRY.get("device_prefetch_ring_occupancy")
    assert wait is not None and stalled is not None and occ is not None
    n0 = wait._snap()["count"]
    pf = DevicePrefetcher(_toy_iter(), depth=2, device=mx.cpu())
    try:
        got = len(list(pf))
    finally:
        pf.close()
    assert wait._snap()["count"] - n0 == got == 4
    assert 0 <= occ.value <= 2


# ---------------------------------------------------------------------------
# placement on a ParallelTrainer's mesh
# ---------------------------------------------------------------------------

def test_parallel_trainer_mesh_prefetch_bit_exact():
    """Mesh-mode DevicePrefetcher places batches on the mesh's device;
    fit_batch over them trains bit-identically to the plain path, each
    array passed through on the way."""
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.parallel import make_mesh
    from mxnet_tpu_torch.parallel.data_parallel import ParallelTrainer

    mesh = make_mesh({"dp": 1}, [torch.device("cpu")])

    def make_trainer():
        _seed(5)
        net = nn.HybridSequential()
        net.add(nn.Dense(16, activation="relu"), nn.Dense(4))
        net.initialize(ctx=mx.cpu())
        return ParallelTrainer(
            net, gluon.loss.SoftmaxCrossEntropyLoss(), optimizer="sgd",
            optimizer_params={"learning_rate": 0.1}, mesh=mesh)

    t1 = make_trainer()
    for b in _toy_iter():
        t1.fit_batch(b.data[0], b.label[0])
    t2 = make_trainer()
    elided = obs_metrics.REGISTRY.get("device_put_elided_total")
    e0 = elided.value
    pf = DevicePrefetcher(_toy_iter(), depth=2, mesh=t2.mesh)
    try:
        for b in pf:
            assert b.data[0]._data.device == mesh.device
            t2.fit_batch(b.data[0], b.label[0])
    finally:
        pf.close()
    assert elided.value - e0 == 8
    for n1, n2 in zip(t1.param_names, t2.param_names):
        assert torch.equal(t1.params[n1], t2.params[n2])


# ---------------------------------------------------------------------------
# PrefetchingIter's failure semantics (tests/test_io.py's cases)
# ---------------------------------------------------------------------------

class _DyingIter(NDArrayIter):
    """Raises on one batch of the first epoch, then behaves."""

    def __init__(self, fail_at=2, exc=None, **kwargs):
        self._fail_at = fail_at
        self._exc = exc or RuntimeError("worker died")
        self._served = 0
        self._failed_once = False
        super().__init__(**kwargs)

    def next(self):
        if not self._failed_once and self._served == self._fail_at:
            self._failed_once = True
            raise self._exc
        self._served += 1
        return super().next()


def _dying_iter(fail_at=2, exc=None):
    return _DyingIter(fail_at=fail_at, exc=exc,
                      data=np.arange(40).reshape(20, 2).astype(np.float32),
                      label=np.zeros(20), batch_size=5)


@pytest.mark.parametrize("device", [None, "cpu"])
def test_prefetch_worker_death_reaches_consumer_then_reset_recovers(device):
    pre = PrefetchingIter(_dying_iter(fail_at=2), device=device and
                          torch.device(device))
    assert pre.next() is not None and pre.next() is not None
    with pytest.raises(RuntimeError, match="worker died"):
        pre.next()
    with pytest.raises(StopIteration):
        pre.next()
    pre.reset()
    assert len(list(pre)) == 4
    pre.reset()
    assert pre.iter_next()
    pre.close()


def test_prefetch_retry_spec_recovers_transient_failures():
    sleeps = []
    pre = PrefetchingIter(
        _dying_iter(fail_at=2, exc=OSError("transient storage flake")),
        retry=dict(attempts=3, retry_on=(OSError,), sleep=sleeps.append))
    batches = list(pre)
    pre.close()
    assert len(batches) == 4
    assert len(sleeps) == 1


def test_prefetch_reset_while_producer_blocked_on_full_queue():
    import time
    inner = NDArrayIter(np.arange(80).reshape(40, 2).astype(np.float32),
                        np.zeros(40), batch_size=5)
    pre = DevicePrefetcher(inner, depth=1, device=mx.cpu())
    time.sleep(0.1)
    pre.reset()
    assert len(list(pre)) == 8
    pre.close()
