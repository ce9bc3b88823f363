"""Batch serving held against the JAX package: the same checkpoint, the
same seeded requests, through ``ModelRegistry.submit`` of both packages.

The model is ``tests/test_torch_serve.py``'s small LM (vocab 40, dim 32,
4 heads, 2 layers, max_seq 48): the JAX package's weights, carried into
the port and exported by it (the JAX package cannot serve its own export
of this model, see ROADMAP.md "Caveats about the reference"); both
registries load that one checkpoint on the CPU.  Answers match across
packages at atol 1e-5 (as in ``tests/test_torch_serve.py``); the port's
coalesced answers are bit-equal to its own ``predict`` of the stacked
batch; the same deterministic traffic leaves the same serve metric names
and the same request, shed and expiry counts; ``seq_axes`` pads alike;
and a coalesced batch of two natural sequence lengths fails in both.
"""

import os
import threading
import time

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import serve as jserve
from mxnet_tpu.gluon.model_zoo.transformer import \
    get_transformer_lm as jax_lm
from mxnet_tpu.observability import metrics as jmetrics
from mxnet_tpu.resilience import chaos as jchaos
from mxnet_tpu.resilience import servechaos as jservechaos

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import serve as tserve
from mxnet_tpu_torch.gluon import load_jax_params
from mxnet_tpu_torch.gluon.model_zoo.transformer import \
    get_transformer_lm as port_lm
from mxnet_tpu_torch.observability import metrics as tmetrics
from mxnet_tpu_torch.resilience import chaos as tchaos
from mxnet_tpu_torch.resilience import servechaos as tservechaos

CFG = dict(vocab=40, dim=32, heads=4, layers=2, max_seq=48,
           prefix="transformerlm0_")
SEQ = 16
LADDER = (1, 2, 4)
THREADS = 4
PER_THREAD = 3
ATOL = 1e-5

# the port's instruments are the JAX package's serve instruments, less
# those of what it has not ported (none left: the fleet's decode failover
# counter, declared in decode.py, came with the fleet)
UNPORTED = ()

PKGS = {
    "jax": dict(mx=jmx, serve=jserve, metrics=jmetrics, chaos=jchaos,
                servechaos=jservechaos),
    "port": dict(mx=tmx, serve=tserve, metrics=tmetrics, chaos=tchaos,
                 servechaos=tservechaos),
}


def _tokens(rows, seed, seq=SEQ):
    return np.random.RandomState(seed).randint(
        0, CFG["vocab"], (rows, seq)).astype(np.float32)


@pytest.fixture(scope="module")
def prefix(tmp_path_factory):
    """The JAX LM's weights in the port, exported by the port."""
    d = tmp_path_factory.mktemp("lm")
    jnet = jax_lm(**CFG)
    jnet.initialize(ctx=jmx.cpu())
    jnet.hybridize()
    jnet(jmx.nd.array(_tokens(2, 0), ctx=jmx.cpu()))
    jparams = {k: v.data().asnumpy()
               for k, v in jnet.collect_params().items()}
    pnet = port_lm(**CFG)
    pnet.initialize(ctx=tmx.cpu())
    load_jax_params(pnet, jparams)
    pnet.hybridize()
    pnet(tmx.nd.array(_tokens(2, 0), ctx=tmx.cpu()))
    out = str(d / "port")
    pnet.export(out, 0)
    return out


def _load(pkg, prefix, name="lm", **ladder):
    p = PKGS[pkg]
    reg = p["serve"].ModelRegistry()
    pred = reg.load_checkpoint(
        name, prefix, 0, data_shapes={"data0": (1, SEQ)},
        ladder=p["serve"].BucketLadder(batches=LADDER, **ladder),
        ctx=p["mx"].cpu())
    return reg, pred


def _requests():
    """Per thread, the seeded (id, tokens) of its requests: 1-3 rows."""
    rs = np.random.RandomState(7)
    out = []
    for t in range(THREADS):
        out.append([(t * PER_THREAD + i,
                     _tokens(int(rs.randint(1, 4)), 100 + t * 10 + i))
                    for i in range(PER_THREAD)])
    return out


def _record_batches(pred):
    """Wrap *pred*.predict so the batcher's stacked inputs are kept."""
    real = pred.predict
    batches = []

    def recording(data, key=None):
        batches.append(np.array(data["data0"]))
        return real(data, key=key)

    pred.predict = recording
    return real, batches


def _serve_concurrently(reg, requests):
    answers, errors = {}, []

    def client(mine):
        try:
            for rid, x in mine:
                answers[rid] = reg.submit("lm", x).result(60)[0]
        except Exception as e:      # reported below, never swallowed
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(mine,))
               for mine in requests]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
        assert not t.is_alive()
    assert errors == []
    return answers


@pytest.fixture(scope="module")
def traffic(prefix):
    """The same concurrent traffic through both packages' registries."""
    requests = _requests()
    out = {}
    for pkg in ("jax", "port"):
        reg, pred = _load(pkg, prefix)
        reg.batcher("lm", max_wait_ms=20)
        real, batches = _record_batches(pred)
        answers = _serve_concurrently(reg, requests)
        pred.predict = real
        out[pkg] = dict(reg=reg, pred=pred, answers=answers,
                        batches=batches)
    yield requests, out
    for res in out.values():
        res["reg"].close()


def test_concurrent_answers_match_across_packages(traffic):
    requests, out = traffic
    flat = [r for mine in requests for r in mine]
    assert len(out["port"]["answers"]) == len(flat) == THREADS * PER_THREAD
    for rid, x in flat:
        got, want = out["port"]["answers"][rid], out["jax"]["answers"][rid]
        assert got.shape == want.shape == (x.shape[0], SEQ, CFG["vocab"])
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_each_coalesced_answer_is_its_stacked_batch(traffic):
    """Every coalesced answer is bit-equal to the port's predict of the
    stacked batch it rode in (the JAX contract)."""
    requests, out = traffic
    port = out["port"]
    by_row = {}
    for mine in requests:
        for rid, x in mine:
            for i, row in enumerate(x):
                by_row[row.tobytes()] = (rid, i)
    rows_total = sum(x.shape[0] for mine in requests for _, x in mine)
    assert sum(b.shape[0] for b in port["batches"]) == rows_total
    assert port["reg"].batcher("lm").batch_count == len(port["batches"])
    for stacked in port["batches"]:
        want = port["pred"].predict(stacked)[0].asnumpy()
        got = np.stack([port["answers"][rid][i] for rid, i in
                        (by_row[row.tobytes()] for row in stacked)])
        assert np.array_equal(got, want)


def _metric_deltas(pkg, before):
    after = PKGS[pkg]["metrics"].snapshot()
    names = ("serve_requests_total", "serve_requests_shed_total",
             "serve_requests_expired_total", "serve_batches_total")
    return {n: after[n]["value"] - before.get(n, {"value": 0})["value"]
            for n in names}


def _deterministic_traffic(pkg, prefix):
    """Accepted, shed and expired requests with no timing-dependent
    outcome: the shed comes from a full queue behind a 60 s window, the
    expiry from a deadline that passes while a chaos hang holds the
    dispatcher."""
    p = PKGS[pkg]
    before = p["metrics"].snapshot()
    reg, pred = _load(pkg, prefix, name="det")
    try:
        reg.batcher("det", max_wait_ms=60000, max_queue=2)
        futs = [reg.submit("det", _tokens(1, s)) for s in (1, 2)]
        with pytest.raises(p["serve"].OverloadError):
            reg.submit("det", _tokens(1, 3))
        assert reg.drain("det", timeout=30) is True
        for f in futs:
            assert f.result(10)[0].shape == (1, SEQ, CFG["vocab"])
        b = p["serve"].DynamicBatcher(pred, max_wait_ms=1)
        p["chaos"].configure(dispatch_hang_at=1)
        try:
            filler = b.submit(_tokens(1, 4))
            deadline = time.monotonic() + 10
            while b.queue_depth and time.monotonic() < deadline:
                time.sleep(0.005)
            victim = b.submit(_tokens(1, 5), deadline_ms=50)
            time.sleep(0.3)             # the deadline passes in the hang
            p["servechaos"].release_hangs()
            with pytest.raises(p["serve"].DeadlineExceededError):
                victim.result(10)
            assert filler.result(10)[0].shape == (1, SEQ, CFG["vocab"])
        finally:
            p["servechaos"].release_hangs()
            p["chaos"].reset()
            p["servechaos"].reset_hangs()
            b.close()
    finally:
        reg.close()
    return _metric_deltas(pkg, before)


def _jax_source():
    root = os.path.dirname(jmx.__file__)
    return "".join(open(os.path.join(d, f)).read()
                   for d, _, fs in os.walk(root) for f in fs
                   if f.endswith(".py"))


def test_same_metric_names_and_counts_after_the_same_traffic(prefix):
    deltas = {pkg: _deterministic_traffic(pkg, prefix) for pkg in PKGS}
    assert deltas["port"] == deltas["jax"] == {
        "serve_requests_total": 4, "serve_requests_shed_total": 1,
        "serve_requests_expired_total": 1, "serve_batches_total": 2}
    jnames = {n for n in jmetrics.snapshot()
              if n.startswith("serve_") and not n.startswith(UNPORTED)}
    tnames = set(tmetrics.snapshot())
    assert {n for n in tnames if n.startswith("serve_")} == jnames
    # every other name the port registers is one the JAX package
    # registers too; read from its source, since which of those a
    # process holds depends on what ran in it before
    src = _jax_source()
    assert {n for n in tnames if not n.startswith("serve_") and
            '"%s"' % n not in src} == set()


@pytest.mark.parametrize("path", ["predict", "submit"])
def test_seq_axes_pad_alike(prefix, path):
    """A 5-token request on seq_axes {1: 4} runs at 8 tokens in both
    packages (a program built on demand, once) and the logits match."""
    x = _tokens(2, 11, seq=5)
    outs = {}
    for pkg in PKGS:
        reg, pred = _load(pkg, prefix, seq_axes={1: 4}, seq_max={1: 48})
        try:
            built = pred.compile_count
            assert PKGS[pkg]["serve"].BucketLadder(
                batches=LADDER, seq_axes={1: 4}).pad_shape((2, 5)) == (2, 8)
            if path == "predict":
                outs[pkg] = reg.predict("lm", x)[0].asnumpy()
            else:
                outs[pkg] = reg.submit("lm", x).result(60)[0]
            again = reg.predict("lm", _tokens(1, 12, seq=7))[0]
            assert again.shape == (1, 8, CFG["vocab"])
            assert pred.compile_count == built + 2   # (2, 8) and (1, 8)
        finally:
            reg.close()
    assert outs["port"].shape == outs["jax"].shape == (2, 8, CFG["vocab"])
    np.testing.assert_allclose(outs["port"], outs["jax"], rtol=0, atol=ATOL)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_mixed_natural_lengths_in_one_batch_fail_that_batch(prefix, pkg):
    """The reference's caveat, pinned in both packages: the batcher
    concatenates requests at their natural shapes, so a 5-token and a
    6-token request coalesced into one batch fail together with numpy's
    ValueError (per-batch isolation), though each alone would be served
    at the same 8-token bucket."""
    reg, _ = _load(pkg, prefix, seq_axes={1: 4}, seq_max={1: 48})
    try:
        b = reg.batcher("lm", max_wait_ms=60000)
        futs = [reg.submit("lm", _tokens(1, 21, seq=5)),
                reg.submit("lm", _tokens(1, 22, seq=6))]
        assert b.flush(timeout=60) is True
        for f in futs:
            with pytest.raises(ValueError, match="concatenat|dimension"):
                f.result(1)
        alone = reg.submit("lm", _tokens(1, 22, seq=6))
        assert b.flush(timeout=60) is True
        assert alone.result(1)[0].shape == (1, 8, CFG["vocab"])
    finally:
        reg.close()
