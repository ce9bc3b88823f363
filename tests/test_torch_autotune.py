"""The autotuner of the PyTorch port (``mxnet_tpu_torch/autotune``, the
tuned layers of ``config`` and their pick-up by ``ModelRegistry.load``,
``DynamicBatcher`` and ``DecodeEngine``) against the JAX package, in one
process on the CPU.

The cases of ``tests/test_autotune.py`` run on the port (config space,
trace determinism, store round trip, search mechanics, knob precedence
env > tuned > default, load-time pick-up by the registry and the decode
engine).  The parity cases hold it against the reference: the same
``random.Random`` seed gives the same space samples and neighbors; the
same trace has the same sha and bit-equal payloads; trace and store
files cross in both directions; and the search with a deterministic fake
measurer picks the same winner, the same score and the same store entry.
An entry keyed on another device kind (the CPU's, a TPU's) does not
apply on the card.
"""

import json
import random

import numpy as np
import pytest

import mxnet_tpu.autotune as jat
from mxnet_tpu.autotune import search as jsearch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import config as _cfg
from mxnet_tpu_torch import sym
from mxnet_tpu_torch.autotune import (Choice, FloatRange, IntRange, Trace,
                                      TuningStore, decode_space,
                                      serve_space, synth_decode_trace,
                                      synth_serve_trace, tune)
from mxnet_tpu_torch.autotune.search import (INFEASIBLE, Objective,
                                             decode_objective,
                                             serve_objective)
from mxnet_tpu_torch.autotune.store import (TuningStoreError, device_kind,
                                            lookup)
from mxnet_tpu_torch.autotune.trace import TraceError, replay
from mxnet_tpu_torch.serve import (BucketLadder, CompiledPredictor,
                                   ModelRegistry, ServeError)

CPU = mx.cpu()


# ---------------------------------------------------------------------------
# config space


def test_space_default_and_validate():
    space = serve_space()
    d = space.default()
    space.validate(d)
    assert d["ladder"] == (1, 2, 4, 8, 16)
    assert d["MXNET_SERVE_MAX_WAIT_MS"] == 2.0
    with pytest.raises(ValueError):
        space.validate({"ladder": (1, 2)})      # missing params
    with pytest.raises(ValueError):
        space.validate(dict(d, bogus=1))        # unknown param


def test_space_sample_and_neighbors_stay_valid():
    space = serve_space()
    rng = random.Random(7)
    for _ in range(50):
        c = space.sample(rng)
        space.validate(c)
        for n in space.neighbors(c, rng):
            space.validate(n)


def test_space_key_canonical():
    space = serve_space()
    a = space.default()
    b = dict(a, ladder=list(a["ladder"]))   # list vs tuple
    assert space.key(a) == space.key(b)


def test_range_params():
    r = IntRange("k", 2, 64, default=8, scale="log")
    rng = random.Random(0)
    for _ in range(20):
        v = r.sample(rng)
        assert 2 <= v <= 64
    assert set(r.neighbors(8, rng)) <= {4, 16}
    f = FloatRange("w", 0.0, 8.0, default=2.0, scale="linear", step=1.0)
    assert all(0.0 <= v <= 8.0 for v in f.neighbors(0.0, rng))
    with pytest.raises(ValueError):
        IntRange("bad", 0, 8, default=1, scale="log")   # log needs > 0


def test_choice_rejects_bad_default():
    with pytest.raises(ValueError):
        Choice("c", (1, 2, 3), default=9)


@pytest.mark.parametrize("space_fn", ["serve_space", "decode_space"])
def test_space_samples_match_jax(space_fn):
    """The same seed walks the same samples and neighbors in both."""
    t_space = {"serve_space": serve_space,
               "decode_space": decode_space}[space_fn]()
    j_space = getattr(jat, space_fn)()
    tr, jr = random.Random(13), random.Random(13)
    for _ in range(30):
        tc, jc = t_space.sample(tr), j_space.sample(jr)
        assert tc == jc
        assert t_space.neighbors(tc, tr) == j_space.neighbors(jc, jr)
    assert t_space.default() == j_space.default()


# ---------------------------------------------------------------------------
# traces


def test_trace_roundtrip_and_sha(tmp_path):
    tr = synth_serve_trace(rate=50, seconds=1, dim=8, seed=3)
    p = str(tmp_path / "t.json")
    tr.save(p)
    tr2 = Trace.load(p)
    assert tr2.sha256() == tr.sha256()
    assert tr2.schedule() == tr.schedule()


def test_trace_payload_determinism():
    a = synth_serve_trace(rate=40, seconds=1, dim=8, seed=11)
    b = synth_serve_trace(rate=40, seconds=1, dim=8, seed=11)
    pa, pb = a.payloads(), b.payloads()
    assert len(pa) == len(pb)
    for x, y in zip(pa, pb):
        assert x.dtype == np.float32
        np.testing.assert_array_equal(x, y)


def test_trace_budget_prefix_stable():
    tr = synth_serve_trace(rate=40, seconds=1, dim=8, seed=2)
    full = tr.payloads()
    short = tr.payloads(0.25)
    assert 0 < len(short) < len(full)
    for x, y in zip(short, full):
        np.testing.assert_array_equal(x, y)
    assert tr.schedule(0.25) == tr.schedule()[:len(short)]


def test_decode_trace_payloads():
    tr = synth_decode_trace(rate=6, seconds=1, vocab=32, seed=4)
    toks = tr.payloads()
    assert all(t.dtype == np.int32 for t in toks)
    assert all(0 <= int(t.min()) and int(t.max()) < 32 for t in toks)
    lens = [e["prompt_len"] for e in tr.events]
    assert [t.shape[0] for t in toks] == lens


def test_trace_validation():
    with pytest.raises(TraceError):
        Trace("serve", [], {"dim": 4})               # no events
    with pytest.raises(TraceError):
        Trace("serve", [{"t": 1.0, "rows": 1},
                        {"t": 0.5, "rows": 1}], {"dim": 4})  # order
    with pytest.raises(TraceError):
        Trace("bogus", [{"t": 0.0, "rows": 1}], {})  # kind


def test_replay_open_loop():
    tr = synth_serve_trace(rate=200, seconds=0.2, dim=4, seed=0)
    got = []
    records, wall = replay(tr, lambda x, i: got.append(i) or i)
    assert [h for _, _, h in records] == list(range(len(got)))
    assert wall >= tr.duration() * 0.5


@pytest.mark.parametrize("kind", ["serve", "decode"])
def test_trace_sha_and_payloads_match_jax(kind):
    if kind == "serve":
        t = synth_serve_trace(rate=40, seconds=1, dim=8, seed=11)
        j = jat.synth_serve_trace(rate=40, seconds=1, dim=8, seed=11)
    else:
        t = synth_decode_trace(rate=6, seconds=1, vocab=32, seed=4)
        j = jat.synth_decode_trace(rate=6, seconds=1, vocab=32, seed=4)
    assert t.sha256() == j.sha256()
    assert t.schedule() == j.schedule()
    assert t.summary() == j.summary()
    for x, y in zip(t.payloads(), j.payloads()):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("direction", ["port-to-jax", "jax-to-port"])
def test_trace_files_cross(tmp_path, direction):
    p = str(tmp_path / "t.json")
    if direction == "port-to-jax":
        src = synth_serve_trace(rate=30, seconds=1, dim=6, seed=9)
        src.save(p)
        back = jat.Trace.load(p)
    else:
        src = jat.synth_decode_trace(rate=6, seconds=1, vocab=16, seed=2)
        src.save(p)
        back = Trace.load(p)
    assert back.sha256() == src.sha256()
    assert back.schedule() == src.schedule()


# ---------------------------------------------------------------------------
# bucket ladder: explicit rungs


def test_ladder_explicit_rungs_validation():
    assert BucketLadder(batches=(1, 3, 6, 16)).batches == (1, 3, 6, 16)
    with pytest.raises(ServeError):
        BucketLadder(batches=(1, 3, 3, 16))      # not strictly ascending
    with pytest.raises(ServeError):
        BucketLadder(batches=(3, 1, 16))         # descending
    with pytest.raises(ServeError):
        BucketLadder(batches=())                 # empty
    with pytest.raises(ServeError):
        BucketLadder(batches=(0, 4))             # rung < 1
    with pytest.raises(ServeError):
        BucketLadder(batches=(1, 2 ** 13))       # beyond cap
    with pytest.raises(ServeError):
        BucketLadder(batches=tuple(range(1, 70)))  # too many rungs


def _fc_net(dim=6, hidden=8, classes=4, seed=0):
    data = sym.var("data")
    net = sym.FullyConnected(data, num_hidden=hidden, name="lfc1")
    net = sym.Activation(net, act_type="relu")
    net = sym.FullyConnected(net, num_hidden=classes, name="lfc2")
    rs = np.random.RandomState(seed)
    arg_shapes, _, _ = net.infer_shape(data=(1, dim))
    params = {n: mx.nd.array(rs.randn(*s).astype(np.float32) * 0.1,
                             ctx=CPU)
              for n, s in zip(net.list_arguments(), arg_shapes)
              if n != "data"}
    return net, params


def _eager(net, params, x):
    args = dict(params)
    args["data"] = mx.nd.array(x, ctx=CPU)
    return net.bind(CPU, args).forward()[0].asnumpy()


def test_non_power_of_two_ladder_bit_equal():
    """An explicit ladder with non-power-of-two rungs (1, 3, 6, 16), for
    every row count across the rung boundaries: predict is bit-equal to
    the eager forward of the zero-padded rung batch (the port's serving
    contract: PyTorch's CPU GEMM may block another row count differently,
    so the natural batch's forward is held to a few f32 ulps, 2**-20 of
    its magnitude, where the JAX package's is bit-equal)."""
    dim = 6
    net, params = _fc_net(dim=dim)
    ladder = BucketLadder(batches=(1, 3, 6, 16))
    pred = CompiledPredictor(net, params, data_shapes={"data": (1, dim)},
                             ladder=ladder, ctx=CPU)
    pred.warm()
    rs = np.random.RandomState(0)
    for rows in (1, 2, 3, 4, 5, 6, 7, 16):
        x = rs.randn(rows, dim).astype(np.float32)
        got = pred.predict({"data": x})[0].asnumpy()
        assert got.shape[0] == rows
        pad = np.zeros((ladder.batch_for(rows), dim), np.float32)
        pad[:rows] = x
        np.testing.assert_array_equal(got, _eager(net, params, pad)[:rows])
        want = _eager(net, params, x)
        assert np.abs(got - want).max() <= 2.0 ** -20 * np.abs(want).max()
    assert pred.compile_count == 4


# ---------------------------------------------------------------------------
# knob precedence: env > tuned > default


def test_tuned_override_precedence(monkeypatch):
    name = "MXNET_SERVE_MAX_WAIT_MS"
    monkeypatch.delenv(name, raising=False)
    default = _cfg.get_env(name)
    try:
        _cfg.tuned_override(name, 5.5)
        assert _cfg.get_env(name) == 5.5
        # a per-model tuned value beats the global tuned layer
        assert _cfg.resolve_env(name, 3.25) == 3.25
        # an exported env var always wins over any tuning
        monkeypatch.setenv(name, "1.5")
        assert _cfg.get_env(name) == 1.5
        assert _cfg.resolve_env(name, 3.25) == 1.5
        assert _cfg.env_is_set(name)
    finally:
        _cfg.clear_tuned(name)
    monkeypatch.delenv(name, raising=False)
    assert _cfg.get_env(name) == default
    assert not _cfg.env_is_set(name)


def test_tuned_override_typed():
    with pytest.raises(Exception):
        _cfg.tuned_override("NOT_A_REGISTERED_KNOB", 1)
    try:
        v = _cfg.tuned_override("MXNET_SERVE_MAX_BATCH", "8")
        assert v == 8 and isinstance(v, int)
        assert _cfg.tuned_overrides()["MXNET_SERVE_MAX_BATCH"] == 8
    finally:
        _cfg.clear_tuned()
    assert _cfg.tuned_overrides() == {}


# ---------------------------------------------------------------------------
# store


def _entry_config():
    return {"ladder": [1, 3, 6, 16], "MXNET_SERVE_MAX_WAIT_MS": 0.25,
            "MXNET_SERVE_MAX_BATCH": 6}


def test_store_roundtrip(tmp_path):
    p = str(tmp_path / "store.json")
    st = TuningStore.load(p, missing_ok=True)
    st.put("m", "serve", _entry_config(), device="cpu", score=1.0,
           baseline_score=2.0, gain_pct=50.0)
    st.save()
    st2 = TuningStore.load(p)
    e = st2.get("m", "serve", device="cpu")
    assert e["config"] == _entry_config()
    assert e["gain_pct"] == 50.0
    st2.put("m2", "serve", _entry_config(), device="any")
    assert st2.get("m2", "serve", device="tpu-v4")["config"] == \
        _entry_config()
    assert st2.get("missing", "serve") is None


def test_store_missing_is_loud(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_TUNING_STORE", str(tmp_path / "nope.json"))
    with pytest.raises(TuningStoreError):
        lookup("m", "serve")


def test_store_env_lookup_and_cache(tmp_path, monkeypatch):
    p = str(tmp_path / "store.json")
    st = TuningStore.load(p, missing_ok=True)
    st.put("m", "serve", _entry_config(), device="any")
    st.save()
    monkeypatch.setenv("MXNET_TUNING_STORE", p)
    assert lookup("m", "serve")["config"] == _entry_config()
    assert lookup("m", "decode") is None
    monkeypatch.delenv("MXNET_TUNING_STORE")
    assert lookup("m", "serve") is None


@pytest.mark.parametrize("direction", ["port-to-jax", "jax-to-port"])
def test_store_files_cross(tmp_path, direction):
    p = str(tmp_path / "store.json")
    writer = TuningStore if direction == "port-to-jax" else jat.TuningStore
    reader = jat.TuningStore if direction == "port-to-jax" else TuningStore
    st = writer.load(p, missing_ok=True)
    st.put("m", "serve", _entry_config(), device="cpu", score=1.5)
    st.put("m", "decode", {"ladder": [1, 2]}, device="any")
    st.save()
    back = reader.load(p)
    assert back.entries() == st.entries()
    with open(p) as f:
        raw = f.read()
    back.save(str(tmp_path / "again.json"))
    with open(str(tmp_path / "again.json")) as f:
        assert f.read() == raw


def test_device_kind_keys_cpu_and_cards_apart(tmp_path, monkeypatch):
    """An entry written on the CPU, or for a TPU, never applies to a
    card; the CPU's kind is "cpu"."""
    import torch
    assert device_kind(torch.device("cpu")) == "cpu"
    p = str(tmp_path / "store.json")
    st = TuningStore.load(p, missing_ok=True)
    st.put("m", "serve", _entry_config(), device="cpu")
    st.put("m", "serve", _entry_config(), device="TPU v4")
    st.save()
    monkeypatch.setenv("MXNET_TUNING_STORE", p)
    assert lookup("m", "serve", device=torch.device("cpu")) is not None
    assert lookup("m", "serve", device="NVIDIA H100 80GB HBM3") is None


# ---------------------------------------------------------------------------
# search mechanics (a fake measurer: no serving machinery)


class _StubMeasurer(object):
    """Deterministic fake: score = wait + |batch - 8|; optional prior
    mirror; counts measurements so tests can assert pruning."""

    def __init__(self, trace, with_prior=False, fail_keys=()):
        self.trace = trace
        self.with_prior = with_prior
        self.fail_keys = set(fail_keys)
        self.measured = []

    def _score(self, config):
        return (float(config["MXNET_SERVE_MAX_WAIT_MS"])
                + abs(int(config["MXNET_SERVE_MAX_BATCH"] or 12) - 8)
                + 0.1 * len(config["ladder"]))

    def measure(self, config, budget_frac=1.0):
        self.measured.append((dict(config), budget_frac))
        key = json.dumps({k: list(v) if isinstance(v, tuple) else v
                          for k, v in sorted(config.items())})
        if any(f in key for f in self.fail_keys):
            return {"ok": False, "error": "boom"}
        return {"ok": True, "workload": "serve", "offered_rps": 100.0,
                "achieved_rps": 100.0, "p99_ms": self._score(config),
                "request_path_compiles": 0}

    def prior(self, config, budget_frac=1.0):
        return self._score(config) if self.with_prior else None


def test_tune_deterministic_and_guarded(tmp_path):
    tr = synth_serve_trace(rate=20, seconds=0.5, dim=4)
    space = serve_space()
    results = []
    for _ in range(2):
        m = _StubMeasurer(tr)
        r = tune(space, m, serve_objective(), model="m", workload="serve",
                 trials=6, neighbor_trials=2, seed=42, device="cpu")
        results.append(r)
    assert results[0]["config"] == results[1]["config"]
    assert results[0]["score"] == results[1]["score"]
    assert results[0]["trace"]["sha256"] == tr.sha256()
    assert results[0]["score"] <= results[0]["baseline_score"]


def test_tune_schedule_deterministic():
    tr = synth_serve_trace(rate=20, seconds=0.5, dim=4)
    space = serve_space()
    seqs = []
    for _ in range(2):
        m = _StubMeasurer(tr)
        tune(space, m, serve_objective(), model="m", workload="serve",
             trials=6, neighbor_trials=2, seed=7, device="cpu")
        seqs.append([(json.dumps(sorted((k, str(v)) for k, v in
                                        c.items())), b)
                     for c, b in m.measured])
    assert seqs[0] == seqs[1]


def test_tune_prior_prunes():
    tr = synth_serve_trace(rate=20, seconds=0.5, dim=4)
    space = serve_space()
    m = _StubMeasurer(tr, with_prior=True)
    r = tune(space, m, serve_objective(), model="m", workload="serve",
             trials=12, neighbor_trials=4, seed=3, prune_ratio=1.05,
             min_keep=2, device="cpu")
    assert r["pruned"] > 0
    assert r["trials"] == len(m.measured)
    assert len(m.measured) < 12 + 4 + r["pruned"]


def test_tune_failed_trials_infeasible():
    tr = synth_serve_trace(rate=20, seconds=0.5, dim=4)
    space = serve_space()
    m = _StubMeasurer(tr, fail_keys=("ladder",))
    r = tune(space, m, serve_objective(), model="m", workload="serve",
             trials=4, neighbor_trials=0, seed=0, device="cpu")
    assert r["config"] == space.default()
    assert r["gain_pct"] == 0.0


def test_objective_infeasibility_rules():
    obj = serve_objective()
    assert obj.score({"ok": False}) == INFEASIBLE
    assert obj.score({"ok": True, "p99_ms": 1.0,
                      "request_path_compiles": 2}) == INFEASIBLE
    assert obj.score({"ok": True, "p99_ms": 1.0, "offered_rps": 100,
                      "achieved_rps": 10}) == INFEASIBLE
    assert obj.score({"ok": True, "p99_ms": 1.0, "offered_rps": 100,
                      "achieved_rps": 99}) == 1.0
    d = decode_objective()
    assert d.score({"ok": True, "tokens_per_sec": 50.0}) == -50.0
    assert Objective("x", lambda m: None).score({"ok": True}) == INFEASIBLE


def test_tune_persists_to_store(tmp_path):
    tr = synth_serve_trace(rate=20, seconds=0.5, dim=4)
    p = str(tmp_path / "store.json")
    st = TuningStore.load(p, missing_ok=True)
    m = _StubMeasurer(tr)
    r = tune(serve_space(), m, serve_objective(), model="m",
             workload="serve", trials=4, seed=1, store=st, device="cpu")
    on_disk = TuningStore.load(p)
    e = on_disk.get("m", "serve", device="cpu")
    assert e is not None
    assert e["trace"]["sha256"] == tr.sha256()
    assert e["score"] == r["score"]
    assert e["measurement"]["ok"]


@pytest.mark.parametrize("seed,prior", [(42, False), (3, True)])
def test_tune_matches_jax(tmp_path, seed, prior):
    """The same trace, space, seed and fake measurer: the same winner,
    score, trial and prune counts, measured sequence and store entry."""
    tr = synth_serve_trace(rate=20, seconds=0.5, dim=4)
    jtr = jat.synth_serve_trace(rate=20, seconds=0.5, dim=4)
    kw = dict(model="m", workload="serve", trials=8, neighbor_trials=3,
              seed=seed, device="cpu", prune_ratio=1.05, min_keep=2)
    tm, jm = _StubMeasurer(tr, prior), _StubMeasurer(jtr, prior)
    tst = TuningStore.load(str(tmp_path / "t.json"), missing_ok=True)
    jst = jat.TuningStore.load(str(tmp_path / "j.json"), missing_ok=True)
    r = tune(serve_space(), tm, serve_objective(), store=tst, **kw)
    j = jat.tune(jat.serve_space(), jm, jsearch.serve_objective(),
                 store=jst, **kw)
    for k in ("config", "score", "baseline_score", "gain_pct", "trials",
              "pruned", "objective", "trace", "search", "device_kind"):
        assert r[k] == j[k], k
    assert tm.measured == jm.measured
    te, je = dict(r["entry"]), dict(j["entry"])
    te.pop("created")
    je.pop("created")
    assert te == je


# ---------------------------------------------------------------------------
# load-time pick-up


def _store_with(tmp_path, model, workload, config, **extra):
    p = str(tmp_path / "pickup.json")
    st = TuningStore.load(p, missing_ok=True)
    st.put(model, workload, config, device="any", score=1.0,
           baseline_score=2.0, gain_pct=50.0, **extra)
    st.save()
    return p


def _pfc(dim=6):
    data = sym.var("data")
    net = sym.FullyConnected(data, num_hidden=4, name="pfc")
    rs = np.random.RandomState(0)
    arg_shapes, _, _ = net.infer_shape(data=(1, dim))
    params = {n: mx.nd.array(rs.randn(*s).astype(np.float32), ctx=CPU)
              for n, s in zip(net.list_arguments(), arg_shapes)
              if n != "data"}
    return net, params


def test_registry_picks_up_tuning(tmp_path, monkeypatch):
    p = _store_with(tmp_path, "picked", "serve", _entry_config())
    monkeypatch.setenv("MXNET_TUNING_STORE", p)
    monkeypatch.delenv("MXNET_SERVE_MAX_WAIT_MS", raising=False)
    dim = 6
    net, params = _pfc(dim)
    reg = ModelRegistry()
    try:
        pred = reg.load("picked", net, params,
                        data_shapes={"data": (1, dim)}, ctx=CPU)
        assert pred.ladder.batches == (1, 3, 6, 16)
        assert pred.tuning["config"]["MXNET_SERVE_MAX_WAIT_MS"] == 0.25
        b = reg.batcher("picked")
        assert b._max_wait == pytest.approx(0.25e-3)
        assert b._max_batch == 6
        h = reg.health("picked")
        assert h["tuning"]["config"]["ladder"] == [1, 3, 6, 16]
        assert h["tuning"]["applied"]["ladder"] == [1, 3, 6, 16]
        assert h["tuning"]["applied"]["max_batch"] == 6
        assert h["tuning"]["source"] == p
        # an exported env var still beats the store at load time
        reg2 = ModelRegistry()
        monkeypatch.setenv("MXNET_SERVE_MAX_WAIT_MS", "4.0")
        reg2.load("picked", net, params, data_shapes={"data": (1, dim)},
                  ctx=CPU)
        b2 = reg2.batcher("picked")
        assert b2._max_wait == pytest.approx(4.0e-3)
        reg2.close()
    finally:
        reg.close()


def test_registry_explicit_ladder_beats_store(tmp_path, monkeypatch):
    p = _store_with(tmp_path, "picked", "serve", _entry_config())
    monkeypatch.setenv("MXNET_TUNING_STORE", p)
    net, params = _pfc()
    reg = ModelRegistry()
    try:
        pred = reg.load("picked", net, params, data_shapes={"data": (1, 6)},
                        ladder=BucketLadder(batches=(1, 4)), ctx=CPU)
        assert pred.ladder.batches == (1, 4)
    finally:
        reg.close()


def test_decode_engine_picks_up_tuning(tmp_path, monkeypatch):
    from mxnet_tpu_torch.serve import DecodeBatcher, DecodeEngine
    from mxnet_tpu_torch.test_utils import tiny_attention_lm
    cfg = {"ladder": [1, 2, 6], "MXNET_SERVE_KV_BLOCK_SIZE": 4,
           "MXNET_SERVE_DECODE_MAX_WAIT_MS": 0.5}
    p = _store_with(tmp_path, "tuned-dec", "decode", cfg)
    monkeypatch.setenv("MXNET_TUNING_STORE", p)
    monkeypatch.delenv("MXNET_SERVE_KV_BLOCK_SIZE", raising=False)
    monkeypatch.delenv("MXNET_SERVE_DECODE_MAX_WAIT_MS", raising=False)
    params, step_fn, prefill_fn, token_spec, input_spec = \
        tiny_attention_lm(vocab=16, dim=8, seed=0, ctx=CPU)
    eng = DecodeEngine(step_fn, prefill_fn, token_spec, input_spec,
                       params=params, max_len=16, num_blocks=24,
                       label="tuned-dec", donate=True, device=CPU)
    try:
        assert eng.ladder.batches == (1, 2, 6)
        assert eng.block_size == 4
        b = DecodeBatcher(eng)
        assert b._max_wait == pytest.approx(0.5e-3)
        b.close()
    finally:
        eng.close()


def test_serve_measurer_tunes_the_fc_model_end_to_end(tmp_path):
    """The real measurer on the CPU: a short search over a few candidates
    replays the trace through DynamicBatcher, prices rungs from their
    flops and bytes, and persists a winner keyed "cpu"."""
    from mxnet_tpu_torch.autotune.measure import ServeMeasurer
    tr = synth_serve_trace(rate=100.0, seconds=0.3, dim=8, seed=0)
    m = ServeMeasurer(tr, name="e2e", ctx=CPU)
    try:
        assert m.rung_cost_s(4) > m.rung_cost_s(1) > 0
        assert m.prior({"ladder": (1, 2, 4), "MXNET_SERVE_MAX_WAIT_MS": 1.0,
                        "MXNET_SERVE_MAX_BATCH": 0}) > 0
        st = TuningStore.load(str(tmp_path / "s.json"), missing_ok=True)
        r = tune(serve_space(max_rows=4, ladders=[(1, 2, 4), (1, 4)]), m,
                 serve_objective(), model="e2e", workload="serve",
                 trials=2, neighbor_trials=1, seed=0, store=st)
    finally:
        m.close()
    assert r["device_kind"] == "cpu"
    assert r["score"] is not None
    assert r["baseline"]["request_path_compiles"] == 0
    assert TuningStore.load(st.path).get("e2e", "serve", device="cpu")


def test_cli_runs_on_the_cpu(tmp_path, capsys):
    from mxnet_tpu_torch.autotune.__main__ import main
    store = str(tmp_path / "cli.json")
    assert main(["--workload", "serve", "--model", "cli", "--rate", "80",
                 "--seconds", "0.2", "--dim", "8", "--trials", "2",
                 "--neighbor-trials", "0", "--store", store, "--quiet",
                 "--ctx", "cpu"]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last.startswith("autotune: trials=") and last.endswith(" ok")
    assert TuningStore.load(store).get("cli", "serve", device="cpu")
