"""The post-training quantization pipeline of the PyTorch port —
``quantize.calibrate`` -> ``quantize.quantize_model`` ->
``serve.ModelRegistry.load(quantize=...)`` with its load-time gate ->
``health()`` — against the JAX package, in one process on the CPU, on a
small convnet and a 2-layer transformer LM (vocab 40, dim 32, 4 heads).

The cases of ``tests/test_quantize_pipeline.py`` run on the port; the
parity cases hold it against the reference on the same seeded inputs and
the same CalibTable:

* calibrated ranges within 1e-5 of each tensor's magnitude (the two
  packages' f32 convolutions and products differ in summation order);
* CalibTable files, quantized ``.params`` files (int8 ``*_quantized``
  entries with their ``_min``/``_max`` scalars) cross in both
  directions with the same sha and the same bytes;
* ``quantize_model`` from one CalibTable: the same symbol JSON and the
  same int8 weights, int32 biases and ranges (the JSON compared past the
  two packages' known writing differences: the ``framework`` attribute,
  and a one-element tuple, which the JAX package writes "(1)" and the
  port "(1,)");
* a whole quantized model's outputs within 2/127 of max |reference
  output|, argmax agreement >= 0.99;
* the load gate's verdict the same, its worst error within 2/127 of the
  reference's;
* the proof of int8 compute (the port has no StableHLO): each rung's
  program counted its int8 products (``int8``) or its int8 weights
  dequantized in-graph (``int8-weight-only``), and moves fewer compute
  bytes than the fp32 program.
"""

import json
import os
import re

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import quantize as jquant
from mxnet_tpu import serve as jserve
from mxnet_tpu.gluon.model_zoo.transformer import \
    get_transformer_lm as jax_lm

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import nd, serve as tserve
from mxnet_tpu_torch.gluon import load_jax_params
from mxnet_tpu_torch.gluon.model_zoo.transformer import \
    get_transformer_lm as port_lm
from mxnet_tpu_torch.quantize import (CalibTable, QuantizationError,
                                      QuantizePolicy, calibrate,
                                      hlo_has_int8_compute,
                                      hlo_has_int8_tensors, int8_work,
                                      quantize_model)
from mxnet_tpu_torch.serve.buckets import BucketLadder
from mxnet_tpu_torch.serve.registry import ModelRegistry

CPU = tmx.cpu()
RANGE_TOL = 1e-5
OUT_TOL = 2.0 / 127
ARGMAX_SHARE = 0.99
LM_CFG = dict(vocab=40, dim=32, heads=4, layers=2, max_seq=48,
              prefix="transformerlm0_")
LM_SEQ = 16


def _convnet(mx):
    data = mx.sym.var("data")
    c1 = mx.sym.Convolution(data=data, kernel=(3, 3), num_filter=8,
                            name="c1")
    a1 = mx.sym.Activation(data=c1, act_type="relu", name="a1")
    p1 = mx.sym.Pooling(data=a1, kernel=(2, 2), stride=(2, 2),
                        pool_type="max", name="p1")
    return mx.sym.FullyConnected(data=p1, num_hidden=10, name="f1")


def _params_np(rs):
    return {
        "c1_weight": rs.randn(8, 3, 3, 3).astype(np.float32) * 0.2,
        "c1_bias": rs.randn(8).astype(np.float32) * 0.1,
        "f1_weight": rs.randn(10, 8 * 5 * 5).astype(np.float32) * 0.1,
        "f1_bias": rs.randn(10).astype(np.float32) * 0.1,
    }


@pytest.fixture
def net():
    rs = np.random.RandomState(4)
    pnp = _params_np(rs)
    params = {n: nd.array(v, ctx=CPU) for n, v in pnp.items()}
    batches = [rs.randn(4, 3, 12, 12).astype(np.float32)
               for _ in range(4)]
    return _convnet(tmx), params, batches, rs


def _fwd(sym, args, x):
    return sym.bind(CPU, args=dict(args, data=nd.array(x, ctx=CPU))) \
        .forward()[0].asnumpy()


# -- calibration (the reference's cases, on the port) ------------------------

def test_calibrate_covers_every_float_tensor(net):
    sym, params, batches, _ = net
    table = calibrate(sym, params, batches, ctx=CPU)
    for tname in ("data", "c1", "a1", "p1", "f1"):
        assert table.covers(tname), tname
    assert table.batches == 4 and table.mode == "minmax"
    lo, hi = table.range("a1")
    assert lo == 0.0 and hi > 0.0          # post-relu range


def test_calibrate_minmax_is_running_envelope(net):
    sym, params, batches, _ = net
    one = calibrate(sym, params, batches[:1], ctx=CPU)
    full = calibrate(sym, params, batches, ctx=CPU)
    lo1, hi1 = one.range("c1")
    lo4, hi4 = full.range("c1")
    assert lo4 <= lo1 and hi4 >= hi1


def test_calibrate_percentile_tightens_ranges(net):
    sym, params, batches, _ = net
    mm = calibrate(sym, params, batches, ctx=CPU)
    pc = calibrate(sym, params, batches, mode="percentile",
                   percentile=90.0, ctx=CPU)
    assert pc.max_abs("c1") < mm.max_abs("c1")
    assert pc.sha != mm.sha


def test_calibrate_rejects_empty_and_bad_mode(net):
    sym, params, _, _ = net
    with pytest.raises(QuantizationError):
        calibrate(sym, params, [], ctx=CPU)
    with pytest.raises(QuantizationError):
        calibrate(sym, params, [np.zeros((1, 3, 12, 12), np.float32)],
                  mode="bogus", ctx=CPU)


def test_calib_table_sha_identity_and_atomic_roundtrip(net, tmp_path):
    sym, params, batches, _ = net
    table = calibrate(sym, params, batches, ctx=CPU)
    path = os.path.join(str(tmp_path), "calib.json")
    sha = table.save(path)
    loaded = CalibTable.load(path)
    assert loaded.sha == sha == table.sha
    assert loaded.ranges == table.ranges


def test_calib_table_corruption_fails_typed(net, tmp_path):
    sym, params, batches, _ = net
    table = calibrate(sym, params, batches, ctx=CPU)
    path = os.path.join(str(tmp_path), "calib.json")
    table.save(path)
    doc = json.load(open(path))
    doc["calib_table"]["ranges"]["c1"] = [-99.0, 99.0]
    open(path, "w").write(json.dumps(doc))
    with pytest.raises(QuantizationError, match="sha check"):
        CalibTable.load(path)
    with pytest.raises(QuantizationError, match="unreadable"):
        CalibTable.load(os.path.join(str(tmp_path), "missing.json"))


# -- lowering ---------------------------------------------------------------

def test_quantize_model_int8_close_to_fp32_with_fused_chain(net):
    sym, params, batches, rs = net
    x = batches[-1]
    ref = _fwd(sym, params, x)
    table = calibrate(sym, params, batches, ctx=CPU)
    qsym, qargs, _, report = quantize_model(sym, params, calib=table,
                                            policy="int8", ctx=CPU)
    out = _fwd(qsym, qargs, x)
    err = np.abs(out - ref).max() / np.abs(ref).max()
    assert err < 0.05, err
    assert report["layers"] == {"c1": "int8", "f1": "int8"}
    assert report["passthrough"] == ["a1", "p1"]
    assert report["covered"] == 2 and report["total"] == 2
    assert report["calib_sha"] == table.sha
    args = qsym.list_arguments()
    assert "c1_weight_quantized" in args and "c1_weight" not in args
    assert str(qargs["c1_weight_quantized"].dtype) == "int8"
    assert "f1_data_min" not in args       # fused: one quantize at input


def test_quantize_model_weight_only_needs_no_calib(net):
    sym, params, batches, _ = net
    x = batches[-1]
    ref = _fwd(sym, params, x)
    qsym, qargs, _, report = quantize_model(
        sym, params, policy="int8-weight-only", ctx=CPU)
    out = _fwd(qsym, qargs, x)
    err = np.abs(out - ref).max() / np.abs(ref).max()
    assert err < 0.05, err
    assert report["calib_sha"] is None
    assert set(report["layers"].values()) == {"int8-weight-only"}


def test_quantize_model_int8_requires_calib(net):
    sym, params, _, _ = net
    with pytest.raises(QuantizationError, match="CalibTable"):
        quantize_model(sym, params, policy="int8", ctx=CPU)


def test_policy_exclude_and_first_last(net):
    sym, params, batches, _ = net
    table = calibrate(sym, params, batches, ctx=CPU)
    _, _, _, rep = quantize_model(
        sym, params, calib=table,
        policy=QuantizePolicy(mode="int8", exclude=("f1",)), ctx=CPU)
    assert rep["layers"] == {"c1": "int8", "f1": "fp32:excluded"}
    _, _, _, rep = quantize_model(
        sym, params, calib=table,
        policy=QuantizePolicy(mode="int8", first_last_fp32=True), ctx=CPU)
    assert set(rep["layers"].values()) == {"fp32:first-last-fp32"}


def test_missing_calib_range_falls_back_fp32(net):
    sym, params, batches, _ = net
    table = calibrate(sym, params, batches, ctx=CPU)
    ranges = dict(table.ranges)
    del ranges["data"]
    _, _, _, rep = quantize_model(sym, params, calib=CalibTable(ranges),
                                  policy="int8", ctx=CPU)
    assert rep["layers"]["c1"] == "fp32:no-calib-range"
    assert rep["layers"]["f1"] == "int8"


def test_policy_coerce_boundary():
    assert QuantizePolicy.coerce(None) is None
    assert QuantizePolicy.coerce("off") is None
    assert QuantizePolicy.coerce("int8").mode == "int8"
    assert QuantizePolicy.coerce(
        {"mode": "int8", "max_rel_err": 0.2}).max_rel_err == 0.2
    p = QuantizePolicy(mode="int8-weight-only")
    assert QuantizePolicy.coerce(p) is p
    with pytest.raises(QuantizationError):
        QuantizePolicy.coerce("int4")
    with pytest.raises(QuantizationError):
        QuantizePolicy.coerce(42)
    assert p.to_dict() == jquant.QuantizePolicy(
        mode="int8-weight-only").to_dict()


# -- serving integration ------------------------------------------------------

def test_registry_load_quantized_gate_health_and_unload(net):
    sym, params, batches, rs = net
    reg = ModelRegistry()
    pred = reg.load("qm", sym, params,
                    data_shapes={"data": (4, 3, 12, 12)},
                    ladder=BucketLadder(batches=(1, 2, 4)),
                    quantize="int8", calib_batches=batches, ctx=CPU)
    try:
        assert pred.jit_cache_size() == 0
        h = reg.health("qm")
        q = h["quantization"]
        assert q["mode"] == "int8"
        assert q["covered"] == 2 and q["total"] == 2
        assert len(q["calib_sha"]) == 64
        assert set(q["gate"]["rungs"]) == {1, 2, 4}
        assert q["gate"]["max_rel_err"] <= 0.1
        for b in (1, 2, 4):        # int8 compute provably present
            assert hlo_has_int8_compute(pred, b)
        before = pred.compile_count
        out = pred.predict(
            {"data": rs.randn(3, 3, 12, 12).astype(np.float32)})
        assert out[0].shape == (3, 10)
        assert pred.compile_count == before
        with pytest.raises(tserve.ServeError, match="program_work"):
            pred.lowered_text(pred.rung_shapes(1))
    finally:
        reg.unload("qm", drain=False)
    assert reg.health().get("qm") is None


def test_registry_gate_failure_is_typed_and_installs_nothing(net):
    sym, params, batches, _ = net
    reg = ModelRegistry()
    with pytest.raises(QuantizationError, match="gate"):
        reg.load("qm", sym, params, data_shapes={"data": (4, 3, 12, 12)},
                 quantize=QuantizePolicy(mode="int8", max_rel_err=1e-9),
                 calib_batches=batches, ctx=CPU)
    assert reg.health().get("qm") is None
    assert reg.names() == []


def test_registry_int8_without_calib_fails_typed(net):
    sym, params, _, _ = net
    reg = ModelRegistry()
    with pytest.raises(QuantizationError, match="calib"):
        reg.load("qm", sym, params, data_shapes={"data": (4, 3, 12, 12)},
                 quantize="int8", ctx=CPU)


def test_registry_load_from_saved_calib_path_and_broken_path(net, tmp_path):
    sym, params, batches, _ = net
    table = calibrate(sym, params, batches, ctx=CPU)
    path = os.path.join(str(tmp_path), "calib.json")
    table.save(path)
    reg = ModelRegistry()
    pred = reg.load("qm", sym, params, data_shapes={"data": (4, 3, 12, 12)},
                    ladder=BucketLadder(batches=(1, 4)), quantize="int8",
                    calib=path, ctx=CPU)
    assert pred.quantization["calib_sha"] == table.sha
    reg.unload("qm", drain=False)
    doc = json.load(open(path))
    doc["sha"] = "0" * 64
    open(path, "w").write(json.dumps(doc))
    with pytest.raises(QuantizationError, match="sha check"):
        reg.load("qm2", sym, params, data_shapes={"data": (4, 3, 12, 12)},
                 quantize="int8", calib=path, ctx=CPU)


def test_registry_weight_only_load(net):
    sym, params, _, _ = net
    reg = ModelRegistry()
    pred = reg.load("wq", sym, params, data_shapes={"data": (4, 3, 12, 12)},
                    ladder=BucketLadder(batches=(1, 4)),
                    quantize="int8-weight-only", ctx=CPU)
    try:
        assert pred.quantization["mode"] == "int8-weight-only"
        assert pred.quantization["calib_sha"] is None
        assert reg.health("wq")["quantization"]["mode"] == \
            "int8-weight-only"
        for b in (1, 4):
            assert hlo_has_int8_tensors(pred, b)
            assert not hlo_has_int8_compute(pred, b)
    finally:
        reg.unload("wq", drain=False)


# -- autotune integration -----------------------------------------------------

def test_serve_space_has_quantize_choice():
    from mxnet_tpu_torch.autotune.space import serve_space
    space = serve_space(max_rows=8)
    cfg = space.default()
    assert cfg["quantize"] == "off"
    assert "quantize" in space.params
    assert tuple(space.params["quantize"].options) == \
        ("off", "int8-weight-only", "int8")


def test_serve_measurer_quantized_artifact_records_calib_sha():
    from mxnet_tpu_torch.autotune import trace as T
    from mxnet_tpu_torch.autotune.measure import ServeMeasurer
    tr = T.synth_serve_trace(rate=150.0, seconds=0.3, dim=16, seed=0)
    m = ServeMeasurer(tr, name="qtune", ctx=CPU)
    art = m.measure({"ladder": (1, 2, 4), "quantize": "int8"},
                    budget_frac=0.5)
    assert art["ok"]
    assert art["quantize"] == "int8"
    assert len(art["calib_sha"]) == 64
    assert art["quant_max_rel_err"] <= 0.1
    assert art["request_path_compiles"] == 0
    base = m.measure({"ladder": (1, 2, 4)}, budget_frac=0.5)
    assert "quantize" not in base


# -- parity against the JAX package -------------------------------------------

def _jax_net():
    rs = np.random.RandomState(4)
    pnp = _params_np(rs)
    batches = [rs.randn(4, 3, 12, 12).astype(np.float32) for _ in range(4)]
    return _convnet(jmx), {n: jmx.nd.array(v) for n, v in pnp.items()}, \
        batches


def _port_table(jt):
    """The JAX package's table as the port's (the same sha)."""
    t = CalibTable(jt.ranges, mode=jt.mode, percentile=jt.percentile,
                   batches=jt.batches)
    assert t.sha == jt.sha
    return t


def _close_tables(t, j):
    assert set(t.ranges) == set(j.ranges)
    for n, (lo, hi) in j.ranges.items():
        scale = max(abs(lo), abs(hi), 1e-30)
        assert abs(t.ranges[n][0] - lo) <= RANGE_TOL * scale, n
        assert abs(t.ranges[n][1] - hi) <= RANGE_TOL * scale, n


@pytest.mark.parametrize("mode", ["minmax", "percentile"])
def test_calibration_matches_jax(net, mode):
    sym, params, batches, _ = net
    jsym, jparams, jbatches = _jax_net()
    t = calibrate(sym, params, batches, mode=mode, percentile=99.0,
                  ctx=CPU)
    j = jquant.calibrate(jsym, jparams, jbatches, mode=mode,
                         percentile=99.0)
    _close_tables(t, j)
    assert (t.mode, t.percentile, t.batches) == \
        (j.mode, j.percentile, j.batches)


@pytest.mark.parametrize("direction", ["port-to-jax", "jax-to-port"])
def test_calib_table_files_cross_with_the_same_sha(net, tmp_path,
                                                   direction):
    sym, params, batches, _ = net
    jsym, jparams, jbatches = _jax_net()
    path = str(tmp_path / "calib.json")
    if direction == "port-to-jax":
        table = calibrate(sym, params, batches, ctx=CPU)
        sha = table.save(path)
        loaded = jquant.CalibTable.load(path)
    else:
        table = jquant.calibrate(jsym, jparams, jbatches)
        sha = table.save(path)
        loaded = CalibTable.load(path)
    assert loaded.sha == sha == table.sha
    assert loaded.ranges == table.ranges
    # the same payload hashes alike in both packages
    assert CalibTable(table.ranges).sha == \
        jquant.CalibTable(table.ranges).sha


@pytest.mark.parametrize("mode", ["int8", "int8-weight-only"])
def test_quantize_model_same_json_and_weights(net, mode):
    sym, params, _, _ = net
    jsym, jparams, jbatches = _jax_net()
    jt = jquant.calibrate(jsym, jparams, jbatches)
    calib = _port_table(jt) if mode == "int8" else None
    tq = quantize_model(sym, params, calib=calib, policy=mode, ctx=CPU)
    jq = jquant.quantize_model(jsym, jparams, calib=jt if calib else None,
                               policy=mode)
    assert _canon_json(tq[0]) == _canon_json(jq[0])
    assert sorted(tq[1]) == sorted(jq[1])
    for n in jq[1]:
        a, b = tq[1][n].asnumpy(), jq[1][n].asnumpy()
        assert a.dtype == b.dtype and a.shape == b.shape, n
        np.testing.assert_array_equal(a, b, err_msg=n)
    assert tq[3] == jq[3]


_ONE_TUPLE = re.compile(r"^\((-?[0-9]+)\)$")


def _canon_json(sym):
    """A symbol's JSON, past the packages' known writing differences."""
    doc = json.loads(sym.tojson())
    doc.get("attrs", {}).pop("framework", None)
    for node in doc["nodes"]:
        for k, v in list(node.get("attrs", {}).items()):
            node["attrs"][k] = _ONE_TUPLE.sub(r"(\1,)", v)
    return doc


def _hold_outputs(got, want):
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= OUT_TOL * np.abs(want).max()
    if want.ndim >= 2:
        agree = (got.argmax(-1) == want.argmax(-1)).mean()
        assert agree >= ARGMAX_SHARE, agree


def test_quantized_convnet_outputs_match_jax(net):
    sym, params, batches, rs = net
    jsym, jparams, jbatches = _jax_net()
    jt = jquant.calibrate(jsym, jparams, jbatches)
    tq = quantize_model(sym, params, calib=_port_table(jt), ctx=CPU)
    jq = jquant.quantize_model(jsym, jparams, calib=jt)
    x = np.random.RandomState(9).randn(16, 3, 12, 12).astype(np.float32)
    got = _fwd(tq[0], tq[1], x)
    want = jq[0].bind(args=dict(jq[1], data=jmx.nd.array(x))) \
        .forward()[0].asnumpy()
    _hold_outputs(got, want)


@pytest.fixture(scope="module")
def lm_prefix(tmp_path_factory):
    """The JAX LM's weights carried into the port and exported by it (the
    JAX package serves the port's export of this model, not its own)."""
    d = tmp_path_factory.mktemp("qlm")
    rs = np.random.RandomState(0)
    tok = rs.randint(0, LM_CFG["vocab"], (2, LM_SEQ)).astype(np.float32)
    jnet = jax_lm(**LM_CFG)
    jnet.initialize(ctx=jmx.cpu())
    jnet.hybridize()
    jnet(jmx.nd.array(tok, ctx=jmx.cpu()))
    jparams = {k: v.data().asnumpy()
               for k, v in jnet.collect_params().items()}
    pnet = port_lm(**LM_CFG)
    pnet.initialize(ctx=CPU)
    load_jax_params(pnet, jparams)
    pnet.hybridize()
    pnet(tmx.nd.array(tok, ctx=CPU))
    out = str(d / "lm")
    pnet.export(out, 0)
    return out


def _lm_batches(n=4, rows=2, seed=1):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, LM_CFG["vocab"], (rows, LM_SEQ))
            .astype(np.float32) for _ in range(n)]


def test_quantized_lm_outputs_match_jax(lm_prefix):
    tsym, targs, taux = tmx.model.load_checkpoint(lm_prefix, 0, ctx=CPU)
    jsym, jargs, jaux = jmx.model.load_checkpoint(lm_prefix, 0)
    batches = [{"data0": b} for b in _lm_batches()]
    jt = jquant.calibrate(jsym, jargs, batches, aux_params=jaux)
    t = calibrate(tsym, targs, batches, aux_params=taux, ctx=CPU)
    _close_tables(t, jt)
    tq = quantize_model(tsym, targs, calib=_port_table(jt),
                        aux_params=taux, ctx=CPU)
    jq = jquant.quantize_model(jsym, jargs, calib=jt, aux_params=jaux)
    assert _canon_json(tq[0]) == _canon_json(jq[0])
    assert tq[3]["covered"] == jq[3]["covered"] > 0
    x = _lm_batches(1, rows=3, seed=5)[0]
    got = tq[0].bind(CPU, args=dict(tq[1], data0=nd.array(x, ctx=CPU)),
                     aux_states=tq[2]).forward()[0].asnumpy()
    want = jq[0].bind(args=dict(jq[1], data0=jmx.nd.array(x)),
                      aux_states=jq[2]).forward()[0].asnumpy()
    _hold_outputs(got, want)


def _gate(pkg, load, **kw):
    """(verdict, worst rel err or the error text) of one quantized load."""
    try:
        pred = load(**kw)
    except (QuantizationError, jquant.QuantizationError) as exc:
        return "fail", str(exc)
    return "pass", pred.quantization["gate"]["max_rel_err"]


@pytest.mark.parametrize("policy", [
    "int8", "int8-weight-only",
    {"mode": "int8", "max_rel_err": 1e-9},
    {"mode": "int8", "first_last_fp32": True}], ids=str)
def test_gate_verdict_matches_jax_convnet(net, policy):
    sym, params, batches, _ = net
    jsym, jparams, jbatches = _jax_net()
    kw = dict(data_shapes={"data": (4, 3, 12, 12)}, quantize=policy)
    mode = policy if isinstance(policy, str) else policy["mode"]
    cal = mode == "int8"
    verdicts = {
        "port": _gate("port", lambda **k: ModelRegistry().load(
            "g", sym, params, ladder=BucketLadder(batches=(1, 4)),
            calib_batches=batches if cal else None, ctx=CPU, **k), **kw),
        "jax": _gate("jax", lambda **k: jserve.ModelRegistry().load(
            "g", jsym, jparams, ladder=jserve.BucketLadder(batches=(1, 4)),
            calib_batches=jbatches if cal else None, **k), **kw)}
    assert verdicts["port"][0] == verdicts["jax"][0], verdicts
    if verdicts["jax"][0] == "pass":
        assert abs(verdicts["port"][1] - verdicts["jax"][1]) <= OUT_TOL


@pytest.mark.parametrize("mode", ["int8", "int8-weight-only"])
def test_gate_verdict_matches_jax_lm(lm_prefix, mode):
    batches = [{"data0": b} for b in _lm_batches()]
    kw = dict(data_shapes={"data0": (1, LM_SEQ)}, quantize=mode,
              calib_batches=batches if mode == "int8" else None)
    verdicts = {
        "port": _gate("port", lambda **k: ModelRegistry().load_checkpoint(
            "g", lm_prefix, 0, ladder=BucketLadder(batches=(1, 2)),
            ctx=CPU, **k), **kw),
        "jax": _gate("jax", lambda **k: jserve.ModelRegistry()
                     .load_checkpoint("g", lm_prefix, 0,
                                      ladder=jserve.BucketLadder(
                                          batches=(1, 2)), **k), **kw)}
    assert verdicts["port"][0] == verdicts["jax"][0], verdicts
    if verdicts["jax"][0] == "pass":
        assert abs(verdicts["port"][1] - verdicts["jax"][1]) <= OUT_TOL


def test_health_sections_match_jax(net):
    sym, params, batches, _ = net
    jsym, jparams, jbatches = _jax_net()
    treg, jreg = ModelRegistry(), jserve.ModelRegistry()
    try:
        treg.load("h", sym, params, data_shapes={"data": (4, 3, 12, 12)},
                  ladder=BucketLadder(batches=(1, 4)), quantize="int8",
                  calib_batches=batches, ctx=CPU)
        jreg.load("h", jsym, jparams, data_shapes={"data": (4, 3, 12, 12)},
                  ladder=jserve.BucketLadder(batches=(1, 4)),
                  quantize="int8", calib_batches=jbatches)
        th, jh = treg.health("h"), jreg.health("h")
        assert set(th) == set(jh)
        tq, jq = th["quantization"], jh["quantization"]
        assert set(tq) == set(jq)
        assert {k: tq[k] for k in ("mode", "covered", "total", "layers")} \
            == {k: jq[k] for k in ("mode", "covered", "total", "layers")}
        assert set(tq["gate"]) == set(jq["gate"])
        assert set(tq["gate"]["rungs"]) == set(jq["gate"]["rungs"])
    finally:
        treg.close()
        jreg.close()


# -- the proof of int8 compute, per rung -------------------------------------

@pytest.mark.parametrize("mode", ["int8", "int8-weight-only"])
def test_int8_work_per_rung(net, mode):
    sym, params, batches, _ = net
    reg = ModelRegistry()
    pred = reg.load("w", sym, params, data_shapes={"data": (4, 3, 12, 12)},
                    ladder=BucketLadder(batches=(1, 2, 4)), quantize=mode,
                    calib_batches=batches, ctx=CPU)
    fp32 = reg.load("f", sym, params, data_shapes={"data": (4, 3, 12, 12)},
                    ladder=BucketLadder(batches=(1, 2, 4)), ctx=CPU)
    try:
        for b in (1, 2, 4):
            w, f = int8_work(pred, b), int8_work(fp32, b)
            assert f["int8_products"] == 0 and f["float_products"] == 2
            if mode == "int8":
                # both layers run int8 x int8 -> int32, no float product
                assert w["int8_products"] == 2
                assert w["float_products"] == 0
                assert w["compute_bytes"] < f["compute_bytes"]
            else:
                assert w["int8_products"] == 0
                assert w["int8_dequantized"] == 2
            gate = pred.quantization["gate"]["rungs"][b]
            assert gate["work"] == w and gate["fp32_work"] == f
    finally:
        reg.close()


# -- quantized .params files cross in both directions -------------------------

@pytest.mark.parametrize("direction", ["port-to-jax", "jax-to-port"])
def test_quantized_params_files_cross(net, tmp_path, direction):
    sym, params, batches, _ = net
    jsym, jparams, jbatches = _jax_net()
    jt = jquant.calibrate(jsym, jparams, jbatches)
    path = str(tmp_path / "q.params")
    if direction == "port-to-jax":
        _, qargs, _, _ = quantize_model(sym, params,
                                        calib=_port_table(jt), ctx=CPU)
        nd.save(path, qargs)
        back = jmx.nd.load(path)
    else:
        _, qargs, _, _ = jquant.quantize_model(jsym, jparams, calib=jt)
        jmx.nd.save(path, qargs)
        back = nd.load(path, ctx=CPU)
    assert sorted(back) == sorted(qargs)
    kinds = set()
    for n, v in qargs.items():
        a, b = v.asnumpy(), back[n].asnumpy()
        assert a.dtype == b.dtype and a.shape == b.shape, n
        np.testing.assert_array_equal(a, b, err_msg=n)
        kinds.add(str(a.dtype))
    assert {"int8", "int32", "float32"} <= kinds
    assert any(n.endswith("_quantized") for n in qargs)
    assert any(n.endswith("_min") for n in qargs)
