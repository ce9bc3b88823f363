"""The port's slice as a whole: serve the transformer LM from a checkpoint.

One small LM (vocab 40, dim 32, 4 heads, 2 layers, max_seq 48) is
exported by the JAX package; the port serves that checkpoint, the JAX
package serves the port's export of the same weights, and both answer
requests of 1 and 3 rows at ladder (1, 2, 4) with equal logits (f32,
atol 1e-5).  Symbol JSON and ``.params`` files cross both ways.
"""

import json

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import serve as jserve
from mxnet_tpu.gluon.model_zoo.transformer import \
    get_transformer_lm as jax_lm
from mxnet_tpu.symbol import symbol as jsym

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import serve as tserve
from mxnet_tpu_torch.gluon import load_jax_params
from mxnet_tpu_torch.gluon.model_zoo.transformer import \
    get_transformer_lm as port_lm
from mxnet_tpu_torch.symbol import symbol as tsym

# an explicit prefix pins the parameter names in both packages, whatever
# models the process built before
CFG = dict(vocab=40, dim=32, heads=4, layers=2, max_seq=48,
           prefix="transformerlm0_")
SEQ = 16
LADDER = (1, 2, 4)


def _tokens(rows, seed):
    return np.random.RandomState(seed).randint(
        0, CFG["vocab"], (rows, SEQ)).astype(np.float32)


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """A JAX LM, its forward on two requests and its exported checkpoint;
    then a port LM carrying the same weights, and its own export."""
    d = tmp_path_factory.mktemp("lm")
    jnet = jax_lm(**CFG)
    jnet.initialize(ctx=jmx.cpu())
    jnet.hybridize()
    jnet(jmx.nd.array(_tokens(2, 0), ctx=jmx.cpu()))
    jax_prefix = str(d / "jax")
    jnet.export(jax_prefix, 0)
    jparams = {k: v.data().asnumpy()
               for k, v in jnet.collect_params().items()}
    want = {rows: jnet(jmx.nd.array(_tokens(rows, rows),
                                    ctx=jmx.cpu())).asnumpy()
            for rows in (1, 3)}

    pnet = port_lm(**CFG)
    pnet.initialize(ctx=tmx.cpu())
    load_jax_params(pnet, jparams)
    pnet.hybridize()
    pnet(tmx.nd.array(_tokens(2, 0), ctx=tmx.cpu()))
    port_prefix = str(d / "port")
    pnet.export(port_prefix, 0)
    return dict(jnet=jnet, jparams=jparams, want=want, pnet=pnet,
                jax_prefix=jax_prefix, port_prefix=port_prefix)


def test_collect_params_same_names_and_shapes(exported):
    pnet = exported["pnet"]
    jparams = exported["jparams"]
    mine = pnet.collect_params()
    assert list(mine.keys()) == list(jparams.keys())
    for name, p in mine.items():
        assert p.shape == jparams[name].shape, name
    assert "transformerlm0_h0_multiheadattention0_query_weight" in mine


@pytest.mark.parametrize("rows", [1, 3])
@pytest.mark.parametrize("hybridize", [False, True])
def test_load_jax_params_forward_matches_jax(exported, rows, hybridize):
    pnet = port_lm(**CFG)
    pnet.initialize(ctx=tmx.cpu())
    load_jax_params(pnet, exported["jparams"])
    if hybridize:
        pnet.hybridize()
    got = pnet(tmx.nd.array(_tokens(rows, rows), ctx=tmx.cpu())).asnumpy()
    np.testing.assert_allclose(got, exported["want"][rows], rtol=0,
                               atol=1e-5)


def test_load_jax_params_from_a_jax_params_file(exported):
    pnet = port_lm(**CFG)
    pnet.initialize(ctx=tmx.cpu())
    load_jax_params(pnet, jmx.nd.load(exported["jax_prefix"] +
                                      "-0000.params"))
    got = pnet(tmx.nd.array(_tokens(1, 1), ctx=tmx.cpu())).asnumpy()
    np.testing.assert_allclose(got, exported["want"][1], rtol=0, atol=1e-5)


@pytest.mark.parametrize("fault", ["missing", "extra", "shape", "dtype"])
def test_load_jax_params_checks_names_shapes_dtypes(exported, fault):
    params = dict(exported["jparams"])
    name = "transformerlm0_h0_dense0_weight"
    if fault == "missing":
        del params[name]
    elif fault == "extra":
        params["transformerlm0_bogus_weight"] = np.zeros(3, np.float32)
    elif fault == "shape":
        params[name] = np.zeros((3, 3), np.float32)
    else:
        params[name] = params[name].astype(np.float64)
    pnet = port_lm(**CFG)
    pnet.initialize(ctx=tmx.cpu())
    with pytest.raises(tmx.MXNetError, match=fault if fault != "shape"
                       else "shape"):
        load_jax_params(pnet, params)


@pytest.mark.parametrize("rows", [1, 3])
def test_both_registries_serve_each_others_checkpoint(exported, rows):
    x = _tokens(rows, rows)
    preg = tserve.ModelRegistry()
    preg.load_checkpoint("lm", exported["jax_prefix"], 0,
                         data_shapes={"data0": (1, SEQ)},
                         ladder=tserve.BucketLadder(batches=LADDER),
                         ctx=tmx.cpu())
    port_out = preg.predict("lm", x)[0].asnumpy()
    # the JAX package cannot serve its own export of this model (its JSON
    # writes slice_like's axes=(1,) as "(1)", read back as the int 1); it
    # serves the port's export of the same weights
    jreg = jserve.ModelRegistry()
    jreg.load_checkpoint("lm", exported["port_prefix"], 0,
                         data_shapes={"data0": (1, SEQ)},
                         ladder=jserve.BucketLadder(batches=LADDER),
                         ctx=jmx.cpu())
    jax_out = jreg.predict("lm", x)[0].asnumpy()
    assert port_out.shape == (rows, SEQ, CFG["vocab"])
    np.testing.assert_allclose(port_out, jax_out, rtol=0, atol=1e-5)
    np.testing.assert_allclose(port_out, exported["want"][rows], rtol=0,
                               atol=1e-5)


def test_jax_export_of_slice_like_axes_reads_back_as_int(exported):
    sym = jsym.load(exported["jax_prefix"] + "-symbol.json")
    node = next(n for n in sym._topo()
                if not n.is_var and n.op.name == "slice_like")
    assert node.params["axes"] == 1
    psym = tsym.load(exported["port_prefix"] + "-symbol.json")
    node = next(n for n in psym._topo()
                if not n.is_var and n.op.name == "slice_like")
    assert node.params["axes"] == (1,)


def _graph(sym):
    return [(n.op.name if n.op else "null", n.name,
             [(s.name, i) for s, i in n.inputs]) for n in sym._topo()]


def test_symbol_json_round_trips_both_ways(exported):
    with open(exported["jax_prefix"] + "-symbol.json") as f:
        jax_json = f.read()
    jax_sym = jsym.load_json(jax_json)
    port_sym = tsym.load_json(jax_json)
    back = jsym.load_json(port_sym.tojson())
    assert _graph(back) == _graph(jax_sym) == _graph(port_sym)
    assert back.list_arguments() == jax_sym.list_arguments() == \
        port_sym.list_arguments()
    assert back.list_outputs() == jax_sym.list_outputs() == \
        port_sym.list_outputs()
    # the port's own trace has the JAX package's graph, up to node names
    with open(exported["port_prefix"] + "-symbol.json") as f:
        port_json = json.load(f)
    ops = [n["op"] for n in json.loads(jax_json)["nodes"]]
    assert [n["op"] for n in port_json["nodes"]] == ops
    assert [n["name"] for n in port_json["nodes"] if n["op"] == "null"] == \
        [n["name"] for n in json.loads(jax_json)["nodes"]
         if n["op"] == "null"]
    again = tsym.load_json(port_sym.tojson())
    assert again.tojson() == port_sym.tojson()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32",
                                   "float16"])
def test_params_files_cross_both_ways(tmp_path, dtype):
    rng = np.random.RandomState(0)
    vals = {"a": rng.standard_normal((3, 4)), "b": rng.standard_normal(5)}
    jarrs = {k: jmx.nd.array(v, ctx=jmx.cpu(), dtype=dtype)
             for k, v in vals.items()}
    jmx.nd.save(str(tmp_path / "j.params"), jarrs)
    loaded = tmx.nd.load(str(tmp_path / "j.params"), ctx=tmx.cpu())
    assert sorted(loaded) == ["a", "b"]
    for k in vals:
        assert loaded[k].dtype == jarrs[k].dtype
        np.testing.assert_array_equal(
            loaded[k].asnumpy().astype(np.float32),
            jarrs[k].asnumpy().astype(np.float32))
    tmx.nd.save(str(tmp_path / "t.params"), [loaded["a"], loaded["b"]])
    back = jmx.nd.load(str(tmp_path / "t.params"))
    assert isinstance(back, list) and len(back) == 2
    np.testing.assert_array_equal(back[0].asnumpy(), jarrs["a"].asnumpy())
    assert back[1].dtype == jarrs["b"].dtype


def test_predictor_warms_every_rung_and_trims(exported):
    reg = tserve.ModelRegistry()
    pred = reg.load_checkpoint("lm", exported["jax_prefix"], 0,
                               data_shapes={"data0": (1, SEQ)},
                               ladder=tserve.BucketLadder(batches=LADDER),
                               ctx=tmx.cpu())
    assert pred.compile_count == len(LADDER)
    for rows in (1, 2, 3, 4):
        out = reg.predict("lm", {"data0": _tokens(rows, rows)})
        assert out[0].shape == (rows, SEQ, CFG["vocab"])
    assert pred.compile_count == len(LADDER)
    assert pred.dispatch_count == 4
    one = reg.predict("lm", _tokens(1, 1)[0])[0]   # no batch dim
    assert one.shape == (1, SEQ, CFG["vocab"])
    with pytest.raises(tserve.ServeError, match="top rung"):
        reg.predict("lm", _tokens(5, 5))
    assert reg.names() == ["lm"]
    reg.unload("lm")
    with pytest.raises(tserve.ServeError, match="no model"):
        reg.get("lm")


def test_predictor_rejects_unknown_inputs(exported):
    with pytest.raises(tserve.ServeError, match="data inputs"):
        tserve.ModelRegistry().load_checkpoint(
            "lm", exported["jax_prefix"], 0, data_shapes={"data": (1, SEQ)},
            ctx=tmx.cpu())


def test_plain_attention_graph_override_matches(exported):
    """The chip check evaluates the served graph with the plain attention
    swapped in through ``_build_eval(op_impls=...)``."""
    from mxnet_tpu_torch.executor import _build_eval
    from mxnet_tpu_torch.model import load_checkpoint
    from mxnet_tpu_torch.ops import attention as att
    sym, args, _ = load_checkpoint(exported["jax_prefix"], 0, ctx=tmx.cpu())
    calls = []

    def plain(q, k, v, causal=False, sm_scale=None, chunk=512):
        calls.append(q.shape)
        return att._chunked_attention(q, k, v, bool(causal), sm_scale)
    ev = _build_eval(sym, False, op_impls={
        "_contrib_DotProductAttention": plain})
    amap = {n: a._data for n, a in args.items()}
    amap["data0"] = torch.from_numpy(_tokens(3, 3))
    out = ev(amap, {})[0][0]
    assert len(calls) == CFG["layers"]
    np.testing.assert_allclose(out.numpy(), exported["want"][3], rtol=0,
                               atol=1e-5)


def test_save_checkpoint_reads_back_in_the_jax_package(exported, tmp_path):
    from mxnet_tpu import model as jmodel
    from mxnet_tpu_torch import model as tmodel
    sym, args, aux = tmodel.load_checkpoint(exported["jax_prefix"], 0,
                                            ctx=tmx.cpu())
    prefix = str(tmp_path / "again")
    tmodel.save_checkpoint(prefix, 3, sym, args, aux)
    jsym_, jargs, jaux = jmodel.load_checkpoint(prefix, 3)
    assert jsym_.list_arguments() == sym.list_arguments()
    assert sorted(jargs) == sorted(args) and jaux == {}
    for name, arr in args.items():
        np.testing.assert_array_equal(jargs[name].asnumpy(), arr.asnumpy())


@pytest.mark.parametrize("value", [np.array(3.5, np.float32),
                                   np.array(7, np.int32), np.float32(2.0)],
                         ids=["0d-f32", "0d-i32", "np-scalar"])
def test_predictor_as_tensor_keeps_0d_like_jax(value):
    """A 0-d request array stays 0-d on its way to a tensor, as the JAX
    predictor's host conversion keeps it."""
    from mxnet_tpu.serve.predictor import _as_jnp
    from mxnet_tpu_torch.serve.predictor import _as_tensor
    got = _as_tensor(value)
    want = _as_jnp(value)
    assert tuple(got.shape) == want.shape == ()
    assert got.item() == want.item()


@pytest.mark.parametrize("bad", [[0, 3, 40, -1], [0, -40, 7, 1],
                                 [-41, 3, 5, 1]],
                         ids=["past-table", "wrap-to-0", "below-range"])
def test_ids_out_of_range_served_like_jax(exported, bad):
    """Both registries answer a request with ids outside [0, vocab) the
    same way: -vocab..-1 wrap (finite, equal answers); an id past the
    table or below -vocab embeds as NaN, and every logit of the
    sequence is NaN in both (attention's zero weights times a NaN
    value)."""
    x = _tokens(1, 9)
    x[0, :4] = bad
    preg = tserve.ModelRegistry()
    preg.load_checkpoint("lm", exported["port_prefix"], 0,
                         data_shapes={"data0": (1, SEQ)},
                         ladder=tserve.BucketLadder(batches=(1,)),
                         ctx=tmx.cpu())
    jreg = jserve.ModelRegistry()
    jreg.load_checkpoint("lm", exported["port_prefix"], 0,
                         data_shapes={"data0": (1, SEQ)},
                         ladder=jserve.BucketLadder(batches=(1,)),
                         ctx=jmx.cpu())
    port_out = preg.predict("lm", x)[0].asnumpy()
    jax_out = jreg.predict("lm", x)[0].asnumpy()
    np.testing.assert_array_equal(np.isnan(port_out), np.isnan(jax_out))
    assert np.isnan(port_out).all() == (bad != [0, -40, 7, 1])
    np.testing.assert_allclose(np.nan_to_num(port_out),
                               np.nan_to_num(jax_out), rtol=0, atol=1e-5)
