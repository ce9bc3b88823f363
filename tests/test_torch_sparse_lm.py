"""The slice's LM path on the CPU: the transformer LM (2 layers, dim 64,
vocab 500, seq 16) traced to a Symbol whose Embedding node carries
``sparse_grad`` = True in its JSON, as a user's saved symbol would (in
the JAX package's graph, set in place),
trained through ``Module`` with SGD (momentum 0.9, wd 1e-3, the lazy
update) in both packages from the same weights (the JAX package's,
crossed by ``gluon.load_jax_params``) on the same batches.

After 3 steps every weight and momentum is the JAX package's within
1e-5 x max(1, max |JAX|); the Embedding rows no batch touched are
bit-unchanged in weight and momentum; the port's step is the fused one
(its gradient pairs inside the program), and the executor holds the
table's gradient as (ids, rows) pairs, no dense (vocab, dim) buffer.
"""

import json
import os
import pickle

import numpy as np

import mxnet_tpu as jmx
import mxnet_tpu.gluon.model_zoo.transformer  # noqa: F401
import mxnet_tpu_torch as tmx
import mxnet_tpu_torch.gluon.model_zoo.transformer  # noqa: F401
from mxnet_tpu_torch.gluon import load_jax_params

VOCAB, DIM, HEADS, LAYERS, SEQ, BATCH = 500, 64, 4, 2, 16, 4
SEEN = 240              # the batches draw ids below this
OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3}
STEPS = 3


def _symbol(mx):
    net = mx.gluon.model_zoo.transformer.get_transformer_lm(
        vocab=VOCAB, dim=DIM, heads=HEADS, layers=LAYERS, max_seq=SEQ,
        prefix="slm_")
    out = mx.sym.SoftmaxOutput(net(mx.sym.var("data")),
                               mx.sym.var("softmax_label"),
                               preserve_shape=True, normalization="valid",
                               name="softmax")
    if mx is jmx:
        # the JAX package's load_json reads a 1-d variable shape back as
        # an int (ROADMAP "Caveats"), so its graph is set in place
        for node in out._topo():
            if not node.is_var and node.op.name == "Embedding":
                node.params["sparse_grad"] = True
        return net, out
    graph = json.loads(out.tojson())
    for node in graph["nodes"]:
        if node["op"] == "Embedding":
            node["attrs"]["sparse_grad"] = "True"
    return net, mx.sym.load_json(json.dumps(graph))


def _batches():
    rs = np.random.RandomState(11)
    return [(rs.randint(0, SEEN, (BATCH, SEQ)).astype(np.float32),
             rs.randint(0, SEEN, (BATCH, SEQ)).astype(np.float32))
            for _ in range(STEPS)]


def _train(mx, ctx, arg_params, tmp):
    _, sym = _symbol(mx)
    mod = mx.mod.Module(sym, context=ctx)
    mod.bind([("data", (BATCH, SEQ))], [("softmax_label", (BATCH, SEQ))])
    mod.init_params(arg_params=arg_params, aux_params={})
    mod.init_optimizer(optimizer="sgd", optimizer_params=dict(OPT))
    for x, y in _batches():
        mod.forward_backward_update(mx.io.DataBatch(
            [mx.nd.array(x, ctx=ctx)], [mx.nd.array(y, ctx=ctx)]))
    args = {n: a.asnumpy() for n, a in mod.get_params()[0].items()}
    names = mod._exec_group.param_names
    path = os.path.join(tmp, type(mod).__module__.split(".")[0] + ".states")
    mod.save_optimizer_states(path)     # the format-2 blob of both packages
    with open(path, "rb") as f:
        states = pickle.load(f)["states"]
    moms = {names[i]: v[1] for i, v in states.items() if v[0] == "nd"}
    return mod, args, moms


def test_sparse_embedding_lm_matches_jax_through_module(tmp_path):
    jnet, _ = _symbol(jmx)
    jmx.random.seed(3)
    jnet.initialize(jmx.init.Xavier())
    jnet(jmx.nd.zeros((1, SEQ)))
    jparams = {n: p.data() for n, p in jnet.collect_params().items()}
    tnet, _ = _symbol(tmx)
    tnet.initialize(ctx=tmx.cpu())
    load_jax_params(tnet, jparams)
    tparams = {n: p.data() for n, p in tnet.collect_params().items()}

    _, want, want_m = _train(jmx, jmx.cpu(), jparams, str(tmp_path))
    mod, got, got_m = _train(tmx, tmx.cpu(), tparams, str(tmp_path))

    assert mod.fused_step is not None
    ex = mod._exec_group.execs[0]
    g = ex.grad_dict["slm_embedding0_weight"]
    # the fused step keeps its pairs inside the program; the executor's
    # container is the bind-time one, never a (vocab, dim) buffer
    assert g.stype == "row_sparse" and g.data.shape == (1, DIM)
    assert sorted(got) == sorted(want) and sorted(got_m) == sorted(want_m)
    assert "slm_embedding0_weight" in got_m and len(got_m) == len(got)
    for table, ref in ((got, want), (got_m, want_m)):
        for n, w in ref.items():
            err = np.abs(table[n] - w).max()
            assert err <= 1e-5 * max(1.0, np.abs(w).max()), (n, err)
    w0 = jparams["slm_embedding0_weight"].asnumpy()
    emb, mom = got["slm_embedding0_weight"], \
        got_m["slm_embedding0_weight"]
    np.testing.assert_array_equal(emb[SEEN:], w0[SEEN:])
    np.testing.assert_array_equal(mom[SEEN:], 0)
    assert not np.array_equal(emb[:SEEN], w0[:SEEN])
