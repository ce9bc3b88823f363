"""Sparse storage in mxnet_tpu_torch against the JAX package on the CPU
(mirrors tests/test_sparse.py): ``nd.sparse``, the lazy row updates,
``Embedding(sparse_grad=True)`` through gluon and through the executor,
CSR arguments of a bound graph, ``LibSVMIter``, sparse ``.params``
entries and the sparse linear classification flow.

Each case feeds the same seeded numpy inputs to both packages.
Tolerances: outputs within 1e-5 x max(1, max |JAX|), gradients within
1e-4 x max |g|; ids, indptr, batches and files' entries equal; rows a
lazy update does not touch bit-unchanged.

The reference file's two kvstore cases (``row_sparse_pull``, a local
kvstore's row-sparse push and pull) wait for the kvstore's port (ROADMAP
queue A item 14).
"""

import os
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.ndarray import sparse as jsp
from mxnet_tpu_torch.ndarray import sparse as tsp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = tmx.cpu()


def _np(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def _close(got, want, tol=1e-5):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.abs(got - want).max(initial=0.0) <= \
        tol * max(1.0, float(np.abs(want).max(initial=0.0)))


def _rand_dense(rs, rows, cols, density=0.2):
    dense = rs.randn(rows, cols).astype(np.float32)
    dense[rs.rand(rows, cols) > density] = 0
    return dense


# -- nd.sparse --------------------------------------------------------------

@pytest.mark.parametrize("transpose_a", [False, True])
def test_csr_dot_matches_jax(transpose_a):
    rs = np.random.RandomState(int(transpose_a))
    dense = _rand_dense(rs, 6, 8)
    rhs = rs.randn(6 if transpose_a else 8, 3).astype(np.float32)
    got = tsp.dot(tsp.csr_matrix(dense, shape=(6, 8), ctx=CPU),
                  tmx.nd.array(rhs, ctx=CPU), transpose_a=transpose_a)
    want = jsp.dot(jsp.csr_matrix(dense, shape=(6, 8)), jmx.nd.array(rhs),
                   transpose_a=transpose_a)
    _close(got, want)
    _close(got, (dense.T if transpose_a else dense) @ rhs)


def test_csr_dot_relaunch_is_bit_equal():
    rs = np.random.RandomState(2)
    dense = _rand_dense(rs, 40, 30, 0.3)
    csr = tsp.csr_matrix(dense, ctx=CPU)
    rhs = tmx.nd.array(rs.randn(30, 5).astype(np.float32), ctx=CPU)
    a, b = tsp.dot(csr, rhs).asnumpy(), tsp.dot(csr, rhs).asnumpy()
    np.testing.assert_array_equal(a, b)


def test_csr_components_and_row_slice_match_jax():
    rs = np.random.RandomState(3)
    dense = _rand_dense(rs, 7, 9)
    t, j = tsp.csr_matrix(dense, ctx=CPU), jsp.csr_matrix(dense)
    for key in (slice(None), slice(2, 5), slice(0, 1)):
        ts, js = (t, j) if key == slice(None) else (t[key], j[key])
        for part in ("data", "indices", "indptr"):
            np.testing.assert_array_equal(getattr(ts, part).asnumpy(),
                                          getattr(js, part).asnumpy())
        np.testing.assert_array_equal(ts.asnumpy(), js.asnumpy())
    assert t.stype == "csr" and t.shape == (7, 9)


def test_tostype_and_cast_storage_match_jax():
    rs = np.random.RandomState(4)
    dense = _rand_dense(rs, 6, 5, 0.4)
    dense[2] = 0
    t, j = tmx.nd.array(dense, ctx=CPU), jmx.nd.array(dense)
    for stype in ("row_sparse", "csr"):
        ts, js = t.tostype(stype), j.tostype(stype)
        assert ts.stype == js.stype == stype
        np.testing.assert_array_equal(ts.indices.asnumpy(),
                                      js.indices.asnumpy())
        np.testing.assert_array_equal(ts.asnumpy(), dense)
        np.testing.assert_array_equal(
            tsp.cast_storage(ts, "default").asnumpy(), dense)


def test_rowsparse_todense_duplicate_rows_sum():
    a = tsp.row_sparse_array((np.ones((2, 3), np.float32), [1, 4]),
                             shape=(6, 3), ctx=CPU)
    b = tsp.row_sparse_array((2 * np.ones((2, 3), np.float32), [1, 2]),
                             shape=(6, 3), ctx=CPU)
    summed = tsp.sparse_add(a, b).todense().asnumpy()
    want = jsp.sparse_add(
        jsp.row_sparse_array((np.ones((2, 3), np.float32), [1, 4]),
                             shape=(6, 3)),
        jsp.row_sparse_array((2 * np.ones((2, 3), np.float32), [1, 2]),
                             shape=(6, 3))).todense().asnumpy()
    np.testing.assert_array_equal(summed, want)
    assert summed[1, 0] == 3 and summed[4, 0] == 1 and summed[2, 0] == 2


def test_retain_and_elemwise_mul_match_jax():
    vals = np.arange(6, dtype=np.float32).reshape(3, 2)
    t = tsp.row_sparse_array((vals, [1, 3, 5]), shape=(7, 2), ctx=CPU)
    j = jsp.row_sparse_array((vals, [1, 3, 5]), shape=(7, 2))
    kt = tsp.retain(t, tmx.nd.array([3, 4], ctx=CPU))
    kj = jsp.retain(j, jmx.nd.array([3, 4]))
    np.testing.assert_array_equal(kt.asnumpy(), kj.asnumpy())
    np.testing.assert_array_equal(kt.indices.asnumpy(), kj.indices.asnumpy())
    w = np.random.RandomState(5).randn(7, 2).astype(np.float32)
    _close(tsp.elemwise_mul(t, tmx.nd.array(w, ctx=CPU)),
           jsp.elemwise_mul(j, jmx.nd.array(w)))


def test_compress_rowsparse_matches_jax():
    g = np.zeros((5, 3), np.float32)
    g[1] = 1.5
    g[4] = -2.0
    t = tsp.compress_rowsparse(tmx.nd.array(g, ctx=CPU))
    j = jsp.compress_rowsparse(jmx.nd.array(g))
    np.testing.assert_array_equal(t.indices.asnumpy(), j.indices.asnumpy())
    np.testing.assert_array_equal(t.asnumpy(), g)


def test_zeros_of_each_stype():
    for stype in ("row_sparse", "csr", "default"):
        z = tsp.zeros(stype, (4, 3), ctx=CPU)
        assert z.stype == stype
        np.testing.assert_array_equal(z.asnumpy(), np.zeros((4, 3)))


# -- lazy row updates ---------------------------------------------------------

LAZY = {
    "sgd": ("sgd", {"learning_rate": 0.1, "wd": 0.01}),
    "sgd-momentum": ("sgd", {"learning_rate": 0.1, "momentum": 0.9,
                             "wd": 0.01, "clip_gradient": 0.5}),
    "adagrad": ("adagrad", {"learning_rate": 0.1, "wd": 0.01,
                            "rescale_grad": 0.5}),
}


@pytest.mark.parametrize("case", sorted(LAZY))
def test_lazy_row_update_matches_jax_and_dense(case):
    """Two row-sparse updates through the Updater: as the JAX package's;
    touched rows as a dense update's; untouched rows bit-unchanged."""
    opt, params = LAZY[case]
    rs = np.random.RandomState(2)
    w0 = rs.randn(6, 4).astype(np.float32)
    gs = []
    for rows in ([1, 3], [3, 4]):
        g = np.zeros((6, 4), np.float32)
        g[rows] = rs.randn(len(rows), 4)
        gs.append(g)
    out = {}
    for key, mx, sp, kw in (("port", tmx, tsp, {"ctx": CPU}),
                            ("jax", jmx, jsp, {})):
        upd = mx.optimizer.get_updater(mx.optimizer.create(opt, **params))
        w = mx.nd.array(w0.copy(), **kw)
        for g in gs:
            upd(0, sp.compress_rowsparse(mx.nd.array(g, **kw)), w)
        out[key] = w.asnumpy()
    _close(out["port"], out["jax"])
    np.testing.assert_array_equal(out["port"][[0, 2, 5]], w0[[0, 2, 5]])
    upd = tmx.optimizer.get_updater(tmx.optimizer.create(opt, **params))
    w = tmx.nd.array(w0.copy(), ctx=CPU)
    upd(0, tmx.nd.array(gs[0], ctx=CPU), w)
    w1 = tmx.nd.array(w0.copy(), ctx=CPU)
    upd1 = tmx.optimizer.get_updater(tmx.optimizer.create(opt, **params))
    upd1(0, tsp.compress_rowsparse(tmx.nd.array(gs[0], ctx=CPU)), w1)
    _close(w1.asnumpy()[[1, 3]], w.asnumpy()[[1, 3]])


def test_row_updates_drop_padding_ids():
    """A pair's ids equal to the row count (the executor's padding) write
    nothing, with repeated ids before it or none."""
    w0 = np.random.RandomState(6).randn(5, 2).astype(np.float32)
    for ids in ([1, 3, 5, 5], [0, 1, 2, 3]):
        vals = np.ones((4, 2), np.float32)
        vals[np.asarray(ids) == 5] = 0
        w = tmx.nd.array(w0.copy(), ctx=CPU)
        m = tmx.nd.zeros((5, 2), ctx=CPU)
        g = tsp.row_sparse_array((vals, ids), shape=(5, 2), ctx=CPU)
        tsp.sgd_mom_row_update(w, g, m, lr=0.1, momentum=0.9, wd=0.1)
        touched = [i for i in ids if i < 5]
        keep = [i for i in range(5) if i not in touched]
        np.testing.assert_array_equal(w.asnumpy()[keep], w0[keep])
        want = w0[touched] - 0.1 * (1.0 + 0.1 * w0[touched])
        _close(w.asnumpy()[touched], want)


@pytest.mark.parametrize("ids", [[[3, 1, 3], [7, 1, 1]],
                                 [[2, 5, 0], [9, 4, 6]]],
                         ids=["repeats", "unique"])
def test_dedup_rsp_pairs_matches_jax(ids):
    """Sorted unique ids, summed values, the tail slots padded with the
    row count and zeros: as the JAX package's, with repeats and with
    every slot unique."""
    import jax.numpy as jnp
    from mxnet_tpu.ops.sparse_graph import dedup_rsp_pairs as jdedup
    from mxnet_tpu_torch.ops.sparse_graph import dedup_rsp_pairs, \
        densify_pair
    ids = np.asarray(ids, np.float32)
    vals = np.random.RandomState(7).randn(2, 3, 4).astype(np.float32)
    ti, tv = dedup_rsp_pairs(torch.from_numpy(ids), torch.from_numpy(vals),
                             10)
    ji, jv = jdedup(jnp.asarray(ids), jnp.asarray(vals), 10)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(tv.numpy(), np.asarray(jv))
    dense = np.zeros((10, 4), np.float32)
    np.add.at(dense, ids.astype(int).reshape(-1), vals.reshape(-1, 4))
    _close(densify_pair((ti, tv), (10, 4)).numpy(), dense)


# -- gluon: Embedding(sparse_grad=True) ---------------------------------------

def _emb_train(mx, kw, sparse_grad, opt, params, steps=3, vocab=20, dim=4):
    w0 = np.random.RandomState(3).randn(vocab, dim).astype(np.float32)
    emb = mx.gluon.nn.Embedding(vocab, dim, sparse_grad=sparse_grad)
    emb.initialize(**kw)
    emb.weight.set_data(mx.nd.array(w0, **kw))
    trainer = mx.gluon.Trainer(emb.collect_params(), opt, dict(params))
    idx = mx.nd.array(np.array([1, 3, 3, 7], np.float32), **kw)
    target = mx.nd.array(np.ones((4, dim), np.float32), **kw)
    for _ in range(steps):
        with mx.autograd.record():
            loss = mx.nd.sum(mx.nd.square(emb(idx) - target))
        loss.backward()
        trainer.step(4)
    return emb, w0


def test_embedding_sparse_grad_trains_and_matches_jax():
    params = {"learning_rate": 0.5}
    t, w0 = _emb_train(tmx, {"ctx": CPU}, True, "sgd", params)
    j, _ = _emb_train(jmx, {}, True, "sgd", params)
    assert t.weight._grad_stype == "row_sparse"
    w = t.weight.data().asnumpy()
    _close(w, j.weight.data().asnumpy())
    untouched = [i for i in range(20) if i not in (1, 3, 7)]
    np.testing.assert_array_equal(w[untouched], w0[untouched])
    assert not np.allclose(w[[1, 3, 7]], w0[[1, 3, 7]])


def test_embedding_sparse_grad_with_dense_only_optimizer():
    t, w0 = _emb_train(tmx, {"ctx": CPU}, True, "adam",
                       {"learning_rate": 0.1}, steps=2)
    assert not np.allclose(t.weight.data().asnumpy()[[1, 3, 7]],
                           w0[[1, 3, 7]])


def test_sparse_embedding_matches_dense_embedding():
    params = {"learning_rate": 0.3}
    a, _ = _emb_train(tmx, {"ctx": CPU}, False, "sgd", params, steps=4)
    b, _ = _emb_train(tmx, {"ctx": CPU}, True, "sgd", params, steps=4)
    _close(b.weight.data().asnumpy(), a.weight.data().asnumpy())


def test_contrib_sparse_embedding_trains():
    emb = tmx.gluon.contrib.nn.SparseEmbedding(12, 3)
    emb.initialize(ctx=CPU)
    w0 = emb.weight.data().asnumpy().copy()
    trainer = tmx.gluon.Trainer(emb.collect_params(), "adagrad",
                                {"learning_rate": 0.5})
    x = tmx.nd.array(np.array([0, 4, 7], np.float32), ctx=CPU)
    for _ in range(2):
        with tmx.autograd.record():
            loss = tmx.nd.sum(tmx.nd.square(emb(x)))
        loss.backward()
        trainer.step(3)
    w1 = emb.weight.data().asnumpy()
    untouched = [i for i in range(12) if i not in (0, 4, 7)]
    np.testing.assert_array_equal(w1[untouched], w0[untouched])
    assert not np.allclose(w1[[0, 4, 7]], w0[[0, 4, 7]])


# -- the executor's sparse paths -----------------------------------------------

def test_graph_csr_dot_and_cast_storage_match_jax():
    rs = np.random.RandomState(0)
    dense = rs.randn(6, 8).astype(np.float32)
    dense[dense < 0.5] = 0
    W = rs.randn(8, 4).astype(np.float32)
    rhs = rs.randn(6, 3).astype(np.float32)
    res = {}
    for key, mx, sp, ctx in (("port", tmx, tsp, CPU),
                             ("jax", jmx, jsp, jmx.cpu())):
        csr = sp.csr_matrix(dense, shape=(6, 8), ctx=ctx)
        x = mx.sym.Variable("x", stype="csr")
        w = mx.sym.Variable("w")
        out = [mx.sym.dot(x, w).bind(ctx, {"x": csr, "w": mx.nd.array(
            W, ctx=ctx)}).forward()[0].asnumpy()]
        out.append(mx.sym.dot(x, mx.sym.Variable("w2"), transpose_a=True)
                   .bind(ctx, {"x": csr, "w2": mx.nd.array(rhs, ctx=ctx)})
                   .forward()[0].asnumpy())
        out.append(mx.sym.cast_storage(x, stype="default").bind(
            ctx, {"x": csr}).forward()[0].asnumpy())
        ex = mx.sym.dot(x, w).bind(
            ctx, {"x": csr, "w": mx.nd.array(W, ctx=ctx)},
            args_grad={"w": mx.nd.zeros((8, 4), ctx=ctx)}, grad_req="write")
        ex.forward(is_train=True)
        ex.backward(mx.nd.ones((6, 4), ctx=ctx))
        out.append(ex.grad_dict["w"].asnumpy())
        res[key] = out
    for g, w in zip(res["port"], res["jax"]):
        _close(g, w)


def test_embedding_sparse_grad_rsp_pair_matches_jax():
    """sparse_grad=True delivers deduplicated (ids, rows) pairs of the
    ids' static slot count, whose densification is the dense gradient,
    and the autograd record holds no (vocab, dim) tensor."""
    vocab, dim, B, T = 50, 4, 3, 5
    rs = np.random.RandomState(7)
    ids = rs.randint(0, vocab, (B, T)).astype(np.float32)
    ids[:, 0] = 3.0
    W = rs.randn(vocab, dim).astype(np.float32)
    grads = {}
    for key, mx, ctx in (("port", tmx, CPU), ("jax", jmx, jmx.cpu())):
        for sparse in (True, False):
            emb = mx.sym.Embedding(mx.sym.Variable("ids"),
                                   mx.sym.Variable("w"), input_dim=vocab,
                                   output_dim=dim, sparse_grad=sparse)
            ex = mx.sym.sum(emb * emb).bind(
                ctx, {"ids": mx.nd.array(ids, ctx=ctx),
                      "w": mx.nd.array(W, ctx=ctx)},
                args_grad={"w": mx.nd.zeros((vocab, dim), ctx=ctx)},
                grad_req={"w": "write", "ids": "null"})
            ex.forward(is_train=True)
            ex.backward()
            grads[key, sparse] = ex.grad_dict["w"]
    g = grads["port", True]
    assert isinstance(g, tsp.RowSparseNDArray)
    assert g.data.shape == (B * T, dim)
    np.testing.assert_array_equal(g.indices.asnumpy(),
                                  grads["jax", True].indices.asnumpy())
    _close(g.data.asnumpy(), grads["jax", True].data.asnumpy())
    _close(g.todense().asnumpy(), grads["port", False].asnumpy())


def test_sparse_grad_backward_holds_no_dense_table_gradient():
    """The differentiable leaf of a sparse_grad weight is the (ids, dim)
    per-occurrence tensor; the table itself takes no gradient, so the
    backward makes no (vocab, dim) tensor (the dense path's leaf is the
    table)."""
    from mxnet_tpu_torch.executor import Executor
    vocab, dim = 64, 8
    leaves = {}
    for sparse in (True, False):
        emb = tmx.sym.Embedding(tmx.sym.var("ids"), tmx.sym.var("w"),
                                input_dim=vocab, output_dim=dim,
                                sparse_grad=sparse)
        ex = Executor._simple_bind(tmx.sym.sum(tmx.sym.square(emb)), CPU,
                                   {"w": "write"}, None, {"ids": (2, 3)})
        ex.arg_dict["ids"]._data = torch.tensor([[1., 2., 1.],
                                                 [5., 5., 9.]])
        made = []
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: made.append(tuple(t.shape)) or t, lambda t: t):
            ex.forward(is_train=True)
        leaves[sparse] = tuple(ex._pending[0]["w"].shape)
        assert ex.arg_dict["w"]._data.grad is None
        ex.backward()
        if sparse:
            assert (vocab, dim) not in made
            assert isinstance(ex.grad_dict["w"], tsp.RowSparseNDArray)
    assert leaves == {True: (2, 3, dim), False: (vocab, dim)}


@pytest.mark.parametrize("bad", ["add", "tied", "computed"])
def test_sparse_grad_checks_match_jax(bad):
    for mx, ctx in ((tmx, CPU), (jmx, jmx.cpu())):
        ids, w = mx.sym.var("ids"), mx.sym.var("w")
        src = ids + 0 if bad == "computed" else ids
        e = mx.sym.Embedding(src, w, input_dim=6, output_dim=2,
                             sparse_grad=True)
        out = e + mx.sym.FullyConnected(e, w, num_hidden=6, no_bias=True) \
            .sum() if bad == "tied" else e
        with pytest.raises(mx.MXNetError):
            mx.sym.sum(out).simple_bind(
                ctx, grad_req={"w": "add" if bad == "add" else "write"},
                ids=(2, 3))


def test_module_sparse_grad_embedding_trains_fused():
    """Module + Embedding(sparse_grad=True) with adagrad: the fused step
    runs (one program), the gradient container is row-sparse, and the
    model learns."""
    vocab, dim = 100, 8
    rs = np.random.RandomState(0)
    X = rs.randint(0, vocab, (200, 6)).astype(np.float32)
    Y = (X.sum(1) % 3).astype(np.float32)
    mx = tmx
    emb = mx.sym.Embedding(mx.sym.Variable("data"), input_dim=vocab,
                           output_dim=dim, sparse_grad=True, name="emb")
    out = mx.sym.SoftmaxOutput(
        mx.sym.FullyConnected(mx.sym.mean(emb, axis=1), num_hidden=3,
                              name="fc"),
        mx.sym.Variable("softmax_label"), name="softmax")
    mod = mx.mod.Module(out, context=CPU)
    mx.random.seed(0)
    mod.fit(mx.io.NDArrayIter(X, Y, batch_size=20, shuffle=True),
            num_epoch=6, optimizer="adagrad",
            optimizer_params={"learning_rate": 0.5})
    assert mod.fused_step is not None
    g = mod._exec_group.execs[0].grad_dict["emb_weight"]
    assert isinstance(g, tsp.RowSparseNDArray)
    score = dict(mod.score(mx.io.NDArrayIter(X, Y, batch_size=20), "acc"))
    assert score["accuracy"] > 0.6, score


def test_module_fused_and_legacy_sparse_steps_agree():
    """One fused step and one legacy step from the same weights: equal
    within the output tolerance, and the rows no id touched unchanged."""
    vocab, dim = 30, 4
    rs = np.random.RandomState(1)
    X = rs.randint(0, vocab // 2, (8, 5)).astype(np.float32)
    Y = rs.randint(0, 3, 8).astype(np.float32)
    mx = tmx
    emb = mx.sym.Embedding(mx.sym.Variable("data"), input_dim=vocab,
                           output_dim=dim, sparse_grad=True, name="emb")
    out = mx.sym.SoftmaxOutput(
        mx.sym.FullyConnected(mx.sym.mean(emb, axis=1), num_hidden=3,
                              name="fc"),
        mx.sym.Variable("softmax_label"), name="softmax")
    it = mx.io.NDArrayIter(X, Y, batch_size=8)
    batch = next(iter(it))
    res = []
    for fused in ("1", "0"):
        os.environ["MXNET_MODULE_FUSED_STEP"] = fused
        try:
            mod = mx.mod.Module(out, context=CPU)
            mod.bind(it.provide_data, it.provide_label)
            mx.random.seed(3)
            mod.init_params(mx.init.Xavier())
            mod.init_optimizer(optimizer="sgd", optimizer_params={
                "learning_rate": 0.5, "momentum": 0.9, "wd": 0.01})
            w0 = mod.get_params()[0]["emb_weight"].asnumpy()
            mod.forward_backward_update(batch)
            mod.forward_backward_update(batch)
            res.append(mod.get_params()[0]["emb_weight"].asnumpy())
        finally:
            os.environ.pop("MXNET_MODULE_FUSED_STEP", None)
    _close(res[0], res[1])
    untouched = sorted(set(range(vocab)) - set(X.astype(int).ravel()))
    np.testing.assert_array_equal(res[0][untouched], w0[untouched])
    np.testing.assert_array_equal(res[1][untouched], w0[untouched])


# -- io and files ---------------------------------------------------------------

def _libsvm(path, n, features, seed=7):
    sys.path.insert(0, os.path.join(REPO, "examples"))
    from train_sparse_linear import make_synthetic_libsvm
    make_synthetic_libsvm(path, n, features, seed=seed)


def test_libsvm_iter_matches_jax(tmp_path):
    path = str(tmp_path / "d.libsvm")
    _libsvm(path, 100, 50)
    for round_batch in (True, False):
        kw = dict(data_libsvm=path, data_shape=(50,), batch_size=32,
                  round_batch=round_batch)
        a, b = list(tmx.io.LibSVMIter(**kw)), list(jmx.io.LibSVMIter(**kw))
        assert len(a) == len(b) == (4 if round_batch else 3)
        for x, y in zip(a, b):
            assert x.pad == y.pad
            assert x.data[0].stype == "csr" and x.data[0].shape == (32, 50)
            for part in ("data", "indices", "indptr"):
                np.testing.assert_array_equal(
                    getattr(x.data[0], part).asnumpy(),
                    getattr(y.data[0], part).asnumpy())
            np.testing.assert_array_equal(x.label[0].asnumpy(),
                                          y.label[0].asnumpy())


def test_sparse_params_files_cross_both_ways(tmp_path):
    rs = np.random.RandomState(8)
    dense = _rand_dense(rs, 6, 5, 0.4)
    rows = rs.randn(2, 5).astype(np.float32)
    made = {
        "port": {"c": tsp.csr_matrix(dense, ctx=CPU),
                 "r": tsp.row_sparse_array((rows, [1, 4]), shape=(6, 5),
                                           ctx=CPU),
                 "d": tmx.nd.array(dense, ctx=CPU)},
        "jax": {"c": jsp.csr_matrix(dense),
                "r": jsp.row_sparse_array((rows, [1, 4]), shape=(6, 5)),
                "d": jmx.nd.array(dense)}}
    files = {}
    for key, mx in (("port", tmx), ("jax", jmx)):
        files[key] = str(tmp_path / (key + ".params"))
        mx.nd.save(files[key], made[key])
    with np.load(files["port"]) as zp, np.load(files["jax"]) as zj:
        assert sorted(zp.files) == sorted(zj.files)
        for k in zp.files:
            assert zp[k].dtype == zj[k].dtype, k
            np.testing.assert_array_equal(zp[k], zj[k])
    for src in ("port", "jax"):
        t = tmx.nd.load(files[src], ctx=CPU)
        j = jmx.nd.load(files[src])
        for k in ("c", "r", "d"):
            assert t[k].stype == j[k].stype == made["port"][k].stype
            np.testing.assert_array_equal(t[k].asnumpy(), j[k].asnumpy())
        assert t["r"].shape == (6, 5)
        np.testing.assert_array_equal(t["c"].indptr.asnumpy(),
                                      j["c"].indptr.asnumpy())


def test_sparse_linear_flow_converges(tmp_path):
    """The local loop of examples/train_sparse_linear.py on the port (the
    example imports the JAX package): LibSVMIter -> sparse.dot ->
    compress_rowsparse -> AdaGrad's lazy row update, 5 epochs, to the
    example's 0.9 train accuracy bar (1,200 examples)."""
    path = str(tmp_path / "d.libsvm")
    _libsvm(path, 1200, 1000)
    mx = tmx
    it = mx.io.LibSVMIter(data_libsvm=path, data_shape=(1000,),
                          batch_size=64)
    weight = mx.nd.zeros((1000, 1), ctx=CPU)
    bias = mx.nd.zeros((1,), ctx=CPU)
    upd = mx.optimizer.get_updater(mx.optimizer.create(
        "adagrad", learning_rate=0.5))
    for _ in range(5):
        it.reset()
        for batch in it:
            csr = batch.data[0]
            y = batch.label[0].asnumpy().reshape(-1, 1)
            z = (tsp.dot(csr, weight) + bias).asnumpy()
            p = 1.0 / (1.0 + np.exp(-z))
            dlogits = mx.nd.array(((p - y) / y.shape[0]).astype(np.float32),
                                  ctx=CPU)
            dw = tsp.compress_rowsparse(tsp.dot(csr, dlogits,
                                                transpose_a=True))
            upd(0, dw, weight)
            upd(1, mx.nd.array(dlogits.asnumpy().sum(0), ctx=CPU), bias)
    it.reset()
    right = total = 0
    for batch in it:
        z = (tsp.dot(batch.data[0], weight) + bias).asnumpy()
        y = batch.label[0].asnumpy().reshape(-1, 1)
        right += int(((z > 0) == (y > 0.5)).sum())
        total += y.shape[0]
    assert right / total >= 0.9, right / total


def test_module_over_csr_batches_takes_the_legacy_step(tmp_path):
    """dot(var('data', stype='csr'), weight) + bias ->
    LogisticRegressionOutput through Module.fit on LibSVMIter batches
    (the JAX package's Module feeds a CSR batch as its values and cannot
    run this graph: ROADMAP "Caveats").  One step equals the eager CSR
    step's gradient update; the loss falls."""
    path = str(tmp_path / "d.libsvm")
    _libsvm(path, 512, 200)
    mx = tmx
    x = mx.sym.var("data", stype="csr")
    w = mx.sym.var("weight", shape=(200, 1))
    b = mx.sym.var("bias", shape=(1,))
    net = mx.sym.LogisticRegressionOutput(
        mx.sym.broadcast_add(mx.sym.dot(x, w), b),
        mx.sym.var("softmax_label"), name="lro")
    it = mx.io.LibSVMIter(data_libsvm=path, data_shape=(200,),
                          batch_size=64)
    mod = mx.mod.Module(net, data_names=["data"],
                        label_names=["softmax_label"], context=CPU)
    mod.bind(it.provide_data, [("softmax_label", (64, 1))])
    mod.init_params(mx.init.Zero())
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.5})
    batch = next(iter(it))
    batch.label = [batch.label[0].reshape((64, 1))]
    mod.forward_backward_update(batch)
    assert mod._needs_legacy_step() and mod.fused_step is None
    csr = batch.data[0]
    y = batch.label[0].asnumpy()
    p = np.full((64, 1), 0.5, np.float32)         # zero weights
    dw = tsp.dot(csr, mx.nd.array((p - y) / 64, ctx=CPU),
                 transpose_a=True).asnumpy()
    _close(mod.get_params()[0]["weight"].asnumpy(), -0.5 * dw)
    losses = []

    def record(param):
        pr = mod.get_outputs()[0].asnumpy()
        lab = param.locals["data_batch"].label[0].asnumpy().reshape(-1, 1)
        losses.append(float(-(lab * np.log(pr + 1e-12) + (1 - lab) *
                              np.log(1 - pr + 1e-12)).mean()))

    label_it = _Reshaped(it)
    mod.fit(label_it, num_epoch=2, batch_end_callback=record,
            optimizer="sgd", optimizer_params={"learning_rate": 0.5},
            force_init=False)
    assert np.mean(losses[-4:]) < np.mean(losses[:4])


class _Reshaped(tmx.io.DataIter):
    """LibSVMIter batches with (batch, 1) labels."""

    def __init__(self, it):
        super().__init__(it.batch_size)
        self.it = it
        self.provide_data = it.provide_data
        self.provide_label = [("softmax_label", (it.batch_size, 1))]

    def reset(self):
        self.it.reset()

    def next(self):
        b = self.it.next()
        b.label = [b.label[0].reshape((-1, 1))]
        return b
