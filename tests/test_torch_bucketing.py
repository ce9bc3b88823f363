"""The port's ``mx.rnn`` (symbolic cells, ``BucketSentenceIter``),
``BucketingModule``, ``SequentialModule`` and ``PythonModule`` /
``PythonLossModule`` against the JAX package's, on the CPU
(tests/test_bucketing.py and tests/test_contrib.py's cases mirrored), and
the loop of ``examples/train_lm.py`` on the port in-process.

Tolerances: unrolled cells' outputs and gradients at float32 rtol 1e-5 /
atol 1e-5; BucketingModule losses over alternating buckets within 1e-5 x
max(1, |loss|) (the same arithmetic in both packages, whose summation
orders differ).
"""

import os
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples"))
from train_lm import synthetic_corpus  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cpu(mx, x):
    return mx.nd.array(x, ctx=mx.cpu())


# -- symbolic cells -----------------------------------------------------------

def _cell(mx, kind):
    r = mx.rnn
    if kind == "rnn":
        return r.RNNCell(num_hidden=4, activation="tanh", prefix="r_")
    if kind == "lstm":
        return r.LSTMCell(num_hidden=5, prefix="l_")
    if kind == "gru":
        return r.GRUCell(num_hidden=5, prefix="g_")
    if kind == "fused_lstm":
        return r.FusedRNNCell(num_hidden=5, num_layers=2, mode="lstm",
                              prefix="f_")
    if kind == "fused_gru":
        return r.FusedRNNCell(num_hidden=4, num_layers=1, mode="gru",
                              bidirectional=True, prefix="fg_")
    if kind == "stack":
        stack = r.SequentialRNNCell()
        stack.add(r.LSTMCell(num_hidden=4, prefix="s0_"))
        stack.add(r.ResidualCell(r.LSTMCell(num_hidden=4, prefix="s1_")))
        stack.add(r.DropoutCell(r.GRUCell(num_hidden=4, prefix="s2_"),
                                dropout=0.0))
        return stack
    return r.BidirectionalCell(r.RNNCell(num_hidden=3, prefix="fw_"),
                               r.GRUCell(num_hidden=3, prefix="bw_"))


def _unrolled(mx, kind, layout, length):
    outputs, states = _cell(mx, kind).unroll(
        length, inputs=mx.sym.var("x"), layout=layout, merge_outputs=True)
    return mx.sym.Group([outputs] + list(states))


@pytest.mark.parametrize("kind", ["rnn", "lstm", "gru", "fused_lstm",
                                  "fused_gru", "stack", "bidirectional"])
@pytest.mark.parametrize("layout", ["NTC", "TNC"])
def test_symbolic_cells_unroll_match_jax(kind, layout):
    """Outputs, final states and every argument's gradient of the
    unrolled graph, from the same argument values."""
    T, B, C = 4, 2, 3
    xshape = (B, T, C) if layout == "NTC" else (T, B, C)
    jsym = _unrolled(jmx, kind, layout, T)
    tsym = _unrolled(tmx, kind, layout, T)
    assert tsym.list_arguments() == jsym.list_arguments()
    shapes, out_shapes, _ = jsym.infer_shape(x=xshape)
    assert tsym.infer_shape(x=xshape)[1] == out_shapes
    rs = np.random.RandomState(0)
    args = {n: (rs.randn(*s) * 0.5).astype(np.float32)
            for n, s in zip(jsym.list_arguments(), shapes)}
    cots = [rs.randn(*s).astype(np.float32) for s in out_shapes]
    res = []
    for mx, symbol in ((jmx, jsym), (tmx, tsym)):
        exe = symbol.bind(
            ctx=mx.cpu(), args={k: _cpu(mx, v) for k, v in args.items()},
            args_grad={k: mx.nd.zeros(v.shape, ctx=mx.cpu())
                       for k, v in args.items()})
        outs = [o.asnumpy() for o in exe.forward(is_train=True)]
        exe.backward([_cpu(mx, c) for c in cots])
        res.append((outs, {k: g.asnumpy() for k, g in
                           exe.grad_dict.items()}))
    (jo, jg), (to, tg) = res
    for a, b in zip(to, jo):
        np.testing.assert_allclose(a, b, **TOL)
    for k in args:
        np.testing.assert_allclose(tg[k], jg[k], **TOL)


def test_bucket_sentence_iter_yields_the_jax_batches():
    """Same buckets, keys, batches and order as the JAX iterator for one
    seed, shuffled, over two epochs; labels are the inputs shifted by one
    and padded with invalid_label."""
    sentences = synthetic_corpus(vocab=30, num_sentences=300, seed=5)
    its = [mx.rnn.BucketSentenceIter(sentences, 8, buckets=[8, 12, 16, 20],
                                     invalid_label=0, seed=3)
           for mx in (jmx, tmx)]
    assert its[1].default_bucket_key == its[0].default_bucket_key == 20
    assert its[1].provide_data == its[0].provide_data
    for _epoch in range(2):
        jb, tb = list(its[0]), list(its[1])
        assert len(tb) == len(jb) > 4
        for a, b in zip(tb, jb):
            assert a.bucket_key == b.bucket_key
            assert a.provide_data == b.provide_data
            np.testing.assert_array_equal(a.data[0].asnumpy(),
                                          b.data[0].asnumpy())
            np.testing.assert_array_equal(a.label[0].asnumpy(),
                                          b.label[0].asnumpy())
            d, lab = a.data[0].asnumpy(), a.label[0].asnumpy()
            np.testing.assert_array_equal(lab[:, :-1], d[:, 1:])
            assert (lab[:, -1] == 0).all()
            assert a.data[0].context == tmx.cpu()
        assert {b.bucket_key for b in tb} == {8, 12, 16, 20}
        for it in its:
            it.reset()


# -- BucketingModule ----------------------------------------------------------

VOCAB, HIDDEN = 20, 16


def _lm_module(mx, ctx=None):
    stack = mx.rnn.SequentialRNNCell()
    stack.add(mx.rnn.LSTMCell(num_hidden=HIDDEN, prefix="lstm_"))

    def sym_gen(seq_len):
        embed = mx.sym.Embedding(data=mx.sym.var("data"), input_dim=VOCAB,
                                 output_dim=8, name="embed")
        outputs, _ = stack.unroll(seq_len, inputs=embed,
                                  merge_outputs=True)
        pred = mx.sym.reshape(outputs, shape=(-1, HIDDEN))
        pred = mx.sym.FullyConnected(data=pred, num_hidden=VOCAB,
                                     name="pred")
        label = mx.sym.reshape(mx.sym.var("softmax_label"), shape=(-1,))
        return mx.sym.SoftmaxOutput(data=pred, label=label,
                                    name="softmax"), ("data",), \
            ("softmax_label",)

    kw = {"context": ctx} if ctx is not None else {}
    return mx.mod.BucketingModule(sym_gen=sym_gen, default_bucket_key=8,
                                  **kw)


def _batch(mx, seq_len, seed=None):
    rs = np.random.RandomState(seq_len if seed is None else seed)
    d = rs.randint(0, VOCAB, (2, seq_len)).astype(np.float32)
    return mx.io.DataBatch(
        data=[_cpu(mx, d)], label=[_cpu(mx, d)], bucket_key=seq_len,
        provide_data=[mx.io.DataDesc("data", (2, seq_len))],
        provide_label=[mx.io.DataDesc("softmax_label", (2, seq_len))])


def _bound(mx, weights=None, optimizer="sgd"):
    mod = _lm_module(mx, ctx=mx.cpu())
    mod.bind(data_shapes=[("data", (2, 8))],
             label_shapes=[("softmax_label", (2, 8))])
    if weights is None:
        mod.init_params(mx.init.Xavier())
    else:
        mod.init_params(arg_params={k: _cpu(mx, v)
                                    for k, v in weights.items()})
    mod.init_optimizer(optimizer=optimizer,
                       optimizer_params={"learning_rate": 0.1})
    return mod


def _arg(mod, key, name):
    return mod._buckets[key]._exec_group.execs[0].arg_dict[name]


def test_bucketing_module_shares_params_and_one_updater():
    """tests/test_bucketing.py:140 on the port: every bucket's arrays are
    the default bucket's (the same NDArray, the same storage) through
    updates and set_params; one Updater serves every bucket; a bucket
    seen before is not bound again."""
    mod = _bound(tmx)
    mod.forward_backward(_batch(tmx, 4))
    mod.update()
    m4, m8 = mod._buckets[4], mod._buckets[8]
    names = m4._exec_group.param_names
    assert names == m8._exec_group.param_names

    def shared():
        for n in names:
            a, b = _arg(mod, 4, n), _arg(mod, 8, n)
            assert a is b and a._data.data_ptr() == b._data.data_ptr()
    shared()
    assert m4._updater is m8._updater and m4._optimizer is m8._optimizer
    w0 = _arg(mod, 8, "pred_weight").asnumpy().copy()
    mod.forward_backward(_batch(tmx, 8))
    mod.update()
    assert not np.allclose(w0, _arg(mod, 8, "pred_weight").asnumpy())
    before = dict(mod._buckets)
    mod.forward_backward(_batch(tmx, 4))
    mod.update()
    assert mod._buckets[4] is before[4]
    shared()
    mod.set_params(*mod.get_params())
    shared()
    mod.forward_backward(_batch(tmx, 12))
    assert set(mod._buckets) == {4, 8, 12}
    assert mod._buckets[12]._updater is m8._updater
    shared()


def _nll(mx, mod, batch):
    probs = mod.get_outputs()[0].asnumpy()
    lab = batch.label[0].asnumpy().reshape(-1).astype(int)
    return float(-np.log(probs[np.arange(len(lab)), lab]).mean())


@pytest.mark.parametrize("optimizer", ["adam"])
def test_bucketing_module_steps_match_jax(optimizer):
    """Steps through alternating buckets in both packages from the same
    weights: the losses and the final weights agree."""
    jmod = _bound(jmx, optimizer=optimizer)
    weights = {k: v.asnumpy() for k, v in jmod.get_params()[0].items()}
    tmod = _bound(tmx, weights, optimizer=optimizer)
    losses = {"jax": [], "port": []}
    for key in (8, 4, 12, 4, 8, 12):
        for name, mx, mod in (("jax", jmx, jmod), ("port", tmx, tmod)):
            b = _batch(mx, key)
            mod.forward_backward(b)
            losses[name].append(_nll(mx, mod, b))
            mod.update()
    for a, b in zip(losses["port"], losses["jax"]):
        assert abs(a - b) <= 1e-5 * max(1.0, abs(b)), losses
    jp, tp = jmod.get_params()[0], tmod.get_params()[0]
    for k in jp:
        want = jp[k].asnumpy()
        err = np.abs(tp[k].asnumpy() - want).max()
        assert err <= 1e-4 * max(1.0, np.abs(want).max()), (k, err)


def test_bucketing_module_checkpoint_steps_bit_equal(tmp_path):
    """save_checkpoint with optimizer states, loaded into a fresh
    BucketingModule: its next step equals the original's bit for bit."""
    mod = _bound(tmx, optimizer="adam")
    for key in (8, 12, 4):
        mod.forward_backward(_batch(tmx, key))
        mod.update()
    prefix = str(tmp_path / "lm")
    mod.save_checkpoint(prefix, 3, save_optimizer_states=True)
    _, args, auxs = tmx.model.load_checkpoint(prefix, 3, ctx=tmx.cpu())
    fresh = _lm_module(tmx, ctx=tmx.cpu())
    fresh.bind(data_shapes=[("data", (2, 8))],
               label_shapes=[("softmax_label", (2, 8))])
    fresh.set_params(args, auxs)
    fresh.init_optimizer(optimizer="adam",
                         optimizer_params={"learning_rate": 0.1})
    fresh._buckets[8].load_optimizer_states(prefix + "-0003.states")
    # the states blob holds no update counts (the reference's format), and
    # adam's step depends on them: take the original's, as a resume would
    for attr in ("_index_update_count", "num_update"):
        setattr(fresh._buckets[8]._optimizer, attr, type(getattr(
            mod._buckets[8]._optimizer, attr))(getattr(
                mod._buckets[8]._optimizer, attr)))
    for m in (mod, fresh):
        m.forward_backward(_batch(tmx, 12, seed=9))
        m.update()
    a, b = mod.get_params()[0], fresh.get_params()[0]
    for k in a:
        assert torch.equal(a[k]._data, b[k]._data), k


def test_example_train_lm_loop_on_the_port():
    """The loop of examples/train_lm.py (tests/test_bucketing.py:178's
    run: 4 epochs of 400 sentences) through the port: the final training
    perplexity is under the example's bound of 12, and it fell."""
    mx = tmx
    sentences = synthetic_corpus(50, 400)
    train = mx.rnn.BucketSentenceIter(sentences, 32, buckets=[8, 12, 16, 20],
                                      invalid_label=0)
    stack = mx.rnn.SequentialRNNCell()
    stack.add(mx.rnn.LSTMCell(num_hidden=64, prefix="lstm_l0_"))

    def sym_gen(seq_len):
        embed = mx.sym.Embedding(data=mx.sym.var("data"), input_dim=50,
                                 output_dim=32, name="embed")
        outputs, _ = stack.unroll(seq_len, inputs=embed,
                                  merge_outputs=True)
        pred = mx.sym.reshape(outputs, shape=(-1, 64))
        pred = mx.sym.FullyConnected(data=pred, num_hidden=50, name="pred")
        label = mx.sym.reshape(mx.sym.var("softmax_label"), shape=(-1,))
        pred = mx.sym.SoftmaxOutput(data=pred, label=label, use_ignore=True,
                                    ignore_label=0, name="softmax")
        return pred, ("data",), ("softmax_label",)

    model = mx.mod.BucketingModule(sym_gen=sym_gen,
                                   default_bucket_key=train.default_bucket_key,
                                   context=mx.cpu())
    ppl = mx.metric.Perplexity(ignore_label=0)
    per_epoch = []

    def epoch_end(epoch, symbol, arg, aux):
        per_epoch.append(ppl.get()[1])
    model.fit(train, eval_metric=ppl, optimizer="adam",
              optimizer_params={"learning_rate": 0.02},
              initializer=mx.init.Xavier(), num_epoch=4,
              epoch_end_callback=epoch_end)
    train.reset()
    ppl.reset()
    for batch in train:
        model.forward(batch, is_train=False)
        model.update_metric(ppl, batch.label)
    final = ppl.get()[1]
    assert len(per_epoch) == 4 and per_epoch[-1] < per_epoch[0]
    assert final < 12.0, (per_epoch, final)
    assert set(model._buckets) == {8, 12, 16, 20}


# -- SequentialModule, PythonModule -------------------------------------------

def _seq_with_python_loss(mx, grad_func=None):
    net = mx.sym.FullyConnected(mx.sym.var("data"), num_hidden=4,
                                name="fc_seq")
    mod1 = mx.mod.Module(net, data_names=("data",), label_names=None,
                         context=[mx.cpu()])
    loss_mod = mx.mod.PythonLossModule(data_names=("fc_seq_output",),
                                       grad_func=grad_func)
    seq = mx.mod.SequentialModule()
    seq.add(mod1).add(loss_mod, take_labels=True, auto_wiring=True)
    return seq


def test_sequential_module_with_python_loss_matches_jax():
    """tests/test_contrib.py:241 in both packages from the same weights:
    the same losses epoch by epoch, and the chain learns."""
    rng = np.random.RandomState(0)
    X = rng.randn(40, 6).astype(np.float32)
    y = rng.randint(0, 4, 40).astype(np.float32)
    curves, weights = {}, None
    for name, mx in (("jax", jmx), ("port", tmx)):
        seq = _seq_with_python_loss(mx)
        it = mx.io.NDArrayIter({"data": X}, {"softmax_label": y},
                               batch_size=10)
        seq.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
        if weights is None:
            seq.init_params()
            weights = {k: v.asnumpy() for k, v in seq.get_params()[0].items()}
        else:
            seq.init_params(arg_params={k: _cpu(mx, v)
                                        for k, v in weights.items()})
        seq.init_optimizer(optimizer="sgd",
                           optimizer_params={"learning_rate": 0.1})
        curve = []
        for _epoch in range(6):
            it.reset()
            total, count = 0.0, 0
            for batch in it:
                seq.forward(batch, is_train=True)
                s = seq.get_outputs()[0].asnumpy()
                lab = batch.label[0].asnumpy().astype(int)
                p = np.exp(s - s.max(1, keepdims=True))
                p /= p.sum(1, keepdims=True)
                total += -np.log(p[np.arange(len(lab)), lab] + 1e-9).sum()
                count += len(lab)
                seq.backward()
                seq.update()
            curve.append(total / count)
        curves[name] = curve
    np.testing.assert_allclose(curves["port"], curves["jax"], rtol=1e-5)
    assert curves["port"][-1] < curves["port"][0]


def test_python_loss_grad_func_gets_device_arrays_and_binds_shapes():
    seen = []

    def grad_func(scores, labels):
        seen.append((scores.context, labels.context))
        return (scores * 0 + 1).asnumpy()
    seq = _seq_with_python_loss(tmx, grad_func)
    it = tmx.io.NDArrayIter({"data": np.ones((4, 6), np.float32)},
                            {"softmax_label": np.zeros(4, np.float32)},
                            batch_size=4)
    seq.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    seq.init_params()
    seq.init_optimizer()
    assert seq.output_shapes[0].shape == (4, 4)
    assert seq._modules[1].data_shapes[0].name == "fc_seq_output"
    batch = next(iter(it))
    seq.forward(batch, is_train=True)
    seq.backward()
    assert seen == [(tmx.cpu(), tmx.cpu())]
    g = seq._modules[0]._exec_group.execs[0].grad_dict["fc_seq_weight"]
    np.testing.assert_allclose(g.asnumpy(), np.full((4, 6), 4.0))


def test_python_module_mirrors_its_inputs():
    class Double(tmx.mod.PythonModule):
        def forward(self, data_batch, is_train=None):
            self._out = data_batch.data[0] * 2

        def get_outputs(self, merge_multi_context=True):
            return [self._out]

    m = Double(["data"], None, ["double_output"])
    m.bind([("data", (3, 2))])
    m.init_params()
    m.init_optimizer()
    assert m.binded and m.params_initialized and m.optimizer_initialized
    assert m.output_shapes == [tmx.io.DataDesc("double_output", (3, 2))]
    assert m.get_params() == ({}, {})
    m.forward(tmx.io.DataBatch([_cpu(tmx, np.ones((3, 2)))]))
    np.testing.assert_array_equal(m.get_outputs()[0].asnumpy(),
                                  np.full((3, 2), 2.0))
