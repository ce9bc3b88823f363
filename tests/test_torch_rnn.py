"""The port's recurrent networks against the JAX package's, on the CPU:
the fused ``RNN`` op (forward, and gradients against ``jax.vjp`` of the
JAX op), its packing, ``gluon.rnn`` layers and cells, ``get_lstm_lm``,
``ParallelTrainer`` over the LSTM LM, and ``gluon.contrib.rnn``.

Inputs come from seeded numpy generators; weights cross with
``gluon.load_jax_params``.  Tolerances: the op and the layers in float32
at rtol 1e-5 / atol 1e-5 (T <= 6 steps of float32 gate math whose
summation order differs); the LSTM LM trainer's losses over five SGD
steps within 1e-5 x max(1, |loss|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.gluon import rnn as jrnn
from mxnet_tpu.gluon.contrib import rnn as jcrnn
from mxnet_tpu.gluon.model_zoo.lm import get_lstm_lm as jax_lstm_lm
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu.ops.rnn import rnn_param_size as jax_param_size
from mxnet_tpu.parallel.data_parallel import ParallelTrainer as JTrainer
from mxnet_tpu.parallel.mesh import make_mesh as jmesh

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.gluon import rnn as trnn
from mxnet_tpu_torch.gluon.contrib import rnn as tcrnn
from mxnet_tpu_torch.gluon.model_zoo.lm import get_lstm_lm as port_lstm_lm
from mxnet_tpu_torch.ops import rnn as trnn_op
from mxnet_tpu_torch.ops import registry as treg
from mxnet_tpu_torch.parallel import ParallelTrainer, make_mesh

TOL = dict(rtol=1e-5, atol=1e-5)
T, B, I, H = 5, 3, 4, 6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: one intra-op thread, so that the parallel test run
    does not oversubscribe the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cpu(x):
    return tmx.nd.array(x, ctx=tmx.cpu())


# -- the op ------------------------------------------------------------------

OP_CASES = []
for _mode in ("rnn_relu", "rnn_tanh", "lstm", "gru"):
    for _layers, _bidir in ((1, False), (2, False), (2, True)):
        OP_CASES.append((_mode, _layers, _bidir, True, True, None))
    OP_CASES.append((_mode, 1, True, False, False, None))   # no states
OP_CASES += [("lstm", 2, False, True, True, (-0.1, 0.1, False)),
             ("lstm", 1, True, True, False, (-0.2, 0.15, True))]


def _op_inputs(mode, layers, bidir, seed=0):
    rs = np.random.RandomState(seed)
    dirs = 2 if bidir else 1
    n = jax_param_size(mode, I, H, layers, bidir)
    par = (rs.randn(n) * 0.4).astype(np.float32)
    x = rs.randn(T, B, I).astype(np.float32)
    h0 = rs.randn(layers * dirs, B, H).astype(np.float32)
    c0 = rs.randn(layers * dirs, B, H).astype(np.float32)
    return x, par, h0, c0


def _op_kwargs(mode, layers, bidir, state_outputs, clip):
    kw = dict(state_size=H, num_layers=layers, bidirectional=bidir,
              mode=mode, state_outputs=state_outputs, training=False)
    if clip is not None:
        kw.update(lstm_state_clip_min=clip[0], lstm_state_clip_max=clip[1],
                  lstm_state_clip_nan=clip[2])
    return kw


@pytest.mark.parametrize("mode,layers,bidir,state_outputs,states,clip",
                         OP_CASES, ids=str)
def test_rnn_op_forward_and_vjp_match_jax(mode, layers, bidir,
                                          state_outputs, states, clip):
    x, par, h0, c0 = _op_inputs(mode, layers, bidir)
    kw = _op_kwargs(mode, layers, bidir, state_outputs, clip)
    n_states = (2 if mode == "lstm" else 1) if states else 0
    ins = [x, par, h0, c0][:2 + n_states]
    jop = jreg.get_op("RNN")
    key = jax.random.PRNGKey(0)
    jouts, vjp = jax.vjp(
        lambda *a: jop.fn(key, *a, **kw), *[jnp.asarray(a) for a in ins])
    rs = np.random.RandomState(7)
    cots = [rs.randn(*o.shape).astype(np.float32) for o in jouts]
    jgrads = vjp(tuple(jnp.asarray(c) for c in cots))

    leaves = [torch.tensor(a, requires_grad=True) for a in ins]
    touts = trnn_op._rnn(None, *leaves, **kw)
    assert len(touts) == len(jouts)
    for got, want in zip(touts, jouts):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **TOL)
    torch.autograd.backward(list(touts), [torch.tensor(c) for c in cots])
    for leaf, want in zip(leaves, jgrads):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(want),
                                   **TOL)


def test_rnn_op_clip_nan_sanitizes_the_returned_cell():
    x, par, h0, c0 = _op_inputs("lstm", 1, False)
    c0[0, 1, 2] = np.nan
    kw = _op_kwargs("lstm", 1, False, True, (-0.3, 0.25, True))
    want = jreg.get_op("RNN").fn(jax.random.PRNGKey(0), *map(
        jnp.asarray, (x, par, h0, c0)), **kw)
    got = tmx.nd.RNN(*map(_cpu, (x, par, h0, c0)), **kw)
    assert np.isnan(np.asarray(want[0])).any()
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.asnumpy(), np.asarray(w), **TOL)
    assert float(got[2].asnumpy()[0, 1, 2]) == 0.25


@pytest.mark.parametrize("mode,layers,bidir", [
    ("lstm", 1, False), ("gru", 3, True), ("rnn_tanh", 2, True),
    ("rnn_relu", 1, True)])
def test_rnn_param_size_matches_jax(mode, layers, bidir):
    assert trnn_op.rnn_param_size(mode, 7, 5, layers, bidir) == \
        jax_param_size(mode, 7, 5, layers, bidir)


def test_op_contract_matches_jax():
    jop, top = jreg.get_op("RNN"), treg.get_op("RNN")
    assert top.input_names == jop.input_names
    assert set(top.param_names) == set(jop.param_names)
    for p in ({"mode": "lstm"}, {"mode": "gru", "state_outputs": True}):
        assert top.input_names_for(p) == jop.input_names_for(p)
        assert top.n_out(p) == jop.n_out(p)
        assert top.n_visible(p) == jop.n_visible(p)


def test_cell_weights_packed_into_the_fused_op():
    """An LSTMCell's weights packed into the op's layout give the cell's
    unroll (tests/test_rnn.py's packing check, on the port)."""
    cell = trnn.LSTMCell(H, input_size=I, prefix="pk_")
    cell.initialize(ctx=tmx.cpu())
    x = _cpu(np.random.RandomState(3).randn(T, B, I).astype(np.float32))
    outs, _ = cell.unroll(T, x, layout="TNC")
    par = np.concatenate([
        cell.i2h_weight.data().asnumpy().ravel(),
        cell.h2h_weight.data().asnumpy().ravel(),
        cell.i2h_bias.data().asnumpy(), cell.h2h_bias.data().asnumpy()])
    h0 = np.zeros((1, B, H), np.float32)
    fused, _, _ = tmx.nd.RNN(x, _cpu(par), _cpu(h0), _cpu(h0),
                             state_size=H, num_layers=1, mode="lstm",
                             state_outputs=True)
    np.testing.assert_allclose(outs.asnumpy(), fused.asnumpy(), **TOL)


def test_dropout_between_layers_only_and_by_moments(monkeypatch):
    """Dropout masks come between layers, never after the last one, only
    in training; a mask keeps 1 - p of its entries, scaled by 1 / (1 -
    p), within 4 standard errors."""
    calls = []
    real = trnn_op._dropout_mask

    def spy(rng, x, p):
        m = real(rng, x, p)
        calls.append(m)
        return m
    monkeypatch.setattr(trnn_op, "_dropout_mask", spy)
    x, par, h0, c0 = _op_inputs("lstm", 3, True)
    kw = _op_kwargs("lstm", 3, True, False, None)
    args = [torch.tensor(a) for a in (x, par, h0, c0)]
    gen = torch.Generator().manual_seed(0)
    trnn_op._rnn(gen, *args, **dict(kw, p=0.5, training=True))
    assert len(calls) == 2 and all(m.shape == (T, B, 2 * H) for m in calls)
    calls.clear()
    trnn_op._rnn(gen, *args, **dict(kw, p=0.5, training=False))
    assert not calls
    # one layer: nothing between layers, so training equals inference
    x1, par1, h01, c01 = _op_inputs("gru", 1, False)
    a1 = [torch.tensor(a) for a in (x1, par1, h01)]
    kw1 = _op_kwargs("gru", 1, False, True, None)
    tr = trnn_op._rnn(gen, *a1, **dict(kw1, p=0.7, training=True))
    ev = trnn_op._rnn(gen, *a1, **kw1)
    assert not calls
    for a, b in zip(tr, ev):
        assert torch.equal(a, b)
    p, n = 0.3, 200000
    m = real(gen, torch.zeros(n), p)
    kept = float((m > 0).float().mean())
    assert abs(kept - (1 - p)) <= 4 * np.sqrt(p * (1 - p) / n)
    assert torch.allclose(m[m > 0], torch.full((1,), 1 / (1 - p)))


# -- gluon layers ------------------------------------------------------------

def _cross(jnet, tnet, *xs):
    """Initialize both nets (the JAX one's shapes resolved by a forward),
    give the port the JAX package's weights."""
    jnet.initialize()
    jnet(*[jmx.nd.array(x) for x in xs])
    tnet.initialize(ctx=tmx.cpu())
    tmx.gluon.load_jax_params(
        tnet, {k: p.data().asnumpy()
               for k, p in jnet.collect_params().items()})


LAYERS = [("LSTM", dict(num_layers=2), "TNC"),
          ("GRU", dict(num_layers=1, bidirectional=True), "NTC"),
          ("RNN", dict(num_layers=2, activation="tanh",
                       bidirectional=True), "TNC"),
          ("RNN", dict(num_layers=1, activation="relu"), "NTC"),
          ("LSTM", dict(num_layers=1, bidirectional=True,
                        input_size=I), "NTC")]


@pytest.mark.parametrize("kind,kw,layout", LAYERS, ids=str)
@pytest.mark.parametrize("hybrid", [False, True])
def test_layers_match_jax(kind, kw, layout, hybrid):
    rs = np.random.RandomState(1)
    shape = (T, B, I) if layout == "TNC" else (B, T, I)
    x = rs.randn(*shape).astype(np.float32)
    jl = getattr(jrnn, kind)(H, layout=layout, prefix="ly_", **kw)
    tl = getattr(trnn, kind)(H, layout=layout, prefix="ly_", **kw)
    _cross(jl, tl, x)
    if hybrid:
        tl.hybridize()
    np.testing.assert_allclose(tl(_cpu(x)).asnumpy(),
                               jl(jmx.nd.array(x)).asnumpy(), **TOL)
    n_st = len(jl.state_info())
    st = [rs.randn(*s["shape"]).astype(np.float32)
          for s in jl.state_info(B)]
    jo, js = jl(jmx.nd.array(x), [jmx.nd.array(s) for s in st])
    to, ts = tl(_cpu(x), [_cpu(s) for s in st])
    assert len(ts) == len(js) == n_st
    for g, w in zip([to] + ts, [jo] + js):
        np.testing.assert_allclose(g.asnumpy(), w.asnumpy(), **TOL)
    zeros = tl.begin_state(B, ctx=tmx.cpu())
    assert [z.shape for z in zeros] == [s["shape"] for s in
                                         jl.state_info(B)]
    assert all(float(abs(z).sum().asnumpy()) == 0 for z in zeros)


def test_layer_parameter_names_and_deferred_input_size():
    tl = trnn.LSTM(H, num_layers=2, bidirectional=True, prefix="nm_")
    jl = jrnn.LSTM(H, num_layers=2, bidirectional=True, prefix="nm_")
    assert list(tl.collect_params().keys()) == \
        list(jl.collect_params().keys())
    tl.initialize(ctx=tmx.cpu())
    assert tl.l0_i2h_weight.shape == (4 * H, 0)
    out = tl(_cpu(np.ones((T, B, I), np.float32)))
    assert out.shape == (T, B, 2 * H)
    assert tl.l0_i2h_weight.shape == (4 * H, I)
    assert tl.r1_i2h_weight.shape == (4 * H, 2 * H)


def test_layer_gradients_match_jax():
    rs = np.random.RandomState(2)
    x = rs.randn(T, B, I).astype(np.float32)
    jl = jrnn.GRU(H, num_layers=2, bidirectional=True, prefix="gd_")
    tl = trnn.GRU(H, num_layers=2, bidirectional=True, prefix="gd_")
    _cross(jl, tl, x)
    for mx, net in ((jmx, jl), (tmx, tl)):
        xs = mx.nd.array(x, ctx=mx.cpu())
        with mx.autograd.record():
            loss = (net(xs) ** 2).sum()
        loss.backward()
    for name, tp in tl.collect_params().items():
        np.testing.assert_allclose(
            tp.grad().asnumpy(),
            jl.collect_params()[name].grad().asnumpy(), **TOL)


# -- gluon cells --------------------------------------------------------------

def _cells(pkg, kind):
    r = pkg.gluon.rnn
    if kind == "rnn":
        return r.RNNCell(H, activation="tanh", prefix="c_")
    if kind == "lstm":
        return r.LSTMCell(H, prefix="c_")
    if kind == "gru":
        return r.GRUCell(H, prefix="c_")
    if kind == "sequential":
        seq = r.SequentialRNNCell(prefix="s_")
        seq.add(r.LSTMCell(H, prefix="s0_"))
        seq.add(r.DropoutCell(0.0, prefix="sd_"))
        seq.add(r.GRUCell(H, prefix="s1_"))
        return seq
    if kind == "residual":
        seq = r.SequentialRNNCell(prefix="s_")
        seq.add(r.GRUCell(H, prefix="s0_"))
        seq.add(r.ResidualCell(r.LSTMCell(H, prefix="s1_")))
        return seq
    return r.BidirectionalCell(r.LSTMCell(H, prefix="bl_"),
                               r.GRUCell(H, prefix="br_"), prefix="b_")


@pytest.mark.parametrize("kind", ["rnn", "lstm", "gru", "sequential",
                                  "residual", "bidirectional"])
@pytest.mark.parametrize("layout,merge", [("NTC", True), ("TNC", None),
                                          ("NTC", False)])
def test_cells_unroll_match_jax(kind, layout, merge):
    rs = np.random.RandomState(4)
    x = rs.randn(*((B, T, I) if layout == "NTC" else (T, B, I))).astype(
        np.float32)
    jc, tc = _cells(jmx, kind), _cells(tmx, kind)
    jc.initialize()
    jc.unroll(T, jmx.nd.array(x), layout=layout)
    tc.initialize(ctx=tmx.cpu())
    tmx.gluon.load_jax_params(tc, {k: p.data().asnumpy() for k, p in
                                   jc.collect_params().items()})
    jo, js = jc.unroll(T, jmx.nd.array(x), layout=layout,
                       merge_outputs=merge)
    to, ts = tc.unroll(T, _cpu(x), layout=layout, merge_outputs=merge)
    if merge is False:
        assert isinstance(to, list) and len(to) == T
    else:
        to, jo = [to], [jo]
    for g, w in zip(list(to) + list(ts), list(jo) + list(js)):
        np.testing.assert_allclose(g.asnumpy(), w.asnumpy(), **TOL)


@pytest.mark.parametrize("kind", ["lstm", "gru"])
def test_hybridized_cell_step_matches_eager(kind):
    rs = np.random.RandomState(5)
    x = _cpu(rs.randn(B, I).astype(np.float32))
    cell = _cells(tmx, kind)
    cell.initialize(ctx=tmx.cpu())
    st = cell.begin_state(B, ctx=tmx.cpu())
    eo, es = cell(x, st)
    cell.hybridize()
    ho, hs = cell(x, st)
    for a, b in zip([eo] + es, [ho] + hs):
        np.testing.assert_allclose(a.asnumpy(), b.asnumpy(), **TOL)


def test_valid_length_masks_the_unroll_as_jax():
    rs = np.random.RandomState(6)
    x = rs.randn(B, T, I).astype(np.float32)
    vl = np.array([2, 5, 3], np.float32)
    jc, tc = _cells(jmx, "lstm"), _cells(tmx, "lstm")
    jc.initialize()
    jc.unroll(T, jmx.nd.array(x))
    tc.initialize(ctx=tmx.cpu())
    tmx.gluon.load_jax_params(tc, {k: p.data().asnumpy() for k, p in
                                   jc.collect_params().items()})
    jo, _ = jc.unroll(T, jmx.nd.array(x), valid_length=jmx.nd.array(vl))
    to, _ = tc.unroll(T, _cpu(x), valid_length=_cpu(vl))
    np.testing.assert_allclose(to.asnumpy(), jo.asnumpy(), **TOL)
    assert float(abs(to.asnumpy()[0, 2:]).sum()) == 0.0


# -- the LSTM LM --------------------------------------------------------------

LM = (30, 16, 2)


def test_lstm_lm_forward_matches_jax():
    x = np.random.RandomState(0).randint(0, LM[0], (4, 12)).astype(
        np.float32)
    jnet = jax_lstm_lm(*LM, prefix="lm_")
    tnet = port_lstm_lm(*LM, prefix="lm_")
    _cross(jnet, tnet, x)
    want = jnet(jmx.nd.array(x)).asnumpy()
    assert want.shape == (4, 12, LM[0])
    np.testing.assert_allclose(tnet(_cpu(x)).asnumpy(), want, **TOL)
    tnet.hybridize()
    np.testing.assert_allclose(tnet(_cpu(x)).asnumpy(), want, **TOL)


def _lm_trainers():
    x = np.random.RandomState(1).randint(0, LM[0], (8, 12))
    jnet = jax_lstm_lm(*LM, prefix="lmt_")
    tnet = port_lstm_lm(*LM, prefix="lmt_")
    _cross(jnet, tnet, x.astype(np.float32))
    opt = {"learning_rate": 0.1, "momentum": 0.9}
    jtr = JTrainer(jnet, jmx.gluon.loss.SoftmaxCrossEntropyLoss(),
                   optimizer="sgd", optimizer_params=dict(opt),
                   mesh=jmesh({"dp": 1}, [jax.devices("cpu")[0]]))
    ttr = ParallelTrainer(tnet, tmx.gluon.loss.SoftmaxCrossEntropyLoss(),
                          optimizer="sgd", optimizer_params=dict(opt),
                          mesh=make_mesh({"dp": 1}, [torch.device("cpu")]))
    return jtr, ttr


def test_parallel_trainer_lstm_lm_matches_jax_and_freezes_begin_states():
    """5 SGD steps of get_lstm_lm(30, 16, 2) in both packages from the
    same weights; the auto-created begin states are frozen zeros with no
    optimizer state (tests/test_parallel_modes.py:265 mirrored)."""
    jtr, ttr = _lm_trainers()
    rs = np.random.RandomState(2)
    x = rs.randint(0, LM[0], (8, 12)).astype(np.float32)
    y = rs.randint(0, LM[0], (8, 12)).astype(np.float32)
    jl, tl = [], []
    for _ in range(5):
        jl.append(float(np.asarray(jtr.fit_batch(jmx.nd.array(x),
                                                 jmx.nd.array(y)))))
        tl.append(float(ttr.fit_batch(_cpu(x), _cpu(y))))
    for a, b in zip(tl, jl):
        assert abs(a - b) <= 1e-5 * max(1.0, abs(b)), (tl, jl)
    assert tl[-1] < tl[0]
    # the names carry a per-process counter (rnnN_): compare the kinds
    assert sorted(n.split("_", 1)[1] for n in ttr._frozen) == \
        sorted(n.split("_", 1)[1] for n in jtr._frozen) == \
        ["state", "state_cell"]
    for n in ttr._frozen:
        assert ttr._opt_state[n] == ()
        assert float(ttr._params[n].abs().sum()) == 0.0


def test_parallel_trainer_frozen_states_follow_the_batch_size():
    """A new batch size rebuilds the frozen begin-state zeros
    (tests/test_parallel_modes.py:294 mirrored)."""
    _, ttr = _lm_trainers()
    rs = np.random.RandomState(3)
    for bs in (8, 4, 8):
        x = rs.randint(0, LM[0], (bs, 6)).astype(np.float32)
        y = rs.randint(0, LM[0], (bs, 6)).astype(np.float32)
        assert np.isfinite(float(ttr.fit_batch(_cpu(x), _cpu(y))))
        for n in ttr._frozen:
            assert ttr._params[n].shape == (2, bs, LM[1])


# -- gluon.contrib.rnn --------------------------------------------------------

@pytest.mark.parametrize("dims,kind", [(1, "RNN"), (2, "LSTM"),
                                       (3, "GRU")])
def test_conv_cells_unroll_and_gradients_match_jax(dims, kind):
    shape = (2,) + (4,) * dims
    name = "Conv%dD%sCell" % (dims, kind)
    rs = np.random.RandomState(dims)
    x = rs.randn(2, 3, *shape).astype(np.float32)       # N T C spatial
    kw = dict(input_shape=shape, hidden_channels=3, i2h_kernel=3,
              h2h_kernel=3, i2h_pad=1, prefix="cv_")
    jc, tc = getattr(jcrnn, name)(**kw), getattr(tcrnn, name)(**kw)
    jc.initialize()
    tc.initialize(ctx=tmx.cpu())
    tmx.gluon.load_jax_params(tc, {k: p.data().asnumpy() for k, p in
                                   jc.collect_params().items()})
    for mx, cell in ((jmx, jc), (tmx, tc)):
        xs = mx.nd.array(x, ctx=mx.cpu())
        with mx.autograd.record():
            outs, _ = cell.unroll(3, xs, layout="NTC", merge_outputs=True)
            loss = (outs * outs).sum()
        loss.backward()
        cell.out = outs.asnumpy()
    np.testing.assert_allclose(tc.out, jc.out, **TOL)
    assert tc.out.shape == (2, 3, 3) + (4,) * dims
    for n, p in tc.collect_params().items():
        np.testing.assert_allclose(p.grad().asnumpy(),
                                   jc.collect_params()[n].grad().asnumpy(),
                                   rtol=1e-4, atol=1e-5)


def test_lstmp_cell_matches_jax():
    x = np.random.RandomState(8).randn(2, 5).astype(np.float32)
    jc, tc = (m.LSTMPCell(8, 3, prefix="lp_") for m in (jcrnn, tcrnn))
    jc.initialize()
    jc(jmx.nd.array(x), jc.begin_state(batch_size=2))
    tc.initialize(ctx=tmx.cpu())
    tmx.gluon.load_jax_params(tc, {k: p.data().asnumpy() for k, p in
                                   jc.collect_params().items()})
    jo, js = jc(jmx.nd.array(x), jc.begin_state(batch_size=2))
    to, ts = tc(_cpu(x), tc.begin_state(batch_size=2, ctx=tmx.cpu()))
    assert to.shape == (2, 3) and ts[0].shape == (2, 3) and \
        ts[1].shape == (2, 8)
    for g, w in zip([to] + ts, [jo] + js):
        np.testing.assert_allclose(g.asnumpy(), w.asnumpy(), **TOL)


def test_variational_dropout_is_locked_and_by_moments():
    """One mask per sequence, drawn at the first step and held; its kept
    share is 1 - p within 4 standard errors; inference is unmasked
    (tests/test_contrib.py:159 on the port)."""
    base = trnn.RNNCell(4, prefix="vd_")
    vd = tcrnn.VariationalDropoutCell(base, drop_inputs=0.5,
                                      drop_outputs=0.25)
    vd.initialize(ctx=tmx.cpu())
    n = 4000
    x = _cpu(np.ones((n, 4), np.float32))
    with tmx.autograd.record():
        vd.reset()
        st = vd.begin_state(batch_size=n, ctx=tmx.cpu())
        vd(x, st)
        m_in, m_out = vd._input_mask.asnumpy(), vd._output_mask.asnumpy()
        vd(x, st)
        assert np.array_equal(vd._input_mask.asnumpy(), m_in)
        assert np.array_equal(vd._output_mask.asnumpy(), m_out)
    for m, p in ((m_in, 0.5), (m_out, 0.25)):
        assert set(np.unique(m)) <= {0.0, np.float32(1) / np.float32(1 - p)}
        kept = (m > 0).mean()
        assert abs(kept - (1 - p)) <= 4 * np.sqrt(p * (1 - p) / m.size)
    vd.reset()
    out1, _ = vd(x, vd.begin_state(batch_size=n, ctx=tmx.cpu()))
    assert np.array_equal(vd._input_mask.asnumpy(), np.ones((n, 4)))
    vd.reset()
    out2, _ = vd(x, vd.begin_state(batch_size=n, ctx=tmx.cpu()))
    assert np.array_equal(out1.asnumpy(), out2.asnumpy())
    seq = _cpu(np.ones((1, 6, 4), np.float32))
    outs, _ = vd.unroll(6, seq, layout="NTC", merge_outputs=True,
                        valid_length=_cpu(np.array([4.0])))
    assert outs.shape == (1, 6, 4)


def test_layer_parameter_files_cross_both_packages(tmp_path):
    """``save_parameters`` files of an LSTM stack load into the other
    package's layer, both ways, and give its outputs."""
    x = np.random.RandomState(9).randn(T, B, I).astype(np.float32)
    jl = jrnn.LSTM(H, num_layers=2, bidirectional=True, prefix="pf_")
    tl = trnn.LSTM(H, num_layers=2, bidirectional=True, prefix="pf_")
    jl.initialize()
    want = jl(jmx.nd.array(x)).asnumpy()
    jl.save_parameters(str(tmp_path / "j.params"))
    tl.load_parameters(str(tmp_path / "j.params"), ctx=tmx.cpu())
    np.testing.assert_allclose(tl(_cpu(x)).asnumpy(), want, **TOL)
    tl.save_parameters(str(tmp_path / "t.params"))
    back = jrnn.LSTM(H, num_layers=2, bidirectional=True, prefix="pb_")
    back.load_parameters(str(tmp_path / "t.params"))
    np.testing.assert_allclose(back(jmx.nd.array(x)).asnumpy(), want,
                               **TOL)
