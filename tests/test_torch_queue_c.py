"""Faults of the PyTorch port against the reference, held in both
packages' terms on the CPU (each case runs the JAX package and the port).

1. Initialization follows ``mx.random.seed``: the same seed gives the
   same weights, a new seed new weights, and two blocks initialized one
   after the other get different weights — through ``Block.initialize``,
   ``Parameter.initialize`` and ``Module.init_params``.  The two
   packages' random streams differ, so the cases check behaviour, not
   draws.
2. A 64-bit dtype that a user names narrows where it enters, as in the
   reference (JAX without x64): int64 -> int32, uint64 -> uint32,
   float64 -> float32, in ``nd.array``, the creation functions,
   ``astype``, ``Cast``, ``Parameter.cast``/``Block.cast`` and
   ``DataLoader`` batches.  ``mxnet_tpu_torch.enable_x64()`` keeps them,
   as JAX's ``enable_x64`` scope does for the reference.
3. ``gluon.nn.Embedding(sparse_grad=True)`` under ``gluon.Trainer`` with
   an optimizer that has a lazy row update (SGD, AdaGrad) moves only the
   rows a batch touched: momentum and weight decay leave the other rows
   as they were.  A row touched in the first step but not the second
   ends as the JAX package's within 1e-6; a row no step touched ends
   bit-unchanged.  Adam, which has no lazy update, takes the dense
   gradient in both packages.
4. (ROADMAP C1) A row-sparse gradient that names a row more than once
   (``sparse_add`` keeps repeats) moves that row by the sum of its
   entries: plain SGD as the JAX package within 1e-6; SGD with momentum
   and AdaGrad as their update with the summed gradient within 1e-6 (the
   JAX package's own momentum and AdaGrad keep one entry or add per-entry
   steps, ROADMAP's caveats); rows no slot names bit-unchanged.
5. (C2) ``Initializer.__call__`` routes by name to the reference's hooks,
   ``hook(self, desc, arr)`` with the ``InitDesc``: a subclass's
   ``_init_bias``, zeros for ``*moving_inv_var``/``*moving_avg``, a user
   ``_init_weight(desc, arr)``; every built-in still follows
   ``mx.random.seed``.
6. (C3) ``Block.collect_params(select)`` filters by regular expression,
   and ``Updater.get_states(dump_optimizer=...)`` is accepted, as in the
   JAX package.
"""

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

PKGS = {"jax": jmx, "port": tmx}


def _ctx(pkg):
    return {"ctx": tmx.cpu()} if pkg == "port" else {}


def _dense_weights(pkg, seed, n=1):
    """The weights of *n* ``Dense(4, in_units=4)`` blocks initialized one
    after the other after ``mx.random.seed(seed)``."""
    mx = PKGS[pkg]
    mx.random.seed(seed)
    out = []
    for _ in range(n):
        blk = mx.gluon.nn.Dense(4, in_units=4)
        blk.initialize(mx.init.Uniform(1.0), **_ctx(pkg))
        out.append(blk.weight.data().asnumpy())
    return out


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_same_seed_gives_the_same_weights(pkg):
    a, = _dense_weights(pkg, 7)
    b, = _dense_weights(pkg, 7)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_new_seed_gives_new_weights(pkg):
    a, = _dense_weights(pkg, 1)
    b, = _dense_weights(pkg, 2)
    assert not np.array_equal(a, b)


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_two_blocks_in_a_row_differ(pkg):
    a, b = _dense_weights(pkg, 3, n=2)
    assert not np.array_equal(a, b)


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_parameter_initialize_follows_the_seed(pkg):
    mx = PKGS[pkg]

    def draw(seed):
        mx.random.seed(seed)
        p = mx.gluon.Parameter("w", shape=(3, 5), init=mx.init.Normal(1.0))
        p.initialize(**_ctx(pkg))
        return p.data().asnumpy()

    np.testing.assert_array_equal(draw(5), draw(5))
    assert not np.array_equal(draw(5), draw(6))


def _module_weights(pkg, seed):
    mx = PKGS[pkg]
    data = mx.sym.var("data")
    net = mx.sym.FullyConnected(data, num_hidden=6, name="fc")
    net = mx.sym.SoftmaxOutput(net, name="softmax")
    kw = {"context": tmx.cpu()} if pkg == "port" else {}
    mod = mx.mod.Module(net, **kw)
    mod.bind(data_shapes=[("data", (2, 5))],
             label_shapes=[("softmax_label", (2,))])
    mx.random.seed(seed)
    mod.init_params(initializer=mx.init.Uniform(1.0))
    return mod.get_params()[0]["fc_weight"].asnumpy()


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_module_init_params_follows_the_seed(pkg):
    np.testing.assert_array_equal(_module_weights(pkg, 11),
                                  _module_weights(pkg, 11))
    assert not np.array_equal(_module_weights(pkg, 11),
                              _module_weights(pkg, 12))


# -- 64-bit dtypes ----------------------------------------------------------

WIDE = (("int64", "int32"), ("uint64", "uint32"), ("float64", "float32"))


def _creations(pkg, dt):
    mx = PKGS[pkg]
    kw = _ctx(pkg)
    return {
        "array": mx.nd.array([1, 2, 3], dtype=dt, **kw),
        "zeros": mx.nd.zeros((2,), dtype=dt, **kw),
        "ones": mx.nd.ones((2,), dtype=dt, **kw),
        "empty": mx.nd.empty((2,), dtype=dt, **kw),
        "full": mx.nd.full((2,), 3, dtype=dt, **kw),
        "astype": mx.nd.ones((2,), **kw).astype(dt),
        "Cast": mx.nd.Cast(mx.nd.ones((2,), **kw), dtype=dt),
    }


@pytest.mark.parametrize("pkg", sorted(PKGS))
@pytest.mark.parametrize("wide,narrow", WIDE)
def test_64_bit_dtypes_narrow(pkg, wide, narrow):
    got = {k: str(v.dtype) for k, v in _creations(pkg, wide).items()}
    assert got == {k: narrow for k in got}, got


@pytest.mark.parametrize("pkg", sorted(PKGS))
@pytest.mark.parametrize("wide,narrow", (WIDE[0], WIDE[2]))
def test_arange_narrows(pkg, wide, narrow):
    mx = PKGS[pkg]
    a = mx.nd.arange(0, 4, dtype=wide, **_ctx(pkg))
    assert str(a.dtype) == narrow
    np.testing.assert_array_equal(a.asnumpy(), [0, 1, 2, 3])


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_block_and_parameter_cast_narrow(pkg):
    mx = PKGS[pkg]
    blk = mx.gluon.nn.Dense(3, in_units=2)
    blk.initialize(**_ctx(pkg))
    blk.cast("float64")
    assert str(blk.weight.data().dtype) == "float32"
    p = mx.gluon.Parameter("q", shape=(2,))
    p.initialize(**_ctx(pkg))
    p.cast("float64")
    assert str(p.data().dtype) == "float32"


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_dataloader_batches_int64_labels_as_int32(pkg):
    mx = PKGS[pkg]
    x = np.arange(12, dtype=np.float64).reshape(6, 2)
    y = np.arange(6, dtype=np.int64)
    ds = mx.gluon.data.ArrayDataset(x, y)
    loader = mx.gluon.data.DataLoader(ds, batch_size=3)
    if pkg == "port":
        with tmx.cpu():
            xb, yb = next(iter(loader))
    else:
        xb, yb = next(iter(loader))
    assert str(xb.dtype) == "float32"
    assert str(yb.dtype) == "int32"
    np.testing.assert_array_equal(yb.asnumpy(), [0, 1, 2])


@pytest.mark.parametrize("wide", [w for w, _ in WIDE])
def test_enable_x64_keeps_64_bit_dtypes(wide):
    with tmx.enable_x64():
        got = {k: str(v.dtype) for k, v in _creations("port", wide).items()}
        assert got == {k: wide for k in got}, got
        blk = tmx.gluon.nn.Dense(3, in_units=2)
        blk.initialize(ctx=tmx.cpu())
        if wide == "float64":
            blk.cast(wide)
            assert str(blk.weight.data().dtype) == wide
    # the scope ends: narrowing again
    assert str(tmx.nd.array([1], dtype=wide, ctx=tmx.cpu()).dtype) != wide


def test_enable_x64_matches_the_reference_scope():
    """The reference's scope is JAX's enable_x64 (``jax.enable_x64`` in
    this JAX, ``jax.experimental.enable_x64`` in older ones): inside it
    both packages keep int64 and float64 where a user names them."""
    import jax
    with jax.enable_x64(True):
        j = jmx.nd.array([1, 2], dtype="int64")
        jf = jmx.nd.ones((2,)).astype("float64")
    with tmx.enable_x64():
        t = tmx.nd.array([1, 2], dtype="int64", ctx=tmx.cpu())
        tf = tmx.nd.ones((2,), ctx=tmx.cpu()).astype("float64")
    assert str(j.dtype) == str(t.dtype) == "int64"
    assert str(jf.dtype) == str(tf.dtype) == "float64"


# -- 3. row-sparse Embedding gradients under gluon.Trainer -------------------

SPARSE_OPTS = {
    "sgd-momentum-wd": ("sgd", {"learning_rate": 0.1, "momentum": 0.9,
                                "wd": 0.01}),
    "sgd-momentum": ("sgd", {"learning_rate": 0.1, "momentum": 0.9}),
    "adagrad": ("adagrad", {"learning_rate": 0.1, "wd": 0.01}),
}
SPARSE_STEPS = ([1, 2], [3, 4])         # row 1, 2 then 3, 4
SPARSE_UNTOUCHED = [0, 5, 6, 7, 8, 9]


def _sparse_embedding_run(pkg, opt, params):
    """A 10 x 3 ``Embedding(sparse_grad=True)`` from seeded weights, two
    ``Trainer`` steps of sum((emb(ids) - 1)^2): (start, end) weights."""
    mx = PKGS[pkg]
    w0 = np.random.RandomState(5).randn(10, 3).astype(np.float32)
    emb = mx.gluon.nn.Embedding(10, 3, sparse_grad=True)
    emb.initialize(**_ctx(pkg))
    emb.weight.set_data(mx.nd.array(w0, **_ctx(pkg)))
    trainer = mx.gluon.Trainer(emb.collect_params(), opt, dict(params))
    for ids in SPARSE_STEPS:
        x = mx.nd.array(np.asarray(ids, np.float32), **_ctx(pkg))
        with mx.autograd.record():
            loss = mx.nd.sum(mx.nd.square(emb(x) - 1.0))
        loss.backward()
        trainer.step(len(ids))
    return w0, emb.weight.data().asnumpy()


@pytest.mark.parametrize("case", sorted(SPARSE_OPTS))
def test_sparse_grad_embedding_trainer_matches_jax(case):
    opt, params = SPARSE_OPTS[case]
    _, want = _sparse_embedding_run("jax", opt, params)
    w0, got = _sparse_embedding_run("port", opt, params)
    assert np.abs(got - want).max() <= 1e-6, (got, want)
    # lazy updates: rows no step touched stay bit for bit
    np.testing.assert_array_equal(got[SPARSE_UNTOUCHED], w0[SPARSE_UNTOUCHED])


def test_sparse_grad_embedding_adam_stays_dense():
    """Adam has no lazy row update: weight decay moves every row, in both
    packages (outputs within 1e-5 of max(1, max |JAX|): Adam divides by
    sqrt(v) of near-zero second moments, which magnifies f32 rounding)."""
    params = {"learning_rate": 0.1, "wd": 0.01}
    _, want = _sparse_embedding_run("jax", "adam", params)
    w0, got = _sparse_embedding_run("port", "adam", params)
    assert np.abs(got - want).max() <= 1e-5 * max(1.0, np.abs(want).max())
    assert (got[SPARSE_UNTOUCHED] != w0[SPARSE_UNTOUCHED]).all()


# -- 4. a repeated row id in a row-sparse gradient (C1) ----------------------

def _repeated_rsp(mx, **ctx):
    """ids [1, 1, 3]: row 1 twice (values 1 and 2), row 3 once."""
    sp = mx.nd.sparse
    a = sp.row_sparse_array((np.ones((2, 2), np.float32), [1, 3]),
                            shape=(5, 2), **ctx)
    b = sp.row_sparse_array((np.full((1, 2), 2.0, np.float32), [1]),
                            shape=(5, 2), **ctx)
    return sp.sparse_add(a, b)


def _summed_rsp(mx, **ctx):
    return mx.nd.sparse.row_sparse_array(
        (np.array([[3, 3], [1, 1]], np.float32), [1, 3]), shape=(5, 2),
        **ctx)


C1_UNTOUCHED = [0, 2, 4]


def _c1_step(mx, opt, params, grad_fn, steps=2, **ctx):
    w0 = np.random.RandomState(11).randn(5, 2).astype(np.float32)
    o = mx.optimizer.create(opt, **params)
    w = mx.nd.array(w0, **ctx)
    st = o.create_state(0, w)
    for _ in range(steps):
        o.update(0, w, grad_fn(mx, **ctx), st)
    return w0, w.asnumpy()


def test_repeated_row_ids_sum_in_plain_sgd():
    """The ROADMAP case: a 5 x 2 weight of ones, lr 0.1 moves row 1 to
    0.7 (the dense gradient's update) in both packages."""
    got = {}
    for pkg, mx in PKGS.items():
        w = mx.nd.ones((5, 2), **_ctx(pkg))
        mx.nd.sparse.sgd_row_update(w, _repeated_rsp(mx, **_ctx(pkg)),
                                    lr=0.1)
        got[pkg] = w.asnumpy()
    np.testing.assert_allclose(got["port"][1], [0.7, 0.7], atol=1e-6)
    assert np.abs(got["port"] - got["jax"]).max() <= 1e-6
    np.testing.assert_array_equal(got["port"][C1_UNTOUCHED], 1.0)
    # (no weight decay: the JAX package adds wd x w once per entry, so a
    # repeated id decays twice there; ROADMAP's caveats)
    _, want = _c1_step(jmx, "sgd", {"learning_rate": 0.1}, _repeated_rsp)
    w0, port = _c1_step(tmx, "sgd", {"learning_rate": 0.1}, _repeated_rsp,
                        ctx=tmx.cpu())
    assert np.abs(port - want).max() <= 1e-6
    np.testing.assert_array_equal(port[C1_UNTOUCHED], w0[C1_UNTOUCHED])


@pytest.mark.parametrize("opt,params", [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 0.01}),
    ("adagrad", {"learning_rate": 0.1, "wd": 0.01})])
def test_repeated_row_ids_sum_in_momentum_and_adagrad(opt, params):
    """Two steps with the repeated ids equal two steps with the summed
    gradient (one entry a row), in the port and in the JAX package's
    summed-gradient run."""
    _, want = _c1_step(jmx, opt, params, _summed_rsp)
    _, summed = _c1_step(tmx, opt, params, _summed_rsp, ctx=tmx.cpu())
    w0, got = _c1_step(tmx, opt, params, _repeated_rsp, ctx=tmx.cpu())
    assert np.abs(got - summed).max() <= 1e-6, (got, summed)
    assert np.abs(got - want).max() <= 1e-6, (got, want)
    np.testing.assert_array_equal(got[C1_UNTOUCHED], w0[C1_UNTOUCHED])


def test_repeated_row_ids_with_padding_slots():
    """Out-of-range padding slots (the id V that the executor pads pair
    arrays with) write nothing, beside a repeated id."""
    from mxnet_tpu_torch.ndarray.sparse import sgd_rows_
    import torch
    w = torch.ones((5, 2))
    ids = torch.tensor([3, 5, 1, 1, 5], dtype=torch.int32)
    vals = torch.tensor([[1., 1.], [9., 9.], [1., 1.], [2., 2.], [9., 9.]])
    sgd_rows_(w, ids, vals, lr=0.1)
    want = np.ones((5, 2), np.float32)
    want[1] -= 0.3
    want[3] -= 0.1
    np.testing.assert_allclose(w.numpy(), want, atol=1e-7)
    np.testing.assert_array_equal(w.numpy()[C1_UNTOUCHED], 1.0)


# -- 5. Initializer dispatch (C2) ----------------------------------------------

def _filled(mx, pkg, init, name, shape=(3,)):
    arr = mx.nd.zeros(shape, **_ctx(pkg))
    init(mx.init.InitDesc(name), arr)
    return arr.asnumpy()


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_initializer_routes_to_subclass_hooks(pkg):
    mx = PKGS[pkg]

    class TwoBias(mx.init.Uniform):
        def _init_bias(self, desc, arr):
            arr[:] = 2.0

    np.testing.assert_array_equal(_filled(mx, pkg, TwoBias(), "fc_bias"),
                                  [2.0, 2.0, 2.0])
    for name in ("bn_moving_inv_var", "ema_moving_avg"):
        np.testing.assert_array_equal(
            _filled(mx, pkg, mx.init.Uniform(0.5), name), [0.0] * 3)
    np.testing.assert_array_equal(
        _filled(mx, pkg, mx.init.Uniform(0.5), "bn_gamma"), [1.0] * 3)
    np.testing.assert_array_equal(
        _filled(mx, pkg, mx.init.Uniform(0.5), "bn_moving_var"), [1.0] * 3)


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_user_initializer_takes_the_reference_hook_signature(pkg):
    mx = PKGS[pkg]
    seen = []

    class Sevens(mx.init.Initializer):
        def _init_weight(self, desc, arr):
            seen.append(desc)
            arr[:] = 7.0

    desc = mx.init.InitDesc("Conv_Weight", attrs={"lr_mult": "2"})
    arr = mx.nd.zeros((2,), **_ctx(pkg))
    Sevens()(desc, arr)
    np.testing.assert_array_equal(arr.asnumpy(), [7.0, 7.0])
    assert isinstance(seen[0], mx.init.InitDesc)
    assert str(seen[0]) == "Conv_Weight"
    assert seen[0].attrs == {"lr_mult": "2"}
    # default: anything else goes to _init_default, then _init_weight
    np.testing.assert_array_equal(_filled(mx, pkg, Sevens(), "alpha"),
                                  [7.0] * 3)


BUILTINS = [("uniform", {}), ("normal", {}), ("xavier", {}),
            ("msraprelu", {}), ("orthogonal", {})]


@pytest.mark.parametrize("name,kw", BUILTINS)
def test_builtin_initializers_follow_the_seed(name, kw):
    def draw(seed):
        tmx.random.seed(seed)
        return _filled(tmx, "port", tmx.init.create(name, **kw),
                       "fc_weight", (4, 6))
    a, b, c = draw(3), draw(3), draw(4)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


def test_initializer_register_name_and_aliases():
    for mx in PKGS.values():
        @mx.init.register(name="fives", aliases=("five",))
        class _Fives(mx.init.Initializer):
            def _init_weight(self, desc, arr):
                arr[:] = 5.0
        for n in ("fives", "five", "FIVE"):
            assert type(mx.init.create(n)) is _Fives
        np.testing.assert_array_equal(
            _filled(mx, "port" if mx is tmx else "jax",
                    mx.init.create("five"), "w_weight"), [5.0] * 3)


# -- 6. collect_params(select) and get_states(dump_optimizer) (C3) -------------

def _bn_net(mx):
    net = mx.gluon.nn.HybridSequential(prefix="n_")
    with net.name_scope():
        net.add(mx.gluon.nn.Dense(4, in_units=3),
                mx.gluon.nn.BatchNorm(in_channels=4),
                mx.gluon.nn.Dense(2, in_units=4))
    return net


def test_collect_params_select_regex():
    got = {}
    for pkg, mx in PKGS.items():
        net = _bn_net(mx)
        assert len(net.collect_params()) == 8
        got[pkg] = sorted(net.collect_params(".*weight|.*gamma").keys())
        assert sorted(net.collect_params(None).keys()) == \
            sorted(net.collect_params().keys())
    assert got["port"] == got["jax"]
    assert len(got["port"]) == 3


def test_updater_get_states_dump_optimizer():
    import pickle
    blobs = {}
    for pkg, mx in PKGS.items():
        o = mx.optimizer.create("sgd", learning_rate=0.1, momentum=0.9)
        upd = mx.optimizer.get_updater(o)
        w = mx.nd.ones((3,), **_ctx(pkg))
        upd(0, mx.nd.ones((3,), **_ctx(pkg)), w)
        plain = pickle.loads(upd.get_states(dump_optimizer=False))
        dumped = pickle.loads(upd.get_states(dump_optimizer=True))
        assert "optimizer" not in plain
        assert type(dumped["optimizer"]).__name__ == "SGD"
        assert dumped["optimizer"].momentum == 0.9
        blobs[pkg] = plain
    for key in ("__format__", "opt_class", "hyper_sig"):
        assert blobs["port"][key] == blobs["jax"][key], key
    np.testing.assert_array_equal(blobs["port"]["states"][0][1],
                                  blobs["jax"]["states"][0][1])
