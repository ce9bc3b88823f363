"""Two faults of the PyTorch port against the reference, held in both
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
