"""The nine ops of the LM serving graph in the PyTorch port against the JAX
package's ``get_op(name).fn`` on the same numpy inputs (f32, atol 1e-5),
plus their registry contracts and the symbol-JSON attribute parsing."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import registry as jreg
from mxnet_tpu.symbol import symbol as jsym
from mxnet_tpu_torch.ops import registry as treg
from mxnet_tpu_torch.symbol import symbol as tsym

SERVED_OPS = ["FullyConnected", "Reshape", "transpose", "broadcast_add",
              "LayerNorm", "_contrib_DotProductAttention", "Activation",
              "Embedding", "slice_like"]


def _run_both(name, arrays, params):
    jout = jreg.get_op(name).fn(*(jnp.asarray(a) for a in arrays), **params)
    tout = treg.get_op(name).fn(*(torch.from_numpy(a) for a in arrays),
                                **params)
    if not isinstance(jout, tuple):
        jout, tout = (jout,), (tout,)
    assert len(jout) == len(tout)
    for j, t in zip(jout, tout):
        assert tuple(t.shape) == tuple(j.shape)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                   atol=1e-5)


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("name", SERVED_OPS)
def test_op_contract_matches_jax(name):
    jop, top = jreg.get_op(name), treg.get_op(name)
    assert top.name == jop.name
    assert top.input_names == jop.input_names
    if name != "broadcast_add":
        # the JAX op is jnp.add itself, whose ufunc keywords ('out',
        # 'where') show up as its param names
        assert top.param_names == jop.param_names
    assert top.needs_rng == jop.needs_rng
    for params in ({}, {"no_bias": True}, {"output_mean_var": True}):
        assert top.n_out(params) == jop.n_out(params)
        assert top.n_visible(params) == jop.n_visible(params)
        assert top.input_names_for(params) == jop.input_names_for(params)


@pytest.mark.parametrize("alias_name", ["_plus", "elemwise_add"])
def test_broadcast_add_aliases(alias_name):
    assert treg.get_op(alias_name) is treg.get_op("broadcast_add")
    assert jreg.get_op(alias_name) is jreg.get_op("broadcast_add")


@pytest.mark.parametrize("flatten,no_bias,shape", [
    (True, False, (3, 4, 5)), (False, False, (2, 3, 20)),
    (False, True, (2, 3, 20)), (True, True, (6, 20))])
def test_fully_connected(flatten, no_bias, shape):
    in_units = int(np.prod(shape[1:])) if flatten else shape[-1]
    arrays = [_rand(*shape), _rand(7, in_units, seed=1)]
    if not no_bias:
        arrays.append(_rand(7, seed=2))
    _run_both("FullyConnected", arrays,
              dict(num_hidden=7, no_bias=no_bias, flatten=flatten))


@pytest.mark.parametrize("act", ["relu", "sigmoid", "tanh", "softrelu",
                                 "softsign", "gelu", "swish"])
def test_activation(act):
    _run_both("Activation", [_rand(4, 9)], dict(act_type=act))


@pytest.mark.parametrize("axis,shape", [(-1, (2, 5, 8)), (1, (3, 6, 4))])
def test_layer_norm_all_three_outputs(axis, shape):
    c = shape[axis]
    _run_both("LayerNorm", [_rand(*shape), _rand(c, seed=1),
                            _rand(c, seed=2)], dict(axis=axis, eps=1e-5))


@pytest.mark.parametrize("spec,reverse,shape", [
    ((0, 0, 4, -1), False, (2, 3, 8)), ((0, 0, -1), False, (2, 3, 4, 2)),
    ((-3, -1), False, (2, 3, 4)), ((-4, 2, -1, 0), False, (6, 5)),
    ((-2,), False, (2, 3)), ((0, -1), True, (2, 3, 4))])
def test_reshape_codes(spec, reverse, shape):
    _run_both("Reshape", [_rand(*shape)], dict(shape=spec, reverse=reverse))


@pytest.mark.parametrize("axes", [(0, 2, 1, 3), (3, 2, 1, 0), None])
def test_transpose(axes):
    _run_both("transpose", [_rand(2, 3, 4, 5)], dict(axes=axes))


@pytest.mark.parametrize("axes", [(1,), (1, 2), ()])
def test_slice_like(axes):
    _run_both("slice_like", [_rand(1, 9, 6), _rand(2, 4, 3)],
              dict(axes=axes))


def test_slice_like_accepts_jax_json_spelling():
    # the JAX package writes axes=(1,) as "(1)", which parses as int 1
    axes = jsym._parse_attr(jsym._stringify((1,)))
    assert axes == 1
    x, y = _rand(1, 9, 6), _rand(2, 4, 6)
    got = treg.get_op("slice_like").fn(torch.from_numpy(x),
                                       torch.from_numpy(y), axes=axes)
    np.testing.assert_array_equal(got.numpy(), x[:, :4])


@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_embedding_ids_float_or_int(dtype):
    ids = np.random.RandomState(3).randint(0, 11, (2, 7)).astype(dtype)
    _run_both("Embedding", [ids, _rand(11, 5)],
              dict(input_dim=11, output_dim=5))


@pytest.mark.parametrize("shapes", [((2, 3, 4), (2, 3, 4)),
                                    ((2, 3, 4), (1, 3, 4)),
                                    ((2, 1, 4), (1, 3, 1))])
def test_broadcast_add(shapes):
    _run_both("broadcast_add", [_rand(*shapes[0]), _rand(*shapes[1], seed=1)],
              {})


@pytest.mark.parametrize("causal", [True, False])
def test_dot_product_attention(causal):
    _run_both("_contrib_DotProductAttention",
              [_rand(2, 3, 10, 8), _rand(2, 3, 10, 8, seed=1),
               _rand(2, 3, 10, 8, seed=2)], dict(causal=causal))


@pytest.mark.parametrize("value", [True, False, 1e-05, -1, 512, (1, 2),
                                   (0, 0, 4, -1), "relu", None])
def test_attr_strings_parse_like_jax(value):
    s = tsym._stringify(value)
    assert tsym._parse_attr(s) == jsym._parse_attr(s) == value


# -- the reference's index rules (jnp.take / take_along_axis) -------------

def _vjp_both(name, arrays, params, wrt):
    """Forward and the gradient wrt input *wrt* of one op in both
    packages, for an all-ones cotangent on the finite outputs."""
    import jax
    jargs = [jnp.asarray(a) for a in arrays]

    def jf(x):
        args = list(jargs)
        args[wrt] = x
        return jreg.get_op(name).fn(*args, **params)
    jout, jvjp = jax.vjp(jf, jargs[wrt])
    ct = jnp.where(jnp.isnan(jout), 0.0, 1.0).astype(jout.dtype)
    targs = [torch.from_numpy(a) for a in arrays]
    targs[wrt].requires_grad_()
    tout = treg.get_op(name).fn(*targs, **params)
    tout.backward(torch.from_numpy(np.array(ct)))
    return (tout.detach().numpy(), np.asarray(jout),
            targs[wrt].grad.numpy(), np.asarray(jvjp(ct)[0]))


@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_embedding_out_of_range_ids_match_jax(dtype):
    """An id >= input_dim or < -input_dim gives a NaN row, an id in
    [-input_dim, 0) wraps, and neither passes gradient to a wrong row:
    ids [0, 3, 4, -1] of a 4-row table read rows 0, 3, NaN and 3."""
    ids = np.array([[0, 3, 4, -1], [-4, -5, 7, 2]], dtype)
    got, want, g, jg = _vjp_both("Embedding", [ids, _rand(4, 3)],
                                 dict(input_dim=4, output_dim=3), wrt=1)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[0, 2]).all() and np.isnan(got[1, 1:3]).all()
    np.testing.assert_allclose(got[0, 3], got[0, 1], rtol=0, atol=0)
    np.testing.assert_allclose(np.nan_to_num(got), np.nan_to_num(want),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(g, jg, rtol=0, atol=1e-6)


def test_pick_out_of_range_index_matches_jax():
    """``pick`` follows ``jnp.take_along_axis``: index 5 of a row of 4
    is NaN, -1 is the last element; the gradient matches."""
    data = _rand(3, 4)
    idx = np.array([5, -1, -5], np.float32)
    got, want, g, jg = _vjp_both("pick", [data, idx], dict(axis=-1), wrt=0)
    assert np.isnan(got[0]) and np.isnan(got[2])
    assert got[1] == data[1, -1]
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(np.nan_to_num(got), np.nan_to_num(want),
                               rtol=0, atol=0)
    np.testing.assert_allclose(g, jg, rtol=0, atol=0)


@pytest.mark.parametrize("source", [
    np.array(3.5), np.int64(7), 5, np.array(2, np.int64), [1, 2],
    np.arange(3, dtype=np.int64), np.arange(2, dtype=np.uint64),
    np.arange(3, dtype=np.float64), np.array([1, 2], np.int16)],
    ids=["0d-f64", "np-int64-scalar", "py-int", "0d-int64", "py-list",
         "int64", "uint64", "float64", "int16"])
def test_nd_array_shape_and_dtype_match_jax(source):
    """0-d stays 0-d; int64 data and Python ints become int32 (uint64
    uint32, float64 float32), as the reference stores them without
    x64."""
    import mxnet_tpu as jmx
    import mxnet_tpu_torch as tmx
    got = tmx.nd.array(source, ctx=tmx.cpu())
    want = jmx.nd.array(source)
    assert got.shape == want.shape
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_saved_0d_and_int_arrays_cross_packages(writer, tmp_path):
    """nd.save / nd.load keep 0-d shapes and give int32 for int64 data,
    whichever package wrote the file and whichever reads it."""
    import ml_dtypes
    import mxnet_tpu as jmx
    import mxnet_tpu_torch as tmx
    data = {"s": np.array(2.5, np.float32), "i": np.arange(3),
            "z": np.array(4, np.int64),
            "b": np.array(1.5, ml_dtypes.bfloat16)}
    fname = str(tmp_path / "x.params")
    if writer == "jax":
        jmx.nd.save(fname, {k: jmx.nd.array(v) for k, v in data.items()})
    else:
        tmx.nd.save(fname, {k: tmx.nd.array(v, ctx=tmx.cpu())
                            for k, v in data.items()})
    jgot = jmx.nd.load(fname)
    tgot = tmx.nd.load(fname, ctx=tmx.cpu())
    for k in data:
        assert tgot[k].shape == jgot[k].shape == data[k].shape, k
        assert tgot[k].dtype == jgot[k].dtype, k
        np.testing.assert_array_equal(tgot[k].asnumpy(), jgot[k].asnumpy())
    assert tgot["i"].dtype == np.int32 and tgot["z"].dtype == np.int32
