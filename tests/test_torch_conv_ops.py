"""The ResNet op set of the PyTorch port (Convolution, Pooling, BatchNorm,
Flatten, slice, space_to_depth) against the JAX package's
``get_op(name).fn`` on the same numpy inputs: the forward outputs and the
VJP (``jax.vjp`` against ``torch.autograd``) of every output under the
same random cotangents, in float32 and bfloat16.

Tolerances, relative to max(1, max |reference|) of each array: float32
2e-5 against the JAX op in float32 (the two differ in summation order
only).  bfloat16: the port's bfloat16 outputs and gradients against the
JAX op evaluated in float32 on the same bfloat16-rounded inputs and
cotangents, within 2**-5 (a few roundings of the 8-bit mantissa); the
output dtypes are the JAX op's own in bfloat16.  The JAX op run in
bfloat16 is not the reference for values: it sums BatchNorm's and
pooling's reductions in bfloat16, 12 % off on a sum of 100 terms, where
the port sums in float32.

Also pinned here: the convolution precision the port chose (cuDNN's
convolution precision is "ieee" around the forward and both backward
convolutions of a float32 Convolution, left alone for 16-bit ones), the
ops' registry contracts and the shape rules of Convolution and BatchNorm.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from mxnet_tpu.ops import registry as jreg
from mxnet_tpu.symbol import symbol as jsym
from mxnet_tpu_torch.ops import nn as tnn
from mxnet_tpu_torch.ops import registry as treg
from mxnet_tpu_torch.symbol import symbol as tsym

TOL = {"float32": 2e-5, "bfloat16": 2.0 ** -5}
DTYPES = ["float32", "bfloat16"]


def _rand(shape, seed):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want, dtype, what):
    got = got.detach().float().numpy()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()) if want.size else 1.0)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= TOL[dtype] * scale, (what, err, scale)


def _rounded(a, dtype):
    """*a* rounded to *dtype* and back to float32 numpy."""
    return torch.from_numpy(a).to(getattr(torch, dtype)).float().numpy()


def _vjp_both(name, arrays, params, dtype, dtypes=None):
    """Forward and VJP of op *name* in both packages on *arrays* (numpy
    f32, each cast to its dtype: *dtypes* per input, else *dtype*);
    every output gets a random cotangent.  The JAX op runs in float32
    on the rounded values (see the module docstring).  Asserts
    agreement."""
    dtypes = dtypes or [dtype] * len(arrays)
    arrays = [_rounded(a, d) for a, d in zip(arrays, dtypes)]
    jfn = jreg.get_op(name).fn
    jout, jvjp = jax.vjp(lambda *xs: jfn(*xs, **params),
                         *[jnp.asarray(a) for a in arrays])
    single = not isinstance(jout, tuple)
    jouts = (jout,) if single else jout
    typed = jax.eval_shape(
        lambda *xs: jfn(*xs, **params),
        *[jax.ShapeDtypeStruct(a.shape, jnp.dtype(d))
          for a, d in zip(arrays, dtypes)])
    typed = (typed,) if single else typed
    cots = [_rounded(_rand(o.shape, 100 + i), jnp.dtype(t.dtype).name)
            for i, (o, t) in enumerate(zip(jouts, typed))]
    jgrads = jvjp(jnp.asarray(cots[0]) if single
                  else tuple(jnp.asarray(c) for c in cots))

    tin = [torch.from_numpy(a).to(getattr(torch, d)).requires_grad_()
           for a, d in zip(arrays, dtypes)]
    tout = treg.get_op(name).fn(*tin, **params)
    touts = (tout,) if not isinstance(tout, tuple) else tout
    assert len(touts) == len(jouts)
    for i, (t, j, ty) in enumerate(zip(touts, jouts, typed)):
        assert t.dtype == getattr(torch, jnp.dtype(ty.dtype).name), i
        _close(t, np.asarray(j), dtype, "output %d" % i)
    pairs = [(t, torch.from_numpy(c).to(t.dtype)) for t, c in
             zip(touts, cots) if t.requires_grad]
    torch.autograd.backward([t for t, _ in pairs], [c for _, c in pairs])
    for i, (x, g) in enumerate(zip(tin, jgrads)):
        got = x.grad if x.grad is not None else torch.zeros_like(x)
        _close(got, np.asarray(g), dtype, "grad of input %d" % i)


# -- Convolution ---------------------------------------------------------

# (data shape, params, with bias)
CONV_CASES = [
    ((2, 4, 11), dict(kernel=(3,), stride=(2,), pad=(1,), num_filter=6),
     True),
    ((2, 4, 9, 8), dict(kernel=(3, 3), stride=(1, 2), pad=(1, 0),
                        dilate=(2, 1), num_group=2, num_filter=6), False),
    ((2, 3, 7, 7), dict(kernel=(1, 1), num_filter=5), True),
    ((2, 4, 6, 6), dict(kernel=(3, 3), pad=(1, 1), num_group=4,
                        num_filter=8), True),
    ((1, 2, 5, 6, 5), dict(kernel=(2, 3, 2), stride=(2, 1, 1),
                           pad=(0, 1, 1), num_filter=3), True),
    ((1, 3, 9, 9), dict(kernel=(7, 7), stride=(2, 2), pad=(3, 3),
                        num_filter=4), False),
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,params,bias", CONV_CASES,
                         ids=["1d", "2d-dilate-groups", "1x1", "depthwise",
                              "3d", "7x7-s2"])
def test_convolution(shape, params, bias, dtype):
    g = params.get("num_group", 1)
    w = (params["num_filter"], shape[1] // g) + params["kernel"]
    arrays = [_rand(shape, 0), _rand(w, 1) / np.sqrt(np.prod(w[1:]))]
    if bias:
        arrays.append(_rand((params["num_filter"],), 2))
    _vjp_both("Convolution", arrays, dict(params, no_bias=not bias), dtype)


class _PrecisionLog(TorchDispatchMode):
    """Records cuDNN's convolution precision at each aten convolution
    call."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in (torch.ops.aten.convolution,
                                   torch.ops.aten.convolution_backward):
            self.calls.append((func.overloadpacket.__name__,
                               torch.backends.cudnn.conv.fp32_precision))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("dtype,want", [("float32", "ieee"),
                                        ("bfloat16", None),
                                        ("float16", None)])
def test_convolution_precision_is_pinned_forward_and_backward(dtype, want):
    """The chosen f32 setting: a float32 Convolution runs its forward and
    its backward convolutions (data and weight gradients in one
    ``convolution_backward``) with cuDNN's convolution precision "ieee"
    (no TF32), whatever the process default; 16-bit ones leave it be.
    The default comes back after each call."""
    assert tnn.conv_precision(getattr(torch, dtype)) == want
    conv = torch.backends.cudnn.conv
    before = conv.fp32_precision
    dt = getattr(torch, dtype)
    x = torch.randn(2, 3, 6, 6).to(dt).requires_grad_()
    w = torch.randn(4, 3, 3, 3).to(dt).requires_grad_()
    b = torch.randn(4).to(dt).requires_grad_()
    log = _PrecisionLog()
    try:
        conv.fp32_precision = "tf32"
        with log:
            out = treg.get_op("Convolution").fn(x, w, b, kernel=(3, 3),
                                                num_filter=4)
            out.sum().backward()
        after = conv.fp32_precision
    finally:
        conv.fp32_precision = before
    expect = want or "tf32"
    assert log.calls == [("convolution", expect),
                         ("convolution_backward", expect)]
    assert after == "tf32"
    assert x.grad is not None and w.grad is not None and b.grad is not None


# -- Pooling -------------------------------------------------------------

# (data shape, params); every windowed case has (size + 2 pad - k) %
# stride != 0 on some axis, so "full" and "valid" differ, and no window
# lies wholly in the padding (where max gives -inf and a count of real
# elements is 0)
POOL_CASES = [
    ((2, 3, 10, 9), dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1))),
    ((2, 3, 11), dict(kernel=(2,), stride=(2,), pad=(0,))),
    ((1, 2, 7, 6, 5), dict(kernel=(3, 2, 2), stride=(2, 2, 2),
                           pad=(1, 0, 0))),
    ((2, 3, 9, 7), dict(kernel=(3, 3), stride=(3, 2), pad=(1, 1))),
]


# (pool_type, count_include_pad): the flag only changes avg
POOL_TYPES = [("max", True), ("avg", True), ("avg", False), ("sum", True),
              ("lp", True)]


@pytest.mark.parametrize("convention", ["valid", "full"])
@pytest.mark.parametrize("pool_type,count_include_pad", POOL_TYPES)
@pytest.mark.parametrize("case,dtype", [
    (0, "float32"), (1, "float32"), (2, "float32"), (3, "float32"),
    (0, "bfloat16")], ids=["2d-pad", "1d", "3d", "2d-uneven",
                           "2d-pad-bf16"])
def test_pooling(case, dtype, pool_type, count_include_pad, convention):
    shape, params = POOL_CASES[case]
    params = dict(params, pool_type=pool_type, pooling_convention=convention,
                  count_include_pad=count_include_pad)
    x = _rand(shape, 3)
    if pool_type == "lp":
        x = np.abs(x) + 0.5        # |x|^p has no kink to split the VJP
    _vjp_both("Pooling", [x], params, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("pool_type", ["max", "avg", "sum", "lp"])
@pytest.mark.parametrize("shape", [(2, 3, 5, 4), (2, 3, 7), (1, 2, 3, 4, 3)])
def test_global_pooling(shape, pool_type, dtype):
    x = _rand(shape, 4)
    if pool_type == "lp":
        x = np.abs(x) + 0.5
    _vjp_both("Pooling", [x], dict(kernel=(1,) * (len(shape) - 2),
                                   global_pool=True, pool_type=pool_type),
              dtype)


def test_pooling_full_convention_is_not_torch_ceil_mode():
    """A last window that starts in the right padding: torch's ceil_mode
    drops it, the JAX package's "full" keeps it (here one more column),
    and avg divides by the whole kernel."""
    x = torch.arange(1.0, 6.0).reshape(1, 1, 5)
    got = treg.get_op("Pooling").fn(x, kernel=(2,), stride=(2,), pad=(1,),
                                    pool_type="avg",
                                    pooling_convention="full")
    ceil = torch.nn.functional.avg_pool1d(x, 2, 2, 1, ceil_mode=True)
    want = jreg.get_op("Pooling").fn(jnp.asarray(x.numpy()), kernel=(2,),
                                     stride=(2,), pad=(1,), pool_type="avg",
                                     pooling_convention="full")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    assert got.shape[-1] == 4 and ceil.shape[-1] == 3


# -- BatchNorm -----------------------------------------------------------

@pytest.mark.parametrize("fix_gamma", [True, False])
@pytest.mark.parametrize("mode", ["training", "inference",
                                  "use_global_stats"])
@pytest.mark.parametrize("shape,axis,dtype", [
    ((4, 3, 5, 5), 1, "float32"), ((6, 2, 4), -1, "float32"),
    ((4, 3, 5, 5), 1, "bfloat16")], ids=["nchw", "axis-last", "nchw-bf16"])
def test_batch_norm_all_five_outputs(shape, axis, dtype, mode, fix_gamma):
    """Out, batch mean and biased variance, and both new moving stats;
    the VJP carries every output's cotangent through the batch
    statistics.  A 16-bit input keeps its statistics (and the moving
    stats) in float32, as a cast BatchNorm layer does."""
    c = shape[axis]
    x = _rand(shape, 5) * 2.0 + 0.5
    arrays = [x, 1.0 + 0.1 * _rand((c,), 6), _rand((c,), 7),
              0.1 * _rand((c,), 8), 1.0 + 0.2 * np.abs(_rand((c,), 9))]
    params = dict(axis=axis, eps=1e-3, momentum=0.9, fix_gamma=fix_gamma,
                  use_global_stats=mode == "use_global_stats",
                  training=mode != "inference")
    _vjp_both("BatchNorm", arrays, params, dtype,
              dtypes=[dtype] + ["float32"] * 4)


def test_batch_norm_moves_by_momentum_with_the_biased_variance():
    """new = moving * 0.9 + batch * 0.1 with the biased variance; torch's
    own running-stat update would give the unbiased one and weigh the
    other way."""
    x = torch.from_numpy(_rand((8, 2, 3, 3), 10))
    mm, mv = torch.full((2,), 0.5), torch.full((2,), 2.0)
    out = treg.get_op("BatchNorm").fn(x, torch.ones(2), torch.zeros(2), mm,
                                      mv, momentum=0.9, fix_gamma=False)
    var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
    torch.testing.assert_close(out[3], 0.5 * 0.9 + mean * 0.1)
    torch.testing.assert_close(out[4], 2.0 * 0.9 + var * 0.1)
    assert treg.get_op("BatchNorm").aux_states == {3: 3, 4: 4}


# -- Flatten, slice, space_to_depth ----------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_flatten(dtype):
    _vjp_both("Flatten", [_rand((2, 3, 4, 5), 11)], {}, dtype)
    assert treg.get_op("flatten") is treg.get_op("Flatten")


SLICES = [
    dict(begin=(0, 0, 0, 0), end=(None, None, -1, -1)),
    dict(begin=(None, 1, -1), end=(None, -1, None), step=(None, 2, -2)),
    dict(begin=(-1, None), end=(None, None), step=(-1, -3)),
    dict(begin=(1, 4), end=(2, 0), step=(1, -1)),
    dict(begin=(1,), end=(3,)),
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("params", SLICES, ids=["s2d-stem", "neg-steps",
                                                "reverse", "neg-range",
                                                "leading-axis"])
def test_slice(params, dtype):
    _vjp_both("slice", [_rand((3, 5, 6, 7), 12)], params, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_space_to_depth(dtype):
    _vjp_both("space_to_depth", [_rand((2, 3, 8, 6), 13)],
              dict(block_size=2), dtype)


# -- contracts, shape rules and symbol JSON --------------------------------

NEW_OPS = ["Convolution", "Pooling", "BatchNorm", "Flatten", "slice",
           "space_to_depth"]


@pytest.mark.parametrize("name", NEW_OPS)
def test_op_contract_matches_jax(name):
    jop, top = jreg.get_op(name), treg.get_op(name)
    assert top.input_names == jop.input_names
    assert top.param_names == jop.param_names
    assert top.aux_states == jop.aux_states
    for params in ({}, {"no_bias": True}, {"no_bias": False}):
        assert top.n_out(params) == jop.n_out(params)
        assert top.n_visible(params) == jop.n_visible(params)
        assert top.input_names_for(params) == jop.input_names_for(params)


@pytest.mark.parametrize("name,params,ins", [
    ("Convolution", dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                         num_filter=8, num_group=2), [(2, 4, 9, 8), None,
                                                      None]),
    ("Convolution", dict(kernel=(5,), dilate=(2,), num_filter=3,
                         no_bias=True), [(1, 2, 20), None]),
    ("Convolution", dict(kernel=3, num_filter=3), [(1, 2, 20), None, None]),
    ("BatchNorm", dict(axis=1), [(4, 6, 3, 3)] + [None] * 4),
    ("BatchNorm", dict(axis=-1), [(4, 6, 5)] + [None] * 4),
])
def test_shape_rules_match_jax(name, params, ins):
    """The deferred weight, bias and statistics shapes and the output
    shape, as the JAX package infers them (a kernel of 3 is the JAX
    JSON's spelling of (3,))."""
    got = tsym._SHAPE_RULES[name](params, list(ins))
    jparams = dict(params, kernel=(params["kernel"],)) \
        if isinstance(params.get("kernel"), int) else params
    want = jsym._SHAPE_RULES[name](jparams, list(ins))
    assert [tuple(s) if s else s for s in got[0]] == \
        [tuple(s) if s else s for s in want[0]]
    assert [tuple(s) for s in got[1]] == [tuple(s) for s in want[1]]


@pytest.mark.parametrize("value", [(None, None, -1, -1), (0, 0, 0, 0),
                                   False, True, "full", "NCHW", (7, 7)])
def test_resnet_attrs_round_trip(value):
    """Attribute values of the ResNet graph survive the symbol JSON in
    both packages: None inside a tuple, booleans, strings."""
    s = tsym._stringify(value)
    assert tsym._parse_attr(s) == jsym._parse_attr(s) == value


def test_resnet_graph_json_round_trips_both_ways():
    """A port graph with the ResNet ops (layout=None dropped, booleans,
    strings, None inside a tuple) loads back with equal params in the
    port and in the JAX package."""
    from mxnet_tpu_torch import symbol as sym
    x = sym.var("data")
    h = sym.Convolution(x, kernel=(4, 4), pad=(2, 2), num_filter=8,
                        no_bias=True, layout=None, name="conv")
    h = sym.slice(h, begin=(0, 0, 0, 0), end=(None, None, -1, -1),
                  name="cut")
    h = sym.BatchNorm(h, fix_gamma=False, use_global_stats=False,
                      name="bn")
    h = sym.Pooling(h, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                    pool_type="max", global_pool=False,
                    pooling_convention="full", name="pool")
    text = h.tojson()

    def params(nodes):
        return {n.name: n.params for n in nodes if not n.is_var}
    want = params(h._topo())
    assert "layout" not in want["conv"]
    assert params(tsym.load_json(text)._topo()) == want
    assert params(jsym.load_json(text)._topo()) == want
    assert tsym.load_json(text).list_auxiliary_states() == \
        ["bn_moving_mean", "bn_moving_var"]
