"""The elementwise, reduce, tensor, random, Dropout and InstanceNorm ops of
the PyTorch port against the JAX package's ``get_op(name).fn``, one
parametrised case per op name and case of the op sweep
(``mxnet_tpu_torch.test_utils.op_sweep_cases``), on the same numpy inputs
(fixed seed).

Tolerances: an "exact" case (shape, index, comparison, integer and
exactly-rounded ops) must give equal values, NaNs in the same places,
and the same dtype and shape.  A "float" case (transcendental and summing
ops) is held to 1e-6 of the element's magnitude or of the array's
largest magnitude, whichever is larger: XLA's and PyTorch's f32 math
functions differ by a few ulps (6e-8 relative each) and their sums by
summation order, and near a zero of the function the difference is one
of the operands' scale, not of the result's.  A "random" case is held by
distribution (mean and variance within 4 standard errors), never by
draws: the two packages' random streams differ.

Every op name the JAX package registers in ``ops/{elemwise,reduce,
tensor}.py`` (less ``_linalg_*``, ``histogram`` and
``_contrib_SparseEmbedding``), ``Dropout``, ``InstanceNorm`` and the
samplers of ``ops/random_ops.py`` with their aliases has a case, and its
registry contract (input names, parameter names, needs_rng, canonical
name) equals the JAX registry's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu.ops.elemwise as jelemwise
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch.ops import registry as treg
from mxnet_tpu_torch.runtime import rng as trng
from mxnet_tpu_torch.test_utils import (SAMPLER_MOMENTS, moments_within,
                                        op_sweep_cases)

FLOAT_TOL = 1e-6
# the port's registry: these families' 275 names and 91 others (the
# layers' ops, the loss heads, attention, the optimizer updates, RNN, the
# four control-flow ops, the nine _image_* ops with their aliases, the
# 17 quantization names, the 16 layer-op names of
# test_utils.layer_op_cases, and the 37 detection and spatial names of
# test_utils.detection_op_cases)
N_PORT_OPS = 403

_JAX_MODULES = {"mxnet_tpu.ops.elemwise", "mxnet_tpu.ops.reduce",
                "mxnet_tpu.ops.tensor", "mxnet_tpu.ops.random_ops"}


def _not_ported_yet(name):
    return name.startswith(("_linalg_", "linalg_")) or \
        name in ("histogram", "_histogram", "_contrib_SparseEmbedding")


def _slice_names():
    """Every JAX op name whose op is registered by the slice's modules
    (aliases included), less the names left for a later slice."""
    tables = list(jelemwise._UNARY.values()) + \
        list(jelemwise._BINARY.values())
    canon = {id(op) for _, op in jreg.iter_registrations()
             if getattr(op.fn, "__module__", None) in _JAX_MODULES
             or op.name in ("Dropout", "InstanceNorm")
             or any(op.fn is f for f in tables)}
    return sorted(n for n in jreg.list_ops()
                  if id(jreg.get_op(n)) in canon and not _not_ported_yet(n))


SLICE_NAMES = _slice_names()
CASES = op_sweep_cases(seed=0, draws=100000)


def test_every_slice_name_has_a_case_and_the_count_is_pinned():
    assert len(SLICE_NAMES) == 275
    assert {c["name"] for c in CASES} == set(SLICE_NAMES)
    assert set(SLICE_NAMES) <= set(treg.list_ops())
    assert len(treg.list_ops()) == N_PORT_OPS


@pytest.mark.parametrize("name", SLICE_NAMES)
def test_contract_matches_jax(name):
    jop, top = jreg.get_op(name), treg.get_op(name)
    assert top.name == jop.name
    assert top.input_names == jop.input_names
    assert top.param_names == jop.param_names
    assert top.needs_rng == jop.needs_rng
    for params in ({}, {"act_type": "prelu"}, {"num_outputs": 3},
                   {"ret_typ": "both"}):
        assert top.n_out(params) == jop.n_out(params)
        assert top.n_visible(params) == jop.n_visible(params)
        assert top.input_names_for(params) == jop.input_names_for(params)


def _tuple(out):
    return out if isinstance(out, tuple) else (out,)


def _run_jax(case, key=None):
    fn = jreg.get_op(case["name"]).fn
    args = [jnp.asarray(a) for a in case["inputs"]]
    if key is not None:
        args.insert(0, key)
    return [np.asarray(o) for o in _tuple(fn(*args, **case["params"]))]


def _run_port(case, gen=None):
    fn = treg.get_op(case["name"]).fn
    args = [torch.from_numpy(a.copy()) for a in case["inputs"]]
    if gen is not None:
        args.insert(0, gen)
    return [o.numpy() for o in _tuple(fn(*args, **case["params"]))]


def _equal(a, b):
    if a.dtype.kind in "fc":
        return bool(np.all((a == b) | (np.isnan(a) & np.isnan(b))))
    return bool(np.all(a == b))


@pytest.mark.parametrize("case", [c for c in CASES if c["kind"] != "random"],
                         ids=lambda c: c["id"])
def test_op_matches_jax(case):
    want = _run_jax(case)
    got = _run_port(case)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert g.dtype == w.dtype, (g.dtype, w.dtype)
        if case["kind"] == "exact":
            assert _equal(g, w), (g, w)
        else:
            scale = max(1.0, float(np.nanmax(np.abs(w))) if w.size else 1.0)
            fin = np.isfinite(w)
            assert np.array_equal(fin, np.isfinite(g))
            err = np.abs(g[fin].astype(np.float64) - w[fin])
            lim = FLOAT_TOL * np.maximum(np.abs(w[fin]), scale)
            assert np.all(err <= lim), float(np.max(err / lim))


RANDOM = [c for c in CASES if c["kind"] == "random"]


@pytest.mark.parametrize("case", RANDOM, ids=lambda c: c["id"])
def test_random_op_shape_dtype_and_distribution(case):
    want = _run_jax(case, key=jax.random.PRNGKey(0))
    gen = torch.Generator()
    gen.manual_seed(1)
    got = _run_port(case, gen)
    assert [g.shape for g in got] == [w.shape for w in want]
    assert [g.dtype for g in got] == [w.dtype for w in want]
    canon = treg.get_op(case["name"]).name
    out = got[0].astype(np.float64)
    if canon == "Dropout":
        p = case["params"]["p"]
        kept = out != 0
        ok, text = moments_within(kept.reshape(-1).astype(np.float64),
                                  1 - p, p * (1 - p))
        assert ok, text
        np.testing.assert_array_equal(out[kept], np.float32(1 / (1 - p)))
        np.testing.assert_array_equal(got[1], out)
    elif canon == "shuffle":
        x = case["inputs"][0]
        rows = sorted(map(tuple, got[0]))
        assert rows == sorted(map(tuple, x))
    else:
        mean, var = SAMPLER_MOMENTS[canon]
        rows = out.reshape(len(np.atleast_1d(mean)), -1)
        for row, m, v in zip(rows, np.atleast_1d(mean), np.atleast_1d(var)):
            ok, text = moments_within(row, m, v)
            assert ok, text
    # one generator state gives the same draws twice
    gen.manual_seed(1)
    again = _run_port(case, gen)
    for g, a in zip(got, again):
        np.testing.assert_array_equal(g, a)


def test_dropout_is_the_identity_outside_training():
    x = torch.randn(5, 7)
    gen = torch.Generator()
    out, mask = treg.get_op("Dropout").fn(gen, x, p=0.5, training=False)
    assert torch.equal(out, x) and torch.equal(mask, torch.ones_like(x))
    out, _ = treg.get_op("Dropout").fn(gen, x, p=0.5, training=False,
                                       mode="always")
    assert not torch.equal(out, x)


def test_global_stream_reseeds():
    trng.seed(7)
    a = torch.rand(4, generator=trng.generator("cpu"))
    trng.seed(7)
    b = torch.rand(4, generator=trng.generator("cpu"))
    assert torch.equal(a, b)
