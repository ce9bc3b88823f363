"""The long tail of the op registry in mxnet_tpu_torch against the JAX
package on the CPU: the 24 names of the reference's ops/parity.py, each
case of ``test_utils.sparse_op_cases`` run through both packages' op on
the same seeded numpy inputs.

Tolerances: outputs within 1e-5 x max(1, max |JAX|); gradients (by
``jax.vjp`` on the JAX side, ``torch.autograd`` on the port's, seeded
cotangents) within 1e-4 x max |g|; discrete outputs (shapes, matches,
counts) equal; the per-row samplers by their moments within 4 standard
errors, in both packages (their random streams differ).

Also: the port registers exactly the 48 names of this slice, 451 of the
reference's 453, with the reference's contracts.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch.ops import registry as treg
from mxnet_tpu_torch.test_utils import (SAMPLER_MOMENTS, SPARSE_SLICE_NAMES,
                                        align_signs, moments_within,
                                        sparse_op_cases)

TOL_OUT = 1e-5
TOL_GRAD = 1e-4
CASES = sparse_op_cases(0)


def _module(name):
    return jreg.get_op(name).fn.__module__.split(".")[-1]


PARITY_CASES = [c for c in CASES if c["kind"] in ("op", "sample") and
                _module(c["name"]) == "parity"]


def _cots(shapes, seed):
    rs = np.random.RandomState(seed)
    return [rs.standard_normal(tuple(s)).astype(np.float32) for s in shapes]


def run_port(case, seed=16):
    """(outputs, gradients of the inputs ``case['grads']``) of the port's
    op on the CPU, numpy."""
    op = treg.get_op(case["name"])
    ins = [torch.from_numpy(np.array(a)) for a in case["inputs"]]
    for i in case["grads"]:
        ins[i].requires_grad_()
    args = ([torch.Generator().manual_seed(seed)] if op.needs_rng else []) \
        + ins
    out = op.fn(*args, **case["params"])
    outs = list(out) if isinstance(out, tuple) else [out]
    live = [(o, torch.from_numpy(c)) for o, c in
            zip(outs, _cots([o.shape for o in outs], seed))
            if o.requires_grad]
    if live:
        torch.autograd.backward([o for o, _ in live], [c for _, c in live])
    grads = [ins[i].grad.numpy() if ins[i].grad is not None
             else np.zeros(ins[i].shape, np.float32) for i in case["grads"]]
    return [o.detach().numpy() for o in outs], grads


def run_jax(case, seed=16):
    """The same through the JAX package's op, gradients by ``jax.vjp``."""
    op = jreg.get_op(case["name"])
    ins = [jnp.asarray(a) for a in case["inputs"]]
    lead = [jax.random.PRNGKey(seed)] if op.needs_rng else []
    gi = list(case["grads"])

    def f(*g):
        full = list(ins)
        for i, v in zip(gi, g):
            full[i] = v
        out = op.fn(*lead, *full, **case["params"])
        return tuple(out) if isinstance(out, (tuple, list)) else (out,)

    outs, vjp = jax.vjp(f, *[ins[i] for i in gi])
    grads = []
    if gi:
        cots = tuple(
            jnp.asarray(c) if jnp.issubdtype(o.dtype, jnp.floating)
            else np.zeros(o.shape, jax.dtypes.float0)
            for c, o in zip(_cots([o.shape for o in outs], seed), outs))
        grads = [np.asarray(g) for g in vjp(cots)]
    return [np.asarray(o) for o in outs], grads


def check_case(case):
    """Hold the port's op to the JAX package's on *case*."""
    got, got_g = run_port(case)
    want, want_g = run_jax(case)
    assert len(got) == len(want)
    signs = case.get("signs", {})
    flips = {}
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (k, g.shape, w.shape)
        if k in case.get("exact", []):
            np.testing.assert_array_equal(g, w)
            assert g.dtype == w.dtype, (g.dtype, w.dtype)
            continue
        if k in signs:
            link = case.get("sign_links", {}).get(k)
            gt, wt = torch.from_numpy(g), torch.from_numpy(w)
            if link is None:
                gt, flips[k] = align_signs(gt, wt, signs[k])
            else:           # the signs of the linked output's vectors
                s = flips[link]
                gt = gt * (s if signs[k] == -1 else s.swapaxes(-1, -2))
            g = gt.numpy()
        scale = max(1.0, float(np.abs(w).max())) if w.size else 1.0
        assert np.abs(g - w).max() <= TOL_OUT * scale, \
            (case["id"], k, np.abs(g - w).max(), scale)
    for i, (g, w) in zip(case["grads"], zip(got_g, want_g)):
        scale = float(np.abs(w).max())
        err = float(np.abs(g - w).max())
        assert err <= TOL_GRAD * scale or err <= 1e-7, \
            (case["id"], i, err, scale)


def check_sampler(case, mx_is_port):
    """Each row of the draws by its moments."""
    if mx_is_port:
        got, _ = run_port(case)
    else:
        got, _ = run_jax(case)
    means, vars_ = SAMPLER_MOMENTS[case["name"]]
    for row, m, v in zip(got[0], means, vars_):
        ok, text = moments_within(np.asarray(row, np.float64), m, v)
        assert ok, text


@pytest.mark.parametrize("case", [c for c in PARITY_CASES
                                  if c["kind"] == "op"],
                         ids=lambda c: c["id"])
def test_parity_op_matches_jax(case):
    check_case(case)


@pytest.mark.parametrize("pkg", ["port", "jax"])
@pytest.mark.parametrize("case", [c for c in PARITY_CASES
                                  if c["kind"] == "sample"],
                         ids=lambda c: c["id"])
def test_sampler_moments(case, pkg):
    check_sampler(case, pkg == "port")


def test_cases_cover_the_twenty_four_parity_names():
    names = {c["name"] for c in PARITY_CASES}
    ref = {n for n in jreg.list_ops() if _module(n) == "parity"}
    left = ref - set(treg.list_ops()) - names
    assert len(names) == 24 and not left


def test_breadth_grows_by_the_forty_eight_names():
    """451 of the reference's 453 names, every one the reference's; the
    two left are MoEFFN's (ROADMAP queue A item 16)."""
    port, ref = set(treg.list_ops()), set(jreg.list_ops())
    new = set(SPARSE_SLICE_NAMES)
    assert len(new) == 48 and new <= port
    assert len(port) == 451 and port <= ref and len(ref) == 453
    assert ref - port == {"MoEFFN", "_contrib_MoEFFN"}
    left = collections.Counter(_module(n) for n in new)
    assert left == {"parity": 24, "tensor": 23, "nn": 1}
    for n in new:
        assert hasattr(tmx.nd, n) and hasattr(tmx.sym, n), n
        if n.startswith("_contrib_"):
            short = n[len("_contrib_"):]
            assert hasattr(tmx.nd.contrib, short) and \
                hasattr(tmx.sym.contrib, short), n
            assert hasattr(jmx.nd.contrib, short), n


@pytest.mark.parametrize("name", sorted(set(SPARSE_SLICE_NAMES) -
                                        {"Custom"}))
def test_contract_matches_jax(name):
    jop, top = jreg.get_op(name), treg.get_op(name)
    assert top.name == jop.name
    assert top.input_names == jop.input_names
    assert top.param_names == jop.param_names
    assert top.needs_rng == jop.needs_rng
    assert top.n_out({}) == jop.n_out({})
    assert top.n_visible({}) == jop.n_visible({})


def test_top_level_names():
    for name in ("operator", "subgraph"):
        assert hasattr(tmx, name) and hasattr(jmx, name)
    assert hasattr(tmx.nd, "sparse") and hasattr(tmx.io, "LibSVMIter")
