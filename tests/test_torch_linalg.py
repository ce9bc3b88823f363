"""The 20 ``linalg`` op names and ``histogram`` of mxnet_tpu_torch against
the JAX package on the CPU (the cases of ``test_utils.sparse_op_cases``,
run through both packages' ops on the same seeded numpy inputs).

Tolerances as ``test_torch_parity_tail.py``: outputs within 1e-5 x
max(1, max |JAX|), gradients by ``jax.vjp`` within 1e-4 x max |g|,
histogram counts equal (its data lies on the edges) and its edges within
the output tolerance.
Eigenvectors (``syevd``) and LQ factors (``gelqf``) are compared after
giving each vector the JAX solver's sign, and their reconstruction is
held too; their gradients are taken of sign-free quantities (the
eigenvalues, |L|).  The JAX package's quirks hold in the port:
``_linalg_trmm`` multiplies by the whole of *a*, ``_linalg_potri``
takes the Cholesky factor.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch.ops import registry as treg
from test_torch_parity_tail import CASES, check_case

LINALG_CASES = [c for c in CASES if c["kind"] == "op" and
                ("linalg" in c["name"] or "histogram" in c["name"])]


@pytest.mark.parametrize("case", LINALG_CASES, ids=lambda c: c["id"])
def test_linalg_op_matches_jax(case):
    check_case(case)


def test_cases_cover_the_twenty_two_names():
    names = {c["name"] for c in LINALG_CASES}
    assert len(names) == 22
    assert {n for n in jreg.list_ops() if "linalg" in n or "histogram" in n
            } == names


def _both(name, *arrays, **params):
    j = jreg.get_op(name).fn(*[jnp.asarray(a) for a in arrays], **params)
    t = treg.get_op(name).fn(*[torch.from_numpy(np.asarray(a))
                               for a in arrays], **params)
    return j, t


def test_trmm_ignores_lower_as_the_reference_does():
    rs = np.random.RandomState(3)
    a, b = rs.randn(4, 4).astype(np.float32), rs.randn(4, 2).astype(
        np.float32)
    j, t = _both("_linalg_trmm", a, b, lower=True)
    np.testing.assert_allclose(t.numpy(), a @ b, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                               atol=1e-5)


def test_potri_takes_the_cholesky_factor():
    rs = np.random.RandomState(4)
    m = rs.randn(5, 5)
    spd = (m @ m.T + 5 * np.eye(5)).astype(np.float32)
    low = np.linalg.cholesky(spd.astype(np.float64)).astype(np.float32)
    j, t = _both("_linalg_potri", low)
    np.testing.assert_allclose(t.numpy() @ spd, np.eye(5), atol=1e-4)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("name", ["_linalg_syevd", "linalg_gelqf"])
def test_factorizations_reconstruct(name):
    rs = np.random.RandomState(5)
    if name == "_linalg_syevd":
        a = rs.randn(5, 5)
        a = (a + a.T).astype(np.float32)
        u, w = treg.get_op(name).fn(torch.from_numpy(a))
        rec = u.T @ torch.diag(w) @ u
    else:
        a = rs.randn(3, 6).astype(np.float32)
        q, low = treg.get_op(name).fn(torch.from_numpy(a))
        rec = low @ q
        np.testing.assert_allclose((q @ q.T).numpy(), np.eye(3), atol=1e-5)
    np.testing.assert_allclose(rec.numpy(), a, atol=1e-5)


def test_factorization_gradients_match_jax():
    """Gradients of sign-free quantities: the eigenvalues, and |L|."""
    rs = np.random.RandomState(6)
    a = rs.randn(4, 4)
    a = (a + a.T + np.diag([-6.0, -2.0, 2.0, 6.0])).astype(np.float32)
    c = rs.randn(4).astype(np.float32)
    b = rs.randn(3, 5).astype(np.float32)
    cl = rs.randn(3, 3).astype(np.float32)

    def j_eig(x):
        return jnp.sum(jreg.get_op("_linalg_syevd").fn(x)[1] * c)

    def j_lq(x):
        return jnp.sum(jnp.abs(jreg.get_op("_linalg_gelqf").fn(x)[1]) * cl)

    for jfn, x, tfn in (
            (j_eig, a, lambda t: (treg.get_op("_linalg_syevd").fn(t)[1] *
                                  torch.from_numpy(c)).sum()),
            (j_lq, b, lambda t: (treg.get_op("_linalg_gelqf").fn(t)[1].abs()
                                 * torch.from_numpy(cl)).sum())):
        want = np.asarray(jax.grad(jfn)(jnp.asarray(x)))
        t = torch.from_numpy(x.copy()).requires_grad_()
        tfn(t).backward()
        err = np.abs(t.grad.numpy() - want).max()
        assert err <= 1e-4 * np.abs(want).max(), err


def test_histogram_edges_follow_jnp_linspace():
    """Edges by jnp.linspace's formula (lo (1 - s) + hi s), with data on
    every edge and bins whose width is not a power of two: counts equal,
    edges within the output tolerance (XLA's compiled linspace
    reassociates and contracts that formula on the CPU and may round an
    edge one ulp apart; ROADMAP "Caveats")."""
    data = np.array([-0.3, 0.0, 0.7, 1.4, 2.1, 2.8, 3.5, 0.35, 3.15, 9.0],
                    np.float32)
    for params in (dict(bin_cnt=7, range=(-0.35, 3.5)), dict(bin_cnt=3),
                   dict(bin_cnt=5, range=(0, 5))):
        (jh, je), (th, te) = _both("histogram", data, **params)
        je = np.asarray(je)
        assert np.abs(te.numpy() - je).max() <= \
            1e-5 * max(1.0, np.abs(je).max())
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
        # data on each edge the two packages round alike
        same = te.numpy()[te.numpy() == je]
        assert same.size >= je.size - 1
        on_edges = np.concatenate([data, same])
        (jh, _), (th, _) = _both("histogram", on_edges, **params)
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
