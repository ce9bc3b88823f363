"""The attention gradient in the PyTorch port against the JAX package.

The port's plain backward versions (``_flash_bwd_dkdv_plain`` /
``_flash_bwd_dq_plain``, the CPU path and the backward kernels'
yardstick on the card) are held against the JAX package's Pallas
backward kernels run in interpret mode, on the same q, k, v, o, lse and
dO: f32 atol 2e-4, the tolerance tests/test_attention.py gives the
Pallas backward.  The port's ``torch.autograd.Function`` is held against
``jax.vjp`` of the JAX einsum oracle (f32, atol 2e-4: the same gradient,
summed blockwise against all at once), and against finite differences
with ``torch.autograd.gradcheck`` in f64.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import attention as jatt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import attention as tatt

# (sq, sk, causal): square, cross-length both ways (sq > sk leaves rows
# that see no key), ragged lengths that are not block multiples; the
# grid of tests/test_torch_attention.py
CASES = [(32, 32, True), (32, 32, False), (16, 40, True), (40, 16, True),
         (24, 56, False), (33, 17, True), (17, 33, False)]


def _inputs(b, h, sq, sk, d, seed):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, h, sq, d), (b, h, sk, d), (b, h, sk, d),
                      (b, h, sq, d))]


def _t(*arrs):
    return [torch.from_numpy(np.array(a)) for a in arrs]


def _jax_fwd_bwd(q, k, v, do, causal, scale, dtype=jnp.float32):
    """(o, lse (b, h, sq), dq, dk, dv) of the Pallas kernels, interpret
    mode, 16-row blocks."""
    jq, jk, jv, jdo = (jnp.asarray(a, dtype) for a in (q, k, v, do))
    b, h, sq, _ = q.shape
    o, lse = jatt._flash_fwd_pallas(jq, jk, jv, causal, scale, blk_q=16,
                                    blk_k=16, interpret=True, with_lse=True)
    dq, dk, dv = jatt._flash_bwd_pallas(jq, jk, jv, o, lse, jdo, causal,
                                        scale, blk_q=16, blk_k=16,
                                        interpret=True)
    lse = np.asarray(lse)[:, :sq].reshape(b, h, sq)
    return o, lse, dq, dk, dv


@pytest.mark.parametrize("sq,sk,causal", CASES)
def test_plain_bwd_matches_pallas_interpret(sq, sk, causal):
    q, k, v, do = _inputs(1, 2, sq, sk, 16, seed=sq * 100 + sk)
    scale = 1.0 / math.sqrt(16)
    o, lse, jdq, jdk, jdv = _jax_fwd_bwd(q, k, v, do, causal, scale)
    tq, tk, tv, tdo, to, tlse = _t(q, k, v, do, o, lse)
    delta = tatt._delta(to, tdo)
    dk, dv = tatt._flash_bwd_dkdv_plain(tq, tk, tv, tdo, tlse, delta, causal,
                                        scale, chunk=16)
    dq = tatt._flash_bwd_dq_plain(tq, tk, tv, tdo, tlse, delta, causal,
                                  scale, chunk=16)
    for got, want in ((dq, jdq), (dk, jdk), (dv, jdv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=2e-4)
    if sq > sk and causal:
        # the first sq - sk rows see no key and pass zero gradient
        assert np.all(dq.numpy()[:, :, :sq - sk] == 0)


@pytest.mark.parametrize("sq,sk,causal", CASES)
@pytest.mark.parametrize("chunk", [7, 512])
def test_function_grads_match_jax_vjp_of_reference(sq, sk, causal, chunk):
    q, k, v, do = _inputs(2, 2, sq, sk, 8, seed=sq + sk)

    def ref(q_, k_, v_):
        return jatt.attention_reference(q_, k_, v_, causal=causal)

    want_o, vjp = jax.vjp(ref, *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    out = tatt.flash_attention(tq, tk, tv, causal=causal, chunk=chunk)
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_o),
                               rtol=0, atol=1e-5)
    for t, w in zip((tq, tk, tv), want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=0,
                                   atol=2e-4)


@pytest.mark.parametrize("causal", [True, False])
def test_bf16_grads_match_pallas_bf16_and_f32_oracle(causal):
    q, k, v, do = _inputs(1, 2, 32, 48, 16, seed=11)
    scale = 1.0 / 4.0
    _, _, jdq, jdk, jdv = _jax_fwd_bwd(q, k, v, do, causal, scale,
                                       jnp.bfloat16)
    _, vjp = jax.vjp(lambda a, b, c: jatt.attention_reference(
        a, b, c, causal=causal), *(jnp.asarray(a) for a in (q, k, v)))
    oracle = vjp(jnp.asarray(do))
    tq, tk, tv = (t.to(torch.bfloat16).requires_grad_()
                  for t in _t(q, k, v))
    out = tatt.flash_attention(tq, tk, tv, causal=causal)
    out.backward(torch.from_numpy(do).to(torch.bfloat16))
    for t, jw, ow in zip((tq, tk, tv), (jdq, jdk, jdv), oracle):
        assert t.grad.dtype == torch.bfloat16
        got = t.grad.float().numpy()
        np.testing.assert_allclose(got, np.asarray(jw, np.float32),
                                   rtol=5e-2, atol=5e-2)
        np.testing.assert_allclose(got, np.asarray(ow), rtol=5e-2,
                                   atol=5e-2)


@pytest.mark.parametrize("sq,sk,causal", [(5, 5, True), (6, 4, True),
                                          (4, 7, False), (3, 9, True)])
def test_gradcheck_f64(sq, sk, causal):
    g = torch.Generator().manual_seed(sq * 10 + sk)
    q, k, v = (torch.randn(1, 2, n, 3, generator=g, dtype=torch.float64,
                           requires_grad=True) for n in (sq, sk, sk))

    def fn(q_, k_, v_):
        return tatt.flash_attention(q_, k_, v_, causal=causal, chunk=2)

    assert torch.autograd.gradcheck(fn, (q, k, v), eps=1e-6, atol=1e-6)


def test_no_grad_path_keeps_no_graph_and_lse():
    q, k, v, _ = _inputs(1, 2, 8, 8, 4, seed=3)
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    with torch.no_grad():
        out = tatt.flash_attention(tq, tk, tv, causal=True)
    assert out.grad_fn is None
    o, lse = tatt.flash_attention(tq, tk, tv, causal=True, with_lse=True)
    assert o.grad_fn is not None and not lse.requires_grad
    # shape inference on the meta device stays on the plain forward
    m = [torch.empty(1, 2, 8, 4, device="meta") for _ in range(3)]
    assert tatt.flash_attention(*m, causal=True).shape == (1, 2, 8, 4)


def test_cpu_backward_runs_plain_versions_and_launches_nothing():
    q, k, v, do = _inputs(1, 2, 16, 16, 8, seed=5)
    counts = (tatt.flash_fwd.launches, tatt.flash_bwd_dkdv.launches,
              tatt.flash_bwd_dq.launches)
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    tatt.flash_attention(tq, tk, tv, causal=True).backward(
        torch.from_numpy(do))
    assert (tatt.flash_fwd.launches, tatt.flash_bwd_dkdv.launches,
            tatt.flash_bwd_dq.launches) == counts
    o, lse = tatt._chunked_attention(*_t(q, k, v), True, with_lse=True)
    dq, dk, dv = tatt._flash_bwd_plain(*_t(q, k, v), o, lse,
                                       torch.from_numpy(do), True)
    for t, want in zip((tq, tk, tv), (dq, dk, dv)):
        np.testing.assert_array_equal(t.grad.numpy(), want.numpy())


@pytest.mark.parametrize("wrapper", ["flash_bwd", "flash_bwd_dkdv",
                                     "flash_bwd_dq"])
def test_bwd_wrappers_refuse_cpu_tensors(wrapper):
    q, k, v, do = _t(*_inputs(1, 1, 8, 8, 8, seed=1))
    o, lse = tatt._chunked_attention(q, k, v, True, with_lse=True)
    if wrapper == "flash_bwd":
        args = (q, k, v, o, lse, do)
    else:
        args = (q, k, v, do, lse, tatt._delta(o, do))
    counts = (tatt.flash_bwd_dkdv.launches, tatt.flash_bwd_dq.launches)
    with pytest.raises(MXNetError, match="CUDA tensors"):
        getattr(tatt, wrapper)(*args)
    assert (tatt.flash_bwd_dkdv.launches,
            tatt.flash_bwd_dq.launches) == counts
