"""Attention in the PyTorch port against the JAX package.

The port's plain forward (``_chunked_attention``, the CPU path and the
kernel's yardstick on the card) is held against the JAX package's Pallas
flash kernel run in interpret mode and against its einsum oracle, on the
same numpy inputs.  f32 tolerance atol 1e-5 (the same f32 online softmax,
summed in another order); bf16 rtol/atol 5e-2 against the f32 oracle, as
tests/test_attention.py uses.
"""

import ast
import inspect
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import attention as jatt
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import attention as tatt
from mxnet_tpu_torch.ops import registry as treg


def _qkv(b, h, sq, sk, d, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, h, sq, d), (b, h, sk, d), (b, h, sk, d))]


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


# (sq, sk, causal): square, cross-length both ways (sq > sk leaves rows
# that see no key), ragged lengths that are not block multiples
CASES = [(32, 32, True), (32, 32, False), (16, 40, True), (40, 16, True),
         (24, 56, False), (33, 17, True), (17, 33, False)]


@pytest.mark.parametrize("sq,sk,causal", CASES)
def test_plain_forward_matches_pallas_interpret(sq, sk, causal):
    q, k, v = _qkv(1, 2, sq, sk, 16, seed=sq * 100 + sk)
    scale = 1.0 / math.sqrt(16)
    jo, jl = jatt._flash_fwd_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, scale,
        blk_q=16, blk_k=16, interpret=True, with_lse=True)
    jl = np.asarray(jl)[:, :sq].reshape(1, 2, sq)
    to, tl = tatt._chunked_attention(*_t(q, k, v), causal, scale, chunk=16,
                                     with_lse=True)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(tl.numpy(), jl, rtol=1e-6, atol=1e-5)


# (sq, sk, d, causal) with lengths that no block divides and head dims off
# 16: ragged both ways, Sq > Sk with rows that see no key (causal) and
# with every row seeing every key (not causal); D = 300 is past 256, which
# the CUDA kernels take in their wide branch
RAGGED = [(50, 70, 24, True), (70, 50, 24, True), (70, 50, 40, False),
          (45, 45, 80, True), (90, 37, 32, True), (50, 70, 300, True),
          (70, 50, 300, True)]


@pytest.mark.parametrize("sq,sk,d,causal", RAGGED)
def test_forward_matches_pallas_interpret_at_ragged_blocks(sq, sk, d,
                                                           causal):
    """The dispatcher on the CPU (the kernel's plain version) against the
    Pallas kernel in interpret mode with blocks that divide neither
    length: the same o, the same lse, and zeros with lse +1e30 on rows
    that see no key."""
    q, k, v = _qkv(2, 1, sq, sk, d, seed=sq * 7 + sk + d)
    scale = 1.0 / math.sqrt(d)
    jo, jl = jatt._flash_fwd_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, scale,
        blk_q=32, blk_k=16, interpret=True, with_lse=True)
    jl = np.asarray(jl)[:, :sq].reshape(2, 1, sq)
    to, tl = tatt.flash_attention(*_t(q, k, v), causal=causal, chunk=16,
                                  with_lse=True)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(tl.numpy(), jl, rtol=1e-6, atol=1e-5)
    empty = max(0, sq - sk) if causal else 0
    assert np.all(to.numpy()[:, :, :empty] == 0)
    assert np.all(tl.numpy()[:, :, :empty] == 1e30)
    assert np.all(tl.numpy()[:, :, empty:] < 1e3)


@pytest.mark.parametrize("sq,sk", [(70, 50), (50, 70)])
def test_bf16_matches_pallas_bf16_at_ragged_blocks(sq, sk):
    q, k, v = _qkv(1, 2, sq, sk, 24, seed=sq + 3 * sk)
    qb, kb, vb = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = tatt.flash_attention(qb, kb, vb, causal=True, chunk=16)
    assert got.dtype == torch.bfloat16
    jo = jatt._flash_fwd_pallas(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), True,
        1.0 / math.sqrt(24), blk_q=32, blk_k=16, interpret=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jo, np.float32), rtol=5e-2,
                               atol=5e-2)


@pytest.mark.parametrize("sq,sk,causal", CASES)
@pytest.mark.parametrize("chunk", [7, 512])
def test_plain_forward_matches_reference(sq, sk, causal, chunk):
    q, k, v = _qkv(2, 2, sq, sk, 8, seed=sq + sk)
    want = np.asarray(jatt.attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
    got = tatt._chunked_attention(*_t(q, k, v), causal, chunk=chunk)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    ref = tatt.attention_reference(*_t(q, k, v), causal=causal)
    np.testing.assert_allclose(ref.numpy(), want, rtol=0, atol=1e-5)


def test_fully_masked_rows_output_zero_and_lse_sentinel():
    # causal with sq > sk and ends aligned: the first sq - sk rows see no
    # key at all
    q, k, v = _qkv(1, 2, 40, 16, 16)
    o, lse = tatt.flash_attention(*_t(q, k, v), causal=True, with_lse=True)
    assert np.all(o.numpy()[:, :, :24] == 0)
    assert np.all(lse.numpy()[:, :, :24] == 1e30)
    assert np.all(np.abs(o.numpy()[:, :, 24:]).sum(-1) > 0)
    assert np.all(lse.numpy()[:, :, 24:] < 1e3)


@pytest.mark.parametrize("causal", [True, False])
def test_bf16_matches_f32_oracle_and_pallas_bf16(causal):
    q, k, v = _qkv(1, 2, 32, 48, 16, seed=7)
    oracle = np.asarray(jatt.attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
    qb, kb, vb = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = tatt.flash_attention(qb, kb, vb, causal=causal)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), oracle, rtol=5e-2,
                               atol=5e-2)
    jo = jatt._flash_fwd_pallas(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), causal,
        1.0 / 4.0, blk_q=16, blk_k=16, interpret=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jo, np.float32), rtol=5e-2,
                               atol=5e-2)


def test_mixed_dtypes_promote_once_and_return_query_dtype():
    q, k, v = _qkv(1, 1, 8, 8, 8)
    qb = torch.from_numpy(q).to(torch.bfloat16)
    out = tatt.flash_attention(qb, *_t(k, v), causal=True)
    assert out.dtype == torch.bfloat16
    want = tatt._chunked_attention(qb.float(), *_t(k, v), True)
    np.testing.assert_allclose(out.float().numpy(),
                               want.to(torch.bfloat16).float().numpy())


def test_count_readers_cover_every_wrapper():
    wrappers = (tatt.flash_fwd, tatt.flash_bwd_dkdv, tatt.flash_bwd_dq)
    assert tatt.launch_counts() == {w.__name__: w.launches
                                    for w in wrappers}
    assert tatt.capture_counts() == {w.__name__: w.captured
                                     for w in wrappers}
    q, k, v = _qkv(1, 2, 16, 16, 8)
    before = (tatt.launch_counts(), tatt.capture_counts())
    tatt.flash_attention(*_t(q, k, v), causal=True)
    assert (tatt.launch_counts(), tatt.capture_counts()) == before


def test_cpu_dispatch_runs_plain_version_and_launches_nothing():
    q, k, v = _qkv(1, 2, 16, 16, 8)
    before = tatt.flash_fwd.launches
    assert isinstance(before, int)
    out = tatt.flash_attention(*_t(q, k, v), causal=True)
    assert tatt.flash_fwd.launches == before
    np.testing.assert_array_equal(
        out.numpy(), tatt._chunked_attention(*_t(q, k, v), True).numpy())


def test_kernel_wrapper_refuses_cpu_tensors():
    q, k, v = _qkv(1, 1, 8, 8, 8)
    with pytest.raises(MXNetError, match="CUDA tensors"):
        tatt.flash_fwd(*_t(q, k, v))


def test_no_fallback_from_kernel_to_plain_version():
    """A CUDA tensor launches the kernel or raises: neither the
    dispatcher, the autograd Function nor a wrapper catches an
    exception."""
    for fn in (tatt.flash_attention, tatt.flash_fwd, tatt.flash_bwd,
               tatt.flash_bwd_dkdv, tatt.flash_bwd_dq, tatt._FlashAttention,
               tatt._check_qkv, tatt._check_rows):
        tree = ast.parse(inspect.getsource(fn))
        assert not any(isinstance(n, ast.Try) for n in ast.walk(tree)), fn


def test_kernel_head_dim_bound_is_the_sources_bound():
    """The wrappers refuse D past ``KERNEL_MAX_HEAD_DIM``, and each CUDA
    source's C entry past its ``kMaxHeadDim``: the three must agree."""
    import os
    import re
    csrc = os.path.join(os.path.dirname(os.path.dirname(tatt.__file__)),
                        "csrc")
    for name in ("flash_fwd.cu", "flash_bwd.cu"):
        with open(os.path.join(csrc, name)) as f:
            found = re.findall(r"constexpr int kMaxHeadDim = (\d+);", f.read())
        assert found == [str(tatt.KERNEL_MAX_HEAD_DIM)], name
    assert tatt.KERNEL_MAX_HEAD_DIM >= 2048


def test_registered_op_contract_matches_jax():
    name = "_contrib_DotProductAttention"
    jop, top = jreg.get_op(name), treg.get_op(name)
    assert top.input_names == jop.input_names == ("query", "key", "value")
    assert top.param_names == jop.param_names
    q, k, v = _qkv(2, 2, 12, 12, 8)
    want = np.asarray(jop.fn(*(jnp.asarray(a) for a in (q, k, v)),
                             causal=True))
    got = top.fn(*_t(q, k, v), causal=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
