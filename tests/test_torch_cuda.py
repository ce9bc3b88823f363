"""The port's CUDA kernel on the card: ``flash_fwd`` against its plain
version, the wrapper's refusals, and the serving path's launch count.

Every test here needs an NVIDIA GPU with nvcc and skips without one.
This file imports neither jax nor the JAX package, so it runs on a
machine that has only PyTorch (the repo's conftest imports jax, hence
``--noconftest``)::

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda -q
"""

import math

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(cuda, b, h, sq, sk, d, dtype, seed=0):
    g = torch.Generator(device=cuda)
    g.manual_seed(seed)
    return [torch.randn(s, generator=g, device=cuda).to(dtype)
            for s in ((b, h, sq, d), (b, h, sk, d), (b, h, sk, d))]


def _o_limit(want, q, k, v, causal):
    """Per-element limit on |kernel - plain|: 1e-4 for f32.  A 16-bit
    dtype rounds every p to v's dtype (relative error <= 2**-(bits+1) in
    each version), so the two o differ by at most 2**-bits times the
    attention of |v|, plus 2 ulps of the dtype at |plain| for rounding o."""
    from mxnet_tpu_torch.ops import attention as att
    if want.dtype == torch.float32:
        return torch.full(want.shape, 1e-4, device=want.device)
    bits = {torch.bfloat16: 7, torch.float16: 10}[want.dtype]
    mag = want.float().abs().clamp_min(2.0 ** -24)
    a = att._chunked_attention(q.float(), k.float(), v.float().abs(), causal)
    return 2 * torch.exp2(torch.floor(torch.log2(mag)) - bits) + \
        2.0 ** -bits * a


@pytest.mark.parametrize("sq,sk,d,causal,dtype", [
    (128, 128, 64, True, torch.float32),
    (300, 100, 64, True, torch.float32),
    (1000, 1537, 64, False, torch.float32),
    (384, 384, 128, True, torch.bfloat16),
    (200, 200, 200, True, torch.float16)])
def test_kernel_matches_plain_version(cuda, sq, sk, d, causal, dtype):
    from mxnet_tpu_torch.ops import attention as att
    q, k, v = _qkv(cuda, 2, 3, sq, sk, d, dtype)
    o, lse = att.flash_fwd(q, k, v, causal, with_lse=True)
    po, plse = att._chunked_attention(q, k, v, causal, with_lse=True)
    assert o.dtype == dtype
    assert bool(((o.float() - po.float()).abs()
                 <= _o_limit(po, q, k, v, causal)).all())
    assert (lse - plse).abs().max().item() <= 1e-4
    assert torch.equal(att.flash_fwd(q, k, v, causal), o)


def test_dispatch_launches_the_kernel(cuda):
    from mxnet_tpu_torch.ops import attention as att
    q, k, v = _qkv(cuda, 1, 2, 64, 64, 32, torch.float32)
    before = att.flash_fwd.launches
    att.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                        k, v, causal=True)
    assert att.flash_fwd.launches == before + 1


@pytest.mark.parametrize("fault", ["dtype", "head_dim", "strides",
                                   "shape", "device"])
def test_wrapper_refuses_what_the_kernel_does_not_take(cuda, fault):
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.ops import attention as att
    q, k, v = _qkv(cuda, 1, 2, 16, 16, 32, torch.float32)
    if fault == "dtype":
        q, k, v = q.double(), k.double(), v.double()
    elif fault == "head_dim":
        q, k, v = _qkv(cuda, 1, 1, 8, 8, 300, torch.float32)
    elif fault == "strides":
        q = q.transpose(1, 2)
    elif fault == "shape":
        v = v[:, :, :8]
    else:
        k = k.cpu()
    before = att.flash_fwd.launches
    with pytest.raises(MXNetError):
        att.flash_fwd(q, k, v)
    assert att.flash_fwd.launches == before


def test_served_lm_goes_through_the_kernel(cuda, tmp_path):
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo.transformer import \
        get_transformer_lm
    from mxnet_tpu_torch.ops import attention as att
    net = get_transformer_lm(vocab=50, dim=64, heads=4, layers=3,
                             max_seq=64, prefix="lm_")
    net.initialize(ctx=mx.gpu(0))
    net.hybridize()
    x = np.random.RandomState(0).randint(0, 50, (3, 64)).astype("float32")
    want = net(mx.nd.array(x, ctx=mx.gpu(0))).asnumpy()
    net.export(str(tmp_path / "lm"), 0)
    reg = mx.serve.ModelRegistry()
    reg.load_checkpoint("lm", str(tmp_path / "lm"), 0,
                        data_shapes={"data0": (1, 64)},
                        ladder=mx.serve.BucketLadder(batches=(1, 4)),
                        ctx=mx.gpu(0))
    before = att.flash_fwd.launches
    got = reg.predict("lm", x)[0].asnumpy()
    assert att.flash_fwd.launches == before + 3
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * max(1.0, np.abs(want).max()))
    assert math.isfinite(float(got.sum()))
