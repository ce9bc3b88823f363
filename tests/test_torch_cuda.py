"""The port's CUDA kernels on the card: ``flash_fwd``, ``flash_bwd_dkdv``
and ``flash_bwd_dq`` against their plain versions, the wrappers'
refusals, and the launch counts of the serving and training paths.

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


def _bwd_inputs(cuda, b, h, sq, sk, d, dtype, causal, seed=1):
    from mxnet_tpu_torch.ops import attention as att
    q, k, v = _qkv(cuda, b, h, sq, sk, d, dtype, seed)
    g = torch.Generator(device=cuda)
    g.manual_seed(seed + 1)
    do = torch.randn(q.shape, generator=g, device=cuda).to(dtype)
    o, lse = att.flash_fwd(q, k, v, causal, with_lse=True)
    return q, k, v, do, lse, att._delta(o, do)


@pytest.mark.parametrize("sq,sk,d,causal,dtype", [
    (128, 128, 64, True, torch.float32),
    (300, 100, 64, True, torch.float32),
    (100, 300, 32, True, torch.float32),
    (1000, 1537, 64, False, torch.float32),
    (384, 384, 128, True, torch.bfloat16),
    (200, 200, 200, True, torch.float16),
    # lengths that are not multiples of dkdv's tiles
    (65, 127, 64, False, torch.float32),
    (127, 65, 64, True, torch.float32),
    (1, 300, 64, True, torch.float32),
    # causal, Sq > Sk: whole q-tiles see no key
    (400, 65, 64, True, torch.float32),
    # 16-bit head dims off the tile; 36 bf16 is a 72-byte row, which dkdv
    # stages with plain loads instead of 16-byte cp.async
    (100, 100, 16, True, torch.bfloat16),
    (200, 150, 96, False, torch.bfloat16),
    (130, 200, 36, True, torch.bfloat16)])
def test_bwd_kernels_match_plain_versions(cuda, sq, sk, d, causal, dtype):
    """Per element within the limits chip_smoke.py derives (f32:
    2**-12 times the sum of the absolute terms; 16-bit: one rounding
    flip per term plus 2 ulps), and bit-equal from launch to launch."""
    from chip_smoke import bwd_error, bwd_magnitudes
    from mxnet_tpu_torch.ops import attention as att
    q, k, v, do, lse, delta = _bwd_inputs(cuda, 2, 3, sq, sk, d, dtype,
                                          causal)
    scale = 1.0 / math.sqrt(d)
    dk, dv = att.flash_bwd_dkdv(q, k, v, do, lse, delta, causal)
    dq = att.flash_bwd_dq(q, k, v, do, lse, delta, causal)
    pdk, pdv = att._flash_bwd_dkdv_plain(q, k, v, do, lse, delta, causal)
    pdq = att._flash_bwd_dq_plain(q, k, v, do, lse, delta, causal)
    mags = bwd_magnitudes(torch, att, q, k, v, do, lse, delta, causal,
                          scale)
    dtn = str(dtype).split(".")[1]
    for got, want, mag in zip((dq, dk, dv), (pdq, pdk, pdv), mags):
        assert got.dtype == dtype
        assert bwd_error(torch, got, want, mag, dtn)[1] <= 1.0
    dk2, dv2 = att.flash_bwd_dkdv(q, k, v, do, lse, delta, causal)
    assert torch.equal(dk2, dk) and torch.equal(dv2, dv)
    assert torch.equal(att.flash_bwd_dq(q, k, v, do, lse, delta, causal), dq)
    if causal and sq > sk:
        assert not dq[:, :, :sq - sk].any()


def test_dkdv_takes_inputs_off_16_byte_alignment(cuda):
    """Contiguous views that start one element into their storage cannot
    take 16-byte cp.async; the kernel stages them with plain loads and
    gives the same bits as aligned copies of the same values."""
    from mxnet_tpu_torch.ops import attention as att
    q, k, v, do, lse, delta = _bwd_inputs(cuda, 1, 2, 130, 100, 64,
                                          torch.float32, True)

    def shifted(t):
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        flat[1:] = t.reshape(-1)
        return flat[1:].view(t.shape)
    ins = [shifted(t) for t in (q, k, v, do)]
    assert all(t.data_ptr() % 16 != 0 for t in ins)
    got = att.flash_bwd_dkdv(*ins, lse, delta, True)
    want = att.flash_bwd_dkdv(q, k, v, do, lse, delta, True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_function_backward_launches_both_kernels(cuda):
    from mxnet_tpu_torch.ops import attention as att
    q, k, v = (t.requires_grad_() for t in
               _qkv(cuda, 1, 2, 64, 64, 32, torch.float32))
    before = (att.flash_fwd.launches, att.flash_bwd_dkdv.launches,
              att.flash_bwd_dq.launches)
    att.flash_attention(q, k, v, causal=True).sum().backward()
    assert (att.flash_fwd.launches, att.flash_bwd_dkdv.launches,
            att.flash_bwd_dq.launches) == tuple(n + 1 for n in before)
    qc, kc, vc = (t.detach().cpu().requires_grad_() for t in (q, k, v))
    att.flash_attention(qc, kc, vc, causal=True).sum().backward()
    for t, c in ((q, qc), (k, kc), (v, vc)):
        np.testing.assert_allclose(t.grad.cpu().numpy(), c.grad.numpy(),
                                   rtol=0, atol=1e-4)


@pytest.mark.parametrize("fault", ["dout_dtype", "lse_dtype", "lse_shape",
                                   "delta_device", "dout_shape"])
def test_bwd_wrappers_refuse_what_the_kernels_do_not_take(cuda, fault):
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.ops import attention as att
    q, k, v, do, lse, delta = _bwd_inputs(cuda, 1, 2, 16, 16, 32,
                                          torch.float32, True)
    if fault == "dout_dtype":
        do = do.half()
    elif fault == "lse_dtype":
        lse = lse.double()
    elif fault == "lse_shape":
        lse = lse[:, :, :8].contiguous()
    elif fault == "delta_device":
        delta = delta.cpu()
    else:
        do = do[:, :, :8].contiguous()
    before = (att.flash_bwd_dkdv.launches, att.flash_bwd_dq.launches)
    for fn in (att.flash_bwd_dkdv, att.flash_bwd_dq):
        with pytest.raises(MXNetError):
            fn(q, k, v, do, lse, delta, True)
    assert (att.flash_bwd_dkdv.launches, att.flash_bwd_dq.launches) == \
        before


def test_trained_lm_goes_through_the_kernels(cuda):
    """One SGD step of a small LM on the card launches each kernel once
    per layer, and its loss and updated weights match the same step on
    the CPU (plain versions) within 1e-4 of each weight's scale."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.gluon.model_zoo.transformer import \
        get_transformer_lm
    from mxnet_tpu_torch.ops import attention as att
    rng = np.random.RandomState(0)
    x = rng.randint(0, 50, (3, 64)).astype("float32")
    y = rng.randint(0, 50, (3, 64)).astype("float32")
    weights, losses = [], []
    for ctx in (mx.gpu(0), mx.cpu()):
        net = get_transformer_lm(vocab=50, dim=64, heads=4, layers=3,
                                 max_seq=64, prefix="trainlm_")
        net.initialize(ctx=ctx)
        net(mx.nd.array(x, ctx=ctx))        # resolves deferred shapes
        if weights:
            for n, p in net.collect_params().items():
                p.set_data(weights[0][n])
        net.hybridize()
        trainer = gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.1, "momentum": 0.9})
        loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
        before = (att.flash_fwd.launches, att.flash_bwd_dkdv.launches,
                  att.flash_bwd_dq.launches)
        if not weights:
            weights.append({n: p.data().asnumpy()
                            for n, p in net.collect_params().items()})
        with autograd.record():
            loss = loss_fn(net(mx.nd.array(x, ctx=ctx)),
                           mx.nd.array(y, ctx=ctx))
        loss.backward()
        trainer.step(3)
        grew = (att.flash_fwd.launches - before[0],
                att.flash_bwd_dkdv.launches - before[1],
                att.flash_bwd_dq.launches - before[2])
        assert grew == ((3, 3, 3) if ctx == mx.gpu(0) else (0, 0, 0))
        losses.append(loss.asnumpy())
        weights.append({n: p.data().asnumpy()
                        for n, p in net.collect_params().items()})
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-5)
    for n, w in weights[1].items():
        np.testing.assert_allclose(w, weights[2][n], rtol=0,
                                   atol=1e-4 * max(1.0, np.abs(w).max()))
