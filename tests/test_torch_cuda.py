"""The port's CUDA kernels on the card: ``flash_fwd``, ``flash_bwd_dkdv``
(its 16-bit tensor-core route at the tile edges too) and ``flash_bwd_dq``
against their plain versions, the wrappers'
refusals, and the launch counts of the serving and training paths; the
float32 ``Convolution`` on cuDNN held to float64 (no TF32); and serving's
CUDA graph per rung (replay against eager, outputs that never alias,
``set_params`` seen by the next replay, a capture failure that raises);
the reference's index rules on the card (an id past the embedding table
reads NaN, eagerly and under a graph, and serving goes on); and decode:
the paged engine's CUDA graphs per rung over a pool updated in place, a
pool rebuild under captured graphs, and the dense decoder's graph; the
data path: nvJPEG's decode and the route's geometry on the card, the
ImageRecordIter's batches on the card, and the prefetchers' copy stream
ordered before the consumer's reads; the int8 products: ``_int_mm`` with
the zero padding its limits need, the int8 convolution's columns, and a
quantized rung's CUDA graph counting its int8 products, each bit-equal to
the plain CPU version; the serving fleet: two replica processes on the
card answering bit-equal to an in-process registry, building no kernel
and capturing nothing in the request path, and a replica that refuses to
start without CUDA unless its spec says ``"ctx": "cpu"``.

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


@pytest.mark.parametrize("sq,sk,d,causal,dtype", [
    # lengths off the q-tile (128 at D <= 64, 64 at D 128, 32 at D 256) and
    # the k-tile (64, 32 at D 256)
    (129, 65, 64, False, torch.float32),
    (65, 129, 64, True, torch.float32),
    (1, 200, 64, True, torch.float32),
    # causal, Sq > Sk: whole q-tiles see no key, then a ragged diagonal
    (400, 70, 64, True, torch.float32),
    (333, 100, 32, True, torch.bfloat16),
    # head dims of each padded tile, and off them
    (150, 170, 32, True, torch.float16),
    (150, 170, 80, True, torch.float32),
    (150, 170, 128, False, torch.bfloat16),
    (97, 61, 128, True, torch.float16),
    (70, 90, 256, True, torch.float32),
    (70, 90, 256, False, torch.bfloat16),
    (90, 70, 200, True, torch.float16),
    # 36 bf16 is a 72-byte row: staged by plain loads, not cp.async
    (130, 100, 36, True, torch.bfloat16)])
def test_forward_at_the_tile_edges(cuda, sq, sk, d, causal, dtype):
    """The register-tiled forward at the edges of its tiles against its
    plain version (the limits of test_kernel_matches_plain_version); a
    relaunch, and the launch without lse, give the same bits."""
    from mxnet_tpu_torch.ops import attention as att
    q, k, v = _qkv(cuda, 2, 3, sq, sk, d, dtype, seed=sq + sk + d)
    o, lse = att.flash_fwd(q, k, v, causal, with_lse=True)
    po, plse = att._chunked_attention(q, k, v, causal, with_lse=True)
    assert o.dtype == dtype and bool(torch.isfinite(o).all())
    assert bool(((o.float() - po.float()).abs()
                 <= _o_limit(po, q, k, v, causal)).all())
    assert (lse - plse).abs().max().item() <= 1e-4
    if causal and sq > sk:
        assert not o[:, :, :sq - sk].any()
        assert bool((lse[:, :, :sq - sk] == 1e30).all())
    o2, lse2 = att.flash_fwd(q, k, v, causal, with_lse=True)
    assert torch.equal(o2, o) and torch.equal(lse2, lse)
    assert torch.equal(att.flash_fwd(q, k, v, causal), o)


@pytest.mark.parametrize("b,h,sq,sk,d,causal,dtype", [
    (2, 4, 512, 512, 64, True, torch.bfloat16),
    (1, 3, 300, 777, 128, False, torch.float16)])
def test_tensor_core_route_matches_plain_version(cuda, b, h, sq, sk, d,
                                                 causal, dtype):
    """The 16-bit tensor-core kernel (route "wgmma") against the plain
    version at the limits above; relaunches, and the launch without lse,
    give the same bits; the launch counts on its route."""
    from mxnet_tpu_torch.ops import attention as att
    q, k, v = _qkv(cuda, b, h, sq, sk, d, dtype, seed=d)
    assert att._fwd_route(dtype, d, att._aligned16(q, k, v)) == "wgmma"
    before = dict(att.flash_fwd.launches_by_route)
    o, lse = att.flash_fwd(q, k, v, causal, with_lse=True)
    assert att.flash_fwd.launches_by_route == dict(
        before, wgmma=before["wgmma"] + 1)
    po, plse = att._chunked_attention(q, k, v, causal, with_lse=True)
    assert bool(((o.float() - po.float()).abs()
                 <= _o_limit(po, q, k, v, causal)).all())
    assert (lse - plse).abs().max().item() <= 1e-4
    o2, lse2 = att.flash_fwd(q, k, v, causal, with_lse=True)
    assert torch.equal(o2, o) and torch.equal(lse2, lse)
    assert torch.equal(att.flash_fwd(q, k, v, causal), o)


def test_unaligned_16bit_base_takes_the_simt_route(cuda):
    """A contiguous bf16 q whose base is 2 bytes off 16 runs the
    register-tiled kernel, within the same limits."""
    from mxnet_tpu_torch.ops import attention as att
    q, k, v = _qkv(cuda, 1, 2, 200, 200, 64, torch.bfloat16)
    buf = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda)
    qs = buf[1:].view(q.shape)
    qs.copy_(q)
    assert qs.is_contiguous() and qs.data_ptr() % 16 != 0
    before = dict(att.flash_fwd.launches_by_route)
    o = att.flash_fwd(qs, k, v, True)
    assert att.flash_fwd.launches_by_route == dict(
        before, simt=before["simt"] + 1)
    po = att._chunked_attention(q, k, v, True)
    assert bool(((o.float() - po.float()).abs()
                 <= _o_limit(po, q, k, v, True)).all())


def test_all_three_kernels_past_65535_batch_heads(cuda):
    """B*H = 65600 goes on grid.x: one launch of each kernel against its
    plain version, through flash_attention's forward and backward too."""
    from chip_smoke import bwd_error, bwd_magnitudes
    from mxnet_tpu_torch.ops import attention as att
    q, k, v, do, lse, delta = _bwd_inputs(cuda, 2, 32800, 16, 16, 32,
                                          torch.float32, True)
    o, _ = att.flash_fwd(q, k, v, True, with_lse=True)
    po, plse = att._chunked_attention(q, k, v, True, with_lse=True)
    assert (o - po).abs().max().item() <= 1e-4
    assert (lse - plse).abs().max().item() <= 1e-4
    dk, dv = att.flash_bwd_dkdv(q, k, v, do, lse, delta, True)
    dq = att.flash_bwd_dq(q, k, v, do, lse, delta, True)
    pdk, pdv = att._flash_bwd_dkdv_plain(q, k, v, do, lse, delta, True)
    pdq = att._flash_bwd_dq_plain(q, k, v, do, lse, delta, True)
    mags = bwd_magnitudes(torch, att, q, k, v, do, lse, delta, True,
                          1.0 / math.sqrt(32))
    for got, want, mag in zip((dq, dk, dv), (pdq, pdk, pdv), mags):
        assert bwd_error(torch, got, want, mag, "float32")[1] <= 1.0
    before = (att.flash_fwd.launches, att.flash_bwd_dkdv.launches,
              att.flash_bwd_dq.launches)
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    att.flash_attention(qg, kg, vg, causal=True).backward(do)
    assert (att.flash_fwd.launches, att.flash_bwd_dkdv.launches,
            att.flash_bwd_dq.launches) == tuple(n + 1 for n in before)
    assert torch.equal(qg.grad, dq) and torch.equal(kg.grad, dk) and \
        torch.equal(vg.grad, dv)


def test_dispatch_launches_the_kernel(cuda):
    from mxnet_tpu_torch.ops import attention as att
    q, k, v = _qkv(cuda, 1, 2, 64, 64, 32, torch.float32)
    before = att.flash_fwd.launches
    att.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                        k, v, causal=True)
    assert att.flash_fwd.launches == before + 1


def test_a_captured_call_records_and_does_not_launch(cuda):
    """Under CUDA graph capture the wrapper records its kernel into the
    graph: ``captured`` grows, ``launches`` does not, and a replay runs
    the kernel without calling the wrapper."""
    from mxnet_tpu_torch.ops import attention as att
    q, k, v = _qkv(cuda, 1, 2, 128, 128, 64, torch.float32)
    want = att.flash_fwd(q, k, v, causal=True)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        att.flash_fwd(q, k, v, causal=True)     # warm-up off the capture
    torch.cuda.current_stream().wait_stream(side)
    before = (att.launch_counts(), att.capture_counts())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = att.flash_fwd(q, k, v, causal=True)
    launches, captured = att.launch_counts(), att.capture_counts()
    assert launches == before[0]
    assert captured["flash_fwd"] == before[1]["flash_fwd"] + 1
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert att.launch_counts() == launches
    assert att.capture_counts() == captured
    assert torch.equal(out, want)


@pytest.mark.parametrize("fault", ["dtype", "head_dim", "strides",
                                   "shape", "device"])
def test_wrapper_refuses_what_the_kernel_does_not_take(cuda, fault):
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.ops import attention as att
    q, k, v = _qkv(cuda, 1, 2, 16, 16, 32, torch.float32)
    if fault == "dtype":
        q, k, v = q.double(), k.double(), v.double()
    elif fault == "head_dim":
        # just past the kernels' bound, which the error names
        q, k, v = _qkv(cuda, 1, 1, 8, 8, att.KERNEL_MAX_HEAD_DIM + 1,
                       torch.float32)
    elif fault == "strides":
        q = q.transpose(1, 2)
    elif fault == "shape":
        v = v[:, :, :8]
    else:
        k = k.cpu()
    before = att.flash_fwd.launches
    with pytest.raises(MXNetError) as err:
        att.flash_fwd(q, k, v)
    assert att.flash_fwd.launches == before
    if fault == "head_dim":
        assert str(att.KERNEL_MAX_HEAD_DIM) in str(err.value)


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
    loaded = (att.flash_fwd.launches, att.flash_fwd.captured)
    reg.load_checkpoint("lm", str(tmp_path / "lm"), 0,
                        data_shapes={"data0": (1, 64)},
                        ladder=mx.serve.BucketLadder(batches=(1, 4)),
                        ctx=mx.gpu(0))
    # 2 rungs: a warm-up run of 3 launches each, a capture of 3 records
    assert (att.flash_fwd.launches - loaded[0],
            att.flash_fwd.captured - loaded[1]) == (6, 6)
    pred = reg.get("lm")
    # each rung is a CUDA graph: the wrapper recorded its 3 launches at
    # capture (counted apart from launches), a request replays them
    # without calling it
    assert pred.captured_launches(pred.rung_shapes(4)) == {"flash_fwd": 3}
    before = att.flash_fwd.launches
    graph = pred.graph_launches()["flash_fwd"]
    got = reg.predict("lm", x)[0].asnumpy()
    assert att.flash_fwd.launches == before
    assert pred.graph_launches()["flash_fwd"] == graph + 3
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * max(1.0, np.abs(want).max()))
    assert math.isfinite(float(got.sum()))


# serving: one CUDA graph per bucket rung
TOL_SERVE = 1e-3        # x max(1, max|logit|), chip_smoke.py's limit


def _served_lm(tmp_path, ladder=(1, 4)):
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo.transformer import \
        get_transformer_lm
    net = get_transformer_lm(vocab=50, dim=64, heads=4, layers=3,
                             max_seq=64, prefix="glm_")
    net.initialize(ctx=mx.gpu(0))
    net.hybridize()
    net(mx.nd.array(np.zeros((1, 64), "float32"), ctx=mx.gpu(0)))
    net.export(str(tmp_path / "glm"), 0)
    reg = mx.serve.ModelRegistry()
    pred = reg.load_checkpoint(
        "lm", str(tmp_path / "glm"), 0, data_shapes={"data0": (1, 64)},
        ladder=mx.serve.BucketLadder(batches=ladder), ctx=mx.gpu(0))
    return reg, pred


def _tokens(rows, seed, seq=64):
    return np.random.RandomState(seed).randint(0, 50, (rows, seq)) \
        .astype("float32")


def test_graph_replay_of_a_rung_matches_eager(cuda, tmp_path):
    reg, pred = _served_lm(tmp_path)
    assert pred.compile_count == 2
    x = _tokens(3, 0)
    got = pred.predict(x)[0]._data
    pad = torch.zeros((4, 64), device=cuda)
    pad[:3] = torch.from_numpy(x).to(cuda)
    want = pred._run({"data0": pad})[0][:3]
    scale = max(1.0, want.abs().max().item())
    err = (got - want).abs().max().item()
    print("replay vs eager: max abs err %.3g, bit-equal %s"
          % (err, torch.equal(got, want)))
    assert err <= TOL_SERVE * scale
    assert pred.compile_count == 2


def test_consecutive_predicts_do_not_alias(cuda, tmp_path):
    reg, pred = _served_lm(tmp_path)
    a = pred.predict(_tokens(4, 1))[0]._data
    kept = a.clone()
    b = pred.predict(_tokens(4, 2))[0]._data
    assert a.data_ptr() != b.data_ptr()
    assert torch.equal(a, kept)         # the second replay left a alone
    assert not torch.equal(a, b)


def test_predicts_from_two_streams_do_not_overlap(cuda, tmp_path):
    """Two threads predicting on two streams of their own: the
    predictor replays on its own stream, so neither replay overwrites
    the static outputs before the other's clone read them, and each
    answer is bit-equal to a predict of the same input alone."""
    import threading
    reg, pred = _served_lm(tmp_path)
    xs = [_tokens(4, 20 + i) for i in range(2)]
    want = [pred.predict(x)[0]._data.clone() for x in xs]
    got, errors = [[None] * 8 for _ in xs], []

    def client(i):
        try:
            s = torch.cuda.Stream()
            with torch.cuda.stream(s):
                for r in range(8):
                    out = pred.predict(xs[i])[0]._data
                    # work queued after the answer on the caller's
                    # stream sees the finished clone
                    got[i][r] = out * 1.0
                s.synchronize()
        except Exception as e:          # re-raised below
            errors.append(e)

    workers = [threading.Thread(target=client, args=(i,)) for i in (0, 1)]
    for w in workers:
        w.start()
    for w in workers:
        w.join(120)
    assert not errors and not any(w.is_alive() for w in workers)
    for i in (0, 1):
        for out in got[i]:
            assert torch.equal(out, want[i])


def test_set_params_is_seen_by_the_next_replay(cuda, tmp_path):
    reg, pred = _served_lm(tmp_path)
    x = _tokens(4, 3)
    before = pred.predict(x)[0]._data
    name = next(n for n in pred._params if n.endswith("dense0_weight"))
    new = {name: pred._params[name] * 2.0}
    pred.set_params(new)
    after = pred.predict(x)[0]._data
    want = pred._run({"data0": torch.from_numpy(x).to(cuda)})[0]
    assert pred.compile_count == 2
    assert not torch.equal(before, after)
    assert (after - want).abs().max().item() <= \
        TOL_SERVE * max(1.0, want.abs().max().item())


def test_capture_failure_raises_and_never_runs_eager(cuda, tmp_path):
    import mxnet_tpu_torch as mx
    reg, good = _served_lm(tmp_path)
    pred = mx.serve.CompiledPredictor(
        good._symbol, good._params, data_shapes={"data0": (1, 64)},
        ladder=mx.serve.BucketLadder(batches=(2,)), ctx=mx.gpu(0))
    real, calls = pred._eval, []

    def syncing(amap, aux, generator=None):
        outs, upd = real(amap, aux)
        calls.append(float(outs[0].sum()))  # a host read: no capture
        return outs, upd

    pred._eval = syncing
    with pytest.raises(mx.serve.ServeError, match="capture"):
        pred.warm()
    assert pred.compile_count == 0 and pred.program_keys() == []
    assert len(calls) == 1                  # the warm-up before capture
    with pytest.raises(mx.serve.ServeError, match="capture"):
        pred.predict(_tokens(2, 4))
    assert pred.dispatch_count == 0
    # the process serves on: the registry's model still replays
    assert good.predict(_tokens(2, 5))[0].shape == (2, 64, 50)
    # through the registry: the load fails typed and registers nothing
    from unittest import mock
    with mock.patch.object(mx.serve.predictor, "_build_eval",
                           lambda sym, training, **kw: syncing):
        with pytest.raises(mx.serve.ServeError, match="capture"):
            reg.load("bad", good._symbol, good._params,
                     data_shapes={"data0": (1, 64)}, ctx=mx.gpu(0),
                     ladder=mx.serve.BucketLadder(batches=(1,)))
    assert reg.names() == ["lm"] and "bad" not in reg.health()


def test_submit_on_the_card_replays_the_rung(cuda, tmp_path):
    reg, pred = _served_lm(tmp_path)
    b = reg.batcher("lm", max_wait_ms=60000)
    xs = [_tokens(1, 6), _tokens(2, 7)]
    futs = [reg.submit("lm", x) for x in xs]
    assert b.flush(timeout=60)
    got = np.concatenate([f.result(1)[0] for f in futs])
    want = pred.predict(np.concatenate(xs))[0].asnumpy()
    assert b.batch_count == 1
    assert np.array_equal(got, want)
    assert pred.compile_count == 2


def test_embedding_ids_past_the_table_on_the_card(cuda):
    """ids [0, 3, 32000, -1] of a 32000-row table read rows 0, 3, NaN and
    31999, eagerly and replayed from a CUDA graph; nothing asserts on
    the device, so the next op still runs."""
    from mxnet_tpu_torch.ops.tensor import _embedding
    g = torch.Generator(device=cuda)
    g.manual_seed(0)
    w = torch.randn((32000, 16), generator=g, device=cuda)
    ids = torch.tensor([0, 3, 32000, -1], dtype=torch.float32, device=cuda)
    eager = _embedding(ids, w)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        _embedding(ids, w)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = _embedding(ids, w)
    graph.replay()
    for got in (eager, out):
        assert torch.equal(got[0], w[0]) and torch.equal(got[1], w[3])
        assert bool(torch.isnan(got[2]).all())
        assert torch.equal(got[3], w[31999])
    torch.cuda.synchronize()           # a device assert would raise here
    assert bool(torch.isfinite(w.sum()))


def test_served_bad_ids_get_nan_rows_and_serving_goes_on(cuda, tmp_path):
    """A request holding ids [0, 3, 50, -1] (vocab 50) is answered as the
    reference answers it: the id past the table embeds as a NaN row, and
    attention's P.V multiplies its NaN value by the zero weights of the
    rows before it too, so every logit is NaN (the JAX package's forward
    of the same ids on the CPU is NaN at every position).  Graph replay
    and eager agree, nothing asserts on the device, and the next request
    is still served, matching eager."""
    reg, pred = _served_lm(tmp_path)
    x = _tokens(1, 3)
    x[0, :4] = [0, 3, 50, -1]
    got = pred.predict(x)[0]._data
    want = pred._run({"data0": torch.from_numpy(x).to(cuda)})[0]
    assert bool(torch.isnan(got).all()) and bool(torch.isnan(want).all())
    y = _tokens(4, 4)
    got = pred.predict(y)[0]._data
    want = pred._run({"data0": torch.from_numpy(y).to(cuda)})[0]
    assert bool(torch.isfinite(got).all())
    scale = max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= TOL_SERVE * scale


# decode on the card
def _tiny_engine(cuda, **kwargs):
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.test_utils import tiny_attention_lm
    params, step_fn, prefill_fn, token_spec, input_spec = \
        tiny_attention_lm(vocab=32, dim=16, seed=0, ctx=mx.gpu(0))
    kwargs.setdefault("max_len", 24)
    kwargs.setdefault("block_size", 4)
    kwargs.setdefault("num_blocks", 40)
    kwargs.setdefault("session_rungs", (1, 2, 4))
    eng = mx.serve.DecodeEngine(step_fn, prefill_fn, token_spec, input_spec,
                                params=params, **kwargs)
    return eng, params, step_fn


def test_paged_decode_graphs_on_the_card(cuda):
    """One CUDA graph per tick rung and per prefill rung, built at
    construction; 4 staggered sessions through them give the dense
    decode's streams, with no build under traffic and the pool's own
    tensors written in place."""
    from mxnet_tpu_torch.test_utils import dense_decode_reference
    eng, params, step_fn = _tiny_engine(cuda)
    assert eng.compile_count == 3 + len(eng.prefill_rungs)
    ptrs = {k: a.data_ptr() for k, a in eng.pool.arrays.items()}
    rs = np.random.RandomState(0)
    prompts = [rs.randint(0, 32, n).astype(np.int32) for n in (1, 3, 7, 12)]
    n_new = [9, 4, 6, 2]
    sess = [eng.admit({"tok": p}, max_new_tokens=n)
            for p, n in zip(prompts, n_new)]
    for s in sess:
        eng.prefill(s)
    while any(not s.done() for s in sess):
        eng.tick([s for s in sess if not s.done()])
    for s, p, n in zip(sess, prompts, n_new):
        assert [int(o) for o in s.result(10)] == dense_decode_reference(
            params, step_fn, p, n, eng.padded_len, 16)
    assert eng.compile_count == 3 + len(eng.prefill_rungs)
    assert {k: a.data_ptr() for k, a in eng.pool.arrays.items()} == ptrs
    assert eng.pool.blocks_in_use == 0
    eng.close()


def test_pool_rebuild_under_captured_graphs(cuda):
    """A tick crash quarantines the pool; the fresh pool takes over its
    tensors zeroed in place, so the captured graphs run it with no new
    build and the resumed stream is the dense decode's."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.resilience import chaos
    from mxnet_tpu_torch.test_utils import dense_decode_reference
    eng, params, step_fn = _tiny_engine(cuda, session_rungs=(1,),
                                        prefill_rungs=(4,))
    built = eng.compile_count
    ptrs = {k: a.data_ptr() for k, a in eng.pool.arrays.items()}
    bat = mx.serve.DecodeBatcher(eng, max_wait_ms=1.0, rebuilds=1)
    p = np.asarray([3, 1, 4], np.int32)
    chaos.configure(decode_tick_raise_at=2)
    try:
        got = [int(o) for o in bat.start({"tok": p}, max_new_tokens=6)
               .result(60)]
    finally:
        chaos.reset()
    assert got == dense_decode_reference(params, step_fn, p, 6,
                                         eng.padded_len, 16)
    assert bat.rebuild_count == 1 and eng.compile_count == built
    assert {k: a.data_ptr() for k, a in eng.pool.arrays.items()} == ptrs
    bat.close()
    eng.close()


def test_speculative_verify_graph_on_the_card(cuda):
    """The K-step verify program (the steps unrolled in one CUDA graph)
    with a perfect draft gives the dense decode's stream from fewer
    target dispatches than tokens."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.test_utils import dense_decode_reference
    target, params, step_fn = _tiny_engine(cuda, session_rungs=(1,),
                                           spec_k=4, prefill_rungs=(4,))
    draft, _, _ = _tiny_engine(cuda, session_rungs=(1,), prefill_rungs=(4,))
    assert target.compile_count == 1 + len(target.prefill_rungs) + 1
    spec = mx.serve.SpeculativeDecoder(target, draft)
    p = np.asarray([1, 2, 3], np.int32)
    sess = spec.run({"tok": p}, max_new_tokens=12)
    assert [int(o) for o in sess.outputs()] == dense_decode_reference(
        params, step_fn, p, 12, target.padded_len, 16)
    assert spec.stats["accepted"] == spec.stats["proposed"]
    assert spec.stats["target_dispatches"] < 12
    target.close()
    draft.close()


def test_dense_decoder_graph_on_the_card(cuda, tmp_path):
    """make_decoder captures one CUDA graph; each step replays it over
    the session's cache, written in place, and a device-resident input
    skips the host."""
    reg, pred = _served_lm(tmp_path)
    built = pred.compile_count

    def step(p, cache, inputs, t):
        new = cache["kv"].index_copy(1, t.long().reshape(1),
                                     inputs["tok"][:, None])
        return new.sum(dim=1), {"kv": new}
    sess = pred.make_decoder(step, {"kv": np.zeros((2, 6), np.float32)},
                             {"tok": (2,)})
    assert pred.compile_count == built + 1
    cache = sess.cache["kv"]
    out = sess.step({"tok": np.ones((2,), np.float32)})
    out = sess.step({"tok": out})
    assert out.is_cuda and out.tolist() == [2.0, 2.0]
    assert sess.cache["kv"] is cache
    assert cache.tolist() == [[1.0, 1.0, 0, 0, 0, 0]] * 2


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
    (130, 200, 36, True, torch.bfloat16),
    # dq's plain-load staging with rows that see no key (Sq > Sk)
    (130, 100, 36, True, torch.bfloat16),
    (300, 100, 36, True, torch.bfloat16)])
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
        assert dq[:, :, sq - sk:].abs().sum().item() > 0


def _bwd_ratios(q, k, v, do, lse, delta, causal, grads):
    """Worst error/limit of (dq, dk, dv) against the plain versions, with
    chip_smoke.py's limits."""
    from chip_smoke import bwd_error, bwd_magnitudes
    from mxnet_tpu_torch.ops import attention as att
    pdk, pdv = att._flash_bwd_dkdv_plain(q, k, v, do, lse, delta, causal)
    pdq = att._flash_bwd_dq_plain(q, k, v, do, lse, delta, causal)
    mags = bwd_magnitudes(torch, att, q, k, v, do, lse, delta, causal,
                          1.0 / math.sqrt(q.shape[-1]))
    dtn = str(q.dtype).split(".")[1]
    return [bwd_error(torch, g, w, m, dtn)[1]
            for g, w, m in zip(grads, (pdq, pdk, pdv), mags)]


@pytest.mark.parametrize("sq,sk,d,causal,dtype", [
    (200, 300, 300, True, torch.float32),
    (300, 200, 300, True, torch.bfloat16),    # causal Sq > Sk: empty rows
    (256, 256, 1024, False, torch.float32),
    (70, 90, 520, True, torch.float16),
    (64, 80, 2048, True, torch.float32)])     # the kernels' bound
def test_wide_head_kernels_match_plain_versions(cuda, sq, sk, d, causal,
                                               dtype):
    """Head dims past 256 run the wide kernels (one warp a row): all three
    against their plain versions within chip_smoke.py's limits, and
    bit-equal from launch to launch."""
    from mxnet_tpu_torch.ops import attention as att
    assert d <= att.KERNEL_MAX_HEAD_DIM
    q, k, v, do, lse, delta = _bwd_inputs(cuda, 1, 2, sq, sk, d, dtype,
                                          causal)
    o, lse2 = att.flash_fwd(q, k, v, causal, with_lse=True)
    po, plse = att._chunked_attention(q, k, v, causal, with_lse=True)
    assert bool(((o.float() - po.float()).abs()
                 <= _o_limit(po, q, k, v, causal)).all())
    assert (lse2 - plse).abs().max().item() <= 1e-4
    assert torch.equal(att.flash_fwd(q, k, v, causal), o)
    dk, dv = att.flash_bwd_dkdv(q, k, v, do, lse, delta, causal)
    dq = att.flash_bwd_dq(q, k, v, do, lse, delta, causal)
    assert max(_bwd_ratios(q, k, v, do, lse, delta, causal,
                           (dq, dk, dv))) <= 1.0
    dk2, dv2 = att.flash_bwd_dkdv(q, k, v, do, lse, delta, causal)
    assert torch.equal(dk2, dk) and torch.equal(dv2, dv)
    assert torch.equal(att.flash_bwd_dq(q, k, v, do, lse, delta, causal), dq)
    if causal and sq > sk:
        assert not o[:, :, :sq - sk].any() and not dq[:, :, :sq - sk].any()


@pytest.mark.parametrize("d,causal", [(300, True), (1024, False)])
def test_wide_head_attention_runs_the_kernels(cuda, d, causal):
    """flash_attention forward and backward at D > 256 launch each kernel
    once and give the plain versions' gradients within their limits."""
    from mxnet_tpu_torch.ops import attention as att
    q, k, v, do, _, _ = _bwd_inputs(cuda, 1, 2, 96, 128, d, torch.float32,
                                    causal)
    before = (att.flash_fwd.launches, att.flash_bwd_dkdv.launches,
              att.flash_bwd_dq.launches)
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    out = att.flash_attention(qg, kg, vg, causal=causal)
    out.backward(do)
    assert (att.flash_fwd.launches, att.flash_bwd_dkdv.launches,
            att.flash_bwd_dq.launches) == tuple(n + 1 for n in before)
    po, plse = att._chunked_attention(q, k, v, causal, with_lse=True)
    assert (out.detach() - po).abs().max().item() <= 1e-4
    assert max(_bwd_ratios(q, k, v, do, plse, att._delta(po, do), causal,
                           (qg.grad, kg.grad, vg.grad))) <= 1.0


def test_every_wrapper_refuses_a_head_dim_past_the_bound(cuda):
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.ops import attention as att
    d = att.KERNEL_MAX_HEAD_DIM + 1
    q, k, v = _qkv(cuda, 1, 1, 4, 4, d, torch.float32)
    lse = torch.zeros(1, 1, 4, device=cuda)
    counts = (att.flash_fwd.launches, att.flash_bwd_dkdv.launches,
              att.flash_bwd_dq.launches)
    for call in (lambda: att.flash_fwd(q, k, v),
                 lambda: att.flash_bwd_dkdv(q, k, v, q, lse, lse),
                 lambda: att.flash_bwd_dq(q, k, v, q, lse, lse),
                 lambda: att.flash_attention(q, k, v)):
        with pytest.raises(MXNetError, match=str(att.KERNEL_MAX_HEAD_DIM)):
            call()
    assert (att.flash_fwd.launches, att.flash_bwd_dkdv.launches,
            att.flash_bwd_dq.launches) == counts


def test_dq_takes_inputs_off_16_byte_alignment(cuda):
    """As dkdv: views one element into their storage are staged with
    plain loads and give the bits of aligned copies of the same values."""
    from mxnet_tpu_torch.ops import attention as att
    q, k, v, do, lse, delta = _bwd_inputs(cuda, 1, 2, 130, 100, 64,
                                          torch.float32, True)

    def shifted(t):
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        flat[1:] = t.reshape(-1)
        return flat[1:].view(t.shape)
    ins = [shifted(t) for t in (q, k, v, do)]
    assert all(t.data_ptr() % 16 != 0 for t in ins)
    assert torch.equal(att.flash_bwd_dq(*ins, lse, delta, True),
                       att.flash_bwd_dq(q, k, v, do, lse, delta, True))


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


@pytest.mark.parametrize("sq,sk,d,causal,dtype", [
    (256, 256, 64, True, torch.bfloat16),
    (256, 256, 64, False, torch.float16),
    # lengths off the k-tile (128 keys, 64 a warpgroup) and the q-tile (64
    # at D <= 64, 32 at D 128); Sq % 4 != 0, so the lse and delta rows end
    # off 16 bytes
    (129, 65, 64, False, torch.bfloat16),
    (65, 129, 64, True, torch.float16),
    (1, 300, 64, True, torch.bfloat16),
    (1537, 1000, 64, True, torch.bfloat16),
    (1000, 1537, 64, False, torch.float16),
    # causal, Sq > Sk: rows that see no key (lse +1e30)
    (300, 100, 64, True, torch.bfloat16),
    (333, 70, 128, True, torch.float16),
    # head dims of each padded tile, and off them (zeros past D)
    (150, 170, 32, True, torch.float16),
    (150, 170, 16, False, torch.bfloat16),
    (200, 190, 80, True, torch.bfloat16),
    (130, 200, 96, False, torch.float16),
    (97, 61, 128, True, torch.bfloat16),
    (300, 300, 128, False, torch.bfloat16)])
def test_dkdv_tensor_core_route_matches_plain_version(cuda, sq, sk, d,
                                                      causal, dtype):
    """The 16-bit tensor-core dK/dV kernel (route "wgmma") at the edges of
    its tiles against ``_flash_bwd_dkdv_plain`` within chip_smoke.py's
    16-bit limit; the launch counts on its route, and a relaunch gives
    the same bits."""
    from chip_smoke import bwd_error, bwd_magnitudes
    from mxnet_tpu_torch.ops import attention as att
    q, k, v, do, lse, delta = _bwd_inputs(cuda, 2, 3, sq, sk, d, dtype,
                                          causal, seed=sq + sk + d)
    assert att._dkdv_route(dtype, d, att._aligned16(q, k, v, do)) == "wgmma"
    before = dict(att.flash_bwd_dkdv.launches_by_route)
    dk, dv = att.flash_bwd_dkdv(q, k, v, do, lse, delta, causal)
    assert att.flash_bwd_dkdv.launches_by_route == dict(
        before, wgmma=before["wgmma"] + 1)
    pdk, pdv = att._flash_bwd_dkdv_plain(q, k, v, do, lse, delta, causal)
    _, m_dk, m_dv = bwd_magnitudes(torch, att, q, k, v, do, lse, delta,
                                   causal, 1.0 / math.sqrt(d))
    dtn = str(dtype).split(".")[1]
    for got, want, mag in ((dk, pdk, m_dk), (dv, pdv, m_dv)):
        assert got.dtype == dtype and bool(torch.isfinite(got).all())
        assert bwd_error(torch, got, want, mag, dtn)[1] <= 1.0
    dk2, dv2 = att.flash_bwd_dkdv(q, k, v, do, lse, delta, causal)
    assert torch.equal(dk2, dk) and torch.equal(dv2, dv)


def test_dkdv_dout_off_16_bytes_takes_the_simt_route(cuda):
    """A bf16 dout whose base alone is 2 bytes off 16 sends dK/dV to the
    register-tiled kernel (the forward of the same q, k, v stays on the
    tensor cores), within the same limit against the plain version."""
    from chip_smoke import bwd_error, bwd_magnitudes, off16
    from mxnet_tpu_torch.ops import attention as att
    q, k, v, do, lse, delta = _bwd_inputs(cuda, 1, 2, 200, 200, 64,
                                          torch.bfloat16, True)
    dos = off16(torch, do)
    assert dos.is_contiguous() and dos.data_ptr() % 16 != 0
    assert att._fwd_route(q.dtype, 64, att._aligned16(q, k, v)) == "wgmma"
    before = dict(att.flash_bwd_dkdv.launches_by_route)
    dk, dv = att.flash_bwd_dkdv(q, k, v, dos, lse, delta, True)
    assert att.flash_bwd_dkdv.launches_by_route == dict(
        before, simt=before["simt"] + 1)
    pdk, pdv = att._flash_bwd_dkdv_plain(q, k, v, do, lse, delta, True)
    _, m_dk, m_dv = bwd_magnitudes(torch, att, q, k, v, do, lse, delta,
                                   True, 1.0 / 8)
    for got, want, mag in ((dk, pdk, m_dk), (dv, pdv, m_dv)):
        assert bwd_error(torch, got, want, mag, "bfloat16")[1] <= 1.0


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


@pytest.mark.parametrize("shape,w,stride,pad", [
    ((8, 3, 224, 224), (64, 3, 7, 7), 2, 3),      # ResNet's stem
    ((8, 64, 56, 56), (64, 64, 3, 3), 1, 1),
    ((8, 256, 56, 56), (128, 256, 1, 1), 2, 0)])
def test_f32_convolution_runs_full_f32_forward_and_backward(
        cuda, monkeypatch, shape, w, stride, pad):
    """A float32 Convolution on the card, its output and its data and
    weight gradients, against the same in float64: within 1e-4 of each
    array's max |value| (f32 rounding), with cuDNN's process default at
    TF32; the same call with TF32 convolutions must miss that limit
    (TF32 rounds the products' inputs to 10 bits)."""
    from mxnet_tpu_torch.ops import nn as nn_ops
    from mxnet_tpu_torch.ops import registry
    conv = registry.get_op("Convolution").fn
    g = torch.Generator(device=cuda)
    g.manual_seed(0)
    x = torch.randn(shape, generator=g, device=cuda)
    wt = torch.randn(w, generator=g, device=cuda) / math.sqrt(
        w[1] * w[2] * w[3])
    dout = None

    def run(dtype):
        nonlocal dout
        xs = x.to(dtype).requires_grad_()
        ws = wt.to(dtype).requires_grad_()
        out = conv(xs, ws, kernel=w[2:], stride=(stride,) * 2,
                   pad=(pad,) * 2, num_filter=w[0], no_bias=True)
        if dout is None:
            dout = torch.randn(out.shape, generator=g, device=cuda)
        out.backward(dout.to(dtype))
        return [t.detach().double() for t in (out, xs.grad, ws.grad)]

    monkeypatch.setattr(torch.backends.cudnn.conv, "fp32_precision", "tf32")
    want = run(torch.float64)

    def worst(got):
        return max(((a - b).abs().max() / b.abs().max()).item()
                   for a, b in zip(got, want))
    f32 = worst(run(torch.float32))
    monkeypatch.setattr(nn_ops, "conv_precision",
                        lambda dt: "tf32" if dt == torch.float32 else None)
    tf32 = worst(run(torch.float32))
    assert f32 <= 1e-4 < tf32, (f32, tf32)


def test_mp_lars_step_on_the_card_matches_the_cpu(cuda):
    """Two ParallelTrainer steps of a thumbnail ResNet-18 (bench.py's
    north-star optimizer: lbsgd, lr 0.1, eta 0.001, momentum 0.9, bf16
    compute weights with float32 masters, small arrays coalesced) on the
    card and on the CPU from the same weights: the losses, masters,
    momenta and running statistics within 16 x 2**-8 x max(1, max |x|)
    (bf16 rounds in other places on the two devices; the CPU parity
    tests against the JAX package hold the same limit), and every bf16
    weight is its master rounded on both."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.parallel import ParallelTrainer, make_mesh
    rng = np.random.RandomState(0)
    x = rng.randn(4, 3, 32, 32).astype("float32")
    y = rng.randint(0, 10, (4,)).astype("float32")
    net = mx.gluon.model_zoo.vision.get_model(
        "resnet18_v1", classes=10, thumbnail=True, prefix="r18_")
    net.initialize(mx.init.Xavier(rnd_type="gaussian"), ctx=mx.cpu())
    net(mx.nd.array(x, ctx=mx.cpu()))
    trainers = [ParallelTrainer(
        net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), optimizer="lbsgd",
        optimizer_params={"learning_rate": 0.1, "eta": 0.001,
                          "momentum": 0.9},
        mesh=make_mesh({"dp": 1}, [dev]), multi_precision=True)
        for dev in (cuda, torch.device("cpu"))]
    losses = [[float(tr.fit_batch(x, y)) for _ in range(2)]
              for tr in trainers]
    tol = 16 * 2.0 ** -8
    np.testing.assert_allclose(losses[0], losses[1], rtol=tol, atol=tol)
    gpu, cpu = trainers
    assert gpu._params[gpu.param_names[0]].device.type == cuda.type
    assert len(gpu._small) > 2

    def close(a, b):
        a, b = a.float().cpu(), b.float()
        assert (a - b).abs().max().item() <= tol * max(
            1.0, b.abs().max().item())
    for n in gpu.param_names:
        for a, b in zip(gpu._opt_state[n], cpu._opt_state[n]):
            close(a, b)
        for tr in trainers:
            assert torch.equal(tr._params[n],
                               tr._opt_state[n][-1].to(torch.bfloat16))
    for n in gpu.aux_names:
        close(gpu._aux[n], cpu._aux[n])


# ---------------------------------------------------------------------------
# the data path on the card
# ---------------------------------------------------------------------------

def _jpegs(n, seed=0):
    import io
    Image = pytest.importorskip("PIL.Image")
    rs = np.random.RandomState(seed)
    out = []
    for i in range(n):
        h, w = (int(v) for v in rs.randint(60, 300, 2))
        yy, xx = np.mgrid[0:h, 0:w]
        img = np.stack([(yy * 0.5 + i * 9) % 256, (xx * 0.4) % 256,
                        ((yy + xx) * 0.3) % 256], -1)
        img = (img + rs.randint(0, 20, img.shape)).clip(0, 255)
        buf = io.BytesIO()
        Image.fromarray(img.astype(np.uint8)).save(buf, format="JPEG",
                                                   quality=90)
        out.append((buf.getvalue(), img.astype(np.uint8)))
    return out


def test_nvjpeg_decode_and_geometry_on_the_card(cuda):
    from mxnet_tpu_torch.io import native_decode as nd_
    data = _jpegs(12)
    bufs = [b for b, _ in data]
    dev = torch.device("cuda", 0)
    pool = nd_.NvjpegDecodePool(2, (48, 40), resize=64, rand_crop=True,
                                rand_mirror=True, device=dev)
    hw, rcs = pool.info(bufs)
    assert (rcs == 0).all()
    assert [tuple(v) for v in hw] == [img.shape[:2] for _, img in data]
    full = pool.decode_full(bufs, hw)
    Image = pytest.importorskip("PIL.Image")
    import io
    for f, b in zip(full, bufs):
        # another decoder of the same bytes (PIL's libjpeg: its own IDCT
        # and chroma upsampling)
        ref = np.asarray(Image.open(io.BytesIO(b)).convert("RGB"))
        d = np.abs(f.cpu().numpy().astype(int) - ref.astype(int))
        assert d.mean() < 2.0
    np.random.seed(4)
    out, ok = pool.decode_batch(bufs)
    assert ok.all() and out.device == dev and out.shape == (12, 48, 40, 3)
    np.random.seed(4)
    seeds = nd_.draw_seeds(len(bufs))
    for i, f in enumerate(full):
        want = nd_.augment_decoded(f.cpu(), seeds[i], 64, 48, 40, True,
                                   True)
        assert torch.equal(out[i].cpu(), want)
    assert pool.launches == 2


def test_image_record_iter_on_the_card_decodes_with_nvjpeg(cuda, tmp_path):
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import recordio
    prefix = str(tmp_path / "d")
    w = recordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    for i, (b, _) in enumerate(_jpegs(16, 1)):
        w.write_idx(i, recordio.pack(recordio.IRHeader(0, float(i), i, 0),
                                     b))
    w.close()
    epochs = []
    for _ in range(2):
        import random
        random.seed(3)
        np.random.seed(3)
        it = mx.io.ImageRecordIter(
            path_imgrec=prefix + ".rec", data_shape=(3, 32, 32),
            batch_size=8, shuffle=True, rand_crop=True, rand_mirror=True,
            mean_r=123.68, mean_g=116.28, mean_b=103.53)
        batches = [(b.data[0], b.label[0]) for b in it]
        assert it.iters[0].native_route == "nvjpeg"
        assert it.iters[0].routes == {"native": 2, "chain": 0}
        it.close()
        for x, y in batches:
            assert x._data.is_cuda and y._data.is_cuda
        epochs.append([(x.asnumpy(), y.asnumpy()) for x, y in batches])
    for (a, la), (b, lb) in zip(*epochs):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(la, lb)


def test_prefetcher_copy_stream_is_ordered_before_the_consumer(cuda):
    """Host batches of known fills through the pinned staging and the
    copy stream while the consumer's stream is kept busy: every batch
    the consumer reads holds its own fill (a missing event wait reads a
    half-copied or a reused buffer)."""
    import mxnet_tpu_torch as mx
    n, rows = 24, 256
    x = np.repeat(np.arange(n, dtype=np.float32), rows)[:, None] * \
        np.ones((1, 4096), np.float32)
    y = np.arange(n * rows, dtype=np.float32)
    pf = mx.io.DevicePrefetcher(mx.io.NDArrayIter(x, y, batch_size=rows),
                                depth=2, device=mx.gpu(0))
    busy = torch.randn(2048, 2048, device="cuda")
    try:
        for i, b in enumerate(pf):
            for _ in range(4):
                busy = torch.tanh(busy @ busy) * 0.5
            t = b.data[0]._data
            assert t.is_cuda
            got = float(t.double().sum())
            assert got == float(i) * rows * 4096, (i, got)
    finally:
        pf.close()
    assert i == n - 1


@pytest.mark.parametrize("m,k,n", [(1, 2048, 1000), (17, 64, 64),
                                   (5, 147, 64), (2048, 1024, 3072),
                                   (3, 9, 6)])
def test_int8_matmul_pads_to_int_mm_limits_and_matches_cpu(cuda, m, k, n):
    """Rows <= 16 and widths off a multiple of 8 (the FC at rung 1, the
    ResNet stem's 3 * 7 * 7 = 147) pad with zeros: exact, bit-equal to the
    CPU's float64 product, and counted as one int8 product."""
    from mxnet_tpu_torch.ops import quantization as q
    g = torch.Generator().manual_seed(m * 131 + k)
    a = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
    b = torch.randint(-127, 128, (n, k), generator=g, dtype=torch.int8)
    with q.counting() as work:
        got = q.int8_matmul(a.to(cuda), b.to(cuda))
    assert got.dtype == torch.int32 and tuple(got.shape) == (m, n)
    assert work["int8_products"] == 1
    torch.testing.assert_close(got.cpu(), q.int8_matmul(a, b), rtol=0,
                               atol=0)


@pytest.mark.parametrize("shape,w,stride,pad,groups", [
    ((2, 3, 224, 224), (64, 3, 7, 7), 2, 3, 1),
    ((4, 64, 56, 56), (64, 64, 3, 3), 1, 1, 1),
    ((4, 256, 28, 28), (512, 256, 1, 1), 2, 0, 1),
    ((2, 8, 9, 9), (8, 2, 3, 3), 1, 1, 4)])
def test_int8_convolution_matches_the_plain_version(cuda, shape, w, stride,
                                                    pad, groups):
    """The columns-and-_int_mm convolution against the CPU's exact float64
    convolution: int32 accumulators bit-equal."""
    from mxnet_tpu_torch.ops import registry as reg
    fn = reg.get_op("_contrib_quantized_conv").fn
    g = torch.Generator().manual_seed(sum(shape))
    d = torch.randint(-127, 128, shape, generator=g, dtype=torch.int8)
    wt = torch.randint(-127, 128, w, generator=g, dtype=torch.int8)
    r = [torch.tensor(v) for v in (-1.0, 1.0, -0.5, 0.5)]
    kw = dict(kernel=w[2:], stride=(stride, stride), pad=(pad, pad),
              num_filter=w[0], num_group=groups)
    got = fn(d.to(cuda), wt.to(cuda), *[t.to(cuda) for t in r], **kw)
    want = fn(d, wt, *r, **kw)
    torch.testing.assert_close(got[0].cpu(), want[0], rtol=0, atol=0)
    torch.testing.assert_close(got[1].cpu(), want[1])


def test_quantized_rung_graph_counts_int8_products(cuda):
    """A quantized convnet served on the card: each rung's CUDA graph
    recorded its int8 products at capture, the load gate passed, and a
    replay's answer is within 2**-20 of its magnitude of the same
    quantized graph run eagerly on the CPU with the same int8 weights
    (the int32 accumulators are exact; the float32 ops round alike)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.quantize import int8_work
    data = mx.sym.var("data")
    net = mx.sym.Convolution(data, kernel=(3, 3), num_filter=16, name="c1")
    net = mx.sym.Activation(net, act_type="relu", name="a1")
    net = mx.sym.Pooling(net, kernel=(2, 2), stride=(2, 2), name="p1")
    net = mx.sym.FullyConnected(net, num_hidden=24, name="f1")
    rs = np.random.RandomState(0)
    shapes = {"c1_weight": (16, 3, 3, 3), "c1_bias": (16,),
              "f1_weight": (24, 16 * 7 * 7), "f1_bias": (24,)}
    params = {n: mx.nd.array(rs.randn(*s).astype(np.float32) * 0.1,
                             ctx=mx.cpu()) for n, s in shapes.items()}
    batches = [rs.randn(8, 3, 16, 16).astype(np.float32) for _ in range(3)]
    reg = mx.serve.ModelRegistry()
    pred = reg.load("q", net, params, data_shapes={"data": (1, 3, 16, 16)},
                    ladder=mx.serve.BucketLadder(batches=(1, 8)),
                    quantize="int8", calib_batches=batches, ctx=mx.gpu(0))
    try:
        for b in (1, 8):
            work = int8_work(pred, b)
            assert work["int8_products"] == 2 and work["float_products"] == 0
        x = rs.randn(8, 3, 16, 16).astype(np.float32)
        got = pred.predict({"data": x})[0].asnumpy()
        cpu_args = {n: mx.nd.array(t.cpu(), ctx=mx.cpu())
                    for n, t in pred._params.items()}
        cpu_args["data"] = mx.nd.array(x, ctx=mx.cpu())
        want = pred._symbol.bind(mx.cpu(), args=cpu_args).forward()[0]
        want = want.asnumpy()
        assert np.abs(got - want).max() <= 2.0 ** -20 * np.abs(want).max()
    finally:
        reg.close()



def _fleet_checkpoint(tmp_path):
    """A small LM (2 layers, dim 64) exported for the fleet cases."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo.transformer import \
        get_transformer_lm
    net = get_transformer_lm(vocab=50, dim=64, heads=4, layers=2,
                             max_seq=16, prefix="cudafleet0_")
    gen = torch.Generator().manual_seed(3)
    net.initialize(ctx=mx.cpu(), generator=gen)
    net.hybridize()
    net(mx.nd.array(np.zeros((1, 8), np.float32), ctx=mx.cpu()))
    prefix = str(tmp_path / "lm")
    net.export(prefix, 0)
    return {"name": "lm", "prefix": prefix, "epoch": 0,
            "data_shapes": {"data0": [1, 8]}, "batches": [1, 2]}


def test_two_replica_fleet_round_trip_on_the_card(cuda, tmp_path):
    """Two replica processes serve the LM on cuda:0 (a CUDA graph per
    rung, flash_fwd inside): answers through the router are bit-equal to
    an in-process registry on the card at the request's rung, no replica
    captures in the request path, and a replica after the first builds
    no kernel."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import _cuda
    _cuda.build("flash_fwd")    # the parent builds; replicas find it
    spec = _fleet_checkpoint(tmp_path)
    reg = mx.serve.ModelRegistry()
    reg.load_checkpoint("lm", spec["prefix"], 0,
                        data_shapes={"data0": (1, 8)},
                        ladder=mx.serve.BucketLadder(batches=(1, 2)),
                        ctx=mx.gpu(0))
    fleet = mx.serve.Fleet([spec], replicas=2, workdir=str(tmp_path),
                           max_wait_ms=1.0)
    try:
        fleet.start()
        warm = {k: fleet.stats(k)["compile_count"] for k in fleet.keys()}
        rs = np.random.RandomState(4)
        for rows in (1, 2, 1, 2):
            x = rs.randint(0, 50, (rows, 8)).astype(np.float32)
            got = fleet.router.predict("lm", {"data0": x})[0]
            want = reg.predict("lm", x)[0].asnumpy()
            assert np.array_equal(got, want)
        for k in fleet.keys():
            st = fleet.stats(k)
            assert st["compile_count"] == warm[k] == {"lm": 2}
            assert st["nvcc_seconds"] == 0.0
            assert st["kernels"]["flash_fwd"]["wrapper"] > 0
            assert st["peak_memory_bytes"] > 0
        assert sum(fleet.stats(k)["predicts_dispatched"]
                   for k in fleet.keys()) == 4
    finally:
        fleet.stop()
        reg.close()


def test_replica_refuses_to_start_without_cuda_unless_told_cpu(cuda,
                                                               tmp_path):
    """A replica process that sees no CUDA device raises before its
    READY line unless its spec says "ctx": "cpu"; with it, it serves."""
    import json
    import os
    import subprocess
    import sys
    spec = _fleet_checkpoint(tmp_path)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=root)
    code = ("import sys; from mxnet_tpu_torch.serve.replica import main; "
            "sys.exit(main())")
    path = tmp_path / "spec.json"
    path.write_text(json.dumps({"models": [spec]}))
    out = subprocess.run([sys.executable, "-c", code, "--spec", str(path)],
                         capture_output=True, text=True, timeout=300,
                         env=env, cwd=root)
    assert out.returncode != 0 and "REPLICA READY" not in out.stdout
    assert "CUDA" in out.stderr
    path.write_text(json.dumps({"models": [spec], "ctx": "cpu"}))
    proc = subprocess.Popen([sys.executable, "-c", code, "--spec",
                             str(path)], stdout=subprocess.PIPE, text=True,
                            env=env, cwd=root)
    try:
        line = proc.stdout.readline()
        assert line.startswith("REPLICA READY"), line
    finally:
        proc.kill()
        proc.wait(30)
