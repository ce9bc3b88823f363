"""The layer ops of the PyTorch port other than Deconvolution, against
the JAX package, on the same numpy inputs (``test_utils.layer_op_cases``):
LRN, UpSampling, the contrib BilinearResize2D, AdaptiveAvgPooling2D and
div_sqrt_dim, softmin, SoftmaxActivation, softmax_cross_entropy, the CTC
loss under its four names and the ``*_v1`` spellings; then
``gluon.loss.CTCLoss`` and the contrib layers (Concurrent,
HybridConcurrent, Identity, SyncBatchNorm).

Every output and the gradients of the inputs a case names (``jax.vjp``
against ``torch.autograd``, the same random cotangents), float32: outputs
within 1e-5 of max(1, max |JAX|), gradients within 1e-4 of max |g|, the
CTC losses within 1e-4 relative.  Included: the antialiased shrink of
the two resize ops (torch's plain bilinear shrink parts from JAX's by
~1.8), the non-divisible adaptive pool (a resize in the JAX package, not
a pool), and a CTC alignment that cannot exist (JAX's finite ~1e5 loss,
where torch's own is infinite).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import mxnet_tpu as jmx
from mxnet_tpu.ops import registry as jreg

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.gluon import load_jax_params
from mxnet_tpu_torch.ops import registry as treg
from mxnet_tpu_torch.test_utils import (CTC_NAMES, V1_NAMES,
                                        layer_op_cases)

TOL_OUT, TOL_GRAD, TOL_CTC = 1e-5, 1e-4, 1e-4
CASES = [c for c in layer_op_cases() if c["name"] != "Deconvolution"]
NEW_NAMES = {"LRN", "UpSampling", "_contrib_BilinearResize2D",
             "_contrib_AdaptiveAvgPooling2D", "_contrib_div_sqrt_dim",
             "softmin", "SoftmaxActivation", "softmax_cross_entropy"} | \
    set(CTC_NAMES) | set(V1_NAMES)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs files in parallel processes: one intra-op thread a
    # process keeps them from oversubscribing the cores
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _err(got, want, relative_to_max=False):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = float(np.abs(want).max()) if relative_to_max else \
        max(1.0, float(np.abs(want).max()))
    return float(np.abs(got - want).max()) / scale


def test_cases_cover_the_other_fifteen_names():
    assert {c["name"] for c in CASES} == NEW_NAMES
    assert len(NEW_NAMES) == 15
    port = set(treg.list_ops())
    assert NEW_NAMES | {"Deconvolution"} <= port
    assert len(port) == 403 and port <= set(jreg.list_ops())


@pytest.mark.parametrize("case", CASES, ids=[c["id"] for c in CASES])
def test_layer_op_matches_jax(case):
    name, ins, params = case["name"], case["inputs"], case["params"]
    grads = case["grads"]
    jfn = jreg.get_op(name).fn

    def jcall(*diff):
        args = list(ins)
        for i, a in zip(grads, diff):
            args[i] = a
        return jfn(*[jnp.asarray(a) for a in args], **params)

    jout, vjp = jax.vjp(jcall, *[jnp.asarray(ins[i]) for i in grads])
    jouts = jout if isinstance(jout, tuple) else (jout,)
    rs = np.random.RandomState(11)
    cots = [rs.standard_normal(o.shape).astype(np.float32) for o in jouts]
    jgrads = vjp(tuple(jnp.asarray(c) for c in cots)
                 if isinstance(jout, tuple) else jnp.asarray(cots[0]))

    tin = [torch.from_numpy(a) for a in ins]
    for i in grads:
        tin[i].requires_grad_()
    tout = treg.get_op(name).fn(*tin, **params)
    touts = tout if isinstance(tout, tuple) else (tout,)
    assert len(touts) == len(jouts)
    ctc = name in CTC_NAMES
    for t, j in zip(touts, jouts):
        err = _err(t.detach().numpy(), np.asarray(j), relative_to_max=ctc)
        assert err <= (TOL_CTC if ctc else TOL_OUT), (name, err)
    torch.autograd.backward(list(touts), [torch.from_numpy(c)
                                          for c in cots])
    for i, g in zip(grads, jgrads):
        err = _err(tin[i].grad.numpy(), np.asarray(g), relative_to_max=True)
        assert err <= TOL_GRAD, (name, "grad of input %d" % i, err)


def test_plain_bilinear_shrink_would_not_match():
    """The reason for antialias: torch's plain bilinear shrink samples
    two pixels a tap and parts from the JAX resize far beyond the
    limit, the antialiased one does not."""
    x = np.random.RandomState(0).standard_normal((1, 2, 17, 23)).astype(
        np.float32)
    want = np.asarray(jreg.get_op("_contrib_BilinearResize2D").fn(
        jnp.asarray(x), height=5, width=7))
    plain = F.interpolate(torch.from_numpy(x), size=(5, 7), mode="bilinear",
                          align_corners=False).numpy()
    got = treg.get_op("_contrib_BilinearResize2D").fn(
        torch.from_numpy(x), height=5, width=7).numpy()
    assert _err(plain, want) > 0.1
    assert _err(got, want) <= TOL_OUT


def test_impossible_alignment_is_finite_as_in_jax():
    case = next(c for c in CASES if c["id"] == "CTCLoss-impossible")
    loss = treg.get_op("CTCLoss").fn(
        *[torch.from_numpy(a) for a in case["inputs"]], **case["params"])
    want = np.asarray(jreg.get_op("CTCLoss").fn(
        *[jnp.asarray(a) for a in case["inputs"]], **case["params"]))
    assert np.isfinite(loss.numpy()).all()
    assert (loss.numpy()[[0, 2]] > 9e4).all()        # ~1e5 per lacking step
    assert _err(loss.numpy(), want, relative_to_max=True) <= TOL_CTC
    # torch's own CTC gives infinity there
    lp = torch.log_softmax(torch.from_numpy(case["inputs"][0]), -1)
    raw = F.ctc_loss(lp[:, :1], torch.tensor([[1, 2, 3]]), torch.tensor([2]),
                     torch.tensor([3]), reduction="none")
    assert torch.isinf(raw).all()


def test_ctc_shape_inference_on_meta_tensors():
    out = treg.get_op("CTCLoss").fn(torch.empty((12, 4, 6), device="meta"),
                                    torch.empty((4, 3), device="meta"))
    assert out.shape == (4,) and out.device.type == "meta"


@pytest.mark.parametrize("layout,label_layout,lengths,weight", [
    ("NTC", "NT", False, None), ("TNC", "TN", True, 0.5),
    ("NTC", "NT", True, None)])
@pytest.mark.parametrize("hybridize", [False, True])
def test_gluon_ctc_loss_matches_jax(layout, label_layout, lengths, weight,
                                    hybridize):
    rs = np.random.RandomState(5)
    b, t, a = 3, 10, 5
    pred = rs.standard_normal((b, t, a)).astype(np.float32)
    # blank "last": the labels are 0 .. a - 2, padding -1
    label = np.array([[0, 1, 2], [3, 3, -1], [2, -1, -1]], np.float32)
    pl = np.array([10, 6, 4], np.float32)
    ll = np.array([3, 2, 1], np.float32)
    if layout == "TNC":
        pred = pred.transpose(1, 0, 2).copy()
    if label_layout == "TN":
        label = label.T.copy()
    outs = []
    for mx, ctx in ((jmx, None), (tmx, tmx.cpu())):
        loss = mx.gluon.loss.CTCLoss(layout=layout, label_layout=label_layout,
                                     weight=weight)
        if hybridize:
            loss.hybridize()
        arr = (lambda v: mx.nd.array(v)) if ctx is None else \
            (lambda v: mx.nd.array(v, ctx=ctx))
        p = arr(pred)
        p.attach_grad()
        extra = (arr(pl), arr(ll)) if lengths else ()
        with mx.autograd.record():
            out = loss(p, arr(label), *extra)
        out.backward()
        outs.append((out.asnumpy(), p.grad.asnumpy()))
    (tl, tg), (jl, jg) = outs[1], outs[0]
    assert tl.shape == (b,)
    assert _err(tl, jl, relative_to_max=True) <= TOL_CTC
    assert _err(tg, jg, relative_to_max=True) <= TOL_GRAD


def _contrib_pair(mx, make):
    net = make(mx)
    if mx is jmx:
        net.initialize(jmx.init.Normal(0.5))
    else:
        net.initialize(ctx=tmx.cpu())
    return net


def _concurrent(mx, hybrid):
    cls = mx.gluon.contrib.nn.HybridConcurrent if hybrid else \
        mx.gluon.contrib.nn.Concurrent
    net = cls(axis=1, prefix="cc_")
    with net.name_scope():
        net.add(mx.gluon.nn.Dense(4), mx.gluon.contrib.nn.Identity(),
                mx.gluon.nn.Dense(3, activation="tanh"))
    return net


def _sync_bn(mx):
    net = mx.gluon.nn.HybridSequential(prefix="sbn_")
    with net.name_scope():
        # no conv bias: BatchNorm takes the mean out, so its exact
        # gradient is zero and both packages would compare f32 noise
        net.add(mx.gluon.nn.Conv2D(4, 3, padding=1, use_bias=False),
                mx.gluon.contrib.nn.SyncBatchNorm(num_devices=1))
    return net


@pytest.mark.parametrize("kind", ["Concurrent", "HybridConcurrent",
                                  "HybridConcurrent-hybridized",
                                  "SyncBatchNorm", "SyncBatchNorm-hybridized"])
def test_contrib_layers_match_jax(kind):
    rs = np.random.RandomState(9)
    if kind.startswith("SyncBatchNorm"):
        make, x = _sync_bn, rs.standard_normal((4, 3, 6, 6))
    else:
        make = lambda mx: _concurrent(mx, kind != "Concurrent")
        x = rs.standard_normal((5, 6))
    x = x.astype(np.float32)
    jnet = _contrib_pair(jmx, make)
    tnet = _contrib_pair(tmx, make)
    with jmx.autograd.record():       # train mode: BatchNorm's batch stats
        jout = jnet(jmx.nd.array(x))
    cot = rs.standard_normal(jout.shape).astype(np.float32)
    jout.backward(jmx.nd.array(cot))
    load_jax_params(tnet, {k: v.data().asnumpy()
                           for k, v in jnet.collect_params().items()})
    if kind.endswith("hybridized"):
        tnet.hybridize()
    xt = tmx.nd.array(x, ctx=tmx.cpu())
    with tmx.autograd.record():
        tout = tnet(xt)
    tout.backward(tmx.nd.array(cot, ctx=tmx.cpu()))
    assert _err(tout.asnumpy(), jout.asnumpy()) <= TOL_OUT
    for name, p in tnet.collect_params().items():
        if p.grad_req == "null":
            continue
        jg = jnet.collect_params()[name].grad().asnumpy()
        assert _err(p.grad().asnumpy(), jg, relative_to_max=True) <= \
            TOL_GRAD, name
