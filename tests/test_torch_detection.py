"""The detection ops of the PyTorch port against the JAX package, on the
same numpy inputs: the 17 names of ``ops/detection.py`` (MultiBoxPrior,
MultiBoxTarget, MultiBoxDetection, box_iou, box_nms, ROIAlign, Proposal
and their aliases) over ``test_utils.detection_op_cases``, the cases of
``tests/test_detection.py`` mirrored, the NMS top-k route, and the shape
rules against the JAX package's ``infer_shape``.

Tolerances (float32): outputs within 1e-5 of max(1, max |JAX|), the
gradients of every input a case names (``jax.vjp`` against
``torch.autograd``, the same random cotangents; an input the port's
graph does not reach has gradient zero) within 1e-4 of max |g|.
Discrete outputs (keep masks, class ids, the scores that order the
rows, the matched targets) must be equal.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.ops import registry as jreg

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.ops import registry as treg
from mxnet_tpu_torch.ops import detection as tdet
from mxnet_tpu_torch.test_utils import (DETECTION_NAMES, SPATIAL_NAMES,
                                        detection_op_cases)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL_OUT, TOL_GRAD = 1e-5, 1e-4
CASES = [c for c in detection_op_cases() if c["name"] in DETECTION_NAMES]


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
    if not want.size:
        return 0.0
    scale = float(np.abs(want).max()) if relative_to_max else \
        max(1.0, float(np.abs(want).max()))
    return float(np.abs(got - want).max()) / max(scale, 1e-30)


def run_both(case, seed=11):
    """(JAX outputs, JAX gradients, port outputs, port gradients) of one
    case, the same cotangents on both sides."""
    name, ins, params, grads = (case["name"], case["inputs"],
                                case["params"], case["grads"])
    jfn = jreg.get_op(name).fn

    def jcall(*diff):
        args = list(ins)
        for i, a in zip(grads, diff):
            args[i] = a
        return jfn(*[jnp.asarray(a) for a in args], **params)

    jout, vjp = jax.vjp(jcall, *[jnp.asarray(ins[i]) for i in grads])
    jouts = jout if isinstance(jout, tuple) else (jout,)
    rs = np.random.RandomState(seed)
    cots = [rs.standard_normal(o.shape).astype(np.float32) for o in jouts]
    jgrads = vjp(tuple(jnp.asarray(c) for c in cots)
                 if isinstance(jout, tuple) else jnp.asarray(cots[0]))
    tin = [torch.from_numpy(a) for a in ins]
    for i in grads:
        tin[i].requires_grad_()
    tout = treg.get_op(name).fn(*tin, **params)
    touts = tout if isinstance(tout, tuple) else (tout,)
    live = [(t, torch.from_numpy(c)) for t, c in zip(touts, cots)
            if t.requires_grad]
    if live:
        torch.autograd.backward([t for t, _ in live], [c for _, c in live])
    tgrads = [tin[i].grad if tin[i].grad is not None
              else torch.zeros_like(tin[i]) for i in grads]
    return ([np.asarray(j) for j in jouts], [np.asarray(g) for g in jgrads],
            [t.detach().numpy() for t in touts],
            [g.numpy() for g in tgrads])


def check_case(case):
    jouts, jgrads, touts, tgrads = run_both(case)
    assert len(touts) == len(jouts)
    for k, cols in case.get("exact", []):
        j, t = jouts[k], touts[k]
        if cols is not None:
            j, t = j[..., cols], t[..., cols]
        np.testing.assert_array_equal(t, j, err_msg="%s output %d" % (
            case["id"], k))
    for k, (t, j) in enumerate(zip(touts, jouts)):
        assert t.dtype == j.dtype, (case["id"], k, t.dtype, j.dtype)
        assert _err(t, j) <= TOL_OUT, (case["id"], k, _err(t, j))
    for i, t, j in zip(case["grads"], tgrads, jgrads):
        if not np.abs(j).max() and not np.abs(t).max():
            continue
        err = _err(t, j, relative_to_max=True)
        assert err <= TOL_GRAD, (case["id"], "grad of input %d" % i, err)


def test_cases_cover_the_seventeen_names():
    assert {c["name"] for c in CASES} == set(DETECTION_NAMES)
    assert len(DETECTION_NAMES) == 17
    port, ref = set(treg.list_ops()), set(jreg.list_ops())
    assert set(DETECTION_NAMES) <= port and port <= ref


@pytest.mark.parametrize("name", DETECTION_NAMES)
def test_contract_matches_jax(name):
    jop, top = jreg.get_op(name), treg.get_op(name)
    assert top.name == jop.name
    assert top.input_names == jop.input_names
    assert top.param_names == jop.param_names
    for params in ({}, {"output_score": True}):
        assert top.n_out(params) == jop.n_out(params)
        assert top.n_visible(params) == jop.n_visible(params)


@pytest.mark.parametrize("case", CASES, ids=[c["id"] for c in CASES])
def test_detection_op_matches_jax(case):
    check_case(case)


# -- the cases of tests/test_detection.py, on both packages -------------------

def _both(name, *arrays, **params):
    j = jreg.get_op(name).fn(*[jnp.asarray(a) for a in arrays], **params)
    t = treg.get_op(name).fn(*[torch.from_numpy(np.asarray(a))
                               for a in arrays], **params)
    j = j if isinstance(j, tuple) else (j,)
    t = t if isinstance(t, tuple) else (t,)
    return [np.asarray(a) for a in j], [b.numpy() for b in t]


def test_multibox_prior_matches_reference_math():
    j, t = _both("MultiBoxPrior", np.zeros((1, 3, 2, 3), np.float32),
                 sizes=(0.5, 0.3), ratios=(1.0, 2.0))
    np.testing.assert_array_equal(t[0], j[0])
    out = mx_nd_prior = tmx.nd.MultiBoxPrior(
        tmx.nd.array(np.zeros((1, 3, 2, 3), np.float32), ctx=tmx.cpu()),
        sizes=(0.5, 0.3), ratios=(1.0, 2.0)).asnumpy()
    assert mx_nd_prior.shape == (1, 18, 4)
    cx, cy, w, h = 0.5 / 3, 0.5 / 2, 0.5 * 2 / 3 / 2, 0.5 / 2
    np.testing.assert_allclose(out[0, 0], [cx - w, cy - h, cx + w, cy + h],
                               rtol=1e-5)


def test_box_nms_per_class():
    rows = np.array([[0, 0.9, 0.1, 0.1, 0.5, 0.5],
                     [1, 0.8, 0.1, 0.1, 0.5, 0.5],
                     [0, 0.7, 0.12, 0.12, 0.5, 0.5]], np.float32)
    j, t = _both("box_nms", rows[None], overlap_thresh=0.5, id_index=0,
                 force_suppress=False)
    np.testing.assert_array_equal(t[0], j[0])
    assert (t[0][0, 2] == -1).all() and (t[0][0, 0] == rows[0]).all()


def test_box_iou_and_nms_through_nd():
    a = np.array([[0, 0, 2, 2]], np.float32)
    b = np.array([[1, 1, 3, 3], [0, 0, 2, 2], [5, 5, 6, 6]], np.float32)
    got = tmx.nd.box_iou(tmx.nd.array(a, ctx=tmx.cpu()),
                         tmx.nd.array(b, ctx=tmx.cpu())).asnumpy()
    np.testing.assert_allclose(got[0], [1.0 / 7, 1.0, 0.0], rtol=1e-6)
    rs = np.random.RandomState(0)
    rows = np.zeros((1, 20, 6), np.float32)
    ctr = rs.uniform(0.2, 0.8, (20, 2))
    wh = rs.uniform(0.05, 0.3, (20, 2))
    rows[0, :, 2:4] = ctr - wh
    rows[0, :, 4:6] = ctr + wh
    rows[0, :, 1] = rs.uniform(0.1, 1.0, 20)
    got = tmx.nd.contrib.box_nms(tmx.nd.array(rows, ctx=tmx.cpu()),
                                 overlap_thresh=0.5,
                                 force_suppress=True).asnumpy()
    want = np.asarray(jmx.nd.box_nms(jmx.nd.array(rows), overlap_thresh=0.5,
                                     force_suppress=True).asnumpy())
    np.testing.assert_array_equal(got, want)


def test_multibox_target_basic_and_mining():
    anchors = np.array([[[0.0, 0.0, 0.3, 0.3], [0.4, 0.4, 0.8, 0.8],
                         [0.0, 0.6, 0.3, 0.9], [0.6, 0.0, 0.9, 0.3]]],
                       np.float32)
    labels = np.array([[[1.0, 0.4, 0.4, 0.8, 0.8]]], np.float32)
    cls_preds = np.zeros((1, 3, 4), np.float32)
    cls_preds[0, 0] = [5.0, 5.0, 5.0, -5.0]
    for params in ({}, dict(negative_mining_ratio=1.0,
                            negative_mining_thresh=0.5)):
        j, t = _both("MultiBoxTarget", anchors, labels, cls_preds, **params)
        for a, b in zip(t, j):
            np.testing.assert_allclose(a, b, atol=1e-6)
    assert list(t[2][0]) == [-1.0, 2.0, -1.0, 0.0]


def test_multibox_detection_decode_and_nms():
    anchors = np.array([[[0.1, 0.1, 0.3, 0.3], [0.5, 0.5, 0.9, 0.9]]],
                       np.float32)
    loc = np.zeros((1, 8), np.float32)
    cls_prob = np.array([[[0.1, 0.2], [0.8, 0.1], [0.1, 0.7]]], np.float32)
    j, t = _both("MultiBoxDetection", cls_prob, loc, anchors,
                 nms_threshold=0.5)
    np.testing.assert_array_equal(t[0], j[0])
    np.testing.assert_allclose(t[0][0, 0], [0, 0.8, 0.1, 0.1, 0.3, 0.3],
                               rtol=1e-6)


def test_roi_align_constant_and_proposal_bounds():
    j, t = _both("ROIAlign", np.full((1, 2, 8, 8), 3.0, np.float32),
                 np.array([[0, 0, 0, 4, 4]], np.float32),
                 pooled_size=(2, 2), spatial_scale=1.0)
    np.testing.assert_array_equal(t[0], j[0])
    np.testing.assert_allclose(t[0], 3.0)
    rs = np.random.RandomState(0)
    ins = (rs.rand(1, 6, 4, 4).astype(np.float32),
           rs.randn(1, 12, 4, 4).astype(np.float32) * 0.1,
           np.array([[64, 64, 1.0]], np.float32))
    j, t = _both("Proposal", *ins, rpn_post_nms_top_n=10, scales=(2,),
                 ratios=(0.5, 1, 2), feature_stride=16, rpn_min_size=4)
    assert t[0].shape == (10, 5)
    assert (t[0][:, 1:] >= 0).all() and (t[0][:, 1:] <= 63).all()
    assert _err(t[0], j[0]) <= TOL_OUT


# -- NMS over the top k ---------------------------------------------------

def _nms_inputs(seed, b=3, n=40):
    rs = np.random.RandomState(seed)
    c = rs.uniform(0.3, 0.7, (b, n, 2))
    wh = rs.uniform(0.1, 0.5, (b, n, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    scores = rs.uniform(0, 1, (b, n)).astype(np.float32)
    scores[:, 5] = scores[:, 9]                       # a tie, kept stable
    ids = rs.randint(0, 3, (b, n)).astype(np.float32)
    return boxes, scores, scores > 0.2, ids


@pytest.mark.parametrize("topk", [-1, 1, 7, 40, 100])
@pytest.mark.parametrize("per_class", [False, True])
def test_nms_mask_topk_matches_jax(topk, per_class):
    """The port's loop stops at min(N, topk) sorted rows; the JAX op runs
    all N with rows past topk invalid: the same keep mask, topk below,
    at and above N, and none."""
    from mxnet_tpu.ops.detection import _nms_mask as jnms
    boxes, scores, valid, ids = _nms_inputs(topk + 3)
    got = tdet._nms_mask(torch.from_numpy(boxes), torch.from_numpy(scores),
                         torch.from_numpy(valid), 0.45,
                         torch.from_numpy(ids) if per_class else None,
                         not per_class, topk).numpy()
    for b in range(boxes.shape[0]):
        want = np.asarray(jnms(jnp.asarray(boxes[b]), jnp.asarray(scores[b]),
                               jnp.asarray(valid[b]), 0.45,
                               jnp.asarray(ids[b]) if per_class else None,
                               not per_class, topk))
        np.testing.assert_array_equal(got[b], want)


def test_nms_loop_runs_topk_steps_only():
    """At topk the loop writes the keep mask topk times, however many
    boxes there are (the reason SSD-300's 8732 anchors fit a graph)."""
    boxes, scores, valid, _ = _nms_inputs(0, b=1, n=300)
    writes = []
    real = torch.Tensor.__setitem__

    def counting(self, key, value):
        writes.append(key)
        return real(self, key, value)
    torch.Tensor.__setitem__ = counting
    try:
        tdet._nms_mask(torch.from_numpy(boxes), torch.from_numpy(scores),
                       torch.from_numpy(valid), 0.5, topk=12)
    finally:
        torch.Tensor.__setitem__ = real
    assert len(writes) == 12


# -- shape rules ------------------------------------------------------------

def _ssd_graphs():
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    sys.path.insert(0, ROOT)
    import chip_smoke
    import ssd_model
    return ssd_model, chip_smoke


def test_shape_rules_match_jax_without_running_the_ops():
    """The port's SSD-300 graphs infer the JAX package's shapes, and no
    detection op runs while they do (each op's function is replaced by
    one that raises)."""
    from unittest import mock
    ssd_model, chip_smoke = _ssd_graphs()
    jinfer = ssd_model.build_ssd300_infer(num_classes=20)
    jtrain = ssd_model.build_ssd300_train(num_classes=20)
    tinfer = chip_smoke.build_ssd300_infer(tmx, num_classes=20)
    ttrain = chip_smoke.build_ssd300_train(tmx, num_classes=20)

    def boom(*a, **k):
        raise AssertionError("shape inference ran a detection op")
    ops = [treg.get_op(n) for n in ("_contrib_MultiBoxPrior",
                                    "_contrib_MultiBoxTarget",
                                    "_contrib_MultiBoxDetection")]
    with mock.patch.multiple(ops[0], fn=boom), \
            mock.patch.multiple(ops[1], fn=boom), \
            mock.patch.multiple(ops[2], fn=boom):
        for jsym, tsym, shapes in (
                (jinfer, tinfer, dict(data0=(2, 3, 300, 300))),
                (jtrain, ttrain, dict(data0=(2, 3, 300, 300),
                                      label=(2, 3, 5)))):
            ja, jo, jx = jsym.infer_shape(**shapes)
            ta, to, tx = tsym.infer_shape(**shapes)
            assert [tuple(s) for s in to] == [tuple(s) for s in jo]
            assert [tuple(s) for s in ta] == [tuple(s) for s in ja]
    assert [tuple(s) for s in to] == [(2 * 8732, 21), (2, 8732 * 4),
                                      (1, 8732, 4)]


@pytest.mark.parametrize("case", [
    c for c in detection_op_cases()
    if len(c["inputs"]) == len(treg.get_op(c["name"]).input_names)],
    ids=lambda c: c["id"])
def test_op_shape_inference_matches_jax(case):
    """Each case's op as a one-node Symbol: the port's infer_shape (a
    rule for the detection ops, meta tensors for the rest) gives the JAX
    package's output shapes.  (A case that leaves an input out, the
    DeformableConvolution without bias, is left out: neither package
    infers the shape of an input the op ignores.)"""
    names = ["in%d" % i for i in range(len(case["inputs"]))]
    shapes = {n: a.shape for n, a in zip(names, case["inputs"])}
    outs = []
    for mx in (jmx, tmx):
        fn = getattr(mx.sym, case["name"])
        s = fn(*[mx.sym.var(n) for n in names], **case["params"])
        outs.append([tuple(o) for o in s.infer_shape(**shapes)[1]])
    assert outs[1] == outs[0]


def test_breadth_grows_by_the_thirty_seven_names():
    """The detection slice added exactly the 17 detection names, the 19
    spatial ones and ROIPooling to the 366 before it, every one the
    reference's; the long-tail slice added 48 more (451 of the
    reference's 453); the 2 left are MoEFFN's, in the JAX package's
    ops/nn.py."""
    import collections
    from mxnet_tpu_torch.test_utils import SPARSE_SLICE_NAMES
    port, ref = set(treg.list_ops()), set(jreg.list_ops())
    new = set(DETECTION_NAMES) | set(SPATIAL_NAMES) | {"ROIPooling"}
    assert len(new) == 37 and new <= port
    assert len(port) == 451 and \
        len(port - new - set(SPARSE_SLICE_NAMES)) == 366
    assert port <= ref and len(ref) == 453
    left = collections.Counter(jreg.get_op(n).fn.__module__.split(".")[-1]
                               for n in ref - port)
    assert left == {"nn": 2}
    for n in new:
        assert hasattr(tmx.nd, n) and hasattr(tmx.sym, n), n
        if n.startswith("_contrib_"):
            short = n[len("_contrib_"):]
            assert hasattr(tmx.nd.contrib, short) and \
                hasattr(tmx.sym.contrib, short), n
            assert hasattr(jmx.nd.contrib, short), n
