"""The quantization ops of the PyTorch port (``mxnet_tpu_torch/ops/
quantization.py``) and its MXNet-1.3 ``contrib.quantization`` API against
the JAX package, in one process on seeded numpy inputs, on the CPU.

Covered: the 17 op names (contract and values), the 2-bit wire pack, the
cases of ``tests/test_quantization.py`` and ``tests/test_quant_parity.py``
mirrored on the port, and ``contrib.quantization`` against the
reference's.

Tolerances: int8/uint8 codes equal on at least 99.9 % of elements and
never more than 1 apart (XLA may contract ``(x - min) * scale + qmin``
into one FMA, which moves a value sitting on a .5 boundary by one code);
int32 accumulators of the quantized conv, fc and pooling bit-equal for
equal int8 inputs; dequantized and other float outputs within 1e-6 of
the reference's magnitude.  The mirrored model cases hold the port to
the reference's own limits against fp32.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu.ops.quantization import pack_2bit as jpack
from mxnet_tpu.ops.quantization import unpack_2bit as junpack
from mxnet_tpu_torch import nd
from mxnet_tpu_torch.ops import registry as treg
from mxnet_tpu_torch.ops.quantization import pack_2bit, unpack_2bit

CPU = tmx.cpu()
INT32_MAX = 2.0 ** 31 - 1
FLOAT_TOL = 1e-6
CODE_SHARE = 0.999

OP_NAMES = (
    "_contrib_quantize", "quantize", "_contrib_dequantize", "dequantize",
    "_contrib_requantize", "_contrib_quantized_conv", "quantized_conv",
    "_contrib_quantized_fully_connected", "quantized_fc",
    "_contrib_quantized_pooling", "quantized_pooling",
    "_contrib_quantized_flatten", "quantized_flatten",
    "_contrib_quantized_act", "quantized_act", "_contrib_quantize_2bit",
    "_contrib_dequantize_2bit")


def test_seventeen_names_registered_in_both():
    assert len(OP_NAMES) == 17 and len(set(OP_NAMES)) == 17
    assert set(OP_NAMES) <= set(jreg.list_ops())
    assert set(OP_NAMES) <= set(treg.list_ops())


@pytest.mark.parametrize("name", OP_NAMES)
def test_contract_matches_jax(name):
    jop, top = jreg.get_op(name), treg.get_op(name)
    assert top.name == jop.name
    assert top.input_names == jop.input_names
    assert top.param_names == jop.param_names
    assert top.needs_rng == jop.needs_rng
    assert top.n_out({}) == jop.n_out({})


def _f32(x):
    return np.asarray(x, np.float32)


def _cases():
    rs = np.random.RandomState(0)
    x = (rs.randn(4, 3, 9, 9) * 1.5).astype(np.float32)
    q8 = rs.randint(-127, 128, (4, 3, 9, 9)).astype(np.int8)
    u8 = rs.randint(0, 256, (2, 3, 8, 8)).astype(np.uint8)
    acc = rs.randint(-2 ** 30, 2 ** 30, (5, 7)).astype(np.int32)
    w33 = rs.randint(-127, 128, (6, 3, 3, 3)).astype(np.int8)
    wg = rs.randint(-127, 128, (6, 1, 3, 3)).astype(np.int8)
    w1 = rs.randint(-127, 128, (5, 3, 1, 1)).astype(np.int8)
    w7 = rs.randint(-127, 128, (8, 3, 7, 7)).astype(np.int8)
    wfc = rs.randint(-127, 128, (6, 243)).astype(np.int8)
    wfc9 = rs.randint(-127, 128, (6, 9)).astype(np.int8)
    r = [_f32(-1.3), _f32(1.3), _f32(-0.4), _f32(0.4)]
    big = rs.randint(-127, 128, (2, 3, 20, 20)).astype(np.int8)
    out = [
        ("quantize", "int8", [x, _f32(-2.5), _f32(3.1)],
         {"out_type": "int8"}),
        ("quantize", "uint8", [x, _f32(-2.5), _f32(3.1)],
         {"out_type": "uint8"}),
        ("_contrib_quantize", "sym", [x, _f32(-3.7), _f32(3.7)],
         {"out_type": "int8"}),
        ("dequantize", "int8", [q8, _f32(-2.5), _f32(2.5)], {}),
        ("_contrib_dequantize", "uint8", [u8, _f32(0.0), _f32(4.0)], {}),
        ("dequantize", "int32", [acc, _f32(-1.7), _f32(1.7)], {}),
        ("_contrib_requantize", "plain", [acc, _f32(-1.7), _f32(1.7)], {}),
        ("_contrib_requantize", "calib", [acc, _f32(-1.7), _f32(1.7)],
         {"min_calib_range": -0.3, "max_calib_range": 0.3}),
        ("quantized_conv", "3x3", [q8, w33] + r,
         {"kernel": (3, 3), "num_filter": 6}),
        ("_contrib_quantized_conv", "stride-pad", [q8, w33] + r,
         {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1),
          "num_filter": 6}),
        ("quantized_conv", "dilate", [q8, w33] + r,
         {"kernel": (3, 3), "dilate": (2, 2), "pad": (2, 2),
          "num_filter": 6}),
        ("quantized_conv", "groups", [q8, wg] + r,
         {"kernel": (3, 3), "num_group": 3, "num_filter": 6}),
        ("quantized_conv", "1x1-stride", [q8, w1] + r,
         {"kernel": (1, 1), "stride": (2, 2), "num_filter": 5}),
        ("quantized_conv", "stem-7x7", [big, w7] + r,
         {"kernel": (7, 7), "stride": (2, 2), "pad": (3, 3),
          "num_filter": 8}),
        ("quantized_fc", "flatten", [q8, wfc] + r, {"num_hidden": 6}),
        ("_contrib_quantized_fully_connected", "no-flatten",
         [q8, wfc9] + r, {"num_hidden": 6, "flatten": False}),
    ]
    for pt in ("max", "avg"):
        out += [
            ("quantized_pooling", pt + "-s2", [q8, _f32(-1), _f32(1)],
             {"kernel": (2, 2), "stride": (2, 2), "pool_type": pt}),
            ("_contrib_quantized_pooling", pt + "-pad",
             [q8, _f32(-1), _f32(1)],
             {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1),
              "pool_type": pt}),
            ("quantized_pooling", pt + "-global", [q8, _f32(-1), _f32(1)],
             {"kernel": (3, 3), "pool_type": pt, "global_pool": True}),
            ("quantized_pooling", pt + "-uint8", [u8, _f32(0), _f32(2)],
             {"kernel": (2, 2), "stride": (2, 2), "pool_type": pt}),
        ]
    out += [
        ("quantized_act", "relu", [q8, _f32(-1), _f32(1)], {}),
        ("_contrib_quantized_act", "relu", [q8, _f32(-1), _f32(1)],
         {"act_type": "relu"}),
        ("quantized_flatten", "4d", [q8, _f32(-1), _f32(1)], {}),
        ("_contrib_quantized_flatten", "4d", [q8, _f32(-1), _f32(1)], {}),
        ("_contrib_quantize_2bit", "t0.5", [x, (x * 0.3).astype(np.float32)],
         {"threshold": 0.5}),
        ("_contrib_dequantize_2bit", "t0.25",
         [rs.randint(-1, 2, (7, 5)).astype(np.int8)], {"threshold": 0.25}),
    ]
    return out


CASES = _cases()


def _run(reg, name, ins, params, jax):
    fn = reg.get_op(name).fn
    if jax:
        out = fn(*[jnp.asarray(a) for a in ins], **params)
        out = out if isinstance(out, tuple) else (out,)
        return [np.asarray(o) for o in out]
    out = fn(*[torch.from_numpy(np.array(a)) for a in ins], **params)
    out = out if isinstance(out, tuple) else (out,)
    return [o.numpy() for o in out]


def hold(got, want):
    """The file's tolerance rule for one output."""
    assert got.shape == want.shape and got.dtype == want.dtype, \
        (got.shape, got.dtype, want.shape, want.dtype)
    if want.dtype in (np.int8, np.uint8):
        d = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert d.max(initial=0) <= 1
        assert (d == 0).mean() >= CODE_SHARE if d.size else True
    elif want.dtype.kind in "iu":
        np.testing.assert_array_equal(got, want)
    else:
        scale = max(1e-30, float(np.abs(want).max(initial=0.0)))
        err = float(np.abs(got.astype(np.float64) - want).max(initial=0.0))
        assert err <= FLOAT_TOL * scale, (err, scale)


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0] + "-" + c[1])
def test_op_matches_jax(case):
    name, _, ins, params = case
    want = _run(jreg, name, ins, params, True)
    got = _run(treg, name, ins, params, False)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        hold(g, w)


def test_int32_accumulators_are_bit_equal_at_width():
    """A ResNet-shaped 3x3 conv and an LM-shaped fc: the int32
    accumulators equal the reference's bit for bit."""
    rs = np.random.RandomState(5)
    d = rs.randint(-127, 128, (2, 64, 14, 14)).astype(np.int8)
    w = rs.randint(-127, 128, (64, 64, 3, 3)).astype(np.int8)
    r = [_f32(-1), _f32(1), _f32(-1), _f32(1)]
    p = {"kernel": (3, 3), "pad": (1, 1), "num_filter": 64}
    j = _run(jreg, "quantized_conv", [d, w] + r, p, True)[0]
    t = _run(treg, "quantized_conv", [d, w] + r, p, False)[0]
    np.testing.assert_array_equal(t, j)
    d = rs.randint(-127, 128, (32, 1024)).astype(np.int8)
    w = rs.randint(-127, 128, (4096, 1024)).astype(np.int8)
    j = _run(jreg, "quantized_fc", [d, w] + r, {"num_hidden": 4096}, True)
    t = _run(treg, "quantized_fc", [d, w] + r, {"num_hidden": 4096}, False)
    np.testing.assert_array_equal(t[0], j[0])


# -- the cases of tests/test_quantization.py, on the port -------------------

def test_quantize_dequantize_roundtrip_int8():
    rs = np.random.RandomState(0)
    x = rs.uniform(-3, 3, (4, 5)).astype(np.float32)
    m = float(np.abs(x).max())
    with CPU:
        q, lo, hi = nd.quantize(nd.array(x), nd.array(-m), nd.array(m),
                                out_type="int8")
        assert str(q.dtype) == "int8"
        back = nd.dequantize(q, lo, hi).asnumpy()
    np.testing.assert_allclose(back, x, atol=2 * m / 254)
    jq, jlo, jhi = jmx.nd.quantize(jmx.nd.array(x), jmx.nd.array(-m),
                                   jmx.nd.array(m), out_type="int8")
    hold(q.asnumpy(), jq.asnumpy())
    hold(back, jmx.nd.dequantize(jq, jlo, jhi).asnumpy())


def test_quantized_fc_matches_int_math():
    rs = np.random.RandomState(1)
    d = rs.randint(-127, 128, (2, 6)).astype(np.int8)
    w = rs.randint(-127, 128, (3, 6)).astype(np.int8)
    with CPU:
        out, omin, omax = nd.quantized_fc(
            nd.array(d), nd.array(w), nd.array(-1.0), nd.array(1.0),
            nd.array(-1.0), nd.array(1.0), num_hidden=3)
    assert str(out.dtype) == "int32"
    expected = d.astype(np.int64) @ w.T.astype(np.int64)
    np.testing.assert_array_equal(out.asnumpy(), expected)


def test_quantized_conv_matches_fp32():
    rs = np.random.RandomState(2)
    x = rs.randn(2, 3, 8, 8).astype(np.float32)
    w = rs.randn(4, 3, 3, 3).astype(np.float32) * 0.3
    mx_, mw = float(np.abs(x).max()), float(np.abs(w).max())
    qx = np.round(x * 127 / mx_).astype(np.int8)
    qw = np.round(w * 127 / mw).astype(np.int8)
    with CPU:
        out, omin, omax = nd.quantized_conv(
            nd.array(qx), nd.array(qw), nd.array(-mx_), nd.array(mx_),
            nd.array(-mw), nd.array(mw), kernel=(3, 3), num_filter=4)
        deq = nd.dequantize(out, omin, omax).asnumpy()
        ref = nd.Convolution(nd.array(x), nd.array(w), kernel=(3, 3),
                             num_filter=4, no_bias=True).asnumpy()
    err = np.abs(deq - ref).max() / np.abs(ref).max()
    assert err < 0.03, err


def test_quantized_pooling_int8():
    rs = np.random.RandomState(3)
    x = rs.randint(-127, 128, (1, 2, 4, 4)).astype(np.int8)
    with CPU:
        out, _, _ = nd.quantized_pooling(
            nd.array(x), nd.array(-1.0), nd.array(1.0), kernel=(2, 2),
            stride=(2, 2), pool_type="max")
    assert str(out.dtype) == "int8"
    ref = x.reshape(1, 2, 2, 2, 2, 2).max((3, 5))
    np.testing.assert_array_equal(out.asnumpy(), ref)


def _convnet(mx):
    data = mx.sym.var("data")
    c1 = mx.sym.Convolution(data=data, kernel=(3, 3), num_filter=8,
                            name="c1")
    a1 = mx.sym.Activation(data=c1, act_type="relu")
    p1 = mx.sym.Pooling(data=a1, kernel=(2, 2), stride=(2, 2),
                        pool_type="max")
    return mx.sym.FullyConnected(data=p1, num_hidden=10, name="f1")


def _convnet_np(rs):
    return {
        "c1_weight": rs.randn(8, 3, 3, 3).astype(np.float32) * 0.2,
        "c1_bias": rs.randn(8).astype(np.float32) * 0.1,
        "f1_weight": rs.randn(10, 8 * 5 * 5).astype(np.float32) * 0.1,
        "f1_bias": rs.randn(10).astype(np.float32) * 0.1,
    }


class _OneBatch:
    def __init__(self, mx, x):
        self._mx = mx
        self._x = x
        self._done = False

    def reset(self):
        self._done = False

    def __iter__(self):
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        self._done = True
        return self._mx.io.DataBatch(data=[self._mx.nd.array(self._x)])


def _forward(mx, sym, args, x):
    args = dict(args, data=mx.nd.array(x))
    if mx is tmx:
        return sym.bind(CPU, args=args).forward()[0].asnumpy()
    return sym.bind(args=args).forward()[0].asnumpy()


@pytest.mark.parametrize("mode", ["none", "naive", "entropy"])
def test_quantize_model_close_to_fp32(mode):
    """The reference's case on the port, and the two quantized models'
    outputs held to each other (2/127 of max |output|)."""
    from mxnet_tpu.contrib import quantization as jq
    from mxnet_tpu_torch.contrib import quantization as tq
    rs = np.random.RandomState(4)
    x = rs.randn(4, 3, 12, 12).astype(np.float32)
    pnp = _convnet_np(rs)
    outs = {}
    for mx, q in ((jmx, jq), (tmx, tq)):
        sym = _convnet(mx)
        with (CPU if mx is tmx else _nullctx()):
            arg_params = {n: mx.nd.array(v) for n, v in pnp.items()}
            ref = _forward(mx, sym, arg_params, x)
            qsym, qargs, _ = q.quantize_model(
                sym, arg_params, {}, calib_mode=mode,
                calib_data=_OneBatch(mx, x) if mode != "none" else None)
            out = _forward(mx, qsym, qargs, x)
        err = np.abs(out - ref).max() / np.abs(ref).max()
        assert err < 0.05, err
        args = qsym.list_arguments()
        assert "c1_weight_quantized" in args and "c1_weight" not in args
        assert str(qargs["c1_weight_quantized"].dtype) == "int8"
        outs[mx] = (out, args, {n: v.asnumpy() for n, v in qargs.items()})
    (jo, ja, jp), (to, ta, tp) = outs[jmx], outs[tmx]
    assert ja == ta
    for n in jp:
        if jp[n].dtype == np.int8:
            np.testing.assert_array_equal(tp[n], jp[n])
    assert np.abs(to - jo).max() <= 2.0 / 127 * np.abs(jo).max()


class _nullctx:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def test_quantize_symbol_excluded_layers_stay_fp32():
    from mxnet_tpu_torch.contrib.quantization import quantize_symbol
    from mxnet_tpu.contrib.quantization import quantize_symbol as jqs
    qsym, points = quantize_symbol(_convnet(tmx), excluded_sym_names=("c1",))
    args = qsym.list_arguments()
    assert "c1_weight" in args            # untouched
    assert "f1_weight_quantized" in args  # quantized
    jsym, jpoints = jqs(_convnet(jmx), excluded_sym_names=("c1",))
    assert args == jsym.list_arguments()
    assert sorted(points) == sorted(jpoints)


def test_quantized_lenet_accuracy_close_to_fp32():
    """End to end on the port: train fp32 LeNet on synthetic digits
    through Module, quantize with naive calibration, int8 accuracy within
    2 % of fp32 (the reference's case)."""
    import sys
    from mxnet_tpu_torch.contrib.quantization import quantize_model
    sys.path.insert(0, os.path.join(REPO, "examples"))
    from train_mnist import synthetic_mnist

    x, y = synthetic_mnist(1024)
    mx = tmx
    tmx.random.seed(0)
    with CPU:
        it = mx.io.NDArrayIter(data=x, label=y, batch_size=64,
                               label_name="softmax_label")
        data = mx.sym.var("data")
        c1 = mx.sym.Convolution(data=data, kernel=(5, 5), num_filter=8,
                                name="c1")
        t1 = mx.sym.Activation(data=c1, act_type="tanh")
        p1 = mx.sym.Pooling(data=t1, kernel=(2, 2), stride=(2, 2),
                            pool_type="max")
        fl = mx.sym.Flatten(data=p1)
        f1 = mx.sym.FullyConnected(data=fl, num_hidden=10, name="f1")
        net = mx.sym.SoftmaxOutput(data=f1, name="softmax")
        mod = mx.mod.Module(net, context=CPU)
        mod.fit(it, num_epoch=2, initializer=mx.init.Xavier(),
                optimizer_params={"learning_rate": 0.1,
                                  "rescale_grad": 1.0 / 64})
        acc_fp32 = dict(mod.score(it, mx.metric.create("accuracy")))[
            "accuracy"]
        arg_params, aux_params = mod.get_params()
        qsym, qargs, _ = quantize_model(
            f1, arg_params, aux_params, calib_mode="naive",
            calib_data=_OneBatch(mx, x[:256]), num_calib_examples=256,
            ctx=CPU)
        logits = qsym.bind(CPU, args={**qargs, "data": nd.array(x)}) \
            .forward()[0].asnumpy()
    acc_int8 = float((logits.argmax(1) == y).mean())
    assert acc_fp32 > 0.9
    assert acc_int8 >= acc_fp32 - 0.02, (acc_int8, acc_fp32)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_entropy_calibration_clips_outliers():
    """KL calibration chooses a much tighter threshold than the naive max
    when the data holds rare outliers, the same index as the reference's."""
    from mxnet_tpu_torch.contrib.quantization import _kl_optimal_threshold
    from mxnet_tpu.contrib.quantization import _kl_optimal_threshold as jkl
    rs = np.random.RandomState(0)
    vals = np.abs(rs.randn(100000))
    with_outlier = np.concatenate([vals, [100.0]])
    hist, _ = np.histogram(with_outlier, bins=2048, range=(0.0, 100.0))
    i = _kl_optimal_threshold(hist)
    assert i == jkl(hist)
    thr = i / 2048 * 100.0
    assert thr < 20.0, thr          # naive would use 100.0
    assert thr > np.percentile(vals, 99), thr


# -- the cases of tests/test_quant_parity.py, on the port ------------------

def _acc_of(real, m):
    """The int32 accumulator whose symmetric range is +-m (float64 math:
    float32 rounds 2**31-1 up and overflows the cast)."""
    scaled = np.round(np.asarray(real, np.float64) / m * INT32_MAX)
    return np.clip(scaled, -INT32_MAX, INT32_MAX).astype(np.int32)


def test_requantize_without_calib_range():
    m = 3.0
    real = np.array([-2.5, -1.0, 0.0, 0.5, 3.0], np.float32)
    acc = _acc_of(real, m)
    with CPU:
        q, lo, hi = nd._contrib_requantize(nd.array(acc), nd.array(-m),
                                           nd.array(m))
    assert str(q.asnumpy().dtype) == "int8"
    assert float(lo.asnumpy()) == -m and float(hi.asnumpy()) == m
    back = q.asnumpy().astype(np.float32) * m / 127.0
    np.testing.assert_allclose(back, real, atol=m / 127.0)


def test_requantize_with_calib_range_clips():
    m = 4.0
    real = np.array([-3.5, -1.0, 0.0, 1.0, 3.5], np.float32)
    acc = _acc_of(real, m)
    cal = 2.0
    with CPU:
        q, lo, hi = nd._contrib_requantize(
            nd.array(acc), nd.array(-m), nd.array(m),
            min_calib_range=-cal, max_calib_range=cal)
    qv = q.asnumpy()
    assert float(lo.asnumpy()) == -cal and float(hi.asnumpy()) == cal
    assert qv[0] == -127 and qv[-1] == 127          # saturated
    back = qv.astype(np.float32) * cal / 127.0
    np.testing.assert_allclose(back[1:4], real[1:4], atol=cal / 127.0)


def test_requantize_matches_dequantize_scale():
    rs = np.random.RandomState(0)
    m = 1.7
    acc = rs.randint(-2 ** 30, 2 ** 30, 64).astype(np.int32)
    with CPU:
        direct = nd.dequantize(nd.array(acc), nd.array(-m),
                               nd.array(m)).asnumpy()
        q, lo, hi = nd._contrib_requantize(nd.array(acc), nd.array(-m),
                                           nd.array(m))
        two_step = nd.dequantize(q, lo, hi).asnumpy()
    np.testing.assert_allclose(two_step, direct, atol=m / 127.0)


def test_quantize_qfc_requantize_dequantize_chain_close_to_fp32():
    rs = np.random.RandomState(1)
    x = rs.randn(4, 16).astype(np.float32)
    w = (rs.randn(8, 16) * 0.3).astype(np.float32)
    ref = x @ w.T
    mx_, mw = float(np.abs(x).max()), float(np.abs(w).max())
    qw = np.round(w * 127.0 / mw).astype(np.int8)
    mo = float(np.abs(ref).max()) * 1.1
    outs = []
    for mx in (tmx, jmx):
        with (CPU if mx is tmx else _nullctx()):
            qx, xlo, xhi = mx.nd.quantize(mx.nd.array(x), mx.nd.array(-mx_),
                                          mx.nd.array(mx_), out_type="int8")
            acc, alo, ahi = mx.nd.quantized_fc(
                qx, mx.nd.array(qw), xlo, xhi, mx.nd.array(-mw),
                mx.nd.array(mw), num_hidden=8)
            q8, olo, ohi = mx.nd._contrib_requantize(
                acc, alo, ahi, min_calib_range=-mo, max_calib_range=mo)
            outs.append(mx.nd.dequantize(q8, olo, ohi).asnumpy())
    err = np.abs(outs[0] - ref).max() / np.abs(ref).max()
    assert err < 0.03, err
    # the two chains' codes may differ by one (the rounding rule above)
    np.testing.assert_allclose(outs[0], outs[1], rtol=0,
                               atol=mo / 127.0 * (1 + 1e-6))


def test_int32_range_bias_accumulation_bounds():
    rs = np.random.RandomState(2)
    md, mw = 2.0, 0.5
    d = rs.randint(-127, 128, (3, 10)).astype(np.int8)
    w = rs.randint(-127, 128, (5, 10)).astype(np.int8)
    bias = (rs.randn(5) * 0.2).astype(np.float32)
    s_acc = (md / 127.0) * (mw / 127.0)
    bq = np.round(bias / s_acc).astype(np.int32)
    with CPU:
        acc, lo, hi = nd.quantized_fc(
            nd.array(d), nd.array(w), nd.array(-md), nd.array(md),
            nd.array(-mw), nd.array(mw), num_hidden=5)
        acc_b = acc.asnumpy() + bq[None, :]
        real = (d.astype(np.int64) @ w.T.astype(np.int64)) * s_acc + bias
        expected_m = s_acc * INT32_MAX
        np.testing.assert_allclose(float(lo.asnumpy()), -expected_m,
                                   rtol=1e-6)
        np.testing.assert_allclose(float(hi.asnumpy()), expected_m,
                                   rtol=1e-6)
        back = nd.dequantize(nd.array(acc_b), lo, hi).asnumpy()
    np.testing.assert_allclose(back, real, atol=2 * s_acc)


@pytest.mark.parametrize("pool_type", ["max", "avg"])
def test_quantized_pooling_uint8(pool_type):
    rs = np.random.RandomState(3)
    x = rs.randint(0, 256, (1, 2, 4, 4)).astype(np.uint8)
    with CPU:
        out, _, _ = nd.quantized_pooling(
            nd.array(x), nd.array(0.0), nd.array(2.0), kernel=(2, 2),
            stride=(2, 2), pool_type=pool_type)
    ov = out.asnumpy()
    assert str(ov.dtype) == "uint8"
    for i in range(2):
        for j in range(2):
            win = x[0, :, 2 * i:2 * i + 2, 2 * j:2 * j + 2]
            if pool_type == "max":
                exp = win.reshape(2, -1).max(axis=1)
            else:
                exp = np.clip(np.round(
                    win.reshape(2, -1).astype(np.int32).mean(axis=1)),
                    0, 255).astype(np.uint8)
            np.testing.assert_array_equal(ov[0, :, i, j], exp)


@pytest.mark.parametrize("pool_type", ["max", "avg"])
def test_quantized_pooling_int8_negative_values(pool_type):
    x = -np.arange(1, 17, dtype=np.int8).reshape(1, 1, 4, 4)
    with CPU:
        out, _, _ = nd.quantized_pooling(
            nd.array(x), nd.array(-1.0), nd.array(1.0), kernel=(2, 2),
            stride=(2, 2), pool_type=pool_type)
    ov = out.asnumpy()
    assert str(ov.dtype) == "int8"
    assert ov.max() < 0
    if pool_type == "max":
        np.testing.assert_array_equal(ov[0, 0], [[-1, -3], [-9, -11]])


def test_quantized_pooling_global_uint8():
    x = np.arange(32, dtype=np.uint8).reshape(1, 2, 4, 4)
    with CPU:
        out, _, _ = nd.quantized_pooling(
            nd.array(x), nd.array(0.0), nd.array(1.0), pool_type="max",
            global_pool=True)
    np.testing.assert_array_equal(out.asnumpy().ravel(), [15, 31])


@pytest.mark.parametrize("n", [0, 1, 2, 3, 4, 5, 7, 8, 15, 64, 1001])
def test_pack_unpack_2bit_roundtrip_ragged(n):
    rs = np.random.RandomState(n)
    codes = rs.randint(-1, 2, n).astype(np.int8)
    packed, count = pack_2bit(codes)
    assert count == n
    assert len(packed) == (n + 3) // 4
    assert str(packed.dtype) == "uint8"
    np.testing.assert_array_equal(unpack_2bit(packed, count), codes)
    jpacked, jcount = jpack(codes)
    np.testing.assert_array_equal(packed, jpacked)
    np.testing.assert_array_equal(junpack(packed, count), codes)


def test_pack_2bit_accepts_nd_shapes():
    rs = np.random.RandomState(7)
    codes = rs.randint(-1, 2, (3, 5, 2)).astype(np.int8)
    packed, count = pack_2bit(codes)
    np.testing.assert_array_equal(unpack_2bit(packed, count), codes.ravel())
