"""``Deconvolution`` and the transposed convolution layers of the PyTorch
port against the JAX package, on the same numpy inputs.

- The op in every case of ``test_utils.DECONV_CASES`` (1-d, 2-d, 3-d,
  groups, dilation, ``adj`` below the stride and at or past it, with pad
  0 and pad > 0, with and without bias): the output and the gradients of
  every input (``jax.vjp`` against ``torch.autograd``) under the same
  random cotangent, float32, within 1e-5 (output) and 1e-4 of max |g|
  (gradients) of the JAX op's.  ``adj`` >= the stride is a case torch's
  ``conv_transpose`` refuses; the port windows the full transposed
  convolution, and must equal the JAX op there too.
- The shape rule against the JAX package's, and ``infer_shape`` of a
  symbol in both packages.
- ``Conv1DTranspose``, ``Conv2DTranspose`` and ``Conv3DTranspose`` with
  deferred initialization (``in_channels=0``), weights carried by
  ``gluon.load_jax_params``, eager and hybridized, against the JAX
  layers.
- The convolution precision: a float32 Deconvolution runs its forward
  and backward under cuDNN's "ieee" precision, as Convolution does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import mxnet_tpu as jmx
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu.symbol import symbol as jsym

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.gluon import load_jax_params
from mxnet_tpu_torch.ops import registry as treg
from mxnet_tpu_torch.symbol import symbol as tsym
from mxnet_tpu_torch.test_utils import DECONV_CASES, layer_op_cases

TOL_OUT, TOL_GRAD = 1e-5, 1e-4
CASES = [c for c in layer_op_cases() if c["name"] == "Deconvolution"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs files in parallel processes: one intra-op thread a
    # process keeps them from oversubscribing the cores
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol, what, relative_to_max=False):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max()) if relative_to_max else \
        max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, scale)


def test_cases_cover_every_kind():
    ids = [c["id"] for c in CASES]
    assert len(ids) == len(DECONV_CASES) == len(set(ids))
    params = [c["params"] for c in CASES]
    dims = {len(p["kernel"]) for p in params}
    assert dims == {1, 2, 3}
    adj_ge = [p for p in params
              if any(a >= max(s, d) for a, s, d in zip(
                  p.get("adj", (0,) * 3), p.get("stride", (1,) * 3),
                  p.get("dilate", (1,) * 3)))]
    assert {p.get("pad", (0,))[0] > 0 for p in adj_ge} == {True, False}
    assert any(p.get("num_group", 1) > 1 for p in params)
    assert any(max(p.get("dilate", (1,))) > 1 for p in params)
    assert {p["no_bias"] for p in params} == {True, False}


@pytest.mark.parametrize("case", CASES, ids=[c["id"] for c in CASES])
def test_deconvolution_matches_jax(case):
    ins, params = case["inputs"], case["params"]
    jfn = jreg.get_op("Deconvolution").fn
    jout, vjp = jax.vjp(lambda *a: jfn(*a, **params),
                        *[jnp.asarray(a) for a in ins])
    cot = np.random.RandomState(7).standard_normal(jout.shape).astype(
        np.float32)
    jgrads = vjp(jnp.asarray(cot))
    tin = [torch.from_numpy(a).requires_grad_() for a in ins]
    tout = treg.get_op("Deconvolution").fn(*tin, **params)
    _close(tout.detach().numpy(), np.asarray(jout), TOL_OUT, "output")
    tout.backward(torch.from_numpy(cot))
    for i, (t, g) in enumerate(zip(tin, jgrads)):
        _close(t.grad.numpy(), np.asarray(g), TOL_GRAD, "grad %d" % i,
               relative_to_max=True)


@pytest.mark.parametrize("case", CASES, ids=[c["id"] for c in CASES])
def test_shape_rule_matches_jax(case):
    params = case["params"]
    ins = [tuple(a.shape) for a in case["inputs"]]
    blank = [ins[0]] + [None] * (len(ins) - 1)
    got = tsym._SHAPE_RULES["Deconvolution"](params, list(blank))
    want = jsym._SHAPE_RULES["Deconvolution"](params, list(blank))
    assert got == want
    assert [tuple(s) for s in got[0]] == ins
    out = jreg.get_op("Deconvolution").fn(
        *[jnp.asarray(a) for a in case["inputs"]], **params)
    assert tuple(got[1][0]) == out.shape


def test_symbol_infer_shape_matches_jax():
    shapes = []
    for mx in (tmx, jmx):
        x = mx.sym.var("data")
        y = mx.sym.Deconvolution(x, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                                 adj=(3, 2), num_filter=6, num_group=2,
                                 no_bias=False, name="up")
        shapes.append(y.infer_shape(data=(2, 4, 5, 6)))
    assert shapes[0] == shapes[1]
    arg, out, _ = shapes[0]
    assert arg == [(2, 4, 5, 6), (4, 3, 3, 3), (6,)]
    assert out == [(2, 6, 12, 13)]


LAYERS = [
    ("Conv1DTranspose", (2, 3, 7), dict(channels=4, kernel_size=3,
                                        strides=2, padding=1,
                                        output_padding=1)),
    ("Conv2DTranspose", (2, 3, 5, 6), dict(channels=4, kernel_size=4,
                                           strides=2, padding=1,
                                           use_bias=False)),
    ("Conv2DTranspose", (2, 4, 5, 6), dict(channels=6, kernel_size=3,
                                           strides=(2, 1), padding=1,
                                           output_padding=(2, 0),
                                           groups=2, activation="relu")),
    ("Conv3DTranspose", (1, 2, 3, 4, 3), dict(channels=3, kernel_size=2,
                                              strides=2, dilation=(1, 2, 1))),
]


@pytest.mark.parametrize("hybridize", [False, True])
@pytest.mark.parametrize("layer,shape,kwargs", LAYERS,
                         ids=["1d", "2d", "2d-adj-ge-stride-groups", "3d"])
def test_transposed_layers_match_jax(layer, shape, kwargs, hybridize):
    x = np.random.RandomState(3).standard_normal(shape).astype(np.float32)
    jnet = getattr(jmx.gluon.nn, layer)(prefix="up_", **kwargs)
    jnet.initialize(jmx.init.Normal(0.5))
    want = jnet(jmx.nd.array(x)).asnumpy()
    tnet = getattr(tmx.gluon.nn, layer)(prefix="up_", **kwargs)
    assert tnet.weight.shape[0] == 0            # in_channels deferred
    tnet.initialize(ctx=tmx.cpu())
    load_jax_params(tnet, {k: v.data().asnumpy()
                           for k, v in jnet.collect_params().items()})
    assert tnet.weight.shape == jnet.weight.shape
    if hybridize:
        tnet.hybridize()
    xt = tmx.nd.array(x, ctx=tmx.cpu())
    xt.attach_grad()
    with tmx.autograd.record():
        out = tnet(xt)
    out.backward()
    _close(out.asnumpy(), want, TOL_OUT, "output")
    jxs = jmx.nd.array(x)
    jxs.attach_grad()
    with jmx.autograd.record():
        jout = jnet(jxs)
    jout.backward()
    _close(xt.grad.asnumpy(), jxs.grad.asnumpy(), TOL_GRAD, "data grad",
           relative_to_max=True)
    _close(tnet.weight.grad().asnumpy(), jnet.weight.grad().asnumpy(),
           TOL_GRAD, "weight grad", relative_to_max=True)


def test_deferred_layer_infers_its_weight_from_the_first_input():
    net = tmx.gluon.nn.Conv2DTranspose(5, 3, strides=2, output_padding=1,
                                       groups=1)
    net.initialize(ctx=tmx.cpu())
    out = net(tmx.nd.ones((1, 7, 4, 4), ctx=tmx.cpu()))
    assert net.weight.shape == (7, 5, 3, 3)
    assert net.bias.shape == (5,)
    assert out.shape == (1, 5, 10, 10)


class _PrecisionLog(TorchDispatchMode):
    """cuDNN's convolution precision at each aten convolution call."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in (torch.ops.aten.convolution,
                                   torch.ops.aten.convolution_backward):
            self.calls.append((func.overloadpacket.__name__,
                               args[6] if func.overloadpacket is
                               torch.ops.aten.convolution else args[7],
                               torch.backends.cudnn.conv.fp32_precision))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("adj", [(1, 1), (2, 3)], ids=["output_padding",
                                                       "window"])
def test_deconvolution_precision_is_pinned(adj):
    conv = torch.backends.cudnn.conv
    before = conv.fp32_precision
    x = torch.randn(2, 3, 5, 5, requires_grad=True)
    w = torch.randn(3, 4, 3, 3, requires_grad=True)
    b = torch.randn(4, requires_grad=True)
    log = _PrecisionLog()
    try:
        conv.fp32_precision = "tf32"
        with log:
            out = treg.get_op("Deconvolution").fn(
                x, w, b, kernel=(3, 3), stride=(2, 2), adj=adj,
                num_filter=4, no_bias=False)
            out.sum().backward()
        after = conv.fp32_precision
    finally:
        conv.fp32_precision = before
    # (op, transposed, precision): both convolutions transposed, "ieee"
    assert log.calls == [("convolution", True, "ieee"),
                         ("convolution_backward", True, "ieee")]
    assert after == "tf32"
    assert out.shape == (2, 4, 11 + adj[0], 11 + adj[1])
