"""The spatial ops of the PyTorch port and ROIPooling against the JAX
package, on the same numpy inputs: the 19 names of ``ops/spatial.py``
(BilinearSampler, GridGenerator, SpatialTransformer, Correlation,
DeformableConvolution, PSROIPooling, SyncBatchNorm, fft, ifft,
count_sketch, quadratic, index_copy and their ``_contrib_`` names) over
``test_utils.detection_op_cases``, then the cases of
``tests/test_spatial_ops.py`` mirrored.

Tolerances (float32): outputs within 1e-5 of max(1, max |JAX|), the
gradients of every input a case names (``jax.vjp`` against
``torch.autograd``, the same random cotangents) within 1e-4 of max |g|.
``tests/test_spatial_ops.py::test_bilinear_sampler_gradient`` needs
``enable_x64``, which jax 0.9.0 lacks, so the sampler's gradient is held
against ``jax.vjp`` here and against ``torch.autograd.gradcheck`` in f64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import registry as jreg

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.ops import registry as treg
from mxnet_tpu_torch.test_utils import SPATIAL_NAMES, detection_op_cases

from test_torch_detection import check_case

NAMES = SPATIAL_NAMES + ("ROIPooling",)
CASES = [c for c in detection_op_cases() if c["name"] in NAMES]
RS = np.random.RandomState


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs files in parallel processes: one intra-op thread a
    # process keeps them from oversubscribing the cores
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_cases_cover_the_twenty_names():
    assert {c["name"] for c in CASES} == set(NAMES)
    assert len(NAMES) == 20
    assert set(NAMES) <= set(treg.list_ops())


@pytest.mark.parametrize("name", NAMES)
def test_contract_matches_jax(name):
    jop, top = jreg.get_op(name), treg.get_op(name)
    assert top.name == jop.name
    assert top.input_names == jop.input_names
    assert top.param_names == jop.param_names
    assert top.aux_states == jop.aux_states
    assert top.n_out({}) == jop.n_out({})
    assert top.n_visible({}) == jop.n_visible({})


@pytest.mark.parametrize("case", CASES, ids=[c["id"] for c in CASES])
def test_spatial_op_matches_jax(case):
    check_case(case)


# -- the cases of tests/test_spatial_ops.py -----------------------------------

def _nd(x):
    return tmx.nd.array(x, ctx=tmx.cpu())


def _identity_grid(N, H, W):
    ys, xs = np.meshgrid(np.linspace(-1, 1, H), np.linspace(-1, 1, W),
                         indexing="ij")
    return np.stack([np.broadcast_to(xs, (N, H, W)),
                     np.broadcast_to(ys, (N, H, W))], 1).astype(np.float32)


def test_bilinear_sampler_identity_and_shift():
    x = RS(0).randn(2, 3, 5, 6).astype(np.float32)
    grid = _identity_grid(2, 5, 6)
    out = tmx.nd.BilinearSampler(_nd(x), _nd(grid)).asnumpy()
    np.testing.assert_allclose(out, x, rtol=1e-4, atol=1e-5)
    shift = grid.copy()
    shift[:, 0] -= 2.0 / (6 - 1)
    out = tmx.nd.BilinearSampler(_nd(x), _nd(shift)).asnumpy()
    np.testing.assert_allclose(out[..., 1:], x[..., :-1], rtol=1e-3,
                               atol=1e-4)


def test_bilinear_sampler_gradcheck_f64():
    """The gradient the reference's finite-difference test checks, here
    by ``torch.autograd.gradcheck`` in f64 away from the kinks."""
    rs = RS(1)
    data = torch.from_numpy(rs.randn(1, 2, 4, 4) * 0.5).requires_grad_()
    grid = torch.from_numpy(rs.uniform(-0.8, 0.8, (1, 2, 3, 3))) \
        .requires_grad_()
    fn = treg.get_op("BilinearSampler").fn
    assert torch.autograd.gradcheck(fn, (data, grid), eps=1e-6, atol=1e-5)


def test_grid_generator_warp_and_transformer_zoom():
    g = tmx.nd.GridGenerator(_nd(np.zeros((1, 2, 4, 5), np.float32)),
                             transform_type="warp").asnumpy()
    np.testing.assert_allclose(g, _identity_grid(1, 4, 5), rtol=1e-5,
                               atol=1e-6)
    x = RS(2).randn(1, 1, 8, 8).astype(np.float32)
    theta = np.array([[0.5, 0, 0, 0, 0.5, 0]], np.float32)
    out = tmx.nd.SpatialTransformer(_nd(x), _nd(theta),
                                    target_shape=(8, 8)).asnumpy()
    assert out.shape == (1, 1, 8, 8)
    np.testing.assert_allclose(out[0, 0, 4, 4], x[0, 0, 4, 4], rtol=0.2,
                               atol=0.3)


def test_correlation_zero_displacement_is_self_energy():
    x = RS(3).randn(2, 4, 5, 5).astype(np.float32)
    c = tmx.nd.Correlation(_nd(x), _nd(x), kernel_size=1,
                           max_displacement=1, pad_size=1).asnumpy()
    assert c.shape == (2, 9, 5, 5)
    np.testing.assert_allclose(c[:, 4], (x * x).mean(1), rtol=1e-4,
                               atol=1e-5)


def test_deformable_conv_zero_and_integer_offsets():
    rs = RS(4)
    x = rs.randn(2, 3, 6, 6).astype(np.float32)
    w = rs.randn(4, 3, 3, 3).astype(np.float32) * 0.2
    dc = tmx.nd.DeformableConvolution(
        _nd(x), _nd(np.zeros((2, 18, 6, 6), np.float32)), _nd(w), None,
        kernel=(3, 3), pad=(1, 1), num_filter=4, no_bias=True).asnumpy()
    ref = tmx.nd.Convolution(_nd(x), _nd(w), kernel=(3, 3), pad=(1, 1),
                             num_filter=4, no_bias=True).asnumpy()
    np.testing.assert_allclose(dc, ref, rtol=1e-3, atol=1e-4)
    x = RS(5).randn(1, 1, 6, 6).astype(np.float32)
    w = RS(5).randn(1, 1, 1, 1).astype(np.float32)
    off = np.zeros((1, 2, 6, 6), np.float32)
    off[:, 1] = 1.0
    dc = tmx.nd.DeformableConvolution(
        _nd(x), _nd(off), _nd(w), None, kernel=(1, 1), num_filter=1,
        no_bias=True).asnumpy()
    expected = np.zeros_like(x)
    expected[..., :-1] = x[..., 1:] * w[0, 0, 0, 0]
    np.testing.assert_allclose(dc, expected, rtol=1e-4, atol=1e-5)


def test_psroi_pooling_bins():
    data = RS(6).randn(1, 8, 6, 6).astype(np.float32)
    out = tmx.nd.PSROIPooling(_nd(data), _nd(np.array([[0, 0, 0, 5, 5]],
                                                      np.float32)),
                              spatial_scale=1.0, output_dim=2,
                              pooled_size=2, group_size=2).asnumpy()
    assert out.shape == (1, 2, 2, 2)
    np.testing.assert_allclose(out[0, 0, 0, 0], data[0, 0, :3, :3].mean(),
                               rtol=1e-4)
    np.testing.assert_allclose(out[0, 1, 0, 1], data[0, 5, :3, 3:].mean(),
                               rtol=1e-4)


def test_sync_batch_norm_is_batch_norm_and_updates_moving_stats():
    rs = RS(7)
    x = rs.randn(4, 3, 2, 2).astype(np.float32)
    g = (np.abs(rs.randn(3)) + 0.5).astype(np.float32)
    b = rs.randn(3).astype(np.float32)
    args = [_nd(x), _nd(g), _nd(b), _nd(np.zeros(3, np.float32)),
            _nd(np.ones(3, np.float32))]
    sb = tmx.nd.SyncBatchNorm(*args, fix_gamma=False, training=True)
    bn = tmx.nd.BatchNorm(*args, fix_gamma=False, training=True)
    np.testing.assert_array_equal(sb.asnumpy(), bn.asnumpy())
    # a symbol's moving statistics are aux states the executor writes back
    data = tmx.sym.var("data")
    net = tmx.sym.contrib.SyncBatchNorm(data, fix_gamma=False, name="sbn")
    assert net.list_auxiliary_states() == ["sbn_moving_mean",
                                           "sbn_moving_var"]


def test_fft_count_sketch_index_copy():
    d = RS(8).randn(3, 8).astype(np.float32)
    f = tmx.nd.fft(_nd(d)).asnumpy()
    ref = np.fft.fft(d, axis=-1)
    np.testing.assert_allclose(f[:, 0::2], ref.real, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(f[:, 1::2], ref.imag, rtol=1e-3, atol=1e-4)
    back = tmx.nd.ifft(_nd(f)).asnumpy() / 8.0
    np.testing.assert_allclose(back, d, rtol=1e-4, atol=1e-5)
    d = RS(9).randn(2, 6).astype(np.float32)
    h = np.array([0, 2, 1, 2, 0, 1], np.float32)
    s = np.array([1, -1, 1, 1, -1, 1], np.float32)
    out = tmx.nd.count_sketch(_nd(d), _nd(h), _nd(s), out_dim=3).asnumpy()
    exp = np.zeros((2, 3), np.float32)
    for j in range(6):
        exp[:, int(h[j])] += s[j] * d[:, j]
    np.testing.assert_allclose(out, exp, rtol=1e-5)
    old = np.zeros((4, 2), np.float32)
    new = np.arange(1, 7, dtype=np.float32).reshape(3, 2)
    got = tmx.nd.contrib.index_copy(_nd(old), _nd(np.array([-1, 5, 1],
                                                           np.float32)),
                                    _nd(new)).asnumpy()
    want = np.asarray(jreg.get_op("_contrib_index_copy").fn(
        jnp.asarray(old), jnp.asarray([-1.0, 5.0, 1.0]), jnp.asarray(new)))
    np.testing.assert_array_equal(got, want)


def test_roi_pooling_empty_bin_and_ties():
    """An ROI past the map's edge pools empty bins to 0, and a bin whose
    maximum ties shares the gradient, in both packages."""
    data = np.zeros((1, 1, 4, 4), np.float32)
    data[0, 0, 1, 1] = data[0, 0, 1, 2] = 2.0
    rois = np.array([[0, 0, 0, 3, 3], [0, 5, 5, 9, 9]], np.float32)
    jout, vjp = jax.vjp(lambda d: jreg.get_op("ROIPooling").fn(
        d, jnp.asarray(rois), pooled_size=(2, 2)), jnp.asarray(data))
    t = torch.from_numpy(data).requires_grad_()
    tout = treg.get_op("ROIPooling").fn(t, torch.from_numpy(rois),
                                        pooled_size=(2, 2))
    np.testing.assert_array_equal(tout.detach().numpy(), np.asarray(jout))
    assert (tout[1] == 0).all()
    cot = np.ones(jout.shape, np.float32)
    tout.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(t.grad.numpy(),
                               np.asarray(vjp(jnp.asarray(cot))[0]),
                               atol=1e-6)
