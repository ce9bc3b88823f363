"""Spatial-transform, correlation, deformable, normalization and signal ops
(port of ``mxnet_tpu/ops/spatial.py``): BilinearSampler, GridGenerator,
SpatialTransformer, Correlation, DeformableConvolution, PSROIPooling,
SyncBatchNorm, fft, ifft, count_sketch, quadratic and index_copy.

The JAX package computes these with XLA, so here they are PyTorch ops.
Samplers are gathers and elementwise arithmetic in the JAX op's order;
the displacement grid of Correlation and the kernel taps of
DeformableConvolution are static Python loops of shifted views, as in the
JAX op.  DeformableConvolution's contraction is a float32 matrix product,
which PyTorch runs in full float32 (``torch.backends.cuda.matmul.
allow_tf32`` is False by default), the JAX package's HIGHEST policy.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .registry import register_op, get_op
from .detection import _clip, _maximum, _seq


# ---------------------------------------------------------------------------
# bilinear sampling
# ---------------------------------------------------------------------------

def _bilinear_sample(img, xs, ys):
    """Sample img (N, C, H, W) at float pixel coordinates xs, ys (N, ...)
    -> (N, C, ...); taps outside the image read zero (the reference
    BilinearSampler's border)."""
    N, C, H, W = img.shape
    x0 = torch.floor(xs)
    y0 = torch.floor(ys)
    x1 = x0 + 1
    y1 = y0 + 1
    wx1 = xs - x0
    wy1 = ys - y0
    nidx = torch.arange(N, device=img.device).reshape(
        (N,) + (1,) * (xs.dim() - 1))
    lead = xs.dim() - 1

    def tap(xi, yi):
        valid = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
        xc = _clip(xi, 0, W - 1).to(torch.int64)
        yc = _clip(yi, 0, H - 1).to(torch.int64)
        v = img[nidx, :, yc, xc]                    # (N, ..., C)
        v = v.permute((0, lead + 1) + tuple(range(1, lead + 1)))
        return v * valid.to(img.dtype)[:, None]

    def w(a):
        return a.to(img.dtype)[:, None]

    return (tap(x0, y0) * w((1 - wy1) * (1 - wx1))
            + tap(x1, y0) * w((1 - wy1) * wx1)
            + tap(x0, y1) * w(wy1 * (1 - wx1))
            + tap(x1, y1) * w(wy1 * wx1))


@register_op("BilinearSampler", input_names=("data", "grid"))
def _bilinear_sampler(data, grid):
    """data (N, C, H, W), grid (N, 2, Ho, Wo) of normalized coordinates in
    [-1, 1], grid[:, 0] x and grid[:, 1] y (reference:
    bilinear_sampler.cc) -> (N, C, Ho, Wo)."""
    N, C, H, W = data.shape
    xs = (grid[:, 0] + 1.0) * (W - 1) / 2.0
    ys = (grid[:, 1] + 1.0) * (H - 1) / 2.0
    return _bilinear_sample(data, xs, ys)


def _linspace(start, stop, num, dtype, device):
    """``jnp.linspace``'s values: start (1 - t) + stop t at t = i / (num -
    1), the last exactly *stop*."""
    if num == 1:
        return torch.full((1,), start, dtype=dtype, device=device)
    div = num - 1
    t = torch.arange(div, dtype=dtype, device=device) / div
    out = start * (1 - t) + stop * t
    return torch.cat([out, torch.full((1,), stop, dtype=dtype,
                                      device=device)])


@register_op("GridGenerator", input_names=("data",))
def _grid_generator(data, transform_type="affine", target_shape=(0, 0)):
    """affine: data (N, 6), a row-major 2 x 3 matrix each -> grid (N, 2,
    H, W); warp: data a flow (N, 2, H, W) in pixels added to the identity
    grid and normalized (reference: grid_generator.cc)."""
    th, tw = (int(v) for v in _seq(target_shape))
    if transform_type == "affine":
        N = data.shape[0]
        f32, dev = torch.float32, data.device
        ys = _linspace(-1.0, 1.0, th, f32, dev)[:, None].expand(th, tw)
        xs = _linspace(-1.0, 1.0, tw, f32, dev)[None, :].expand(th, tw)
        base = torch.stack([xs, ys, torch.ones_like(xs)], 0).reshape(3, -1)
        theta = data.reshape(N, 2, 3)
        return torch.matmul(theta, base.to(theta.dtype)).reshape(N, 2, th, tw)
    N, _, H, W = data.shape
    ys = torch.arange(H, dtype=data.dtype, device=data.device)[:, None]
    xs = torch.arange(W, dtype=data.dtype, device=data.device)[None, :]
    x = xs[None] + data[:, 0]
    y = ys[None] + data[:, 1]
    xn = 2.0 * x / max(W - 1, 1) - 1.0
    yn = 2.0 * y / max(H - 1, 1) - 1.0
    return torch.stack([xn, yn], 1)


@register_op("SpatialTransformer", input_names=("data", "loc"))
def _spatial_transformer(data, loc, target_shape=(0, 0),
                         transform_type="affine",
                         sampler_type="bilinear"):
    """GridGenerator (affine) then BilinearSampler (reference:
    spatial_transformer.cc)."""
    grid = _grid_generator(loc, "affine", target_shape)
    return _bilinear_sampler(data, grid)


# ---------------------------------------------------------------------------
# Correlation
# ---------------------------------------------------------------------------

def _window(x, y0, x0, ny, nx, step):
    """x[:, :, y0 + step * i, x0 + step * j] for i < ny, j < nx."""
    return x[:, :, y0:y0 + step * (ny - 1) + 1:step,
             x0:x0 + step * (nx - 1) + 1:step]


@register_op("Correlation", input_names=("data1", "data2"))
def _correlation(data1, data2, kernel_size=1, max_displacement=1,
                 stride1=1, stride2=1, pad_size=0, is_multiply=True):
    """FlowNet's cost volume (reference: correlation.cc) -> (N, D*D, Ho,
    Wo), D = 2 * (max_displacement // stride2) + 1: each channel the mean
    over the channels and the kernel window of the product (or absolute
    difference) at one displacement."""
    N, C, H, W = data1.shape
    pad = int(pad_size)
    d1 = F.pad(data1, (pad, pad, pad, pad))
    d2 = F.pad(data2, (pad, pad, pad, pad))
    k = int(kernel_size)
    bk = k // 2
    md = int(max_displacement)
    s1, s2 = int(stride1), int(stride2)
    nd = md // s2
    border = bk + md
    Hp, Wp = H + 2 * pad, W + 2 * pad
    ny = len(range(border, Hp - border, s1))
    nx = len(range(border, Wp - border, s1))
    norm = C * k * k
    outs = []
    for dy in range(-nd, nd + 1):
        for dx in range(-nd, nd + 1):
            acc = 0.0
            for ky in range(-bk, bk + 1):
                for kx in range(-bk, bk + 1):
                    p1 = _window(d1, border + ky, border + kx, ny, nx, s1)
                    p2 = _window(d2, border + ky + dy * s2,
                                 border + kx + dx * s2, ny, nx, s1)
                    if is_multiply:
                        acc = acc + (p1 * p2).sum(dim=1)
                    else:
                        acc = acc + (p1 - p2).abs().sum(dim=1)
            outs.append(acc / norm)
    return torch.stack(outs, dim=1)


# ---------------------------------------------------------------------------
# deformable convolution, PSROIPooling
# ---------------------------------------------------------------------------

@register_op("_contrib_DeformableConvolution",
             input_names=("data", "offset", "weight", "bias"),
             aliases=("DeformableConvolution",))
def _deformable_conv(data, offset, weight, bias=None, kernel=(3, 3),
                     stride=(1, 1), pad=(0, 0), dilate=(1, 1),
                     num_filter=0, num_group=1,
                     num_deformable_group=1, no_bias=False):
    """Deformable convolution v1 (reference: deformable_convolution.cc):
    each kernel tap samples the input bilinearly at its place plus a
    learned (dy, dx) offset (N, ndg * kh * kw * 2, Ho, Wo), then one
    matrix product per group applies the weights."""
    N, C, H, W = data.shape
    kh, kw = (int(v) for v in _seq(kernel))
    sh, sw = (int(v) for v in _seq(stride))
    ph, pw = (int(v) for v in _seq(pad))
    dh, dw = (int(v) for v in _seq(dilate))
    Ho = (H + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    Wo = (W + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    ndg = int(num_deformable_group)
    ys = torch.arange(Ho, device=data.device) * sh - ph
    xs = torch.arange(Wo, device=data.device) * sw - pw
    off = offset.reshape(N, ndg, kh * kw, 2, Ho, Wo)
    cpd = C // ndg
    cols = []
    for ki in range(kh):
        for kj in range(kw):
            tap = ki * kw + kj
            planes = []
            for g in range(ndg):
                py = ys[None, :, None] + ki * dh + off[:, g, tap, 0]
                px = xs[None, None, :] + kj * dw + off[:, g, tap, 1]
                planes.append(_bilinear_sample(
                    data[:, g * cpd:(g + 1) * cpd], px, py))
            cols.append(torch.cat(planes, dim=1))
    col = torch.stack(cols, dim=2)                   # (N, C, K, Ho, Wo)
    nf = int(num_filter)
    w = weight.reshape(nf, -1)
    G = int(num_group)
    cpg, fpg = C // G, nf // G
    outs = []
    for g in range(G):
        colg = col[:, g * cpg:(g + 1) * cpg].reshape(N, cpg * kh * kw,
                                                     Ho * Wo)
        outs.append(torch.matmul(w[g * fpg:(g + 1) * fpg], colg))
    out = torch.cat(outs, dim=1).reshape(N, nf, Ho, Wo)
    if bias is not None and not no_bias:
        out = out + bias.reshape(1, -1, 1, 1)
    return out


@register_op("_contrib_PSROIPooling", input_names=("data", "rois"),
             aliases=("PSROIPooling",))
def _psroi_pooling(data, rois, spatial_scale=1.0, output_dim=0,
                   pooled_size=0, group_size=0):
    """Position-sensitive ROI pooling (reference: psroi_pooling.cc,
    R-FCN): output channel c's bin (i, j) averages input channel
    (c * g + gi) * g + gj over the pixels of that bin -> (R, output_dim,
    k, k)."""
    g = int(group_size) if group_size else int(pooled_size)
    k = int(pooled_size)
    od = int(output_dim)
    N, C, H, W = data.shape
    bidx = rois[:, 0].to(torch.int64)
    x1 = torch.round(rois[:, 1]) * spatial_scale
    y1 = torch.round(rois[:, 2]) * spatial_scale
    x2 = (torch.round(rois[:, 3]) + 1.0) * spatial_scale
    y2 = (torch.round(rois[:, 4]) + 1.0) * spatial_scale
    rw = _maximum(x2 - x1, 0.1)
    rh = _maximum(y2 - y1, 0.1)
    bin_h = (rh / k)[:, None, None]
    bin_w = (rw / k)[:, None, None]
    y1, x1 = y1[:, None, None], x1[:, None, None]
    ys = (torch.arange(H, dtype=data.dtype, device=data.device) + 0.5)[
        None, :, None]
    xs = (torch.arange(W, dtype=data.dtype, device=data.device) + 0.5)[
        None, None, :]
    od_idx = torch.arange(od, device=data.device)
    cells = []
    for i in range(k):
        for j in range(k):
            mask = ((ys >= torch.floor(y1 + i * bin_h)) &
                    (ys < torch.ceil(y1 + (i + 1) * bin_h)) &
                    (xs >= torch.floor(x1 + j * bin_w)) &
                    (xs < torch.ceil(x1 + (j + 1) * bin_w)))   # (R, H, W)
            cnt = torch.clamp(mask.sum(dim=(1, 2)), min=1)
            chans = (od_idx * g + i * g // k) * g + j * g // k
            img = data[bidx[:, None], chans[None, :]]          # (R, od, H, W)
            cells.append((img * mask[:, None]).sum(dim=(2, 3)) /
                         cnt[:, None])
    return torch.stack(cells, dim=2).reshape(rois.shape[0], od, k, k)


# ---------------------------------------------------------------------------
# SyncBatchNorm
# ---------------------------------------------------------------------------

@register_op("_contrib_SyncBatchNorm", num_outputs=5,
             num_visible_outputs=1,
             input_names=("data", "gamma", "beta", "moving_mean",
                          "moving_var"),
             aliases=("SyncBatchNorm",))
def _sync_batch_norm(data, gamma, beta, moving_mean, moving_var,
                     eps=1e-3, momentum=0.9, fix_gamma=True,
                     use_global_stats=False, output_mean_var=False,
                     ndev=1, key="", training=True):
    """BatchNorm over the batch one device holds (reference:
    sync_batch_norm.cc, which all-reduces the moments across devices).
    As in the JAX op, the batch statistics of the one program are the
    synchronized ones; ``ndev`` and ``key`` are kept for the contract."""
    from .nn import _batch_norm
    return _batch_norm(data, gamma, beta, moving_mean, moving_var,
                       eps=eps, momentum=momentum, fix_gamma=fix_gamma,
                       use_global_stats=use_global_stats,
                       output_mean_var=output_mean_var, axis=1,
                       training=training)


# moving statistics are mutable auxiliary states, as BatchNorm's
get_op("_contrib_SyncBatchNorm").aux_states = {3: 3, 4: 4}


# ---------------------------------------------------------------------------
# fft, ifft, count_sketch, quadratic, index_copy
# ---------------------------------------------------------------------------

@register_op("_contrib_fft", aliases=("fft",))
def _fft(data, compute_size=128):
    """FFT over the last axis, output interleaved [re, im] pairs (..., 2n)
    (reference: fft.cc's layout)."""
    f = torch.fft.fft(data.to(torch.complex64), dim=-1)
    out = torch.stack([f.real, f.imag], dim=-1)
    return out.reshape(tuple(data.shape[:-1]) + (2 * data.shape[-1],)) \
        .to(torch.float32)


@register_op("_contrib_ifft", aliases=("ifft",))
def _ifft(data, compute_size=128):
    """Inverse of fft: interleaved (..., 2n) -> real (..., n), scaled by n
    (the reference's unnormalized cuFFT inverse)."""
    n = data.shape[-1] // 2
    pairs = data.reshape(tuple(data.shape[:-1]) + (n, 2)).to(torch.float32)
    comp = torch.complex(pairs[..., 0], pairs[..., 1])
    return torch.fft.ifft(comp, dim=-1).real.to(torch.float32) * n


@register_op("_contrib_count_sketch", input_names=("data", "h", "s"),
             aliases=("count_sketch",))
def _count_sketch(data, h, s, out_dim=0, processing_batch_size=32):
    """Count sketch (reference: count_sketch.cc): out[..., h[j]] += s[j] *
    data[..., j]."""
    idx = h.reshape(-1).to(torch.int64)
    sign = s.reshape(-1).to(data.dtype)
    out = torch.zeros(tuple(data.shape[:-1]) + (int(out_dim),),
                      dtype=data.dtype, device=data.device)
    return out.index_add(-1, idx, data * sign)


@register_op("_contrib_quadratic", aliases=("quadratic",))
def _quadratic(data, a=0.0, b=0.0, c=0.0):
    """a x^2 + b x + c elementwise (reference: quadratic_op-inl.h)."""
    return a * data * data + b * data + c


@register_op("_contrib_index_copy", input_names=("old", "idx", "new"))
def _index_copy(old, idx, new):
    """Rows of *new* written into *old* at *idx* (reference:
    index_copy.cc).  As in the JAX op, a negative index counts from the
    end and an index outside the rows is dropped (no write), where the
    reference raises: the write goes to a spare row past the end, which
    is cut off, so nothing is read back to the host."""
    n = old.shape[0]
    i = idx.reshape(-1).to(torch.int64)
    i = torch.where(i < 0, i + n, i)
    i = torch.where((i >= 0) & (i < n), i, n)
    spare = torch.cat([old, old.new_zeros((1,) + tuple(old.shape[1:]))])
    return spare.index_copy(0, i, new.to(old.dtype))[:n]
