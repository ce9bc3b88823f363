"""Neural-network ops (port of ``mxnet_tpu/ops/nn.py``, less Custom and
MoEFFN): FullyConnected, Convolution, Deconvolution, Pooling, ROIPooling,
Activation, BatchNorm, LayerNorm, InstanceNorm, LRN, Dropout, softmax,
log_softmax, softmin, SoftmaxActivation, UpSampling, the contrib
BilinearResize2D, AdaptiveAvgPooling2D and div_sqrt_dim, the losses
softmax_cross_entropy and CTCLoss, the loss heads SoftmaxOutput,
LinearRegressionOutput, MAERegressionOutput, LogisticRegressionOutput,
BlockGrad and make_loss, and the ``*_v1`` spellings.

Matrix products and convolutions stay with PyTorch (cuBLAS and cuDNN on
the card), as the JAX package left them to XLA.  A float32 contraction
runs in full float32, the JAX package's ``Precision.HIGHEST`` policy for
float32 (``mxnet_tpu/ops/_precision.py``); bfloat16 and float16 take the
fast path.  For products, ``torch.backends.cuda.matmul.allow_tf32`` is
False by default, which is that policy already.  cuDNN runs a float32
convolution in TF32 by default (``torch.backends.cudnn.conv.
fp32_precision`` is "tf32"), so ``Convolution`` sets cuDNN's convolution
precision itself, in its forward and in both backward convolutions (see
``_Convolution``).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from ..runtime import rng as _rng
from .registry import register_op, get_op, alias


@register_op("FullyConnected", input_names=("data", "weight", "bias"))
def _fully_connected(data, weight, *rest, num_hidden=0, no_bias=False,
                     flatten=True):
    if flatten and data.dim() > 2:
        data = data.reshape(data.shape[0], -1)
    # weight: (num_hidden, in_units), contracted on in_units
    out = torch.matmul(data, weight.t())
    if not no_bias and rest:
        out = out + rest[0]
    return out


def _bias_inputs(params):
    if params.get("no_bias", False):
        return ("data", "weight")
    return ("data", "weight", "bias")


get_op("FullyConnected").active_inputs = _bias_inputs


def _tup(v, nd, default):
    """An op's per-axis parameter as an *nd*-tuple: empty or None means
    *default* on every axis, an int is repeated (symbol JSON written by
    the JAX package spells a one-element tuple "(3)", which parses as
    the int 3)."""
    if v is None or (isinstance(v, (tuple, list)) and len(v) == 0):
        return (default,) * nd
    if isinstance(v, int):
        return (v,) * nd
    return tuple(v)


# -- Convolution -------------------------------------------------------------

@contextlib.contextmanager
def _cudnn_conv_precision(precision):
    """cuDNN's float32 convolution precision ("ieee" or "tf32") for the
    calls inside; None leaves it as it is.  The setting is the process's
    (``torch.backends.cudnn.conv.fp32_precision``) and is restored on
    exit."""
    if precision is None:
        yield
        return
    conv = torch.backends.cudnn.conv
    prev = conv.fp32_precision
    conv.fp32_precision = precision
    try:
        yield
    finally:
        conv.fp32_precision = prev


class _Convolution(torch.autograd.Function):
    """A convolution whose forward and backward each run under one cuDNN
    precision.

    The f32 setting chosen for the port is this Function, not a
    package-level flag: a ``cudnn.flags(...)`` block around the forward
    call would not reach the backward convolutions, which autograd runs
    later (on its own device thread), and a flag set when the package is
    imported would change every other convolution of the process.  So
    the forward sets *precision* around ``aten.convolution`` and the
    backward sets it again around ``aten.convolution_backward``, which
    computes the data and weight gradients (and the bias's).  With
    *transposed* it is the transposed convolution (``Deconvolution``),
    weight (C_in, C_out / groups, *kernel), grown by *output_padding* on
    the high side of each axis."""

    @staticmethod
    def forward(ctx, data, weight, bias, stride, pad, dilate, groups,
                precision, transposed=False, output_padding=None):
        out_pad = output_padding or [0] * len(stride)
        with _cudnn_conv_precision(precision):
            out = torch.ops.aten.convolution(
                data, weight, bias, stride, pad, dilate, transposed,
                out_pad, groups)
        ctx.save_for_backward(data, weight)
        ctx.conf = (stride, pad, dilate, groups, precision,
                    None if bias is None else list(bias.shape), transposed,
                    out_pad)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        data, weight = ctx.saved_tensors
        (stride, pad, dilate, groups, precision, bias_shape, transposed,
         out_pad) = ctx.conf
        need = ctx.needs_input_grad
        with _cudnn_conv_precision(precision):
            gdata, gweight, gbias = torch.ops.aten.convolution_backward(
                dout, data, weight, bias_shape, stride, pad, dilate,
                transposed, out_pad, groups,
                [need[0], need[1], bias_shape is not None and need[2]])
        return gdata, gweight, gbias, None, None, None, None, None, None, \
            None


def conv_precision(dtype):
    """The cuDNN precision a convolution of *dtype* runs at: full float32
    ("ieee") for float32, the default fast path otherwise (None)."""
    return "ieee" if dtype == torch.float32 else None


@register_op("Convolution", input_names=("data", "weight", "bias"))
def _convolution(data, weight, *rest, kernel=(), stride=(), dilate=(),
                 pad=(), num_filter=0, num_group=1, workspace=1024,
                 no_bias=False, cudnn_tune=None, cudnn_off=False,
                 layout=None):
    """N-d convolution, NC + spatial layout, weight (num_filter,
    C / num_group, *kernel)."""
    nd = data.dim() - 2
    bias = rest[0] if rest and not no_bias else None
    return _Convolution.apply(
        data, weight, bias, list(_tup(stride, nd, 1)),
        list(_tup(pad, nd, 0)), list(_tup(dilate, nd, 1)), int(num_group),
        conv_precision(data.dtype))


get_op("Convolution").active_inputs = _bias_inputs


@register_op("Deconvolution", input_names=("data", "weight", "bias"))
def _deconvolution(data, weight, *rest, kernel=(), stride=(), dilate=(),
                   pad=(), adj=(), target_shape=(), num_filter=0,
                   num_group=1, workspace=1024, no_bias=True,
                   cudnn_tune=None, cudnn_off=False, layout=None):
    """N-d transposed convolution, weight (C_in, num_filter / num_group,
    *kernel).  Each spatial extent is (in - 1) * stride - 2 * pad +
    dilate * (kernel - 1) + 1 + adj; *target_shape* is ignored, as in the
    JAX package.  Torch takes ``output_padding`` only below the stride or
    the dilation; a larger *adj* runs the full transposed convolution
    (pad 0) and takes the window [pad, pad + out) of each axis, zeros
    past the full result's end, before the bias is added."""
    nd = data.dim() - 2
    kernel = tuple(weight.shape[2:])
    stride = list(_tup(stride, nd, 1))
    dilate = list(_tup(dilate, nd, 1))
    pad = list(_tup(pad, nd, 0))
    adj = list(_tup(adj, nd, 0))
    bias = rest[0] if rest and not no_bias else None
    prec = conv_precision(data.dtype)
    if all(a < max(s, d) for a, s, d in zip(adj, stride, dilate)):
        return _Convolution.apply(data, weight, bias, stride, pad, dilate,
                                  int(num_group), prec, True, adj)
    full = _Convolution.apply(data, weight, None, stride, [0] * nd, dilate,
                              int(num_group), prec, True, None)
    # F.pad takes (lo, hi) pairs from the last axis back; a negative
    # amount crops
    window = []
    for i in reversed(range(nd)):
        eff_k = (kernel[i] - 1) * dilate[i] + 1
        size = (data.shape[2 + i] - 1) * stride[i] + eff_k
        out = size - 2 * pad[i] + adj[i]
        window += [-pad[i], out + pad[i] - size]
    out = F.pad(full, window)
    if bias is not None:
        out = out + bias.reshape((1, -1) + (1,) * nd)
    return out


def _deconv_inputs(params):
    if params.get("no_bias", True):
        return ("data", "weight")
    return ("data", "weight", "bias")


get_op("Deconvolution").active_inputs = _deconv_inputs


# -- Pooling -----------------------------------------------------------------

_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}


def _window_sum(x, kernel, stride):
    """Sum of each window (no padding), accumulated in float32 for a
    16-bit input."""
    n = 1
    for k in kernel:
        n *= k
    xf = x.float() if x.dtype in (torch.bfloat16, torch.float16) else x
    return _AVG_POOL[len(kernel)](xf, kernel, stride) * n


@register_op("Pooling")
def _pooling(data, kernel=(), pool_type="max", global_pool=False,
             cudnn_off=False, pooling_convention="valid", stride=(),
             pad=(), p_value=2, count_include_pad=True):
    """Max, avg, sum or lp pooling over the spatial axes of NC + spatial
    data.  As in the JAX package, the input is padded explicitly (-inf
    for max, 0 otherwise) and then pooled without padding: "full" adds
    ``stride - rem`` on the high side so the last window fits, and avg
    divides by the whole kernel (``count_include_pad``) or by the count
    of real elements in the window.  Torch's ``ceil_mode`` and its
    ``count_include_pad`` are not these (they drop a last window that
    starts in the padding and clip the divisor to the padded size), so
    neither is used."""
    nd = data.dim() - 2
    if global_pool:
        axes = tuple(range(2, data.dim()))
        if pool_type == "max":
            return data.amax(dim=axes, keepdim=True)
        if pool_type in ("avg", "sum"):
            r = data.sum(dim=axes, keepdim=True)
            if pool_type == "avg":
                cnt = 1
                for a in axes:
                    cnt *= data.shape[a]
                r = r / cnt
            return r
        if pool_type == "lp":
            return data.abs().pow(p_value).sum(dim=axes, keepdim=True) \
                .pow(1.0 / p_value)
        raise ValueError("unknown pool_type %r" % pool_type)
    kernel = _tup(kernel, nd, 1)
    stride = _tup(stride, nd, 1)
    pad = _tup(pad, nd, 0)
    pads = []
    for i in range(nd):
        hi = pad[i]
        if pooling_convention == "full":
            rem = (data.shape[2 + i] + 2 * pad[i] - kernel[i]) % stride[i]
            if rem:
                hi += stride[i] - rem
        pads.append((pad[i], hi))
    # F.pad takes (lo, hi) pairs from the last axis back
    flat = [p for lo_hi in reversed(pads) for p in lo_hi]
    padded = any(flat)
    if pool_type == "max":
        fill = float("-inf") if data.is_floating_point() else \
            torch.iinfo(data.dtype).min
        x = F.pad(data, flat, value=fill) if padded else data
        return _MAX_POOL[nd](x, kernel, stride)
    if pool_type not in ("avg", "sum", "lp"):
        raise ValueError("unknown pool_type %r" % pool_type)
    x = data.abs().pow(p_value) if pool_type == "lp" else data
    s = _window_sum(F.pad(x, flat) if padded else x, kernel, stride)
    if pool_type == "avg":
        if count_include_pad or not padded:
            n = 1
            for k in kernel:
                n *= k
            s = s / n
        else:
            ones = torch.ones((1, 1) + tuple(data.shape[2:]),
                              dtype=s.dtype, device=data.device)
            s = s / _window_sum(F.pad(ones, flat), kernel, stride)
    elif pool_type == "lp":
        s = s.pow(1.0 / p_value)
    return s.to(data.dtype)


_ACTS = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "softrelu": F.softplus,
    "softsign": F.softsign,
    "gelu": F.gelu,
    "swish": F.silu,
}


@register_op("ROIPooling")
def _roi_pooling(data, rois, pooled_size=(), spatial_scale=1.0):
    """Max pool each scaled ROI (R, 5) [batch_idx, x1, y1, x2, y2] of data
    (N, C, H, W) to a (ph, pw) grid -> (R, C, ph, pw); an empty bin reads
    0 (reference: roi_pooling-inl.h).  Every bin is a masked max over the
    whole map, as in the JAX op, so ties share the gradient (``amax``)."""
    ph, pw = (int(v) for v in pooled_size)
    H, W = data.shape[2], data.shape[3]
    dev = data.device
    bidx = rois[:, 0].to(torch.int64)
    x1, y1, x2, y2 = (torch.round(rois[:, i] * spatial_scale).to(torch.int64)
                      for i in range(1, 5))
    rh = torch.clamp(y2 - y1 + 1, min=1)[:, None]
    rw = torch.clamp(x2 - x1 + 1, min=1)[:, None]
    iy = torch.arange(ph, device=dev)[None, :]
    ix = torch.arange(pw, device=dev)[None, :]
    hstart = y1[:, None] + torch.div(iy * rh, ph, rounding_mode="floor")
    hend = y1[:, None] + torch.div((iy + 1) * rh + ph - 1, ph,
                                   rounding_mode="floor")
    wstart = x1[:, None] + torch.div(ix * rw, pw, rounding_mode="floor")
    wend = x1[:, None] + torch.div((ix + 1) * rw + pw - 1, pw,
                                   rounding_mode="floor")
    ys = torch.arange(H, device=dev)
    xs = torch.arange(W, device=dev)
    in_y = (ys >= hstart[..., None]) & (ys < hend[..., None])    # (R, ph, H)
    in_x = (xs >= wstart[..., None]) & (xs < wend[..., None])    # (R, pw, W)
    mask = in_y[:, :, None, :, None] & in_x[:, None, :, None, :]
    img = data[bidx][:, :, None, None]                       # (R, C, 1, 1, H, W)
    v = torch.where(mask[:, None], img, float("-inf")).amax(dim=(4, 5))
    return torch.where(torch.isfinite(v), v, 0.0)


@register_op("Activation")
def _activation(x, act_type="relu"):
    try:
        fn = _ACTS[act_type]
    except KeyError:
        raise ValueError("unknown act_type %r" % act_type)
    return fn(x)


# -- BatchNorm ---------------------------------------------------------------

def _stat_dtype(dtype):
    """Statistics run in float32 for a 16-bit input (float64 for float64)."""
    return torch.promote_types(dtype, torch.float32)


def _bshape(data, ax):
    shape = [1] * data.dim()
    shape[ax] = data.shape[ax]
    return shape


class _BatchNormTrain(torch.autograd.Function):
    """Training-mode batch normalization over every axis but *ax*:
    returns (out, batch mean, biased batch variance), the statistics in
    float32 (float64 for float64 data) and *out* in the data's dtype.

    The backward is written by hand so that the activation is the only
    full-size tensor kept for it (autograd over the composed forward
    would keep three).  It carries the gradient through the batch mean
    and variance, as ``jax.vjp`` of the JAX package's op does: for
    xmu = x - mean, inv = 1/sqrt(var + eps) and n elements a channel,
    dx = gamma inv (dy - sum(dy)/n - xmu inv^2 sum(dy xmu)/n), plus
    dmean/n + 2 dvar xmu/n where the statistics outputs get gradients."""

    @staticmethod
    def forward(ctx, data, gamma, beta, ax, eps):
        ctx.set_materialize_grads(False)
        stat = _stat_dtype(data.dtype)
        red = tuple(i for i in range(data.dim()) if i != ax)
        bshape = _bshape(data, ax)
        x = data.to(stat)
        var, mean = torch.var_mean(x, dim=red, correction=0)
        inv = torch.rsqrt(var + eps)
        scale = inv * gamma.to(stat)
        out = torch.addcmul(beta.to(stat).reshape(bshape),
                            x - mean.reshape(bshape), scale.reshape(bshape))
        ctx.save_for_backward(data, mean, inv, gamma)
        ctx.ax = ax
        return out.to(data.dtype), mean, var

    @staticmethod
    @once_differentiable
    def backward(ctx, dout, dmean, dvar):
        data, mean, inv, gamma = ctx.saved_tensors
        ax = ctx.ax
        stat = mean.dtype
        red = tuple(i for i in range(data.dim()) if i != ax)
        bshape = _bshape(data, ax)
        n = data.numel() // max(data.shape[ax], 1)
        xmu = data.to(stat) - mean.reshape(bshape)
        dx = dgamma = dbeta = None
        if dout is not None:
            dy = dout.to(stat)
            sum_dy = dy.sum(dim=red)
            sum_dy_xmu = (dy * xmu).sum(dim=red)
            k = inv * inv * sum_dy_xmu / n
            dx = torch.addcmul(dy - (sum_dy / n).reshape(bshape), xmu,
                               k.reshape(bshape), value=-1.0)
            dx.mul_((inv * gamma.to(stat)).reshape(bshape))
            dgamma = (sum_dy_xmu * inv).to(gamma.dtype)
            dbeta = sum_dy.to(gamma.dtype)
        if dmean is not None or dvar is not None:
            if dx is None:
                dx = torch.zeros_like(xmu)
            if dmean is not None:
                dx.add_((dmean / n).reshape(bshape))
            if dvar is not None:
                dx.addcmul_(xmu, (2.0 * dvar / n).reshape(bshape))
        if dx is not None:
            dx = dx.to(data.dtype)
        return dx, dgamma, dbeta, None, None


@register_op("BatchNorm", num_outputs=5, num_visible_outputs=1)
def _batch_norm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
                momentum=0.9, fix_gamma=True, use_global_stats=False,
                output_mean_var=False, axis=1, cudnn_off=False,
                training=True):
    """Returns (out, batch_mean, batch_var, new_moving_mean,
    new_moving_var).  In training (and not ``use_global_stats``) the
    batch's mean and *biased* variance normalize, and the moving
    statistics move as ``moving * momentum + batch * (1 - momentum)``;
    otherwise the moving statistics normalize and come back unchanged.
    ``fix_gamma`` scales by one.  The statistics are computed here, not
    by ``torch.nn.functional.batch_norm``, whose running variance is the
    unbiased one and whose momentum weighs the other way."""
    ax = axis % data.dim()
    bshape = _bshape(data, ax)
    if fix_gamma:
        gamma = torch.ones_like(gamma)
    if training and not use_global_stats:
        out, mean, var = _BatchNormTrain.apply(data, gamma, beta, ax, eps)
        mean = mean.to(moving_mean.dtype)
        var = var.to(moving_var.dtype)
        new_mm = moving_mean * momentum + mean * (1 - momentum)
        new_mv = moving_var * momentum + var * (1 - momentum)
        return out, mean, var, new_mm, new_mv
    stat = _stat_dtype(data.dtype)
    scale = torch.rsqrt(moving_var.to(stat) + eps) * gamma.to(stat)
    out = torch.addcmul(beta.to(stat).reshape(bshape),
                        data.to(stat) - moving_mean.to(stat).reshape(bshape),
                        scale.reshape(bshape))
    return out.to(data.dtype), moving_mean, moving_var, moving_mean, \
        moving_var


# moving_mean, moving_var are mutable auxiliary states -> outputs 3, 4
get_op("BatchNorm").aux_states = {3: 3, 4: 4}


@register_op("LayerNorm", num_outputs=3,
             num_visible_outputs=lambda p: 3 if p.get("output_mean_var")
             else 1)
def _layer_norm(data, gamma, beta, axis=-1, eps=1e-5, output_mean_var=False):
    mean = data.mean(dim=axis, keepdim=True)
    var = data.var(dim=axis, keepdim=True, unbiased=False)
    inv = torch.rsqrt(var + eps)
    bshape = [1] * data.dim()
    bshape[axis % data.dim()] = data.shape[axis % data.dim()]
    out = (data - mean) * inv * gamma.reshape(bshape) + beta.reshape(bshape)
    return out, mean.squeeze(axis), var.squeeze(axis)


def _temper(x, temperature):
    if temperature is not None and temperature != 1.0:
        x = x / temperature
    return x


@register_op("softmax")
def _softmax(x, axis=-1, temperature=None, length=None):
    return torch.softmax(_temper(x, temperature), dim=axis)


@register_op("log_softmax")
def _log_softmax(x, axis=-1, temperature=None):
    return torch.log_softmax(_temper(x, temperature), dim=axis)


@register_op("InstanceNorm")
def _instance_norm(data, gamma, beta, eps=1e-3):
    """Each (sample, channel) normalized over its spatial axes."""
    red = tuple(range(2, data.dim()))
    mean = data.mean(dim=red, keepdim=True)
    var = data.var(dim=red, keepdim=True, unbiased=False)
    bshape = (1, -1) + (1,) * (data.dim() - 2)
    return (data - mean) * torch.rsqrt(var + eps) * \
        gamma.reshape(bshape) + beta.reshape(bshape)


@register_op("Dropout", num_outputs=2, needs_rng=True,
             num_visible_outputs=1)
def _dropout(rng, data, p=0.5, mode="training", axes=(), cudnn_off=False,
             training=True):
    """(data * mask, mask): each kept element (one draw per position of
    the mask, which is 1 along *axes*) scaled by 1 / (1 - p), from the
    ``torch.Generator`` *rng* (None: the global stream's on data's
    device).  Outside training (unless *mode* is
    "always"), or with p = 0, the identity and a mask of ones."""
    if (not training and mode != "always") or p == 0.0:
        return data, torch.ones_like(data)
    shape = list(data.shape)
    for a in axes or ():
        shape[a] = 1
    keep = 1.0 - p
    if rng is None:
        rng = _rng.generator(data.device)
    u = torch.rand(shape, generator=rng, device=data.device)
    mask = (u < keep).to(data.dtype) / keep
    return data * mask, torch.broadcast_to(mask, data.shape)


# ---------------------------------------------------------------------------
# loss heads: each backward ignores the incoming gradient, as the
# reference's custom_vjp does, and gives the label a zero gradient
# ---------------------------------------------------------------------------

def _head_label(label, shape):
    """*label* shaped as *shape* (the head's output less its class axis,
    or the data's shape for the regression heads)."""
    return label if tuple(label.shape) == tuple(shape) else \
        label.reshape(shape)


class _SoftmaxOutput(torch.autograd.Function):
    """Softmax over *cls_axis*; the backward is softmax - one_hot(label)
    (smoothed by *smooth_alpha*, masked at *ignore_label* with
    *use_ignore*) times grad_scale over the *normalization*'s count."""

    @staticmethod
    def forward(ctx, data, label, cls_axis, grad_scale, ignore_label,
                use_ignore, normalization, smooth_alpha):
        out = torch.softmax(data, dim=cls_axis)
        ctx.save_for_backward(out, label)
        ctx.cfg = (cls_axis, grad_scale, ignore_label, use_ignore,
                   normalization, smooth_alpha)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, _g):
        out, label = ctx.saved_tensors
        (cls_axis, grad_scale, ignore_label, use_ignore, normalization,
         smooth_alpha) = ctx.cfg
        n_class = out.shape[cls_axis]
        rows = list(out.shape)
        del rows[cls_axis]
        lab = _head_label(label, rows)
        li = lab.to(torch.int64)
        # one_hot of an id outside [0, n_class) is a row of zeros
        inside = (li >= 0) & (li < n_class)
        onehot = torch.zeros_like(out).scatter_(
            cls_axis, torch.where(inside, li, 0).unsqueeze(cls_axis),
            inside.to(out.dtype).unsqueeze(cls_axis))
        if smooth_alpha:
            onehot = onehot * (1 - smooth_alpha) + smooth_alpha / n_class
        grad = out - onehot
        if use_ignore:
            keep = lab != ignore_label
            grad = grad * keep.to(out.dtype).unsqueeze(cls_axis)
        scale = grad_scale
        if normalization == "batch":
            scale = scale / grad.shape[0]
        elif normalization == "valid":
            if use_ignore:
                valid = torch.clamp((lab != ignore_label).sum(), min=1)
            else:
                valid = lab.numel()
            scale = scale / valid
        return grad * scale, torch.zeros_like(label), None, None, None, \
            None, None, None


@register_op("SoftmaxOutput", aliases=("Softmax",))
def _softmax_output(data, label, grad_scale=1.0, ignore_label=-1.0,
                    multi_output=False, use_ignore=False,
                    preserve_shape=False, normalization="null",
                    out_grad=False, smooth_alpha=0.0):
    """Softmax forward with the cross-entropy gradient as its backward
    (reference: ``src/operator/softmax_output-inl.h``).  The class axis
    is 1 with *multi_output*, the last with *preserve_shape*; otherwise
    data of more than two axes is flattened to (N, -1) first."""
    if multi_output or (preserve_shape and data.dim() > 2):
        cls_axis = 1 if multi_output else data.dim() - 1
    else:
        cls_axis = data.dim() - 1
        if data.dim() > 2:
            data = data.reshape(data.shape[0], -1)
            cls_axis = 1
    return _SoftmaxOutput.apply(data, label, cls_axis, grad_scale,
                                ignore_label, use_ignore, normalization,
                                smooth_alpha)


class _RegressionOutput(torch.autograd.Function):
    """Forward *kind*(data); backward grad_scale * d(data, label) with d
    the head's residual (linear and logistic: out - label; mae: its
    sign)."""

    @staticmethod
    def forward(ctx, data, label, kind, grad_scale):
        out = torch.sigmoid(data) if kind == "logistic" else data * 1.0
        ctx.save_for_backward(out, label)
        ctx.cfg = (kind, grad_scale)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, _g):
        out, label = ctx.saved_tensors
        kind, grad_scale = ctx.cfg
        res = out - _head_label(label, out.shape)
        if kind == "mae":
            res = torch.sign(res)
        return grad_scale * res, torch.zeros_like(label), None, None


@register_op("LinearRegressionOutput")
def _linear_regression_output(data, label, grad_scale=1.0):
    return _RegressionOutput.apply(data, label, "linear", grad_scale)


@register_op("MAERegressionOutput")
def _mae_regression_output(data, label, grad_scale=1.0):
    return _RegressionOutput.apply(data, label, "mae", grad_scale)


@register_op("LogisticRegressionOutput")
def _logistic_regression_output(data, label, grad_scale=1.0):
    return _RegressionOutput.apply(data, label, "logistic", grad_scale)


@register_op("BlockGrad", aliases=("stop_gradient",))
def _block_grad(x):
    """The value, with no gradient flowing back through it."""
    return x.detach()


@register_op("make_loss", aliases=("MakeLoss",))
def _make_loss(x):
    """The value as a loss head (its head gradient is ones)."""
    return x * 1.0


# ---------------------------------------------------------------------------
# softmax variants, LRN, resizing and the CTC loss
# ---------------------------------------------------------------------------

@register_op("softmin")
def _softmin(x, axis=-1, temperature=None):
    """softmax(-x) over *axis*; *temperature* is ignored, as in the JAX
    package."""
    return torch.softmax(-x, dim=axis)


@register_op("SoftmaxActivation")
def _softmax_activation(x, mode="instance"):
    """Softmax over the channel axis ("channel") or over all but the
    first axis ("instance")."""
    if mode == "channel":
        return torch.softmax(x, dim=1)
    return torch.softmax(x.reshape(x.shape[0], -1), dim=-1).reshape(x.shape)


@register_op("softmax_cross_entropy")
def _softmax_cross_entropy(data, label):
    """Sum over the batch of -log softmax(data)[label] (a 0-d tensor)."""
    logp = torch.log_softmax(data, dim=-1)
    return -torch.gather(logp, -1, label.long()[:, None]).sum()


@register_op("LRN", num_outputs=2, num_visible_outputs=1)
def _lrn(data, alpha=1e-4, beta=0.75, knorm=2.0, nsize=5):
    """Across-channel local response normalization (reference
    ``src/operator/nn/lrn.cc``): (data * norm, norm), norm = (knorm +
    alpha / nsize * the sum of squares over *nsize* channels) ** -beta."""
    half = nsize // 2
    sq = F.pad(torch.square(data), (0, 0) * (data.dim() - 2) + (half, half))
    c = data.shape[1]
    acc = torch.zeros_like(data)
    for i in range(nsize):
        acc = acc + sq[:, i:i + c]
    norm = torch.pow(knorm + (alpha / nsize) * acc, -beta)
    return data * norm, norm


def _resize(data, size):
    """Bilinear resize of NCHW data to *size*, antialiased when it
    shrinks: the function of ``jax.image.resize`` with "bilinear" or
    "linear" that the JAX package calls (without ``antialias`` torch
    samples a shrunk image at two points and parts from it by up to
    ~1.8 at 17 x 23 -> 5 x 7)."""
    return F.interpolate(data, size=tuple(int(s) for s in size),
                         mode="bilinear", align_corners=False,
                         antialias=True)


@register_op("UpSampling")
def _upsampling(*args, scale=1, sample_type="nearest", num_args=1,
                num_filter=0, multi_input_mode="concat", workspace=512):
    """Nearest: each input's pixels repeated *scale* times on both
    spatial axes, the inputs concatenated on channels or summed.
    Bilinear: the first input resized by *scale*; the weight input is
    ignored, as in the JAX package."""
    if sample_type == "nearest":
        outs = [d.repeat_interleave(scale, dim=2)
                .repeat_interleave(scale, dim=3) for d in args]
        if len(outs) == 1:
            return outs[0]
        if multi_input_mode == "sum":
            out = outs[0]
            for o in outs[1:]:
                out = out + o
            return out
        return torch.cat(outs, dim=1)
    h, w = args[0].shape[2:]
    return _resize(args[0], (h * scale, w * scale))


@register_op("_contrib_BilinearResize2D")
def _bilinear_resize2d(data, height=0, width=0, scale_height=None,
                       scale_width=None, mode="size"):
    h, w = data.shape[2:]
    if scale_height is not None:
        height = int(h * scale_height)
        width = int(w * scale_width)
    return _resize(data, (height, width))


@register_op("_contrib_AdaptiveAvgPooling2D")
def _adaptive_avg_pool(data, output_size=()):
    """Mean over equal windows when the output divides the input on both
    axes; otherwise the bilinear resize the JAX package falls back to
    (not torch's adaptive pooling, which parts from it)."""
    if not output_size:
        oh = ow = 1
    elif isinstance(output_size, int):
        oh = ow = output_size
    elif len(output_size) == 1:
        oh = ow = output_size[0]
    else:
        oh, ow = output_size
    n, c, h, w = data.shape
    if h % oh == 0 and w % ow == 0:
        return data.reshape(n, c, oh, h // oh, ow, w // ow).mean(dim=(3, 5))
    return _resize(data, (oh, ow))


@register_op("_contrib_div_sqrt_dim")
def _div_sqrt_dim(data):
    """data / sqrt(its last extent), the root taken in float32 and
    rounded to data's dtype (reference ``src/operator/contrib/
    transformer.cc:33``)."""
    root = torch.tensor(float(data.shape[-1]), dtype=torch.float32).sqrt()
    return data / float(root.to(data.dtype))


for _old, _new in (("BatchNorm_v1", "BatchNorm"),
                   ("Convolution_v1", "Convolution"),
                   ("Pooling_v1", "Pooling")):
    alias(_old, _new)

# optax's stand-in for log(0) in the JAX package's CTC loss
_CTC_LOG_EPS = -1e5


class _LogAddExp(torch.autograd.Function):
    """log(exp(a) + exp(b)) with the gradients g * exp(a - out) and g *
    exp(b - out), the formulas of ``jnp.logaddexp``.  Torch's own
    backward, g / (1 + exp(b - a)), is the more accurate one; but where
    the CTC recursion runs near -1e5 its out carries an f32 rounding of
    ~0.004, which moves JAX's gradient by ~0.4 %, and the port follows
    the JAX package's numbers."""

    @staticmethod
    def forward(ctx, a, b):
        out = torch.maximum(a, b) + torch.log1p(torch.exp(-(a - b).abs()))
        ctx.save_for_backward(a, b, out)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        a, b, out = ctx.saved_tensors
        return g * torch.exp(a - out), g * torch.exp(b - out)


def _ctc_dp(logp, logit_pad, labels, label_pad):
    """Per-sequence CTC loss by the recursion of ``optax.ctc_loss``
    (blank 0, log(0) taken as -1e5): an alignment that cannot exist
    costs 1e5 for each transition it lacks, where torch's loss is
    infinite.  logp (B, T, K) log-probabilities, logit_pad (B, T) and
    label_pad (B, N) 1.0 at padding, labels (B, N) right-padded."""
    b, _, k = logp.shape
    n = labels.shape[1]
    eps = _CTC_LOG_EPS
    dt = logp.dtype
    lens = n - label_pad.sum(dim=1).long()
    repeat = F.pad((labels[:, :-1] == labels[:, 1:]).to(dt), (0, 1))
    phi_lp = logp[:, :, 0].t().unsqueeze(-1)                # (T, B, 1)
    emit_lp = torch.gather(
        logp, 2, labels.long().clamp(0, k - 1)[:, None, :]
        .expand(b, logp.shape[1], n)).transpose(0, 1)       # (T, B, N)
    # a label outside [0, K) is a one_hot of zeros: log-prob 0
    inside = ((labels >= 0) & (labels < k)).to(dt)
    emit_lp = emit_lp * inside
    phi = torch.full((b, n + 1), eps, dtype=dt, device=logp.device)
    phi[:, 0] = 0.0
    emit = torch.full((b, n), eps, dtype=dt, device=logp.device)

    lae = _LogAddExp.apply

    def add_phi(p, score):
        return torch.cat([p[:, :1], lae(p[:, 1:], score)], -1)

    pads = logit_pad.t().to(dt)
    for t in range(logp.shape[1]):
        prev_phi = phi
        p = add_phi(phi, emit + eps * repeat)
        next_emit = lae(p[:, :-1] + emit_lp[t], emit + emit_lp[t])
        next_phi = add_phi(p + phi_lp[t],
                           emit + phi_lp[t] + eps * (1.0 - repeat))
        pad = pads[t].reshape(b, 1)
        emit = pad * emit + (1.0 - pad) * next_emit
        phi = pad * prev_phi + (1.0 - pad) * next_phi
    last = add_phi(phi, emit)
    return -torch.gather(last, 1, lens[:, None])[:, 0]


@register_op("CTCLoss", aliases=("ctc_loss", "_contrib_CTCLoss",
                                 "_contrib_ctc_loss"),
             input_names=("data", "label", "data_lengths",
                          "label_lengths"))
def _ctc_loss(*inputs, use_data_lengths=False, use_label_lengths=False,
              blank_label="first"):
    """CTC loss per sequence; data (seq, batch, alphabet), labels (batch,
    N).  The length tensors are inputs gated by ``use_*_lengths``;
    without label lengths, label 0 is padding.  Blank "first" is class
    0; "last" rotates the alphabet so that the last class is 0 and the
    labels move up by one, as the JAX package does.

    The loss is ``F.ctc_loss``'s.  A sequence whose alignment cannot
    exist (fewer frames than labels plus adjacent repeats) or whose label
    is the blank takes the JAX package's finite value instead, by
    ``_ctc_dp``, as does its gradient."""
    expected = 2 + bool(use_data_lengths) + bool(use_label_lengths)
    if len(inputs) != expected:
        raise TypeError(
            "CTCLoss expects %d inputs for use_data_lengths=%r, "
            "use_label_lengths=%r; got %d"
            % (expected, use_data_lengths, use_label_lengths, len(inputs)))
    rest = list(inputs[2:])
    data_lengths = rest.pop(0) if use_data_lengths else None
    label_lengths = rest.pop(0) if use_label_lengths else None
    data, label = inputs[0], inputs[1]
    seq, batch, _ = data.shape
    if data.device.type == "meta":      # shape inference
        return data.new_empty((batch,))
    logits = data.transpose(0, 1)                           # (B, T, A)
    labels = label.long()
    if blank_label != "first":
        logits = torch.cat([logits[..., -1:], logits[..., :-1]], -1)
        labels = labels + 1
    dev = data.device
    if data_lengths is not None:
        t_len = data_lengths.long().reshape(-1)
    else:
        t_len = torch.full((batch,), seq, dtype=torch.long, device=dev)
    cols = torch.arange(labels.shape[1], device=dev)[None, :]
    if label_lengths is not None:
        label_pad = cols >= label_lengths.long().reshape(-1, 1)
    else:
        label_pad = labels <= 0
    l_len = labels.shape[1] - label_pad.sum(dim=1)
    logp = torch.log_softmax(logits, dim=-1)
    loss = F.ctc_loss(logp.transpose(0, 1), labels.clamp(min=0), t_len,
                      l_len, blank=0, reduction="none", zero_infinity=True)
    valid = ~label_pad
    repeats = ((labels[:, 1:] == labels[:, :-1]) & valid[:, 1:]).sum(dim=1)
    by_dp = (t_len < l_len + repeats) | ((labels == 0) & valid).any(dim=1)
    # F.ctc_loss takes the lengths to the host, so this read adds no sync
    if bool(by_dp.any()):
        pad_t = (torch.arange(seq, device=dev)[None, :] >=
                 t_len[:, None]).to(logp.dtype)
        dp = _ctc_dp(logp, pad_t, labels, label_pad.to(logp.dtype))
        loss = torch.where(by_dp, dp, loss)
    return loss


def _ctc_inputs(params):
    names = ["data", "label"]
    if params.get("use_data_lengths", False):
        names.append("data_lengths")
    if params.get("use_label_lengths", False):
        names.append("label_lengths")
    return tuple(names)


get_op("CTCLoss").active_inputs = _ctc_inputs
