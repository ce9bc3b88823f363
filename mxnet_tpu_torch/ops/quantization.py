"""Quantization operators (port of ``mxnet_tpu/ops/quantization.py``).

The reference's INT8 path (quantize, dequantize, requantize, the int8
convolution, fully-connected, pooling, flatten and relu ops) and
KVStore's 2-bit gradient compression with its error-feedback residual.
The JAX package computes these with XLA (``lax.dot_general`` and
``lax.conv_general_dilated`` with ``preferred_element_type=int32``): no
Pallas kernel lies on them, so the port runs them as PyTorch library ops.

**Int8 products.**  A CUDA tensor multiplies through ``torch._int_mm``
(int8 x int8 -> int32 on the tensor cores).  Its limits on the card: the
left operand has more than 16 rows, and the contracted and output widths
are multiples of 8; :func:`int8_matmul` pads with zeros, which is exact,
and slices the result.  Convolution builds its columns from the padded
int8 input with ``as_strided`` and multiplies them the same way.  A CPU
tensor runs the plain version: the product in float64, exact for every
width these models reach (each term is at most 127 * 127 and a sum of K
of them stays far below 2**53), cast to int32.  Nothing falls back to a
float product on the card.

**Counting.**  Inside :func:`counting` (one per thread), the quantized ops
count the int8 products they compute (on either device) and the int8
tensors they consume, and with :func:`counted_impls` wrapping Convolution
and FullyConnected, the bytes every compute op moves (operands read
once, the result written once) and the float products left.  The
serving predictor counts each rung's program while it is built (on the
card: while its CUDA graph is captured, so the counts are per replay).
"""

from __future__ import annotations

import contextlib
import threading

import numpy as _np
import torch
import torch.nn.functional as F

from ..base import narrow_dtype, torch_dtype
from .registry import get_op, register_op

__all__ = ["pack_2bit", "unpack_2bit", "int8_matmul", "counting",
           "counted_impls"]

_INT32_MAX = 2.0 ** 31 - 1
_tls = threading.local()


@contextlib.contextmanager
def counting():
    """Count this thread's quantized work inside the block.  Yields the
    dict the ops add to: ``int8_products``, ``int8_tensors`` (int8 inputs
    the quantized ops consumed), ``int8_dequantized`` (int8 tensors
    dequantized in-graph: the weights of ``int8-weight-only``),
    ``float_products`` and ``compute_bytes``."""
    prev = getattr(_tls, "counts", None)
    counts = {"int8_products": 0, "int8_tensors": 0,
              "int8_dequantized": 0, "float_products": 0,
              "compute_bytes": 0}
    _tls.counts = counts
    try:
        yield counts
    finally:
        _tls.counts = prev


def _count(key, n=1):
    counts = getattr(_tls, "counts", None)
    if counts is not None:
        counts[key] += n


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def counted_impls():
    """``op_impls`` for ``executor._build_eval``: Convolution and
    FullyConnected that count their float products and compute bytes
    inside :func:`counting` (the fp32 side of the byte comparison)."""
    def wrap(fn):
        def counted(data, weight, *rest, **params):
            out = fn(data, weight, *rest, **params)
            if getattr(_tls, "counts", None) is not None:
                _count("float_products")
                _count("compute_bytes", _nbytes(data, weight, out))
            return out
        return counted
    return {n: wrap(get_op(n).fn) for n in ("Convolution", "FullyConnected")}


def _round8(n):
    return -(-n // 8) * 8


def int8_matmul(a, b_t):
    """``a @ b_t.T`` for int8 *a* (M, K) and *b_t* (N, K): int32 (M, N).
    On the card through ``torch._int_mm`` with zero padding to its limits
    (M > 16; K, N multiples of 8); on the CPU exact in float64."""
    if a.dtype != torch.int8 or b_t.dtype != torch.int8:
        raise TypeError("int8_matmul takes int8 operands, got %s and %s"
                        % (a.dtype, b_t.dtype))
    m, k = a.shape
    n = b_t.shape[0]
    _count("int8_products")
    if a.device.type != "cuda":
        return (a.double() @ b_t.double().t()).to(torch.int32)
    mp, kp, np_ = max(m, 17), _round8(k), _round8(n)
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if (np_, kp) != (n, k):
        b_t = F.pad(b_t, (0, kp - k, 0, np_ - n))
    out = torch._int_mm(a.contiguous(), b_t.contiguous().t())
    if (mp, np_) != (m, n):
        out = out[:m, :n]
    return out


@register_op("_contrib_quantize", num_outputs=3, aliases=("quantize",))
def _quantize(data, min_range, max_range, out_type="uint8"):
    """Affine-quantize to int8/uint8 (reference: quantize-inl.h)."""
    if out_type == "uint8":
        qmin, qmax = 0.0, 255.0
        dt = torch.uint8
    else:
        qmin, qmax = -127.0, 127.0
        dt = torch.int8
    scale = (qmax - qmin) / torch.clamp(max_range - min_range, min=1e-20)
    q = torch.clamp(torch.round((data - min_range) * scale + qmin),
                    qmin, qmax)
    return q.to(dt), min_range, max_range


@register_op("_contrib_dequantize", aliases=("dequantize",))
def _dequantize(data, min_range, max_range, out_type="float32"):
    if data.dtype == torch.uint8:
        qmin, qmax = 0.0, 255.0
    elif data.dtype == torch.int32:
        # int32 accumulator out of the quantized conv/fc ops
        qmin, qmax = -_INT32_MAX, _INT32_MAX
    else:
        qmin, qmax = -127.0, 127.0
        if data.dtype == torch.int8:
            _count("int8_dequantized")
    scale = (max_range - min_range) / (qmax - qmin)
    # affine as q * scale + offset, not (q - qmin) * scale + min: at int32
    # magnitudes (q - qmin) ~ 2**31 and float32 would lose the
    # accumulator's low bits (for symmetric ranges the offset is 0)
    return data.to(torch.float32) * scale + (min_range - qmin * scale)


def _f32(x):
    """A Python number as the float32 value JAX would compute with."""
    return _np.float32(x)


@register_op("_contrib_requantize", num_outputs=3)
def _requantize(data, min_range, max_range, min_calib_range=None,
                max_calib_range=None):
    # int32 -> int8 with a (possibly calibrated) range.  The accumulator
    # carries a symmetric real range: real = q * MaxAbs(min, max) /
    # (2**31 - 1), the scale _dequantize's int32 branch resolves to
    real = data.to(torch.float32) * \
        torch.maximum(torch.abs(min_range), torch.abs(max_range)) / \
        _INT32_MAX
    if min_calib_range is not None and max_calib_range is not None:
        # both bounds are parameters: the scale in float32 on the host
        lo, hi = _f32(min_calib_range), _f32(max_calib_range)
        m = _np.maximum(_np.maximum(_np.abs(lo), _np.abs(hi)),
                        _f32(1e-20))
        q = torch.round(real * float(_f32(127.0) / m))
        top = float(_np.abs(hi))
        lo_t = torch.full((), -top, dtype=torch.float32, device=data.device)
        hi_t = torch.full((), top, dtype=torch.float32, device=data.device)
    else:
        lo = min_calib_range if min_calib_range is not None else min_range
        hi = max_calib_range if max_calib_range is not None else max_range
        lo = torch.as_tensor(lo, dtype=torch.float32, device=data.device)
        hi = torch.as_tensor(hi, dtype=torch.float32, device=data.device)
        m = torch.clamp(torch.maximum(torch.abs(lo), torch.abs(hi)),
                        min=1e-20)
        q = torch.round(real * (127.0 / m))
        lo_t, hi_t = -torch.abs(hi), torch.abs(hi)
    return torch.clamp(q, -127, 127).to(torch.int8), lo_t, hi_t


# ---------------------------------------------------------------------------
# INT8 compute ops — int8 x int8 -> int32 (reference:
# src/operator/quantization/quantized_conv.cc, quantized_fully_connected.cc,
# quantized_pooling.cc, quantized_flatten.cc).  A quantized tensor carries
# a symmetric real range (min, max); real = q * M / 127 with M = max(|min|,
# |max|), so the int32 accumulator's range is (2**31 - 1) * Md * Mw / 127**2.
# ---------------------------------------------------------------------------


def _sym_scale(mn, mx):
    return torch.maximum(torch.abs(mn), torch.abs(mx)) / 127.0


def _int32_range(dmin, dmax, wmin, wmax):
    m = _sym_scale(dmin, dmax) * _sym_scale(wmin, wmax) * _INT32_MAX
    return -m, m


def _as_int8(x):
    if x.dtype != torch.int8:
        x = x.to(torch.int8)
    return x


def _conv_columns(x, kernel, stride, dilate):
    """(N * OH * OW, C * KH * KW) int8 columns of padded NC + 2-d *x*."""
    n, c, h, w = x.shape
    kh, kw = kernel
    sh, sw = stride
    dh, dw = dilate
    oh = (h - dh * (kh - 1) - 1) // sh + 1
    ow = (w - dw * (kw - 1) - 1) // sw + 1
    x = x.contiguous()
    s0, s1, s2, s3 = x.stride()
    cols = x.as_strided((n, oh, ow, c, kh, kw),
                        (s0, s2 * sh, s3 * sw, s1, s2 * dh, s3 * dw))
    return cols.reshape(n * oh * ow, c * kh * kw), oh, ow


@register_op("_contrib_quantized_conv", num_outputs=3,
             aliases=("quantized_conv",))
def _quantized_conv(data, weight, dmin, dmax, wmin, wmax, kernel=(1, 1),
                    stride=(1, 1), pad=(0, 0), dilate=(1, 1),
                    num_filter=0, num_group=1, no_bias=True,
                    layout="NCHW"):
    """int8 NCHW convolution with int32 accumulation."""
    d, w = _as_int8(data), _as_int8(weight)
    _count("int8_tensors", 2)
    nd_ = len(kernel)
    if nd_ != 2:
        raise ValueError("quantized_conv supports 2-d kernels, got %r"
                         % (kernel,))
    stride = tuple(int(s) for s in (stride or (1,) * nd_))
    dilate = tuple(int(s) for s in (dilate or (1,) * nd_))
    pad = tuple(int(p) for p in (pad or (0,) * nd_))
    groups = int(num_group)
    if d.device.type != "cuda":
        _count("int8_products")
        out = F.conv2d(d.double(), w.double(), stride=stride, padding=pad,
                       dilation=dilate, groups=groups).to(torch.int32)
    else:
        if any(pad):
            d = F.pad(d, (pad[1], pad[1], pad[0], pad[0]))
        n = d.shape[0]
        o = w.shape[0]
        cg, og = d.shape[1] // groups, o // groups
        parts = []
        for g in range(groups):
            cols, oh, ow = _conv_columns(d[:, g * cg:(g + 1) * cg],
                                         tuple(int(k) for k in kernel),
                                         stride, dilate)
            wg = w[g * og:(g + 1) * og].reshape(og, -1)
            parts.append(int8_matmul(cols, wg))
        acc = parts[0] if groups == 1 else torch.cat(parts, dim=1)
        out = acc.reshape(n, oh, ow, o).permute(0, 3, 1, 2).contiguous()
    _count("compute_bytes", _nbytes(d, w, out))
    omin, omax = _int32_range(dmin, dmax, wmin, wmax)
    return out, omin, omax


@register_op("_contrib_quantized_fully_connected", num_outputs=3,
             aliases=("quantized_fc",))
def _quantized_fc(data, weight, dmin, dmax, wmin, wmax, num_hidden=0,
                  no_bias=True, flatten=True):
    d, w = _as_int8(data), _as_int8(weight)
    _count("int8_tensors", 2)
    if flatten and d.dim() > 2:
        d = d.reshape(d.shape[0], -1)
    lead = d.shape[:-1]
    out = int8_matmul(d.reshape(-1, d.shape[-1]), w)
    out = out.reshape(tuple(lead) + (w.shape[0],))
    _count("compute_bytes", _nbytes(d, w, out))
    omin, omax = _int32_range(dmin, dmax, wmin, wmax)
    return out, omin, omax


@register_op("_contrib_quantized_pooling", num_outputs=3,
             aliases=("quantized_pooling",))
def _quantized_pooling(data, dmin, dmax, kernel=(2, 2), stride=None,
                       pad=None, pool_type="max", global_pool=False):
    """int8 pooling: max stays exact in int8; avg sums in int32, then
    divides in float32 and rounds back (the range is unchanged either
    way)."""
    d = data
    _count("int8_tensors")
    nd_ = len(kernel)
    if global_pool:
        kernel = d.shape[2:]
        stride = (1,) * nd_
        pad = (0,) * nd_
    kernel = tuple(int(k) for k in kernel)
    stride = tuple(int(s) for s in (stride or kernel))
    pad = tuple(int(p) for p in (pad or (0,) * nd_))
    if nd_ == 1:
        # as a 2-d window of height 1 (avg_pool1d has no divisor_override)
        out, _, _ = _quantized_pooling(
            d.unsqueeze(2), dmin, dmax, kernel=(1,) + kernel,
            stride=(1,) + stride, pad=(0,) + pad, pool_type=pool_type)
        return out.squeeze(2), dmin, dmax
    pool = {2: F.max_pool2d, 3: F.max_pool3d}[nd_]
    avg = {2: F.avg_pool2d, 3: F.avg_pool3d}[nd_]
    spad = []
    for p in reversed(pad):
        spad += [p, p]
    if pool_type == "max":
        # the window's identity is the input dtype's minimum, as the
        # reference's reduce_window init; int8 and uint8 are exact in f32
        init = float(torch.iinfo(d.dtype).min)
        x = F.pad(d.to(torch.float32), spad, value=init) if any(pad) \
            else d.to(torch.float32)
        out = pool(x, kernel, stride).to(d.dtype)
    else:
        x = F.pad(d.to(torch.float64), spad) if any(pad) \
            else d.to(torch.float64)
        s = avg(x, kernel, stride, divisor_override=1)
        n = 1
        for k in kernel:
            n *= k
        lo, hi = (0, 255) if d.dtype == torch.uint8 else (-127, 127)
        q = torch.round(s.to(torch.int32).to(torch.float32) / n)
        out = torch.clamp(q, lo, hi).to(d.dtype)
    return out, dmin, dmax


@register_op("_contrib_quantized_flatten", num_outputs=3,
             aliases=("quantized_flatten",))
def _quantized_flatten(data, dmin, dmax):
    return data.reshape(data.shape[0], -1), dmin, dmax


@register_op("_contrib_quantized_act", num_outputs=3,
             aliases=("quantized_act",))
def _quantized_act(data, dmin, dmax, act_type="relu"):
    """Activation that stays in the quantized domain (relu only).  With
    the symmetric convention relu commutes with dequantization, so the
    output carries the input's range unchanged."""
    if act_type != "relu":
        raise ValueError("quantized activation supports act_type='relu' "
                         "only, got %r" % (act_type,))
    return torch.clamp(data, min=0), dmin, dmax


# ---------------------------------------------------------------------------
# 2-bit gradient compression (error feedback)
# ---------------------------------------------------------------------------


@register_op("_contrib_quantize_2bit", num_outputs=2)
def _quantize_2bit(grad, residual, threshold=0.5):
    """Ternarize grad + residual to {-t, 0, +t}; returns (codes,
    residual'), codes int8 in {-1, 0, 1}."""
    acc = grad + residual
    code = (acc >= threshold).to(torch.int8) - \
        (acc <= -threshold).to(torch.int8)
    decoded = code.to(grad.dtype) * threshold
    return code, acc - decoded


@register_op("_contrib_dequantize_2bit")
def _dequantize_2bit(codes, threshold=0.5, dtype="float32"):
    return codes.to(torch_dtype(narrow_dtype(dtype))) * threshold


def pack_2bit(codes):
    """Host-side: pack int8 {-1, 0, 1} lanes into a uint8 array, 4 values
    per byte (the dist kvstore's wire format)."""
    flat = _np.asarray(codes).ravel()
    pad = (-len(flat)) % 4
    if pad:
        flat = _np.concatenate([flat, _np.zeros(pad, flat.dtype)])
    two_bit = (flat + 1).astype(_np.uint8)      # {-1,0,1} -> {0,1,2}
    packed = (two_bit[0::4] | (two_bit[1::4] << 2) |
              (two_bit[2::4] << 4) | (two_bit[3::4] << 6))
    return packed, len(_np.asarray(codes).ravel())


def unpack_2bit(packed, n):
    packed = _np.asarray(packed)
    vals = _np.empty(len(packed) * 4, _np.int8)
    for i in range(4):
        vals[i::4] = ((packed >> (2 * i)) & 0x3).astype(_np.int8) - 1
    return vals[:n]
