"""Shape and indexing ops (port of ``mxnet_tpu/ops/tensor.py``, subset:
Reshape, reshape_like, Flatten, transpose, slice, slice_like,
space_to_depth, pick, Embedding).

``pick`` and ``Embedding`` read an index as the reference's ``jnp.take``
family does: negative indices in range wrap, and an index out of range
reads NaN instead of being clipped or tripping a device assert."""

from __future__ import annotations

import torch

from .registry import register_op


def _infer_reshape(src_shape, spec, reverse=False):
    """MXNet Reshape special codes (0 copy, -1 infer, -2 copy rest,
    -3 merge two, -4 split one); mirrors ``mxnet_tpu/ops/tensor.py``."""
    src = list(src_shape)
    spec = list(spec)
    if reverse:
        src = src[::-1]
        spec = spec[::-1]
    out = []
    i = 0
    j = 0
    while j < len(spec):
        s = spec[j]
        if s == 0:
            out.append(src[i]); i += 1
        elif s == -1:
            out.append(-1); i += 1
        elif s == -2:
            out.extend(src[i:]); i = len(src)
        elif s == -3:
            out.append(src[i] * src[i + 1]); i += 2
        elif s == -4:
            d1, d2 = spec[j + 1], spec[j + 2]
            if d1 == -1:
                d1 = src[i] // d2
            if d2 == -1:
                d2 = src[i] // d1
            out.extend([d1, d2]); i += 1; j += 2
        else:
            out.append(int(s))
            if i < len(src):
                i += 1
        j += 1
    if -1 in out:
        known = 1
        for d in out:
            if d != -1:
                known *= d
        total = 1
        for d in src_shape:
            total *= d
        out[out.index(-1)] = total // known
    if reverse:
        out = out[::-1]
    return tuple(out)


def _axes_tuple(axes):
    # symbol JSON writes a one-element tuple as "(1)", which parses back
    # as the int 1; accept both spellings
    if axes is None:
        return None
    if isinstance(axes, int):
        return (axes,)
    return tuple(axes)


@register_op("Reshape", aliases=("reshape",))
def _reshape(x, shape=(), reverse=False):
    return torch.reshape(x, _infer_reshape(x.shape, _axes_tuple(shape),
                                           reverse))


@register_op("reshape_like")
def _reshape_like(x, y):
    return torch.reshape(x, y.shape)


@register_op("Flatten", aliases=("flatten",))
def _flatten(x):
    return torch.reshape(x, (x.shape[0], -1))


@register_op("transpose")
def _transpose(x, axes=None):
    axes = _axes_tuple(axes)
    if not axes:
        axes = tuple(range(x.dim() - 1, -1, -1))
    return x.permute(*axes)


def _slice_axis(x, axis, begin, end, step):
    """``x[begin:end:step]`` along *axis* with Python's slice semantics
    (None, negative bounds, negative steps); torch indexing takes no
    negative step, so one is a flip of the covered range."""
    if step is None or step > 0:
        idx = [slice(None)] * x.dim()
        idx[axis] = slice(begin, end, step)
        return x[tuple(idx)]
    picked = range(*slice(begin, end, step).indices(x.shape[axis]))
    if not picked:
        return x.narrow(axis, 0, 0)
    seg = x.narrow(axis, picked[-1], picked[0] - picked[-1] + 1).flip(axis)
    return _slice_axis(seg, axis, None, None, -step)


@register_op("slice")
def _slice(x, begin=(), end=(), step=()):
    """``x[b0:e0:s0, b1:e1:s1, ...]`` over the leading axes; None in
    *begin*, *end* or *step* is Python's default."""
    begin, end = _axes_tuple(begin), _axes_tuple(end)
    step = _axes_tuple(step) or (None,) * len(begin)
    for axis, (b, e, st) in enumerate(zip(begin, end, step)):
        x = _slice_axis(x, axis, b, e, st)
    return x


@register_op("slice_like")
def _slice_like(x, y, axes=()):
    axes = _axes_tuple(axes) or range(x.dim())
    idx = [slice(None)] * x.dim()
    for a in axes:
        idx[a] = slice(0, y.shape[a])
    return x[tuple(idx)]


@register_op("space_to_depth")
def _space_to_depth(x, block_size=1):
    """(N, C, H, W) -> (N, C * b * b, H / b, W / b), channels ordered
    (row offset, column offset, channel), as the JAX package orders
    them."""
    n, c, h, w = x.shape
    b = block_size
    x = x.reshape(n, c, h // b, b, w // b, b)
    x = x.permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, c * b * b, h // b, w // b)


def _fill_value(dtype):
    """What an out-of-range index reads (``jnp.take``'s "fill" mode): NaN
    for a floating dtype, the most negative value for a signed integer,
    the largest for an unsigned one, True for bool."""
    if dtype.is_floating_point or dtype.is_complex:
        return float("nan")
    if dtype == torch.bool:
        return True
    info = torch.iinfo(dtype)
    return info.min if info.min < 0 else info.max


def _wrap_index(index, n):
    """(index wrapped into [0, n), in range) for integer-valued *index*
    along an axis of *n*: an index in [-n, 0) counts from the end, one
    outside [-n, n) is out of range.  Index arithmetic only, so the
    device never asserts and nothing waits on the host: an out-of-range
    index gathers row 0 and its result is masked afterwards."""
    i = index.long()
    ok = (i >= -n) & (i < n)
    i = torch.where(i < 0, i + n, i)
    return torch.where(ok, i, torch.zeros_like(i)), ok


@register_op("pick")
def _pick(data, index, axis=-1, keepdims=False, mode="clip"):
    """data's element at *index* along *axis*, with the reference's
    ``jnp.take_along_axis`` semantics whatever *mode* says: an index in
    [-n, 0) wraps, one outside [-n, n) reads NaN (and passes no
    gradient).  Indices arrive as floats or ints."""
    axis = axis % data.dim()
    j, ok = _wrap_index(index, data.shape[axis])
    out = torch.gather(data, axis, j.unsqueeze(axis))
    out = torch.where(ok.unsqueeze(axis), out,
                      torch.full((), _fill_value(data.dtype),
                                 dtype=data.dtype, device=data.device))
    return out if keepdims else out.squeeze(axis)


@register_op("Embedding")
def _embedding(data, weight, input_dim=0, output_dim=0, dtype="float32",
               sparse_grad=False):
    """Rows of *weight* by id, with the reference's ``jnp.take`` rules: an
    id in [-input_dim, 0) wraps, one outside [-input_dim, input_dim)
    gives a NaN row (and passes no gradient).  Token ids arrive as
    floats (serving inputs default to float32) or ints.  Safe under CUDA
    graph capture: no id reaches the device's index assert and nothing
    is read back to the host."""
    j, ok = _wrap_index(data, weight.shape[0])
    rows = torch.index_select(weight, 0, j.reshape(-1)).reshape(
        tuple(j.shape) + tuple(weight.shape[1:]))
    return torch.where(ok.reshape(tuple(ok.shape) + (1,) *
                                  (weight.dim() - 1)), rows,
                       torch.full((), _fill_value(weight.dtype),
                                  dtype=weight.dtype, device=weight.device))
