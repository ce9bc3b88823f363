"""Shape and indexing ops (port of ``mxnet_tpu/ops/tensor.py``, subset:
Reshape, reshape_like, transpose, slice_like, pick, Embedding)."""

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


@register_op("transpose")
def _transpose(x, axes=None):
    axes = _axes_tuple(axes)
    if not axes:
        axes = tuple(range(x.dim() - 1, -1, -1))
    return x.permute(*axes)


@register_op("slice_like")
def _slice_like(x, y, axes=()):
    axes = _axes_tuple(axes) or range(x.dim())
    idx = [slice(None)] * x.dim()
    for a in axes:
        idx[a] = slice(0, y.shape[a])
    return x[tuple(idx)]


@register_op("pick")
def _pick(data, index, axis=-1, keepdims=False, mode="clip"):
    """data's element at *index* along *axis*; indices arrive as floats
    or ints and are clipped into range (mode 'clip')."""
    idx = index.long().clamp(0, data.shape[axis] - 1).unsqueeze(axis)
    out = torch.gather(data, axis, idx)
    return out if keepdims else out.squeeze(axis)


@register_op("Embedding")
def _embedding(data, weight, input_dim=0, output_dim=0, dtype="float32",
               sparse_grad=False):
    # token ids arrive as floats (serving inputs default to float32) or
    # ints; rows are gathered with long indices
    return weight[data.long()]
