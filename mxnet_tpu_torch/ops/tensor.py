"""Creation, shape, indexing, ordering and product ops (port of
``mxnet_tpu/ops/tensor.py``; its ``_linalg_*`` ops and ``histogram`` are
not ported yet).

Indices follow the reference's ``jnp`` rules, never PyTorch's errors:

- ``pick`` and ``Embedding`` read an index as ``jnp.take``'s "fill" mode
  does: a negative index in range wraps, one out of range reads NaN;
- ``take`` clips (its default mode), or wraps, or fills;
- a gather by ``jnp`` indexing (``gather_nd``, ``batch_take``, the
  ``Sequence*`` ops) wraps a negative index once and clamps the rest into
  range, and a scatter (``scatter_nd``, ``_scatter_set_nd``) drops an
  out-of-range index;
- ``one_hot`` gives a zero row for an id out of range.

Index arithmetic stays on the device: no index reaches PyTorch's device
assert and nothing is read back to the host.  Ops with no array input
(``_zeros``, ``_arange``, ...) make their tensor on PyTorch's default
device, which the caller sets (``imperative_invoke`` runs them under
``with torch.device(ctx)``)."""

from __future__ import annotations

import numpy as _np
import torch

from ..base import np_dtype, torch_dtype
from .registry import register_op, alias


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


# ---------------------------------------------------------------------------
# creation (no array inputs: the shape, dtype and values are parameters)
# ---------------------------------------------------------------------------

def _shape(shape):
    if shape is None:
        return ()
    if isinstance(shape, int):
        return (shape,)
    return tuple(shape)


@register_op("_zeros")
def _zeros(shape=(), dtype="float32"):
    return torch.zeros(_shape(shape), dtype=torch_dtype(dtype))


@register_op("_ones")
def _ones(shape=(), dtype="float32"):
    return torch.ones(_shape(shape), dtype=torch_dtype(dtype))


@register_op("_full")
def _full(shape=(), dtype="float32", value=0.0):
    return torch.full(_shape(shape), value, dtype=torch_dtype(dtype))


@register_op("_arange")
def _arange(start=0.0, stop=None, step=1.0, repeat=1, dtype="float32"):
    # the reference's jnp.arange with a step is numpy's arange, value for
    # value
    out = torch.tensor(_np.arange(start, stop, step, np_dtype(dtype)))
    if repeat != 1:
        out = torch.repeat_interleave(out, repeat)
    return out


@register_op("_eye")
def _eye(N=0, M=0, k=0, dtype="float32"):
    n, m = int(N), int(M) or int(N)
    i = torch.arange(n).unsqueeze(1)
    j = torch.arange(m).unsqueeze(0)
    return (j - i == int(k)).to(torch_dtype(dtype))


@register_op("_linspace")
def _linspace(start=0.0, stop=1.0, num=50, endpoint=True, dtype="float32"):
    """``jnp.linspace``'s arithmetic: start * (1 - t) + stop * t with t =
    i / div in the compute dtype, the end point appended exactly."""
    num = int(num)
    dt = torch_dtype(dtype)
    cdt = dt if dt.is_floating_point else torch.float32
    start_t = torch.tensor(start, dtype=cdt)
    stop_t = torch.tensor(stop, dtype=cdt)
    if num > 1:
        div = num - 1 if endpoint else num
        t = torch.arange(div, dtype=cdt) / torch.tensor(div, dtype=cdt)
        out = start_t * (1 - t) + stop_t * t
        if endpoint:
            out = torch.cat([out, stop_t.reshape(1)])
    else:
        out = start_t.reshape(1)[:num]
    if not dt.is_floating_point:
        out = torch.floor(out)
    return out.to(dt)


# ---------------------------------------------------------------------------
# shape
# ---------------------------------------------------------------------------

@register_op("SwapAxis", aliases=("swapaxes",))
def _swapaxes(x, dim1=0, dim2=0):
    return torch.swapaxes(x, dim1, dim2)


@register_op("expand_dims")
def _expand_dims(x, axis=0):
    return torch.unsqueeze(x, axis)


@register_op("squeeze")
def _squeeze(x, axis=None):
    if axis is None:
        return torch.squeeze(x)
    return torch.squeeze(x, _axes_tuple(axis))


@register_op("broadcast_to")
def _broadcast_to(x, shape=()):
    # a 0 in *shape* keeps the input's size (zip stops at the shorter, as
    # the reference's does)
    tgt = tuple(s if t == 0 else t for s, t in zip(x.shape, shape))
    return torch.broadcast_to(x, tgt)


@register_op("broadcast_like")
def _broadcast_like(x, y):
    return torch.broadcast_to(x, y.shape)


@register_op("broadcast_axis", aliases=("broadcast_axes",))
def _broadcast_axis(x, axis=(), size=()):
    tgt = list(x.shape)
    for a, s in zip(_axes_tuple(axis), _axes_tuple(size)):
        tgt[a] = s
    return torch.broadcast_to(x, tuple(tgt))


@register_op("Concat", aliases=("concat",), input_names=())
def _concat(*args, dim=1, num_args=None):
    return torch.cat(args, dim=dim)


alias("_rnn_param_concat", "Concat")


@register_op("stack", input_names=())
def _stack(*args, axis=0, num_args=None):
    return torch.stack(args, dim=axis)


def _split_nout(params):
    return int(params.get("num_outputs", 1))


@register_op("SliceChannel", num_outputs=_split_nout, aliases=("split",))
def _split(x, num_outputs=1, axis=1, squeeze_axis=False):
    n = x.shape[axis]
    if n % num_outputs:
        raise ValueError("array split does not result in an equal "
                         "division: %d into %d" % (n, num_outputs))
    parts = torch.split(x, n // num_outputs, dim=axis)
    if squeeze_axis:
        parts = [p.squeeze(axis) for p in parts]
    return tuple(parts)


alias("crop", "slice")


@register_op("slice_axis")
def _slice_axis_op(x, axis=0, begin=0, end=None):
    return _slice_axis(x, axis % x.dim(), begin, end, None)


@register_op("tile")
def _tile(x, reps=()):
    return torch.tile(x, _axes_tuple(reps))


@register_op("repeat")
def _repeat(x, repeats=1, axis=None):
    return torch.repeat_interleave(x, repeats, dim=axis)


def _pad_index(n, lo, hi, mode, device):
    """Source index of each padded position along an axis of *n*: numpy's
    "edge" repeats the border, "reflect" mirrors about it."""
    i = torch.arange(-lo, n + hi, device=device)
    if mode == "edge" or n == 1:
        return i.clamp(0, n - 1)
    period = 2 * (n - 1)
    i = torch.remainder(i, period)
    return torch.where(i >= n, period - i, i)


@register_op("Pad", aliases=("pad",))
def _pad(x, mode="constant", pad_width=(), constant_value=0.0):
    pw = [(pad_width[2 * i], pad_width[2 * i + 1]) for i in range(x.dim())]
    if mode == "constant":
        flat = [p for lo_hi in reversed(pw) for p in lo_hi]
        return torch.nn.functional.pad(x, flat, value=constant_value)
    if mode not in ("edge", "reflect"):
        raise ValueError("unknown pad mode %r" % mode)
    for axis, (lo, hi) in enumerate(pw):
        if lo or hi:
            x = torch.index_select(
                x, axis, _pad_index(x.shape[axis], lo, hi, mode, x.device))
    return x


@register_op("reverse", aliases=("flip",))
def _reverse(x, axis=()):
    return torch.flip(x, _axes_tuple(axis))


@register_op("depth_to_space")
def _depth_to_space(x, block_size=1):
    n, c, h, w = x.shape
    b = block_size
    x = x.reshape(n, b, b, c // (b * b), h, w)
    x = x.permute(0, 3, 4, 1, 5, 2)
    return x.reshape(n, c // (b * b), h * b, w * b)


# ---------------------------------------------------------------------------
# indexing
# ---------------------------------------------------------------------------

def _gather_index(index, n):
    """*index* as ``jnp`` indexing reads it along an axis of *n*: a
    negative index counts from the end once, then any index is clamped
    into [0, n)."""
    i = index.long()
    i = torch.where(i < 0, i + n, i)
    return i.clamp(0, max(n - 1, 0))


@register_op("take")
def _take(a, indices, axis=0, mode="clip"):
    """Slices of *a* along *axis* by *indices*: "clip" clamps an index
    into [0, n) (a negative one reads 0), "wrap" takes it modulo n,
    "fill" reads NaN for one outside [-n, n)."""
    axis = axis % a.dim()
    n = a.shape[axis]
    i = indices.long()
    if mode == "clip":
        i = i.clamp(0, n - 1)
    elif mode == "wrap":
        i = torch.remainder(i, n)
    elif mode == "fill":
        i, ok = _wrap_index(i, n)
    else:
        raise ValueError("take mode %r is not supported" % (mode,))
    out = torch.index_select(a, axis, i.reshape(-1))
    out = out.reshape(a.shape[:axis] + tuple(i.shape) + a.shape[axis + 1:])
    if mode == "fill":
        okb = ok.reshape((1,) * axis + tuple(ok.shape) +
                         (1,) * (a.dim() - axis - 1))
        out = torch.where(okb, out, torch.full((), _fill_value(a.dtype),
                                               dtype=a.dtype,
                                               device=a.device))
    return out


@register_op("batch_take")
def _batch_take(a, indices):
    flat = a.reshape(-1)
    offs = torch.arange(a.shape[0], device=a.device) * a.shape[1]
    return flat[_gather_index(indices.long() + offs, flat.shape[0])]


@register_op("one_hot")
def _one_hot(indices, depth=0, on_value=1.0, off_value=0.0, dtype="float32"):
    depth = int(depth)
    hot = indices.to(torch.int32).long().unsqueeze(-1) == \
        torch.arange(depth, device=indices.device)
    return hot.to(torch_dtype(dtype)) * (on_value - off_value) + off_value


def _nd_index(indices, shape):
    """The leading index arrays of ``indices`` (M, ...) against the first
    M axes of *shape*, each wrapped and clamped as ``jnp`` indexing
    gathers."""
    return tuple(_gather_index(indices[m], shape[m])
                 for m in range(indices.shape[0]))


@register_op("gather_nd")
def _gather_nd(data, indices):
    return data[_nd_index(indices, data.shape)]


def _scatter(out, idx, values):
    """``out.at[idx].set(values)`` as ``jnp`` scatters it: a negative
    index counts from the end once, one still out of range is dropped.
    Out of place: *out* is not written."""
    m = len(idx)
    lead = out.shape[:m]
    flat = out.reshape((-1,) + out.shape[m:])
    n = flat.shape[0]
    pos = torch.zeros_like(idx[0].long())
    ok = torch.ones_like(pos, dtype=torch.bool)
    for i, size in zip(idx, lead):
        i = i.long()
        i = torch.where(i < 0, i + size, i)
        ok = ok & (i >= 0) & (i < size)
        pos = pos * size + i
    # dropped updates land in one spare row, cut off afterwards
    pos = torch.where(ok, pos, torch.full_like(pos, n))
    spare = torch.cat([flat, flat.new_zeros((1,) + flat.shape[1:])])
    values = torch.broadcast_to(values.to(out.dtype),
                                tuple(pos.shape) + out.shape[m:])
    spare = spare.index_put((pos,), values)
    return spare[:n].reshape(out.shape)


@register_op("scatter_nd")
def _scatter_nd(data, indices, shape=()):
    out = torch.zeros(_shape(shape), dtype=data.dtype, device=data.device)
    return _scatter(out, tuple(indices.to(torch.int32)), data)


@register_op("_scatter_set_nd")
def _scatter_set_nd(lhs, rhs, indices, shape=()):
    return _scatter(lhs, tuple(indices.to(torch.int32)), rhs)


@register_op("where")
def _where(cond, x, y):
    return torch.where(cond != 0, x, y)


def _moved_gather(data_m, rows, batch):
    """``data_m[rows, batch]`` with ``jnp``'s gather rules on *rows*."""
    return data_m[_gather_index(rows, data_m.shape[0]), batch]


@register_op("SequenceMask", input_names=("data", "sequence_length"))
def _sequence_mask(data, *rest, use_sequence_length=False, value=0.0,
                   axis=0):
    """Steps at or past each sequence's length set to *value*; data is
    (seq, batch, ...) for axis 0, (batch, seq, ...) for axis 1."""
    if not use_sequence_length or not rest:
        return data
    seq_len = rest[0]
    bshape = [1] * data.dim()
    bshape[axis] = data.shape[axis]
    steps = torch.arange(data.shape[axis], device=data.device).reshape(
        bshape)
    lshape = [1] * data.dim()
    lshape[1 - axis] = data.shape[1 - axis]
    mask = steps < seq_len.reshape(lshape)
    return torch.where(mask, data, torch.full((), value, dtype=data.dtype,
                                              device=data.device))


@register_op("SequenceLast", input_names=("data", "sequence_length"))
def _sequence_last(data, *rest, use_sequence_length=False, axis=0):
    if not use_sequence_length or not rest:
        return torch.select(data, axis, data.shape[axis] - 1)
    idx = rest[0].to(torch.int32) - 1
    data_m = torch.movedim(data, axis, 0)
    batch = torch.arange(data_m.shape[1], device=data.device)
    return _moved_gather(data_m, idx, batch)


@register_op("SequenceReverse", input_names=("data", "sequence_length"))
def _sequence_reverse(data, *rest, use_sequence_length=False, axis=0):
    if not use_sequence_length or not rest:
        return torch.flip(data, (axis,))
    seq_len = rest[0].to(torch.int32).unsqueeze(0)
    t = data.shape[axis]
    data_m = torch.movedim(data, axis, 0)
    steps = torch.arange(t, device=data.device).unsqueeze(1)
    rev_idx = torch.where(steps < seq_len, seq_len - 1 - steps, steps)
    batch = torch.arange(data_m.shape[1], device=data.device).unsqueeze(0)
    return torch.movedim(_moved_gather(data_m, rev_idx, batch), 0, axis)


# ---------------------------------------------------------------------------
# ordering: indices come back as float32 (the dtype parameter), ties in
# the order of their positions
# ---------------------------------------------------------------------------

@register_op("sort")
def _sort(x, axis=-1, is_ascend=True):
    out = torch.sort(x, dim=axis, stable=True).values
    return out if is_ascend else torch.flip(out, (axis,))


@register_op("argsort")
def _argsort(x, axis=-1, is_ascend=True, dtype="float32"):
    out = torch.argsort(x, dim=axis, stable=True)
    if not is_ascend:
        out = torch.flip(out, (axis,))
    return out.to(torch_dtype(dtype))


def _topk_nout(params):
    return 2 if params.get("ret_typ", "indices") == "both" else 1


@register_op("topk", num_outputs=_topk_nout)
def _topk(x, axis=-1, k=1, ret_typ="indices", is_ascend=False,
          dtype="float32"):
    """The k largest (smallest with *is_ascend*) along *axis*, tied values
    in the order of their positions, as ``lax.top_k`` returns them."""
    axis = axis % x.dim()
    k = int(k)
    if k <= 0:
        k = x.shape[axis]
    xm = torch.movedim(x, axis, -1)
    vals, idx = torch.sort(xm, dim=-1, descending=not is_ascend,
                           stable=True)
    vals, idx = vals[..., :k], idx[..., :k]
    if ret_typ == "mask":
        hot = torch.zeros_like(xm).scatter(-1, idx, 1)
        return torch.movedim(hot, -1, axis)
    vals = torch.movedim(vals, -1, axis)
    idx = torch.movedim(idx, -1, axis).to(torch_dtype(dtype))
    if ret_typ == "value":
        return vals
    if ret_typ == "indices":
        return idx
    if ret_typ == "both":
        return vals, idx
    raise ValueError(ret_typ)


def _arg(fn):
    def f(x, axis=None, keepdims=False):
        if axis is None:
            out = fn(x.reshape(-1), 0)
            if keepdims:
                out = out.reshape((1,) * x.dim())
        else:
            out = fn(x, axis)
            if keepdims:
                out = out.unsqueeze(axis)
        return out.to(torch.float32)
    return f


register_op("argmax")(_arg(lambda x, a: torch.argmax(x, dim=a)))
register_op("argmin")(_arg(lambda x, a: torch.argmin(x, dim=a)))


@register_op("argmax_channel")
def _argmax_channel(x):
    return torch.argmax(x, dim=1).to(torch.float32)


@register_op("shuffle", needs_rng=True, aliases=("_shuffle",))
def _shuffle(rng, x):
    """A random permutation of the rows (axis 0), drawn from the
    ``torch.Generator`` *rng*."""
    perm = torch.randperm(x.shape[0], generator=rng, device=rng.device)
    return x[perm.to(x.device)]


# ---------------------------------------------------------------------------
# products: float32 in full float32 (no TF32), the reference's HIGHEST
# precision for float32
# ---------------------------------------------------------------------------

@register_op("dot")
def _dot(a, b, transpose_a=False, transpose_b=False):
    """The last axis of *a* against the first of *b* (MXNet's dot)."""
    if transpose_a and a.dim() > 1:
        a = torch.swapaxes(a, -1, -2)
    if transpose_b and b.dim() > 1:
        b = torch.swapaxes(b, -1, -2)
    if a.dim() == 1 and b.dim() == 1:
        return torch.dot(a, b)
    return torch.tensordot(a, b, dims=([a.dim() - 1], [0]))


@register_op("batch_dot")
def _batch_dot(a, b, transpose_a=False, transpose_b=False):
    if transpose_a:
        a = torch.swapaxes(a, -1, -2)
    if transpose_b:
        b = torch.swapaxes(b, -1, -2)
    return torch.matmul(a, b)


@register_op("khatri_rao", input_names=())
def _khatri_rao(*mats):
    out = mats[0]
    for m in mats[1:]:
        out = torch.einsum("i...,j...->ij...", out, m).reshape(
            (out.shape[0] * m.shape[0],) + tuple(out.shape[1:]))
    return out


@register_op("diag")
def _diag(x, k=0, axis1=0, axis2=1):
    if x.dim() == 1:
        return torch.diag(x, k)
    return torch.diagonal(x, offset=k, dim1=axis1, dim2=axis2)


@register_op("norm")
def _norm(x, ord=2, axis=None, keepdims=False):
    """The 2-norm (any *ord* but 1) or the 1-norm over *axis*; over every
    axis the result is 0-d (shape (1,) * ndim with *keepdims*)."""
    if axis is None:
        v = torch.sqrt(torch.sum(torch.square(x))) if ord == 2 \
            else torch.sum(torch.abs(x))
        return v.reshape((1,) * x.dim()) if keepdims else v.reshape(())
    axis = _axes_tuple(axis)
    if ord == 1:
        return torch.sum(torch.abs(x), dim=axis, keepdim=keepdims)
    return torch.sqrt(torch.sum(torch.square(x), dim=axis,
                                keepdim=keepdims))


@register_op("ravel_multi_index", aliases=("_ravel_multi_index",))
def _ravel_multi_index(data, shape=()):
    idx = data.to(torch.int32)
    out = torch.zeros(data.shape[1:], dtype=torch.int32, device=data.device)
    for i, s in enumerate(shape):
        out = out * s + idx[i]
    return out.to(torch.float32)


@register_op("unravel_index", aliases=("_unravel_index",))
def _unravel_index(data, shape=()):
    idx = data.to(torch.int32)
    outs = []
    for s in reversed(shape):
        outs.append(torch.remainder(idx, s))
        idx = torch.div(idx, s, rounding_mode="floor")
    return torch.stack(outs[::-1], dim=0).to(torch.float32)
