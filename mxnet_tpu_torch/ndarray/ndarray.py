"""NDArray — the imperative tensor (port of ``mxnet_tpu/ndarray/ndarray.py``,
subset).

An NDArray is a thin holder of a ``torch.Tensor``.  CUDA work is queued
on the current stream; ``asnumpy()`` copies to the host and is the sync
point, as ``WaitToRead`` is in the reference.
"""

from __future__ import annotations

import numpy as _np
import torch

from ..base import np_dtype, torch_dtype
from ..context import Context, current_context, context_of
from ..ops import registry as _reg

__all__ = ["NDArray", "array", "zeros", "imperative_invoke"]


def _to_numpy(t):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        # numpy has no bfloat16: hand back its bits under ml_dtypes' type
        return t.view(torch.int16).numpy().view(np_dtype("bfloat16"))
    return t.numpy()


def _from_numpy(arr):
    arr = _np.ascontiguousarray(arr)
    if not arr.flags.writeable:     # torch tensors always share writably
        arr = arr.copy()
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(_np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class NDArray:
    """Multi-dimensional array on a device."""

    __slots__ = ("_data",)

    def __init__(self, data, ctx=None):
        if isinstance(data, NDArray):
            data = data._data
        if not isinstance(data, torch.Tensor):
            data = _from_numpy(_np.asarray(data))
        if ctx is not None:
            data = data.to(Context(ctx).torch_device)
        self._data = data

    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        return np_dtype(self._data.dtype)

    @property
    def context(self):
        return context_of(self._data)

    ctx = context

    def asnumpy(self):
        """Copy to a numpy array (waits for the value)."""
        return _to_numpy(self._data)

    def as_in_context(self, ctx):
        ctx = Context(ctx)
        if ctx == self.context:
            return self
        return NDArray(self._data, ctx=ctx)

    as_in_ctx = as_in_context

    def __repr__(self):
        return "%s\n<NDArray %s @%s>" % (
            str(self.asnumpy()), "x".join(map(str, self.shape)), self.context)

    def __add__(self, other):
        if not isinstance(other, NDArray):
            raise TypeError("NDArray + %s is not ported" % type(other))
        return imperative_invoke("broadcast_add", self, other)

    def __radd__(self, other):
        return self.__add__(other)


def imperative_invoke(op_name, *nd_inputs, out=None, **params):
    """Run an op eagerly on NDArrays; returns the visible outputs (one
    NDArray, or a list when the op surfaces several)."""
    op = _reg.get_op(op_name)
    params = {k: v for k, v in params.items() if v is not None}
    res = op.fn(*[x._data for x in nd_inputs], **params)
    if not isinstance(res, tuple):
        res = (res,)
    outs = [NDArray(r) for r in res[:op.n_visible(params)]]
    if out is not None:
        out._data = outs[0]._data
        return out
    return outs[0] if len(outs) == 1 else outs


def array(source_array, ctx=None, dtype=None):
    """An NDArray on *ctx* (default: the current context) from array-like
    data; float64 data defaults to float32, as in the reference."""
    if isinstance(source_array, NDArray):
        t = source_array._data
    elif isinstance(source_array, torch.Tensor):
        t = source_array
    else:
        t = _from_numpy(_np.asarray(source_array))
    if dtype is None and t.dtype == torch.float64:
        dtype = "float32"
    dev = (Context(ctx) if ctx is not None else current_context()).torch_device
    return NDArray(t.to(device=dev, dtype=torch_dtype(dtype) if dtype
                        else None, copy=True))


def zeros(shape, ctx=None, dtype=None, **kwargs):
    if isinstance(shape, int):
        shape = (shape,)
    dev = (Context(ctx) if ctx is not None else current_context()).torch_device
    return NDArray(torch.zeros(shape, dtype=torch_dtype(dtype), device=dev))

