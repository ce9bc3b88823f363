"""NDArray — the imperative tensor (port of ``mxnet_tpu/ndarray/ndarray.py``).

An NDArray is a thin holder of a ``torch.Tensor``.  CUDA work is queued
on the current stream; ``asnumpy()`` copies to the host and is the sync
point, as ``WaitToRead`` is in the reference.

Ops run with PyTorch's grad mode set to ``autograd.is_recording()``, so
inside ``autograd.record()`` they are taped and outside it they are not.

The reference's arrays are immutable, and the port keeps its semantics
where PyTorch's differ:

- ``a[key] = v`` and the in-place operators (``+=``, ...) rebind ``a`` to
  a new tensor and never write the old one, so an array taken from ``a``
  before (``a.reshape(...)``, ``a[0]``) keeps its value; ``a[key] = v``
  also cuts ``a`` from the tape;
- an integer index out of range is clamped when read (``a[5]`` of two
  rows is the last row) and dropped when written (``a[5] = 1`` does
  nothing); a negative one counts from the end once;
- comparisons return the array's dtype (0/1), and index results
  (``argmax``, ``argsort``, ``topk``) are float32;
- a reduction over every axis is 0-d.
"""

from __future__ import annotations

import numpy as _np
import torch

from .. import autograd as _ag
from ..base import np_dtype, narrow_dtype, torch_dtype
from ..context import Context, current_context, context_of
from ..ops import registry as _reg
from ..runtime import rng as _rng

__all__ = ["NDArray", "array", "zeros", "ones", "full", "empty", "arange",
           "zeros_like", "ones_like", "concatenate", "imperative_invoke",
           "waitall", "moveaxis", "transpose"]


def _to_numpy(t):
    # always a copy: a CPU tensor's numpy() would share its memory, and
    # optimizer updates write parameters in place
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        # numpy has no bfloat16: hand back its bits under ml_dtypes' type
        return t.view(torch.int16).numpy().view(np_dtype("bfloat16"))
    return t.numpy()


def _from_numpy(arr):
    if not arr.flags.c_contiguous:
        # (np.ascontiguousarray alone would turn a 0-d array into (1,))
        arr = _np.ascontiguousarray(arr)
    if not arr.flags.writeable:     # torch tensors always share writably
        arr = arr.copy()
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(_np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class NDArray:
    """Multi-dimensional array on a device."""

    __slots__ = ("_data", "_grad")

    def __init__(self, data, ctx=None):
        if isinstance(data, NDArray):
            data = data._data
        if not isinstance(data, torch.Tensor):
            data = _from_numpy(_np.asarray(data))
        if ctx is not None:
            data = data.to(Context(ctx).torch_device)
        self._data = data
        self._grad = None

    # -- properties -------------------------------------------------------
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

    @property
    def size(self):
        return self._data.numel()

    @property
    def ndim(self):
        return self._data.dim()

    @property
    def stype(self):
        return "default"

    @property
    def handle(self):
        # the reference hands out its jax.Array; this is the tensor
        return self._data

    @property
    def grad(self):
        """The gradient buffer attached by ``attach_grad`` (or None)."""
        return self._grad

    @property
    def T(self):
        return transpose(self)

    # -- sync / conversion ------------------------------------------------
    def asnumpy(self):
        """Copy to a numpy array (waits for the value)."""
        return _to_numpy(self._data)

    asnpy = asnumpy

    def asscalar(self):
        if self.size != 1:
            raise ValueError("The current array is not a scalar")
        return self.asnumpy().reshape(()).item()

    item = asscalar

    def tolist(self):
        return self.asnumpy().tolist()

    def wait_to_read(self):
        """Wait until the value is computed."""
        if self._data.is_cuda:
            torch.cuda.current_stream(self._data.device).synchronize()
        return self

    def astype(self, dtype, copy=True):
        dtype = narrow_dtype(dtype)
        if not copy and self.dtype == np_dtype(dtype):
            return self
        return _invoke("Cast", [self], {"dtype": narrow_dtype(dtype)})

    def copy(self):
        return _invoke("_copy", [self], {})

    def copyto(self, other):
        """Copy into NDArray *other* (rebinding it to this value in its
        dtype, on its device, off the tape), or onto a Context."""
        if isinstance(other, NDArray):
            other._data = self._data.detach().to(other._data.device,
                                                 other._data.dtype,
                                                 copy=True)
            return other
        if isinstance(other, Context):
            return NDArray(self._data.detach().to(other.torch_device,
                                                  copy=True))
        raise TypeError("copyto does not support type " + str(type(other)))

    def as_in_context(self, ctx):
        ctx = Context(ctx)
        if ctx == self.context:
            return self
        return NDArray(self._data, ctx=ctx)

    as_in_ctx = as_in_context

    def tostype(self, stype):
        """This array in storage type *stype* ("default", "row_sparse" or
        "csr"; see ``ndarray/sparse.py``)."""
        if stype == "default":
            return self
        from . import sparse as _sp
        return _sp.cast_storage(self, stype)

    # -- autograd ---------------------------------------------------------
    def attach_grad(self, grad_req="write", stype=None):
        """Allocate a gradient buffer (zeros on this array's device) and
        mark this array as a variable (reference: ndarray.py
        attach_grad -> MarkVariables).  The buffer is dense whatever
        *stype* asks, as in the JAX package."""
        grad = NDArray(torch.zeros_like(self._data,
                                        memory_format=torch.contiguous_format))
        _ag.mark_variables([self], [grad], grad_req)

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        """Gradients of this array with respect to the marked variables
        (see ``autograd.backward``)."""
        _ag.backward([self], [out_grad] if out_grad is not None else None,
                     retain_graph=retain_graph, train_mode=train_mode)

    def detach(self):
        """The same value, cut from the tape."""
        return NDArray(self._data.detach())

    # -- python protocol --------------------------------------------------
    def __repr__(self):
        return "%s\n<NDArray %s @%s>" % (
            str(self.asnumpy()), "x".join(map(str, self.shape)), self.context)

    def __len__(self):
        if self.ndim == 0:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    def __bool__(self):
        if self.size == 1:
            return bool(self.asnumpy())
        raise ValueError("The truth value of an NDArray with multiple "
                         "elements is ambiguous")

    def __float__(self):
        return float(self.asscalar())

    def __int__(self):
        return int(self.asscalar())

    def __iter__(self):
        for i in range(self.shape[0]):
            yield self[i]

    # arithmetic: an NDArray operand runs the broadcast op, a Python or
    # numpy scalar the scalar op (as a float, as in the reference)
    def __add__(self, other):
        return _binary("broadcast_add", "_plus_scalar", self, other)

    def __radd__(self, other):
        return self.__add__(other)

    def __sub__(self, other):
        return _binary("broadcast_sub", "_minus_scalar", self, other)

    def __rsub__(self, other):
        return _invoke("_rminus_scalar", [self], {"scalar": float(other)})

    def __mul__(self, other):
        return _binary("broadcast_mul", "_mul_scalar", self, other)

    def __rmul__(self, other):
        return self.__mul__(other)

    def __truediv__(self, other):
        return _binary("broadcast_div", "_div_scalar", self, other)

    def __rtruediv__(self, other):
        return _invoke("_rdiv_scalar", [self], {"scalar": float(other)})

    def __mod__(self, other):
        return _binary("broadcast_mod", "_mod_scalar", self, other)

    def __rmod__(self, other):
        return _invoke("_rmod_scalar", [self], {"scalar": float(other)})

    def __pow__(self, other):
        return _binary("broadcast_power", "_power_scalar", self, other)

    def __rpow__(self, other):
        return _invoke("_rpower_scalar", [self], {"scalar": float(other)})

    def __neg__(self):
        return _invoke("negative", [self], {})

    def __abs__(self):
        return _invoke("abs", [self], {})

    def __eq__(self, other):
        return _binary("broadcast_equal", "_equal_scalar", self, other)

    def __ne__(self, other):
        return _binary("broadcast_not_equal", "_not_equal_scalar", self,
                       other)

    def __gt__(self, other):
        return _binary("broadcast_greater", "_greater_scalar", self, other)

    def __ge__(self, other):
        return _binary("broadcast_greater_equal", "_greater_equal_scalar",
                       self, other)

    def __lt__(self, other):
        return _binary("broadcast_lesser", "_lesser_scalar", self, other)

    def __le__(self, other):
        return _binary("broadcast_lesser_equal", "_lesser_equal_scalar",
                       self, other)

    # == returns an array, so identity is the hash (and `x in list`
    # compares by ==: code of the package tests identity with `is`)
    __hash__ = object.__hash__

    # in place: rebind to the new value, never write the old tensor
    def __iadd__(self, other):
        self._data = self.__add__(other)._data
        return self

    def __isub__(self, other):
        self._data = self.__sub__(other)._data
        return self

    def __imul__(self, other):
        self._data = self.__mul__(other)._data
        return self

    def __itruediv__(self, other):
        self._data = self.__truediv__(other)._data
        return self

    # indexing
    def __getitem__(self, key):
        key = _index_key(key, self._data)
        with torch.set_grad_enabled(_ag.is_recording()):
            return NDArray(self._data[key])

    def __setitem__(self, key, value):
        """Rebind to a copy with ``value`` written at ``key`` (an index out
        of range is dropped), cut from the tape."""
        t = self._data.detach()
        if isinstance(value, NDArray):
            value = value._data.detach()
        value = torch.as_tensor(value, device=t.device).to(t.dtype)
        self._data = _scatter_key(t, key, value)

    # -- op methods (the reference's NDArray methods) --------------------
    def reshape(self, *shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        shape = kwargs.get("shape", shape)
        return _invoke("Reshape", [self],
                       {"shape": tuple(shape),
                        "reverse": kwargs.get("reverse", False)})

    def reshape_like(self, other):
        return _invoke("reshape_like", [self, other], {})

    def expand_dims(self, axis):
        return _invoke("expand_dims", [self], {"axis": axis})

    def squeeze(self, axis=None):
        return _invoke("squeeze", [self], {"axis": axis})

    def flatten(self):
        return _invoke("Flatten", [self], {})

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (tuple, list)):
            axes = tuple(axes[0])
        return _invoke("transpose", [self], {"axes": axes or None})

    def swapaxes(self, dim1, dim2):
        return _invoke("SwapAxis", [self], {"dim1": dim1, "dim2": dim2})

    def broadcast_to(self, shape):
        return _invoke("broadcast_to", [self], {"shape": tuple(shape)})

    def broadcast_like(self, other):
        return _invoke("broadcast_like", [self, other], {})

    def slice(self, begin, end, step=None):
        return _invoke("slice", [self],
                       {"begin": tuple(begin), "end": tuple(end),
                        "step": tuple(step) if step else ()})

    def slice_axis(self, axis, begin, end):
        return _invoke("slice_axis", [self],
                       {"axis": axis, "begin": begin, "end": end})

    def take(self, indices, axis=0, mode="clip"):
        return _invoke("take", [self, _as_nd(indices, like=self)],
                       {"axis": axis, "mode": mode})

    def one_hot(self, depth, **kw):
        return _invoke("one_hot", [self], dict(depth=depth, **kw))

    def pick(self, index, axis=-1, keepdims=False):
        return _invoke("pick", [self, _as_nd(index, like=self)],
                       {"axis": axis, "keepdims": keepdims})

    def clip(self, a_min=None, a_max=None):
        return _invoke("clip", [self], {"a_min": a_min, "a_max": a_max})

    def abs(self):
        return _invoke("abs", [self], {})

    def sign(self):
        return _invoke("sign", [self], {})

    def sqrt(self):
        return _invoke("sqrt", [self], {})

    def square(self):
        return _invoke("square", [self], {})

    def exp(self):
        return _invoke("exp", [self], {})

    def log(self):
        return _invoke("log", [self], {})

    def relu(self):
        return _invoke("relu", [self], {})

    def sigmoid(self):
        return _invoke("sigmoid", [self], {})

    def tanh(self):
        return _invoke("tanh", [self], {})

    def softmax(self, axis=-1):
        return _invoke("softmax", [self], {"axis": axis})

    def log_softmax(self, axis=-1):
        return _invoke("log_softmax", [self], {"axis": axis})

    def sum(self, axis=None, keepdims=False, exclude=False):
        return _invoke("sum", [self], {"axis": axis, "keepdims": keepdims,
                                       "exclude": exclude})

    def mean(self, axis=None, keepdims=False, exclude=False):
        return _invoke("mean", [self], {"axis": axis, "keepdims": keepdims,
                                        "exclude": exclude})

    def prod(self, axis=None, keepdims=False):
        return _invoke("prod", [self], {"axis": axis, "keepdims": keepdims})

    def max(self, axis=None, keepdims=False):
        return _invoke("max", [self], {"axis": axis, "keepdims": keepdims})

    def min(self, axis=None, keepdims=False):
        return _invoke("min", [self], {"axis": axis, "keepdims": keepdims})

    def norm(self, ord=2, axis=None, keepdims=False):
        return _invoke("norm", [self],
                       {"ord": ord, "axis": axis, "keepdims": keepdims})

    def argmax(self, axis=None, keepdims=False):
        return _invoke("argmax", [self], {"axis": axis, "keepdims": keepdims})

    def argmin(self, axis=None, keepdims=False):
        return _invoke("argmin", [self], {"axis": axis, "keepdims": keepdims})

    def argsort(self, axis=-1, is_ascend=True):
        return _invoke("argsort", [self],
                       {"axis": axis, "is_ascend": is_ascend})

    def sort(self, axis=-1, is_ascend=True):
        return _invoke("sort", [self], {"axis": axis, "is_ascend": is_ascend})

    def topk(self, axis=-1, k=1, ret_typ="indices", is_ascend=False):
        return _invoke("topk", [self], {"axis": axis, "k": k,
                                        "ret_typ": ret_typ,
                                        "is_ascend": is_ascend})

    def flip(self, axis):
        return _invoke("reverse", [self], {"axis": axis})

    def tile(self, reps):
        return _invoke("tile", [self], {"reps": tuple(reps)})

    def repeat(self, repeats, axis=None):
        return _invoke("repeat", [self], {"repeats": repeats, "axis": axis})

    def split(self, num_outputs, axis=1, squeeze_axis=False):
        return _invoke("SliceChannel", [self],
                       {"num_outputs": num_outputs, "axis": axis,
                        "squeeze_axis": squeeze_axis})

    def dot(self, other, transpose_a=False, transpose_b=False):
        return _invoke("dot", [self, other],
                       {"transpose_a": transpose_a,
                        "transpose_b": transpose_b})

    def zeros_like(self):
        return zeros_like(self)

    def ones_like(self):
        return ones_like(self)


# ---------------------------------------------------------------------------
# indexing with the reference's rules
# ---------------------------------------------------------------------------

def _expand_key(key, ndim):
    """*key* as a list of (entry, axis) pairs, Ellipsis and the trailing
    axes expanded to full slices; an
    NDArray entry becomes its tensor (as int32, as the reference casts
    it); None entries carry axis None."""
    if not isinstance(key, tuple):
        key = (key,)
    key = tuple(k._data.to(torch.int32) if isinstance(k, NDArray) else k
                for k in key)
    used = sum(1 for k in key if k is not None and k is not Ellipsis)
    out, axis = [], 0
    for k in key:
        if k is Ellipsis:
            for _ in range(ndim - used):
                out.append((slice(None), axis))
                axis += 1
        elif k is None:
            out.append((None, None))
        else:
            out.append((k, axis))
            axis += 1
    out.extend((slice(None), a) for a in range(axis, ndim))
    return out


def _norm_index(i, n):
    """An integer index (int or tensor) with a negative one counted from
    the end once."""
    if isinstance(i, torch.Tensor):
        i = i.long()
        return torch.where(i < 0, i + n, i)
    i = int(i)
    return i + n if i < 0 else i


def _neg_step(k, n, device, entries):
    """A slice of negative step as an index array (torch slices take no
    negative step); only where no other array index would move the
    result's axes."""
    if sum(isinstance(e, torch.Tensor) or
           (isinstance(e, slice) and e.step is not None and e.step < 0)
           for e, _ in entries) > 1:
        raise NotImplementedError("a negative-step slice beside another "
                                  "array index")
    return torch.arange(*k.indices(n), device=device)


def _is_neg_step(k):
    return isinstance(k, slice) and k.step is not None and k.step < 0


def _index_key(key, t):
    """The torch key reading *key* of *t* as ``jnp`` does: an integer
    index (int or array) counts from the end once and is then clamped
    into range."""
    entries = _expand_key(key, t.dim())
    out = []
    for k, axis in entries:
        if k is None or isinstance(k, slice):
            if _is_neg_step(k):
                k = _neg_step(k, t.shape[axis], t.device, entries)
            out.append(k)
            continue
        n = t.shape[axis]
        if isinstance(k, torch.Tensor):
            out.append(_norm_index(k, n).clamp(0, max(n - 1, 0)))
        else:
            out.append(min(max(_norm_index(k, n), 0), max(n - 1, 0)))
    return tuple(out)


def _scatter_key(t, key, value):
    """A copy of *t* with *value* written at *key* as ``jnp``'s
    ``.at[key].set`` writes it: a negative index counts from the end
    once, one still out of range is dropped.  The flat position of every
    written element under an index array is read from an index tensor
    one larger on each axis whose extra slot marks "out of range", so
    nothing is read back to the host."""
    entries = _expand_key(key, t.dim())
    shape = tuple(t.shape)
    if not any(isinstance(k, torch.Tensor) for k, _ in entries):
        # ints and slices only: an int out of range drops the whole write
        basic = []
        for k, axis in entries:
            if k is None or isinstance(k, slice):
                basic.append(_neg_step(k, shape[axis], t.device, entries)
                             if _is_neg_step(k) else k)
                continue
            i = _norm_index(k, shape[axis])
            if not 0 <= i < shape[axis]:
                return t.clone()
            basic.append(i)
        out = t.clone()
        out[tuple(basic)] = value
        return out
    numel = t.numel()
    pos_shape = tuple(n + 1 for n in shape)
    pos_all = torch.full(pos_shape, -1, dtype=torch.long, device=t.device)
    pos_all[tuple(slice(0, n) for n in shape)] = torch.arange(
        numel, device=t.device).reshape(shape)
    pk = []
    for k, axis in entries:
        if k is None:
            pk.append(None)
            continue
        n = shape[axis]
        if isinstance(k, slice):
            if _is_neg_step(k):
                pk.append(_neg_step(k, n, t.device, entries))
            else:
                pk.append(slice(*k.indices(n)))
        elif isinstance(k, torch.Tensor):
            i = _norm_index(k, n)
            pk.append(torch.where((i >= 0) & (i < n), i,
                                  torch.full_like(i, n)))
        else:
            i = _norm_index(k, n)
            pk.append(i if 0 <= i < n else n)
    pos = pos_all[tuple(pk)]
    value = torch.broadcast_to(value, pos.shape)
    # dropped writes land in one spare slot, cut off afterwards
    pos = torch.where(pos >= 0, pos, torch.full_like(pos, numel))
    flat = torch.cat([t.reshape(-1), t.new_zeros(1)])
    flat = flat.index_put((pos.reshape(-1),), value.reshape(-1))
    return flat[:numel].reshape(shape)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def _as_nd(x, like):
    """*x* as an NDArray, on *like*'s device if it is not one already."""
    return x if isinstance(x, NDArray) else array(x, ctx=like.context)


def _binary(op_name, scalar_op, lhs, rhs):
    if isinstance(rhs, NDArray):
        return _invoke(op_name, [lhs, rhs], {})
    if isinstance(rhs, (int, float, _np.generic)):
        return _invoke(scalar_op, [lhs], {"scalar": float(rhs)})
    return _invoke(op_name, [lhs, _as_nd(rhs, like=lhs)], {})


def _invoke(op_name, nd_inputs, params, out=None, ctx=None):
    """Run op *op_name* eagerly on NDArrays: the visible outputs (one
    NDArray, or a list when the op surfaces several), or *out* rebound
    to them.  An op with no array input makes its result on *ctx*
    (default: the current context).  A random op draws from the global
    stream's generator of its device (``runtime/rng.py``); an op with a
    ``training`` parameter gets ``autograd.is_training()`` unless it is
    given one (a random op's is on when either says so)."""
    op = _reg.get_op(op_name)
    params = {k: v for k, v in params.items() if v is not None}
    if "training" in op.param_names:
        training = _ag.is_training()
        if op.needs_rng:
            params["training"] = training or params.get("training", False)
        else:
            params.setdefault("training", training)
    args = [x._data for x in nd_inputs]
    if args and ctx is None:
        device = args[0].device
    else:
        device = (Context(ctx) if ctx is not None
                  else current_context()).torch_device
    if op.needs_rng:
        args.insert(0, _rng.generator(device))
    with torch.set_grad_enabled(_ag.is_recording()):
        if nd_inputs:
            res = op.fn(*args, **params)
        else:
            with device:
                res = op.fn(*args, **params)
    if not isinstance(res, tuple):
        res = (res,)
    outs = [NDArray(r) for r in res[:op.n_visible(params)]]
    if out is not None:
        targets = out if isinstance(out, (list, tuple)) else [out]
        for t, o in zip(targets, outs):
            t._data = o._data
        return out
    return outs[0] if len(outs) == 1 else outs


def imperative_invoke(op_name, *nd_inputs, out=None, ctx=None, **params):
    """Run an op eagerly on NDArrays (see ``_invoke``)."""
    return _invoke(op_name, list(nd_inputs), params, out=out, ctx=ctx)


# ---------------------------------------------------------------------------
# creation functions
# ---------------------------------------------------------------------------



def _device(ctx):
    return (Context(ctx) if ctx is not None else current_context()
            ).torch_device


def array(source_array, ctx=None, dtype=None):
    """An NDArray on *ctx* (default: the current context) from array-like
    data.  As in the reference, float64 data defaults to float32 and
    integer data (int64 numpy arrays, Python ints) to int32, and a 64-bit
    *dtype* narrows (outside ``enable_x64()``); a 0-d source stays 0-d."""
    if dtype is not None:
        dtype = narrow_dtype(dtype)
    if isinstance(source_array, NDArray):
        t = source_array._data.detach()
    elif isinstance(source_array, torch.Tensor):
        t = source_array
    else:
        arr = _np.asarray(source_array)
        if dtype is None and arr.dtype.name != narrow_dtype(arr.dtype):
            arr = arr.astype(narrow_dtype(arr.dtype))
        t = _from_numpy(arr)
    if dtype is None and t.dtype == torch.float64:
        dtype = "float32"
    return NDArray(t.to(device=_device(ctx), dtype=torch_dtype(dtype)
                        if dtype else None, copy=True))


def _shape_of(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def zeros(shape, ctx=None, dtype=None, **kwargs):
    return NDArray(torch.zeros(_shape_of(shape),
                               dtype=torch_dtype(narrow_dtype(dtype)),
                               device=_device(ctx)))


def empty(shape, ctx=None, dtype=None):
    return zeros(shape, ctx, dtype)


def ones(shape, ctx=None, dtype=None, **kwargs):
    return NDArray(torch.ones(_shape_of(shape),
                              dtype=torch_dtype(narrow_dtype(dtype)),
                              device=_device(ctx)))


def full(shape, val, ctx=None, dtype=None):
    return NDArray(torch.full(_shape_of(shape), val,
                              dtype=torch_dtype(narrow_dtype(dtype)),
                              device=_device(ctx)))


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype=None):
    """Values from *start* up to *stop* by *step* (numpy's arange, as the
    reference's), each repeated *repeat* times; float32 by default."""
    return _invoke("_arange", [], {"start": start, "stop": stop,
                                   "step": step, "repeat": repeat,
                                   "dtype": narrow_dtype(dtype)}, ctx=ctx)


def zeros_like(other):
    return NDArray(torch.zeros_like(other._data))


def ones_like(other):
    return NDArray(torch.ones_like(other._data))


def concatenate(arrays, axis=0, always_copy=True):
    return _invoke("Concat", list(arrays), {"dim": axis})


def moveaxis(tensor, source, destination):
    with torch.set_grad_enabled(_ag.is_recording()):
        return NDArray(torch.movedim(tensor._data, source, destination))


def transpose(data, axes=None):
    return _invoke("transpose", [data], {"axes": axes})


def waitall():
    """Wait for all queued work on every CUDA device (reference:
    ``engine.wait_all``); nothing to wait for on the CPU."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)
