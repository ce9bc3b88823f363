"""Sparse NDArrays: row_sparse and CSR (port of
``mxnet_tpu/ndarray/sparse.py``).

A sparse array is a pair (or triple) of dense tensors: ``RowSparseNDArray``
holds its values ``(nnz_rows, *row_shape)`` beside the row ids
``(nnz_rows,)``; ``CSRNDArray`` its values and column ids ``(nnz,)`` beside
``indptr`` ``(rows + 1,)``.  The values tensor is the NDArray's own
``_data``; the index tensors are ``_aux``.

Row-sparse gradients feed the lazy row updates (``sgd_row_update``,
``sgd_mom_row_update``, ``adagrad_row_update``), which read and write only
the gradient's rows: momentum, history and weight decay leave every other
row bit-unchanged (the reference's ``lazy_update``).  A row id outside
``[0, rows)`` is dropped, as a JAX scatter drops it: the executor pads
its deduplicated (ids, values) pairs with the id ``rows``
(``ops/sparse_graph.py``).  The updates write each row once with
``index_put_``, so they capture in a CUDA graph and need no readback.
"""

from __future__ import annotations

import numpy as _np
import torch

from ..base import np_dtype, torch_dtype
from .ndarray import NDArray, array as _array

__all__ = ["BaseSparseNDArray", "RowSparseNDArray", "CSRNDArray",
           "row_sparse_array", "csr_matrix", "cast_storage", "zeros",
           "dot", "retain", "sparse_add", "elemwise_mul",
           "compress_rowsparse", "sgd_row_update", "sgd_mom_row_update",
           "adagrad_row_update"]


def _t(x, device=None, dtype=None):
    """*x* (NDArray, tensor or array-like) as a tensor."""
    if isinstance(x, NDArray):
        x = x._data
    if not isinstance(x, torch.Tensor):
        x = _array(_np.asarray(x), ctx="cpu")._data
    if device is not None or dtype is not None:
        x = x.to(device=device, dtype=dtype)
    return x


class BaseSparseNDArray(NDArray):
    """Common base of the sparse storage types: the values tensor is
    ``_data``, the index tensors ``_aux``."""

    def __init__(self, data, indices, shape, stype):
        super().__init__(_t(data))
        self._aux = [_t(indices, self._data.device)]
        self._shape = tuple(int(s) for s in shape)
        self._stype = stype

    @property
    def shape(self):
        return self._shape

    @property
    def stype(self):
        return self._stype

    @property
    def size(self):
        return int(_np.prod(self._shape))

    @property
    def ndim(self):
        return len(self._shape)

    @property
    def data(self):
        return NDArray(self._data)

    @property
    def indices(self):
        return NDArray(self._aux[0])

    def asnumpy(self):
        return self.todense().asnumpy()

    def astype(self, dtype, copy=True):
        out = self.copy()
        out._data = out._data.to(torch_dtype(dtype))
        return out

    def as_in_context(self, ctx):
        from ..context import Context
        dev = Context(ctx).torch_device
        out = self.copy()
        out._data = out._data.to(dev)
        out._aux = [a.to(dev) for a in out._aux]
        return out

    def __repr__(self):
        return "\n<%s %s @%s>" % (type(self).__name__,
                                  "x".join(map(str, self.shape)),
                                  self.context)

    def tostype(self, stype):
        if stype == self._stype:
            return self
        return cast_storage(self, stype)


class RowSparseNDArray(BaseSparseNDArray):
    """values: (nnz_rows, *row_shape); indices: (nnz_rows,) row ids."""

    def __init__(self, data, indices, shape):
        super().__init__(data, indices, shape, "row_sparse")

    def todense(self):
        """The dense array: rows of repeated ids sum (``sparse_add`` may
        leave repeats), ids outside ``[0, rows)`` drop."""
        ids = self._aux[0].long().reshape(-1)
        ok = (ids >= 0) & (ids < self._shape[0])
        vals = self._data.reshape((ids.shape[0],) + self._shape[1:])
        vals = torch.where(ok.reshape((-1,) + (1,) * (vals.dim() - 1)),
                           vals, torch.zeros((), dtype=vals.dtype,
                                             device=vals.device))
        out = torch.zeros(self._shape, dtype=self._data.dtype,
                          device=self._data.device)
        return NDArray(out.index_add_(0, ids.clamp(0, self._shape[0] - 1),
                                      vals))

    def copy(self):
        return RowSparseNDArray(self._data.clone(), self._aux[0].clone(),
                                self._shape)

    def retain(self, rs_indices):
        return retain(self, rs_indices)

    def __add__(self, other):
        return sparse_add(self, other)


class CSRNDArray(BaseSparseNDArray):
    """values and column ids: (nnz,); indptr: (rows + 1,)."""

    def __init__(self, data, indices, indptr, shape):
        super().__init__(data, indices, shape, "csr")
        self._aux.append(_t(indptr, self._data.device))

    @property
    def indptr(self):
        return NDArray(self._aux[1])

    def todense(self):
        from ..ops.sparse_graph import CsrCarrier
        return NDArray(CsrCarrier(self._data, self._aux[0], self._aux[1],
                                  self._shape).todense())

    def copy(self):
        return CSRNDArray(self._data.clone(), self._aux[0].clone(),
                          self._aux[1].clone(), self._shape)

    def __getitem__(self, key):
        """A slice of rows (the only indexing CSR supports); reads
        ``indptr`` on the host."""
        if isinstance(key, slice):
            start = key.start or 0
            stop = key.stop if key.stop is not None else self._shape[0]
            indptr = self._aux[1].cpu().numpy()
            lo, hi = int(indptr[start]), int(indptr[stop])
            new_indptr = torch.from_numpy(
                (indptr[start:stop + 1] - indptr[start]).astype(
                    indptr.dtype)).to(self._aux[1].device)
            return CSRNDArray(self._data[lo:hi], self._aux[0][lo:hi],
                              new_indptr, (stop - start,) + self._shape[1:])
        raise TypeError("CSRNDArray indexing supports row slices only")


# ---------------------------------------------------------------------------
# constructors
# ---------------------------------------------------------------------------


def _dense_host(arg1, dtype):
    dense = _np.asarray(arg1.asnumpy() if isinstance(arg1, NDArray)
                        else arg1)
    if dtype:
        dense = dense.astype(np_dtype(dtype))
    return dense


def _ctx_of(arg1, ctx):
    if ctx is None and isinstance(arg1, NDArray):
        return arg1.context
    return ctx


def row_sparse_array(arg1, shape=None, ctx=None, dtype=None):
    """A RowSparseNDArray from ``(values, row ids)`` or from a dense array
    (its rows with any nonzero, found on the host), on *ctx* (default: the
    dense input's device, else the current context)."""
    if isinstance(arg1, tuple) and len(arg1) == 2:
        data, indices = arg1
        data = _array(data, ctx=_ctx_of(data, ctx), dtype=dtype)
        indices = _array(indices, ctx=data.context, dtype="int32")
        return RowSparseNDArray(data, indices, shape)
    dev_ctx = _ctx_of(arg1, ctx)
    dense = _dense_host(arg1, dtype)
    nz_rows = _np.where(_np.any(dense.reshape(dense.shape[0], -1) != 0,
                                axis=1))[0]
    return RowSparseNDArray(_array(dense[nz_rows], ctx=dev_ctx),
                            _array(nz_rows.astype(_np.int32), ctx=dev_ctx),
                            shape or dense.shape)


def csr_matrix(arg1, shape=None, ctx=None, dtype=None):
    """A CSRNDArray from ``(values, column ids, indptr)`` or from a dense
    2-d array (its nonzeros, found on the host)."""
    if isinstance(arg1, tuple) and len(arg1) == 3:
        data, indices, indptr = arg1
        data = _array(data, ctx=_ctx_of(data, ctx), dtype=dtype)
        return CSRNDArray(data,
                          _array(indices, ctx=data.context, dtype="int32"),
                          _array(indptr, ctx=data.context, dtype="int32"),
                          shape)
    dev_ctx = _ctx_of(arg1, ctx)
    dense = _dense_host(arg1, dtype)
    rows, cols = _np.nonzero(dense)
    data = dense[rows, cols]
    indptr = _np.zeros(dense.shape[0] + 1, _np.int32)
    _np.add.at(indptr, rows + 1, 1)
    indptr = _np.cumsum(indptr).astype(_np.int32)
    return CSRNDArray(_array(data, ctx=dev_ctx),
                      _array(cols.astype(_np.int32), ctx=dev_ctx),
                      _array(indptr, ctx=dev_ctx), shape or dense.shape)


def zeros(stype, shape, ctx=None, dtype=None):
    """An all-zero array of storage type *stype* (no stored entries)."""
    from .ndarray import _device
    dt = torch_dtype(dtype or "float32")
    dev = _device(ctx)
    shape = tuple(shape)
    if stype == "row_sparse":
        return RowSparseNDArray(
            torch.zeros((0,) + shape[1:], dtype=dt, device=dev),
            torch.zeros((0,), dtype=torch.int32, device=dev), shape)
    if stype == "csr":
        return CSRNDArray(
            torch.zeros((0,), dtype=dt, device=dev),
            torch.zeros((0,), dtype=torch.int32, device=dev),
            torch.zeros((shape[0] + 1,), dtype=torch.int32, device=dev),
            shape)
    if stype == "default":
        from .ndarray import zeros as _zeros
        return _zeros(shape, ctx, dtype)
    raise ValueError(stype)


def cast_storage(arr, stype):
    """Convert between dense, row_sparse and csr storage (reference:
    cast_storage op); dense to sparse finds the nonzeros on the host."""
    if arr.stype == stype:
        return arr
    if stype == "default":
        return arr.todense()
    if isinstance(arr, BaseSparseNDArray):
        arr = arr.todense()
    if stype == "row_sparse":
        return row_sparse_array(arr, shape=arr.shape)
    if stype == "csr":
        return csr_matrix(arr, shape=arr.shape)
    raise ValueError(stype)


# ---------------------------------------------------------------------------
# sparse ops
# ---------------------------------------------------------------------------


def _dense_of(x):
    return x.todense()._data if isinstance(x, BaseSparseNDArray) \
        else x._data


def dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """csr × dense through ``ops/sparse_graph.csr_dot_dense`` (the lowering
    the graph's ``dot`` shares); any other sparse operand is densified."""
    if isinstance(lhs, CSRNDArray) and isinstance(rhs, NDArray) and \
            not isinstance(rhs, BaseSparseNDArray):
        from ..ops.sparse_graph import CsrCarrier, csr_dot_dense
        carrier = CsrCarrier(lhs._data, lhs._aux[0], lhs._aux[1], lhs.shape)
        r = rhs._data
        if transpose_b and r.dim() > 1:
            r = torch.swapaxes(r, -1, -2)
        from .. import autograd as _ag
        with torch.set_grad_enabled(_ag.is_recording()):
            return NDArray(csr_dot_dense(carrier, r, transpose_a))
    from ..ops.tensor import _dot
    return NDArray(_dot(_dense_of(lhs), _dense_of(rhs)))


def retain(rsp, indices):
    """The rows *indices* of *rsp* (zero where *rsp* stores none), as a
    RowSparseNDArray over exactly those ids (reference: sparse_retain)."""
    want = _t(indices, rsp._data.device).long().reshape(-1)
    have = rsp._aux[0].long()
    if have.shape[0] == 0:
        vals = torch.zeros((want.shape[0],) + tuple(rsp._data.shape[1:]),
                           dtype=rsp._data.dtype, device=rsp._data.device)
        return RowSparseNDArray(vals, want.int(), rsp.shape)
    pos = torch.searchsorted(have, want).clamp(0, have.shape[0] - 1)
    ok = have[pos] == want
    vals = torch.where(ok.reshape((-1,) + (1,) * (rsp._data.dim() - 1)),
                       rsp._data[pos], torch.zeros((), dtype=rsp._data.dtype,
                                                   device=rsp._data.device))
    return RowSparseNDArray(vals, want.int(), rsp.shape)


def sparse_add(a, b):
    """Two row-sparse arrays: their pairs concatenated and sorted by id
    (repeats stay, and sum on densifying); otherwise a dense sum."""
    if isinstance(a, RowSparseNDArray) and isinstance(b, RowSparseNDArray):
        idx = torch.cat([a._aux[0], b._aux[0]])
        vals = torch.cat([a._data, b._data])
        order = torch.argsort(idx, stable=True)
        return RowSparseNDArray(vals[order], idx[order], a.shape)
    return NDArray(_dense_of(a) + _dense_of(b))


def elemwise_mul(a, b):
    return NDArray(_dense_of(a) * _dense_of(b))


def compress_rowsparse(dense_grad, rtol=0.0):
    """A dense gradient as a RowSparseNDArray of its rows with any entry
    above *rtol* in magnitude.  The rows are found on the host (a
    readback), so this is eager-only and cannot be captured in a CUDA
    graph; the executor's Embedding path builds its pairs on the device
    instead (``ops/sparse_graph.dedup_rsp_pairs``)."""
    d = _t(dense_grad).detach()
    flat = d.abs().amax(dim=tuple(range(1, d.dim()))) if d.dim() > 1 \
        else d.abs()
    rows = torch.nonzero(flat > rtol).reshape(-1)
    return RowSparseNDArray(d[rows], rows.to(torch.int32),
                            tuple(int(s) for s in d.shape))


# ---------------------------------------------------------------------------
# lazy row updates
# ---------------------------------------------------------------------------


def _rows_of(ids, vals, num_rows):
    """(rows, values, any_valid): each slot whose id lies outside
    ``[0, num_rows)`` takes the id and values of the first valid slot,
    so it computes and writes exactly that slot's row again, and an
    ``index_put_`` of the results is deterministic with no id dropped
    by a readback."""
    ids = ids.long().reshape(-1)
    valid = (ids >= 0) & (ids < num_rows)
    # the first valid slot, as a 1-element index (a 0-d index tensor
    # would be read back to the host)
    j = torch.argmax(valid.to(torch.uint8)).reshape(1)
    rows = torch.where(valid, ids, ids.index_select(0, j)).clamp(
        0, max(num_rows - 1, 0))
    vals = vals.reshape((ids.shape[0],) + tuple(vals.shape[1:]))
    vals = torch.where(valid.reshape((-1,) + (1,) * (vals.dim() - 1)),
                       vals, vals.index_select(0, j))
    return rows, vals, valid.any()


def _row_grad(weight, ids, vals, rescale_grad, clip_gradient, wd):
    """The shared preamble of the row updates on tensors: (rows, rescaled
    and clipped gradient rows with *wd* times the weight's rows added,
    any_valid).  *wd* may be a number (0 adds nothing) or a tensor."""
    rows, g, ok = _rows_of(ids, vals, weight.shape[0])
    g = g * rescale_grad
    if clip_gradient is not None and not isinstance(
            clip_gradient, torch.Tensor) and clip_gradient > 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    if isinstance(wd, torch.Tensor) or wd:
        g = g + wd * weight[rows]
    return rows, g, ok


def _put_rows(dst, rows, new, ok):
    """Write *new* into the rows *rows* of *dst* in place (each row's
    repeats carry equal values); nothing when no slot was valid."""
    old = dst[rows]
    dst.index_put_((rows,), torch.where(ok, new.to(dst.dtype), old))


def sgd_rows_(w, ids, vals, lr, wd=0.0, rescale_grad=1.0,
              clip_gradient=-1.0, mom=None, momentum=0.0):
    """The lazy SGD update on tensors, in place: the rows *ids* of weight
    *w* (and of its momentum *mom*, when given) move by the gradient rows
    *vals*; no other row is read or written.  The eager updates below and
    the fused step's tree update (``optimizer/tree_opt.py``) both run
    it."""
    with torch.no_grad():
        rows, g, ok = _row_grad(w, ids, vals, rescale_grad, clip_gradient,
                               wd)
        if mom is None:
            _put_rows(w, rows, w[rows] + (-lr * g).to(w.dtype), ok)
            return
        m_rows = momentum * mom[rows] - lr * g
        _put_rows(mom, rows, m_rows, ok)
        _put_rows(w, rows, w[rows] + m_rows.to(w.dtype), ok)


def adagrad_rows_(w, ids, vals, history, lr, epsilon=1e-7, wd=0.0,
                  rescale_grad=1.0, clip_gradient=-1.0):
    """The lazy AdaGrad update on tensors, in place (see ``sgd_rows_``)."""
    with torch.no_grad():
        rows, g, ok = _row_grad(w, ids, vals, rescale_grad, clip_gradient,
                               wd)
        h_rows = history[rows] + torch.square(g)
        _put_rows(history, rows, h_rows, ok)
        _put_rows(w, rows, w[rows] + (-lr * g / (torch.sqrt(h_rows) +
                                                 epsilon)).to(w.dtype), ok)


def _pair(rsp_grad):
    return rsp_grad._aux[0], rsp_grad._data


def sgd_row_update(weight, rsp_grad, lr, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0):
    """Lazy SGD: only the gradient's rows move (reference: sgd_update's
    row_sparse path, lazy_update)."""
    sgd_rows_(weight._data, *_pair(rsp_grad), lr, wd, rescale_grad,
              clip_gradient)
    return weight


def sgd_mom_row_update(weight, rsp_grad, mom, lr, momentum=0.9, wd=0.0,
                       rescale_grad=1.0, clip_gradient=-1.0):
    """Lazy momentum SGD: momentum decays only on the gradient's rows."""
    sgd_rows_(weight._data, *_pair(rsp_grad), lr, wd, rescale_grad,
              clip_gradient, mom._data, momentum)
    return weight, mom


def adagrad_row_update(weight, rsp_grad, history, lr, epsilon=1e-7,
                       wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    """Lazy AdaGrad: history and weight move only on the gradient's rows
    (reference: _sparse_adagrad_update's row_sparse path)."""
    adagrad_rows_(weight._data, *_pair(rsp_grad), history._data, lr,
                  epsilon, wd, rescale_grad, clip_gradient)
    return weight, history
