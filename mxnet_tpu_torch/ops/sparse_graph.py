"""Sparse values inside a graph (port of ``mxnet_tpu/ops/sparse_graph.py``).

* ``CsrCarrier`` — a CSR matrix bound as a graph argument: its three
  tensors and its dense shape.  The executor builds one for each
  ``CSRNDArray`` argument; ``dot`` contracts it with a dense operand by
  ``csr_dot_dense`` (the lowering the eager ``sparse.dot`` shares) and
  every other op sees it densified.
* ``SparseGradWeight`` — the Embedding ``sparse_grad=True`` path.  The
  executor passes the weight together with a zero per-occurrence leaf
  ``vals`` that requires grad; the op computes ``W.detach()[ids] + vals``,
  so the backward's gradient of ``vals`` is the row-sparse gradient and
  no dense (vocab, dim) gradient exists anywhere in it.
* ``dedup_rsp_pairs`` — per-occurrence (ids, values) to sorted unique
  rows with their values summed, at a static shape (it captures in a
  CUDA graph): the tail slots carry the id ``num_rows``, which every
  consumer drops (``ndarray/sparse.py`` ``_rows_of``, ``densify_pair``).
"""

from __future__ import annotations

import torch

__all__ = ["CsrCarrier", "SparseGradWeight", "csr_dot_dense",
           "dense_dot_maybe_sparse", "dedup_rsp_pairs", "densify_pair"]


class CsrCarrier:
    """CSR components as one graph value: ``data`` and ``indices``
    (nnz,), ``indptr`` (rows + 1,), and the dense ``shape``."""

    def __init__(self, data, indices, indptr, shape):
        self.data = data
        self.indices = indices
        self.indptr = indptr
        self.shape = tuple(int(s) for s in shape)

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self):
        return self.data.device

    def row_ids(self):
        """The row of each stored entry, from ``indptr``."""
        nnz = self.data.shape[0]
        pos = torch.arange(nnz, device=self.data.device,
                           dtype=self.indptr.dtype)
        return torch.searchsorted(self.indptr.contiguous(), pos,
                                  right=True).long() - 1

    def todense(self):
        """The dense matrix (an entry stored twice: the last one, as a
        scatter-set)."""
        out = torch.zeros(self.shape, dtype=self.data.dtype,
                          device=self.data.device)
        return out.index_put((self.row_ids(), self.indices.long()),
                             self.data)


class SparseGradWeight:
    """An Embedding weight and the zero per-occurrence leaf whose gradient
    is the row-sparse gradient (see the module docstring)."""

    def __init__(self, weight, vals):
        self.weight = weight
        self.vals = vals


def dedup_rsp_pairs(ids, vals, num_rows):
    """Per-occurrence (ids, vals) as sorted unique rows with summed values,
    at the input's shape: slot i < the number of unique ids holds the
    i-th smallest id and the sum of its occurrences' values (in their
    order); every later slot holds the id *num_rows* and zeros.  No
    readback; the sum is ``index_add_`` (atomic on the card, so repeats
    may sum in any order)."""
    flat_ids = ids.reshape(-1).long()
    n = flat_ids.shape[0]
    order = torch.argsort(flat_ids, stable=True)
    s_ids = flat_ids[order]
    s_vals = vals.reshape(n, -1)[order]
    is_new = torch.ones(n, dtype=torch.long, device=flat_ids.device)
    if n > 1:
        is_new[1:] = (s_ids[1:] != s_ids[:-1]).long()
    seg = torch.cumsum(is_new, 0) - 1
    summed = torch.zeros_like(s_vals).index_add_(0, seg, s_vals)
    seg_ids = torch.full((n,), num_rows, dtype=torch.int32,
                         device=flat_ids.device)
    seg_ids = seg_ids.index_put((seg,), s_ids.to(torch.int32))
    return seg_ids, summed.reshape((n,) + tuple(vals.shape[ids.dim():]))


def densify_pair(pair, shape):
    """(ids, vals) as a dense gradient of *shape*; repeated ids sum and
    ids outside ``[0, shape[0])`` drop (masked to zero rows)."""
    ids, vals = pair
    ids = ids.long().reshape(-1)
    ok = (ids >= 0) & (ids < shape[0])
    vals = vals.reshape((ids.shape[0],) + tuple(shape[1:]))
    vals = torch.where(ok.reshape((-1,) + (1,) * (vals.dim() - 1)), vals,
                       torch.zeros((), dtype=vals.dtype, device=vals.device))
    out = torch.zeros(shape, dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, ids.clamp(0, shape[0] - 1), vals)


def csr_dot_dense(csr, rhs, transpose_a=False):
    """csr × dense (``rhs`` 1-d or 2-d).  Without *transpose_a* each output
    row is the sum of its stored entries' products, in order, by
    ``segment_reduce`` over ``indptr``: no atomics, so a relaunch is
    bit-equal.  With it the products scatter into the columns by
    ``index_add_`` (atomic on the card: the order of a column's sum may
    change from run to run)."""
    vals = csr.data
    cols = csr.indices.long()
    rhs2 = rhs.reshape(rhs.shape[0], -1)
    if transpose_a:
        contrib = vals[:, None] * rhs2[csr.row_ids()]
        out = torch.zeros((csr.shape[1], rhs2.shape[1]), dtype=contrib.dtype,
                          device=contrib.device).index_add_(0, cols, contrib)
    else:
        gathered = vals[:, None] * rhs2[cols]
        out = torch.segment_reduce(gathered, "sum",
                                   offsets=csr.indptr.long(), axis=0,
                                   unsafe=True, initial=0)
    if rhs.dim() == 1:
        return out.reshape(-1)
    return out


def dense_dot_maybe_sparse(a, b, transpose_a, transpose_b, dense_dot):
    """The ``dot`` op's dispatch: a CSR carrier on the left goes through
    ``csr_dot_dense``; a CSR operand anywhere else is densified (the
    reference's dot densifies the pairs it has no sparse kernel for)."""
    if isinstance(a, CsrCarrier):
        if isinstance(b, CsrCarrier):
            b = b.todense()
        if transpose_b and b.dim() > 1:
            b = torch.swapaxes(b, -1, -2)
        return csr_dot_dense(a, b, transpose_a)
    if isinstance(b, CsrCarrier):
        b = b.todense()
    return dense_dot(a, b, transpose_a, transpose_b)
