"""The long tail of the operator registry (port of
``mxnet_tpu/ops/parity.py``, the names the port had not registered yet).

Elementwise odds and ends (``hard_sigmoid``, ``shape_array``, ...), slice
assignment, the legacy ``Crop`` layer, the ``SVMOutput`` and
``IdentityAttachKLSparseReg`` output layers (each a
``torch.autograd.Function`` whose backward is the reference's), the
per-row samplers, group AdaGrad, greedy bipartite matching, deformable
PSROI pooling, and the graph-level sparse ops: ``cast_storage`` densifies
a CSR carrier bound as a graph argument and is the identity on a dense
value; ``_sparse_retain`` and ``_square_sum`` are the dense projections
of the row-sparse ops, as in the JAX package.

Every op is capture-safe: index arithmetic stays on the device and nothing
is read back to the host.
"""

from __future__ import annotations

import torch

from ..base import narrow_dtype, torch_dtype
from .registry import register_op, alias
from .tensor import _shape
from .random_ops import _standard_gamma, _poisson

__all__ = []

# Embedding with a row_sparse gradient: the storage of the gradient is the
# executor's concern (ops/sparse_graph.py), the computation is Embedding's
alias("_contrib_SparseEmbedding", "Embedding")


# ---------------------------------------------------------------------------
# elementwise long tail
# ---------------------------------------------------------------------------

@register_op("hard_sigmoid")
def _hard_sigmoid(x, alpha=0.2, beta=0.5):
    """clip(alpha * x + beta, 0, 1)."""
    return torch.clamp(alpha * x + beta, 0.0, 1.0)


def _index_dtype():
    # int64 only inside enable_x64(), as the JAX package without x64
    return torch_dtype(narrow_dtype("int64"))


@register_op("shape_array")
def _shape_array(x):
    """The shape as a 1-d integer array (int32 unless x64 is enabled)."""
    return torch.tensor(tuple(x.shape), dtype=_index_dtype(),
                        device=x.device)


@register_op("size_array")
def _size_array(x):
    """The element count as a 1-element integer array."""
    return torch.tensor([x.numel()], dtype=_index_dtype(), device=x.device)


@register_op("_zeros_without_dtype")
def _zeros_without_dtype(shape=(), ctx=None, dtype=-1):
    """Zeros; an unset dtype (-1) is float32."""
    dt = "float32" if dtype in (-1, None) else dtype
    return torch.zeros(_shape(shape), dtype=torch_dtype(dt))


@register_op("_identity_with_attr_like_rhs", input_names=("lhs", "rhs"))
def _identity_with_attr_like_rhs(lhs, rhs):
    """*lhs*; *rhs* only lends its attributes to graph passes, so its
    gradient is zero."""
    del rhs
    return lhs + 0


@register_op("_scatter_minus_scalar")
def _scatter_minus_scalar(x, scalar=0.0):
    """x - scalar (a dense array stores every element)."""
    return x - scalar


@register_op("_scatter_elemwise_div", input_names=("lhs", "rhs"))
def _scatter_elemwise_div(lhs, rhs):
    return lhs / rhs


# ---------------------------------------------------------------------------
# slice / crop assignment
# ---------------------------------------------------------------------------

def _norm_slice(shape, begin, end, step):
    slc = []
    step = step or (1,) * len(begin)
    for d, (b, e) in enumerate(zip(begin, end)):
        st = int(step[d]) if d < len(step) and step[d] is not None else 1
        b = 0 if b is None else int(b)
        e = shape[d] if e is None else int(e)
        if b < 0:
            b += shape[d]
        if e < 0:
            e += shape[d]
        slc.append(slice(b, e, st))
    for _ in range(len(begin), len(shape)):
        slc.append(slice(None))
    return tuple(slc)


@register_op("_slice_assign", input_names=("lhs", "rhs"),
             aliases=("_crop_assign",))
def _slice_assign(lhs, rhs, begin=(), end=(), step=()):
    """*lhs* with *rhs* written into lhs[begin:end:step]."""
    out = lhs.clone()
    out[_norm_slice(tuple(lhs.shape), begin, end, step)] = rhs
    return out


@register_op("_slice_assign_scalar", aliases=("_crop_assign_scalar",))
def _slice_assign_scalar(data, scalar=0.0, begin=(), end=(), step=()):
    out = data.clone()
    out[_norm_slice(tuple(data.shape), begin, end, step)] = scalar
    return out


# ---------------------------------------------------------------------------
# the legacy Crop layer
# ---------------------------------------------------------------------------

@register_op("Crop")
def _crop_layer(*args, offset=(0, 0), h_w=(0, 0), center_crop=False,
                num_args=None):
    """The spatial window of an NCHW input, of size *h_w* or of a second
    input's H and W, centred or at *offset*."""
    data = args[0]
    H, W = data.shape[2], data.shape[3]
    if len(args) > 1:
        th, tw = args[1].shape[2], args[1].shape[3]
    else:
        th, tw = int(h_w[0]), int(h_w[1])
    if center_crop:
        oy, ox = (H - th) // 2, (W - tw) // 2
    else:
        oy, ox = int(offset[0]), int(offset[1])
    return data[:, :, oy:oy + th, ox:ox + tw]


# ---------------------------------------------------------------------------
# SVM and sparse-regularizer output layers
# ---------------------------------------------------------------------------

class _SVMOutput(torch.autograd.Function):
    """Forward the scores; backward ignores the head gradient and emits
    the hinge-loss gradient (svm_output.cc)."""

    @staticmethod
    def forward(ctx, d, label, margin, coef, use_linear):
        ctx.save_for_backward(d, label)
        ctx.cfg = (margin, coef, use_linear)
        return d + 0

    @staticmethod
    def backward(ctx, g):
        d, label = ctx.saved_tensors
        margin, coef, use_linear = ctx.cfg
        li = label.long()
        n_class = d.shape[-1]
        onehot = (li[..., None] == torch.arange(
            n_class, device=d.device)).to(d.dtype)
        score_y = torch.gather(d, -1, li[..., None].clamp(0, n_class - 1))
        viol = torch.clamp(margin - (score_y - d), min=0.0) * (1 - onehot)
        gj = (viol > 0).to(d.dtype) if use_linear else 2.0 * viol
        grad = gj - onehot * torch.sum(gj, dim=-1, keepdim=True)
        return (coef * grad).to(d.dtype), torch.zeros_like(label), None, \
            None, None


@register_op("SVMOutput")
def _svm_output(data, label, margin=1.0, regularization_coefficient=1.0,
                use_linear=False):
    """Multiclass SVM output: identity forward; the backward is the L1-SVM
    subgradient with *use_linear*, else the squared-hinge L2-SVM one,
    times *regularization_coefficient* (svm_output.cc:107)."""
    return _SVMOutput.apply(data, label, float(margin),
                            float(regularization_coefficient),
                            bool(use_linear))


class _KLSparseReg(torch.autograd.Function):
    @staticmethod
    def forward(ctx, d, rho, penalty):
        ctx.save_for_backward(d)
        ctx.cfg = (rho, penalty)
        return d + 0

    @staticmethod
    def backward(ctx, g):
        d, = ctx.saved_tensors
        rho, penalty = ctx.cfg
        rho_hat = torch.clamp(torch.mean(d, dim=0), 1e-6, 1 - 1e-6)
        kl_grad = (-rho / rho_hat + (1 - rho) / (1 - rho_hat)) / d.shape[0]
        return g + penalty * torch.broadcast_to(kl_grad, d.shape).to(
            d.dtype), None, None


@register_op("IdentityAttachKLSparseReg")
def _identity_attach_kl_sparse_reg(data, sparseness_target=0.1,
                                   penalty=0.001, momentum=0.9):
    """Identity forward; the backward adds *penalty* times the gradient of
    KL(rho || rho_hat), rho_hat each unit's batch-mean activation (the
    reference's momentum smoothing is an auxiliary state the JAX package
    leaves out, so *momentum* changes nothing)."""
    return _KLSparseReg.apply(data, float(sparseness_target),
                              float(penalty))


# ---------------------------------------------------------------------------
# per-row samplers (multisample_op.cc): *shape* draws for each parameter
# ---------------------------------------------------------------------------

def _per_row(t, s):
    return torch.broadcast_to(t.reshape(tuple(t.shape) + (1,) * len(s)),
                              tuple(t.shape) + s)


@register_op("_sample_exponential", needs_rng=True)
def _sample_exponential(rng, lam, shape=(), dtype="float32"):
    s = _shape(shape)
    e = torch.empty(tuple(lam.shape) + s, device=rng.device,
                    dtype=torch_dtype(dtype)).exponential_(generator=rng)
    return e.to(lam.device) / lam.reshape(tuple(lam.shape) + (1,) * len(s))


@register_op("_sample_poisson", needs_rng=True)
def _sample_poisson(rng, lam, shape=(), dtype="float32"):
    s = _shape(shape)
    rate = _per_row(lam, s).to(rng.device, torch.float32)
    return _poisson(rng, rate).to(lam.device, torch_dtype(dtype))


@register_op("_sample_negative_binomial", needs_rng=True)
def _sample_negative_binomial(rng, k, p, shape=(), dtype="float32"):
    """NB(k, p) as Poisson(Gamma(k) (1 - p) / p)."""
    s = _shape(shape)
    kb = _per_row(k, s).to(rng.device, torch.float32)
    pb = _per_row(p, s).to(rng.device, torch.float32)
    rate = _standard_gamma(rng, kb) * (1.0 - pb) / pb
    return _poisson(rng, rate).to(k.device, torch_dtype(dtype))


@register_op("_sample_generalized_negative_binomial", needs_rng=True)
def _sample_generalized_negative_binomial(rng, mu, alpha, shape=(),
                                          dtype="float32"):
    """GNB(mu, alpha): a Poisson of rate Gamma(1 / alpha) mu alpha."""
    s = _shape(shape)
    mub = _per_row(mu, s).to(rng.device, torch.float32)
    ab = _per_row(alpha, s).to(rng.device, torch.float32)
    rate = _standard_gamma(rng, 1.0 / ab) * mub * ab
    return _poisson(rng, rate).to(mu.device, torch_dtype(dtype))


# ---------------------------------------------------------------------------
# group AdaGrad (contrib/optimizer_op.cc)
# ---------------------------------------------------------------------------

@register_op("_contrib_group_adagrad_update",
             input_names=("weight", "grad", "history"), num_outputs=2,
             num_visible_outputs=1)
def _group_adagrad_update(weight, grad, history, lr=0.01, rescale_grad=1.0,
                          clip_gradient=-1.0, epsilon=1e-5):
    """AdaGrad with one accumulator a row: history[r] += mean(g[r]^2);
    w[r] -= lr g[r] / sqrt(history[r] + eps).  Weight and history are
    written in place."""
    with torch.no_grad():
        g = grad * rescale_grad
        if clip_gradient is not None and clip_gradient >= 0:
            g = torch.clamp(g, -clip_gradient, clip_gradient)
        ssq = torch.mean(g * g, dim=tuple(range(1, g.dim())))
        hist = history + ssq
        denom = torch.sqrt(hist + epsilon)
        w = weight - lr * g / denom.reshape((-1,) + (1,) * (g.dim() - 1))
        weight.copy_(w)
        history.copy_(hist)
    return weight, history


# ---------------------------------------------------------------------------
# bipartite matching (contrib/bounding_box.cc:148)
# ---------------------------------------------------------------------------

@register_op("_contrib_bipartite_matching", num_outputs=2)
def _bipartite_matching(data, is_ascend=False, threshold=1e-12, topk=-1):
    """Greedy matching on a score matrix (..., N, M): each round takes the
    best remaining score (the first in row-major order on a tie) while it
    passes *threshold*, for min(N, M) rounds or *topk*.  Returns (x, y):
    x[r] the column matched to row r, y[c] the row matched to column c,
    -1 where unmatched, in the data's dtype; no gradient."""
    d = data.detach()
    *batch, n, m = d.shape
    mat = d.reshape(-1, n, m).clone()
    nb = mat.shape[0]
    sign = 1.0 if is_ascend else -1.0
    rounds = min(n, m) if topk is None or topk <= 0 else min(n, m, int(topk))
    dev = d.device
    x = torch.full((nb, n), -1, dtype=torch.long, device=dev)
    y = torch.full((nb, m), -1, dtype=torch.long, device=dev)
    bi = torch.arange(nb, device=dev)
    cols = torch.arange(m, device=dev)
    rows = torch.arange(n, device=dev)
    blocked = torch.tensor(sign * float("inf"), dtype=d.dtype, device=dev)
    for _ in range(rounds):
        flat = torch.argmin((sign * mat).reshape(nb, -1), dim=1)
        r, c = flat // m, flat % m
        score = mat[bi, r, c]
        ok = (score <= threshold) if is_ascend else (score >= threshold)
        x = torch.where(ok[:, None] & (rows[None] == r[:, None]),
                        c[:, None], x)
        y = torch.where(ok[:, None] & (cols[None] == c[:, None]),
                        r[:, None], y)
        hit = (rows[None, :, None] == r[:, None, None]) | \
            (cols[None, None, :] == c[:, None, None])
        mat = torch.where(ok[:, None, None] & hit, blocked, mat)
    return (x.reshape(tuple(batch) + (n,)).to(data.dtype),
            y.reshape(tuple(batch) + (m,)).to(data.dtype))


# ---------------------------------------------------------------------------
# deformable PSROI pooling (contrib/deformable_psroi_pooling.cc)
# ---------------------------------------------------------------------------

@register_op("_contrib_DeformablePSROIPooling",
             input_names=("data", "rois", "trans"), num_outputs=2,
             num_visible_outputs=1)
def _deformable_psroi_pooling(data, rois, trans=None, spatial_scale=1.0,
                              output_dim=0, group_size=1, pooled_size=0,
                              part_size=0, sample_per_part=1,
                              trans_std=0.0, no_trans=False):
    """Position-sensitive ROI pooling whose bins are shifted by the
    normalized offsets *trans* (num_rois, 2, part, part) times
    *trans_std* and the ROI's size; each bin averages sample_per_part^2
    bilinear taps.  The second output is the taps-per-bin map."""
    g = int(group_size)
    k = int(pooled_size)
    part = int(part_size) if part_size else k
    sp = max(int(sample_per_part), 1)
    od = int(output_dim)
    N, C, H, W = data.shape
    nroi = rois.shape[0]
    dev, dt = data.device, data.dtype
    if trans is None or no_trans:
        tr = torch.zeros((nroi, 2, part, part), dtype=dt, device=dev)
    else:
        tr = trans.reshape(nroi, 2, part, part) * trans_std
    ar_k = torch.arange(k, device=dev)
    gi = torch.clamp((ar_k * g) // k, max=g - 1)
    pi = torch.clamp((ar_k * part) // k, max=part - 1)

    bidx = rois[:, 0].long().clamp(0, N - 1)
    x1 = torch.round(rois[:, 1]) * spatial_scale - 0.5
    y1 = torch.round(rois[:, 2]) * spatial_scale - 0.5
    x2 = (torch.round(rois[:, 3]) + 1.0) * spatial_scale - 0.5
    y2 = (torch.round(rois[:, 4]) + 1.0) * spatial_scale - 0.5
    rw = torch.clamp(x2 - x1, min=0.1)
    rh = torch.clamp(y2 - y1, min=0.1)
    bin_w = rw / k
    bin_h = rh / k

    def r5(t):          # (R,) -> (R, 1, 1, 1, 1)
        return t.reshape(-1, 1, 1, 1, 1)

    dy = tr[:, 0][:, pi][:, :, pi] * rh[:, None, None]      # (R, k, k)
    dx = tr[:, 1][:, pi][:, :, pi] * rw[:, None, None]
    sub = (torch.arange(sp, dtype=dt, device=dev) + 0.5) / sp
    kf = torch.arange(k, dtype=dt, device=dev)
    # (R, k, k, sp, sp) sample coordinates
    yy = r5(y1) + (kf[None, :, None, None, None] +
                   sub[None, None, None, :, None]) * r5(bin_h) + \
        dy[:, :, :, None, None]
    xx = r5(x1) + (kf[None, None, :, None, None] +
                   sub[None, None, None, None, :]) * r5(bin_w) + \
        dx[:, :, :, None, None]
    yy = torch.clamp(yy, 0.0, H - 1.0)
    xx = torch.clamp(xx, 0.0, W - 1.0)
    y0 = torch.floor(yy)
    x0 = torch.floor(xx)
    y1i = y0.long().clamp(0, H - 1)
    x1i = x0.long().clamp(0, W - 1)
    y2i = (y1i + 1).clamp(0, H - 1)
    x2i = (x1i + 1).clamp(0, W - 1)
    wy = (yy - y0)[:, None]
    wx = (xx - x0)[:, None]
    chan = (torch.arange(od, device=dev)[:, None, None] * g * g +
            gi[None, :, None] * g + gi[None, None, :])      # (od, k, k)
    b6 = bidx.reshape(-1, 1, 1, 1, 1, 1)
    c6 = chan[None, :, :, :, None, None]

    def gather(yi, xi):     # -> (R, od, k, k, sp, sp)
        return data[b6, c6, yi[:, None], xi[:, None]]

    val = ((1 - wy) * (1 - wx) * gather(y1i, x1i) +
           (1 - wy) * wx * gather(y1i, x2i) +
           wy * (1 - wx) * gather(y2i, x1i) +
           wy * wx * gather(y2i, x2i))
    out = val.mean(dim=(-2, -1))
    cnt = torch.full((nroi, od, k, k), float(sp * sp), dtype=dt, device=dev)
    return out, cnt


# ---------------------------------------------------------------------------
# graph-level sparse ops
# ---------------------------------------------------------------------------

@register_op("cast_storage")
def _cast_storage_op(data, stype="default"):
    """A CSR carrier bound as a graph argument densifies (to "default" or
    "row_sparse"); a dense value stays dense (its nonzeros would be a
    data-dependent shape: ``ndarray.sparse.cast_storage`` converts
    eagerly)."""
    from .sparse_graph import CsrCarrier
    if isinstance(data, CsrCarrier):
        if stype in ("default", "row_sparse"):
            return data.todense()
        return data
    return data + 0


@register_op("_sparse_retain", input_names=("data", "indices"))
def _sparse_retain_op(data, indices):
    """The rows *indices* of *data*, every other row zero (ids out of range
    drop; a negative one counts from the end)."""
    n = data.shape[0]
    i = indices.reshape(-1).long()
    i = torch.where(i < 0, i + n, i)
    ok = (i >= 0) & (i < n)
    hits = torch.zeros((n,), dtype=torch.int32, device=data.device)
    hits = hits.index_add(0, i.clamp(0, max(n - 1, 0)), ok.to(torch.int32))
    keep = (hits > 0).reshape((-1,) + (1,) * (data.dim() - 1))
    return torch.where(keep, data, torch.zeros((), dtype=data.dtype,
                                               device=data.device))


@register_op("_square_sum")
def _square_sum_op(data, axis=None, keepdims=False):
    """sum(x^2) over *axis* (all axes when None)."""
    if axis is None:
        out = torch.sum(data * data)
        return out.reshape((1,) * data.dim()) if keepdims else out
    ax = (int(axis),) if not isinstance(axis, (tuple, list)) \
        else tuple(int(a) for a in axis)
    return torch.sum(data * data, dim=ax, keepdim=bool(keepdims))
