"""Detection ops, the SSD and RCNN family (port of
``mxnet_tpu/ops/detection.py``): MultiBoxPrior, MultiBoxTarget,
MultiBoxDetection, box_iou, box_nms, ROIAlign and Proposal, with the
aliases the JAX package adds in ``mxnet_tpu/ops/parity.py``
(``_contrib_box_non_maximum_suppression``, ``MultiProposal``,
``_contrib_MultiProposal``).

The JAX package computes these with XLA, so here they are PyTorch ops, not
kernels.  Every op works on the whole batch at once with fixed shapes and
masks: removed boxes are masked (rows of -1), never filtered, and the
sequential parts (bipartite matching, greedy suppression) are Python loops
over static trip counts (G label rows, the top-k sorted boxes).  Nothing
reads a tensor back to the host (no ``.item()``, ``nonzero`` or boolean-mask
indexing), so MultiBoxPrior, MultiBoxTarget and MultiBoxDetection run inside
a CUDA graph (a served rung, Module's fused step).

The reference's tie rules are kept: sorts are stable
(``torch.argsort(stable=True)`` is ``jnp.argsort(stable=True)``) and every
argmax takes the first maximum, the flat one of the bipartite matching too.
Gradients follow ``jax.vjp`` of the JAX ops: ``maximum``/``minimum`` split
a tie evenly (so clipping is written as they are, not as ``clamp``), a max
over an axis shares the gradient among equal maxima (``amax``), and the
discrete choices (matching, mining, suppression) pass none.
"""

from __future__ import annotations

import torch

from .registry import register_op, alias

_INF = float("inf")


def _maximum(x, c):
    """``jnp.maximum(x, c)`` for a number *c* (a tie splits the gradient,
    as in JAX); the constant is a fill on x's device, not a host copy."""
    return torch.maximum(x, torch.full((), c, dtype=x.dtype, device=x.device))


def _minimum(x, c):
    return torch.minimum(x, torch.full((), c, dtype=x.dtype, device=x.device))


def _clip(x, lo, hi):
    """``jnp.clip``: maximum with *lo*, then minimum with *hi*."""
    return _minimum(_maximum(x, lo), hi)


def _box_iou_corner(a, b):
    """IoU of corner boxes a (..., N, 4) against b (..., M, 4) ->
    (..., N, M); the leading axes broadcast."""
    al, at, ar, ab = a.unbind(-1)
    bl, bt, br, bb = b.unbind(-1)
    iw = _maximum(torch.minimum(ar[..., :, None], br[..., None, :]) -
                  torch.maximum(al[..., :, None], bl[..., None, :]), 0.0)
    ih = _maximum(torch.minimum(ab[..., :, None], bb[..., None, :]) -
                  torch.maximum(at[..., :, None], bt[..., None, :]), 0.0)
    inter = iw * ih
    area_a = _maximum(ar - al, 0.0) * _maximum(ab - at, 0.0)
    area_b = _maximum(br - bl, 0.0) * _maximum(bb - bt, 0.0)
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / union, 0.0)


def _to_corner(boxes):
    x, y, w, h = boxes.unbind(-1)
    return torch.stack([x - w / 2, y - h / 2, x + w / 2, y + h / 2], dim=-1)


def _to_center(boxes):
    l, t, r, b = boxes.unbind(-1)
    return torch.stack([(l + r) / 2, (t + b) / 2, r - l, b - t], dim=-1)


def _rows(x, idx):
    """x (B, N, K) gathered at idx (B, M) along N -> (B, M, K)."""
    return x.gather(1, idx[..., None].expand(-1, -1, x.shape[-1]))


def _seq(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v,)


# --------------------------------------------------------------------------
# MultiBoxPrior
# --------------------------------------------------------------------------

def _prior_extents(sizes, ratios, in_h, in_w):
    """A cell's anchor half widths and heights, in the JAX op's float64
    arithmetic: every size at ratio 1, then every other ratio at the
    first size."""
    sizes, ratios = _seq(sizes), _seq(ratios)
    ws = [s * in_h / in_w / 2 for s in sizes]
    hs = [s / 2 for s in sizes]
    for r in ratios[1:]:
        sr = r ** 0.5
        ws.append(sizes[0] * in_h / in_w * sr / 2)
        hs.append(sizes[0] / sr / 2)
    return list(zip(ws, hs))


def _as_dtype(v, dtype):
    """The Python number *v* rounded to *dtype* (on the host)."""
    return torch.tensor(v, dtype=dtype).item()


def num_priors(sizes, ratios):
    """Anchors a feature-map cell gets: sizes + ratios - 1."""
    return len(_seq(sizes)) + len(_seq(ratios)) - 1


@register_op("_contrib_MultiBoxPrior", aliases=("MultiBoxPrior",))
def _multibox_prior(data, sizes=(1.0,), ratios=(1.0,), clip=False,
                    steps=(-1.0, -1.0), offsets=(0.5, 0.5)):
    """Anchor boxes from a feature map (reference: multibox_prior.cc):
    data (N, C, H, W) -> (1, H*W*A, 4) corner boxes, A = sizes + ratios -
    1.  Only the data's shape is read.  Each anchor's half width and
    height enters as a number (a kernel argument), so the op makes no
    host-to-device copy and can run inside a CUDA graph."""
    in_h, in_w = data.shape[2], data.shape[3]
    steps, offsets = _seq(steps), _seq(offsets)
    step_y = steps[0] if steps[0] > 0 else 1.0 / in_h
    step_x = steps[1] if steps[1] > 0 else 1.0 / in_w
    ct = torch.promote_types(data.dtype, torch.float32)
    dev = data.device
    cy = (torch.arange(in_h, dtype=ct, device=dev) + offsets[0]) * step_y
    cx = (torch.arange(in_w, dtype=ct, device=dev) + offsets[1]) * step_x
    cxg = cx[None, :].expand(in_h, in_w)
    cyg = cy[:, None].expand(in_h, in_w)
    anchors = []
    for w, h in _prior_extents(sizes, ratios, in_h, in_w):
        # rounded to the data's dtype first, as the JAX op's arrays are
        hw, hh = _as_dtype(w, data.dtype), _as_dtype(h, data.dtype)
        anchors.append(torch.stack([cxg - hw, cyg - hh, cxg + hw, cyg + hh],
                                   dim=-1))
    out = torch.stack(anchors, dim=2).reshape(1, -1, 4)
    if clip:
        out = _clip(out, 0.0, 1.0)
    return out.to(data.dtype)


# --------------------------------------------------------------------------
# MultiBoxTarget
# --------------------------------------------------------------------------

def _encode_loc(anchors, gt, variances):
    """The SSD offsets of gt boxes (..., A, 4) from anchors (A, 4)."""
    aw = anchors[:, 2] - anchors[:, 0]
    ah = anchors[:, 3] - anchors[:, 1]
    ax = (anchors[:, 0] + anchors[:, 2]) * 0.5
    ay = (anchors[:, 1] + anchors[:, 3]) * 0.5
    gw = gt[..., 2] - gt[..., 0]
    gh = gt[..., 3] - gt[..., 1]
    gx = (gt[..., 0] + gt[..., 2]) * 0.5
    gy = (gt[..., 1] + gt[..., 3]) * 0.5
    return torch.stack([
        (gx - ax) / aw / variances[0],
        (gy - ay) / ah / variances[1],
        torch.log(_maximum(gw / aw, 1e-12)) / variances[2],
        torch.log(_maximum(gh / ah, 1e-12)) / variances[3]], dim=-1)


def _scatter_row(t, idx, val):
    """t[b, idx[b]] = val[b] for each row b, in place."""
    t.scatter_(1, idx[:, None], val[:, None])


def _match(anchors, label, cls_pred, overlap_threshold, negative_mining_ratio,
           negative_mining_thresh, minimum_negative_samples):
    """The discrete half of MultiBoxTarget on detached inputs: (matched
    label row (N, A), positive (N, A), negative (N, A)).

    Greedy bipartite matching first: G rounds, each taking the flat
    first maximum of the IoU among anchors and labels not yet used.  Then
    each other anchor takes its best label where that IoU passes
    *overlap_threshold*.  Negatives are all the rest, or with
    *negative_mining_ratio* the hardest candidates (lowest background
    probability, stable order) up to ratio x positives."""
    N, G = label.shape[0], label.shape[1]
    A = anchors.shape[0]
    dev = anchors.device
    valid = label[:, :, 0] != -1.0
    iou = _box_iou_corner(anchors, label[:, :, 1:5])          # (N, A, G)
    iou = torch.where(valid[:, None, :], iou, -1.0)
    m_iou = torch.full((N, A), -1.0, dtype=anchors.dtype, device=dev)
    m_gt = torch.full((N, A), -1, dtype=torch.int64, device=dev)
    a_used = torch.zeros((N, A), dtype=torch.bool, device=dev)
    g_used = torch.zeros((N, G), dtype=torch.bool, device=dev)
    for _ in range(G):
        masked = torch.where(a_used[:, :, None] | g_used[:, None, :], -1.0,
                             iou).reshape(N, A * G)
        flat = masked.argmax(dim=1)
        bi = torch.div(flat, G, rounding_mode="floor")
        bj = flat - bi * G
        best = masked.gather(1, flat[:, None])[:, 0]
        ok = best > 1e-6
        _scatter_row(m_iou, bi, torch.where(
            ok, best, m_iou.gather(1, bi[:, None])[:, 0]))
        _scatter_row(m_gt, bi, torch.where(
            ok, bj, m_gt.gather(1, bi[:, None])[:, 0]))
        _scatter_row(a_used, bi, a_used.gather(1, bi[:, None])[:, 0] | ok)
        _scatter_row(g_used, bj, g_used.gather(1, bj[:, None])[:, 0] | ok)
    best_gt = iou.argmax(dim=2)
    best_iou = iou.amax(dim=2)
    if overlap_threshold > 0:
        thr_pos = ~a_used & (best_iou > overlap_threshold)
    else:
        thr_pos = torch.zeros_like(a_used)
    m_gt = torch.where(thr_pos, best_gt, m_gt)
    m_iou = torch.where(a_used, m_iou, best_iou)
    positive = a_used | thr_pos
    if negative_mining_ratio > 0:
        num_pos = positive.sum(dim=1)
        num_neg = torch.minimum((num_pos * negative_mining_ratio).to(
            torch.int32).to(torch.int64), A - num_pos)
        num_neg = torch.clamp(num_neg, min=int(minimum_negative_samples))
        mx = cls_pred.amax(dim=1)
        prob0 = torch.exp(cls_pred[:, 0] - mx) / \
            torch.exp(cls_pred - mx[:, None]).sum(dim=1)
        cand = ~positive & (m_iou < negative_mining_thresh)
        score = torch.where(cand, prob0, _INF)
        order = torch.argsort(score, dim=1, stable=True)     # hardest first
        rank = torch.empty_like(order).scatter_(
            1, order, torch.arange(A, device=dev).expand(N, A).contiguous())
        negative = cand & (rank < num_neg[:, None])
    else:
        negative = ~positive
    return m_gt, positive, negative


@register_op("_contrib_MultiBoxTarget", num_outputs=3,
             aliases=("MultiBoxTarget",),
             input_names=("anchor", "label", "cls_pred"))
def _multibox_target(anchor, label, cls_pred, overlap_threshold=0.5,
                     ignore_label=-1.0, negative_mining_ratio=-1.0,
                     negative_mining_thresh=0.5,
                     minimum_negative_samples=0,
                     variances=(0.1, 0.1, 0.2, 0.2)):
    """SSD training targets (reference: multibox_target.cc): anchor (1, A,
    4), label (N, G, 5+) rows [cls, l, t, r, b] (cls -1 pads), cls_pred
    (N, C, A) -> (loc_target (N, A*4), loc_mask (N, A*4), cls_target
    (N, A)): the encoded offsets and mask of each positive anchor, its
    class + 1, 0 for a negative and *ignore_label* for the rest.  The
    matching runs without gradient; loc_target carries it to the anchors
    and label boxes, cls_target to the label classes, as ``jax.vjp`` of
    the JAX op does."""
    anchors = anchor.reshape(-1, 4)
    N, A = label.shape[0], anchors.shape[0]
    with torch.no_grad():
        m_gt, positive, negative = _match(
            anchors.detach(), label.detach(), cls_pred.detach(),
            overlap_threshold, negative_mining_ratio, negative_mining_thresh,
            minimum_negative_samples)
    idx = torch.clamp(m_gt, min=0)
    gt_boxes = _rows(label[:, :, 1:5], idx)
    loc_t = _encode_loc(anchors, gt_boxes, _seq(variances))
    pos4 = positive[:, :, None]
    loc_t = torch.where(pos4, loc_t, 0.0).reshape(N, A * 4)
    loc_m = pos4.expand(N, A, 4).to(anchors.dtype).reshape(N, A * 4)
    cls_t = torch.where(
        positive, label[:, :, 0].gather(1, idx) + 1.0,
        torch.where(negative, 0.0, float(ignore_label)).to(label.dtype))
    return loc_t, loc_m, cls_t


# --------------------------------------------------------------------------
# NMS (shared masked loop)
# --------------------------------------------------------------------------

def _nms_mask(boxes, scores, valid, thresh, ids=None, force_suppress=True,
              topk=-1):
    """Greedy NMS keep mask, batched: boxes (B, N, 4) corner, scores and
    valid (B, N), ids (B, N) or None.  Returns the mask in the original
    order.

    Only the first min(N, topk) boxes in descending score order (stable)
    take part.  In the JAX op a sorted row past topk is invalid, so it
    never survives, and only surviving rows suppress, so it never
    suppresses either: the loop and the IoU rows stop at that row with the
    same keep mask.  At SSD-300 this is what makes the op fit a CUDA
    graph: 400 steps and a 400 x 400 IoU per image where all 8732 anchors
    would take 8732 steps and a 305 MB matrix each."""
    B, N = scores.shape
    order = torch.argsort(-scores, dim=1, stable=True)
    K = N if topk is None or topk <= 0 else min(N, int(topk))
    top = order[:, :K]
    b = _rows(boxes, top)
    v = valid.gather(1, top)
    iou = _box_iou_corner(b, b)                                # (B, K, K)
    if ids is not None and not force_suppress:
        idk = ids.gather(1, top)
        iou = torch.where(idk[:, :, None] == idk[:, None, :], iou, 0.0)
    earlier = torch.ones((K, K), dtype=torch.bool, device=boxes.device).tril(-1)
    over = (iou > thresh) & earlier                  # row i: j < i overlapping
    keep = v.clone()
    for i in range(K):
        keep[:, i] = v[:, i] & ~(over[:, i] & keep).any(dim=1)
    return torch.zeros((B, N), dtype=torch.bool,
                       device=boxes.device).scatter(1, top, keep)


def _kept_rows(rows, keep, scores):
    """Survivors first in descending score (stable), then rows of -1."""
    order = torch.argsort(-torch.where(keep, scores, -_INF), dim=1,
                          stable=True)
    return torch.where(keep.gather(1, order)[:, :, None], _rows(rows, order),
                       -1.0)


@register_op("_contrib_box_iou", aliases=("box_iou",),
             input_names=("lhs", "rhs"))
def _box_iou(lhs, rhs, format="corner"):
    """IoU of every box of lhs (..., 4) against every box of rhs (..., 4)
    -> lhs.shape[:-1] + rhs.shape[:-1]."""
    if format == "center":
        lhs, rhs = _to_corner(lhs), _to_corner(rhs)
    lshape, rshape = tuple(lhs.shape[:-1]), tuple(rhs.shape[:-1])
    out = _box_iou_corner(lhs.reshape(-1, 4), rhs.reshape(-1, 4))
    return out.reshape(lshape + rshape)


@register_op("_contrib_box_nms", num_outputs=2, num_visible_outputs=1,
             aliases=("box_nms",))
def _box_nms(data, overlap_thresh=0.5, valid_thresh=0.0, topk=-1,
             coord_start=2, score_index=1, id_index=-1,
             force_suppress=False, in_format="corner",
             out_format="corner"):
    """Greedy NMS (reference: bounding_box.cc box_nms) over data (...,
    N, K): suppressed and invalid rows become -1, survivors keep
    descending score order."""
    shape = tuple(data.shape)
    flat = data.reshape((-1,) + shape[-2:])
    cs = int(coord_start)
    boxes = flat[:, :, cs:cs + 4]
    if in_format == "center":
        boxes = _to_corner(boxes)
    scores = flat[:, :, int(score_index)]
    valid = scores > valid_thresh
    ids = flat[:, :, int(id_index)] if id_index >= 0 else None
    keep = _nms_mask(boxes, scores, valid, overlap_thresh, ids,
                     force_suppress or id_index < 0, topk)
    rows = flat
    if out_format != in_format:
        b = rows[:, :, cs:cs + 4]
        b = _to_corner(b) if in_format == "center" else _to_center(b)
        rows = torch.cat([rows[:, :, :cs], b, rows[:, :, cs + 4:]], dim=2)
    out = _kept_rows(rows, keep, scores).reshape(shape)
    return out, out


alias("_contrib_box_non_maximum_suppression", "_contrib_box_nms")


# --------------------------------------------------------------------------
# MultiBoxDetection
# --------------------------------------------------------------------------

@register_op("_contrib_MultiBoxDetection", aliases=("MultiBoxDetection",),
             input_names=("cls_prob", "loc_pred", "anchor"))
def _multibox_detection(cls_prob, loc_pred, anchor, clip=True,
                        threshold=0.01, background_id=0,
                        nms_threshold=0.5, force_suppress=False,
                        variances=(0.1, 0.1, 0.2, 0.2), nms_topk=-1):
    """Decode SSD predictions and suppress per class (reference:
    multibox_detection.cc): cls_prob (N, C, A), loc_pred (N, A*4),
    anchor (1, A, 4) -> (N, A, 6) rows [cls_id, score, l, t, r, b],
    survivors first, the rest -1."""
    anchors = anchor.reshape(-1, 4)
    N, C, A = cls_prob.shape
    var = _seq(variances)
    aw = anchors[:, 2] - anchors[:, 0]
    ah = anchors[:, 3] - anchors[:, 1]
    ax = (anchors[:, 0] + anchors[:, 2]) * 0.5
    ay = (anchors[:, 1] + anchors[:, 3]) * 0.5
    loc = loc_pred.reshape(N, A, 4)
    px = loc[..., 0] * var[0] * aw + ax
    py = loc[..., 1] * var[1] * ah + ay
    pw = torch.exp(loc[..., 2] * var[2]) * aw * 0.5
    ph = torch.exp(loc[..., 3] * var[3]) * ah * 0.5
    boxes = torch.stack([px - pw, py - ph, px + pw, py + ph], dim=-1)
    if clip:
        boxes = _clip(boxes, 0.0, 1.0)
    # the best class other than the background, per anchor
    bg = (torch.arange(C, device=cls_prob.device) == background_id)
    scores = torch.where(bg[None, :, None], -1.0, cls_prob)
    cls_id = scores.argmax(dim=1)
    score = scores.amax(dim=1)
    valid = score > threshold
    # class ids skip the background: id - 1 past it
    out_id = torch.where(valid, cls_id.to(cls_prob.dtype) -
                         (cls_id > background_id).to(cls_prob.dtype), -1.0)
    keep = _nms_mask(boxes, score, valid, nms_threshold, out_id,
                     force_suppress, nms_topk)
    rows = torch.cat([out_id[..., None], score[..., None], boxes], dim=-1)
    return _kept_rows(rows, keep, score)


# --------------------------------------------------------------------------
# ROIAlign, Proposal
# --------------------------------------------------------------------------

def _gather_nchw(data, bidx, yi, xi):
    """data[bidx[r], :, yi[r, y], xi[r, x]] -> (R, C, Y, X)."""
    v = data[bidx[:, None, None], :, yi[:, :, None], xi[:, None, :]]
    return v.permute(0, 3, 1, 2)


@register_op("_contrib_ROIAlign", aliases=("ROIAlign",),
             input_names=("data", "rois"))
def _roi_align(data, rois, pooled_size=(7, 7), spatial_scale=1.0,
               sample_ratio=-1):
    """ROI Align with bilinear sampling (reference: roi_align.cc): data
    (N, C, H, W), rois (R, 5) [batch_idx, x1, y1, x2, y2] in image
    coordinates -> (R, C, ph, pw), each bin the mean of sr x sr samples."""
    N, C, H, W = data.shape
    ph, pw = (int(v) for v in _seq(pooled_size))
    sr = int(sample_ratio) if sample_ratio > 0 else 2
    bidx = rois[:, 0].to(torch.int64)
    x1, y1 = rois[:, 1] * spatial_scale, rois[:, 2] * spatial_scale
    x2, y2 = rois[:, 3] * spatial_scale, rois[:, 4] * spatial_scale
    rw = _maximum(x2 - x1, 1.0)
    rh = _maximum(y2 - y1, 1.0)
    dt, dev = data.dtype, data.device
    iy = torch.arange(ph * sr, dtype=dt, device=dev) + 0.5
    ix = torch.arange(pw * sr, dtype=dt, device=dev) + 0.5
    ys = y1[:, None] + iy[None, :] * rh[:, None] / (ph * sr)
    xs = x1[:, None] + ix[None, :] * rw[:, None] / (pw * sr)
    y0 = _clip(torch.floor(ys), 0, H - 1)
    x0 = _clip(torch.floor(xs), 0, W - 1)
    y1i = _clip(y0 + 1, 0, H - 1).to(torch.int64)
    x1i = _clip(x0 + 1, 0, W - 1).to(torch.int64)
    y0i = y0.to(torch.int64)
    x0i = x0.to(torch.int64)
    wy1 = _clip(ys - y0, 0.0, 1.0)
    wx1 = _clip(xs - x0, 0.0, 1.0)
    wy0, wx0 = (1 - wy1)[:, None, :, None], (1 - wx1)[:, None, None, :]
    wy1, wx1 = wy1[:, None, :, None], wx1[:, None, None, :]
    val = (_gather_nchw(data, bidx, y0i, x0i) * wy0 * wx0
           + _gather_nchw(data, bidx, y0i, x1i) * wy0 * wx1
           + _gather_nchw(data, bidx, y1i, x0i) * wy1 * wx0
           + _gather_nchw(data, bidx, y1i, x1i) * wy1 * wx1)
    R = rois.shape[0]
    return val.reshape(R, C, ph, sr, pw, sr).mean(dim=(3, 5))


@register_op("_contrib_Proposal", aliases=("Proposal",),
             input_names=("cls_prob", "bbox_pred", "im_info"),
             num_outputs=lambda p: 2 if p.get("output_score") else 1)
def _proposal(cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n=6000,
              rpn_post_nms_top_n=300, threshold=0.7, rpn_min_size=16,
              scales=(4, 8, 16, 32), ratios=(0.5, 1, 2),
              feature_stride=16, output_score=False, iou_loss=False):
    """RPN proposals (reference: proposal.cc): anchors decoded and
    clipped to the image, the too small masked, NMS over the top
    rpn_pre_nms_top_n, then rpn_post_nms_top_n rows per image (zeros
    past the survivors) -> (N * post, 5) [batch_idx, x1, y1, x2, y2], and
    the scores (N * post, 1) with *output_score*.  The batched
    ``MultiProposal`` is the same op."""
    N, num_anchors2, H, W = cls_prob.shape
    A = num_anchors2 // 2
    dt, dev = cls_prob.dtype, cls_prob.device
    base = feature_stride
    ws, hs = [], []
    for r in _seq(ratios):
        size_r = base * base / r
        w0 = round(size_r ** 0.5)
        h0 = round(w0 * r)
        for s in _seq(scales):
            ws.append(w0 * s)
            hs.append(h0 * s)
    ws = torch.tensor(ws, dtype=dt, device=dev)
    hs = torch.tensor(hs, dtype=dt, device=dev)
    cx = (base - 1) / 2.0
    shift_x = torch.arange(W, device=dev) * feature_stride
    shift_y = torch.arange(H, device=dev) * feature_stride
    acx = (cx + shift_x[None, :, None]).to(dt)              # (1, W, 1)
    acy = (cx + shift_y[:, None, None]).to(dt)              # (H, 1, 1)
    anchors = torch.stack([
        (acx - (ws - 1) / 2).expand(H, W, A),
        (acy - (hs - 1) / 2).expand(H, W, A),
        (acx + (ws - 1) / 2).expand(H, W, A),
        (acy + (hs - 1) / 2).expand(H, W, A)], dim=-1).reshape(-1, 4)
    scores = cls_prob[:, A:].permute(0, 2, 3, 1).reshape(N, -1)
    deltas = bbox_pred.reshape(N, A, 4, H, W).permute(0, 3, 4, 1, 2) \
        .reshape(N, -1, 4)
    aw = anchors[:, 2] - anchors[:, 0] + 1
    ah = anchors[:, 3] - anchors[:, 1] + 1
    ax = anchors[:, 0] + 0.5 * (aw - 1)
    ay = anchors[:, 1] + 0.5 * (ah - 1)
    px = deltas[..., 0] * aw + ax
    py = deltas[..., 1] * ah + ay
    pw = torch.exp(deltas[..., 2]) * aw
    ph = torch.exp(deltas[..., 3]) * ah
    hi_x = (im_info[:, 1] - 1)[:, None]
    hi_y = (im_info[:, 0] - 1)[:, None]
    boxes = torch.stack([
        torch.minimum(_maximum(px - 0.5 * (pw - 1), 0.0), hi_x),
        torch.minimum(_maximum(py - 0.5 * (ph - 1), 0.0), hi_y),
        torch.minimum(_maximum(px + 0.5 * (pw - 1), 0.0), hi_x),
        torch.minimum(_maximum(py + 0.5 * (ph - 1), 0.0), hi_y)], dim=-1)
    min_size = (rpn_min_size * im_info[:, 2])[:, None]
    keep_sz = ((boxes[..., 2] - boxes[..., 0] + 1) >= min_size) & \
        ((boxes[..., 3] - boxes[..., 1] + 1) >= min_size)
    scores = torch.where(keep_sz, scores, -_INF)
    keep = _nms_mask(boxes, scores, keep_sz, threshold,
                     topk=rpn_pre_nms_top_n)
    order = torch.argsort(-torch.where(keep, scores, -_INF), dim=1,
                          stable=True)
    top = order[:, :int(rpn_post_nms_top_n)]
    ok = keep.gather(1, top)
    rois = torch.where(ok[..., None], _rows(boxes, top), 0.0)
    sc = torch.where(ok, scores.gather(1, top), 0.0)
    batch_idx = torch.arange(N, dtype=dt, device=dev).repeat_interleave(
        top.shape[1])
    rois5 = torch.cat([batch_idx[:, None], rois.reshape(-1, 4)], dim=1)
    if output_score:
        return rois5, sc.reshape(-1, 1)
    return rois5


alias("MultiProposal", "_contrib_Proposal")
alias("_contrib_MultiProposal", "_contrib_Proposal")
