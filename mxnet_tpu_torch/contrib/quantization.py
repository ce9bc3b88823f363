"""INT8 model quantization: graph rewrite + calibration driver (port of
``mxnet_tpu/contrib/quantization.py``, the MXNet 1.3 ``quantize_model``
API).

Reference: ``src/operator/quantization/quantize_graph_pass.cc:119``
(QuantizeGraph inserts quantize/dequantize pairs around ops carrying the
FQuantizedOp attr) and the Python driver
``python/mxnet/contrib/quantization.py`` (quantize_model with calib_mode
none/naive/entropy).

Quantized Convolution/FullyConnected run int8 x int8 -> int32
(``ops/quantization.py``); the rewrite inserts ``_contrib_quantize`` on
activations (with calibrated min/max parameters — calib_mode='naive' or
'entropy' — or with in-graph dynamic min/max — calib_mode='none') and a
``_contrib_dequantize`` on the int32 accumulator; weights are quantized
offline to int8 parameters, so the serialized quantized model carries
int8 weights like the reference's.  The new parameters and the
calibration forward live on *ctx* (default: the current context,
``gpu(0)``).
"""

from __future__ import annotations

import logging

import numpy as _np

from .. import ndarray as nd
from .. import symbol as S
from ..context import Context, current_context
from ..symbol.symbol import Node, Symbol

__all__ = ["quantize_symbol", "quantize_model"]

_QUANTIZABLE = ("Convolution", "FullyConnected")


def _entry_symbol(entry):
    return Symbol([entry])


def quantize_symbol(sym, excluded_sym_names=(), quantized_dtype="int8",
                    calib_mode="naive"):
    """Rewrite *sym*, quantizing every Convolution/FullyConnected not in
    *excluded_sym_names*.

    Returns (qsym, calib_points) where calib_points maps
    ``<node name>_data`` -> the ORIGINAL graph entry feeding that node
    (for offline range collection) — empty for calib_mode='none', where
    ranges are computed in-graph per batch (dynamic quantization).
    """
    assert quantized_dtype == "int8", "int8 is the quantized path"
    excluded = set(excluded_sym_names)
    order = sym._topo()
    entry_map = {}       # (id(orig_node), out_idx) -> new entry
    calib_points = {}

    def mapped(entry):
        node, idx = entry
        if node.is_var:
            return (node, idx)
        return entry_map[(id(node), idx)]

    for node in order:
        if node.is_var:
            continue
        new_inputs = [mapped(e) for e in node.inputs]
        if node.op.name in _QUANTIZABLE and node.name not in excluded:
            data = _entry_symbol(new_inputs[0])
            worig = node.inputs[1][0]           # weight var node
            has_bias = not node.params.get("no_bias", False) and \
                len(node.inputs) > 2
            # activation ranges are symmetric (-M, M): the int32
            # accumulator's real value is then exactly
            # q_d * q_w * (Md/127) * (Mw/127) with no zero-point
            # correction term (the reference's MKLDNN path carries a
            # compensation tensor instead)
            if calib_mode == "none":
                m = S.max(S.abs(data))
                dmin = 0.0 - m
                dmax = m
            else:
                dmin = S.var("%s_data_min" % node.name)
                dmax = S.var("%s_data_max" % node.name)
                calib_points["%s_data" % node.name] = node.inputs[0]
            dq = S._contrib_quantize(data, dmin, dmax, out_type="int8",
                                     name="%s_quantize" % node.name)
            wq = S.var("%s_quantized" % worig.name)
            wmin = S.var("%s_min" % worig.name)
            wmax = S.var("%s_max" % worig.name)
            if node.op.name == "Convolution":
                p = node.params
                q = S._contrib_quantized_conv(
                    dq[0], wq, dq[1], dq[2], wmin, wmax,
                    kernel=p.get("kernel"), stride=p.get("stride"),
                    pad=p.get("pad"), dilate=p.get("dilate"),
                    num_filter=p.get("num_filter"),
                    num_group=p.get("num_group", 1),
                    name="%s_quantized" % node.name)
                out = S._contrib_dequantize(
                    q[0], q[1], q[2], name="%s_dequantize" % node.name)
                if has_bias:
                    bias = _entry_symbol(new_inputs[2])
                    out = S.broadcast_add(
                        out, S.reshape(bias, shape=(1, -1, 1, 1)))
            else:
                p = node.params
                q = S._contrib_quantized_fully_connected(
                    dq[0], wq, dq[1], dq[2], wmin, wmax,
                    num_hidden=p.get("num_hidden"),
                    flatten=p.get("flatten", True),
                    name="%s_quantized" % node.name)
                out = S._contrib_dequantize(
                    q[0], q[1], q[2], name="%s_dequantize" % node.name)
                if has_bias:
                    bias = _entry_symbol(new_inputs[2])
                    out = S.broadcast_add(out,
                                          S.reshape(bias, shape=(1, -1)))
            entry_map[(id(node), 0)] = out._outputs[0]
        else:
            new_node = Node(node.op, node.name, params=node.params,
                            inputs=new_inputs, attrs=node.attrs)
            for i in range(node.num_outputs()):
                entry_map[(id(node), i)] = (new_node, i)

    qsym = Symbol([mapped(e) for e in sym._outputs])
    return qsym, calib_points


class _CalibRunner:
    """Shared calibration-pass driver: binds the collection graph ONCE
    (each bind creates fresh jitted closures — a per-batch or per-pass
    bind would recompile it) and streams every layer output to a
    consume(name, np_array) callback, honoring num_calib_examples."""

    def __init__(self, calib_points, arg_params, aux_params, calib_data,
                 data_names, num_calib_examples, label_names=(), ctx=None):
        self.group = S.Group([_entry_symbol(e)
                              for e in calib_points.values()])
        self.names = list(calib_points)
        self.arg_params = dict(arg_params)
        self.aux_params = dict(aux_params or {})
        self.calib_data = calib_data
        self.data_names = data_names
        self.label_names = label_names
        self.num_calib_examples = num_calib_examples
        self.ctx = ctx
        self._exe = None

    def run(self, consume):
        self.calib_data.reset()
        seen = 0
        for batch in self.calib_data:
            feeds = {}
            for dn, arr in zip(self.data_names, batch.data):
                feeds[dn] = arr
            if batch.label:
                for ln, arr in zip(self.label_names, batch.label):
                    feeds[ln] = arr
            if self._exe is None:
                self._exe = self.group.bind(
                    self.ctx, args={**self.arg_params, **feeds},
                    aux_states=self.aux_params)
            outs = self._exe.forward(is_train=False, **feeds)
            for n, o in zip(self.names, outs):
                consume(n, o.asnumpy())
            seen += batch.data[0].shape[0]
            if self.num_calib_examples is not None and \
                    seen >= self.num_calib_examples:
                break


def _collect_naive_ranges(sym, calib_points, arg_params, aux_params,
                          calib_data, data_names, num_calib_examples,
                          label_names=(), ctx=None):
    """Global min/max per calibration point over the calib batches
    (reference: quantization.py _LayerOutputMinMaxCollector,
    calib_mode='naive')."""
    runner = _CalibRunner(calib_points, arg_params, aux_params,
                          calib_data, data_names, num_calib_examples,
                          label_names, ctx)
    th = {n: (_np.inf, -_np.inf) for n in runner.names}

    def consume(n, v):
        lo, hi = th[n]
        th[n] = (min(lo, float(v.min())), max(hi, float(v.max())))
    runner.run(consume)
    return th


def _kl_optimal_threshold(hist, num_quantized_bins=255):
    """KL-divergence-optimal symmetric clip threshold from a histogram
    of |activation| values (reference: quantization.py
    _get_optimal_threshold, the TensorRT-style entropy calibration).

    Scans candidate clip points; for each, the clipped distribution P
    (outliers folded into the last kept bin) is compared against Q, the
    same mass re-expressed with num_quantized_bins levels.  Returns the
    index (exclusive) of the kept-bin count with minimal KL(P || Q).
    """
    nbins = len(hist)
    hist = hist.astype(_np.float64)
    eps = 1e-6
    best_i, best_kl = nbins, _np.inf
    candidates = list(range(num_quantized_bins, nbins + 1,
                            max(1, num_quantized_bins // 16)))
    if candidates[-1] != nbins:
        candidates.append(nbins)  # the no-clip option must be scorable
    for i in candidates:
        # P: kept range with the clipped-off mass folded into the edge
        p = hist[:i].copy()
        p[i - 1] += hist[i:].sum()
        if p.sum() == 0:
            continue
        # Q: built from the UNFOLDED histogram, re-binned to
        # num_quantized_bins levels and spread back uniformly over each
        # level's nonzero source bins.  The fold appears only in P —
        # that asymmetry is what charges a clip for the mass it throws
        # away; folding both sides would score "clip everything" as
        # lossless.
        ref = hist[:i]
        q = _np.zeros(i)
        step = i / num_quantized_bins
        for b in range(num_quantized_bins):
            lo = int(b * step)
            hi = max(int((b + 1) * step), lo + 1)
            chunk = ref[lo:hi]
            nz = chunk > 0
            if nz.any():
                q[lo:hi][nz] = chunk.sum() / nz.sum()
        pk = p / p.sum() + eps
        qk = q / max(q.sum(), 1e-12) + eps
        pk /= pk.sum()
        qk /= qk.sum()
        kl = float(_np.sum(pk * _np.log(pk / qk)))
        if kl < best_kl:
            best_kl, best_i = kl, i
    return best_i


def _collect_entropy_ranges(calib_points, arg_params, aux_params,
                            calib_data, data_names, num_calib_examples,
                            label_names=(), nbins=2048, ctx=None):
    """Two passes over the calibration set: (1) global |x| max per
    point, (2) histogram accumulation; then the KL-optimal clip
    (reference: calib_mode='entropy').  The executor is bound once and
    shared by both passes."""
    runner = _CalibRunner(calib_points, arg_params, aux_params,
                          calib_data, data_names, num_calib_examples,
                          label_names, ctx)
    names = runner.names
    max_abs = {n: 0.0 for n in names}

    def pass1(n, v):
        a = _np.abs(v)
        max_abs[n] = max(max_abs[n], float(a.max()) if a.size else 0.0)
    runner.run(pass1)

    hists = {n: _np.zeros(nbins, _np.int64) for n in names}

    def pass2(n, v):
        m = max_abs[n] or 1e-8
        # clamp: a non-deterministic calib iterator (reshuffle/augment
        # on reset) can exceed pass-1's max — fold such values into the
        # last bin rather than silently dropping the outlier mass the
        # entropy method exists to measure
        a = _np.minimum(_np.abs(v).ravel(), m)
        h, _ = _np.histogram(a, bins=nbins, range=(0.0, m))
        hists[n] += h
    runner.run(pass2)

    th = {}
    for n in names:
        m = max_abs[n] or 1e-8
        i = _kl_optimal_threshold(hists[n])
        th[n] = (i / len(hists[n])) * m
    return th


def _quantize_weights(sym, arg_params, ctx):
    """Offline symmetric int8 weight quantization for every
    '*_quantized' weight var the rewrite introduced."""
    qargs = dict(arg_params)
    still_needed = set(sym.list_arguments())
    for name in still_needed:
        if name.endswith("_quantized") and name[:-10] in arg_params:
            w = arg_params[name[:-10]].asnumpy()
            m = float(_np.abs(w).max()) or 1e-8
            q = _np.clip(_np.round(w * 127.0 / m), -127, 127) \
                .astype(_np.int8)
            qargs[name] = nd.array(q, ctx=ctx)
            qargs[name[:-10] + "_min"] = nd.array(
                _np.asarray(-m, _np.float32), ctx=ctx)
            qargs[name[:-10] + "_max"] = nd.array(
                _np.asarray(m, _np.float32), ctx=ctx)
            if name[:-10] not in still_needed:
                # the fp32 weight may still be consumed by an excluded
                # layer (tied weights) — only drop it when unused
                del qargs[name[:-10]]
    return qargs


def quantize_model(sym, arg_params, aux_params=None, data_names=("data",),
                   label_names=(), excluded_sym_names=(),
                   calib_mode="naive", calib_data=None,
                   num_calib_examples=None, quantized_dtype="int8",
                   logger=logging, ctx=None):
    """(reference: python/mxnet/contrib/quantization.py quantize_model)

    calib_mode:
      'none'    — dynamic: activation min/max computed in-graph per batch
      'naive'   — offline: global min/max over *calib_data* baked in as
                  parameters (requires calib_data)
      'entropy' — offline: KL-divergence-optimal clip thresholds over
                  *calib_data* (requires calib_data; robust to outlier
                  activations that would stretch naive ranges)
    ctx: where the calibration forward runs and the new parameters live
      (default: the current context, ``gpu(0)``).
    Returns (qsym, qarg_params, aux_params).
    """
    ctx = Context(ctx) if ctx is not None else current_context()
    calib_graph_mode = "none" if calib_mode == "none" else "naive"
    qsym, calib_points = quantize_symbol(
        sym, excluded_sym_names=excluded_sym_names,
        quantized_dtype=quantized_dtype, calib_mode=calib_graph_mode)
    qargs = _quantize_weights(qsym, arg_params, ctx)
    if calib_mode in ("naive", "entropy"):
        assert calib_data is not None, \
            "calib_mode=%r needs calib_data" % calib_mode
        if calib_mode == "naive":
            ranges = _collect_naive_ranges(
                sym, calib_points, arg_params, aux_params, calib_data,
                data_names, num_calib_examples, label_names, ctx)
            th = {n: max(abs(lo), abs(hi))
                  for n, (lo, hi) in ranges.items()}
        else:
            th = _collect_entropy_ranges(
                calib_points, arg_params, aux_params, calib_data,
                data_names, num_calib_examples, label_names, ctx=ctx)
        for point, m in th.items():
            logger.info("calibrated %s (%s): +-%g", point, calib_mode, m)
            qargs["%s_min" % point] = nd.array(
                _np.asarray(-m, _np.float32), ctx=ctx)
            qargs["%s_max" % point] = nd.array(
                _np.asarray(m, _np.float32), ctx=ctx)
    elif calib_mode != "none":
        raise ValueError("calib_mode must be 'none', 'naive' or "
                         "'entropy', got %r" % (calib_mode,))
    return qsym, qargs, dict(aux_params or {})
