"""Quantization lowering: fp32 Symbol -> int8 Symbol + param tree (port of
``mxnet_tpu/quantize/lower.py``: the same graph rewrite, node names and
parameters, so one CalibTable lowers to the same symbol JSON and int8
weights in both packages).

The Glow-style recipe (PAPERS.md), mapped onto this graph: walk the
fp32 graph in topological order keeping TWO representations per
tensor —

* the **fp32 entry** (always constructible; materialized lazily via
  ``_contrib_dequantize`` when a non-quantized consumer needs it), and
* the **quantized entry** (int8 value + symmetric range), present only
  along quantized chains.

A quantizable layer (Convolution / FullyConnected, policy permitting,
calibrated input range available) consumes the quantized entry when
its producer has one — so adjacent quantized layers are **fused
through a single int32->int8 requantize** against the calibrated
inter-layer range, with no dequantize/quantize round trip — and falls
back to inserting ``_contrib_quantize`` on the fp32 entry otherwise.
ReLU / Pooling / Flatten between quantized layers stay in the int8
domain (``_contrib_quantized_act`` / ``_contrib_quantized_pooling`` /
``_contrib_quantized_flatten``).  Every other op consumes fp32 —
the unsupported-op fallback is by construction, not by special case.

Weights are quantized OFFLINE (symmetric int8) into the returned
param tree; biases are requantized to int32 at the accumulator scale
``s_data * s_weight`` and added before the requantize, so the whole
conv/fc(+bias) block runs in integers.  ``int8-weight-only`` mode
keeps compute fp32 and only ships int8 weights (dequantized
in-graph): the memory-bound win without the activation-accuracy risk.
"""

from __future__ import annotations

import numpy as _np

from .calibrate import CalibTable, tensor_name
from .policy import QuantizePolicy, QuantizationError
from .. import ndarray as nd
from .. import symbol as S
from ..context import Context, current_context
from ..observability import events as _obs_events
from ..symbol.symbol import Node, Symbol

__all__ = ["quantize_model", "hlo_has_int8_compute",
           "hlo_has_int8_tensors", "int8_work"]

_QUANTIZABLE = ("Convolution", "FullyConnected")
_QCONV_PARAMS = ("kernel", "stride", "pad", "dilate", "num_filter",
                 "num_group")
_QFC_PARAMS = ("num_hidden", "flatten")
_INT32_MAX = 2 ** 31 - 1


def _np_of(v):
    asnumpy = getattr(v, "asnumpy", None)
    return asnumpy() if asnumpy is not None else _np.asarray(v)


def quantize_model(symbol, arg_params, calib=None, policy=None,
                   aux_params=None, name="model", ctx=None):
    """Lower *symbol* onto the int8 kernels per *policy* and *calib*.

    Returns ``(qsym, qarg_params, qaux_params, report)``.  The report
    records per-layer coverage (``"int8"`` / ``"int8-weight-only"`` /
    ``"fp32:<reason>"`` for every Convolution/FullyConnected), the
    int8-passthrough ops, and the calib sha the lowering was built
    against — the identity ``health(name)`` and the tuning store
    quote.  The new parameters (int8 weights, int32 biases, ranges) are
    made on *ctx* (default: the current context, ``gpu(0)``).
    """
    policy = QuantizePolicy.coerce(policy if policy is not None
                                   else "int8")
    if policy is None:
        raise QuantizationError(
            "quantize_model needs an active policy (got 'off')")
    if policy.needs_calib:
        if calib is None:
            raise QuantizationError(
                "mode 'int8' quantizes activations and needs a "
                "CalibTable (run quantize.calibrate, or use "
                "'int8-weight-only')")
        if not isinstance(calib, CalibTable):
            raise QuantizationError(
                "calib must be a CalibTable, got %s"
                % type(calib).__name__)

    ctx = Context(ctx) if ctx is not None else current_context()
    ctx.torch_device        # raises without CUDA unless given mx.cpu()

    def _array(a):
        return nd.array(a, ctx=ctx)

    def _scalar(x):
        return _array(_np.asarray(x, _np.float32))

    params_np = {n: _np_of(v) for n, v in (arg_params or {}).items()}
    order = symbol._topo()
    excluded = set(policy.exclude)
    qable = [n.name for n in order
             if not n.is_var and n.op.name in _QUANTIZABLE]
    skip_fl = set()
    if policy.first_last_fp32 and qable:
        skip_fl = {qable[0], qable[-1]}

    fp32 = {}     # (id(node), idx) -> entry producing the fp32 value
    qrep = {}     # (id(node), idx) -> (q, min, max entries, M float)
    acc32 = {}    # (id(node), idx) -> (int32, min, max entries)
    qargs = dict(arg_params or {})
    wq_cache = {}
    layers = {}
    passthrough = []

    def fp32_entry(key, src_name):
        """The fp32 entry for *key*, dequantizing a quantized-only
        tensor on demand (int32 accumulator preferred: full
        precision, bias already applied)."""
        e = fp32.get(key)
        if e is not None:
            return e
        if key in acc32:
            q, mn, mx = acc32[key]
        else:
            q, mn, mx = qrep[key][:3]
        deq = S._contrib_dequantize(
            Symbol([q]), Symbol([mn]), Symbol([mx]),
            name="%s_dequantize" % src_name)
        fp32[key] = deq._outputs[0]
        return fp32[key]

    def fp32_sym(entry_key, src):
        return Symbol([fp32_entry(entry_key, src)])

    def quant_weight(worig):
        """Offline symmetric int8 weight params (cached: tied weights
        quantize once)."""
        cached = wq_cache.get(worig.name)
        if cached is not None:
            return cached
        w = params_np[worig.name]
        m = float(_np.abs(w).max()) or 1e-8
        q = _np.clip(_np.round(w * 127.0 / m), -127, 127) \
            .astype(_np.int8)
        qargs["%s_quantized" % worig.name] = _array(q)
        qargs["%s_min" % worig.name] = _scalar(-m)
        qargs["%s_max" % worig.name] = _scalar(m)
        out = (S.var("%s_quantized" % worig.name),
               S.var("%s_min" % worig.name),
               S.var("%s_max" % worig.name), m)
        wq_cache[worig.name] = out
        return out

    def copy_fp32(node, reason=None):
        ins = [fp32_entry((id(s), i), tensor_name(s, i))
               for (s, i) in node.inputs]
        new = Node(node.op, node.name, params=node.params,
                   inputs=ins, attrs=node.attrs)
        for i in range(node.num_outputs()):
            fp32[(id(node), i)] = (new, i)
        if node.op.name in _QUANTIZABLE:
            layers[node.name] = "fp32:%s" % (reason or "fallback")

    for node in order:
        if node.is_var:
            fp32[(id(node), 0)] = (node, 0)
            continue
        opname = node.op.name
        lname = node.name
        key0 = (id(node), 0)
        in_node, in_idx = node.inputs[0] if node.inputs else (None, 0)
        ikey = (id(in_node), in_idx) if in_node is not None else None

        if opname in _QUANTIZABLE:
            # -- eligibility ----------------------------------------------
            reason = None
            if lname in excluded:
                reason = "excluded"
            elif lname in skip_fl:
                reason = "first-last-fp32"
            else:
                worig, _w_idx = node.inputs[1]
                if not (worig.is_var and worig.name in params_np):
                    reason = "weight-not-a-parameter"
            has_bias = not node.params.get("no_bias", False) and \
                len(node.inputs) > 2
            if reason is None and policy.mode == "int8":
                in_name = tensor_name(in_node, in_idx)
                if ikey not in qrep and not calib.covers(in_name):
                    reason = "no-calib-range"
                if reason is None and has_bias:
                    bsrc, _ = node.inputs[2]
                    if not (bsrc.is_var and bsrc.name in params_np):
                        reason = "bias-not-a-parameter"
            if reason is not None:
                copy_fp32(node, reason)
                continue

            wq_sym, wmin_sym, wmax_sym, m_w = quant_weight(
                node.inputs[1][0])

            if policy.mode == "int8-weight-only":
                # int8 weights shipped, dequantized in-graph; compute
                # stays fp32 (and so does the bias path)
                wdeq = S._contrib_dequantize(
                    wq_sym, wmin_sym, wmax_sym,
                    name="%s_wdeq" % lname)
                ins = [fp32_entry((id(s), i), tensor_name(s, i))
                       for (s, i) in node.inputs]
                ins[1] = wdeq._outputs[0]
                new = Node(node.op, lname, params=node.params,
                           inputs=ins, attrs=node.attrs)
                for i in range(node.num_outputs()):
                    fp32[(id(node), i)] = (new, i)
                layers[lname] = "int8-weight-only"
                continue

            # -- weight+activation int8 -----------------------------------
            if ikey in qrep:
                # fused: consume the upstream chain's int8 tensor
                q_e, mn_e, mx_e, m_in = qrep[ikey]
                d_sym = Symbol([q_e])
                dmn_sym, dmx_sym = Symbol([mn_e]), Symbol([mx_e])
            else:
                in_name = tensor_name(in_node, in_idx)
                m_in = calib.max_abs(in_name)
                qargs["%s_data_min" % lname] = _scalar(-m_in)
                qargs["%s_data_max" % lname] = _scalar(m_in)
                qz = S._contrib_quantize(
                    fp32_sym(ikey, in_name),
                    S.var("%s_data_min" % lname),
                    S.var("%s_data_max" % lname),
                    out_type="int8", name="%s_quantize" % lname)
                d_sym, dmn_sym, dmx_sym = qz[0], qz[1], qz[2]

            if opname == "Convolution":
                qp = {k: node.params[k] for k in _QCONV_PARAMS
                      if node.params.get(k) is not None}
                q = S._contrib_quantized_conv(
                    d_sym, wq_sym, dmn_sym, dmx_sym, wmin_sym,
                    wmax_sym, name="%s_quantized" % lname, **qp)
            else:
                qp = {k: node.params[k] for k in _QFC_PARAMS
                      if node.params.get(k) is not None}
                q = S._contrib_quantized_fully_connected(
                    d_sym, wq_sym, dmn_sym, dmx_sym, wmin_sym,
                    wmax_sym, name="%s_quantized" % lname, **qp)
            out32_sym, omn_sym, omx_sym = q[0], q[1], q[2]

            if has_bias:
                # bias at the accumulator scale, added in int32 so the
                # whole block (and any fused requantize) sees it
                b = params_np[node.inputs[2][0].name]
                s_acc = (m_in / 127.0) * (m_w / 127.0)
                bq = _np.clip(_np.round(b / s_acc),
                              -_INT32_MAX, _INT32_MAX) \
                    .astype(_np.int32)
                if opname == "Convolution":
                    rank = len(node.params.get("kernel", (1, 1)))
                    bq = bq.reshape((1, -1) + (1,) * rank)
                else:
                    bq = bq.reshape(1, -1)
                qargs["%s_bias_quantized" % lname] = _array(bq)
                out32_sym = S.broadcast_add(
                    out32_sym, S.var("%s_bias_quantized" % lname),
                    name="%s_biasadd" % lname)
            acc32[key0] = (out32_sym._outputs[0], omn_sym._outputs[0],
                           omx_sym._outputs[0])

            out_name = tensor_name(node, 0)
            if calib.covers(out_name):
                # fused inter-layer requantize: int32 -> int8 against
                # the calibrated range of THIS tensor, ready for the
                # next quantized consumer
                m_out = calib.max_abs(out_name)
                rq = S._contrib_requantize(
                    out32_sym, omn_sym, omx_sym,
                    min_calib_range=-m_out, max_calib_range=m_out,
                    name="%s_requantize" % lname)
                qrep[key0] = (rq._outputs[0], rq._outputs[1],
                              rq._outputs[2], m_out)
            layers[lname] = "int8"
            continue

        # -- int8-transparent ops: stay in the quantized domain ----------
        if policy.mode == "int8" and ikey in qrep and \
                lname not in excluded:
            q_e, mn_e, mx_e, m_in = qrep[ikey]
            qs = (Symbol([q_e]), Symbol([mn_e]), Symbol([mx_e]))
            handled = None
            if opname == "Activation" and \
                    node.params.get("act_type") == "relu":
                handled = S._contrib_quantized_act(
                    *qs, act_type="relu", name="%s_q" % lname)
            elif opname == "Pooling" and \
                    node.params.get("pool_type", "max") in \
                    ("max", "avg") and \
                    node.params.get("pooling_convention",
                                    "valid") == "valid":
                qp = {k: node.params[k]
                      for k in ("kernel", "stride", "pad",
                                "pool_type", "global_pool")
                      if node.params.get(k) is not None}
                handled = S._contrib_quantized_pooling(
                    *qs, name="%s_q" % lname, **qp)
            elif opname in ("Flatten", "flatten"):
                handled = S._contrib_quantized_flatten(
                    *qs, name="%s_q" % lname)
            if handled is not None:
                qrep[key0] = (handled._outputs[0],
                              handled._outputs[1],
                              handled._outputs[2], m_in)
                passthrough.append(lname)
                continue

        copy_fp32(node)

    qsym = Symbol([fp32_entry((id(n), i), tensor_name(n, i))
                   for (n, i) in symbol._outputs])
    live = set(qsym.list_arguments())
    qargs = {n: v for n, v in qargs.items() if n in live}
    aux_params = aux_params or {}
    qaux = {n: aux_params[n]
            for n in qsym.list_auxiliary_states() if n in aux_params}

    covered = sum(1 for v in layers.values()
                  if not v.startswith("fp32"))
    report = {
        "mode": policy.mode,
        "calib_sha": calib.sha if calib is not None else None,
        "layers": layers,
        "passthrough": passthrough,
        "covered": covered,
        "total": len(layers),
    }
    _obs_events.emit("quantize", kind="lower", model=name,
                     mode=policy.mode, covered=covered,
                     total=len(layers),
                     passthrough=len(passthrough),
                     calib_sha=(calib.sha[:12] if calib is not None
                                else None))
    return qsym, qargs, qaux, report


# -- proof of int8 compute -------------------------------------------------
#
# The JAX package proves int8 compute from each rung's lowered StableHLO.
# The port lowers to no StableHLO: its quantized ops count their int8
# products and the int8 tensors they consume while a rung's program is
# built (on the card: while its CUDA graph is captured, so the counts are
# per replay; ops/quantization.py), and the predictor keeps them per rung.


def int8_work(pred, rung):
    """What one run of *pred*'s program for a natural batch of *rung* rows
    does (``CompiledPredictor.program_work``): ``int8_products``,
    ``int8_tensors``, ``int8_dequantized``, ``float_products``,
    ``compute_bytes``."""
    return pred.program_work(pred.rung_shapes(rung))


def hlo_has_int8_compute(pred, rung):
    """Does *pred*'s program at *rung* run int8 products?  The
    weight+activation gate: the conv/fc compute provably runs on int8
    operands, not on dequantized fp32."""
    return int8_work(pred, rung)["int8_products"] > 0


def hlo_has_int8_tensors(pred, rung):
    """Weaker proof for weight-only mode: the program dequantizes int8
    tensors (the shipped weights) in-graph."""
    return int8_work(pred, rung)["int8_dequantized"] > 0
