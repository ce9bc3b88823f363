"""Quantization policy + the pipeline's typed error (port of
``mxnet_tpu/quantize/policy.py``: pure Python, the same ``to_dict``).

A :class:`QuantizePolicy` is the one knob object the whole pipeline
reads: which mode to lower to (weight+activation ``int8`` vs
``int8-weight-only``), which layers to leave fp32, and what the
load-time accuracy gate tolerates.  Everywhere a policy is accepted a
plain mode string works too (``QuantizePolicy.coerce``) — the registry,
the autotuner and bench all pass ``"int8"``-style strings around and
coerce at the boundary.
"""

from __future__ import annotations

from ..base import MXNetError

__all__ = ["QuantizePolicy", "QuantizationError", "MODES"]

#: lowering modes, in increasing aggressiveness.  "off" is accepted by
#: coerce() (-> None) so a tuner Choice value can flow straight in.
MODES = ("int8-weight-only", "int8")


class QuantizationError(MXNetError):
    """Typed failure of the quantization pipeline: a broken/mismatched
    calibration table, a model the lowering cannot honor, or a
    quantized model that failed the load-time accuracy gate.  Loads
    raise this instead of ever serving silently-wrong answers."""


class QuantizePolicy(object):
    """Controls lowering coverage and the accuracy gate.

    Parameters
    ----------
    mode : str
        ``"int8"`` — quantize activations AND weights; conv/fc run
        int8 x int8 -> int32 with fused requantize between adjacent
        quantized layers.  ``"int8-weight-only"`` — weights are stored
        and shipped int8 (dequantized in-graph); compute stays fp32.
    exclude : iterable of str
        Layer names the lowering must leave fp32 (per-layer opt-out).
    first_last_fp32 : bool
        Keep the first and last quantizable layer fp32 — the classic
        accuracy-preserving recipe for input/logit-adjacent layers.
    max_rel_err : float
        Accuracy gate: max |quantized - fp32| / max |fp32| allowed at
        every rung (relative worst-case error).
    min_top1_agreement : float or None
        Optional second gate: fraction of rows whose argmax matches
        fp32 (checked on the first 2-D output when set).
    gate_batches : int
        Synthetic gate batches per rung when the caller supplies no
        calibration batches to gate on.
    """

    def __init__(self, mode="int8", exclude=(), first_last_fp32=False,
                 max_rel_err=0.1, min_top1_agreement=None,
                 gate_batches=2):
        if mode not in MODES:
            raise QuantizationError(
                "unknown quantization mode %r (have %s)"
                % (mode, list(MODES)))
        self.mode = mode
        self.exclude = tuple(exclude)
        self.first_last_fp32 = bool(first_last_fp32)
        self.max_rel_err = float(max_rel_err)
        self.min_top1_agreement = (None if min_top1_agreement is None
                                   else float(min_top1_agreement))
        self.gate_batches = int(gate_batches)

    @property
    def needs_calib(self):
        """Weight+activation lowering needs calibrated activation
        ranges; weight-only quantizes offline from the weights."""
        return self.mode == "int8"

    @classmethod
    def coerce(cls, value):
        """Policy | mode string | dict -> QuantizePolicy (or None for
        off).  The single entry point every API boundary funnels
        through."""
        if value is None or value == "off":
            return None
        if isinstance(value, cls):
            return value
        if isinstance(value, str):
            return cls(mode=value)
        if isinstance(value, dict):
            return cls(**value)
        raise QuantizationError(
            "cannot coerce %r into a QuantizePolicy" % (value,))

    def to_dict(self):
        return {"mode": self.mode, "exclude": list(self.exclude),
                "first_last_fp32": self.first_last_fp32,
                "max_rel_err": self.max_rel_err,
                "min_top1_agreement": self.min_top1_agreement,
                "gate_batches": self.gate_batches}

    def __repr__(self):
        return "QuantizePolicy(%s)" % ", ".join(
            "%s=%r" % kv for kv in sorted(self.to_dict().items()))
