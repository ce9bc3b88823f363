"""Profile-guided calibration: instrumented forward -> CalibTable (port of
``mxnet_tpu/quantize/calibrate.py``).

Run the fp32 graph on representative batches and capture every floating
tensor's range.  The walk is ``executor._build_eval``'s in eval mode
(``training=False`` on every op with that parameter), with a reduction
appended after each op: ``min``/``max`` (or a percentile of ``|x|``) of
each floating output, taken on the device as the tensor is produced, so
no intermediate outlives its last consumer.  The running ranges stay on
the device across batches and are read back once at the end.

The result is a :class:`CalibTable`: per-tensor ranges keyed by tensor
name with a sha256 over the canonical payload, in the JAX package's JSON,
so a table written by either package loads in the other with the same
sha.  Tables persist through ``atomic_write`` and verify their sha on
load: a torn or hand-edited table fails typed
(:class:`~.policy.QuantizationError`).
"""

from __future__ import annotations

import hashlib
import json

import numpy as _np
import torch

from .policy import QuantizationError
from ..context import Context, current_context
from ..ndarray import NDArray
from ..observability import events as _obs_events
from ..observability import metrics as _obs_metrics

__all__ = ["CalibTable", "calibrate", "tensor_name"]

_CALIB_BATCHES_TOTAL = _obs_metrics.counter(
    "quant_calibration_batches_total",
    "calibration batches run through the instrumented forward")


def tensor_name(node, out_idx=0):
    """Canonical calibration key of a graph entry: the producing node's
    name, ``name:k`` for secondary outputs."""
    return node.name if out_idx == 0 else "%s:%d" % (node.name, out_idx)


def _percentile_abs(v, q):
    """The *q*-th percentile of |v| with linear interpolation (numpy's
    default, as ``jnp.percentile``), by two order statistics: no sort of
    the whole tensor and no element limit (``torch.quantile`` refuses
    more than 2**24)."""
    flat = v.detach().abs().to(torch.float32).reshape(-1)
    n = flat.numel()
    pos = q / 100.0 * (n - 1)
    lo = int(_np.floor(pos))
    hi = min(lo + 1, n - 1)
    a = torch.kthvalue(flat, lo + 1).values
    b = a if hi == lo else torch.kthvalue(flat, hi + 1).values
    m = a + (b - a) * float(pos - lo)
    return -m, m


def _build_collect(symbol, data_names, percentile=None):
    """fn(arg_map, aux_map, generator) -> {tensor name: (min, max) 0-d
    tensors}: the eval walk with a range reduction after each op, each
    value released after its last consumer."""
    order = symbol._topo()
    data_names = frozenset(data_names)
    last_use = {}
    for pos, node in enumerate(order):
        for src, i in node.inputs:
            last_use[(id(src), i)] = pos
    release = {}
    for key, pos in last_use.items():
        release.setdefault(pos, []).append(key)

    def stat(v):
        if percentile is None:
            lo, hi = torch.aminmax(v.detach())
            return lo.to(torch.float32), hi.to(torch.float32)
        return _percentile_abs(v, percentile)

    def fn(arg_map, aux_map, generator):
        vals = {}
        stats = {}
        for pos, node in enumerate(order):
            if node.is_var:
                v = arg_map[node.name] if node.name in arg_map \
                    else aux_map[node.name]
                vals[(id(node), 0)] = v
                if node.name in data_names and v.is_floating_point():
                    stats[node.name] = stat(v)
                continue
            op = node.op
            ins = [vals[(id(s), i)] for (s, i) in node.inputs]
            params = node.params
            if "training" in op.param_names:
                params = dict(params, training=False)
            if op.needs_rng:
                out = op.fn(generator, *ins, **params)
            else:
                out = op.fn(*ins, **params)
            if not isinstance(out, tuple):
                out = (out,)
            for i, o in enumerate(out):
                vals[(id(node), i)] = o
                if isinstance(o, torch.Tensor) and o.is_floating_point() \
                        and o.numel():
                    stats[tensor_name(node, i)] = stat(o)
            for key in release.get(pos, ()):
                vals.pop(key, None)
        return stats

    return fn


class CalibTable(object):
    """Per-tensor calibrated ranges with a sha256 identity.

    ``ranges`` maps tensor name -> (min, max) floats.  The sha covers the
    canonical JSON payload (ranges + mode + percentile), so two tables
    with identical ranges share an identity and a corrupted file can
    never load silently.
    """

    VERSION = 1

    def __init__(self, ranges, mode="minmax", percentile=None, batches=0):
        self.ranges = {str(n): (float(lo), float(hi))
                       for n, (lo, hi) in ranges.items()}
        self.mode = str(mode)
        self.percentile = None if percentile is None else float(percentile)
        self.batches = int(batches)

    # -- identity ----------------------------------------------------------
    def payload(self):
        return {"version": self.VERSION, "mode": self.mode,
                "percentile": self.percentile, "batches": self.batches,
                "ranges": {n: [lo, hi] for n, (lo, hi)
                           in sorted(self.ranges.items())}}

    @property
    def sha(self):
        blob = json.dumps(self.payload(), sort_keys=True,
                          separators=(",", ":")).encode()
        return hashlib.sha256(blob).hexdigest()

    # -- lookups -----------------------------------------------------------
    def covers(self, name):
        return name in self.ranges

    def range(self, name):
        return self.ranges.get(name)

    def max_abs(self, name):
        """Symmetric magnitude M of a tensor's range (real = q * M / 127),
        floored away from zero so a dead tensor cannot divide by 0."""
        lo, hi = self.ranges[name]
        return max(abs(lo), abs(hi)) or 1e-8

    def __len__(self):
        return len(self.ranges)

    # -- persistence (atomic, sha-verified) --------------------------------
    def save(self, path):
        from ..resilience.checkpoint import atomic_write
        blob = json.dumps({"calib_table": self.payload(), "sha": self.sha},
                          sort_keys=True, indent=1).encode()
        atomic_write(path, blob)
        return self.sha

    @classmethod
    def load(cls, path):
        try:
            with open(path, "rb") as f:
                doc = json.loads(f.read().decode())
            payload = doc["calib_table"]
            table = cls(
                {n: tuple(v) for n, v in payload["ranges"].items()},
                mode=payload["mode"],
                percentile=payload.get("percentile"),
                batches=payload.get("batches", 0))
            stored = doc["sha"]
        except QuantizationError:
            raise
        except Exception as exc:
            raise QuantizationError(
                "calibration table %r is unreadable: %s: %s"
                % (path, type(exc).__name__, exc))
        if table.sha != stored:
            raise QuantizationError(
                "calibration table %r failed its sha check "
                "(stored %s != computed %s) — refusing to quantize "
                "against corrupted ranges"
                % (path, stored[:12], table.sha[:12]))
        return table


def _to_device(v, dev):
    """An NDArray / tensor / array-like as a tensor on *dev* (float64
    host data as float32, as the reference stores it)."""
    if isinstance(v, NDArray):
        v = v._data
    if not isinstance(v, torch.Tensor):
        a = _np.asarray(v)
        if a.dtype == _np.float64:
            a = a.astype(_np.float32)
        v = torch.from_numpy(_np.ascontiguousarray(a))
    return v.to(dev)


def calibrate(symbol, arg_params, batches, aux_params=None, mode="minmax",
              percentile=99.99, data_names=None, name="model", ctx=None):
    """Run the instrumented forward over *batches* and return a
    :class:`CalibTable` covering every floating intermediate tensor.

    symbol : the fp32 inference graph.
    arg_params : {name: array} — the parameters the symbol's arguments
        need beyond the data inputs.
    batches : iterable of dicts ``{input name: array}``, or bare arrays
        for single-input models.
    mode : "minmax" (global min/max over all batches) or "percentile"
        (the per-batch *percentile* of |x|, aggregated by max).
    ctx : the device the forward runs on (default: the current context,
        ``gpu(0)``, which raises without CUDA).
    """
    if mode not in ("minmax", "percentile"):
        raise QuantizationError(
            "calibration mode must be 'minmax' or 'percentile', got %r"
            % (mode,))
    pct = float(percentile) if mode == "percentile" else None
    dev = (Context(ctx) if ctx is not None else current_context()
           ).torch_device
    params = {n: _to_device(v, dev) for n, v in (arg_params or {}).items()}
    aux = {n: _to_device(v, dev) for n, v in (aux_params or {}).items()}
    if data_names is None:
        data_names = [n for n in symbol.list_arguments() if n not in params]
    data_names = list(data_names)
    collect = _build_collect(symbol, data_names, percentile=pct)
    generator = torch.Generator(device=dev)
    generator.manual_seed(0)

    agg = {}
    n_batches = 0
    for batch in batches:
        if not isinstance(batch, dict):
            if len(data_names) != 1:
                raise QuantizationError(
                    "calibration batches must be dicts for a model with "
                    "%d data inputs %s" % (len(data_names),
                                           sorted(data_names)))
            batch = {data_names[0]: batch}
        feeds = {}
        for dn in data_names:
            if dn not in batch:
                raise QuantizationError(
                    "calibration batch is missing input %r" % dn)
            feeds[dn] = _to_device(batch[dn], dev)
        with torch.no_grad():
            stats = collect(dict(params, **feeds), aux, generator)
        for tname, (lo, hi) in stats.items():
            cur = agg.get(tname)
            agg[tname] = (lo, hi) if cur is None else \
                (torch.minimum(cur[0], lo), torch.maximum(cur[1], hi))
        n_batches += 1
        _CALIB_BATCHES_TOTAL.inc()
    if not n_batches:
        raise QuantizationError(
            "calibration needs at least one batch (model %r)" % name)
    names = sorted(agg)
    host = torch.stack([torch.stack(agg[n]) for n in names]).cpu().numpy()
    table = CalibTable({n: (float(lo), float(hi))
                        for n, (lo, hi) in zip(names, host)},
                       mode=mode, percentile=pct, batches=n_batches)
    _obs_events.emit("quantize", kind="calibrate", model=name, mode=mode,
                     batches=n_batches, tensors=len(table),
                     sha=table.sha[:12])
    return table
