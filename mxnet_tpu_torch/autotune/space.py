"""Typed config spaces for the autotuner (port of
``mxnet_tpu/autotune/space.py``: pure Python, the same samples and
neighbors for the same ``random.Random`` seed).

A :class:`ConfigSpace` is an ordered dict of named parameters; a
*config* is a plain JSON-able dict ``{param name: value}`` — the same
dict the :class:`~mxnet_tpu.autotune.store.TuningStore` persists and
the serving load path consults.  Scalar knob parameters are named
after their env var (``MXNET_SERVE_MAX_WAIT_MS``) so a stored config
maps onto the config-registry precedence chain without translation;
structured parameters (the bucket-ladder rung list) use their own
names (``ladder``).

Three parameter kinds:

* :class:`Choice` — a structured choice over an explicit option list
  (ladder rung tuples, block sizes);
* :class:`IntRange` / :class:`FloatRange` — scalar ranges with
  ``linear`` or ``log`` scale; log-scaled sampling draws uniformly in
  log space (the right prior for wait windows and byte caps whose
  interesting values span decades).

Everything is driven by a caller-owned ``random.Random`` — sampling
and neighborhood proposals are deterministic under a fixed seed,
which the search relies on for reproducible tuning runs.
"""

from __future__ import annotations

import math

from ..serve.buckets import MAX_BATCH_RUNG, ServeError

__all__ = ["Choice", "IntRange", "FloatRange", "ConfigSpace",
           "serve_space", "decode_space"]


class _Param(object):
    """One named tunable: sample a value, propose a neighbor,
    validate a stored value."""

    name = None
    default = None

    def sample(self, rng):
        raise NotImplementedError

    def neighbors(self, value, rng):
        """Local proposals around *value* (possibly empty)."""
        raise NotImplementedError

    def validate(self, value):
        """Typed/canonical form of *value*; raises ValueError when a
        stored config carries something outside the space."""
        raise NotImplementedError


class Choice(_Param):
    """A structured choice over an explicit, finite option list.

    Options are canonicalized through ``canon`` (default: identity;
    the ladder space passes ``tuple``) so JSON round-trips — which
    turn tuples into lists — still validate.
    """

    def __init__(self, name, options, default=None, canon=None):
        if not options:
            raise ValueError("Choice %r needs at least one option"
                             % name)
        self.name = name
        self._canon = canon or (lambda v: v)
        self.options = [self._canon(o) for o in options]
        self.default = self._canon(default) if default is not None \
            else self.options[0]
        if self.default not in self.options:
            raise ValueError("Choice %r default %r is not an option"
                             % (name, default))

    def sample(self, rng):
        return self.options[rng.randrange(len(self.options))]

    def neighbors(self, value, rng):
        value = self.validate(value)
        idx = self.options.index(value)
        out = []
        if idx > 0:
            out.append(self.options[idx - 1])
        if idx + 1 < len(self.options):
            out.append(self.options[idx + 1])
        return out

    def validate(self, value):
        value = self._canon(value)
        if value not in self.options:
            raise ValueError("%r is not an option of %r (have %r)"
                             % (value, self.name, self.options))
        return value


class _Range(_Param):
    """Shared machinery of the scalar ranges: uniform sampling on a
    linear or log scale, neighbors = one multiplicative (log) or
    additive (linear) step either way."""

    def __init__(self, name, lo, hi, default=None, scale="linear",
                 step=None):
        if scale not in ("linear", "log"):
            raise ValueError("scale must be 'linear' or 'log', got %r"
                             % (scale,))
        if hi < lo:
            raise ValueError("%r range [%r, %r] is empty"
                             % (name, lo, hi))
        if scale == "log" and lo <= 0:
            raise ValueError("%r: a log-scaled range needs lo > 0 "
                             "(got %r)" % (name, lo))
        self.name = name
        self.lo = lo
        self.hi = hi
        self.scale = scale
        # neighbor step: log = multiply/divide by step (default 2x),
        # linear = +/- step (default a tenth of the span)
        if step is None:
            step = 2.0 if scale == "log" else (hi - lo) / 10.0 or 1.0
        self.step = step
        self.default = self._clamp(default if default is not None
                                   else lo)

    def _cast(self, value):
        raise NotImplementedError

    def _clamp(self, value):
        return self._cast(min(self.hi, max(self.lo, value)))

    def sample(self, rng):
        if self.scale == "log":
            raw = math.exp(rng.uniform(math.log(self.lo),
                                       math.log(self.hi)))
        else:
            raw = rng.uniform(self.lo, self.hi)
        return self._clamp(raw)

    def neighbors(self, value, rng):
        value = self.validate(value)
        if self.scale == "log":
            cands = (value * self.step, value / self.step)
        else:
            cands = (value + self.step, value - self.step)
        out = []
        for c in cands:
            c = self._clamp(c)
            if c != value and c not in out:
                out.append(c)
        return out

    def validate(self, value):
        value = self._cast(value)
        if not (self.lo <= value <= self.hi):
            raise ValueError("%r=%r is outside [%r, %r]"
                             % (self.name, value, self.lo, self.hi))
        return value


class IntRange(_Range):
    def _cast(self, value):
        return int(round(value))


class FloatRange(_Range):
    def _cast(self, value):
        return float(value)


class ConfigSpace(object):
    """An ordered set of parameters + the operations the search
    needs: ``default()``, ``sample(rng)``, ``neighbors(config, rng)``
    (one param perturbed per proposal) and ``validate(config)``."""

    def __init__(self, params):
        self.params = {}
        for p in params:
            if p.name in self.params:
                raise ValueError("duplicate parameter %r" % p.name)
            self.params[p.name] = p

    def default(self):
        return {n: p.default for n, p in self.params.items()}

    def sample(self, rng):
        return {n: p.sample(rng) for n, p in self.params.items()}

    def neighbors(self, config, rng, limit=None):
        """Local proposals: every single-parameter perturbation of
        *config*, shuffled (deterministically under *rng*), capped at
        *limit*."""
        config = self.validate(config)
        out = []
        for n, p in self.params.items():
            for v in p.neighbors(config[n], rng):
                cand = dict(config)
                cand[n] = v
                out.append(cand)
        rng.shuffle(out)
        return out[:limit] if limit else out

    def validate(self, config):
        unknown = set(config) - set(self.params)
        if unknown:
            raise ValueError("config carries unknown parameters %s "
                             "(space has %s)"
                             % (sorted(unknown), sorted(self.params)))
        out = {}
        for n, p in self.params.items():
            if n not in config:
                raise ValueError("config lacks parameter %r" % n)
            out[n] = p.validate(config[n])
        return out

    def key(self, config):
        """Canonical hashable identity of a config (dedup across
        proposal rounds)."""
        config = self.validate(config)
        return tuple((n, tuple(v) if isinstance(v, (list, tuple))
                      else v) for n, v in sorted(config.items()))


def _ladder_choice(options, default):
    for opt in options:
        rungs = tuple(int(r) for r in opt)
        if any(b <= a for a, b in zip(rungs, rungs[1:])) or \
                rungs[0] < 1 or rungs[-1] > MAX_BATCH_RUNG:
            raise ServeError("ladder option %r is not a valid "
                             "ascending rung list" % (opt,))
    return Choice("ladder", options, default=default,
                  canon=lambda v: tuple(int(r) for r in v))


def serve_space(max_rows=16, ladders=None, max_wait_hi_ms=8.0):
    """The serve-workload space the CLI and CI tune over.

    * ``ladder`` — structured choice of rung lists (power-of-two,
      sparse, dense and deliberately non-power-of-two options; every
      option tops out >= *max_rows* so any trace request fits),
    * ``MXNET_SERVE_MAX_WAIT_MS`` — the coalescing window, linear
      ``[0, max_wait_hi_ms]`` (0 = dispatch immediately; the
      latency/throughput trade the tuner is really deciding),
    * ``MXNET_SERVE_MAX_BATCH`` — rows per coalesced dispatch as a
      structured choice (0 = the ladder's top rung),
    * ``quantize`` — serve the model fp32, int8-weight-only or full
      int8 (mxnet_tpu.quantize).  The measurer re-calibrates per
      candidate model and carries an accuracy guard: a quantized
      candidate whose outputs drift from fp32 measures ``ok=False``
      (infeasible), so with the default-``off`` baseline guard the
      tuner can never ship an accuracy- or latency-regressing
      quantization.
    """
    if ladders is None:
        top = int(max_rows)
        ladders = [
            opt for opt in (
                (1, 2, 4, 8, 16),          # the hand-picked default
                (1, 2, 3, 4, 6, 8, 12, 16),  # dense, non-power-of-two
                (1, 3, 6, 16),             # sparse, non-power-of-two
                (1, 4, 16),                # sparse powers of four
                (2, 8, 16),                # no singleton rung
                (1, 2, 4, 8, 16, 32),      # the package default
            ) if opt[-1] >= top]
    return ConfigSpace([
        _ladder_choice(ladders, default=ladders[0]),
        FloatRange("MXNET_SERVE_MAX_WAIT_MS", 0.0, float(max_wait_hi_ms),
                   default=2.0, scale="linear",
                   step=max(0.5, float(max_wait_hi_ms) / 8.0)),
        Choice("MXNET_SERVE_MAX_BATCH", (0, 4, 8, 16), default=0,
               canon=int),
        Choice("quantize", ("off", "int8-weight-only", "int8"),
               default="off", canon=str),
    ])


def decode_space(block_sizes=(4, 8, 16, 32), rungs=None,
                 max_wait_hi_ms=8.0):
    """The decode-workload space: KV block size (structured choice —
    the pool reallocates per value, so it is not a smooth range),
    session-count tick rungs, and the idle-tick coalescing window."""
    if rungs is None:
        rungs = [(1, 2, 4, 8, 16), (1, 2, 3, 4, 6, 8, 12, 16),
                 (1, 4, 16), (1, 2, 4, 8, 16, 32)]
    return ConfigSpace([
        Choice("MXNET_SERVE_KV_BLOCK_SIZE", block_sizes,
               default=16 if 16 in block_sizes else block_sizes[0],
               canon=int),
        _ladder_choice(rungs, default=rungs[0]),
        FloatRange("MXNET_SERVE_DECODE_MAX_WAIT_MS", 0.0,
                   float(max_wait_hi_ms), default=2.0, scale="linear",
                   step=max(0.5, float(max_wait_hi_ms) / 8.0)),
    ])
