"""Metrics registry — thread-safe counters, gauges and histograms (port
of ``mxnet_tpu/observability/metrics.py``).

One process-wide :class:`MetricsRegistry` (module-level ``REGISTRY``)
that every subsystem of the port records into and that two consumers
read: ``snapshot()`` (a JSON-able dict) and ``exposition()``
(Prometheus text format, names prefixed ``mxnet_``).  The instrument
names are the JAX package's, so one scraper reads either package.

Instruments are always on.  Hot paths keep a module-level reference to
their instrument (one uncontended lock per update, no registry lookup);
the registry lookup is lock-free on the hit path and only locks to
create.  Locks come from the :mod:`..sanitizer` factories.
"""

from __future__ import annotations

import bisect

from .. import sanitizer as _san

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "REGISTRY", "counter", "gauge", "histogram", "snapshot",
           "exposition", "reset"]

# latency-style default buckets (seconds): sub-ms dispatch overheads
# through minute-scale checkpoint writes
DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                   0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


class Counter:
    """Monotonically increasing count."""

    kind = "counter"
    __slots__ = ("name", "help", "_value", "_lock")

    def __init__(self, name, help=""):
        self.name = name
        self.help = help
        self._value = 0
        self._lock = _san.lock(label="metrics.%s" % name)

    def inc(self, n=1):
        if n < 0:
            raise ValueError("counter %s cannot decrease (inc %r)"
                             % (self.name, n))
        with self._lock:
            self._value += n

    @property
    def value(self):
        with self._lock:
            return self._value

    def _reset(self):
        with self._lock:
            self._value = 0

    def _snap(self):
        return {"kind": "counter", "value": self.value}


class Gauge:
    """Point-in-time value (queue depth, in-flight batches, ...)."""

    kind = "gauge"
    __slots__ = ("name", "help", "_value", "_lock")

    def __init__(self, name, help=""):
        self.name = name
        self.help = help
        self._value = 0
        self._lock = _san.lock(label="metrics.%s" % name)

    def set(self, v):
        with self._lock:
            self._value = v

    def inc(self, n=1):
        with self._lock:
            self._value += n

    def dec(self, n=1):
        with self._lock:
            self._value -= n

    @property
    def value(self):
        with self._lock:
            return self._value

    def _reset(self):
        with self._lock:
            self._value = 0

    def _snap(self):
        return {"kind": "gauge", "value": self.value}


class Histogram:
    """Cumulative-bucket histogram (Prometheus semantics: ``le``
    upper bounds plus ``+Inf``, with running count and sum)."""

    kind = "histogram"
    __slots__ = ("name", "help", "buckets", "_counts", "_sum",
                 "_count", "_lock")

    def __init__(self, name, help="", buckets=DEFAULT_BUCKETS):
        self.name = name
        self.help = help
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError("histogram %s needs at least one bucket"
                             % name)
        self._counts = [0] * (len(self.buckets) + 1)   # last = +Inf
        self._sum = 0.0
        self._count = 0
        self._lock = _san.lock(label="metrics.%s" % name)

    def observe(self, v):
        v = float(v)
        idx = bisect.bisect_left(self.buckets, v)
        with self._lock:
            self._counts[idx] += 1
            self._sum += v
            self._count += 1

    def _reset(self):
        with self._lock:
            self._counts = [0] * (len(self.buckets) + 1)
            self._sum = 0.0
            self._count = 0

    def _snap(self):
        with self._lock:
            counts = list(self._counts)
            total, s = self._count, self._sum
        cum, out = 0, {}
        for b, c in zip(self.buckets, counts):
            cum += c
            out["%g" % b] = cum
        out["+Inf"] = total
        return {"kind": "histogram", "count": total, "sum": s,
                "buckets": out}


class MetricsRegistry:
    """Get-or-create instrument store.

    The hit path reads the instrument dict WITHOUT the registry lock
    (atomic under the GIL and under free-threading's per-dict locking);
    only creation locks.  Re-requesting a name with a different
    instrument kind is an error — two subsystems silently sharing a
    name would corrupt both series.
    """

    def __init__(self):
        self._instruments = {}
        self._lock = _san.lock(label="metrics.registry")

    def _get_or_create(self, cls, name, help, **kwargs):
        inst = self._instruments.get(name)
        if inst is None:
            with self._lock:
                inst = self._instruments.get(name)
                if inst is None:
                    inst = cls(name, help=help, **kwargs)
                    self._instruments[name] = inst
        if not isinstance(inst, cls):
            raise TypeError(
                "instrument %r already registered as %s, requested %s"
                % (name, inst.kind, cls.kind))
        return inst

    def counter(self, name, help=""):
        return self._get_or_create(Counter, name, help)

    def gauge(self, name, help=""):
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name, help="", buckets=DEFAULT_BUCKETS):
        return self._get_or_create(Histogram, name, help,
                                   buckets=buckets)

    def get(self, name):
        return self._instruments.get(name)

    def snapshot(self, kind=None):
        """{name: instrument snapshot} — a consistent-per-instrument
        JSON-able view (cross-instrument consistency is not promised;
        each instrument locks individually)."""
        out = {}
        for name in sorted(self._instruments):
            inst = self._instruments[name]
            if kind is None or inst.kind == kind:
                out[name] = inst._snap()
        return out

    def reset(self):
        """Zero every instrument (instruments stay registered)."""
        for inst in list(self._instruments.values()):
            inst._reset()

    # -- Prometheus text exposition -----------------------------------
    @staticmethod
    def _prom_name(name):
        safe = "".join(c if (c.isalnum() or c == "_") else "_"
                       for c in name)
        if not safe or not (safe[0].isalpha() or safe[0] == "_"):
            safe = "_" + safe
        return "mxnet_" + safe

    @staticmethod
    def _prom_val(v):
        if isinstance(v, float):
            return repr(v)
        return str(v)

    def exposition(self):
        """Prometheus text format, instruments sorted by name."""
        lines = []
        for name in sorted(self._instruments):
            inst = self._instruments[name]
            pn = self._prom_name(name)
            if inst.help:
                lines.append("# HELP %s %s"
                             % (pn, inst.help.replace("\n", " ")))
            lines.append("# TYPE %s %s" % (pn, inst.kind))
            if inst.kind == "histogram":
                snap = inst._snap()
                for le, c in snap["buckets"].items():
                    lines.append('%s_bucket{le="%s"} %d' % (pn, le, c))
                lines.append("%s_sum %s"
                             % (pn, self._prom_val(snap["sum"])))
                lines.append("%s_count %d" % (pn, snap["count"]))
            else:
                lines.append("%s %s"
                             % (pn, self._prom_val(inst.value)))
        return "\n".join(lines) + "\n"


#: the process-wide registry every subsystem records into
REGISTRY = MetricsRegistry()


def counter(name, help=""):
    return REGISTRY.counter(name, help)


def gauge(name, help=""):
    return REGISTRY.gauge(name, help)


def histogram(name, help="", buckets=DEFAULT_BUCKETS):
    return REGISTRY.histogram(name, help, buckets)


def snapshot(kind=None):
    return REGISTRY.snapshot(kind)


def exposition():
    return REGISTRY.exposition()


def reset():
    REGISTRY.reset()
