"""Telemetry (port of ``mxnet_tpu/observability``, subset):

* :mod:`.metrics` — the always-on, thread-safe instrument registry
  (counters / gauges / histograms) with JSON snapshots and
  Prometheus-style text exposition;
* :mod:`.events` — the opt-in structured run-event log
  (``events.jsonl``; ``MXNET_OBS``).

The JAX package's ``costs`` (StableHLO cost attribution) is not ported.
This package depends only on the stdlib, ``..sanitizer`` and
``..config``.
"""

from __future__ import annotations

from . import metrics
from . import events

__all__ = ["metrics", "events"]
