"""Serving health surface — per-model state machine + liveness (port of
``mxnet_tpu/serve/health.py``).

Every served model walks a small state machine the registry drives::

    loading -> warming -> ready -> draining -> (unloaded)
                  \\                   ^
                   \\                  |  (Registry.drain / unload)
                    +--> (load fails, never registered)
    ready -> unhealthy   (dispatcher crashed past its restart budget)

The :class:`HealthBoard` records the state per model, keeps one
delta-maintained gauge per state in the metrics registry (so the
Prometheus exposition carries fleet-level ``serve_models_ready`` /
``_draining`` / ``_unhealthy`` counts without labels), and emits a
``serve`` event (``kind="health"``) on every transition — the state
machine is replayable from ``events.jsonl``.

Readiness vs liveness (the k8s split):

* **ready** — the model accepts new requests: board state ``ready``
  (``Registry.ready(name)``).
* **live** — the serving process is making progress: every batcher's
  dispatcher thread is alive and its liveness tick is fresh
  (``Registry.live()``).  The dispatcher stamps the tick at least
  every ~0.5s even when idle, so a stale tick with work pending means
  a wedged dispatch, not an idle queue.

``Registry.health(name)`` assembles the full per-model view: state,
queue depth, dispatcher liveness/tick age, restart count, dirty-close
flag and traffic counters.
"""

from __future__ import annotations

from .buckets import ServeError
from .. import sanitizer as _san
from ..observability import events as _obs_events
from ..observability import metrics as _obs_metrics

__all__ = ["STATES", "HealthBoard"]

#: the model serving states, in lifecycle order
STATES = ("loading", "warming", "ready", "draining", "unhealthy")

_STATE_GAUGES = {
    s: _obs_metrics.gauge(
        "serve_models_%s" % s,
        "models currently in serving state %r across all registries "
        "(delta-maintained)" % s)
    for s in STATES
}


class HealthBoard:
    """Thread-safe per-model serving state, one per registry."""

    def __init__(self):
        self._lock = _san.lock(label="serve.health")
        self._states = {}
        _san.track(self, ("_states",), label="serve.health")

    def transition(self, model, state):
        """Move *model* to *state* (a member of :data:`STATES`),
        updating the per-state gauges and emitting the ``health``
        event.  Returns the previous state (None for a new model)."""
        if state not in STATES:
            raise ServeError("unknown serving state %r (have %s)"
                             % (state, list(STATES)))
        with self._lock:
            prev = self._states.get(model)
            if prev == state:
                return prev
            self._states[model] = state
            if prev is not None:
                _STATE_GAUGES[prev].dec()
            _STATE_GAUGES[state].inc()
        _obs_events.emit("serve", kind="health", model=model,
                         state=state, prev=prev)
        return prev

    def drop(self, model):
        """Forget *model* (unloaded, or its load failed)."""
        with self._lock:
            prev = self._states.pop(model, None)
            if prev is not None:
                _STATE_GAUGES[prev].dec()
        return prev

    def state(self, model):
        with self._lock:
            return self._states.get(model)

    def snapshot(self):
        with self._lock:
            return dict(self._states)
