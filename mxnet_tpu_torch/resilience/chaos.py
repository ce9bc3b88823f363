"""Deterministic fault-injection harness (port of
``mxnet_tpu/resilience/chaos.py``, subset: the spec, the tick counters
and the injection accounting that the serve choke points of
:mod:`.servechaos` and the kvstore choke points of :mod:`.netchaos`
read).

Activation: programmatic :func:`configure` wins; otherwise the
``MXNET_CHAOS`` env knob supplies a spec string such as
``"dispatch_raise_at=1,slow_dispatch_ms=400"`` (bare ``on``/``1``
enables the harness with no injections armed).  Everything is
counter-based and deterministic.  The process, checkpoint and training
injection points of the JAX module are not ported.
"""

from __future__ import annotations

import logging

from .. import sanitizer as _san

__all__ = ["configure", "reset", "active", "enabled", "tick", "counter",
           "consume", "fired", "note_injection"]

log = logging.getLogger(__name__)

_lock = _san.lock(label="chaos._lock")
_spec = None        # programmatic spec (dict) — None = env-driven
_used = {}          # injection key -> how many times it already fired
_ticks = {}         # named event counters


def _parse_spec(raw):
    spec = {}
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        key, _, val = part.partition("=")
        key = key.strip()
        if not val:
            continue
        try:
            spec[key] = int(val)
        except ValueError:
            raise ValueError(
                "MXNET_CHAOS: %r is not an integer in %r" % (val, raw))
    return spec


def _env_spec():
    from ..config import get_env
    raw = get_env("MXNET_CHAOS").strip()
    if not raw or raw.lower() in ("0", "off", "false"):
        return None
    return raw


def active():
    """The active injection spec (programmatic beats env); {} when the
    harness is idle."""
    with _lock:
        if _spec is not None:
            return dict(_spec)
    raw = _env_spec()
    if raw is None or raw.lower() in ("1", "on", "true"):
        return {}
    return _parse_spec(raw)


def enabled():
    """True when chaos is switched on at all (even with nothing armed)."""
    with _lock:
        if _spec is not None:
            return True
    return _env_spec() is not None


def configure(**spec):
    """Arm injections programmatically (resets fire/tick counters)."""
    global _spec
    with _lock:
        _spec = {k: int(v) for k, v in spec.items() if v is not None}
        _used.clear()
        _ticks.clear()


def reset():
    """Disarm everything and fall back to the env-driven spec."""
    global _spec
    with _lock:
        _spec = None
        _used.clear()
        _ticks.clear()


def tick(name):
    """Advance (and return) a named event counter."""
    with _lock:
        _ticks[name] = _ticks.get(name, 0) + 1
        return _ticks[name]


def counter(name):
    """The current value of a named event counter."""
    with _lock:
        return _ticks.get(name, 0)


def fired(key):
    """How many times injection *key* has fired."""
    with _lock:
        return _used.get(key, 0)


def consume(key):
    """True (and the fire accounted) while fires remain in *key*'s
    budget of the active spec."""
    budget = active().get(key, 0)
    with _lock:
        hit = _used.get(key, 0) + 1
        if hit > budget:
            return False
        _used[key] = hit
    _account(key, fire=hit, budget=budget)
    return True


def _account(key, **fields):
    from ..observability import events as _obs_events
    from ..observability import metrics as _metrics
    _metrics.counter("chaos_injections_total",
                     "chaos faults actually fired").inc()
    _obs_events.emit("chaos", injection=key, **fields)


def note_injection(key, **fields):
    """Account an injection that fired: bumps the fired table, the
    ``chaos_injections_total`` counter and the chaos event trail."""
    with _lock:
        _used[key] = _used.get(key, 0) + 1
    _account(key, **fields)
