"""Deterministic fault injection for the serving request path (port of
``mxnet_tpu/resilience/servechaos.py``, subset: the batcher, predictor
and decode choke points).

The injection points are consulted by the production serving code — the
:class:`~mxnet_tpu_torch.serve.batcher.DynamicBatcher` dispatcher right
before it runs a coalesced batch,
:meth:`~mxnet_tpu_torch.serve.predictor.CompiledPredictor.ensure_program`
before it builds a rung's program, and
:meth:`~mxnet_tpu_torch.serve.decode.DecodeEngine.tick` before its
dispatch — so a chaos-armed test drives the exact supervision /
shedding / drain / rebuild code a real outage exercises.
Spec keys (all integers, on the :mod:`.chaos` spec):

``dispatch_raise_at=K`` (+ optional ``dispatch_raise_for=N``)
    Raise ``RuntimeError`` on the K-th coalesced dispatch (and the
    following N-1), outside the batcher's per-batch error isolation:
    supervision must fail exactly that batch and restart the thread.
``dispatch_hang_at=K``
    The K-th dispatch wedges in an interruptible sleep loop until
    :func:`release_hangs`.
``slow_dispatch_ms=X``
    Every dispatch sleeps X milliseconds first while armed.
``reject_warm_at=K``
    The K-th program build (warm or on demand) raises a typed
    :class:`~mxnet_tpu_torch.serve.buckets.ServeError`.
``decode_tick_raise_at=K`` (+ optional ``decode_tick_raise_for=N``)
    Raise ``RuntimeError`` out of the K-th decode-engine tick (and the
    following N-1) — the crash escapes the DecodeBatcher loop, so the
    quarantine-and-rebuild path must run.

The fleet keys of the JAX module (``replica_kill_decode_at`` and the
router's partition keys) wait for the fleet: arming
``replica_kill_decode_at`` makes the decode tick raise.
"""

from __future__ import annotations

import logging
import time

from . import chaos
from .. import sanitizer as _san

__all__ = ["on_dispatch", "on_warm", "on_decode_tick", "release_hangs",
           "reset_hangs"]

log = logging.getLogger(__name__)

# a wedged dispatcher waits on this event (cleared again by reset_hangs)
_hang_release = _san.event()

# patchable seam so unit tests can bound the hang without the event
_hang_sleep = None


def release_hangs():
    """Un-wedge every dispatcher currently wedged by
    ``dispatch_hang_at`` (and any future hang until
    :func:`reset_hangs`)."""
    _hang_release.set()


def reset_hangs():
    """Re-arm the hang gate (the next ``dispatch_hang_at`` injection
    wedges again)."""
    _hang_release.clear()


def on_dispatch(name):
    """Serve dispatch choke point, consulted by the batcher's
    dispatcher thread for every coalesced batch before padding and
    dispatch, outside its per-batch error isolation.  May sleep
    (``slow_dispatch_ms``), wedge (``dispatch_hang_at``) or raise
    (``dispatch_raise_at``)."""
    if not chaos.enabled():
        return
    spec = chaos.active()
    slow = spec.get("slow_dispatch_ms")
    if slow:
        time.sleep(slow / 1000.0)
    raise_at = spec.get("dispatch_raise_at")
    hang_at = spec.get("dispatch_hang_at")
    if raise_at is None and hang_at is None:
        return
    n = chaos.tick("serve_dispatch")
    if raise_at is not None and \
            raise_at <= n < raise_at + spec.get("dispatch_raise_for", 1):
        chaos.note_injection("dispatch_raise_at", at=n, batcher=name)
        log.warning("servechaos: raising on dispatch %d of batcher %r",
                    n, name)
        raise RuntimeError(
            "servechaos: injected dispatch failure (batch %d, "
            "batcher %r)" % (n, name))
    if hang_at is not None and n == hang_at:
        chaos.note_injection("dispatch_hang_at", at=n, batcher=name)
        log.warning("servechaos: hanging dispatcher of batcher %r at "
                    "dispatch %d", name, n)
        sleep = _hang_sleep or (lambda s: _hang_release.wait(s))
        while not _hang_release.is_set():
            sleep(0.02)


def on_warm(model):
    """Program-build choke point (``CompiledPredictor.ensure_program``):
    ``reject_warm_at=K`` fails the K-th build with a typed ServeError."""
    if not chaos.enabled():
        return
    k = chaos.active().get("reject_warm_at")
    if not k:
        return
    n = chaos.tick("serve_warm")
    if n == k:
        chaos.note_injection("reject_warm_at", at=n, model=model)
        log.warning("servechaos: failing program build %d of model %r",
                    n, model)
        from ..serve.buckets import ServeError
        raise ServeError(
            "servechaos: injected warm-compile failure (build %d, "
            "model %r)" % (n, model))


def on_decode_tick(name):
    """Decode tick choke point, consulted by
    :meth:`~mxnet_tpu_torch.serve.decode.DecodeEngine.tick` before the
    coalesced tick dispatch.  ``decode_tick_raise_at=K`` (+
    ``decode_tick_raise_for=N``) raises ``RuntimeError`` so the crash
    escapes the DecodeBatcher loop — the quarantine-and-rebuild path
    (fresh pool, built programs, journaled re-admission) must run."""
    if not chaos.enabled():
        return
    spec = chaos.active()
    if spec.get("replica_kill_decode_at") is not None:
        from ..base import MXNetError
        raise MXNetError("servechaos: replica_kill_decode_at is not ported "
                         "(it kills a fleet replica; the fleet is queue A "
                         "item 7)")
    raise_at = spec.get("decode_tick_raise_at")
    if raise_at is None:
        return
    n = chaos.tick("decode_tick")
    if raise_at <= n < raise_at + spec.get("decode_tick_raise_for", 1):
        chaos.note_injection("decode_tick_raise_at", at=n, engine=name)
        log.warning("servechaos: raising on decode tick %d of engine %r",
                    n, name)
        raise RuntimeError(
            "servechaos: injected decode tick failure (tick %d, engine %r)"
            % (n, name))

