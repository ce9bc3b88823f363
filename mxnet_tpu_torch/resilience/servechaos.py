"""Deterministic fault injection for the serving request path (port of
``mxnet_tpu/resilience/servechaos.py``).

The injection points are consulted by the production serving code — the
:class:`~mxnet_tpu_torch.serve.batcher.DynamicBatcher` dispatcher right
before it runs a coalesced batch,
:meth:`~mxnet_tpu_torch.serve.predictor.CompiledPredictor.ensure_program`
before it builds a rung's program, and
:meth:`~mxnet_tpu_torch.serve.decode.DecodeEngine.tick` before its
dispatch — so a chaos-armed test drives the exact supervision /
shedding / drain / rebuild code a real outage exercises.  The fleet's
points are consulted by :class:`~mxnet_tpu_torch.serve.replica.
ReplicaServer` connection handlers (arm them through a replica process's
own ``MXNET_CHAOS`` env) and by :class:`~mxnet_tpu_torch.serve.router.
Router` right before a frame goes out on a replica socket (arm them with
``chaos.configure`` in the router's process).
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
``replica_kill_at=K``
    The replica process hard-exits (``os._exit(137)``, the patchable
    ``_exit`` seam) on receiving its K-th PREDICT request — before
    dispatch, so the router sees the connection die mid-request and must
    fail the request over to another replica.
``replica_kill_decode_at=K``
    The same hard exit, counting DECODE_OPEN / DECODE_NEXT requests: the
    replica dies mid-stream, so the router must re-open every live
    decode session on a healthy replica from its journal and resume it
    bit-equal.
``slow_replica_ms=X`` (+ optional ``slow_replica_for=N``)
    Every PREDICT (or the first N) sleeps X milliseconds before
    dispatch — the straggling replica that hedging and the breaker are
    for.
``fleet_partition_at=K`` (+ optional ``fleet_partition_for=N``,
``fleet_partition_port=P``)
    The K-th (through K+N-1-th) router->replica send raises
    ``ConnectionError`` without touching the wire — a router<->replica
    partition; with ``fleet_partition_port=P`` only sends to the replica
    on port P count (and are cut).
"""

from __future__ import annotations

import logging
import os
import time

from . import chaos
from .. import sanitizer as _san

__all__ = ["on_dispatch", "on_warm", "on_replica_request",
           "on_replica_decode", "on_decode_tick", "on_router_send",
           "release_hangs", "reset_hangs"]

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


# patchable seam so unit tests can assert the kill without dying
_exit = os._exit


def on_replica_request(replica):
    """Replica-side fleet choke point, consulted by the replica's
    connection handler for every PREDICT request before it reaches the
    registry.  ``replica_kill_at=K`` hard-exits the process on the K-th
    request (the router must fail over mid-request);
    ``slow_replica_ms`` makes this replica a straggler."""
    if not chaos.enabled():
        return
    spec = chaos.active()
    kill_at = spec.get("replica_kill_at")
    slow = spec.get("slow_replica_ms")
    if kill_at is None and slow is None:
        return
    n = chaos.tick("replica_predict")
    if slow and n <= spec.get("slow_replica_for", 1 << 62):
        chaos.note_injection("slow_replica_ms", at=n, replica=replica)
        time.sleep(slow / 1000.0)
    if kill_at is not None and n == kill_at:
        chaos.note_injection("replica_kill_at", at=n, replica=replica)
        log.warning("servechaos: hard-killing replica %r at predict %d",
                    replica, n)
        _exit(137)


def on_replica_decode(replica):
    """Replica-side decode choke point, consulted for every DECODE_OPEN /
    DECODE_NEXT request before it reaches the decode batcher.
    ``replica_kill_decode_at=K`` hard-exits the process on the K-th
    decode request — the router must re-open this replica's live
    sessions elsewhere from their journals and resume them bit-equal."""
    if not chaos.enabled():
        return
    kill_at = chaos.active().get("replica_kill_decode_at")
    if kill_at is None:
        return
    n = chaos.tick("replica_decode")
    if n == kill_at:
        chaos.note_injection("replica_kill_decode_at", at=n,
                             replica=replica)
        log.warning("servechaos: hard-killing replica %r at decode "
                    "request %d", replica, n)
        _exit(137)


def on_router_send(replica, port=None):
    """Router-side fleet choke point, consulted right before a frame goes
    out on a replica socket.  ``fleet_partition_at=K`` (+
    ``fleet_partition_for=N``) raises ``ConnectionError`` without
    touching the wire, so the router's failover/breaker path runs as it
    would on a real partition; ``fleet_partition_port=P`` restricts the
    cut (and its tick counter) to the replica on port P."""
    if not chaos.enabled():
        return
    spec = chaos.active()
    at = spec.get("fleet_partition_at")
    if at is None:
        return
    pfilter = spec.get("fleet_partition_port")
    if pfilter and port != pfilter:
        return
    n = chaos.tick("fleet_send")
    if at <= n < at + spec.get("fleet_partition_for", 1):
        chaos.note_injection("fleet_partition_at", at=n, replica=replica)
        log.warning("servechaos: partitioning router<->replica %r at "
                    "send %d", replica, n)
        raise ConnectionError(
            "servechaos: injected router<->replica partition "
            "(send %d, replica %r)" % (n, replica))


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

