"""Deterministic network fault injection for the distributed KVStore
(port of ``mxnet_tpu/resilience/netchaos.py``).

The chaos harness (:mod:`~mxnet_tpu_torch.resilience.chaos`) covers the
serving faults; this module covers the layer most likely to fail in a
fleet — the network.  The injection points are consulted by
the PRODUCTION socket choke points in ``_kvstore_impl``
(:func:`_rpc_call` worker-side, the server's reply path and PUSH
handler), so a chaos-enabled drill drives the exact retry / dedup /
snapshot-restore / eviction code a real outage exercises.

Everything rides the same counter-based ``MXNET_CHAOS`` spec (or
programmatic ``chaos.configure``): each injection is an integer budget
consumed in call order, so a drill armed with ``net_drop_reply=2``
fires on exactly the first two eligible replies and never again.  No
randomness; the only sleeps are the injected delays themselves.

Spec keys (all integers):

``net_partition=N``
    Worker: the next N bulk RPC sends raise ``ConnectionError``
    before any bytes move (transient partition); the transport's
    retry path reconnects and resends the same request id.
``net_delay_request=N`` / ``net_delay_ms=X``
    Worker: delay the next N sends by X milliseconds (default 200).
``net_dup_request=N``
    Worker: send the next N bulk requests TWICE back-to-back with the
    same ``(rank, seq)`` id — the server's dedup window must apply
    the mutation exactly once and answer the duplicate from cache.
``net_torn_request=N``
    Worker: send only half the frame, then close the socket (the
    server sees EOF mid-frame); the retry path reconnects.
``net_drop_reply=N``
    Server: compute the reply — the state mutation has already
    happened — then drop it.  The worker's RPC timeout fires and the
    retried request id must dedup, not double-apply.
``net_delay_reply=N`` / ``net_delay_ms=X``
    Server: delay the next N replies by X milliseconds.  A delay
    longer than the worker's ``MXNET_KVSTORE_RPC_TIMEOUT`` forces the
    full timeout → reconnect → retry → dedup path.
``net_torn_reply=N``
    Server: send half the reply, then close the connection.
``net_kill_server_at=K``
    Server: hard-exit the process (``os._exit(137)``, no cleanup —
    like SIGKILL) on the K-th PUSH received, BEFORE applying it.  The
    restarted server must restore its state snapshot and the workers'
    retried pushes must apply exactly once against the committed
    lineage.

``tests/test_torch_kvstore.py`` drives the drop-reply drill end to end
through the store.
"""

from __future__ import annotations

import logging
import os
import time

from . import chaos

__all__ = ["on_worker_send", "on_server_reply", "on_server_push",
           "DEFAULT_DELAY_MS"]

log = logging.getLogger(__name__)

DEFAULT_DELAY_MS = 200

# patchable seam: os._exit is untestable in-process, and the kill
# injection must stay unit-testable
_exit = os._exit


def _delay_seconds():
    return chaos.active().get("net_delay_ms", DEFAULT_DELAY_MS) / 1000.0


def on_worker_send(kind):
    """Worker-side fault point, consulted before a bulk RPC's bytes
    move.  May raise ``ConnectionError`` (partition) or sleep
    (delay); returns directives the transport applies itself:
    ``{'torn': bool, 'dup': bool}`` (empty dict when idle)."""
    if not chaos.enabled():
        return {}
    if chaos.consume("net_partition"):
        log.warning("netchaos: injected partition on RPC kind %d", kind)
        raise ConnectionError("netchaos: injected network partition")
    if chaos.consume("net_delay_request"):
        time.sleep(_delay_seconds())
    out = {}
    if chaos.consume("net_torn_request"):
        log.warning("netchaos: tearing request frame (kind %d)", kind)
        out["torn"] = True
    if chaos.consume("net_dup_request"):
        log.warning("netchaos: duplicating request (kind %d)", kind)
        out["dup"] = True
    return out


def on_server_reply(kind):
    """Server-side fault point for a computed reply: returns
    ``'drop'``, ``'torn'``, or ``None`` (after an optional injected
    delay).  The state mutation already happened — these faults
    target the reply path, which is exactly where exactly-once
    semantics get hard."""
    if not chaos.enabled():
        return None
    if chaos.consume("net_drop_reply"):
        log.warning("netchaos: dropping reply to RPC kind %d", kind)
        return "drop"
    if chaos.consume("net_delay_reply"):
        time.sleep(_delay_seconds())
    if chaos.consume("net_torn_reply"):
        log.warning("netchaos: tearing reply to RPC kind %d", kind)
        return "torn"
    return None


def on_server_push():
    """Hard-kill switch consulted by the server's PUSH handler before
    the push is registered or applied: ``net_kill_server_at=K`` exits
    the process on the K-th PUSH received.  No cleanup runs (same as
    SIGKILL), so recovery is entirely the restarted server's snapshot
    restore plus the workers' request-id retries."""
    if not chaos.enabled():
        return
    k = chaos.active().get("net_kill_server_at")
    if not k:
        return
    n = chaos.tick("netchaos_push")
    if n == k:
        log.warning("netchaos: hard-killing server process at push %d", n)
        chaos.note_injection("net_kill_server_at", fire=1, budget=1)
        _exit(137)
