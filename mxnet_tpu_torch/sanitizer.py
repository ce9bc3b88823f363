"""Sanitizer bridge (port of ``mxnet_tpu/sanitizer.py``, subset: the
primitive factories and hooks serving uses).

Production code builds its locks, conditions, events, queues and threads
through these factories, which return the plain ``threading``/``queue``
primitives (and no-op hooks) while ``MXNET_SAN`` is unset, as the JAX
package's do.  The graftsan suite that instruments them is developer
tooling of the JAX package (``tools/graftsan``, ``tools/graftsched``)
and is not ported: when ``MXNET_SAN`` asks for a component, the factory
that component instruments raises instead of sanitizing nothing.

``MXNET_SAN`` is read at call time, so objects created while it is unset
stay plain.
"""

from __future__ import annotations

import contextlib
import os
import queue as _queue
import threading as _threading

from .base import MXNetError

__all__ = ["enabled", "lock", "rlock", "condition", "event", "queue",
           "thread", "track", "sched_point", "transfer_guard"]


def enabled(component):
    """Is a sanitizer component on?  (read from env each call)"""
    raw = os.environ.get("MXNET_SAN", "").strip().lower()
    if not raw or raw in ("0", "off", "none", "false"):
        return False
    if raw in ("1", "on", "all", "true"):
        return True
    return component in {p.strip() for p in raw.split(",")}


def _refuse(*components):
    """Raise when MXNET_SAN enables one of *components*."""
    on = [c for c in components if enabled(c)]
    if on:
        raise MXNetError(
            "MXNET_SAN=%r asks for the %s sanitizer, which is not ported "
            "(queue A item 15); unset MXNET_SAN"
            % (os.environ.get("MXNET_SAN"), "/".join(on)))


def lock(label=None):
    _refuse("sched", "race")
    return _threading.Lock()


def rlock(label=None):
    _refuse("sched", "race")
    return _threading.RLock()


def condition(lock=None, label=None):
    _refuse("sched", "race")
    return _threading.Condition(lock)


def event():
    _refuse("sched")
    return _threading.Event()


def queue(maxsize=0):
    _refuse("sched", "race")
    return _queue.Queue(maxsize)


def thread(group=None, target=None, name=None, args=(), kwargs=None,
           daemon=None):
    _refuse("sched", "race")
    return _threading.Thread(group=group, target=target, name=name,
                             args=args, kwargs=kwargs or {}, daemon=daemon)


def track(obj, attrs, label=None):
    """Register *attrs* of *obj* with the race tracker: a no-op while the
    race and sched components are off."""
    _refuse("sched", "race")
    return obj


def sched_point(label=None):
    """Explicit schedule yield point: a no-op while sched is off."""
    _refuse("sched")


def transfer_guard(label="hot path"):
    """Context manager in which device-to-host syncs would raise:
    ``nullcontext`` while the transfer component is off."""
    _refuse("transfer")
    return contextlib.nullcontext()
