"""Structured run-event log — ``events.jsonl`` (port of
``mxnet_tpu/observability/events.py``, without the jit compile watcher).

One JSON object per line::

    {"ts": 1722700000.123, "ev": "serve", "pid": 4242, "seq": 17, ...}

**Off by default, zero per-event cost when off.**  The ``MXNET_OBS`` env
knob: unset/``0``/``off`` disables everything (``emit`` is one env check
and returns); ``all``/``1``/``on`` records every category; a comma list
(``MXNET_OBS=serve,chaos``) records only those.  The writer is created
lazily on the first recorded event.

The ``serve`` category carries the serving control trail as ``kind``
fields, with the JAX package's names: ``load`` / ``load_failed`` /
``unload`` / ``alias`` / ``unalias`` / ``compile`` (one per rung's
program: a CUDA graph capture on the card) / ``shed`` / ``expired`` /
``cancelled`` / ``dispatcher_restart`` / ``unhealthy`` / ``drain`` /
``drain_complete`` / ``cutover_flush`` / ``resume`` / ``health``.  The
``fleet`` category carries the fleet's trail (replica start, load, drain,
cancel and exit; the router's admit, failover, hedge, eject and rejoin;
the fleet's spawn, reap and deploy steps).  ``_CATEGORIES`` lists the
categories the package emits; a caller may emit any other.

Each line is ONE ``os.write`` on an ``O_APPEND`` fd, so concurrent
threads and processes never interleave bytes mid-line; the directory is
fsynced once when the file is created.  Rate cap: at most
``MXNET_OBS_RATE`` events per second (0 = uncapped); the next admitted
event carries ``"dropped": N``.
"""

from __future__ import annotations

import json
import os
import time

from .. import sanitizer as _san
from . import metrics as _metrics

__all__ = ["enabled", "emit", "configure", "path", "read_events",
           "tail_records"]

_CATEGORIES = ("guard", "chaos", "retry", "respawn", "serve", "decode",
               "fleet", "autotune", "quantize")

def _spec():
    raw = os.environ.get("MXNET_OBS", "").strip().lower()
    if not raw or raw in ("0", "off", "none", "false"):
        return None
    if raw in ("1", "on", "all", "true"):
        return "all"
    return frozenset(p.strip() for p in raw.split(",") if p.strip())


def enabled(category=None):
    """Is event recording on (for *category*, or at all)?  Read from
    the environment each call, like ``sanitizer.enabled`` — tests and
    the pytest harness monkeypatch ``MXNET_OBS`` freely."""
    spec = _spec()
    if spec is None:
        return False
    if spec == "all" or category is None:
        return True
    return category in spec


class _Writer:
    """Appending JSONL writer: O_APPEND single-write lines, creation
    fsync, token-bucket rate cap, monotonically increasing ``seq``."""

    def __init__(self, path, rate):
        self._path = path
        self._rate = rate
        self._fd = None
        self._lock = _san.lock(label="obs.events.writer")
        self._seq = 0
        self._dropped = 0
        self._window_start = 0.0
        self._window_count = 0

    def _open(self):
        # only reached from write() with self._lock held
        dirname = os.path.dirname(os.path.abspath(self._path))
        created = not os.path.exists(self._path)
        self._fd = os.open(
            self._path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
        if created:
            _fsync_dir(dirname)
        else:
            # resuming an existing log (another process, or an earlier
            # run): continue from the last recorded seq so the combined
            # file stays monotone — each line's pid still tells the
            # writers apart
            self._seq = max(
                self._seq, _last_seq(self._path))

    def write(self, category, fields):
        now = time.time()
        # the rate window runs on the monotonic clock: an NTP step
        # backward must not freeze a saturated window (only the ts
        # FIELD wants wall time)
        mono = time.monotonic()
        with self._lock:
            if self._rate > 0:
                if mono - self._window_start >= 1.0:
                    self._window_start = mono
                    self._window_count = 0
                if self._window_count >= self._rate:
                    self._dropped += 1
                    _metrics.counter(
                        "obs_events_dropped_total",
                        "events over the MXNET_OBS_RATE cap").inc()
                    return False
                self._window_count += 1
            if self._fd is None:
                self._open()
            self._seq += 1
            rec = {"ts": round(now, 6), "ev": category,
                   "pid": os.getpid(), "seq": self._seq}
            if self._dropped:
                rec["dropped"] = self._dropped
                self._dropped = 0
            rec.update(fields)
            line = json.dumps(rec, default=_json_fallback,
                              separators=(",", ":")) + "\n"
            os.write(self._fd, line.encode("utf-8"))
        _metrics.counter("obs_events_total",
                         "structured run events written").inc()
        return True

    def close(self):
        with self._lock:
            if self._fd is not None:
                os.close(self._fd)
                self._fd = None


def _fsync_dir(dirname):
    """Best-effort fsync of a directory so a new file's entry survives
    power loss."""
    try:
        fd = os.open(dirname or ".", os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def tail_records(path, max_bytes=1 << 16):
    """Parsed JSON records from the last *max_bytes* of an events
    file, oldest first.  The first line of a mid-file seek is usually
    torn — unparseable lines are skipped, an unreadable file yields
    [].  The writer's seq handoff reads it."""
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            f.seek(max(0, size - max_bytes))
            lines = f.read().decode("utf-8", "replace").splitlines()
    except OSError:
        return []
    out = []
    for line in lines:
        line = line.strip()
        if not line:
            continue
        try:
            out.append(json.loads(line))
        except ValueError:
            continue
    return out


def _last_seq(path):
    """The last record's ``seq`` in an existing events file; 0 when
    unreadable or seq-less."""
    for rec in reversed(tail_records(path)):
        seq = rec.get("seq") if isinstance(rec, dict) else None
        if isinstance(seq, int):
            return seq
    return 0


def _json_fallback(obj):
    """Events must never fail to serialize — degrade to repr."""
    try:
        return repr(obj)[:200]
    except Exception:
        return "<unrepresentable>"


_writer = None
_writer_lock = _san.lock(label="obs.events.singleton")


def path():
    """The configured event-log path (the file may not exist yet)."""
    if _writer is not None:
        return _writer._path
    from ..config import get_env
    return get_env("MXNET_OBS_PATH")


def _get_writer():
    global _writer
    if _writer is None:
        with _writer_lock:
            if _writer is None:
                from ..config import get_env
                _writer = _Writer(path(),
                                  int(get_env("MXNET_OBS_RATE")))
    return _writer


def configure(path=None, rate=None):
    """Rebind the writer (tests; call before the first emit of the new
    run segment).  ``configure()`` with no args closes and resets so
    the next emit re-reads the environment."""
    global _writer
    with _writer_lock:
        if _writer is not None:
            _writer.close()
        _writer = None
        if path is not None:
            os.environ["MXNET_OBS_PATH"] = path
        if rate is not None:
            os.environ["MXNET_OBS_RATE"] = str(rate)


def emit(category, **fields):
    """Record one event if *category* is enabled.  Returns True when a
    line was written (False: disabled or rate-capped).  Never raises
    on IO problems — telemetry must not take down training — but does
    count failures."""
    if not enabled(category):
        return False
    try:
        return _get_writer().write(category, fields)
    except Exception:
        _metrics.counter("obs_events_errors_total",
                         "event-log write failures").inc()
        return False


def read_events(p=None):
    """Parse an events.jsonl file back into dicts (tests, post-mortem
    tooling).  Raises on malformed lines — a torn log is a bug."""
    out = []
    with open(p or path(), encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out
