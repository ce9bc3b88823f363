"""Router — health-aware request spreading over a replica fleet (port of
``mxnet_tpu/serve/router.py``).

The router is the fleet's front door: it holds one
:class:`ReplicaHandle` per replica process, spreads predicts across
the ready ones (round-robin), and survives any one of them dying:

* **Retry-with-failover** — a transport failure (connect refused,
  connection torn mid-reply, RPC timeout, partition) retries the SAME
  ``(client, seq, incarnation)`` request id on the next eligible
  replica; the id only ever re-lands on an already-tried replica when
  no fresh one is left, where the replica's idempotency window
  answers from cache instead of re-dispatching (the kvstore's
  discipline applied to serving).  Typed replica answers — shed,
  deadline-expired, serve errors — are answers, not failures: they
  re-raise immediately and never fail over.
* **Circuit breaker per replica** — ``MXNET_SERVE_BREAKER_FAILURES``
  consecutive transport failures open the breaker (no requests
  routed); after ``MXNET_SERVE_BREAKER_COOLDOWN`` one half-open
  trial goes through — success closes, failure re-opens.
* **Heartbeat-staleness ejection** — a probe thread HEALTH-polls
  every replica (``MXNET_SERVE_FLEET_HEARTBEAT``); a replica whose
  last successful probe is staler than ``MXNET_SERVE_EJECT_TIMEOUT``
  is ejected from the rotation (breaker forced open), and the next
  successful probe rejoins it.  Probes also carry the replica's own
  health surface: draining or not-ready replicas are shed
  from routing before they ever see the request.
* **Hedging** (``MXNET_SERVE_HEDGE_MS``, off by default) — after the
  hedge delay a still-unanswered predict is re-issued to a second
  replica; the first typed answer wins and the loser is cancelled
  through the idempotency window, so a hedged request is dispatched
  at most once per replica and never double-answered.

The router-side chaos choke point (``fleet_partition_at``) sits right
before every frame goes out, so a chaos-armed test drives the exact
failover/eject/rejoin code a real partition exercises.  The router is
pure host code: it moves numpy arrays over sockets and never touches a
device.
"""

from __future__ import annotations

import logging
import os
import socket
import time as _time

import numpy as _np

from .buckets import RequestCancelled, ServeError
from .decode import DecodeJournal, _FAILOVERS_TOTAL, _RESUMED_TOTAL
from .replica import (MSG_CANCEL, MSG_DECODE_CANCEL, MSG_DECODE_CLOSE,
                      MSG_DECODE_NEXT, MSG_DECODE_OPEN, MSG_HEALTH,
                      MSG_PREDICT, MSG_REPLY, ReplicaServer,
                      error_class)
from .. import sanitizer as _san
from ..observability import events as _obs_events
from ..observability import metrics as _obs_metrics
from ..resilience import servechaos as _servechaos
from ..resilience.retry import backoff_delays

__all__ = ["CircuitBreaker", "DecodeStream", "ReplicaHandle",
           "Router"]

log = logging.getLogger(__name__)

_REPLICAS_READY = _obs_metrics.gauge(
    "fleet_replicas_ready",
    "replicas currently routable (probed ready, breaker closed, not "
    "draining/ejected) — set by the router's probe loop")
_FAILED_OVER = _obs_metrics.counter(
    "fleet_requests_failed_over_total",
    "requests retried on another replica after a transport failure "
    "(connection death, torn frame, RPC timeout, partition)")
_HEDGED = _obs_metrics.counter(
    "fleet_requests_hedged_total",
    "requests re-issued to a second replica after the hedge delay "
    "(MXNET_SERVE_HEDGE_MS) passed unanswered")
_EJECTIONS = _obs_metrics.counter(
    "fleet_replica_ejections_total",
    "replicas ejected from the rotation on heartbeat staleness")
_ROUTER_REQUESTS = _obs_metrics.counter(
    "fleet_router_requests_total",
    "predicts accepted by the fleet router")

# how long a single connect attempt may retry before the router
# treats the replica as dead-at-connect and fails over (failover
# latency floor, not a correctness knob)
_CONNECT_BUDGET_S = 1.0


class CircuitBreaker:
    """Per-replica transport circuit breaker.

    closed --N consecutive failures--> open --cooldown--> half_open
    half_open: exactly ONE trial request goes through; success closes
    the breaker, failure re-opens it for another cooldown.  All
    timing on an injectable monotonic clock (tests)."""

    def __init__(self, failures=None, cooldown=None, clock=None,
                 label="breaker"):
        from ..config import get_env
        self._threshold = int(failures) if failures is not None \
            else get_env("MXNET_SERVE_BREAKER_FAILURES")
        self._cooldown = float(cooldown) if cooldown is not None \
            else get_env("MXNET_SERVE_BREAKER_COOLDOWN")
        self._clock = clock or _time.monotonic
        self._lock = _san.lock(label="serve.%s" % label)
        self._state = "closed"
        self._consecutive = 0
        self._opened_at = None
        self._trial_inflight = False

    @property
    def state(self):
        with self._lock:
            if self._state == "open" and \
                    self._clock() - self._opened_at >= self._cooldown:
                return "half_open"
            return self._state

    def allow(self):
        """May a request be dispatched now?  In half-open, only one
        trial holder gets True until it reports back."""
        with self._lock:
            if self._state == "closed":
                return True
            if self._state == "open" and \
                    self._clock() - self._opened_at >= self._cooldown:
                self._state = "half_open"
                self._trial_inflight = False
            if self._state == "half_open" and not self._trial_inflight:
                self._trial_inflight = True
                return True
            return False

    def record_success(self):
        with self._lock:
            self._state = "closed"
            self._consecutive = 0
            self._trial_inflight = False

    def record_failure(self):
        with self._lock:
            self._consecutive += 1
            was_half_open = self._state == "half_open"
            self._trial_inflight = False
            if was_half_open or self._consecutive >= self._threshold:
                self._state = "open"
                self._opened_at = self._clock()

    def force_open(self):
        """Ejection: open regardless of the failure count (the
        cooldown still applies before a half-open trial)."""
        with self._lock:
            self._state = "open"
            self._opened_at = self._clock()
            self._trial_inflight = False


class ReplicaHandle:
    """Router-side view of one replica: address, connection pool,
    breaker, and the probe-loop's last health observation."""

    def __init__(self, host, port, http_port=0, key=None,
                 breaker=None):
        self.host = host
        self.port = int(port)
        self.http_port = int(http_port or 0)
        self.key = key or ("%s:%d" % (host, self.port))
        self.breaker = breaker or CircuitBreaker(
            label="breaker.%s" % self.key)
        self._lock = _san.lock(label="serve.replica_handle.%s"
                               % self.key)
        self._pool = []             # idle connected sockets
        self._draining = False      # router-side deploy mark
        self._ejected = False
        self._live = True
        self._replica_draining = False
        self._model_ready = None    # {model: bool} from the last probe
        self._last_ok = _time.monotonic()   # last successful probe/call
        _san.track(self, ("_pool", "_draining", "_ejected", "_live",
                          "_replica_draining", "_model_ready",
                          "_last_ok"),
                   label="serve.replica_handle.%s" % self.key)

    # -- probe-state accessors ---------------------------------------------
    @property
    def draining(self):
        with self._lock:
            return self._draining or self._replica_draining

    @property
    def ejected(self):
        with self._lock:
            return self._ejected

    def set_draining(self, flag):
        """Router/fleet-side deploy mark: stop routing NEW requests
        here (the replica keeps finishing what it accepted)."""
        with self._lock:
            self._draining = bool(flag)

    def last_ok_age(self):
        with self._lock:
            return _time.monotonic() - self._last_ok

    def note_ok(self):
        with self._lock:
            self._last_ok = _time.monotonic()

    def note_probe(self, rmeta):
        with self._lock:
            self._last_ok = _time.monotonic()
            self._live = bool(rmeta.get("live", True))
            self._replica_draining = bool(rmeta.get("draining"))
            models = rmeta.get("models") or {}
            self._model_ready = {n: bool(m.get("ready"))
                                 for n, m in models.items()}

    def note_ejected(self, flag):
        with self._lock:
            self._ejected = bool(flag)

    def eligible(self, model=None):
        """Routable for *model* right now?  (The breaker's half-open
        trial admission happens at dispatch time, not here.)"""
        with self._lock:
            if (self._draining or self._replica_draining
                    or self._ejected or not self._live):
                return False
            ready = self._model_ready
        if self.breaker.state == "open":
            return False
        if model is not None and ready is not None:
            # optimistic before the first probe lands (ready is None)
            return ready.get(model, False)
        return True

    # -- connection pool ---------------------------------------------------
    def acquire(self, timeout):
        with self._lock:
            sock = self._pool.pop() if self._pool else None
        if sock is None:
            # ONE bounded connect attempt: a black-holed replica must
            # cost _CONNECT_BUDGET_S before failover, not the kernel
            # SYN timeout (~2 min), and a refused connect fails over
            # immediately — the next probe round is the retry
            sock = socket.create_connection(
                (self.host, self.port), timeout=_CONNECT_BUDGET_S)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        sock.settimeout(timeout if timeout else None)
        return sock

    def release(self, sock):
        with self._lock:
            if len(self._pool) < 8:
                self._pool.append(sock)
                return
        try:
            sock.close()
        except OSError:
            pass

    def close_pool(self):
        with self._lock:
            pool, self._pool = self._pool, []
        for s in pool:
            try:
                s.close()
            except OSError:
                pass


class Router:
    """Spread predicts across replicas; survive any one dying.

    Parameters
    ----------
    replicas : iterable, optional
        ``(host, port)`` / ``(host, port, http_port)`` tuples or
        :class:`ReplicaHandle` instances.
    hedge_ms, rpc_timeout, retries, probe_interval, eject_timeout :
        Override the corresponding ``MXNET_SERVE_*`` knobs.
    probe : bool
        Start the health-probe thread (default True; unit tests that
        script probe state pass False).
    """

    def __init__(self, replicas=(), hedge_ms=None, rpc_timeout=None,
                 retries=None, probe_interval=None, eject_timeout=None,
                 probe=True, client_id=None):
        from ..config import get_env
        self._hedge = (float(hedge_ms)
                       if hedge_ms is not None
                       else get_env("MXNET_SERVE_HEDGE_MS")) / 1e3
        self._rpc_timeout = float(rpc_timeout) if rpc_timeout is not None \
            else get_env("MXNET_SERVE_RPC_TIMEOUT")
        self._retries = max(1, int(retries) if retries is not None
                            else get_env("MXNET_SERVE_ROUTER_RETRIES"))
        self._probe_interval = float(probe_interval) \
            if probe_interval is not None \
            else get_env("MXNET_SERVE_FLEET_HEARTBEAT")
        self._eject_timeout = float(eject_timeout) \
            if eject_timeout is not None \
            else get_env("MXNET_SERVE_EJECT_TIMEOUT")
        self.client_id = client_id or ("router-%d-%d"
                                       % (os.getpid(), id(self) & 0xFFFF))
        # wall-clock incarnation TOKEN (not a deadline): a restarted
        # router with the same client id must not be deduped against
        # its previous life — same rule as the kvstore's epoch token
        self.incarnation = int(_time.time() * 1000) & 0x7FFFFFFF
        self._lock = _san.lock(label="serve.router")
        self._replicas = {}     # key -> ReplicaHandle
        self._seq = 0
        self._rr = 0
        # router-side half of the decode journal contract: identity,
        # prompt and accepted-token log per fleet streaming session —
        # the resume payload when a replica dies or drains mid-stream
        self._decode_journal = DecodeJournal(
            "router.%s" % self.client_id)
        self._stop = _san.event()
        _san.track(self, ("_replicas", "_seq", "_rr"),
                   label="serve.router")
        for r in replicas:
            self.add_replica(r)
        self._probe_thread = None
        if probe:
            self._probe_thread = _san.thread(
                target=self._probe_loop, name="serve-router-probe",
                daemon=True)
            self._probe_thread.start()

    # -- membership --------------------------------------------------------
    def add_replica(self, replica):
        """Register a replica: a ``ReplicaHandle`` or a
        ``(host, port[, http_port])`` tuple.  Returns the handle."""
        if not isinstance(replica, ReplicaHandle):
            replica = ReplicaHandle(*replica)
        with self._lock:
            self._replicas[replica.key] = replica
        _obs_events.emit("fleet", kind="replica_admit",
                         replica=replica.key)
        return replica

    def remove_replica(self, key):
        with self._lock:
            handle = self._replicas.pop(key, None)
        if handle is not None:
            handle.close_pool()
            _obs_events.emit("fleet", kind="replica_remove",
                             replica=key)
        return handle

    def replicas(self):
        with self._lock:
            return dict(self._replicas)

    def handle(self, key):
        with self._lock:
            h = self._replicas.get(key)
        if h is None:
            raise ServeError("router knows no replica %r (have %s)"
                             % (key, sorted(self.replicas())))
        return h

    def set_draining(self, key, flag=True):
        """Deploy mark: stop routing NEW requests to *key* (accepted
        work keeps flowing back)."""
        self.handle(key).set_draining(flag)

    def ready_count(self, model=None):
        return sum(1 for h in self.replicas().values()
                   if h.eligible(model))

    # -- transport ---------------------------------------------------------
    def _call(self, handle, kind, meta=None, tensors=(), timeout=None):
        """One RPC round trip on *handle* (pooled connection).  EVERY
        transport problem — connect failure (acquire is inside the
        try: an ETIMEDOUT/EHOSTUNREACH/EMFILE here must take the
        failover path, not escape raw and strand a half-open
        breaker's trial), torn frame, RPC timeout, the injected
        partition — closes the socket and surfaces as
        ``ConnectionError``; the reply (ok or typed err) comes back
        as ``(meta, tensors)``."""
        from .._kvstore_impl import _recv_frame, _send_frame
        _servechaos.on_router_send(handle.key, port=handle.port)
        timeout = self._rpc_timeout if timeout is None else timeout
        sock = None
        try:
            sock = handle.acquire(timeout)
            _send_frame(sock, kind, meta or {}, tensors)
            rkind, rmeta, rtensors = _recv_frame(sock)
        except (ConnectionError, OSError, ValueError) as exc:
            if sock is not None:
                try:
                    sock.close()
                except OSError:
                    pass
            raise ConnectionError(
                "replica %s: transport failure (%s: %s)"
                % (handle.key, type(exc).__name__, exc)) from exc
        if rkind != MSG_REPLY:
            try:
                sock.close()
            except OSError:
                pass
            raise ConnectionError(
                "replica %s: protocol desync (reply kind %d)"
                % (handle.key, rkind))
        # the reply tensors VIEW the frame buffer — copy before the
        # socket (and buffer) go back to the pool
        rtensors = [_np.array(t) for t in rtensors]
        handle.release(sock)
        handle.note_ok()
        return rmeta, rtensors

    def control(self, key, kind, meta=None, tensors=(), timeout=None):
        """Raw control-plane RPC to one replica (LOAD / DRAIN / STATS
        / STOP ... — the fleet's deploy primitive).  Raises the typed
        serve error for an ``err`` reply."""
        rmeta, rtensors = self._call(self.handle(key), kind, meta,
                                     tensors, timeout)
        if rmeta.get("status") != "ok":
            raise error_class(rmeta.get("code"))(
                "replica %s: %s" % (key, rmeta.get("msg")))
        return rmeta, rtensors

    # -- request routing ---------------------------------------------------
    def _serialize(self, data):
        if isinstance(data, dict):
            names = sorted(data)
            return names, [_np.asarray(data[n]) for n in names]
        return [], [_np.asarray(data)]

    def _candidates(self, model):
        with self._lock:
            handles = list(self._replicas.values())
            start = self._rr
            self._rr += 1
        if not handles:
            return []
        order = [handles[(start + i) % len(handles)]
                 for i in range(len(handles))]
        return [h for h in order if h.eligible(model)]

    @staticmethod
    def _interpret(rmeta, rtensors):
        if rmeta.get("status") == "ok":
            return rtensors
        raise error_class(rmeta.get("code"))(rmeta.get("msg") or
                                             "replica error")

    def predict(self, model, data, deadline_ms=None):
        """Route one predict.  *data*: {input: array} or a bare array
        for single-input models.  Returns the outputs as a list of
        host numpy arrays; raises the same typed errors the
        single-process serve path does.  Transport failures fail over
        (same request id); typed replica answers do not."""
        names, tensors = self._serialize(data)
        with self._lock:
            self._seq += 1
            seq = self._seq
        meta = {"model": model, "inputs": names,
                "req": [self.client_id, seq, self.incarnation]}
        if deadline_ms is not None:
            meta["deadline_ms"] = float(deadline_ms)
        _ROUTER_REQUESTS.inc()
        candidates = self._candidates(model)
        if not candidates:
            raise ServeError(
                "no replica is routable for model %r (replicas: %s)"
                % (model, sorted(self.replicas())))
        if self._hedge > 0 and len(candidates) >= 2:
            return self._hedged_predict(model, meta, tensors,
                                        candidates)
        return self._failover_predict(model, meta, tensors,
                                      candidates)

    # typed shed codes that are safe to reroute: the replica answered
    # WITHOUT dispatching the request (admission-time shed), so trying
    # another replica cannot double-dispatch it
    _REROUTE_CODES = frozenset(("draining", "overload"))

    def _failover_predict(self, model, meta, tensors, candidates):
        errors = []
        tried = []      # replicas that failed in TRANSPORT
        last_shed = None
        attempts = 0
        # one pass over the fresh candidates, then — if the attempt
        # budget allows — ONE wrap-around pass over the transport-
        # failed ones: the same request id re-lands there, and the
        # replica's dedup window answers from cache if the first
        # attempt actually landed (never re-dispatches)
        plan = list(candidates)
        idx = 0
        wrapped = False
        while attempts < self._retries:
            if idx >= len(plan):
                if wrapped or not tried:
                    break
                plan = list(tried)
                idx = 0
                wrapped = True
            handle = plan[idx]
            idx += 1
            if not handle.breaker.allow():
                continue
            attempts += 1
            if tried:
                _FAILED_OVER.inc()
                _obs_events.emit("fleet", kind="failover", model=model,
                                 req=meta["req"], to=handle.key,
                                 attempt=attempts)
            try:
                rmeta, rtensors = self._call(handle, MSG_PREDICT, meta,
                                             tensors)
            except ConnectionError as exc:
                handle.breaker.record_failure()
                if handle not in tried:
                    tried.append(handle)
                errors.append("%s: %s" % (handle.key, exc))
                continue
            handle.breaker.record_success()
            if rmeta.get("status") != "ok" and \
                    rmeta.get("code") in self._REROUTE_CODES:
                # admission-time shed (deploy drain, overload): the
                # request never dispatched there — reroute, and only
                # surface the typed shed if every replica sheds.
                # Deliberately NOT in `tried`: a wrap-around retry of
                # a shed makes no progress.
                last_shed = (rmeta, rtensors)
                errors.append("%s: shed (%s)" % (handle.key,
                                                 rmeta.get("code")))
                _obs_events.emit("fleet", kind="reroute_shed",
                                 model=model, req=meta["req"],
                                 replica=handle.key,
                                 code=rmeta.get("code"))
                continue
            return self._interpret(rmeta, rtensors)
        if last_shed is not None:
            return self._interpret(*last_shed)      # raises typed
        raise ServeError(
            "request %s failed on every routable replica (%d attempts"
            "): %s" % (meta["req"], attempts,
                       "; ".join(errors) or "no replica admitted it"))

    # -- hedging -----------------------------------------------------------
    def _hedged_predict(self, model, meta, tensors, candidates):
        """Primary dispatch + a hedge to a SECOND replica if the
        primary is still unanswered after the hedge delay.  First
        typed answer wins; the loser is cancelled through the
        idempotency window.  Each replica sees the request at most
        once (distinct candidates; transport failures fall back to
        the sequential failover path over the untried rest)."""
        lock = _san.lock(label="serve.router.hedge")
        cond = _san.condition(lock, label="serve.router.hedge")
        results = []    # ("answer"|"shed"|"transport", handle, payload)

        def attempt(handle):
            try:
                payload = self._call(handle, MSG_PREDICT, meta, tensors)
                handle.breaker.record_success()
                rmeta = payload[0]
                if rmeta.get("status") != "ok" and \
                        rmeta.get("code") in self._REROUTE_CODES:
                    entry = ("shed", handle, payload)
                else:
                    entry = ("answer", handle, payload)
            except ConnectionError as exc:
                handle.breaker.record_failure()
                entry = ("transport", handle, exc)
            with lock:
                results.append(entry)
                cond.notify_all()

        # the primary dispatch honors the breaker like the failover
        # path does — a half-open replica gets its ONE trial, not a
        # burst of concurrent hedged primaries
        primary = next((h for h in candidates if h.breaker.allow()),
                       None)
        if primary is None:
            return self._failover_predict(model, meta, tensors,
                                          candidates)
        launched = [primary]
        _san.thread(target=attempt, args=(primary,),
                    daemon=True).start()
        deadline = _time.monotonic() + (self._rpc_timeout or 60.0)
        hedge_by = _time.monotonic() + self._hedge
        hedged = False
        while True:
            with lock:
                answer = next((r for r in results if r[0] == "answer"),
                              None)
                failed = len(results)
            if answer is not None:
                break
            if failed >= len(launched):
                # every launched attempt died in transport or shed:
                # hand the plain failover path the never-launched
                # candidates FIRST, then the transport-failed launched
                # ones — its wrap-around retries them with the same
                # id, where the dedup window answers from cache (the
                # retry budget the non-hedged path would have given
                # them)
                with lock:
                    transport_failed = [r[1] for r in results
                                        if r[0] == "transport"]
                rest = [h for h in candidates if h not in launched] \
                    + transport_failed
                if rest:
                    return self._failover_predict(model, meta, tensors,
                                                  rest)
                with lock:
                    shed = next((r for r in results if r[0] == "shed"),
                                None)
                if shed is not None:
                    return self._interpret(*shed[2])    # raises typed
                raise ServeError(
                    "hedged request %s failed on every replica: %s"
                    % (meta["req"],
                       "; ".join("%s: %s" % (r[1].key, r[2])
                                 for r in results)))
            now = _time.monotonic()
            if now >= deadline:
                raise ServeError(
                    "hedged request %s unanswered after %.1fs"
                    % (meta["req"], self._rpc_timeout))
            if not hedged and now >= hedge_by:
                second = next((h for h in candidates
                               if h not in launched
                               and h.breaker.allow()), None)
                if second is not None:
                    hedged = True
                    launched.append(second)
                    _HEDGED.inc()
                    _obs_events.emit("fleet", kind="hedge",
                                     model=model, req=meta["req"],
                                     to=second.key)
                    _san.thread(target=attempt, args=(second,),
                                daemon=True).start()
                else:
                    hedge_by = deadline     # nobody to hedge to
            with lock:
                if not any(r[0] == "answer" for r in results) \
                        and len(results) < len(launched):
                    cond.wait(timeout=min(
                        0.05,
                        max(0.001, (hedge_by if not hedged
                                    else deadline)
                            - _time.monotonic())))
        winner_handle = answer[1]
        losers = [h for h in launched if h is not winner_handle]
        for loser in losers:
            # best-effort: reclaim the loser's queue slot and pin the
            # id cancelled in its window so the hedged id can never be
            # answered twice or re-dispatched there
            _san.thread(target=self._cancel_on, args=(loser, meta),
                        daemon=True).start()
        return self._interpret(*answer[2])

    def _cancel_on(self, handle, meta):
        try:
            self._call(handle, MSG_CANCEL, {"req": meta["req"]},
                       timeout=min(5.0, self._rpc_timeout or 5.0))
        except (ConnectionError, OSError):
            pass

    # -- streaming decode --------------------------------------------------
    @property
    def decode_journal(self):
        """The router-side session journal (resume source of truth
        for fleet streaming sessions)."""
        return self._decode_journal

    def decode_open(self, model, prompt, max_new_tokens=None,
                    deadline_ms=None):
        """Open one fleet streaming decode session on an eligible
        replica.  Returns a :class:`DecodeStream` — the stable handle
        the caller keeps across replica death and deploys: tokens are
        journaled as they stream back, and a dead/draining replica's
        session transparently re-opens on a successor from the
        journal, resuming bit-equal.  Raises the typed serve errors
        (``KVPoolExhausted``/``OverloadError`` when no replica can
        hold the session, ``ServeError`` when none is routable)."""
        with self._lock:
            self._seq += 1
            seq = self._seq
        stream = DecodeStream(self, model, prompt, seq,
                              max_new_tokens=max_new_tokens,
                              deadline_ms=deadline_ms)
        stream._open_somewhere("open")
        return stream

    # -- health probing ----------------------------------------------------
    def _probe_loop(self):
        while not self._stop.wait(self._probe_interval):
            try:
                self.probe_once()
            except Exception:   # the fleet's health surface must
                log.exception("router probe round failed")  # survive

    def probe_once(self):
        """One probe round over every replica: refresh health state,
        eject on staleness, rejoin on recovery, refresh the
        fleet_replicas_ready gauge.  Called by the probe thread; unit
        tests call it directly."""
        for handle in self.replicas().values():
            try:
                rmeta, _ = self._call(
                    handle, MSG_HEALTH, {},
                    timeout=max(1.0, self._probe_interval * 4))
            except ConnectionError:
                if not handle.ejected and \
                        handle.last_ok_age() > self._eject_timeout:
                    handle.note_ejected(True)
                    handle.breaker.force_open()
                    _EJECTIONS.inc()
                    _obs_events.emit("fleet", kind="eject",
                                     replica=handle.key,
                                     stale_s=round(
                                         handle.last_ok_age(), 3))
                continue
            handle.note_probe(rmeta)
            if handle.ejected:
                handle.note_ejected(False)
                handle.breaker.record_success()
                _obs_events.emit("fleet", kind="rejoin",
                                 replica=handle.key)
        _REPLICAS_READY.set(self.ready_count())

    def close(self):
        self._stop.set()
        if self._probe_thread is not None:
            self._probe_thread.join(timeout=5.0)
        for handle in self.replicas().values():
            handle.close_pool()


class DecodeStream:
    """One fleet streaming decode session under a stable handle.

    The router places the session on an eligible replica
    (DECODE_OPEN) and the caller pulls tokens with
    :meth:`next_output` (DECODE_NEXT per index — answered from the
    replica's retained stream, so a retried index dedups instead of
    re-decoding).  Every accepted token is journaled router-side; when
    the serving replica dies (transport failure) or drains (deploy
    migration), the session re-opens on a successor with the journal
    as the resume payload — the successor re-prefills and replays the
    log bit-checked, and the caller keeps reading under the SAME
    handle.  Resume attempts ride the shared jittered backoff,
    bounded by the router's retry budget per failover; past the
    budget the stream fails typed.  A cancelled stream is NEVER
    resumed — a cancel racing a failover wins."""

    def __init__(self, router, model, prompt, seq,
                 max_new_tokens=None, deadline_ms=None):
        import random
        self._router = router
        self.model = model
        self.client = router.client_id
        self.seq = int(seq)
        self.incarnation = 0
        names, tensors = router._serialize(prompt)
        self._prompt_names = names
        self._prompt_tensors = tensors
        self.max_new_tokens = max_new_tokens
        self._deadline_ms = deadline_ms
        self._rng = random.Random()
        self._lock = _san.lock(label="serve.decode.stream.%d" % seq)
        self._handle = None         # current ReplicaHandle
        self._base = 0              # successor-side resume offset
        self._ntokens = 0
        self._out_names = None      # leaf names of one output tree
        self._done = False
        self.finish_reason = None
        self._error = None
        self._cancelled = False
        self.failover_count = 0
        self.resume_stamps = []     # (t_detect, t_resumed) monotonic
        length = int(tensors[0].shape[0]) if tensors else 0
        router._decode_journal.open(
            self.client, self.seq, 0,
            prompt=dict(zip(names, tensors)) if names else tensors[0],
            length=length, max_new_tokens=max_new_tokens)

    @property
    def key(self):
        return (self.client, self.seq)

    @property
    def replica(self):
        """The key of the replica currently serving this stream."""
        with self._lock:
            return self._handle.key if self._handle is not None \
                else None

    def tokens(self):
        """Every accepted token so far (the journal log — survives
        failovers, readable after a typed failure)."""
        return self._router._decode_journal.tokens(self.key)

    def done(self):
        with self._lock:
            return self._done

    @property
    def error(self):
        with self._lock:
            return self._error

    # -- placement / failover ----------------------------------------------
    def _open_meta(self, resume_tokens):
        meta = {"model": self.model,
                "session": [self.client, self.seq, self.incarnation],
                "inputs": self._prompt_names,
                "resume": len(resume_tokens),
                "out_names": self._out_names}
        if self.max_new_tokens is not None:
            meta["max_new_tokens"] = self.max_new_tokens
        if self._deadline_ms is not None:
            meta["deadline_ms"] = float(self._deadline_ms)
        tensors = list(self._prompt_tensors)
        for tok in resume_tokens:
            _, leaves = ReplicaServer._out_wire(tok)
            tensors.extend(leaves)
        return meta, tensors

    def _open_somewhere(self, why, failed=None):
        """Place (or re-place) the session on an eligible replica —
        DECODE_OPEN with the journal as the resume payload.  Typed
        sheds (draining/overload/rebuilding) reroute; transport
        failures back off on the shared jittered schedule; the
        router's retry budget bounds the attempts."""
        router = self._router
        resume_tokens = self.tokens()
        meta, tensors = self._open_meta(resume_tokens)
        delays = backoff_delays(router._retries + 1, 0.05, 1.0, 2.0,
                                0.5, self._rng)
        errors = []
        last_shed = None
        attempts = 0
        while attempts < router._retries:
            if self._cancelled:
                raise RequestCancelled(
                    "decode session (%s, %d) cancelled — a cancelled "
                    "session is never resumed"
                    % (self.client, self.seq))
            candidates = [h for h in router._candidates(self.model)
                          if h is not failed] \
                or router._candidates(self.model)
            handle = next((h for h in candidates
                           if h.breaker.allow()), None)
            if handle is None:
                errors.append("no routable replica")
                attempts += 1
                _time.sleep(next(delays))
                continue
            attempts += 1
            try:
                rmeta, _ = router._call(handle, MSG_DECODE_OPEN, meta,
                                        tensors)
            except ConnectionError as exc:
                handle.breaker.record_failure()
                failed = handle
                errors.append("%s: %s" % (handle.key, exc))
                _time.sleep(next(delays))
                continue
            handle.breaker.record_success()
            if rmeta.get("status") != "ok":
                code = rmeta.get("code")
                if code in Router._REROUTE_CODES:
                    # admission-time shed: never dispatched there
                    last_shed = rmeta
                    failed = handle
                    errors.append("%s: shed (%s)" % (handle.key, code))
                    _time.sleep(next(delays))
                    continue
                raise error_class(code)(rmeta.get("msg")
                                        or "replica error")
            with self._lock:
                self._handle = handle
                self._base = int(rmeta.get("base", 0))
            _obs_events.emit(
                "decode",
                kind="migrate" if why == "migrate" else "resume"
                if why != "open" else "session_place",
                model=self.model, client=str(self.client),
                session_seq=self.seq, incarnation=self.incarnation,
                to=handle.key, tokens=len(resume_tokens), why=why)
            return
        if last_shed is not None:
            raise error_class(last_shed.get("code"))(
                last_shed.get("msg") or "replica shed")
        raise ServeError(
            "decode session (%s, %d): %s budget exhausted after %d "
            "attempt(s): %s"
            % (self.client, self.seq,
               "open" if why == "open" else "resume", attempts,
               "; ".join(errors) or "no replica admitted it"))

    def _failover(self, why, exc=None):
        """The serving replica died or drained mid-stream: bump the
        incarnation and re-open on a successor from the journal —
        transparent to the caller, bit-equal to an uninterrupted
        stream (the successor replays the log bit-checked)."""
        with self._lock:
            if self._cancelled:
                raise RequestCancelled(
                    "decode session (%s, %d) cancelled during "
                    "failover — never resumed"
                    % (self.client, self.seq))
            failed = self._handle
            self._handle = None
            self.incarnation += 1
            self.failover_count += 1
        t0 = _time.monotonic()
        _FAILOVERS_TOTAL.inc()
        _obs_events.emit("decode", kind="failover", model=self.model,
                         client=str(self.client), session_seq=self.seq,
                         incarnation=self.incarnation,
                         from_=failed.key if failed else None,
                         why=why,
                         error=str(exc)[:200] if exc else None)
        try:
            self._open_somewhere(why, failed=failed)
        except Exception as oexc:
            with self._lock:
                self._done = True
                self._error = oexc
                self.finish_reason = "failover_exhausted"
            self._router._decode_journal.close(
                self.key, "failover_exhausted")
            raise
        self.resume_stamps.append((t0, _time.monotonic()))
        _RESUMED_TOTAL.inc()

    # -- token stream ------------------------------------------------------
    def next_output(self, timeout=None):
        """The next accepted token (host tree).  Blocks across
        failovers; raises ``StopIteration`` on a clean finish, the
        typed error on failure, ``TimeoutError`` past *timeout*."""
        deadline = None if timeout is None \
            else _time.monotonic() + timeout
        with self._lock:
            if self._error is not None:
                raise self._error
            if self._cancelled:
                raise RequestCancelled(
                    "decode session (%s, %d) cancelled"
                    % (self.client, self.seq))
            if self._done:
                raise StopIteration(
                    "decode session (%s, %d) finished (%s)"
                    % (self.client, self.seq, self.finish_reason))
            index = self._ntokens
            handle = self._handle
        while True:
            if deadline is not None and \
                    _time.monotonic() >= deadline:
                raise TimeoutError(
                    "decode session (%s, %d): token %d not available "
                    "after %ss" % (self.client, self.seq, index,
                                   timeout))
            if handle is None:
                self._failover("resume")
                with self._lock:
                    handle = self._handle
            wait_s = 5.0
            if deadline is not None:
                wait_s = max(0.05, min(
                    wait_s, deadline - _time.monotonic()))
            try:
                rmeta, rtensors = self._router._call(
                    handle, MSG_DECODE_NEXT,
                    {"session": [self.client, self.seq,
                                 self.incarnation],
                     "index": index, "wait_s": wait_s})
            except ConnectionError as exc:
                handle.breaker.record_failure()
                self._failover("resume", exc)
                with self._lock:
                    handle = self._handle
                continue
            handle.breaker.record_success()
            if rmeta.get("status") != "ok":
                code = rmeta.get("code")
                if code == "draining":
                    # deploy drain mid-stream: migrate to a successor
                    self._failover("migrate")
                    with self._lock:
                        handle = self._handle
                    continue
                err = error_class(code)(rmeta.get("msg")
                                        or "replica error")
                with self._lock:
                    self._done = True
                    self._error = err
                    self.finish_reason = code
                self._router._decode_journal.close(self.key, code)
                raise err
            if rmeta.get("pending"):
                continue        # bounded wait elapsed — poll again
            if rmeta.get("done"):
                with self._lock:
                    self._done = True
                    self.finish_reason = rmeta.get("reason")
                self._router._decode_journal.close(
                    self.key, rmeta.get("reason") or "finished")
                raise StopIteration(
                    "decode session (%s, %d) finished (%s)"
                    % (self.client, self.seq, self.finish_reason))
            names = rmeta.get("out_names")
            out = ReplicaServer._out_unwire(names, rtensors)
            self._router._decode_journal.append(self.key, index, out)
            with self._lock:
                self._out_names = names
                self._ntokens = index + 1
            return out

    def result(self, timeout=None):
        """Drain the stream to completion; returns the FULL accepted
        token list (journal log — pre-failover tokens included), or
        raises the typed failure."""
        deadline = None if timeout is None \
            else _time.monotonic() + timeout
        while True:
            remaining = None if deadline is None \
                else max(0.001, deadline - _time.monotonic())
            try:
                self.next_output(timeout=remaining)
            except StopIteration:
                return self.tokens()

    def cancel(self):
        """Abandon the stream.  The cancel is pinned on the serving
        replica (a late failover re-open answers ``cancelled``) and
        the session is never resumed."""
        with self._lock:
            if self._done:
                return False
            self._cancelled = True
            self._done = True
            self.finish_reason = "cancelled"
            self._error = RequestCancelled(
                "decode session (%s, %d) cancelled by its caller"
                % (self.client, self.seq))
            handle = self._handle
        self._router._decode_journal.close(self.key, "cancelled")
        if handle is not None:
            try:
                self._router._call(
                    handle, MSG_DECODE_CANCEL,
                    {"session": [self.client, self.seq,
                                 self.incarnation]},
                    timeout=min(5.0, self._router._rpc_timeout or 5.0))
            except (ConnectionError, OSError):
                pass
        return True

    def close(self):
        """Release the replica-side session record (best effort; a
        live stream is cancelled first)."""
        with self._lock:
            live = not self._done
            handle = self._handle
        if live:
            self.cancel()
            with self._lock:
                handle = self._handle
        if handle is not None:
            try:
                self._router._call(
                    handle, MSG_DECODE_CLOSE,
                    {"session": [self.client, self.seq,
                                 self.incarnation]},
                    timeout=min(5.0, self._router._rpc_timeout or 5.0))
            except (ConnectionError, OSError):
                pass
