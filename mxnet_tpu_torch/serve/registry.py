"""ModelRegistry — multi-model serving with warm per-rung programs (port
of ``mxnet_tpu/serve/registry.py``, without quantization, tuning and the
C predict ABI's process-wide instance).

The registry is the process's serving control plane:

* ``load`` builds a :class:`CompiledPredictor` and — by default — warms
  every bucket program up front (on the card: one CUDA graph per rung),
  so the first request is as fast as the thousandth;
* ``alias`` gives one model several routable names (traffic cutovers
  without a rebuild); repointing an alias flushes the old target's
  accepted requests so a deploy never drops work it admitted;
* ``drain`` stops a model's admissions and waits (bounded) for its
  accepted requests; ``unload`` drains by default, then tears the
  model, its aliases and its batcher down;
* ``batcher``/``submit`` attach the dynamic batcher to a model by name;
* ``health``/``ready``/``live`` expose the per-model state machine (see
  health.py) plus queue depth and dispatcher liveness;
* the paged decode engines a model carries
  (:meth:`CompiledPredictor.make_paged_decoder`) drain with it: unload
  and replacement drain and close their batchers, an alias cutover
  flushes them, and ``health``/``live`` cover them.

Every load/unload/alias/drain/health transition is a ``serve`` event and
every program build is counted and blamed (see predictor.py).
"""

from __future__ import annotations

from .batcher import DynamicBatcher
from .buckets import ServeError
from .health import HealthBoard
from .predictor import CompiledPredictor
from .. import sanitizer as _san
from ..observability import events as _obs_events
from ..observability import metrics as _obs_metrics

__all__ = ["ModelRegistry"]

_MODELS_GAUGE = _obs_metrics.gauge(
    "serve_models_loaded",
    "models resident across all serve registries (delta-maintained)")
_DRAINS_TOTAL = _obs_metrics.counter(
    "serve_drains_total",
    "graceful drains started (Registry.drain + unload(drain=True))")


class ModelRegistry:
    """Named, warm models."""

    def __init__(self):
        self._lock = _san.rlock(label="serve.registry")
        self._models = {}     # name -> CompiledPredictor
        self._aliases = {}    # alias -> canonical name
        self._batchers = {}   # canonical name -> DynamicBatcher
        self._board = HealthBoard()
        _san.track(self, ("_models", "_aliases", "_batchers"),
                   label="serve.registry")

    # -- loading -----------------------------------------------------------
    def load(self, name, symbol, arg_params, aux_params=None,
             data_shapes=None, ladder=None, data_dtypes=None, ctx=None,
             warm=True, bucket_inputs=None, quantize=None, calib=None,
             calib_batches=None):
        """Register and (by default) warm a model: one program per rung,
        a CUDA graph each on the card.  Returns the
        :class:`CompiledPredictor`.  Re-loading a live name replaces it
        atomically (aliases keep pointing at the name; the displaced
        predictor's batcher is drained, then closed).  A build or warm
        failure — a failed graph capture among them — never
        half-registers: the name is dropped from the health board, a
        ``load_failed`` event records it and the error propagates.
        *quantize*, *calib* and *calib_batches* are not ported."""
        if quantize is not None or calib is not None or \
                calib_batches is not None:
            raise ServeError("load(%r): quantized serving is not ported "
                             "(queue A item 6b)" % name)

        def _check_not_alias():
            if name in self._aliases:
                raise ServeError(
                    "%r is an alias (for %r) — unalias it before "
                    "loading a model under that name"
                    % (name, self._aliases[name]))

        with self._lock:
            _check_not_alias()      # before paying the warm builds
            replacing = name in self._models
        if not replacing:
            self._board.transition(name, "loading")
        try:
            pred = CompiledPredictor(
                symbol, arg_params, aux_params=aux_params,
                data_shapes=data_shapes, ladder=ladder,
                data_dtypes=data_dtypes, ctx=ctx, name=name,
                bucket_inputs=bucket_inputs)
            if warm:
                if not replacing:
                    self._board.transition(name, "warming")
                built = pred.warm()
            else:
                built = 0
        except Exception as exc:
            if not replacing:
                self._board.drop(name)
            _obs_events.emit("serve", kind="load_failed", model=name,
                             error="%s: %s" % (type(exc).__name__,
                                               str(exc)[:200]))
            raise
        with self._lock:
            _check_not_alias()      # racing alias() may have won
            displaced = self._models.get(name)
            old_batcher = self._batchers.pop(name, None)
            if name not in self._models:
                _MODELS_GAUGE.inc()  # delta: aggregates across registries
            self._models[name] = pred
            # ready-mark inside the install lock: marking after release
            # let a concurrent unload drop the board first, then this
            # write resurrected a 'ready' entry for a model that is gone
            self._board.transition(name, "ready")
        if old_batcher is not None:
            # the displaced predictor's accepted requests finish before
            # teardown; unwire its health hook first, so a crash while
            # draining leftovers cannot mark the replacement unhealthy
            old_batcher.detach_state_hook()
            old_batcher.drain()
            old_batcher.close()
        if displaced is not None and displaced is not pred:
            # the displaced model's decode sessions are accepted work:
            # finish or typed-fail them, release their pool blocks
            self._drain_decoders(displaced, name)
            for eng in list(displaced._decode_engines):
                eng.close()
        _obs_events.emit("serve", kind="load", model=name, programs=built,
                         warm=bool(warm), buckets=list(pred.ladder.batches))
        return pred

    def load_checkpoint(self, name, prefix, epoch, data_shapes, ctx=None,
                        **kwargs):
        """Load ``prefix-symbol.json`` + ``prefix-NNNN.params`` (written by
        either package) onto *ctx* and register it."""
        from ..model import load_checkpoint
        sym, arg_params, aux_params = load_checkpoint(prefix, epoch, ctx=ctx)
        return self.load(name, sym, arg_params, aux_params=aux_params,
                         data_shapes=data_shapes, ctx=ctx, **kwargs)

    # -- naming ------------------------------------------------------------
    def _resolve(self, name):
        return self._aliases.get(name, name)

    def get(self, name):
        """The predictor for *name* (aliases resolved)."""
        with self._lock:
            pred = self._models.get(self._resolve(name))
        if pred is None:
            raise ServeError("no model %r is loaded (have %s)"
                             % (name, self.names()))
        return pred

    def alias(self, alias, name):
        """Route *alias* to model *name* (repoint allowed — the
        traffic-cutover primitive).  On a repoint, the old target's
        accepted requests are flushed (bounded by
        ``MXNET_SERVE_DRAIN_TIMEOUT``) before returning."""
        with self._lock:
            target = self._resolve(name)
            if target not in self._models:
                raise ServeError("cannot alias %r to unknown model %r"
                                 % (alias, name))
            if alias in self._models:
                raise ServeError(
                    "%r names a loaded model — unload it before "
                    "turning the name into an alias" % alias)
            old = self._aliases.get(alias)
            self._aliases[alias] = target
            old_batcher = self._batchers.get(old) \
                if old is not None and old != target else None
            old_pred = self._models.get(old) \
                if old is not None and old != target else None
        _obs_events.emit("serve", kind="alias", alias=alias, model=target)
        if old_batcher is not None:
            complete = old_batcher.flush()
            _obs_events.emit("serve", kind="cutover_flush", alias=alias,
                             model=old, complete=bool(complete))
        if old_pred is not None:
            # decode sessions riding the old target are accepted work
            # too: let them finish (bounded), typed-fail the rest and
            # release their pool blocks.  Flush, not close — the old
            # model may still serve through other aliases or its direct
            # name (the predict path's cutover rule)
            self._drain_decoders(old_pred, old, close=False)

    # -- graceful drain / teardown -----------------------------------------
    def _drain_decoders(self, pred, name, timeout=None, drain=True,
                        close=True):
        """Decode half of the never-drop-accepted-work deploy contract.
        With *close* (unload / load-replace: the model is going away)
        every decode batcher is drained (bounded, when *drain*) and
        closed; sessions finish or typed-fail and their pool blocks are
        released either way.  Without *close* (alias cutover: the model
        may still be reachable through other aliases or its direct name)
        accepted sessions are FLUSHED — they land or typed-fail at the
        deadline — but admissions continue and the batcher keeps
        serving."""
        for eng in list(pred._decode_engines):
            for db in list(eng._batchers):
                if not close:
                    complete = db.flush(timeout)
                    _obs_events.emit(
                        "decode", kind="cutover_drain", model=name,
                        batcher=db.name, complete=bool(complete))
                    continue
                if drain:
                    drained = db.drain(timeout)
                    _obs_events.emit(
                        "decode", kind="cutover_drain", model=name,
                        batcher=db.name, complete=bool(drained))
                db.close()

    def drain(self, name, timeout=None):
        """Stop admissions to *name*'s batcher (submits raise a typed
        ServeError) and wait up to *timeout* seconds (default the
        ``MXNET_SERVE_DRAIN_TIMEOUT`` knob) for every accepted request to
        resolve.  The model stays loaded (direct ``predict`` still works);
        ``unload`` completes the teardown.  Returns True when the queue
        fully drained."""
        with self._lock:
            target = self._resolve(name)
            if target not in self._models:
                raise ServeError("no model %r to drain" % name)
            batcher = self._batchers.get(target)
        self._board.transition(target, "draining")
        _DRAINS_TOTAL.inc()
        _obs_events.emit("serve", kind="drain", model=target, mode="drain")
        if batcher is None:
            _obs_events.emit("serve", kind="drain_complete", model=target,
                             mode="drain", waited_requests=0,
                             timed_out=False)
            return True
        drained = batcher.drain(timeout)
        stats = batcher.last_drain_stats or {}
        _obs_events.emit("serve", kind="drain_complete", model=target,
                         mode="drain",
                         waited_requests=stats.get("waited_requests", 0),
                         timed_out=bool(stats.get("timed_out",
                                                  not drained)))
        return drained

    def drain_all(self, timeout=None):
        """Drain every loaded model.  Returns ``{"models": N,
        "waited_requests": total, "timed_out": any}``."""
        waited = 0
        timed_out = False
        names = self.names()
        for name in names:
            drained = self.drain(name, timeout)
            with self._lock:
                batcher = self._batchers.get(self._resolve(name))
            stats = (batcher.last_drain_stats or {}) \
                if batcher is not None else {}
            waited += int(stats.get("waited_requests", 0))
            timed_out = timed_out or not drained
        return {"models": len(names), "waited_requests": waited,
                "timed_out": timed_out}

    def resume_all(self):
        """Undo :meth:`drain_all`: reopen admissions on every drained
        model and mark it ready again.  Models whose batcher is closed or
        unhealthy are left alone.  Returns the resumed names."""
        resumed = []
        for name in self.names():
            with self._lock:
                target = self._resolve(name)
                batcher = self._batchers.get(target)
            if batcher is not None and not batcher.undrain():
                continue
            if self._board.state(target) == "draining":
                self._board.transition(target, "ready")
            resumed.append(target)
            _obs_events.emit("serve", kind="resume", model=target)
        return resumed

    def unload(self, name, drain=True, timeout=None):
        """Drop a model (or just an alias).  Unloading a model also drops
        every alias pointing at it and closes its batcher.  With *drain*
        (the default) admissions stop first and accepted requests get up
        to *timeout* seconds to finish; ``drain=False`` is the fast
        teardown that fails queued futures with a typed ServeError."""
        with self._lock:
            if name in self._aliases and name not in self._models:
                del self._aliases[name]
                _obs_events.emit("serve", kind="unalias", alias=name)
                return
            pred = self._models.get(name)
            if pred is None:
                raise ServeError("no model %r to unload" % name)
            batcher = self._batchers.get(name)
        drained = None
        marked_draining = False
        if drain and batcher is not None:
            self._board.transition(name, "draining")
            marked_draining = True
            _DRAINS_TOTAL.inc()
            _obs_events.emit("serve", kind="drain", model=name,
                             mode="unload")
            drained = batcher.drain(timeout)
            stats = batcher.last_drain_stats or {}
            _obs_events.emit(
                "serve", kind="drain_complete", model=name, mode="unload",
                waited_requests=stats.get("waited_requests", 0),
                timed_out=bool(stats.get("timed_out", not drained)))
        with self._lock:
            if self._models.get(name) is not pred:
                # lost the race to a concurrent load/unload: if our
                # draining mark sits over a live replacement, lift it
                if marked_draining and name in self._models and \
                        self._board.state(name) == "draining":
                    self._board.transition(name, "ready")
                return
            del self._models[name]
            dropped = [a for a, t in self._aliases.items() if t == name]
            for a in dropped:
                del self._aliases[a]
            batcher = self._batchers.pop(name, None) or batcher
            _MODELS_GAUGE.dec()
        if batcher is not None:
            # the board entry dies below — a late dispatcher crash must
            # not resurrect it under the dropped name
            batcher.detach_state_hook()
            batcher.close()
        # decode sessions drain with the model: with drain=True they
        # finish (bounded) before the typed-fail sweep; either way every
        # pool block is released before the engine closes
        self._drain_decoders(pred, name, timeout, drain=drain)
        for eng in list(pred._decode_engines):
            eng.close()
        self._board.drop(name)
        _obs_events.emit("serve", kind="unload", model=name,
                         aliases_dropped=dropped,
                         **({} if drained is None
                            else {"drained": bool(drained)}))

    def names(self):
        with self._lock:
            return sorted(self._models)

    def aliases(self):
        with self._lock:
            return dict(self._aliases)

    # -- health ------------------------------------------------------------
    def health(self, name=None):
        """The readiness/liveness view.  With *name*: one model's state
        dict — health-board state (a batcher's unhealthy/draining
        overrides a stale ``ready``), queue depth, dispatcher liveness and
        tick age, restart count, dirty-close flag, traffic counters and
        programs built.  Without: ``{model: state dict}`` for every loaded
        model."""
        if name is None:
            with self._lock:
                known = sorted(set(self._models) |
                               set(self._board.snapshot()))
            out = {}
            for n in known:
                try:
                    out[n] = self.health(n)
                except ServeError:
                    # unloaded between the name snapshot and the
                    # per-model read: omit it, do not fail the view
                    continue
            return out
        with self._lock:
            target = self._resolve(name)
            pred = self._models.get(target)
            batcher = self._batchers.get(target)
        state = self._board.state(target)
        if pred is None and state is None:
            raise ServeError("no model %r is loaded (have %s)"
                             % (name, self.names()))
        info = {
            "model": target,
            "state": state or "ready",
            "queue_depth": 0,
            "dispatcher_alive": None,
            "tick_age_s": None,
            "restarts": 0,
            "closed_dirty": False,
            "requests": 0,
            "batches": 0,
            "programs": pred.compile_count if pred is not None else 0,
        }
        if batcher is not None:
            bstate = batcher.health_state()
            if bstate != "ready" and info["state"] == "ready":
                info["state"] = bstate
            info.update(
                queue_depth=batcher.queue_depth,
                dispatcher_alive=batcher.dispatcher_alive(),
                tick_age_s=round(batcher.last_tick_age(), 3),
                restarts=batcher.restart_count,
                closed_dirty=batcher.closed_dirty,
                requests=batcher.request_count,
                batches=batcher.batch_count)
        engines = list(pred._decode_engines) if pred is not None else []
        if engines:
            dbs = [db for eng in engines for db in eng._batchers]
            info["decode"] = {
                "sessions": sum(e.active_sessions for e in engines),
                "kv_blocks_in_use": sum(e.pool.blocks_in_use
                                        for e in engines),
                "kv_blocks_total": sum(e.pool.blocks_total
                                       for e in engines),
                "batchers": [db.health_state() for db in dbs],
                # quarantine-and-rebuild surface: spent/budgeted
                # rebuilds and whether one is in flight right now
                "rebuilds": sum(db.rebuild_count for db in dbs),
                "rebuild_budget": sum(db.rebuild_budget for db in dbs),
                "rebuilding": any(db.rebuilding for db in dbs),
            }
            if info["state"] == "ready" and any(db.unhealthy for db in dbs):
                info["state"] = "unhealthy"
            elif info["state"] == "ready" and info["decode"]["rebuilding"]:
                info["state"] = "rebuilding"
        return info

    def ready(self, name):
        """Readiness probe: does *name* accept new requests?"""
        try:
            return self.health(name)["state"] == "ready"
        except ServeError:
            return False

    def live(self, max_tick_age=5.0):
        """Liveness probe: every dispatcher thread (the predict batchers'
        and the decode batchers') is running and — when it has work
        queued — has ticked within *max_tick_age* seconds."""
        with self._lock:
            batchers = list(self._batchers.values())
            preds = list(self._models.values())
        for b in batchers:
            if b.unhealthy or not b.dispatcher_alive():
                return False
            if b.queue_depth > 0 and b.last_tick_age() > max_tick_age:
                return False
        for pred in preds:
            for eng in list(pred._decode_engines):
                for db in list(eng._batchers):
                    if db.unhealthy:
                        return False
                    if db.rebuilding:
                        # a quarantine-and-rebuild in flight: the old
                        # dispatcher thread is executing the rebuild,
                        # not ticking — alive, not wedged
                        continue
                    if not db.stopped and not db.dispatcher_alive():
                        return False
                    if db.session_count > 0 and \
                            db.last_tick_age() > max_tick_age:
                        return False
        return True

    # -- request routing ---------------------------------------------------
    def batcher(self, name, **kwargs):
        """Get-or-create the dynamic batcher for a model (aliases
        resolved; knob overrides only apply on creation)."""
        with self._lock:
            target = self._resolve(name)
            if target not in self._models:
                raise ServeError("no model %r is loaded" % name)
            b = self._batchers.get(target)
            if b is None:
                kwargs.setdefault(
                    "on_state",
                    lambda state, _t=target:
                        self._board.transition(_t, state))
                b = DynamicBatcher(self._models[target], name=target,
                                   **kwargs)
                if self._board.state(target) == "draining":
                    # drain() ran before any traffic created a batcher:
                    # the new one comes up with admissions stopped
                    b.drain(timeout=0)
                self._batchers[target] = b
            return b

    def submit(self, name, data, deadline_ms=None):
        """Submit one request to *name*'s dynamic batcher; returns a
        :class:`~mxnet_tpu_torch.serve.batcher.ServeFuture`."""
        return self.batcher(name).submit(data, deadline_ms=deadline_ms)

    def predict(self, name, data, key=None):
        """Direct (unbatched) predict on *name* — bypasses the batcher;
        still padded-bucket, still one program per rung."""
        return self.get(name).predict(data, key=key)

    def close(self):
        """Unload everything, fast (no drain: batchers closed, queued
        futures failed with a typed ServeError)."""
        for name in self.names():
            self.unload(name, drain=False)
