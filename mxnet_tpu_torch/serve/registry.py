"""ModelRegistry — multi-model serving with warm per-rung programs (port
of ``mxnet_tpu/serve/registry.py``, without the C predict ABI's
process-wide instance and the IR audit).

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
* ``load(..., quantize=...)`` lowers the model to int8 first
  (``quantize``) and gates every rung against the fp32 model before it
  serves; ``MXNET_TUNING_STORE`` supplies a tuned ladder and batcher
  knobs (``autotune``);
* the paged decode engines a model carries
  (:meth:`CompiledPredictor.make_paged_decoder`) drain with it: unload
  and replacement drain and close their batchers, an alias cutover
  flushes them, and ``health``/``live`` cover them.

Every load/unload/alias/drain/health transition is a ``serve`` event and
every program build is counted and blamed (see predictor.py).
"""

from __future__ import annotations

from .batcher import DynamicBatcher
from .buckets import BucketLadder, ServeError
from .health import HealthBoard
from .predictor import CompiledPredictor
from .. import sanitizer as _san
from ..context import Context, current_context
from ..observability import events as _obs_events
from ..observability import metrics as _obs_metrics

__all__ = ["ModelRegistry"]

_MODELS_GAUGE = _obs_metrics.gauge(
    "serve_models_loaded",
    "models resident across all serve registries (delta-maintained)")
_DRAINS_TOTAL = _obs_metrics.counter(
    "serve_drains_total",
    "graceful drains started (Registry.drain + unload(drain=True))")
_QUANT_MODELS_GAUGE = _obs_metrics.gauge(
    "serve_quantized_models",
    "quantized models resident across all serve registries "
    "(delta-maintained)")
_QUANT_GATE_FAILURES = _obs_metrics.counter(
    "quant_accuracy_gate_failures_total",
    "quantized loads rejected by the load-time accuracy gate")


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

        When ``MXNET_TUNING_STORE`` names an autotune store with an entry
        for ``(name, device_kind, "serve")``, the tuned ladder applies
        when no *ladder* argument was passed, the entry rides on the
        predictor (``pred.tuning``) for the batcher's scalar knobs, and
        ``health(name)`` shows a ``tuning`` section.  Precedence
        everywhere: explicit argument > exported env var > tuned store >
        registered default.

        *quantize* (``"int8"`` / ``"int8-weight-only"`` / a
        :class:`~mxnet_tpu_torch.quantize.QuantizePolicy` / ``None``)
        lowers the model through ``quantize`` before building the rungs.
        Weight+activation mode needs ranges: pass *calib* (a
        ``CalibTable`` or a saved table's path) or *calib_batches*
        (representative batches to calibrate on at load).  Every rung is
        then gated against an fp32 predictor of the same model: its
        program must run int8 products (``int8-weight-only``: dequantize
        int8 weights), as its build counted them, and its answers must
        be within the policy's thresholds; otherwise the load fails with
        a typed :class:`~mxnet_tpu_torch.quantize.QuantizationError` and
        nothing is installed.  ``health(name)`` grows a ``quantization``
        section."""
        from ..quantize import QuantizePolicy
        policy = QuantizePolicy.coerce(quantize)
        tuning = self._tuning_entry(name, ctx)
        if ladder is None and tuning:
            rungs = (tuning.get("config") or {}).get("ladder")
            if rungs:
                ladder = BucketLadder(batches=rungs)

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
            qreport = None
            serve_symbol, serve_args, serve_aux = \
                symbol, arg_params, aux_params
            if policy is not None:
                serve_symbol, serve_args, serve_aux, qreport = \
                    self._quantize_build(name, symbol, arg_params,
                                         aux_params, policy, calib,
                                         calib_batches, ctx)
            pred = CompiledPredictor(
                serve_symbol, serve_args, aux_params=serve_aux,
                data_shapes=data_shapes, ladder=ladder,
                data_dtypes=data_dtypes, ctx=ctx, name=name,
                bucket_inputs=bucket_inputs)
            if warm:
                if not replacing:
                    self._board.transition(name, "warming")
                built = pred.warm()
            else:
                built = 0
            if policy is not None:
                self._gate_quantized(
                    name, pred, symbol, arg_params, aux_params,
                    data_shapes=data_shapes, data_dtypes=data_dtypes,
                    ctx=ctx, bucket_inputs=bucket_inputs, policy=policy,
                    report=qreport)
        except Exception as exc:
            if not replacing:
                self._board.drop(name)
            _obs_events.emit("serve", kind="load_failed", model=name,
                             error="%s: %s" % (type(exc).__name__,
                                               str(exc)[:200]))
            raise
        pred.tuning = tuning
        with self._lock:
            _check_not_alias()      # racing alias() may have won
            displaced = self._models.get(name)
            old_batcher = self._batchers.pop(name, None)
            if name not in self._models:
                _MODELS_GAUGE.inc()  # delta: aggregates across registries
            was_q = displaced is not None and \
                getattr(displaced, "quantization", None) is not None
            if policy is not None and not was_q:
                _QUANT_MODELS_GAUGE.inc()
            elif was_q and policy is None:
                _QUANT_MODELS_GAUGE.dec()
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
                         warm=bool(warm), buckets=list(pred.ladder.batches),
                         **dict(({"tuned": True} if tuning else {}),
                                **({"quantized": policy.mode}
                                   if policy else {})))
        return pred

    @staticmethod
    def _tuning_entry(name, ctx, workload="serve"):
        """The active TuningStore's entry for *name* on *ctx*'s device kind
        (default: the current context's), or None when no store is
        configured or no entry matches.  A configured but unreadable store
        propagates loudly."""
        from ..autotune.store import lookup
        return lookup(name, workload, device=Context(ctx) if ctx is not None
                      else current_context())

    # -- quantized loading -------------------------------------------------
    @staticmethod
    def _quantize_build(name, symbol, arg_params, aux_params, policy,
                        calib, calib_batches, ctx):
        """Lower the fp32 model per *policy*.  Resolves the calibration
        source (table object > saved table path > calibrate on
        *calib_batches* now, on *ctx*) and returns the quantized
        (symbol, args, aux, report)."""
        from ..quantize import (CalibTable, QuantizationError, calibrate,
                                quantize_model)
        table = None
        if policy.needs_calib:
            if isinstance(calib, CalibTable):
                table = calib
            elif isinstance(calib, str):
                table = CalibTable.load(calib)
            elif calib is not None:
                raise QuantizationError(
                    "calib must be a CalibTable or a saved table path, "
                    "got %s" % type(calib).__name__)
            elif calib_batches is not None:
                table = calibrate(symbol, arg_params, calib_batches,
                                  aux_params=aux_params, name=name, ctx=ctx)
            else:
                raise QuantizationError(
                    "load(%r, quantize='int8') needs calibration ranges: "
                    "pass calib= (CalibTable or path) or calib_batches="
                    % name)
        return quantize_model(symbol, arg_params, calib=table,
                              policy=policy, aux_params=aux_params,
                              name=name, ctx=ctx)

    @staticmethod
    def _gate_quantized(name, pred, symbol, arg_params, aux_params,
                        data_shapes, data_dtypes, ctx, bucket_inputs,
                        policy, report):
        """Load-time gate: at every rung the quantized predictor must (a)
        provably run int8 compute — its program's build counted int8
        products (``int8``) or dequantized int8 weights
        (``int8-weight-only``) — and (b) agree with an fp32 reference
        predictor within the policy's thresholds.  A failure increments
        ``quant_accuracy_gate_failures_total`` and raises typed.  On
        success the report, with per-rung gate numbers and int8 work,
        rides on ``pred.quantization`` for ``health()``."""
        import numpy as _np
        from ..base import dtype_name
        from ..quantize import (QuantizationError, hlo_has_int8_compute,
                                hlo_has_int8_tensors, int8_work)
        ref = CompiledPredictor(
            symbol, arg_params, aux_params=aux_params,
            data_shapes=data_shapes, ladder=pred.ladder,
            data_dtypes=data_dtypes, ctx=ctx, name="%s-fp32ref" % name,
            bucket_inputs=bucket_inputs)
        proof = hlo_has_int8_compute if policy.mode == "int8" \
            else hlo_has_int8_tensors
        # not seed 0: parameters drawn from RandomState(0) share their
        # leading draws with a seed-0 gate stream, which makes the first
        # gate row an outlier far outside any calibrated range
        rng = _np.random.RandomState(0x5EED)
        rungs = {}
        worst_err = 0.0
        worst_top1 = None

        def _fail(why):
            _QUANT_GATE_FAILURES.inc()
            _obs_events.emit("quantize", kind="gate_failed", model=name,
                             mode=policy.mode, error=why)
            raise QuantizationError(
                "model %r failed the quantization gate: %s" % (name, why))

        try:
            for b in pred.ladder.batches:
                if not proof(pred, b):
                    _fail("rung %d: no int8 %s in its program" % (
                        b, "products" if policy.mode == "int8"
                        else "tensors"))
                errs, agree = [], []
                for _ in range(max(1, policy.gate_batches)):
                    data = {n: rng.standard_normal(
                        (b,) + tuple(s[1:])).astype(
                            dtype_name(pred._data_dtypes[n]))
                        for n, s in pred._data_shapes.items()}
                    q_out = pred.predict(data)
                    f_out = ref.predict(data)
                    for qo, fo in zip(q_out, f_out):
                        # reduced where the answers lie: the same float32
                        # max |q - f| and argmax as on the host, without
                        # reading an LM's logits back
                        qa, fa = qo._data, fo._data
                        denom = float(fa.abs().max()) or 1.0
                        errs.append(float((qa - fa).abs().max()) / denom)
                        if fa.dim() == 2 and fa.shape[1] > 1:
                            agree.append(float((qa.argmax(1) ==
                                                fa.argmax(1)).double()
                                               .mean()))
                err = max(errs)
                top1 = min(agree) if agree else None
                rungs[b] = {"rel_err": round(err, 6),
                            "top1_agreement": top1,
                            "work": int8_work(pred, b),
                            "fp32_work": int8_work(ref, b)}
                worst_err = max(worst_err, err)
                if top1 is not None:
                    worst_top1 = top1 if worst_top1 is None \
                        else min(worst_top1, top1)
                if err > policy.max_rel_err:
                    _fail("rung %d: rel err %.4f > %.4f vs fp32"
                          % (b, err, policy.max_rel_err))
                if policy.min_top1_agreement is not None and \
                        top1 is not None and \
                        top1 < policy.min_top1_agreement:
                    _fail("rung %d: top-1 agreement %.4f < %.4f vs fp32"
                          % (b, top1, policy.min_top1_agreement))
        finally:
            del ref
        pred.quantization = {
            "mode": policy.mode,
            "calib_sha": report.get("calib_sha"),
            "layers": report.get("layers"),
            "passthrough": report.get("passthrough"),
            "covered": report.get("covered"),
            "total": report.get("total"),
            "policy": policy.to_dict(),
            "gate": {"max_rel_err": round(worst_err, 6),
                     "min_top1_agreement": worst_top1,
                     "rungs": rungs},
        }
        _obs_events.emit(
            "quantize", kind="gate", model=name, mode=policy.mode,
            covered=report.get("covered"), total=report.get("total"),
            max_rel_err=round(worst_err, 6), rungs=sorted(rungs),
            calib_sha=(report.get("calib_sha") or "")[:12] or None)

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
            if getattr(pred, "quantization", None) is not None:
                _QUANT_MODELS_GAUGE.dec()
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
        tuning = getattr(pred, "tuning", None)
        if tuning:
            from ..config import get_env
            info["tuning"] = {
                "workload": tuning.get("workload"),
                "device_kind": tuning.get("device_kind"),
                "config": tuning.get("config"),
                "score": tuning.get("score"),
                "baseline_score": tuning.get("baseline_score"),
                "gain_pct": tuning.get("gain_pct"),
                "source": get_env("MXNET_TUNING_STORE"),
            }
            if batcher is not None:
                # what applied after env-wins resolution: an exported env
                # var makes this differ from config
                info["tuning"]["applied"] = {
                    "ladder": list(pred.ladder.batches),
                    "max_wait_ms": batcher._max_wait * 1e3,
                    "max_batch": batcher._max_batch,
                }
        quant = getattr(pred, "quantization", None)
        if quant:
            info["quantization"] = {
                "mode": quant.get("mode"),
                "calib_sha": quant.get("calib_sha"),
                "covered": quant.get("covered"),
                "total": quant.get("total"),
                "layers": quant.get("layers"),
                "gate": quant.get("gate"),
            }
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
