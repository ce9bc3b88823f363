"""Successive-halving search over a config space, measured cost only
(port of ``mxnet_tpu/autotune/search.py``).

The loop (TVM's lesson, sized for a knob space rather than a kernel
schedule space):

1. **Propose** — the space's default config plus random samples
   (dedup by canonical config key).
2. **Prune on the analytic prior** — when the measurer provides one
   (roofline pricing of each rung's flops and bytes + a
   deterministic replay of the coalescing discipline), candidates
   whose estimated objective is dominated — worse than
   ``prune_ratio`` x the best estimate — are dropped WITHOUT paying
   a measurement.  The prior only ever prunes, never picks: every
   surviving ranking decision is measured.
3. **Short replays** — every survivor replays the first
   ``short_frac`` of the trace; rank by the objective.
4. **Neighborhood proposals** — local perturbations of the
   short-round leader join at short budget (prior-pruned too).
5. **Promote** — the top ``1/eta`` (>= ``min_promote``) graduate to
   FULL replays; the winner is the best full-replay score.
6. **Baseline guard** — the space default is ALWAYS measured at full
   budget on the same trace; if no candidate beats it, the default
   IS the winner (gain 0) — tuning can only help, never regress.

Every trial emits an ``autotune`` event (trial_start / trial_result
/ pruned / promoted / winner, each with the config and score) and
bumps ``autotune_trials_total`` / ``autotune_prune_total``; the
winning entry is persisted to the :class:`TuningStore` WITH its
measurement artifact (winner + baseline + trace identity + search
stats).
"""

from __future__ import annotations

import math
import random

from ..observability import events as _obs_events
from ..observability import metrics as _obs_metrics

__all__ = ["Objective", "serve_objective", "decode_objective",
           "tune", "INFEASIBLE"]

_TRIALS_TOTAL = _obs_metrics.counter(
    "autotune_trials_total",
    "autotune candidate measurements paid (short + full replays)")
_PRUNE_TOTAL = _obs_metrics.counter(
    "autotune_prune_total",
    "autotune candidates pruned by the analytic-cost prior without "
    "a measurement")

INFEASIBLE = float("inf")


class Objective(object):
    """Scores a measurement artifact; LOWER IS ALWAYS BETTER (a
    maximize-this metric negates).  ``spec`` is the JSON-able
    description persisted with the winning entry."""

    def __init__(self, name, score_fn, spec=None):
        self.name = name
        self._score_fn = score_fn
        self.spec = dict(spec or {}, name=name)

    def score(self, measurement):
        if not measurement or not measurement.get("ok"):
            return INFEASIBLE
        if measurement.get("request_path_compiles"):
            # a config that compiles in the request path is broken,
            # not slow — it must never win
            return INFEASIBLE
        s = self._score_fn(measurement)
        return INFEASIBLE if s is None else float(s)

    def gain_pct(self, winner_score, baseline_score):
        """Relative improvement of winner over baseline (positive =
        better), on the objective's own scale."""
        if not math.isfinite(winner_score) or \
                not math.isfinite(baseline_score) or \
                baseline_score == 0:
            return 0.0
        return round((baseline_score - winner_score)
                     / abs(baseline_score) * 100.0, 2)


def serve_objective(throughput_floor=0.85):
    """p99 latency under a throughput floor: a candidate whose
    achieved rate fell below ``floor x offered`` shed or stalled its
    way to a pretty p99 and is infeasible."""
    floor = float(throughput_floor)

    def score(m):
        offered = m.get("offered_rps")
        achieved = m.get("achieved_rps")
        if offered and (achieved or 0.0) < floor * offered:
            return None
        return m.get("p99_ms")

    return Objective("serve_p99_ms", score,
                     spec={"throughput_floor": floor,
                           "metric": "p99_ms", "mode": "min"})


def decode_objective():
    """Aggregate decode throughput (tokens/sec, maximized)."""
    def score(m):
        tps = m.get("tokens_per_sec")
        return -tps if tps else None

    return Objective("decode_neg_tokens_per_sec", score,
                     spec={"metric": "tokens_per_sec", "mode": "max"})


def _jsonable(config):
    return {k: (list(v) if isinstance(v, tuple) else v)
            for k, v in config.items()}


def _ev_score(score):
    return None if not math.isfinite(score) else round(score, 4)


def tune(space, measurer, objective, *, model, workload,
         trials=12, neighbor_trials=4, seed=0, short_frac=0.25,
         eta=2, min_promote=2, prune_ratio=3.0, min_keep=4,
         store=None, device=None, log=None):
    """Run the search; returns the result dict (and persists the
    winning entry when *store* is given).

    Parameters
    ----------
    space : ConfigSpace
    measurer : object with ``measure(config, budget_frac)`` and
        ``prior(config, budget_frac) -> float | None`` (None = no
        prior, nothing pruned).
    objective : Objective
    model, workload : str
        The store key (with *device*, default-detected).
    trials : int
        Random proposals measured at short budget (incl. default).
    neighbor_trials : int
        Neighborhood proposals around the short-round leader.
    short_frac : float
        Trace fraction of the cheap screening replays.
    eta, min_promote : successive-halving promotion shape.
    prune_ratio, min_keep : analytic-prior pruning (a candidate is
        pruned when its estimate exceeds ``prune_ratio`` x the best
        estimate, but at least ``min_keep`` candidates survive).
    """
    rng = random.Random(seed)
    log = log or (lambda *_a: None)

    def emit(**fields):
        _obs_events.emit("autotune", **fields)

    def propose_random(count, seen):
        out = []
        attempts = 0
        while len(out) < count and attempts < count * 20:
            attempts += 1
            cand = space.sample(rng)
            k = space.key(cand)
            if k not in seen:
                seen.add(k)
                out.append(cand)
        return out

    def prior_prune(cands, keep_always):
        """Split candidates into (kept, pruned) on the analytic
        prior.  *keep_always* keys are never pruned (the default
        config: it is the baseline, it must be measured)."""
        priors = []
        for c in cands:
            try:
                priors.append(measurer.prior(c, short_frac))
            except Exception:
                priors.append(None)
        known = [p for p in priors if p is not None]
        if not known:
            return cands, []
        best = min(known)
        ranked = sorted(range(len(cands)),
                        key=lambda i: (priors[i]
                                       if priors[i] is not None
                                       else best))
        keep_floor = {i for i in ranked[:min_keep]}
        kept, pruned = [], []
        for i, c in enumerate(cands):
            p = priors[i]
            dominated = (p is not None and best > 0
                         and p > prune_ratio * best
                         and i not in keep_floor
                         and space.key(c) not in keep_always)
            if dominated:
                pruned.append((c, p))
            else:
                kept.append(c)
        for c, p in pruned:
            _PRUNE_TOTAL.inc()
            emit(kind="pruned", model=model, workload=workload,
                 config=_jsonable(c), prior=round(p, 4),
                 prior_best=round(best, 4))
            log("pruned (prior %.2f vs best %.2f): %r"
                % (p, best, _jsonable(c)))
        return kept, pruned

    def run_trial(config, budget):
        _TRIALS_TOTAL.inc()
        emit(kind="trial_start", model=model, workload=workload,
             config=_jsonable(config), budget_frac=budget)
        try:
            meas = measurer.measure(config, budget)
        except Exception as exc:
            meas = {"ok": False,
                    "error": "%s: %s" % (type(exc).__name__,
                                         str(exc)[:200])}
        s = objective.score(meas)
        emit(kind="trial_result", model=model, workload=workload,
             config=_jsonable(config), budget_frac=budget,
             score=_ev_score(s), ok=bool(meas.get("ok")))
        log("trial budget=%.2f score=%s %r"
            % (budget, _ev_score(s), _jsonable(config)))
        return meas, s

    default = space.default()
    default_key = space.key(default)
    seen = {default_key}
    candidates = [default] + propose_random(max(0, trials - 1), seen)

    kept, pruned_round1 = prior_prune(candidates, {default_key})
    n_pruned = len(pruned_round1)

    # -- short replays (screening) --------------------------------------
    short = [(c,) + run_trial(c, short_frac) for c in kept]
    short.sort(key=lambda t: t[2])

    # -- neighborhood proposals around the leader -----------------------
    leader = short[0][0]
    neigh = []
    for cand in space.neighbors(leader, rng):
        k = space.key(cand)
        if k not in seen:
            seen.add(k)
            neigh.append(cand)
        if len(neigh) >= neighbor_trials:
            break
    neigh, pruned_n = prior_prune(neigh, set())
    n_pruned += len(pruned_n)
    short += [(c,) + run_trial(c, short_frac) for c in neigh]
    short.sort(key=lambda t: t[2])

    # -- promotion to full replays --------------------------------------
    feasible = [t for t in short if math.isfinite(t[2])]
    n_promote = max(min_promote, int(math.ceil(len(short) / eta)))
    promoted = feasible[:n_promote] or short[:1]
    for c, _m, s in promoted:
        emit(kind="promoted", model=model, workload=workload,
             config=_jsonable(c), short_score=_ev_score(s))

    full = {}
    for c, _m, _s in promoted:
        meas, s = run_trial(c, 1.0)
        full[space.key(c)] = (c, meas, s)

    # the baseline (space default) always gets a full-budget
    # measurement on the same trace — the gain is quoted against it
    if default_key in full:
        baseline_meas, baseline_score = full[default_key][1:]
    else:
        baseline_meas, baseline_score = run_trial(default, 1.0)

    winner, winner_meas, winner_score = min(
        full.values(), key=lambda t: t[2])
    if not math.isfinite(winner_score) or \
            winner_score > baseline_score:
        # nothing beat the default on the full replay: the default IS
        # the winner — a tuning run must never ship a regression
        winner, winner_meas, winner_score = \
            default, baseline_meas, baseline_score

    gain = objective.gain_pct(winner_score, baseline_score)
    n_trials = len(short) + len(full) + \
        (0 if default_key in full else 1)
    result = {
        "model": model, "workload": workload,
        "device_kind": device or _device(),
        "config": winner,
        "score": _ev_score(winner_score),
        "baseline_config": default,
        "baseline_score": _ev_score(baseline_score),
        "gain_pct": gain,
        "trials": n_trials,
        "pruned": n_pruned,
        "objective": objective.spec,
        "measurement": winner_meas,
        "baseline": baseline_meas,
        "trace": measurer.trace.summary(),
        "search": {"seed": seed, "trials": n_trials,
                   "pruned": n_pruned, "short_frac": short_frac,
                   "eta": eta, "promoted": len(full)},
    }
    emit(kind="winner", model=model, workload=workload,
         config=_jsonable(winner), score=_ev_score(winner_score),
         baseline_score=_ev_score(baseline_score), gain_pct=gain,
         trials=n_trials, pruned=n_pruned)
    log("winner score=%s baseline=%s gain=%.2f%% %r"
        % (_ev_score(winner_score), _ev_score(baseline_score), gain,
           _jsonable(winner)))

    if store is not None:
        entry = store.put(
            model, workload, _jsonable(winner),
            device=result["device_kind"],
            score=result["score"],
            baseline_score=result["baseline_score"],
            gain_pct=gain, objective=objective.spec,
            trace=result["trace"], measurement=winner_meas,
            baseline=baseline_meas, search=result["search"])
        store.save()
        result["entry"] = entry
        result["store_path"] = store.path
    return result


def _device():
    from .store import device_kind
    return device_kind()
