"""Environment-knob registry (port of ``mxnet_tpu/config.py``, subset: the
knobs that serving, decode, the fleet, the kernel build, the sanitizer
bridge, events and chaos read).

Every knob is declared here with type, default and doc, and read at call
time (not import time) so tests can monkeypatch the environment.  A read
resolves, in precedence order:

1. **explicit env** — the variable is exported in ``os.environ``; an
   operator's export always wins,
2. **per-call tuned value** — ``resolve_env(name, tuned)``, how one
   model's ``TuningStore`` entry participates,
3. **tuned override** — a value installed by :func:`tuned_override`
   (the process-wide tuned layer),
4. **registered default** — the ``register_env`` declaration.

An explicit argument of the caller's sits above all of them.
"""

from __future__ import annotations

import os

__all__ = ["register_env", "get_env", "resolve_env", "env_is_set",
           "tuned_override", "tuned_overrides", "clear_tuned"]

_REGISTRY = {}

# the tuned-override layer: knob name -> typed value, between the
# environment and the registered default
_TUNED = {}


class _Knob:
    __slots__ = ("name", "type", "default", "doc")

    def __init__(self, name, typ, default, doc):
        self.name = name
        self.type = typ
        self.default = default
        self.doc = doc


def register_env(name, typ, default, doc):
    """Declare an environment knob (type in {int, float, str, bool})."""
    _REGISTRY[name] = _Knob(name, typ, default, doc)
    return _REGISTRY[name]


def _coerce(knob, value):
    if knob.type is bool and isinstance(value, str):
        return value.lower() not in ("0", "false", "off", "")
    try:
        return knob.type(value)
    except (TypeError, ValueError):
        raise ValueError("env %s=%r is not a valid %s"
                         % (knob.name, value, knob.type.__name__))


def get_env(name):
    """Read a registered knob: explicit env > tuned override > registered
    default (typed at every layer)."""
    return resolve_env(name)


def resolve_env(name, tuned=None):
    """Read a registered knob with an explicit per-call tuned value.

    Precedence: exported env var > *tuned* argument > the process-wide
    :func:`tuned_override` layer > registered default.  ``None`` means
    "no per-call tuning"."""
    knob = _REGISTRY[name]
    raw = os.environ.get(name)
    if raw is not None:
        return _coerce(knob, raw)
    if tuned is not None:
        return _coerce(knob, tuned)
    if name in _TUNED:
        return _TUNED[name]
    return knob.default


def env_is_set(name):
    """Is the knob's variable explicitly exported?"""
    return os.environ.get(name) is not None


def tuned_override(name, value):
    """Install a tuned value for a registered knob.  It applies to every
    later read unless the env var is exported (explicit env always wins).
    Returns the typed value installed."""
    knob = _REGISTRY[name]
    _TUNED[name] = _coerce(knob, value)
    return _TUNED[name]


def tuned_overrides():
    """The currently installed tuned layer (a copy)."""
    return dict(_TUNED)


def clear_tuned(name=None):
    """Drop one tuned override (or all of them with no argument)."""
    if name is None:
        _TUNED.clear()
    else:
        _TUNED.pop(name, None)



# ---------------------------------------------------------------------------
# Knob declarations (the JAX package's names, types and defaults).
# ---------------------------------------------------------------------------

register_env("MXNET_SAN", str, "",
             "graftsan runtime sanitizer components to enable: comma "
             "list of race,recompile,donation,transfer,sched, or 'all'; "
             "empty = off.  The sanitizer suite is not ported: setting "
             "a component makes the port's factories raise")
register_env("MXNET_OBS", str, "",
             "Structured run-event categories to record to "
             "events.jsonl: comma list (serve, chaos, retry, warning, "
             "...) or 'all'; empty = off (no file, zero per-event cost)")
register_env("MXNET_OBS_PATH", str, "events.jsonl",
             "Path of the structured run-event log (created lazily on "
             "the first recorded event)")
register_env("MXNET_OBS_RATE", int, 200,
             "Max run events recorded per second; excess events are "
             "counted and surfaced as 'dropped' on the next admitted "
             "event (0 = uncapped)")
register_env("MXNET_CHAOS", str, "",
             "Fault-injection spec for the chaos harness, e.g. "
             "'dispatch_raise_at=1,slow_dispatch_ms=400'; 'on' enables "
             "the harness with nothing armed; empty = off")
register_env("MXNET_SERVE_MAX_WAIT_MS", float, 2.0,
             "How long the serve DynamicBatcher holds a non-full "
             "batch open for more arrivals, measured from the oldest "
             "queued request (milliseconds, monotonic clock); 0 = "
             "dispatch immediately, no coalescing window")
register_env("MXNET_SERVE_MAX_BATCH", int, 0,
             "Row cap per coalesced serve batch; 0 = the model's "
             "bucket-ladder top rung")
register_env("MXNET_SERVE_MAX_QUEUE", int, 1024,
             "Admission control: max requests waiting in one serve "
             "DynamicBatcher — submit past the cap raises a typed "
             "OverloadError instead of queueing unboundedly; "
             "0 = unbounded")
register_env("MXNET_SERVE_MAX_QUEUE_BYTES", int, 1 << 28,
             "Admission control: max payload bytes waiting in one "
             "serve DynamicBatcher; 0 = unbounded")
register_env("MXNET_SERVE_DEFAULT_DEADLINE_MS", float, 0.0,
             "Default per-request serving deadline (milliseconds, "
             "monotonic clock) applied when submit() passes none: an "
             "expired request is shed before padding and dispatch and "
             "its future resolves with DeadlineExceededError; "
             "0 = no deadline")
register_env("MXNET_SERVE_DISPATCHER_RESTARTS", int, 3,
             "How many serve dispatcher-thread crashes (an exception "
             "escaping the batching loop, not a per-batch dispatch "
             "failure) are restarted with jittered backoff before the "
             "batcher declares itself unhealthy and fails every "
             "queued future")
register_env("MXNET_SERVE_DRAIN_TIMEOUT", float, 30.0,
             "Default bound (seconds) on graceful drain: how long "
             "Registry.drain / unload(drain=True) / an alias-cutover "
             "flush waits for accepted serve requests to finish")
register_env("MXNET_SERVE_KV_BLOCK_SIZE", int, 16,
             "Tokens per paged KV-cache block (serve.kvpool): the "
             "granularity decode sessions allocate cache memory at — "
             "smaller blocks waste less tail memory per session, "
             "larger blocks mean fewer scatter rows per tick")
register_env("MXNET_SERVE_KV_BLOCKS", int, 256,
             "Paged KV pool capacity in blocks (per decode engine, "
             "including the reserved null block): bounds TOTAL cache "
             "memory across every concurrent decode session; an "
             "admission that cannot get its blocks sheds with a "
             "typed KVPoolExhausted")
register_env("MXNET_SERVE_DECODE_MAX_WAIT_MS", float, 2.0,
             "How long an IDLE decode batcher holds its first tick "
             "open for more sessions to arrive (milliseconds, "
             "monotonic clock) so co-arriving sessions share one "
             "session-count rung from the start; once decoding, "
             "ticks run back-to-back and joins land between ticks")
register_env("MXNET_SERVE_DECODE_REBUILDS", int, 2,
             "How many decode tick-loop crashes a DecodeBatcher "
             "survives by quarantine-and-rebuild: the suspect KVPool "
             "is quarantined, a fresh same-shape pool takes over its "
             "tensors, zeroed in place, so the already-built "
             "tick/prefill programs run it (zero new compiles), and "
             "journaled sessions are re-admitted via re-prefill + "
             "replayed ticks; past the budget the batcher degrades to "
             "unhealthy typed-fail")
register_env("MXNET_SUBGRAPH_BACKEND", str, "",
             "Subgraph property applied at bind time (see "
             "mxnet_tpu_torch.subgraph)")
register_env("MXNET_MODULE_FUSED_STEP", bool, True,
             "Module.forward_backward_update runs forward + backward + "
             "the optimizer update as one program when eligible (one "
             "CUDA graph on the card); off = always run the legacy "
             "per-parameter Updater loop")
register_env("MXNET_GUARD_NONFINITE", bool, False,
             "Skip optimizer updates whose loss/gradients contain "
             "NaN/Inf: the fused step's non-finite check keeps params, "
             "optimizer state and aux bit-identical on a bad step")
register_env("MXNET_GUARD_READBACK_LAG", int, 0,
             "Async non-finite-guard accounting on the fused step: "
             "defer the skipped flag's readback by up to this many "
             "steps (resolved FIFO; drained at epoch end); 0 = "
             "synchronous")
register_env("MXNET_GUARD_MAX_BAD_STEPS", int, 0,
             "With the non-finite guard on, this many CONSECUTIVE "
             "skipped steps trigger the divergence action (raise, or a "
             "callable given to Module.set_nonfinite_guard); 0 = count "
             "and skip only")
register_env("MXNET_DEVICE_PREFETCH", int, 0,
             "Ring depth of fit()'s DevicePrefetcher: how many batches "
             "a background thread reads ahead and copies onto the "
             "training device (pinned staging, its own CUDA stream) "
             "while the step runs; 0 = off.  fit(device_prefetch=...) "
             "overrides it")
register_env("MXNET_USE_NATIVE_RECORDIO", bool, True,
             "Read .rec files through the native C++ reader "
             "(src/io/recordio_reader.cc, built at first use); off = "
             "pure Python")
register_env("MXNET_TPU_NATIVE_DECODE", bool, True,
             "ImageRecordIter sends plain classification configs "
             "(resize, crop, mirror, mean/std) to the native libjpeg "
             "decode team (src/io/jpeg_decode_pool.cc, built at first "
             "use); off = the cv2 augmenter chain")
register_env("MXNET_DATALOADER_RESPAWNS", int, 2,
             "How many crashed DataLoader worker processes are "
             "respawned (with backoff, lost batches resubmitted) "
             "before the loader gives up and raises")
register_env("MXNET_OPTSTATE_MISMATCH", str, "raise",
             "What load_optimizer_states does when the blob was written "
             "by another optimizer class or hyper-parameter signature: "
             "'raise' or 'reinit' (warn and start from fresh state)")
register_env("MXNET_TUNING_STORE", str, "",
             "Path of the autotuner's JSON TuningStore (python -m "
             "mxnet_tpu_torch.autotune writes it).  When set, "
             "ModelRegistry.load / DynamicBatcher / DecodeEngine consult "
             "it for the winning config keyed (model_name, device_kind, "
             "workload); an exported env var still beats a stored "
             "tuning; empty = no store")
register_env("MXNET_SERVE_HTTP_PORT", int, 0,
             "Per-replica HTTP probe port (serve.replica): serves "
             "/metrics (Prometheus exposition of the process metrics "
             "registry), /healthz (liveness) and /readyz (readiness "
             "+ per-model health JSON) over stdlib http.server so "
             "the fleet router and any external orchestrator can "
             "scrape it; 0 = probe server off (the fleet passes an "
             "explicit port when it spawns replicas)")
register_env("MXNET_SERVE_HEDGE_MS", float, 0.0,
             "Router-side request hedging: after this many "
             "milliseconds without an answer, re-issue the still-"
             "pending predict (SAME request id) to a second replica "
             "— first typed answer wins, the loser is cancelled "
             "through the replica's idempotency window so no request "
             "is ever dispatched twice on one replica or answered "
             "twice; 0 = hedging off")
register_env("MXNET_SERVE_RPC_TIMEOUT", float, 60.0,
             "Per-call socket timeout (seconds) on router->replica "
             "RPCs: a replica that dies mid-reply surfaces as a "
             "transport failure the router fails over, instead of "
             "hanging the caller; 0 = no timeout")
register_env("MXNET_SERVE_ROUTER_RETRIES", int, 3,
             "Total transport attempts per routed request (first "
             "try + failovers): a connection failure retries the "
             "SAME (client, seq, incarnation) request id on the "
             "next eligible replica — wrapping around to an "
             "already-tried replica only when no fresh one is left, "
             "where the dedup window answers a retried id from "
             "cache instead of re-dispatching")
register_env("MXNET_SERVE_BREAKER_FAILURES", int, 3,
             "Consecutive transport failures that open one "
             "replica's router-side circuit breaker (no requests "
             "routed while open)")
register_env("MXNET_SERVE_BREAKER_COOLDOWN", float, 1.0,
             "Seconds an open circuit breaker waits before letting "
             "ONE half-open trial request through; success closes "
             "the breaker, failure re-opens it for another cooldown")
register_env("MXNET_SERVE_FLEET_HEARTBEAT", float, 0.5,
             "Router health-probe cadence (seconds): each replica "
             "is probed with a HEALTH RPC this often, feeding "
             "readiness-aware routing and heartbeat-staleness "
             "ejection")
register_env("MXNET_SERVE_EJECT_TIMEOUT", float, 5.0,
             "Seconds without a successful health probe before the "
             "router ejects a replica from the rotation (breaker "
             "forced open); the next successful probe rejoins it")
register_env("MXNET_SERVE_DEDUP_WINDOW", int, 256,
             "Per-client replica-side idempotency window: how many "
             "recent predict request ids each replica remembers so "
             "a retried or hedged RPC is answered from cache "
             "instead of re-dispatched (in-flight entries are "
             "never trimmed)")
register_env("MXNET_COMPILE_CACHE_DIR", str, "",
             "Directory of the built kernel libraries (nvcc's and "
             "g++'s, with their logs): where a kernel is looked up "
             "before it is compiled and where a new build lands; "
             "empty = build/torch_kernels/ at the root of the "
             "checkout.  A serve.Fleet points every replica at one "
             "directory, so a replica after the first builds nothing")
