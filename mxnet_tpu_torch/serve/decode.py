"""Continuous-batching LLM decode over the paged KV pool (port of
``mxnet_tpu/serve/decode.py``).

The dense :class:`~.predictor.DecodeSession` decodes one sequence per
program: N concurrent sessions pay N dispatches per token and N
worst-case caches.  This module makes decode a served,
continuously-batched workload:

* :class:`DecodeEngine` — builds one **decode-tick** program per
  session-count rung of a :class:`~.buckets.BucketLadder` and one
  **prefill** program per sequence rung, all against a shared
  :class:`~.kvpool.KVPool`.  The tick program gathers each session's
  dense cache view through its block table, runs the model's step, and
  scatters back only the block the new token landed in.  On the card a
  program is one CUDA graph, captured at construction (:meth:`warm`)
  over static table/position/input buffers, so the request path never
  captures; on the CPU it is the eager body.  The pool is updated in
  place by ``index_copy_`` into the tensors the graphs captured.
* :class:`PagedSession` — one live decode: host-side block table,
  position cursor and delivered-token stream.
* :class:`DecodeBatcher` — the continuous-batching tick loop: sessions
  join and leave *between* ticks, one dispatch + one device-to-host
  readback serves every active session's next token.  Prefill
  dispatches run between ticks through their own bucketed programs, so
  a long prompt costs one dispatch instead of stalling the tick loop
  for L rounds.
* :class:`SpeculativeDecoder` — (opt-in) a small draft engine proposes
  K tokens; the target verifies all K in ONE verify dispatch (the K
  steps unrolled in one program), accepting the matched prefix plus
  one corrected token.  Greedy speculative decode gives plain greedy
  decode's stream, because rejected cache positions are beyond-position
  garbage the step contract already ignores.

Step contract (what a model plugs in)::

    step_fn(params, view, inputs, pos) -> (out, new_view)

* ``view``: dict of dense per-session cache views, leaves
  ``(S, padded_len) + per_token_shape`` gathered from the pool (the
  engine's own copy: the step may write it in place and return it);
* ``inputs``: ``{name: (S,) + input_shape}`` this tick's per-session
  inputs; ``pos``: ``(S,) int32`` tokens already cached per session;
* the step must write **exactly at position** ``pos`` (one token per
  tick) and must mask everything at positions ``>= pos+1`` out of its
  outputs — positions beyond a session's cursor hold co-tenant garbage
  by design;
* on the card the step runs under CUDA graph capture: no host reads.

    prefill_fn(params, inputs, length) -> view

* ``inputs``: ``{name: (1, Lr) + input_shape}`` the prompt *prefix*
  (everything but its last token), zero-padded to the sequence rung
  ``Lr``; ``length`` is the real prefix length (a 0-d int32 tensor);
  the returned view (leaves ``(1, Lr) + per_token_shape``) is scattered
  into the session's blocks.  The prompt's last token then rides the
  first regular decode tick, so every emitted token comes from a tick
  program.

Fault tolerance: every session rides an idempotent append-only
:class:`DecodeJournal` record — identity ``(client, session_seq,
incarnation)``, prompt, sampling config, params sha and the
accepted-token log — so greedy decode is deterministically resumable
from prompt + accepted tokens via ONE re-prefill plus replayed ticks
(delivery suppressed, each replayed output bit-checked against the
journal).  A tick-loop crash quarantines the suspect pool; a fresh
same-shape :class:`~.kvpool.KVPool` takes over its tensors, zeroed in
place, so the already-built programs run it (zero new builds,
asserted), and journaled sessions are re-admitted — bounded by
``MXNET_SERVE_DECODE_REBUILDS``, past which the batcher degrades to
unhealthy typed-fail.

Knobs left unset resolve explicit env > the ``MXNET_TUNING_STORE``
entry keyed (label, device kind, "decode") > registered default.

Not ported: the IR-audit hooks and the lowered-text accessors (the port
lowers to no StableHLO; they raise :class:`~.buckets.ServeError`).
"""

from __future__ import annotations

import collections
import hashlib
import logging
import time as _time

import numpy as _np
import torch

from .buckets import (BucketLadder, DeadlineExceededError,
                      RequestCancelled, ServeError)
from .graphs import capture, on_stream
from .kvpool import KVPool, KVPoolExhausted, as_device
from .. import sanitizer as _san
from ..base import np_dtype, torch_dtype
from ..ndarray import NDArray
from ..ndarray.ndarray import _from_numpy, _to_numpy
from ..observability import events as _obs_events
from ..observability import metrics as _obs_metrics
from ..resilience import servechaos as _servechaos

__all__ = ["DecodeEngine", "PagedSession", "DecodeBatcher",
           "DecodeJournal", "SpeculativeDecoder"]

log = logging.getLogger(__name__)

# module-level instrument refs (hot path discipline); the dispatch and
# compile instruments are the predictor's — get-or-create shares them
_ACTIVE_SESSIONS = _obs_metrics.gauge(
    "serve_decode_active_sessions",
    "live paged decode sessions (admitted and not yet finished/"
    "failed/cancelled) across all decode engines (delta-maintained)")
_DECODE_STEPS = _obs_metrics.counter(
    "serve_decode_steps_total",
    "batched decode-tick dispatches (one serves every active "
    "session's next token)")
_DECODE_TOKENS = _obs_metrics.counter(
    "serve_decode_tokens_total",
    "tokens delivered to decode sessions")
_TOKEN_SECONDS = _obs_metrics.histogram(
    "serve_decode_token_seconds",
    "per-token latency: time between successive token deliveries of "
    "a session (first token: admission to delivery)")
_DISPATCH_SECONDS = _obs_metrics.histogram(
    "serve_dispatch_seconds",
    "host-side latency of one serve dispatch (one graph replay on the "
    "card)")
_COMPILES_TOTAL = _obs_metrics.counter(
    "serve_compiles_total",
    "rung programs built (CUDA graph captures on the card); flat after "
    "warmup or the request path is building programs")
_FAILOVERS_TOTAL = _obs_metrics.counter(
    "serve_decode_failovers_total",
    "decode sessions re-opened on another replica after their "
    "replica died / ejected / drained (router-side journal resume)")
_REBUILDS_TOTAL = _obs_metrics.counter(
    "serve_decode_rebuilds_total",
    "decode pool quarantine-and-rebuild cycles after a tick-loop "
    "crash (bounded by MXNET_SERVE_DECODE_REBUILDS)")
_RESUMED_TOTAL = _obs_metrics.counter(
    "serve_decode_resumed_sessions_total",
    "journaled decode sessions re-admitted via re-prefill + replayed "
    "ticks")


def _ceil_div(a, b):
    return -(-int(a) // int(b))


def _leaves(tree):
    """The leaves of a tree of dicts (sorted keys), lists and tuples."""
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [l for t in tree for l in _leaves(t)]
    return [] if tree is None else [tree]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, t) for t in tree)
    return None if tree is None else fn(tree)


def _token_bytes(out):
    """Canonical byte identity of one step-output tree — the journal
    replay bit-equality check (and the speculative accept test)."""
    return tuple(_np.asarray(leaf).tobytes() for leaf in _leaves(out))


def _host(tree):
    """A tree of device tensors as host numpy (one readback a leaf)."""
    return _tree_map(_to_numpy, tree)


class _Spec:
    """Shape and dtype of one input or cache leaf (host and device)."""

    __slots__ = ("shape", "np", "torch")

    def __init__(self, spec):
        self.shape = tuple(int(d) for d in spec.shape)
        self.torch = torch_dtype(spec.dtype)
        self.np = np_dtype(self.torch)


class _EagerProgram:
    """A decode program on the CPU: the eager body over its buffers."""

    def __init__(self, body, buffers):
        self._body = body
        self._buffers = buffers
        self.captured = {}
        self.replays = 0

    def __call__(self, host):
        for n, a in host.items():
            self._buffers[n].copy_(_from_numpy(_np.asarray(a)))
        with torch.no_grad():
            outs = self._body(self._buffers)
        self.replays += 1
        return outs


class _GraphProgram:
    """A decode program on the card: one CUDA graph captured over static
    buffers, replayed on its engine's stream (callers hold the engine's
    lock).  ``captured`` holds the kernel launches its capture recorded,
    ``replays`` counts its replays."""

    def __init__(self, eng, graph, body, buffers, outputs, captured):
        self._eng = eng
        self._graph = graph
        self._body = body             # the eager body the graph captured
        self._buffers = buffers
        self._outputs = outputs
        self.captured = captured
        self.replays = 0

    def __call__(self, host):
        with on_stream(self._eng._dev, self._eng._stream):
            for n, a in host.items():
                self._buffers[n].copy_(_from_numpy(_np.asarray(a)))
            self._graph.replay()
        self.replays += 1
        return self._outputs


class JournalRecord:
    """One session's journal entry: identity, everything needed to
    re-prefill, and the accepted-token log."""

    __slots__ = ("client", "seq", "incarnation", "prompt", "length",
                 "max_new_tokens", "sampling", "params_sha", "tokens",
                 "closed", "reason")

    def __init__(self, client, seq, incarnation, prompt, length,
                 max_new_tokens, sampling, params_sha):
        self.client = client
        self.seq = int(seq)
        self.incarnation = int(incarnation)
        self.prompt = prompt          # {name: (L,)+shape} host arrays
        self.length = int(length)
        self.max_new_tokens = max_new_tokens
        self.sampling = sampling      # e.g. {"mode": "greedy"}
        self.params_sha = params_sha
        self.tokens = []              # accepted host output trees
        self.closed = False
        self.reason = None

    @property
    def key(self):
        return (self.client, self.seq)


class DecodeJournal:
    """Idempotent append-only record of decode sessions — the resume
    source of truth.

    Each record carries the session identity ``(client, session_seq,
    incarnation)``, the normalized prompt, the sampling config, the
    engine's params sha and the accepted-token log.  ``append`` is
    idempotent by token index (a replayed tick re-appending token *i* is
    a no-op; a gap is a bug and raises), so crash-retried writers never
    double-log.  Greedy decode is deterministically resumable from a
    record: one re-prefill of the prompt prefix plus replayed ticks
    feeding the journaled tokens reproduces the interrupted stream.

    Used in-process by :class:`DecodeEngine` (direct ``DecodeBatcher``
    sessions, key ``("local", sid, 0)``).  Closed records are kept for a
    bounded window so late duplicates can still be answered from the
    log."""

    def __init__(self, label="journal", keep_closed=64):
        self.label = label
        self._keep_closed = int(keep_closed)
        self._lock = _san.lock(label="serve.decode.journal.%s" % label)
        self._records = collections.OrderedDict()
        _san.track(self, ("_records",),
                   label="serve.decode.journal.%s" % label)

    def open(self, client, seq, incarnation, prompt, length,
             max_new_tokens=None, sampling=None, params_sha=None):
        """Open (or re-open) a record — idempotent on ``(client, seq)``:
        a retried OPEN returns the existing record; a resume under a
        bumped *incarnation* updates the stamp and keeps the
        accepted-token log."""
        key = (client, int(seq))
        with self._lock:
            rec = self._records.get(key)
            if rec is not None:
                if int(incarnation) > rec.incarnation:
                    rec.incarnation = int(incarnation)
                return rec
            rec = JournalRecord(client, seq, incarnation, prompt, length,
                                max_new_tokens,
                                sampling or {"mode": "greedy"}, params_sha)
            self._records[key] = rec
            self._trim_locked()
            return rec

    def append(self, key, index, token):
        """Log accepted token *index* — idempotent: re-appending an
        already-logged index is a no-op, a gap raises (accepted tokens
        are never lost, so a gap means the caller skipped one)."""
        with self._lock:
            rec = self._records.get((key[0], int(key[1])))
            if rec is None or rec.closed:
                return
            index = int(index)
            if index < len(rec.tokens):
                return            # duplicate (replayed tick) — no-op
            if index > len(rec.tokens):
                raise ServeError(
                    "decode journal %r: token %d appended with %d "
                    "logged — the accepted-token log has a gap"
                    % (self.label, index, len(rec.tokens)))
            rec.tokens.append(token)

    def record(self, key):
        with self._lock:
            return self._records.get((key[0], int(key[1])))

    def tokens(self, key):
        """The accepted-token log (a copy) — the replay source."""
        with self._lock:
            rec = self._records.get((key[0], int(key[1])))
            return list(rec.tokens) if rec is not None else []

    def close(self, key, reason):
        """Mark a record terminal (idempotent).  Kept for the closed
        window, then trimmed."""
        with self._lock:
            rec = self._records.get((key[0], int(key[1])))
            if rec is None or rec.closed:
                return
            rec.closed = True
            rec.reason = reason
            self._trim_locked()

    def live_records(self):
        """Records not yet terminal — what a rebuild must re-admit (or
        fail typed)."""
        with self._lock:
            return [r for r in self._records.values() if not r.closed]

    def _trim_locked(self):
        closed = [k for k, r in self._records.items() if r.closed]
        while len(closed) > self._keep_closed:
            self._records.pop(closed.pop(0), None)


class PagedSession:
    """One live paged decode: block table, position cursor, and the
    delivered token stream.  Engine-owned fields (``pos``, ``blocks``,
    ``table``, ``pending_input``) are mutated only under the engine lock
    by the tick/prefill path; readers use the delivery methods, which
    synchronize on the session's own condition."""

    _NEXT_SID = [0]
    _SID_LOCK = _san.lock(label="serve.decode.sid")

    def __init__(self, engine, prompt, length, blocks, table,
                 max_new_tokens, stop_fn, deadline):
        with self._SID_LOCK:
            self._NEXT_SID[0] += 1
            self.sid = self._NEXT_SID[0]
        self._engine = engine
        self.prompt = prompt          # {name: (L,) + input_shape} host
        self.length = int(length)
        self.blocks = blocks          # pool block ids, growth in ticks
        self.table = table            # np int32 (max_blocks,)
        self.pos = 0                  # set by prefill; tokens cached
        self.pending_input = None     # next tick's {name: host array}
        self.max_new_tokens = max_new_tokens
        self.stop_fn = stop_fn
        self._deadline = deadline     # monotonic; bounds time-to-join
        self.journal_key = None       # (client, seq) — set by admit
        self._replay = collections.deque()  # journaled outs to replay
        self._base = 0                # tokens emitted before a resume
        self._cond = _san.condition(
            label="serve.decode.session%d" % self.sid)
        self._outputs = []
        self._stamps = []             # monotonic delivery stamp/token
        self._queue = collections.deque()
        self._done = False
        self._released = False
        self._cancel = False
        self._error = None
        self.finish_reason = None
        self._t_enq = _time.monotonic()
        self._t_last = None
        _san.track(self, ("_outputs", "_queue", "_done", "_released",
                          "_cancel", "_error"),
                   label="serve.decode.session%d" % self.sid)

    # -- caller side --------------------------------------------------------
    def done(self):
        with self._cond:
            return self._done

    @property
    def error(self):
        with self._cond:
            return self._error

    @property
    def token_count(self):
        with self._cond:
            return len(self._outputs)

    def outputs(self):
        """Everything delivered so far — readable even after a typed
        mid-stream failure (accepted steps are never lost)."""
        with self._cond:
            return list(self._outputs)

    def stamps(self):
        """Monotonic delivery timestamp per token (open-loop latency
        accounting)."""
        with self._cond:
            return list(self._stamps)

    def next_output(self, timeout=None):
        """Block for the next token.  Raises the session's typed error
        after a failure, ``StopIteration`` after a clean finish,
        ``TimeoutError`` on *timeout*."""
        deadline = None if timeout is None \
            else _time.monotonic() + timeout
        with self._cond:
            while not self._queue and not self._done:
                remaining = None if deadline is None \
                    else deadline - _time.monotonic()
                if remaining is not None and remaining <= 0:
                    raise TimeoutError(
                        "decode session %d: no token after %ss"
                        % (self.sid, timeout))
                self._cond.wait(remaining)
            if self._queue:
                return self._queue.popleft()
            if self._error is not None:
                raise self._error
            raise StopIteration("decode session %d finished (%s)"
                                % (self.sid, self.finish_reason))

    def output_at(self, i, timeout=None):
        """Non-consuming read of delivered token *i* (0-based in this
        session's delivered stream): blocks until it exists, the session
        finishes short of it, or *timeout*.  Raises the typed error
        after a failure, ``StopIteration`` when the stream finished
        before index *i*, ``TimeoutError`` on *timeout*."""
        i = int(i)
        deadline = None if timeout is None \
            else _time.monotonic() + timeout
        with self._cond:
            while True:
                if len(self._outputs) > i:
                    return self._outputs[i]
                if self._done:
                    if self._error is not None:
                        raise self._error
                    raise StopIteration(
                        "decode session %d finished (%s) at %d "
                        "token(s)" % (self.sid, self.finish_reason,
                                      len(self._outputs)))
                remaining = None if deadline is None \
                    else deadline - _time.monotonic()
                if remaining is not None and remaining <= 0:
                    raise TimeoutError(
                        "decode session %d: token %d not delivered "
                        "after %ss" % (self.sid, i, timeout))
                self._cond.wait(remaining)

    def result(self, timeout=None):
        """Wait for the session to finish; returns the full output
        stream, or raises the typed failure."""
        deadline = None if timeout is None \
            else _time.monotonic() + timeout
        with self._cond:
            while not self._done:
                remaining = None if deadline is None \
                    else deadline - _time.monotonic()
                if remaining is not None and remaining <= 0:
                    raise TimeoutError(
                        "decode session %d still live after %ss"
                        % (self.sid, timeout))
                self._cond.wait(remaining)
            if self._error is not None:
                raise self._error
            return list(self._outputs)

    def cancel(self):
        """Abandon the session.  The engine releases its blocks at the
        next tick boundary; pending readers get a typed
        :class:`RequestCancelled`.  Tokens already delivered stay
        readable via :meth:`outputs`."""
        with self._cond:
            if self._done:
                return False
            self._cancel = True
        return True

    @property
    def cancelled(self):
        with self._cond:
            return self._cancel

    @property
    def resuming(self):
        """True while journaled tokens are still being replayed (the
        session is catching its cache up; delivery is suppressed)."""
        return bool(self._replay)

    # -- engine side --------------------------------------------------------
    def _deliver(self, out, now):
        with self._cond:
            _TOKEN_SECONDS.observe(
                now - (self._t_last if self._t_last is not None
                       else self._t_enq))
            self._t_last = now
            self._outputs.append(out)
            self._stamps.append(now)
            self._queue.append(out)
            self._cond.notify_all()


class DecodeEngine:
    """Tick/prefill programs over one shared :class:`KVPool`.

    Parameters
    ----------
    step_fn, prefill_fn : callables
        The model's decode step / prompt prefill (module docstring
        contract).  ``prefill_fn`` may be None when every prompt has
        length 1 (pure generation).
    token_spec : dict name -> spec
        One token's cache slice per leaf (the pool layout); a spec has
        ``shape`` and ``dtype`` (a meta tensor, say).
    input_spec : dict name -> spec
        Per-session, per-tick inputs (e.g. the previous token id).
    params : dict name -> array, optional
        Model parameters, moved to the pool's device.  Defaults to
        *predictor*'s parameters when attached (shared: the predictor's
        ``set_params`` is seen by the next tick).
    predictor : CompiledPredictor, optional
        Attach for registry lifecycle (unload/cutover drain this engine)
        and shared compile accounting.
    max_len : int
        Longest sequence a session may reach; rounded up to a whole
        number of blocks (:attr:`padded_len` — the dense-view length
        every step program sees).
    session_rungs : sequence of int, optional
        Session-count rungs of the tick ladder (one program each).
        Default ``(1, 2, 4, 8, 16)``.
    prefill_rungs : sequence of int, optional
        Sequence rungs of the prefill programs; each must be a multiple
        of the block size.  Default: block-size powers-of-two up to
        :attr:`padded_len`.
    next_input_fn : callable, optional
        Maps a delivered (host) step output to the next tick's input
        dict.  Default: identity when the output tree matches
        ``input_spec``.
    spec_k : int
        When > 0, also build the K-token speculative **verify** program
        (see :class:`SpeculativeDecoder`).
    donate : bool, optional
        Accepted for the reference's signature and ignored: the pool is
        always updated in place.
    device : Context or torch.device, optional
        Default: the predictor's device, else the current context
        (``gpu(0)``, which raises without CUDA).
    """

    def __init__(self, step_fn, prefill_fn=None, token_spec=None,
                 input_spec=None, params=None, predictor=None,
                 max_len=None, block_size=None, num_blocks=None,
                 session_rungs=None, prefill_rungs=None,
                 next_input_fn=None, spec_k=0, donate=None,
                 device=None, label="decode", warm=True):
        from ..config import resolve_env

        if step_fn is None or token_spec is None or not input_spec:
            raise ServeError("DecodeEngine needs step_fn, token_spec "
                             "and input_spec")
        if max_len is None:
            raise ServeError("DecodeEngine needs max_len (the longest "
                             "sequence a session may reach)")
        self.label = label
        # tuned-store consultation: an explicit constructor argument
        # always wins; a knob left None falls to exported env > tuned
        # entry keyed (label, device kind, "decode") > registered default
        self.tuning = self._tuning_entry(
            label, as_device(device) if device is not None else
            (predictor._dev if predictor is not None else None))
        tcfg = (self.tuning or {}).get("config") or {}
        if block_size is None:
            block_size = resolve_env("MXNET_SERVE_KV_BLOCK_SIZE",
                                     tcfg.get("MXNET_SERVE_KV_BLOCK_SIZE"))
        if num_blocks is None:
            num_blocks = resolve_env("MXNET_SERVE_KV_BLOCKS",
                                     tcfg.get("MXNET_SERVE_KV_BLOCKS"))
        if session_rungs is None:
            session_rungs = tuple(tcfg.get("ladder") or (1, 2, 4, 8, 16))
        self._step_fn = step_fn
        self._prefill_fn = prefill_fn
        self._predictor = predictor
        if predictor is not None and device is None:
            device = predictor._dev
        self._dev = as_device(device)
        self._pool = KVPool(token_spec, num_blocks=num_blocks,
                            block_size=block_size, device=self._dev)
        bs = self._pool.block_size
        self.block_size = bs
        self.padded_len = _ceil_div(max_len, bs) * bs
        self.max_blocks = self.padded_len // bs
        if self.max_blocks > self._pool.blocks_total:
            self._pool.close()
            raise ServeError(
                "a full-length session needs %d blocks but the pool "
                "only has %d allocatable — grow MXNET_SERVE_KV_BLOCKS "
                "or shrink max_len" % (self.max_blocks,
                                       self._pool.blocks_total))
        self.ladder = BucketLadder(batches=session_rungs)
        if prefill_rungs is None:
            rungs, r = [], bs
            while r < self.padded_len:
                rungs.append(r)
                r *= 2
            rungs.append(self.padded_len)
            prefill_rungs = rungs
        self.prefill_rungs = tuple(sorted({int(r) for r in prefill_rungs}))
        for r in self.prefill_rungs:
            if r < bs or r % bs or r > self.padded_len:
                self._pool.close()
                raise ServeError(
                    "prefill rung %d must be a multiple of the block "
                    "size %d within padded_len %d"
                    % (r, bs, self.padded_len))
        if self.prefill_rungs and \
                self.prefill_rungs[-1] != self.padded_len:
            self.prefill_rungs = self.prefill_rungs + (self.padded_len,)
        self._input_spec = {n: _Spec(s) for n, s in input_spec.items()}
        self._next_input_fn = next_input_fn
        self.spec_k = int(spec_k)
        if params is None:
            if predictor is None:
                self._pool.close()
                raise ServeError("DecodeEngine needs params (or an "
                                 "attached predictor to take them "
                                 "from)")
            params = predictor._params
        self._params = {n: self._put(a) for n, a in params.items()}

        self._lock = _san.lock(label="serve.decode.%s" % label)
        self._tick_progs = {}
        self._prefill_progs = {}
        self._verify_prog = None
        self._compiles = 0
        self._dispatches = 0
        self._live = []               # admitted, not yet released
        self._batchers = []
        self._closed = False
        self._journal = DecodeJournal(label)
        self._params_sha_cache = None
        self._sha_lock = _san.lock(label="serve.decode.sha.%s" % label)
        self._rebuilds = 0            # pool quarantine-and-rebuilds
        self._graph_pool = None       # the programs' CUDA graph pool
        self._stream = None           # capture and replay stream
        _san.track(self, ("_tick_progs", "_prefill_progs", "_compiles",
                          "_dispatches", "_live", "_closed"),
                   label="serve.decode.%s" % label)
        if predictor is not None:
            predictor._decode_engines.append(self)
        if warm:
            self.warm()
        # the journal's stamp reads every parameter back to the host:
        # pay it here, not in the first admission
        self.params_sha()

    def _put(self, a):
        if isinstance(a, NDArray):
            a = a._data
        if not isinstance(a, torch.Tensor):
            a = _from_numpy(_np.asarray(a))
        return a.to(self._dev)

    @staticmethod
    def _tuning_entry(label, device, workload="decode"):
        """The active TuningStore's entry for (label, *device*'s kind,
        *workload*), or None (no store, or no entry)."""
        from ..autotune.store import lookup
        return lookup(label, workload, device=device)

    # -- introspection -------------------------------------------------------
    @property
    def compile_count(self):
        """Programs built so far (CUDA graph captures on the card)."""
        return self._compiles

    @property
    def dispatch_count(self):
        with self._lock:
            return self._dispatches

    @property
    def pool(self):
        return self._pool

    @property
    def device(self):
        return self._dev

    @property
    def active_sessions(self):
        with self._lock:
            return len(self._live)

    @property
    def journal(self):
        """The engine's in-process :class:`DecodeJournal`."""
        return self._journal

    @property
    def rebuild_count(self):
        with self._lock:
            return self._rebuilds

    def _programs(self):
        progs = list(self._tick_progs.values()) + \
            list(self._prefill_progs.values())
        return progs + ([self._verify_prog] if self._verify_prog else [])

    def graph_launches(self, kind=None):
        """{kernel: launches the programs ran}: the kernel launches each
        capture recorded times its replays, over every program (or the
        programs of *kind*: "tick", "prefill" or "verify").  A replay
        calls no kernel wrapper, so the wrappers' ``launches`` do not
        see these."""
        with self._lock:
            progs = {"tick": list(self._tick_progs.values()),
                     "prefill": list(self._prefill_progs.values()),
                     "verify": [self._verify_prog]
                     if self._verify_prog else []}
            chosen = [p for k, ps in progs.items() if kind in (None, k)
                      for p in ps]
            out = {}
            for p in chosen:
                for k, c in p.captured.items():
                    out[k] = out.get(k, 0) + c * p.replays
        return out

    def captured_launches(self, kind, rung=None):
        """The kernel launches one program's capture recorded ({} on
        the CPU): *kind* "tick" (rung: sessions), "prefill" (rung:
        tokens) or "verify"."""
        prog = self._verify_prog if kind == "verify" else \
            {"tick": self._tick_progs,
             "prefill": self._prefill_progs}[kind].get(int(rung))
        if prog is None:
            raise ServeError("decode %r has no %s program %s"
                             % (self.label, kind, rung))
        return dict(prog.captured)

    def params_sha(self):
        """sha256 over the host bytes of every parameter (computed once,
        at construction, and cached) — the journal's model-identity
        stamp."""
        with self._sha_lock:
            if self._params_sha_cache is None:
                h = hashlib.sha256()
                for n in sorted(self._params):
                    h.update(_to_numpy(self._params[n]).tobytes())
                self._params_sha_cache = h.hexdigest()[:16]
            return self._params_sha_cache

    def _not_ported(self, what):
        raise ServeError("%s is not ported: the port lowers to no "
                         "StableHLO (decode %r)" % (what, self.label))

    def tick_lowered_text(self, rung):
        self._not_ported("tick_lowered_text")

    def prefill_lowered_text(self, rung):
        self._not_ported("prefill_lowered_text")

    def verify_lowered_text(self):
        self._not_ported("verify_lowered_text")

    def lower_tick_text(self, S):
        self._not_ported("lower_tick_text")

    def lower_prefill_text(self, Lr):
        self._not_ported("lower_prefill_text")

    # -- programs -------------------------------------------------------------
    def _count_compile(self, kind, key, seconds, captured):
        self._compiles += 1
        _COMPILES_TOTAL.inc()
        if self._predictor is not None:
            with self._predictor._lock:
                self._predictor._compiles += 1
        _obs_events.emit("serve", kind="compile", model=self.label,
                         decoder=kind, rung=key,
                         graph=self._dev.type == "cuda",
                         launches=captured, seconds=round(seconds, 4))

    def _buffers(self, shapes):
        """Static device buffers {name: zeros} for {name: (shape,
        torch dtype)}."""
        return {n: torch.zeros(s, dtype=dt, device=self._dev)
                for n, (s, dt) in shapes.items()}

    def _input_buffers(self, lead):
        return {"in:" + n: (lead + sp.shape, sp.torch)
                for n, sp in self._input_spec.items()}

    def _build(self, kind, key, body, shapes):
        """One program over static buffers of *shapes*: on the card the
        CUDA graph captured on the engine's stream into its graph pool
        after one eager run on the zero buffers (graphs.py; the pool's
        null block takes that run's writes); on the CPU the eager body.
        Caller holds the lock."""
        t0 = _time.perf_counter()
        buffers = self._buffers(shapes)
        if self._dev.type != "cuda":
            prog = _EagerProgram(body, buffers)
        else:
            if self._graph_pool is None:
                self._graph_pool = torch.cuda.graph_pool_handle()
                self._stream = torch.cuda.Stream(self._dev)
            graph, outputs, captured = capture(
                self._dev, self._graph_pool, self._stream,
                lambda: body(buffers),
                "decode %r, %s program %s" % (self.label, kind, key))
            prog = _GraphProgram(self, graph, body, buffers, outputs,
                                 captured)
        self._count_compile(kind, key, _time.perf_counter() - t0,
                            prog.captured)
        return prog

    def _tick_body(self, S):
        bs, nb, L = self.block_size, self.max_blocks, self.padded_len
        step_fn = self._step_fn

        def body(buf):
            table = buf["table"].long()
            pos = buf["pos"]
            pool = self._pool.arrays
            view = {k: p[table].reshape((S, L) + tuple(p.shape[2:]))
                    for k, p in pool.items()}
            out, new_view = step_fn(
                self._params, view,
                {n: buf["in:" + n] for n in self._input_spec}, pos)
            idx = torch.arange(S, device=table.device)
            blk = pos.long() // bs                # (S,) block-in-seq
            blk_ids = table[idx, blk]             # (S,) pool block ids
            for k, p in pool.items():
                nvb = new_view[k].reshape((S, nb, bs) + tuple(p.shape[2:]))
                p.index_copy_(0, blk_ids, nvb[idx, blk].to(p.dtype))
            return out
        return body

    def _build_tick(self, S):
        shapes = {"table": ((S, self.max_blocks), torch.int32),
                  "pos": ((S,), torch.int32)}
        shapes.update(self._input_buffers((S,)))
        self._tick_progs[S] = self._build("tick", S, self._tick_body(S),
                                          shapes)

    def _prefill_body(self, Lr):
        bs, nbr = self.block_size, Lr // self.block_size
        prefill_fn = self._prefill_fn

        # prefill_fn returns leaves (1, Lr) + token_shape; drop the
        # session axis, split into whole blocks and scatter them into
        # the session's table (tail entries point at the null block —
        # their garbage lands where no session reads)
        def body(buf):
            view = prefill_fn(self._params,
                              {n: buf["in:" + n] for n in self._input_spec},
                              buf["length"])
            table = buf["table"][:nbr].long()
            for k, p in self._pool.arrays.items():
                p.index_copy_(0, table, view[k][0].reshape(
                    (nbr, bs) + tuple(p.shape[2:])).to(p.dtype))
            return None
        return body

    def _build_prefill(self, Lr):
        shapes = {"table": ((self.max_blocks,), torch.int32),
                  "length": ((), torch.int32)}
        shapes.update(self._input_buffers((1, Lr)))
        self._prefill_progs[Lr] = self._build(
            "prefill", Lr, self._prefill_body(Lr), shapes)

    def _verify_body(self):
        bs, nb, L, K = (self.block_size, self.max_blocks, self.padded_len,
                        self.spec_k)
        step_fn = self._step_fn

        # the K steps unrolled (the reference scans them): each reads
        # the view the previous one wrote
        def body(buf):
            table = buf["table"].long()
            pos0 = buf["pos"]
            pool = self._pool.arrays
            view = {k: p[table].reshape((1, L) + tuple(p.shape[2:]))
                    for k, p in pool.items()}
            outs = []
            for i in range(K):
                inp = {n: buf["in:" + n][i:i + 1] for n in self._input_spec}
                out, view = step_fn(self._params, view, inp,
                                    (pos0 + i).reshape(1))
                outs.append(out)
            for k, p in pool.items():
                p.index_copy_(0, table, view[k][0].reshape(
                    (nb, bs) + tuple(p.shape[2:])).to(p.dtype))
            return _stack(outs)
        return body

    def _build_verify(self):
        shapes = {"table": ((self.max_blocks,), torch.int32),
                  "pos": ((), torch.int32)}
        shapes.update(self._input_buffers((self.spec_k,)))
        self._verify_prog = self._build("verify", self.spec_k,
                                        self._verify_body(), shapes)

    def warm(self):
        """Build every tick/prefill (and verify) program not built yet
        and prime each new one with one run on its zero buffers, so the
        first real session pays no one-time setup.  The zero tables
        point every write at the null block.  Returns programs built."""
        before = self._compiles
        with self._lock:
            for S in self.ladder.batches:
                if S not in self._tick_progs:
                    self._build_tick(S)
            if self._prefill_fn is not None:
                for Lr in self.prefill_rungs:
                    if Lr not in self._prefill_progs:
                        self._build_prefill(Lr)
            if self.spec_k > 0 and self._verify_prog is None:
                self._build_verify()
            for prog in self._programs():
                if prog.replays == 0:
                    prog({})
            if self._stream is not None:
                self._stream.synchronize()
        return self._compiles - before

    # -- session lifecycle ---------------------------------------------------
    def _normalize_prompt(self, prompt):
        if not isinstance(prompt, dict):
            if len(self._input_spec) != 1:
                raise ServeError(
                    "decode %r has %d inputs — pass a prompt dict"
                    % (self.label, len(self._input_spec)))
            prompt = {next(iter(self._input_spec)): prompt}
        out, length = {}, None
        for n, sp in self._input_spec.items():
            if n not in prompt:
                raise ServeError("decode %r: prompt is missing input "
                                 "%r" % (self.label, n))
            a = prompt[n]
            if isinstance(a, NDArray):
                a = a.asnumpy()
            elif isinstance(a, torch.Tensor):
                a = _to_numpy(a)
            a = _np.asarray(a)
            if a.dtype != sp.np:
                a = a.astype(sp.np)
            if a.shape[1:] != sp.shape:
                raise ServeError(
                    "decode %r prompt input %r: per-token shape %s "
                    "does not match the spec %s"
                    % (self.label, n, a.shape[1:], sp.shape))
            if length is None:
                length = a.shape[0]
            elif a.shape[0] != length:
                raise ServeError("decode %r: prompt inputs disagree "
                                 "on length" % self.label)
            out[n] = a
        if not length:
            raise ServeError("decode %r: empty prompt" % self.label)
        if length > self.padded_len:
            raise ServeError(
                "decode %r: prompt length %d exceeds padded_len %d"
                % (self.label, length, self.padded_len))
        return out, length

    def admit(self, prompt, max_new_tokens=None, stop_fn=None,
              deadline_ms=None, journal_key=None, incarnation=0,
              resume_tokens=None):
        """Admission: validate the prompt, allocate its blocks (typed
        :class:`KVPoolExhausted` when the pool cannot hold it — shed at
        the front door), register the session and open its journal
        record.  Prefill/decode have not run yet — call :meth:`prefill`
        (the batcher does).

        *journal_key* is the ``(client, session_seq)`` identity (a
        direct session defaults to ``("local", sid)``); *incarnation*
        bumps on every resume.  *resume_tokens* (journaled host output
        trees) arms replay: after re-prefill the session replays them
        through ordinary ticks with delivery suppressed, each replayed
        output bit-checked."""
        prompt, length = self._normalize_prompt(prompt)
        with self._lock:
            if self._closed:
                raise ServeError("decode engine %r is closed"
                                 % self.label)
        n0 = _ceil_div(length, self.block_size)
        table = _np.zeros((self.max_blocks,), _np.int32)
        blocks = self._pool.alloc(n0, owner=self.label)
        table[:n0] = blocks
        deadline = (_time.monotonic() + float(deadline_ms) / 1e3
                    if deadline_ms else None)
        sess = PagedSession(self, prompt, length, blocks, table,
                            max_new_tokens, stop_fn, deadline)
        sess.journal_key = tuple(journal_key) if journal_key \
            else ("local", sess.sid)
        if resume_tokens:
            sess._replay = collections.deque(resume_tokens)
            sess._base = len(resume_tokens)
        rec = self._journal.open(
            sess.journal_key[0], sess.journal_key[1], incarnation,
            prompt, length, max_new_tokens=max_new_tokens,
            params_sha=self.params_sha())
        if resume_tokens and not rec.tokens:
            # a resume journaled elsewhere: seed the local log so
            # replayed ticks dedup against it
            rec.tokens.extend(resume_tokens)
        with self._lock:
            if self._closed:
                self._pool.free(blocks)
                raise ServeError("decode engine %r is closed"
                                 % self.label)
            self._live.append(sess)
        _ACTIVE_SESSIONS.inc()
        _obs_events.emit("decode", kind="journal", sid=sess.sid,
                         model=self.label, client=str(rec.client),
                         session_seq=rec.seq,
                         incarnation=rec.incarnation,
                         params_sha=rec.params_sha,
                         tokens_logged=len(rec.tokens))
        _obs_events.emit("decode", kind="session_start", sid=sess.sid,
                         model=self.label, prompt_len=length,
                         blocks=n0, max_new_tokens=max_new_tokens,
                         resume=bool(resume_tokens))
        return sess

    def prefill(self, sess):
        """Run the session's bucketed prefill dispatch (the prompt
        prefix, everything but its last token) and arm the first decode
        tick.  One dispatch regardless of prompt length."""
        with self._lock:
            if sess.done():
                return
            prefix = sess.length - 1
            if prefix > 0:
                if self._prefill_fn is None:
                    raise ServeError(
                        "decode %r has no prefill_fn but got a prompt of "
                        "length %d — prompts must be single-token"
                        % (self.label, sess.length))
                rung = next(r for r in self.prefill_rungs if r >= prefix)
                host = {"table": sess.table,
                        "length": _np.int32(prefix)}
                for n, sp in self._input_spec.items():
                    buf = _np.zeros((1, rung) + sp.shape, sp.np)
                    buf[0, :prefix] = sess.prompt[n][:prefix]
                    host["in:" + n] = buf
                t0 = _time.perf_counter()
                with _san.transfer_guard("decode prefill (%s)"
                                         % self.label):
                    self._prefill_progs[rung](host)
                _DISPATCH_SECONDS.observe(_time.perf_counter() - t0)
                self._dispatches += 1
            sess.pos = prefix
            sess.pending_input = {n: sess.prompt[n][sess.length - 1]
                                  for n in self._input_spec}

    def tick(self, sessions):
        """ONE batched decode step for *sessions*: gather, step,
        scatter, readback — every live session's next token from one
        dispatch.  Cancelled sessions are released; a session that needs
        a block the pool cannot give fails typed and releases its
        blocks; finished sessions (max tokens, stop_fn, length cap) are
        released with their reason.  Returns the sessions that actually
        rode the dispatch."""
        _servechaos.on_decode_tick(self.label)
        with self._lock:
            if self._closed:
                raise ServeError("decode engine %r is closed"
                                 % self.label)
            ready = []
            for s in sessions:
                if s.done():
                    continue
                if s.cancelled:
                    self._release_locked(
                        s, "cancelled", RequestCancelled(
                            "decode session %d cancelled by its caller"
                            % s.sid))
                    continue
                if s.pos >= self.padded_len:
                    self._release_locked(s, "length_cap", None)
                    continue
                need = s.pos // self.block_size + 1
                failed = False
                while len(s.blocks) < need:
                    try:
                        blk = self._pool.alloc(1, owner=self.label)
                    except KVPoolExhausted as exc:
                        self._release_locked(s, "pool_exhausted", exc)
                        failed = True
                        break
                    s.blocks.extend(blk)
                    s.table[len(s.blocks) - 1] = blk[0]
                if not failed:
                    ready.append(s)
            if not ready:
                return []
            n = len(ready)
            S = self.ladder.batch_for(n)
            host = {"table": _np.zeros((S, self.max_blocks), _np.int32),
                    "pos": _np.zeros((S,), _np.int32)}
            for nm, sp in self._input_spec.items():
                host["in:" + nm] = _np.zeros((S,) + sp.shape, sp.np)
            for i, s in enumerate(ready):
                host["table"][i] = s.table
                host["pos"][i] = s.pos
                for nm in self._input_spec:
                    host["in:" + nm][i] = s.pending_input[nm]
            t0 = _time.perf_counter()
            with _san.transfer_guard("decode tick (%s)" % self.label):
                outs = self._tick_progs[S](host)
            _DISPATCH_SECONDS.observe(_time.perf_counter() - t0)
            self._dispatches += 1
            _DECODE_STEPS.inc()
            # ONE device->host readback serves every session's token
            host_out = _host(outs)
            now = _time.monotonic()
            for i, s in enumerate(ready):
                out_i = _tree_map(lambda a: a[i], host_out)
                s.pos += 1
                if s._replay:
                    # replayed tick of a resumed session: the token was
                    # accepted (and delivered) before the crash —
                    # bit-check it against the journal, advance the
                    # cache, suppress delivery/counters
                    expect = s._replay.popleft()
                    if _token_bytes(out_i) != _token_bytes(expect):
                        self._release_locked(
                            s, "resume_divergence", ServeError(
                                "decode session %d resume diverged at "
                                "token %d — replayed output is not "
                                "bit-equal to the journal (params or "
                                "program drift)" % (s.sid, s.token_count)))
                        continue
                    s.pending_input = self._feed(out_i)
                    continue
                s._deliver(out_i, now)
                _DECODE_TOKENS.inc()
                self._journal.append(s.journal_key,
                                     s._base + s.token_count - 1, out_i)
                if self._finished(s, out_i):
                    self._release_locked(s, "finished", None)
                else:
                    s.pending_input = self._feed(out_i)
            _obs_events.emit("decode", kind="tick", model=self.label,
                             rung=S, sessions=n)
            return ready

    def _finished(self, s, out):
        if s.max_new_tokens is not None and \
                s._base + s.token_count >= s.max_new_tokens:
            return True
        if s.stop_fn is not None and s.stop_fn(out):
            return True
        return False

    def _feed(self, out):
        if self._next_input_fn is not None:
            return self._next_input_fn(out)
        if isinstance(out, dict) and set(out) == set(self._input_spec):
            return {n: _np.asarray(out[n]).astype(self._input_spec[n].np)
                    for n in out}
        leaves = _leaves(out)
        if len(leaves) == 1 and len(self._input_spec) == 1:
            name, sp = next(iter(self._input_spec.items()))
            a = _np.asarray(leaves[0]).astype(sp.np)
            if a.shape != sp.shape:
                raise ServeError(
                    "decode %r: step output shape %s does not match "
                    "input spec %s — pass next_input_fn"
                    % (self.label, a.shape, sp.shape))
            return {name: a}
        raise ServeError(
            "decode %r: cannot map the step output back to the inputs — "
            "pass next_input_fn" % self.label)

    # -- speculative verify --------------------------------------------------
    def verify(self, sess, tokens):
        """One K-token verify dispatch (``spec_k`` contract): run the
        step at positions ``pos .. pos+K-1`` with *tokens* (host arrays,
        leaves ``(K,) + input_shape``) and return the K step outputs,
        WITHOUT advancing the session — the caller commits the accepted
        prefix via :meth:`spec_commit`.  Rejected positions hold
        beyond-position garbage the next real tick overwrites."""
        if self._verify_prog is None:
            raise ServeError("decode %r was built without spec_k — "
                             "speculative verify is off" % self.label)
        K = self.spec_k
        with self._lock:
            if sess.done():
                raise ServeError("decode session %d is finished"
                                 % sess.sid)
            if sess.pos + K > self.padded_len:
                raise ServeError(
                    "verify of %d tokens at pos %d crosses padded_len "
                    "%d" % (K, sess.pos, self.padded_len))
            need = (sess.pos + K - 1) // self.block_size + 1
            while len(sess.blocks) < need:
                try:
                    blk = self._pool.alloc(1, owner=self.label)
                except KVPoolExhausted:
                    # same typed-fail-and-release rule as tick(): the
                    # session must not keep its blocks (or the
                    # active-sessions gauge) after a growth failure
                    self._release_locked(
                        sess, "pool_exhausted", KVPoolExhausted(
                            "decode session %d exhausted the pool "
                            "growing for a %d-token verify"
                            % (sess.sid, K)))
                    raise
                sess.blocks.extend(blk)
                sess.table[len(sess.blocks) - 1] = blk[0]
            host = {"table": sess.table, "pos": _np.int32(sess.pos)}
            for n, sp in self._input_spec.items():
                a = _np.asarray(tokens[n]).astype(sp.np)
                if a.shape != (K,) + sp.shape:
                    raise ServeError("verify input %r: shape %s != %s"
                                     % (n, a.shape, (K,) + sp.shape))
                host["in:" + n] = a
            t0 = _time.perf_counter()
            with _san.transfer_guard("decode verify (%s)" % self.label):
                outs = self._verify_prog(host)
            _DISPATCH_SECONDS.observe(_time.perf_counter() - t0)
            self._dispatches += 1
            return _host(outs)

    def spec_commit(self, sess, accepted_outs):
        """Commit *accepted_outs* (host per-token output trees, in
        order) after a :meth:`verify`: deliver each, advance the
        cursor, arm the next input from the last one."""
        with self._lock:
            now = _time.monotonic()
            for out in accepted_outs:
                if sess.done():
                    return
                sess.pos += 1
                sess._deliver(out, now)
                _DECODE_TOKENS.inc()
                self._journal.append(sess.journal_key,
                                     sess._base + sess.token_count - 1,
                                     out)
                if self._finished(sess, out):
                    self._release_locked(sess, "finished", None)
                else:
                    sess.pending_input = self._feed(out)

    # -- fault tolerance -----------------------------------------------------
    def rebuild_pool(self):
        """Quarantine the current pool and swap in a fresh, empty
        same-shape one — the crashed-tick recovery primitive.  The fresh
        pool takes over the quarantined pool's tensors, zeroed in place
        (the programs captured their addresses), so every built
        tick/prefill/verify program runs it with ZERO new builds
        (asserted).  Live sessions' block tables are cleared FIRST
        (their ids belong to the quarantined pool and must never be
        freed into the fresh one) — the caller must then
        :meth:`readmit` or :meth:`release` every live session."""
        with self._lock:
            if self._closed:
                raise ServeError("decode engine %r is closed"
                                 % self.label)
            before = self._compiles
            old = self._pool
            for s in self._live:
                with s._cond:
                    s.blocks = []
                s.table = _np.zeros((self.max_blocks,), _np.int32)
                s.pos = 0
                s.pending_input = None
            if self._stream is not None:
                # the zeroing runs behind every replay queued so far
                with torch.cuda.stream(self._stream):
                    self._pool = old.clone_empty(reuse_arrays=True)
                self._stream.synchronize()
            else:
                self._pool = old.clone_empty(reuse_arrays=True)
            old.close()
            self._rebuilds += 1
            if self._compiles != before:
                raise ServeError(
                    "decode %r: pool rebuild built %d new program(s)"
                    % (self.label, self._compiles - before))
        return self._pool

    def readmit(self, sess):
        """Re-admit a live journaled session onto the current (fresh)
        pool after :meth:`rebuild_pool`: fresh prompt blocks (typed
        :class:`KVPoolExhausted` sheds it without wedging the rebuild),
        cursor reset, replay armed from the journal.  The batcher then
        re-prefills it and replays its accepted tokens through ordinary
        ticks — delivery suppressed and bit-checked, so the
        caller-visible stream continues exactly where it stopped."""
        with self._lock:
            if self._closed:
                raise ServeError("decode engine %r is closed"
                                 % self.label)
            if sess.done():
                return sess
            tokens = self._journal.tokens(sess.journal_key) \
                if sess.journal_key is not None else list(sess.outputs())
            n0 = _ceil_div(sess.length, self.block_size)
            blocks = self._pool.alloc(n0, owner=self.label)
            table = _np.zeros((self.max_blocks,), _np.int32)
            table[:n0] = blocks
            with sess._cond:
                sess.blocks = list(blocks)
            sess.table = table
            sess.pos = 0
            sess.pending_input = None
            sess._replay = collections.deque(tokens)
            # the join deadline bounded time-to-FIRST-join; a
            # re-admission must not expire a session that already
            # joined before the crash
            sess._deadline = None
            if sess not in self._live:
                self._live.append(sess)
                _ACTIVE_SESSIONS.inc()
        _RESUMED_TOTAL.inc()
        _obs_events.emit("decode", kind="resume", sid=sess.sid,
                         model=self.label, tokens_replayed=len(tokens))
        return sess

    # -- teardown ------------------------------------------------------------
    def release(self, sess, reason, error=None):
        """Finish a session: free its blocks, resolve its readers (typed
        *error*, or a clean finish), drop it from the live set.
        Serialized with tick/prefill dispatches — blocks are never freed
        under a program that still reads them."""
        with self._lock:
            self._release_locked(sess, reason, error)

    def _release_locked(self, sess, reason, error):
        with sess._cond:
            if sess._released:
                return
            sess._released = True
            blocks, sess.blocks = sess.blocks, []
        self._pool.free(blocks)
        try:
            self._live.remove(sess)
        except ValueError:
            pass
        _ACTIVE_SESSIONS.dec()
        with sess._cond:
            sess._done = True
            sess._error = error
            sess.finish_reason = reason
            sess._cond.notify_all()
        if sess.journal_key is not None:
            self._journal.close(sess.journal_key, reason)
        _obs_events.emit("decode", kind="session_end", sid=sess.sid,
                         model=self.label, reason=reason,
                         tokens=sess.token_count,
                         error=None if error is None
                         else type(error).__name__)

    def close(self):
        """Tear the engine down: fail live sessions typed, release the
        pool (gauges drop), drop the programs.  Close batchers first
        (the registry does)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            for s in list(self._live):
                self._release_locked(
                    s, "closed", ServeError(
                        "decode engine %r closed" % self.label))
            if self._stream is not None:
                self._stream.synchronize()
            self._tick_progs = {}
            self._prefill_progs = {}
            self._verify_prog = None
            self._pool.close()


def _stack(outs):
    """K per-step output trees of leading dim 1 -> one tree of (K, ...)."""
    first = outs[0]
    if isinstance(first, dict):
        return {k: _stack([o[k] for o in outs]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_stack([o[i] for o in outs])
                            for i in range(len(first)))
    return torch.cat(outs, 0)


class DecodeBatcher:
    """The continuous-batching decode tick loop.

    One dispatcher thread owns the engine: it admits queued joins
    (bucketed prefill dispatches), then runs decode ticks over the whole
    active-session set — one dispatch + one readback per tick serves
    every session's next token.  Sessions join and leave between ticks;
    an idle batcher coalesces arrivals for up to
    ``MXNET_SERVE_DECODE_MAX_WAIT_MS`` before the first tick, exactly
    like the predict batcher's window.

    Supervision: a crash escaping the tick loop cannot simply restart
    over the same pool — the pool cannot be trusted after a dispatch
    died mid-update.  Instead the batcher QUARANTINES the suspect pool
    (``engine.rebuild_pool`` swaps in a fresh same-shape one against the
    already-built programs), re-admits every journaled live session via
    re-prefill + replayed ticks (bit-checked; a session the fresh pool
    cannot hold sheds typed without wedging the rebuild) and restarts
    the tick loop on a fresh thread — bounded by
    ``MXNET_SERVE_DECODE_REBUILDS``.  Past the budget it degrades:
    unhealthy forever, every session failed typed."""

    def __init__(self, engine, max_wait_ms=None, name=None,
                 on_state=None, rebuilds=None):
        from ..config import resolve_env
        self._engine = engine
        self.name = name or engine.label
        if max_wait_ms is None:
            tcfg = (getattr(engine, "tuning", None) or {}) \
                .get("config") or {}
            max_wait_ms = resolve_env(
                "MXNET_SERVE_DECODE_MAX_WAIT_MS",
                tcfg.get("MXNET_SERVE_DECODE_MAX_WAIT_MS"))
        self._max_wait = max(0.0, float(max_wait_ms)) / 1e3
        self._on_state = on_state
        if rebuilds is None:
            rebuilds = resolve_env("MXNET_SERVE_DECODE_REBUILDS")
        self._rebuild_budget = max(0, int(rebuilds))
        self._rebuilds = 0
        self._rebuilding = False
        self._lock = _san.lock(label="serve.decode.batcher.%s" % self.name)
        self._cond = _san.condition(self._lock,
                                    label="serve.decode.batcher.%s"
                                    % self.name)
        self._joins = collections.deque()
        self._sessions = []
        # sessions/joins the tick loop has popped into its locals but
        # not yet written back — drain()/close()/_crashed() must see
        # them or a mid-iteration drain returns early and teardown
        # closes the engine under a live session
        self._inflight = ()
        self._stopped = False
        self._draining = False
        self._unhealthy = False
        self._ticks = 0
        self._last_tick = _time.monotonic()
        _san.track(self, ("_joins", "_sessions", "_inflight", "_stopped",
                          "_draining", "_unhealthy", "_rebuilding",
                          "_rebuilds", "_ticks"),
                   label="serve.decode.batcher.%s" % self.name)
        with engine._lock:
            engine._batchers.append(self)
        self._thread = _san.thread(
            target=self._run, name="serve-decode-%s" % self.name,
            daemon=True)
        self._thread.start()

    # -- stats / health ------------------------------------------------------
    @property
    def engine(self):
        return self._engine

    @property
    def tick_count(self):
        with self._lock:
            return self._ticks

    @property
    def session_count(self):
        with self._lock:
            return len(self._sessions) + len(self._joins)

    @property
    def unhealthy(self):
        with self._lock:
            return self._unhealthy

    @property
    def rebuilding(self):
        with self._lock:
            return self._rebuilding

    @property
    def rebuild_count(self):
        with self._lock:
            return self._rebuilds

    @property
    def rebuild_budget(self):
        return self._rebuild_budget

    @property
    def draining(self):
        with self._lock:
            return self._draining

    @property
    def stopped(self):
        """True after close(): a retired batcher, not a failed one."""
        with self._lock:
            return self._stopped

    def dispatcher_alive(self):
        with self._lock:
            thread, unhealthy = self._thread, self._unhealthy
        return bool(thread.is_alive()) and not unhealthy

    def last_tick_age(self):
        with self._lock:
            return _time.monotonic() - self._last_tick

    def health_state(self):
        with self._lock:
            if self._unhealthy:
                return "unhealthy"
            if self._rebuilding:
                return "rebuilding"
            if self._stopped or self._draining:
                return "draining"
            return "ready"

    def rebuild_state(self):
        """The quarantine/rebuild surface for ``health(name)``:
        spent/budgeted rebuild counts and whether a rebuild is in flight
        right now."""
        with self._lock:
            return {"rebuilds": self._rebuilds,
                    "budget": self._rebuild_budget,
                    "rebuilding": self._rebuilding}

    # -- client side ---------------------------------------------------------
    def start(self, prompt, max_new_tokens=None, stop_fn=None,
              deadline_ms=None, journal_key=None, incarnation=0,
              resume_tokens=None):
        """Admit one decode session.  Raises a typed
        :class:`KVPoolExhausted` when the pool cannot hold the prompt
        (shed at submit), a :class:`ServeError` when the batcher is
        draining/closed/unhealthy.  *deadline_ms* bounds time-to-join: a
        session the dispatcher cannot prefill by then is shed typed
        (:class:`~.buckets.DeadlineExceededError`).
        *journal_key*/*incarnation*/*resume_tokens* pass through to
        :meth:`DecodeEngine.admit`.  Returns the :class:`PagedSession`."""
        with self._lock:
            if self._stopped:
                raise ServeError("decode batcher %r is closed" % self.name)
            if self._unhealthy:
                raise ServeError("decode batcher %r is unhealthy "
                                 "(tick loop crashed)" % self.name)
            if self._rebuilding:
                raise ServeError("decode batcher %r is rebuilding its "
                                 "pool after a tick-loop crash — "
                                 "admissions shed until the rebuild "
                                 "lands" % self.name)
            if self._draining:
                raise ServeError("decode batcher %r is draining — "
                                 "admissions are stopped" % self.name)
        sess = self._engine.admit(prompt, max_new_tokens=max_new_tokens,
                                  stop_fn=stop_fn, deadline_ms=deadline_ms,
                                  journal_key=journal_key,
                                  incarnation=incarnation,
                                  resume_tokens=resume_tokens)
        with self._cond:
            if self._stopped or self._draining:
                stopped = self._stopped
                self._cond.notify_all()
            else:
                self._joins.append(sess)
                self._cond.notify()
                return sess
        # lost the race to a close/drain: undo the admission, typed
        self._engine.release(sess, "shed", ServeError(
            "decode batcher %r %s" % (self.name,
                                      "closed" if stopped else "draining")))
        raise sess.error

    # -- dispatcher ----------------------------------------------------------
    def _run(self):
        try:
            self._loop()
        except Exception as exc:
            self._crashed(exc)

    def _loop(self):
        eng = self._engine
        top = eng.ladder.max_batch
        while True:
            with self._cond:
                self._last_tick = _time.monotonic()
                while not self._stopped and not self._joins and \
                        not self._sessions:
                    # bounded idle wait keeps the liveness tick fresh
                    self._cond.wait(timeout=0.5)
                    self._last_tick = _time.monotonic()
                if self._stopped:
                    return
                # coalescing window: with nothing decoding yet, hold
                # the first tick open for more arrivals (oldest-join
                # clock, monotonic) so co-arriving sessions share one
                # rung from the start
                while self._joins and not self._sessions and \
                        not self._stopped and not self._draining and \
                        len(self._joins) < top:
                    now = _time.monotonic()
                    window = self._joins[0]._t_enq + self._max_wait
                    if now >= window:
                        break
                    self._cond.wait(timeout=window - now)
                    self._last_tick = _time.monotonic()
                if self._stopped:
                    return
                joins = list(self._joins)
                self._joins.clear()
                sessions = list(self._sessions)
                self._inflight = tuple(joins) + tuple(sessions)
            for j in joins:
                if j.cancelled:
                    eng.release(j, "cancelled", RequestCancelled(
                        "decode session %d cancelled before its "
                        "prefill" % j.sid))
                    continue
                # fresh clock per join: an earlier join's slow prefill
                # must not let a stale stamp admit a session whose
                # deadline has already passed
                if j._deadline is not None and \
                        _time.monotonic() >= j._deadline:
                    eng.release(j, "expired", DeadlineExceededError(
                        "decode session %d missed its join deadline "
                        "(%r queue)" % (j.sid, self.name)))
                    continue
                try:
                    eng.prefill(j)
                except Exception as exc:
                    # a failed prefill fails exactly this session — the
                    # error rides its future, typed
                    eng.release(j, "prefill_failed", exc)
                    continue
                sessions.append(j)
            live = [s for s in sessions if not s.done()]
            for i in range(0, len(live), top):
                eng.tick(live[i:i + top])
            with self._cond:
                self._inflight = ()
                self._sessions = [s for s in sessions if not s.done()]
                self._ticks += 1
                self._last_tick = _time.monotonic()
                # wake waiters every iteration: a flush() watching a
                # SUBSET of sessions must see them finish even while new
                # admissions keep the lists non-empty
                self._cond.notify_all()

    def _crashed(self, exc):
        with self._cond:
            leftovers = list(dict.fromkeys(
                self._sessions + list(self._joins)
                + list(self._inflight)))
            self._sessions = []
            self._joins.clear()
            self._inflight = ()
            rebuild = (not self._stopped
                       and self._rebuilds < self._rebuild_budget)
            if rebuild:
                self._rebuilding = True
                self._rebuilds += 1
                nth = self._rebuilds
            else:
                self._unhealthy = True
            self._cond.notify_all()
        if rebuild:
            self._rebuild(exc, leftovers, nth)
        else:
            self._fail_unhealthy(exc, leftovers)

    def _fail_unhealthy(self, exc, leftovers):
        """Past the rebuild budget (or closed): unhealthy forever, every
        session failed typed, delivered tokens stay readable."""
        log.error("decode batcher %r: tick loop crashed (%s: %s) — "
                  "unhealthy, failing %d sessions (no restart: the pool "
                  "state cannot be trusted)", self.name,
                  type(exc).__name__, exc, len(leftovers))
        err = ServeError(
            "decode batcher %r is unhealthy: tick loop crashed (%s: %s)"
            % (self.name, type(exc).__name__, exc))
        for s in leftovers:
            self._engine.release(s, "failed", err)
        _obs_events.emit("decode", kind="unhealthy", model=self.name,
                         sessions_failed=len(leftovers),
                         error="%s: %s" % (type(exc).__name__,
                                           str(exc)[:200]))
        if self._on_state is not None:
            try:
                self._on_state("unhealthy")
            except Exception:
                log.exception("decode batcher %r: on_state hook failed",
                              self.name)

    def _rebuild(self, exc, leftovers, nth):
        """Quarantine-and-rebuild (runs ON the dying dispatcher thread):
        swap in a fresh pool against the built programs, re-admit
        journaled live sessions via re-prefill + replay, hand the loop
        to a fresh thread."""
        eng = self._engine
        log.warning("decode batcher %r: tick loop crashed (%s: %s) — "
                    "quarantining the pool and rebuilding (%d/%d), %d "
                    "sessions to re-admit", self.name, type(exc).__name__,
                    exc, nth, self._rebuild_budget, len(leftovers))
        compiles_before = eng.compile_count
        try:
            eng.rebuild_pool()
        except Exception as rexc:
            # the rebuild itself failed: degrade to the typed-fail
            # terminal state — never hang, never retry-loop here
            log.exception("decode batcher %r: pool rebuild failed",
                          self.name)
            with self._cond:
                self._rebuilding = False
                self._unhealthy = True
                self._cond.notify_all()
            self._fail_unhealthy(rexc, leftovers)
            return
        _REBUILDS_TOTAL.inc()
        _obs_events.emit("decode", kind="rebuild", model=self.name,
                         rebuilds=nth, budget=self._rebuild_budget,
                         sessions=len(leftovers),
                         compiles_before=compiles_before,
                         compiles_after=eng.compile_count,
                         error="%s: %s" % (type(exc).__name__,
                                           str(exc)[:200]))
        if self._on_state is not None:
            # after the fresh pool, before re-admission: lets a registry
            # hook (or a test seam) observe "rebuilding" while
            # re-admission can still shed typed
            try:
                self._on_state("rebuilding")
            except Exception:
                log.exception("decode batcher %r: on_state hook failed",
                              self.name)
        readmitted = []
        for s in leftovers:
            if s.done():
                continue
            if s.cancelled:
                # a cancel racing the crash wins: never resumed
                eng.release(s, "cancelled", RequestCancelled(
                    "decode session %d cancelled during the pool rebuild"
                    % s.sid))
                continue
            try:
                eng.readmit(s)
            except KVPoolExhausted as aexc:
                # shed THIS session typed; the rebuild itself lands
                eng.release(s, "pool_exhausted", aexc)
                continue
            except Exception as aexc:
                eng.release(s, "failed", aexc)
                continue
            readmitted.append(s)
        with self._cond:
            self._joins.extend(readmitted)
            self._rebuilding = False
            # the crash handler runs on the dying thread — a fresh one
            # must own the loop from here
            self._thread = _san.thread(
                target=self._run, name="serve-decode-%s" % self.name,
                daemon=True)
            self._thread.start()
            self._cond.notify_all()
        log.info("decode batcher %r: rebuild %d/%d complete — %d/%d "
                 "sessions re-admitted", self.name, nth,
                 self._rebuild_budget, len(readmitted), len(leftovers))

    # -- lifecycle -----------------------------------------------------------
    def drain(self, timeout=None):
        """Stop admissions (``start`` raises typed) and keep ticking
        until every live session finishes, bounded by *timeout* (default
        ``MXNET_SERVE_DRAIN_TIMEOUT``).  Sessions still live at the
        deadline fail typed and release their pool blocks; tokens
        already delivered stay readable.  Returns True when everything
        finished naturally."""
        with self._cond:
            self._draining = True
            self._cond.notify_all()
        _obs_events.emit("decode", kind="drain", model=self.name)
        return self._await_quiesce(timeout, "drained")

    def flush(self, timeout=None):
        """Wait (bounded) for every session ALREADY accepted to finish
        WITHOUT stopping admissions — the alias-cutover primitive:
        accepted decode work lands (or typed-fails at the deadline,
        releasing its blocks), and the batcher keeps serving.  Returns
        True when everything finished in time."""
        return self._await_quiesce(timeout, "flushed")

    def _await_quiesce(self, timeout, reason):
        if timeout is None:
            from ..config import get_env
            timeout = get_env("MXNET_SERVE_DRAIN_TIMEOUT")
        deadline = _time.monotonic() + max(0.0, float(timeout))
        clean = True
        leftovers = []
        with self._cond:
            # snapshot what is accepted NOW — flush must not chase
            # sessions admitted after it started
            target = set(self._sessions) | set(self._joins) \
                | set(self._inflight)
            while any(not s.done() for s in target):
                remaining = deadline - _time.monotonic()
                if remaining <= 0:
                    clean = False
                    leftovers = [s for s in target if not s.done()]
                    self._sessions = [s for s in self._sessions
                                      if s not in leftovers]
                    for s in leftovers:
                        try:
                            self._joins.remove(s)
                        except ValueError:
                            pass
                    break
                self._cond.wait(timeout=remaining)
        for s in leftovers:
            self._engine.release(s, reason, ServeError(
                "decode session %d %s before finishing (batcher %r); "
                "tokens delivered so far remain readable via outputs()"
                % (s.sid, reason, self.name)))
        return clean

    def close(self, timeout=5.0):
        """Stop the tick loop; live sessions fail typed (their delivered
        tokens stay readable).  Returns True on a clean join."""
        with self._cond:
            if self._stopped:
                return True
            self._stopped = True
            self._cond.notify_all()
            thread = self._thread
        # join FIRST: the loop finishes its in-flight iteration and
        # writes surviving sessions back, so the sweep below sees them
        thread.join(timeout)
        clean = not thread.is_alive()
        with self._cond:
            leftovers = list(dict.fromkeys(
                self._sessions + list(self._joins)
                + list(self._inflight)))
            self._sessions = []
            self._joins.clear()
            self._inflight = ()
        for s in leftovers:
            self._engine.release(s, "closed", ServeError(
                "decode batcher %r closed before session %d finished"
                % (self.name, s.sid)))
        # a cleanly-retired batcher must not haunt the registry's
        # live()/health view; a CRASHED batcher stays listed
        with self._engine._lock:
            try:
                self._engine._batchers.remove(self)
            except ValueError:
                pass
        if not clean:
            log.warning("decode batcher %r: close could not join the "
                        "tick loop within %.1fs", self.name, timeout)
        return clean


class SpeculativeDecoder:
    """Greedy speculative decode (opt-in): a small draft engine proposes
    K tokens with K cheap rung-1 ticks, the target engine verifies all K
    in ONE verify dispatch and accepts the matched prefix plus one
    corrected token.  With greedy (argmax) emission this gives plain
    target decode's stream: every emitted token is the target's own step
    output, and rejected cache positions are beyond-position garbage the
    step contract already masks.

    Build the target engine with ``spec_k=K`` (that builds the verify
    program at warm); the draft engine is any :class:`DecodeEngine` over
    the same input/output token contract (typically a much smaller
    model).  It decodes one session at a time.

    Degradation: a draft-engine failure (crash, pool exhaustion, rebuild
    in progress) falls back to plain greedy target ticks for the rest of
    the run; ``fallback_reason`` and a ``decode`` event of kind
    ``spec_fallback`` name the cause.
    """

    def __init__(self, target, draft):
        if target.spec_k < 1:
            raise ServeError("SpeculativeDecoder needs a target engine "
                             "built with spec_k >= 1")
        if set(draft._input_spec) != set(target._input_spec):
            raise ServeError("draft/target engines disagree on the input "
                             "contract")
        self.target = target
        self.draft = draft
        self.k = target.spec_k
        self.stats = {"rounds": 0, "proposed": 0, "accepted": 0,
                      "target_dispatches": 0, "fallbacks": 0}
        self.fallback_reason = None

    def _token_key(self, out):
        return _token_bytes(out)

    def _fall_back(self, reason, exc, d_sess=None):
        """Degrade to plain greedy ticks: note why, emit the decode
        event, retire the draft session."""
        self.fallback_reason = reason
        self.stats["fallbacks"] += 1
        log.warning("speculative decode %r: draft engine failed (%s: %s) "
                    "— falling back to plain greedy ticks",
                    self.target.label, reason, exc)
        _obs_events.emit("decode", kind="spec_fallback",
                         model=self.target.label, reason=reason,
                         error=None if exc is None else
                         "%s: %s" % (type(exc).__name__, str(exc)[:200]))
        if d_sess is not None and not d_sess.done():
            try:
                self.draft.release(d_sess, "failed", ServeError(
                    "draft engine abandoned: %s" % reason))
            except Exception:
                log.exception("speculative decode %r: draft release "
                              "failed", self.target.label)

    def run(self, prompt, max_new_tokens):
        """Decode one session speculatively; returns the finished target
        :class:`PagedSession` (its ``outputs()`` is the stream)."""
        t_sess = self.target.admit(prompt, max_new_tokens=max_new_tokens)
        self.target.prefill(t_sess)
        d_sess = None
        try:
            d_sess = self.draft.admit(prompt)
            self.draft.prefill(d_sess)
        except Exception as exc:
            self._fall_back("draft_admit", exc, d_sess)
            d_sess = None
        try:
            while not t_sess.done():
                if self.fallback_reason is None and d_sess is not None \
                        and d_sess.done() and d_sess.error is not None:
                    # the draft died typed mid-run: permanent fallback
                    self._fall_back(
                        "draft_%s" % (d_sess.finish_reason or "failed"),
                        d_sess.error)
                if self.fallback_reason is not None:
                    self.target.tick([t_sess])
                    self.stats["target_dispatches"] += 1
                    continue
                base_pos = t_sess.pos
                base_input = dict(t_sess.pending_input)
                # k draft ticks: the first k-1 proposals ride the verify
                # (inputs = pending + proposals[:k-1]); the k-th tick
                # only writes draft-cache position base+k-1, so a FULL
                # accept leaves the draft's cache complete for the next
                # round
                d_sess.pos = base_pos
                d_sess.pending_input = dict(base_input)
                proposals = []
                try:
                    for _ in range(self.k):
                        if d_sess.pos >= self.draft.padded_len:
                            break
                        before = d_sess.token_count
                        self.draft.tick([d_sess])
                        if d_sess.token_count == before:
                            break
                        proposals.append(d_sess.outputs()[-1])
                except Exception as exc:
                    # a draft crash degrades, never surfaces: the target
                    # continues on plain greedy ticks
                    self._fall_back("draft_tick", exc, d_sess)
                    continue
                if len(proposals) < self.k:
                    # tail of the sequence: fall back to plain ticks
                    self.target.tick([t_sess])
                    self.stats["target_dispatches"] += 1
                    continue
                proposals = proposals[:self.k - 1]
                verify_inputs = {}
                for n, sp in self.target._input_spec.items():
                    buf = _np.zeros((self.k,) + sp.shape, sp.np)
                    buf[0] = base_input[n]
                    for i, p in enumerate(proposals):
                        buf[i + 1] = self.target._feed(p)[n]
                    verify_inputs[n] = buf
                outs = self.target.verify(t_sess, verify_inputs)
                self.stats["target_dispatches"] += 1
                self.stats["rounds"] += 1
                self.stats["proposed"] += len(proposals)
                per_tok = [_tree_map(lambda a: a[i], outs)
                           for i in range(self.k)]
                accepted = [per_tok[0]]
                for i, p in enumerate(proposals):
                    if self._token_key(p) == self._token_key(per_tok[i]):
                        accepted.append(per_tok[i + 1])
                    else:
                        break
                self.stats["accepted"] += len(accepted) - 1
                self.target.spec_commit(t_sess, accepted)
        except BaseException as exc:
            # a verify/tick failure must not strand the live target
            # session: its blocks and the active-sessions gauge have to
            # come back (delivered tokens stay readable)
            if not t_sess.done():
                self.target.release(t_sess, "failed", ServeError(
                    "speculative decode failed mid-stream (%s: %s)"
                    % (type(exc).__name__, exc)))
            raise
        finally:
            if d_sess is not None and not d_sess.done():
                self.draft.release(d_sess, "finished", None)
        return t_sess
