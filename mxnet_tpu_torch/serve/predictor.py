"""CompiledPredictor — one program per padding bucket, and the dense
autoregressive :class:`DecodeSession` (port of
``mxnet_tpu/serve/predictor.py``).

A predictor owns the model's inference graph (``executor._build_eval``
over the symbol, ``training=False``), its parameters on the target
device (its own copies: ``set_params`` writes them in place), and one
program per bucket of the :class:`~.buckets.BucketLadder`, built at
load time by :meth:`CompiledPredictor.warm` (or once, on first demand,
for a bucket warm did not plan) and never in the request path.

**On the card a rung's program is one CUDA graph** — the counterpart of
the JAX package's ahead-of-time compiled program per rung.  Building it
runs the graph once eagerly on zeros on the predictor's own stream
(library handles, workspaces and kernel builds land there), then
captures it on that stream with ``torch.cuda.graph`` over static input
buffers of the rung's padded shape (graphs.py).  A request copies its
padded input into those buffers, replays the graph, and clones the
outputs, all on
the predictor's stream and under its lock: the next replay overwrites
the static outputs.  All rungs of one predictor capture into one graph
memory pool (``torch.cuda.graph_pool_handle``).  The lock orders the
replays on the host and the one stream orders them on the card, so
callers on any stream share the pool safely: the predictor's stream
waits for the caller's before the copy, and the caller's waits for the
clone.  Capture runs with
``capture_error_mode="thread_local"``, so work that other threads queue
meanwhile does not break it.  A capture that fails raises
:class:`~.buckets.ServeError`; nothing falls back to eager execution on
the card, where the eager graph runs only in the warm-up before each
capture.  A replay calls no kernel wrapper, so each program records the
kernel calls its capture recorded (the wrappers' ``captured`` counts)
and counts its replays
(:meth:`CompiledPredictor.graph_launches`).

**On the CPU** (``ctx=mx.cpu()``) a program is the eager graph.

Autoregressive decode: :meth:`CompiledPredictor.make_decoder` builds one
step program (a CUDA graph on the card) over a cache the session owns
and updates in place every step — the port's counterpart of the
reference's donated cache; :meth:`CompiledPredictor.make_paged_decoder`
builds the continuously-batched paged engine (decode.py) bound to this
model.

Requests are zero-padded up to their bucket (batch rung, and any
``seq_axes`` rounding) and the outputs trimmed back to the natural batch.
"""

from __future__ import annotations

import time as _time

import numpy as _np
import torch

from .buckets import BucketLadder, ServeError
from .decode import _leaves, _tree_map
from .graphs import capture, on_stream
from .. import sanitizer as _san
from ..base import torch_dtype
from ..context import Context, current_context
from ..executor import _build_eval
from ..ndarray import NDArray
from ..ndarray.ndarray import _from_numpy
from ..observability import events as _obs_events
from ..observability import metrics as _obs_metrics
from ..ops import quantization as _quant
from ..resilience import servechaos as _servechaos

__all__ = ["CompiledPredictor", "DecodeSession"]

# module-level instrument refs (hot path: no registry lookup per call)
_DISPATCH_SECONDS = _obs_metrics.histogram(
    "serve_dispatch_seconds",
    "host-side latency of one serve dispatch (one graph replay on the "
    "card)")
_COMPILES_TOTAL = _obs_metrics.counter(
    "serve_compiles_total",
    "rung programs built (CUDA graph captures on the card); flat after "
    "warmup or the request path is building programs")
_PADDED_ROWS = _obs_metrics.counter(
    "serve_padded_rows_total",
    "zero-padded rows dispatched (bucket size minus real rows)")
_DEVICE_PUT_ELIDED = _obs_metrics.counter(
    "device_put_elided_total",
    "host->device transfers skipped because the array was already on "
    "its target device (device-resident input)")

def _as_tensor(x):
    """A request or parameter array (numpy / NDArray / tensor) as a
    tensor where it lies (numpy on the CPU)."""
    if isinstance(x, NDArray):
        return x._data
    if isinstance(x, torch.Tensor):
        return x
    return _from_numpy(_np.asarray(x))


def _device_resident(x, dev):
    """Is *x* a tensor already on *dev* (the previous decode step's
    output fed back), so its host round trip can be skipped?"""
    return isinstance(x, torch.Tensor) and x.device == dev


def _as_host(x):
    """A request array as host numpy (the batcher queues host data)."""
    if isinstance(x, NDArray):
        return x.asnumpy()
    if isinstance(x, torch.Tensor):
        return NDArray(x).asnumpy()
    return _np.asarray(x)


class _EagerProgram:
    """A rung's program on the CPU: the eager graph, run under the
    predictor's lock like a replay (``set_params`` writes in place).
    ``work`` holds what its last run counted (``ops.quantization``)."""

    def __init__(self, pred):
        self._pred = pred
        self.captured = {}
        self.replays = 0
        self.work = None

    def __call__(self, padded):
        pred = self._pred
        with pred._lock:
            with _quant.counting() as work:
                outs = pred._run({n: t.to(pred._dev)
                                  for n, t in padded.items()})
            self.work = dict(work)
            self.replays += 1
        return outs


class _GraphProgram:
    """A rung's program on the card: one captured CUDA graph over static
    input buffers; ``captured`` holds the kernel launches its capture
    recorded, ``work`` the int8 work and compute bytes it recorded (per
    replay), ``replays`` counts its replays."""

    def __init__(self, pred, graph, inputs, outputs, captured, work):
        self._pred = pred
        self._graph = graph
        self._inputs = inputs
        self._outputs = outputs
        self.captured = captured
        self.work = work
        self.replays = 0

    def __call__(self, padded):
        pred = self._pred
        with pred._lock:
            with on_stream(pred._dev, pred._stream) as caller:
                for n, t in padded.items():
                    self._inputs[n].copy_(t)
                self._graph.replay()
                outs = [o.clone() for o in self._outputs]
            for o in outs:
                o.record_stream(caller)
            self.replays += 1
        return outs


class CompiledPredictor:
    """Bucketed inference programs for one model.

    symbol : the inference graph.
    arg_params : {name: array} for every non-data argument of *symbol*;
        copied onto the target device at construction.
    aux_params : {name: array} of auxiliary states.
    data_shapes : {input name: natural full shape}; the trailing dims seed
        :meth:`warm` and the key set names the request inputs.
    ladder : BucketLadder (default: powers of two).
    data_dtypes : {input name: dtype} (default float32); inputs are cast.
    ctx : the target device (default: the current context, ``gpu(0)``).
    name : model name used in events and errors.
    bucket_inputs : the data inputs whose leading dim is a batch axis
        subject to the ladder (default: all).  Inputs left out are
        fixed-shape: requests must match their declared shape exactly.
    """

    def __init__(self, symbol, arg_params, aux_params=None, data_shapes=None,
                 ladder=None, data_dtypes=None, ctx=None, name="model",
                 bucket_inputs=None):
        if not data_shapes:
            raise ServeError("CompiledPredictor needs data_shapes "
                             "({input name: full shape})")
        self.name = name
        self._symbol = symbol
        self._ctx = Context(ctx) if ctx is not None else current_context()
        self._dev = self._ctx.torch_device
        self.ladder = ladder or BucketLadder()
        self._data_shapes = {n: tuple(int(d) for d in s)
                             for n, s in data_shapes.items()}
        self._data_dtypes = {n: torch_dtype((data_dtypes or {}).get(
            n, "float32")) for n in self._data_shapes}
        if bucket_inputs is None:
            self._bucket_inputs = frozenset(self._data_shapes)
        else:
            self._bucket_inputs = frozenset(bucket_inputs)
            bad = self._bucket_inputs - set(self._data_shapes)
            if bad:
                raise ServeError("model %r: bucket_inputs %s are not data "
                                 "inputs" % (name, sorted(bad)))
        arg_names = symbol.list_arguments()
        missing = [n for n in arg_names if n not in self._data_shapes and
                   n not in (arg_params or {})]
        if missing:
            raise ServeError("model %r: arguments %s are neither data inputs "
                             "nor in arg_params" % (name, missing))
        unknown = [n for n in self._data_shapes if n not in arg_names]
        if unknown:
            raise ServeError("model %r: data inputs %s are not arguments of "
                             "the symbol (it has %s)"
                             % (name, unknown, arg_names[:4]))
        own = lambda v: _as_tensor(v).to(self._dev, copy=True)
        self._params = {n: own(v) for n, v in (arg_params or {}).items()
                        if n in arg_names and n not in self._data_shapes}
        aux_params = aux_params or {}
        aux_names = symbol.list_auxiliary_states()
        missing_aux = [n for n in aux_names if n not in aux_params]
        if missing_aux:
            raise ServeError("model %r: missing auxiliary states %s"
                             % (name, missing_aux))
        self._aux = {n: own(aux_params[n]) for n in aux_names}
        # Convolution and FullyConnected count their compute bytes and
        # float products while a program is built, beside the int8 ops
        self._eval = _build_eval(symbol, False,
                                 op_impls=_quant.counted_impls())
        self._programs = {}        # bucket key -> program
        self._lock = _san.lock(label="serve.predictor.%s" % name)
        self._compiles = 0
        self._dispatches = 0
        self._pool = None          # the rungs' shared CUDA graph pool
        self._stream = None        # warm-up, capture and replay stream
        self._decode_engines = []  # paged engines bound to this model
        self.quantization = None   # the quantized load's report and gate
        self.tuning = None         # the TuningStore entry of the load

    # -- introspection -----------------------------------------------------
    @property
    def compile_count(self):
        """Programs built so far (CUDA graph captures on the card).  Flat
        after warmup — a growing count means the request path builds."""
        return self._compiles

    @property
    def dispatch_count(self):
        return self._dispatches

    @property
    def replay_count(self):
        """Program runs so far (graph replays on the card; warm's priming
        runs included)."""
        with self._lock:
            return sum(p.replays for p in self._programs.values())

    def graph_launches(self):
        """{kernel: launches its graphs ran}: over every program, the
        kernel launches its capture recorded times its replays.  (A
        replay does not call the kernel wrappers, so their ``launches``
        counters do not see it.)"""
        out = {}
        with self._lock:
            for p in self._programs.values():
                for k, c in p.captured.items():
                    out[k] = out.get(k, 0) + c * p.replays
        return out

    def captured_launches(self, shapes):
        """The kernel launches the capture of *shapes*' program recorded
        ({} for an eager program)."""
        prog = self._programs.get(self.ladder.bucket_key(shapes))
        if prog is None:
            raise ServeError("model %r has no program for %s"
                             % (self.name, shapes))
        return dict(prog.captured)

    def jit_cache_size(self):
        """0: the port traces nothing per call (the JAX contract for the
        size of its traced-call cache)."""
        return 0

    def program_keys(self):
        return sorted(self._programs)

    def output_shapes(self, n):
        """Output shapes for a natural batch of *n* rows (trimmed), by
        evaluating the graph on meta tensors (no device work)."""
        shapes = {nm: ((n,) + self._data_shapes[nm][1:])
                  if nm in self._bucket_inputs else self._data_shapes[nm]
                  for nm in self._data_shapes}
        meta = lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta")
        amap = {k: meta(v) for k, v in self._params.items()}
        amap.update({nm: torch.empty(s, dtype=self._data_dtypes[nm],
                                     device="meta")
                     for nm, s in shapes.items()})
        with torch.no_grad():
            outs, _ = self._eval(amap, {k: meta(v)
                                        for k, v in self._aux.items()})
        return [tuple(o.shape) for o in outs]

    # -- programs ----------------------------------------------------------
    def _run(self, data):
        """The eager graph over *data* ({input: tensor on the device})."""
        amap = dict(self._params)
        amap.update(data)
        with torch.no_grad():
            outs, _ = self._eval(amap, self._aux)
        return outs

    def _bucket_shapes(self, natural_shapes):
        """{name: padded full shape} for a request's natural shapes —
        batch dims must agree across the bucketed inputs; fixed-shape
        inputs must match their declared shape exactly."""
        batches = {s[0] for n, s in natural_shapes.items()
                   if s and n in self._bucket_inputs}
        if len(batches) > 1:
            raise ServeError("model %r: inputs disagree on batch size (%s)"
                             % (self.name, sorted(batches)))
        out = {}
        for n, s in natural_shapes.items():
            if n in self._bucket_inputs:
                out[n] = self.ladder.pad_shape(s)
            elif tuple(s) != self._data_shapes[n]:
                raise ServeError(
                    "model %r fixed-shape input %r: %s does not match the "
                    "declared %s (it is outside bucket_inputs — no padding "
                    "applies)" % (self.name, n, tuple(s),
                                  self._data_shapes[n]))
            else:
                out[n] = tuple(s)
        return out

    def _graph_stream(self):
        """(graph pool, stream) of this predictor's programs, made at the
        first capture."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(self._dev)
        return self._pool, self._stream

    def _capture(self, shapes):
        """The CUDA graph of *shapes*' bucket, after one warm-up run on
        zeros (caller holds the lock)."""
        inputs = {n: torch.zeros(s, dtype=self._data_dtypes[n],
                                 device=self._dev)
                  for n, s in shapes.items()}
        work = {}

        def run():
            # the last call is the capture's: what one replay does
            with _quant.counting() as counts:
                outs = self._run(inputs)
            work.clear()
            work.update(counts)
            return outs
        graph, outputs, captured = capture(
            self._dev, *self._graph_stream(), run,
            "model %r, bucket %s" % (self.name, shapes))
        return _GraphProgram(self, graph, inputs, outputs, captured, work)

    def ensure_program(self, shapes):
        """Get-or-build the program for a {name: padded full shape}
        bucket.  Builds are serialized, timed, counted and evented
        (``serve`` category, ``kind="compile"``, blamed on the bucket);
        the hit path is one lock-free dict read."""
        key = self.ladder.bucket_key(shapes)
        prog = self._programs.get(key)
        if prog is not None:
            return prog
        with self._lock:
            prog = self._programs.get(key)
            if prog is not None:
                return prog
            # chaos choke point (reject_warm_at): a failed build must
            # propagate as a typed error, never half-register a model
            _servechaos.on_warm(self.name)
            t0 = _time.perf_counter()
            if self._dev.type == "cuda":
                prog = self._capture(shapes)
            else:
                prog = _EagerProgram(self)
            dt = _time.perf_counter() - t0
            self._programs[key] = prog
            self._compiles += 1
            _COMPILES_TOTAL.inc()
            _obs_events.emit(
                "serve", kind="compile", model=self.name,
                bucket=[list(s) for _, s in key], seconds=round(dt, 4),
                programs=len(self._programs),
                graph=self._dev.type == "cuda", launches=prog.captured)
            return prog

    def rung_shapes(self, b):
        """The padded input shapes of the rung that serves a natural batch
        of *b* rows (construction data shapes, bucket-rounded)."""
        return {n: ((self.ladder.batch_for(b),) + tuple(
            self.ladder.round_axis(ax, d)
            for ax, d in enumerate(s[1:], start=1)))
            if n in self._bucket_inputs else s
            for n, s in self._data_shapes.items()}

    def warm(self, batches=None):
        """Build one program per batch rung (at the construction data
        shapes) and run each once on zeros, so one-time costs land at load
        time.  Returns the number of programs built."""
        before = self._compiles
        for b in (batches or self.ladder.batches):
            shapes = self.rung_shapes(b)
            prog = self.ensure_program(shapes)
            prog({n: torch.zeros(s, dtype=self._data_dtypes[n])
                  for n, s in shapes.items()})
        if self._dev.type == "cuda":
            torch.cuda.synchronize(self._dev)
        return self._compiles - before

    def program_work(self, shapes):
        """What one run of *shapes*' program does, as its build counted
        it (``ops.quantization.counting``): ``int8_products``,
        ``int8_tensors``, ``int8_dequantized``, ``float_products`` and
        ``compute_bytes`` (per replay on the card).  Builds the program
        if needed; an eager program not yet run runs once on zeros."""
        prog = self.ensure_program(shapes)
        if prog.work is None:
            prog({n: torch.zeros(s, dtype=self._data_dtypes[n])
                  for n, s in shapes.items()})
        return dict(prog.work)

    def lowered_text(self, shapes):
        raise ServeError("lowered_text is not ported: the port lowers to no "
                         "StableHLO; program_work(shapes) (or "
                         "quantize.int8_work(pred, rung)) counts the int8 "
                         "products each rung's program runs")

    # -- autoregressive decode ---------------------------------------------
    def make_decoder(self, step_fn, cache, input_shapes, input_dtypes=None,
                     donate=None, label="decode"):
        """Build an autoregressive step program and return a
        :class:`DecodeSession` that threads its cache.

        *step_fn(params, cache, inputs, step)* returns ``(outputs,
        new_cache)`` with ``new_cache`` matching *cache*'s leaves in
        shape and dtype; *step* is a 0-d int32 tensor the session
        advances.  The session owns a copy of *cache* on the predictor's
        device and writes each step's ``new_cache`` into it in place
        (the reference donates it; *donate* is accepted and ignored).
        On the card the step is one CUDA graph captured here over static
        inputs (the step runs under capture: no host reads); on the CPU
        it runs eagerly.  *input_shapes*: {name: shape}; *input_dtypes*:
        {name: dtype} (default float32)."""
        dtypes = input_dtypes or {}
        specs = {n: (tuple(int(d) for d in s), torch_dtype(
            dtypes.get(n, "float32"))) for n, s in input_shapes.items()}
        cache = {n: _as_tensor(a).to(self._dev, copy=True)
                 for n, a in cache.items()}
        t0 = _time.perf_counter()
        prog = _DecodeProgram(self, step_fn, cache, specs, label)
        dt = _time.perf_counter() - t0
        with self._lock:
            self._compiles += 1
        _COMPILES_TOTAL.inc()
        _obs_events.emit("serve", kind="compile", model=self.name,
                         decoder=label, graph=self._dev.type == "cuda",
                         launches=prog.captured, seconds=round(dt, 4))
        return DecodeSession(self, prog, cache, specs, label)

    def make_paged_decoder(self, step_fn, prefill_fn=None, token_spec=None,
                           input_spec=None, **kwargs):
        """Build a continuously-batched paged-KV decode engine bound to
        this model: it shares the predictor's parameters (``set_params``
        reaches it), device and compile accounting, and the registry's
        unload/alias cutover drains it with the model.  See
        :class:`~.decode.DecodeEngine` for the step/prefill contract and
        knobs."""
        from .decode import DecodeEngine
        kwargs.setdefault("label", "%s.decode" % self.name)
        return DecodeEngine(step_fn, prefill_fn=prefill_fn,
                            token_spec=token_spec, input_spec=input_spec,
                            predictor=self, **kwargs)

    # -- request path ------------------------------------------------------
    def predict(self, data, key=None):
        """One padded-bucket dispatch.  *data*: {input name: array}, or one
        array when the model has one input; an array missing the batch
        dim is one example.  Returns the outputs as NDArrays on the
        predictor's device, trimmed to the natural batch (and not to the
        natural length of a rounded axis).  *key* is accepted for the JAX
        signature: no inference op of the port draws random numbers."""
        if not isinstance(data, dict):
            if len(self._data_shapes) != 1:
                raise ServeError("model %r has %d inputs — pass a dict"
                                 % (self.name, len(self._data_shapes)))
            data = {next(iter(self._data_shapes)): data}
        arrays = {}
        for n, full in self._data_shapes.items():
            if n not in data:
                raise ServeError("model %r: request is missing input %r"
                                 % (self.name, n))
            a = _as_tensor(data[n])
            if a.dim() == len(full) - 1:
                a = a[None]         # single example -> batch of one
            if a.dim() != len(full):
                raise ServeError("model %r input %r: rank %d does not match "
                                 "the bound example rank %d"
                                 % (self.name, n, a.dim(), len(full)))
            arrays[n] = a
        natural = {n: tuple(a.shape) for n, a in arrays.items()}
        bucketed = [n for n in natural if n in self._bucket_inputs]
        rows = natural[bucketed[0]][0] if bucketed else None
        shapes = self._bucket_shapes(natural)
        prog = self.ensure_program(shapes)
        padded = {}
        for n, a in arrays.items():
            dt = self._data_dtypes[n]
            if tuple(a.shape) == shapes[n]:
                padded[n] = a.to(dt)
                continue
            buf = torch.zeros(shapes[n], dtype=dt, device=a.device)
            buf[tuple(slice(0, s) for s in a.shape)] = a
            padded[n] = buf
        bucket_rows = shapes[bucketed[0]][0] if bucketed else None
        if bucketed and bucket_rows > rows:
            _PADDED_ROWS.inc(bucket_rows - rows)
        t0 = _time.perf_counter()
        with _san.transfer_guard("serve dispatch (%s)" % self.name):
            outs = prog(padded)
        _DISPATCH_SECONDS.observe(_time.perf_counter() - t0)
        with self._lock:
            self._dispatches += 1
        return [NDArray(o[:rows] if bucketed and rows != bucket_rows and
                        o.dim() and o.shape[0] == bucket_rows else o)
                for o in outs]

    # -- parameter refresh -------------------------------------------------
    def set_params(self, arg_params, aux_params=None):
        """Write new parameter values in place, without rebuilding a
        program: the captured graphs read the same tensors, so the next
        replay sees the new values.  Shapes and dtypes must match (a
        changed shape raises; that is a new model, load it under a new
        name).  Nothing is written unless every value checks out."""
        staged = []
        for table, values, what in ((self._params, arg_params, "parameter"),
                                    (self._aux, aux_params, "aux state")):
            for n, v in (values or {}).items():
                if n not in table:
                    raise ServeError("model %r has no %s %r"
                                     % (self.name, what, n))
                cur, new = table[n], _as_tensor(v)
                if tuple(new.shape) != tuple(cur.shape) or \
                        new.dtype != cur.dtype:
                    raise ServeError(
                        "%s %r changed shape/dtype (%s %s -> %s %s) — "
                        "programs are shape-specialized"
                        % (what, n, tuple(cur.shape), cur.dtype,
                           tuple(new.shape), new.dtype))
                staged.append((cur, new))
        with self._lock:
            for cur, new in staged:
                cur.copy_(new)


class _DecodeProgram:
    """The dense decode step: on the card one CUDA graph over static
    input and step buffers, captured on the predictor's stream into its
    graph pool after one eager warm-up run (the cache is restored after
    it); on the CPU the eager step.  Both write ``new_cache`` into the
    session's cache in place."""

    def __init__(self, pred, step_fn, cache, specs, label):
        self._pred = pred
        dev = pred._dev
        self._inputs = {n: torch.zeros(s, dtype=dt, device=dev)
                        for n, (s, dt) in specs.items()}
        self._step = torch.zeros((), dtype=torch.int32, device=dev)
        self.captured = {}
        self.replays = 0

        def body():
            outs, new = step_fn(pred._params, cache, dict(self._inputs),
                                self._step)
            for n, c in cache.items():
                if new[n] is not c:
                    c.copy_(new[n])
            return outs
        self._body = body
        self._graph = None
        if dev.type != "cuda":
            return

        def warm():
            # the eager run writes the cache: put it back after
            saved = {n: c.clone() for n, c in cache.items()}
            body()
            for n, c in cache.items():
                c.copy_(saved[n])
        with pred._lock:
            self._graph, self._outputs, self.captured = capture(
                dev, *pred._graph_stream(), body,
                "model %r, decoder %r" % (pred.name, label), warm=warm)

    def __call__(self, data, step):
        """One step over *data* ({name: tensor of the input's shape}) at
        *step*; returns the step outputs (the caller's to keep)."""
        pred = self._pred
        if self._graph is None:
            with pred._lock:
                for n, t in data.items():
                    self._inputs[n].copy_(t)
                self._step.fill_(step)
                with torch.no_grad():
                    outs = self._body()
                self.replays += 1
            return outs
        with pred._lock:
            with on_stream(pred._dev, pred._stream) as caller:
                for n, t in data.items():
                    self._inputs[n].copy_(t)
                self._step.fill_(step)
                self._graph.replay()
                outs = _tree_map(torch.Tensor.clone, self._outputs)
            for o in _leaves(outs):
                o.record_stream(caller)
            self.replays += 1
        return outs


class DecodeSession:
    """One live autoregressive decode: holds the cache (updated in place
    every step, never copied) and threads it through the step program —
    the serve-side mirror of the training step's in-place state."""

    def __init__(self, predictor, program, cache, specs, label):
        self._predictor = predictor
        self._program = program
        self._cache = cache
        self._specs = specs
        self._label = label
        self._t = 0

    @property
    def step_count(self):
        return self._t

    @property
    def cache(self):
        """The live cache (the same tensors every step)."""
        return self._cache

    def lowered_text(self):
        raise ServeError("lowered_text is not ported: the port lowers to "
                         "no StableHLO (decoder %r)" % self._label)

    def step(self, inputs):
        """Run one decode step; returns the step outputs (tensors on the
        predictor's device) and advances the cache in place.  An input
        that is already a tensor on the predictor's device (the previous
        step's output fed back) skips the host round trip, counted by
        ``device_put_elided_total``."""
        pred = self._predictor
        data = {}
        for n, (shape, dt) in self._specs.items():
            if n not in inputs:
                raise ServeError("decode %r: missing input %r"
                                 % (self._label, n))
            raw = inputs[n]
            if isinstance(raw, NDArray):
                raw = raw._data
            if _device_resident(raw, pred._dev):
                a = raw
                _DEVICE_PUT_ELIDED.inc()
            else:
                a = _as_tensor(_as_host(raw))
            if tuple(a.shape) != shape:
                raise ServeError(
                    "decode %r input %r: shape %s does not match the "
                    "built %s (decode programs are fixed-shape; pad "
                    "upstream)" % (self._label, n, tuple(a.shape), shape))
            data[n] = a.to(dt)
        t0 = _time.perf_counter()
        with _san.transfer_guard("serve decode step (%s)" % self._label):
            outs = self._program(data, self._t)
        _DISPATCH_SECONDS.observe(_time.perf_counter() - t0)
        with pred._lock:
            pred._dispatches += 1
        self._t += 1
        return outs
