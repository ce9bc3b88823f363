"""CompiledPredictor — bucketed inference for one model (port of
``mxnet_tpu/serve/predictor.py``, subset: construction, ``warm``,
``ensure_program``, ``predict``).

A predictor owns the model's inference graph (``executor._build_eval``
over the symbol), its parameters on the target device, and one
"program" per bucket of the :class:`BucketLadder`.  In this port a
program is the eager evaluation of the graph at that bucket's shapes;
``warm`` runs each one once on zeros, so one-time costs (kernel builds,
allocator growth, library handles) land at load time, not on the first
request.  Requests are zero-padded up to their bucket and the outputs
trimmed back.
"""

from __future__ import annotations

import threading

import numpy as _np
import torch

from .buckets import BucketLadder, ServeError
from ..base import torch_dtype
from ..context import Context, current_context
from ..executor import _build_eval
from ..ndarray import NDArray

__all__ = ["CompiledPredictor"]


def _as_tensor(x, device):
    """A request array (numpy / NDArray / tensor) as a tensor on
    *device*."""
    if isinstance(x, NDArray):
        x = x._data
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(_np.ascontiguousarray(x))
    return x.to(device)


class CompiledPredictor:
    """Bucketed inference for one model.

    symbol : the inference graph.
    arg_params : {name: array} for every non-data argument of *symbol*.
    aux_params : {name: array} of auxiliary states.
    data_shapes : {input name: natural full shape}; the trailing dims seed
        :meth:`warm` and the key set names the request inputs.
    ladder : BucketLadder (default: powers of two).
    data_dtypes : {input name: dtype} (default float32); inputs are cast.
    ctx : the target device (default: the current context).
    """

    def __init__(self, symbol, arg_params, aux_params=None, data_shapes=None,
                 ladder=None, data_dtypes=None, ctx=None, name="model"):
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
        self._params = {n: _as_tensor(v, self._dev)
                        for n, v in (arg_params or {}).items()
                        if n in arg_names and n not in self._data_shapes}
        aux_params = aux_params or {}
        aux_names = symbol.list_auxiliary_states()
        missing_aux = [n for n in aux_names if n not in aux_params]
        if missing_aux:
            raise ServeError("model %r: missing auxiliary states %s"
                             % (name, missing_aux))
        self._aux = {n: _as_tensor(aux_params[n], self._dev)
                     for n in aux_names}
        self._eval = _build_eval(symbol, False)
        self._rungs = set()
        self._lock = threading.Lock()
        self._dispatches = 0

    @property
    def compile_count(self):
        """Rungs readied so far; flat after ``warm``.  A program is the
        eager graph, so nothing is built per rung yet: this counts the
        rung keys that have been seen."""
        return len(self._rungs)

    @property
    def dispatch_count(self):
        return self._dispatches

    def _run(self, data):
        amap = dict(self._params)
        amap.update(data)
        with torch.no_grad():
            outs, _ = self._eval(amap, self._aux)
        return outs

    def ensure_program(self, shapes):
        """The program for a {name: padded full shape} bucket, counting
        the rung in ``compile_count`` the first time it is seen."""
        key = self.ladder.bucket_key(shapes)
        if key not in self._rungs:
            with self._lock:
                self._rungs.add(key)
        return self._run

    def rung_shapes(self, b):
        """The padded input shapes of the rung serving *b* rows."""
        return {n: (self.ladder.batch_for(b),) + s[1:]
                for n, s in self._data_shapes.items()}

    def warm(self, batches=None):
        """Run every rung's program once on zeros.  Returns the number of
        rungs readied for the first time."""
        before = self.compile_count
        for b in (batches or self.ladder.batches):
            shapes = self.rung_shapes(b)
            prog = self.ensure_program(shapes)
            prog({n: torch.zeros(s, dtype=self._data_dtypes[n],
                                 device=self._dev)
                  for n, s in shapes.items()})
        if self._dev.type == "cuda":
            torch.cuda.synchronize(self._dev)
        return self.compile_count - before

    def predict(self, data):
        """One padded-bucket dispatch.  *data*: {input name: array}, or
        one array when the model has one input; an array missing the
        batch dim is one example.  Returns the outputs as NDArrays,
        trimmed to the natural batch."""
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
            a = _as_tensor(data[n], self._dev)
            if a.dim() == len(full) - 1:
                a = a[None]
            if a.dim() != len(full):
                raise ServeError("model %r input %r: rank %d does not match "
                                 "the bound example rank %d"
                                 % (self.name, n, a.dim(), len(full)))
            arrays[n] = a
        batches = {a.shape[0] for a in arrays.values()}
        if len(batches) > 1:
            raise ServeError("model %r: inputs disagree on batch size (%s)"
                             % (self.name, sorted(batches)))
        rows = batches.pop()
        shapes = {n: self.ladder.pad_shape(a.shape)
                  for n, a in arrays.items()}
        prog = self.ensure_program(shapes)
        padded = {}
        for n, a in arrays.items():
            dt = self._data_dtypes[n]
            if tuple(a.shape) == shapes[n] and a.dtype == dt:
                padded[n] = a
                continue
            buf = torch.zeros(shapes[n], dtype=dt, device=self._dev)
            buf[tuple(slice(0, s) for s in a.shape)] = a
            padded[n] = buf
        outs = prog(padded)
        with self._lock:
            self._dispatches += 1
        bucket_rows = next(iter(shapes.values()))[0]
        return [NDArray(o[:rows] if o.dim() and o.shape[0] == bucket_rows
                        and rows != bucket_rows else o) for o in outs]
