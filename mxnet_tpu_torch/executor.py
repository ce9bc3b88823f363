"""Executor — a Symbol bound to a device and buffers (port of
``mxnet_tpu/executor.py``).

PyTorch runs eagerly, so evaluating a Symbol is a walk over its nodes in
topological order, calling each op on tensors (``_build_eval``).  Each
intermediate value is released after its last consumer has run, so peak
memory follows the graph's live set rather than its total size.

``forward(is_train=True)`` records the walk on ``torch.autograd``;
``backward`` takes the gradients of the arguments whose ``grad_req`` is
not ``null`` from that record and frees it (so does the next
``forward``).  A head whose op has its own backward (``SoftmaxOutput`` and
the regression outputs) ignores the head gradient, as in the reference.

``init_fused_step`` builds the whole training step — forward, backward,
the optimizer's tree update and, optionally, the non-finite guard — as
one program: on the card one CUDA graph, captured at the first step and
replayed for every step, reading its batch and hyper-parameters from
static buffers; on the CPU the same function, run eagerly.

Not ported: ``group2ctx`` model parallelism (ROADMAP queue A item 16) and
``Embedding(sparse_grad=True)`` row-sparse gradients (item 12).
"""

from __future__ import annotations

import torch

from .base import MXNetError, torch_dtype
from .context import Context, current_context
from .ndarray import NDArray
from .observability import metrics as _obs_metrics
from .ops.attention import capture_counts

__all__ = ["Executor", "_build_eval"]

# the reference's profiler counters of the fused step: a compile is a
# CUDA graph capture here, a dispatch one replay
_FUSED_CAPTURES = _obs_metrics.counter(
    "fused_step_compiles", "CUDA graphs captured for the fused train step")
_FUSED_REPLAYS = _obs_metrics.counter(
    "fused_step_dispatches", "fused train steps run by graph replay")


def _not_ported(what, item):
    return MXNetError("%s is not ported to mxnet_tpu_torch (ROADMAP queue "
                      "A %s)" % (what, item))


def _build_eval(symbol, training, op_impls=None):
    """Build ``fn(arg_map, aux_map, generator=None, taps=None) ->
    (outputs, aux_updates)`` evaluating *symbol* over name -> tensor maps.

    *op_impls* ({op name: fn}) swaps an op's implementation for this
    evaluation only, e.g. to run a graph with the plain attention.  A dict
    passed as *taps* receives every op node's visible outputs by name
    (``<node>_output`` or ``<node>_output<i>``)."""
    order = symbol._topo()
    out_entries = list(symbol._outputs)
    impls = dict(op_impls or {})
    keep = {(id(n), i) for n, i in out_entries}
    # position after which each value has no consumer left
    last_use = {}
    for pos, node in enumerate(order):
        for src, i in node.inputs:
            last_use[(id(src), i)] = pos
    release = {}
    for key, pos in last_use.items():
        if key not in keep:
            release.setdefault(pos, []).append(key)

    def fn(arg_map, aux_map, generator=None, taps=None):
        vals = {}
        aux_updates = {}
        for pos, node in enumerate(order):
            if node.is_var:
                if node.name in arg_map:
                    vals[(id(node), 0)] = arg_map[node.name]
                elif node.name in aux_map:
                    vals[(id(node), 0)] = aux_map[node.name]
                else:
                    raise MXNetError("unbound variable %r" % node.name)
                continue
            op = node.op
            ins = [vals[(id(s), i)] for (s, i) in node.inputs]
            params = node.params
            if "training" in op.param_names:
                params = dict(params, training=training)
            impl = impls.get(op.name, op.fn)
            if op.needs_rng:
                out = impl(generator, *ins, **params)
            else:
                out = impl(*ins, **params)
            if not isinstance(out, tuple):
                out = (out,)
            for i, o in enumerate(out):
                vals[(id(node), i)] = o
            if taps is not None:
                n_vis = op.n_visible(node.params)
                for i in range(n_vis):
                    taps[node.name + ("_output" if n_vis == 1
                                      else "_output%d" % i)] = out[i]
            if training and op.aux_states:
                for in_idx, out_idx in op.aux_states.items():
                    src, _ = node.inputs[in_idx]
                    if src.is_var and src.name in aux_map:
                        aux_updates[src.name] = out[out_idx]
            for key in release.get(pos, ()):
                vals.pop(key, None)
        return [vals[(id(n), i)] for (n, i) in out_entries], aux_updates

    return fn


def _tensor(x, device, dtype):
    """*x* (NDArray, tensor or array-like) as a detached tensor on
    *device* in *dtype*."""
    if isinstance(x, NDArray):
        x = x._data
    if not isinstance(x, torch.Tensor):
        x = NDArray(x)._data
    return x.detach().to(device=device, dtype=dtype)


class Executor:
    """A bound computation graph."""

    def __init__(self, symbol, ctx, arg_dict, grad_dict, aux_dict,
                 grad_req, group2ctx=None, op_impls=None):
        if group2ctx:
            raise _not_ported("group2ctx model parallelism", "item 16")
        self._symbol = symbol
        self._ctx = Context(ctx) if ctx is not None else current_context()
        self._device = self._ctx.torch_device      # raises without CUDA
        self.arg_dict = arg_dict
        self.grad_dict = grad_dict
        self.aux_dict = aux_dict
        self._arg_names = symbol.list_arguments()
        self._aux_names = symbol.list_auxiliary_states()
        if isinstance(grad_req, str):
            grad_req = {n: grad_req for n in self._arg_names}
        elif isinstance(grad_req, (list, tuple)):
            grad_req = dict(zip(self._arg_names, grad_req))
        self._grad_req = {n: grad_req.get(n, "null")
                          for n in self._arg_names}
        self._grad_names = [n for n in self._arg_names
                            if self._grad_req[n] != "null" and
                            grad_dict.get(n) is not None]
        for node in symbol._topo():
            if not node.is_var and node.op.name == "Embedding" and \
                    node.params.get("sparse_grad", False) in \
                    (True, "True", "true", "1") and \
                    self._grad_req.get(node.inputs[1][0].name) not in \
                    (None, "null"):
                raise _not_ported("Embedding(sparse_grad=True) row-sparse "
                                  "gradients", "item 12")
        self.outputs = []
        self._gen = torch.Generator(device=self._device)
        self._gen.manual_seed(0)
        self._op_impls = op_impls
        self._eval_train = _build_eval(symbol, True, op_impls)
        self._eval_infer = _build_eval(symbol, False, op_impls)
        self._pending = None
        self._monitor = None
        self._monitor_all = False

    # -- binding constructors ---------------------------------------------
    @staticmethod
    def _simple_bind(symbol, ctx, grad_req, type_dict, shape_kwargs,
                     shared_exec=None, group2ctx=None, op_impls=None):
        from .symbol.symbol import _infer_shapes
        if group2ctx:
            raise _not_ported("group2ctx model parallelism", "item 16")
        ctx = Context(ctx) if ctx is not None else current_context()
        dev = ctx.torch_device
        shapes = {k: tuple(v) for k, v in shape_kwargs.items()}
        _, var_sh = _infer_shapes(symbol, shapes)
        type_dict = type_dict or {}

        def fresh(n, shared):
            if shared_exec is not None and n in shared and \
                    tuple(shared[n].shape) == tuple(var_sh[n]):
                return shared[n]
            return NDArray(torch.zeros(var_sh[n], device=dev, dtype=
                                       torch_dtype(type_dict.get(
                                           n, "float32"))))

        sa = shared_exec.arg_dict if shared_exec is not None else {}
        sx = shared_exec.aux_dict if shared_exec is not None else {}
        arg_dict = {n: fresh(n, sa) for n in symbol.list_arguments()}
        aux_dict = {n: fresh(n, sx) for n in symbol.list_auxiliary_states()}
        if isinstance(grad_req, str):
            reqs = {n: grad_req for n in arg_dict}
        elif isinstance(grad_req, (list, tuple)):
            reqs = dict(zip(symbol.list_arguments(), grad_req))
        else:
            reqs = {n: grad_req.get(n, "null") for n in arg_dict}
        grad_dict = {n: NDArray(torch.zeros_like(arg_dict[n]._data))
                     for n in arg_dict if reqs.get(n, "null") != "null"}
        return Executor(symbol, ctx, arg_dict, grad_dict, aux_dict, reqs,
                        op_impls=op_impls)

    @staticmethod
    def _bind(symbol, ctx, args, args_grad, grad_req, aux_states,
              group2ctx=None, op_impls=None):
        ctx = Context(ctx) if ctx is not None else current_context()
        dev = ctx.torch_device

        def as_nd(a):
            if isinstance(a, NDArray):
                return a if a._data.device == dev else \
                    a.as_in_context(ctx)
            return NDArray(_tensor(a, dev, None))

        def named(values, names):
            if values is None:
                return {}
            if isinstance(values, (list, tuple)):
                values = dict(zip(names, values))
            return {k: as_nd(v) for k, v in values.items()
                    if v is not None}

        arg_names = symbol.list_arguments()
        aux_names = symbol.list_auxiliary_states()
        arg_dict = named(args, arg_names)
        missing = [n for n in arg_names if n not in arg_dict]
        if missing:
            raise MXNetError("bind: no array for argument(s) %s" % missing)
        grad_dict = named(args_grad, arg_names)
        aux_dict = named(aux_states, aux_names)
        for n in aux_names:
            if n not in aux_dict:
                raise MXNetError("missing auxiliary state %r" % n)
        return Executor(symbol, ctx, arg_dict, grad_dict, aux_dict,
                        grad_req, group2ctx=group2ctx, op_impls=op_impls)

    # -- properties --------------------------------------------------------
    @property
    def arg_arrays(self):
        return [self.arg_dict[n] for n in self._arg_names]

    @property
    def grad_arrays(self):
        return [self.grad_dict.get(n) for n in self._arg_names]

    @property
    def aux_arrays(self):
        return [self.aux_dict[n] for n in self._aux_names]

    @property
    def output_dict(self):
        return dict(zip(self._symbol.list_outputs(), self.outputs))

    # -- execution ---------------------------------------------------------
    def _feed(self, kwargs):
        """Rebind the named arguments to the given values, in each
        argument's dtype, on this executor's device."""
        for k, v in kwargs.items():
            if k not in self.arg_dict:
                raise MXNetError("unknown forward argument %r" % k)
            dst = self.arg_dict[k]
            dst._data = _tensor(v, self._device, dst._data.dtype)

    def _maps(self):
        return ({n: a._data for n, a in self.arg_dict.items()},
                {n: a._data for n, a in self.aux_dict.items()})

    def forward(self, is_train=False, **kwargs):
        """Run the graph; with *is_train*, on the tape, for a following
        :meth:`backward` (reference: executor.py forward:114)."""
        self._feed(kwargs)
        self._pending = None            # a new forward frees the old record
        arg_map, aux_map = self._maps()
        taps = {} if (self._monitor is not None and
                      self._monitor_all) else None
        if is_train:
            leaves = {n: arg_map[n].detach().requires_grad_(True)
                      for n in self._grad_names}
            arg_map.update(leaves)
            with torch.enable_grad():
                outs, auxu = self._eval_train(arg_map, aux_map, self._gen,
                                              taps)
            self._pending = (leaves, outs)
        else:
            with torch.no_grad():
                outs, auxu = self._eval_infer(arg_map, aux_map, self._gen,
                                              taps)
        for n, v in auxu.items():
            self.aux_dict[n]._data = v.detach()
        self.outputs = [NDArray(o.detach()) for o in outs]
        if self._monitor is not None:
            items = sorted(taps.items()) if taps is not None else \
                zip(self._symbol.list_outputs(),
                    [o._data for o in self.outputs])
            for name, val in items:
                self._monitor(name, NDArray(val.detach()))
        return self.outputs

    def backward(self, out_grads=None, is_train=True):
        """Gradients of the recorded forward into ``grad_dict``: written
        (``grad_req`` 'write') or added ('add'); the head gradients are
        *out_grads*, or ones (reference: backward:155)."""
        if self._pending is None:
            raise MXNetError("backward needs a forward(is_train=True) "
                             "first (each record is used once)")
        leaves, outs = self._pending
        self._pending = None
        if out_grads is None:
            cots = [None] * len(outs)
        elif isinstance(out_grads, NDArray):
            cots = [out_grads]
        else:
            cots = list(out_grads)
        heads, head_grads = [], []
        for o, c in zip(outs, cots):
            if not o.requires_grad:
                continue
            heads.append(o)
            head_grads.append(torch.ones_like(o) if c is None else
                              _tensor(c, o.device, o.dtype))
        names = list(leaves)
        grads = [None] * len(names)
        if heads and names:
            grads = torch.autograd.grad(heads, [leaves[n] for n in names],
                                        head_grads, allow_unused=True)
        for n, g in zip(names, grads):
            dst = self.grad_dict[n]
            if g is None:
                g = torch.zeros_like(leaves[n])
            g = g.to(dst._data.dtype)
            if self._grad_req[n] == "add":
                dst._data = dst._data + g
            else:
                dst._data = g

    def forward_backward(self, out_grads=None, **kwargs):
        """Forward on the tape and backward in one call (the Module
        training loop's legacy step)."""
        self.forward(is_train=True, **kwargs)
        self.backward(out_grads)
        return self.outputs

    # -- the fused train step ------------------------------------------------
    def init_fused_step(self, tree_update_fn, names, state,
                        guard_nonfinite=False):
        """The whole train step as one program over this executor's
        buffers: forward, backward, ``tree_update_fn(grads, params,
        state, lrs, wds, ts)`` (``optimizer/tree_opt.py``: it updates the
        parameters *names* and their *state* tree in place) and, with
        *guard_nonfinite*, one non-finite check over the outputs and
        gradients that leaves weights, state and auxiliary states
        bit-identical on a bad step.  Returns a :class:`FusedStep`.

        On the card the step is one CUDA graph, captured at the first
        call and replayed for every call; on the CPU it runs eagerly.  Gradients live inside the
        program: ``grad_dict`` is not refreshed."""
        return FusedStep(self, tree_update_fn, list(names), state,
                         guard_nonfinite)

    # -- utilities ---------------------------------------------------------
    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        for k, v in (arg_params or {}).items():
            if k in self.arg_dict:
                v.copyto(self.arg_dict[k])
            elif not allow_extra_params:
                raise MXNetError("unknown argument %r" % k)
        for k, v in (aux_params or {}).items():
            if k in self.aux_dict:
                v.copyto(self.aux_dict[k])
            elif not allow_extra_params:
                raise MXNetError("unknown aux state %r" % k)

    def reshape(self, partial_shaping=False, allow_up_sizing=False,
                **kwargs):
        """A new executor at the given argument shapes, sharing every
        array whose shape is unchanged (reference: executor.py
        reshape:372)."""
        shapes = {n: kwargs.get(n, a.shape) for n, a in self.arg_dict.items()}
        ex = Executor._simple_bind(self._symbol, self._ctx, self._grad_req,
                                   {n: a.dtype for n, a in
                                    self.arg_dict.items()}, shapes,
                                   op_impls=self._op_impls)
        for n, a in self.arg_dict.items():
            if tuple(ex.arg_dict[n].shape) == tuple(a.shape):
                ex.arg_dict[n] = a
        for n, a in self.aux_dict.items():
            if tuple(ex.aux_dict[n].shape) == tuple(a.shape):
                ex.aux_dict[n] = a
        return ex

    def set_monitor_callback(self, callback, monitor_all=False):
        """Call *callback(name, NDArray)* on each forward's outputs; with
        *monitor_all*, on every op node's outputs."""
        self._monitor = callback
        self._monitor_all = monitor_all

    def debug_str(self):
        lines = ["Symbol outputs: %s" % self._symbol.list_outputs()]
        for node in self._symbol._topo():
            kind = "var" if node.is_var else node.op.name
            lines.append("%s %s <- %s" % (kind, node.name,
                                          [s.name for s, _ in node.inputs]))
        return "\n".join(lines)


class FusedStep:
    """One train step as one program over static buffers (see
    ``Executor.init_fused_step``).

    The program reads every argument and auxiliary state from the tensor
    it held at construction (``static``); :meth:`__call__` first copies
    any array the executor has since rebound (``set_params``, a legacy
    forward) back into it.  The hyper-parameters enter through one
    float64 device tensor (``lrs``, ``wds``, ``ts`` per name), filled
    before each run, so a learning-rate schedule does not capture again.
    Random ops draw from the executor's generator (on the card the
    device's default generator, whose graph-safe state advances every
    replay), so each step draws anew.  ``captures`` and ``replays`` count graph captures and
    replays; ``captured`` holds the kernel launches the graph recorded
    (``{kernel: n}``), which every replay launches again."""

    def __init__(self, ex, tree_update_fn, names, state, guard):
        self.ex = ex
        self.names = names
        self.state = state
        self.guard = guard
        self.tree_update_fn = tree_update_fn
        dev = ex._device
        self.static = {n: a._data for n, a in ex.arg_dict.items()}
        self.static_aux = {n: a._data for n, a in ex.aux_dict.items()}
        k = len(names)
        self.hyper = torch.zeros(3 * k, dtype=torch.float64, device=dev)
        self._lrs = {n: self.hyper[i] for i, n in enumerate(names)}
        self._wds = {n: self.hyper[k + i] for i, n in enumerate(names)}
        self._ts = {n: self.hyper[2 * k + i] for i, n in enumerate(names)}
        self.graph = None
        self.captured = {}
        self.outputs = None
        self.skipped = None
        self.captures = 0
        self.replays = 0

    def _body(self, generator):
        ex, names = self.ex, self.names
        params = {n: self.static[n] for n in names}
        leaves = {n: p.detach().requires_grad_(True)
                  for n, p in params.items()}
        amap = dict(self.static)
        amap.update(leaves)
        with torch.enable_grad():
            outs, auxu = ex._eval_train(amap, self.static_aux, generator)
            heads = [o for o in outs if o.requires_grad]
            grads = torch.autograd.grad(
                heads, [leaves[n] for n in names],
                [torch.ones_like(o) for o in heads], allow_unused=True)
        grads = {n: g if g is not None else torch.zeros_like(params[n])
                 for n, g in zip(names, grads)}
        outs = [o.detach() for o in outs]
        from .optimizer.tree_opt import _tensors, nonfinite_any
        with torch.no_grad():
            if self.guard:
                bad = nonfinite_any(outs) | nonfinite_any(grads)
                kept = [t.clone() for t in
                        list(params.values()) + _tensors(self.state)]
            self.tree_update_fn(grads, params, self.state, self._lrs,
                                self._wds, self._ts)
            for n, v in auxu.items():
                dst = self.static_aux[n]
                v = v.detach()
                dst.copy_(torch.where(bad, dst, v) if self.guard else v)
            skipped = None
            if self.guard:
                for t, old in zip(list(params.values()) +
                                  _tensors(self.state), kept):
                    t.copy_(torch.where(bad, old, t))
                skipped = bad.to(torch.int32)
        return outs, skipped

    def _rebind(self, batch):
        """Point the executor at the static buffers, copying in what it
        holds elsewhere, then the batch ({name: array})."""
        ex = self.ex
        for table, static in ((ex.arg_dict, self.static),
                              (ex.aux_dict, self.static_aux)):
            for n, t in static.items():
                cur = table[n]._data
                if cur is not t:
                    if n not in batch:
                        t.copy_(cur)
                    table[n]._data = t
        for n, v in batch.items():
            t = self.static[n]
            t.copy_(_tensor(v, t.device, t.dtype))

    def __call__(self, batch, lrs, wds, ts):
        """Run one step on *batch* with this step's per-name lr, wd and
        update count; returns (the outputs, the skipped flag or None)."""
        self._rebind(batch)
        vals = [lrs[n] for n in self.names] + [wds[n] for n in self.names] \
            + [ts[n] for n in self.names]
        self.hyper.copy_(torch.tensor(vals, dtype=torch.float64))
        dev = self.ex._device
        if dev.type != "cuda":
            self.outputs, self.skipped = self._body(self.ex._gen)
            return self.outputs, self.skipped
        if self.graph is None:
            self._capture(dev)
        self.graph.replay()
        self.replays += 1
        _FUSED_REPLAYS.inc()
        return self.outputs, self.skipped

    def _mutable(self):
        from .optimizer.tree_opt import _tensors
        return [self.static[n] for n in self.names] + \
            _tensors(self.state) + list(self.static_aux.values())

    def _capture(self, dev):
        """Run the step once eagerly on a side stream and put back every
        value it changed (library handles, workspaces and kernel builds
        land there), then capture it into a CUDA graph on that stream.
        Every step, the first included, is a replay.  A capture that fails
        raises; nothing falls back to the eager step."""
        gen = torch.cuda.default_generators[dev.index or 0]
        stream = torch.cuda.Stream(dev)
        with torch.cuda.device(dev):
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                kept = [t.clone() for t in self._mutable()]
                self._body(gen)
                for t, old in zip(self._mutable(), kept):
                    t.copy_(old)
                del kept
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()
            before = capture_counts()
            graph = torch.cuda.CUDAGraph()
            try:
                # thread_local: an input pipeline's thread may be decoding
                # onto the card meanwhile (its own streams); only this
                # thread's unsafe calls would break the capture
                with torch.cuda.graph(graph, stream=stream,
                                      capture_error_mode="thread_local"):
                    self.outputs, self.skipped = self._body(gen)
            except Exception as exc:
                raise MXNetError(
                    "fused train step: CUDA graph capture failed (%s: %s); "
                    "the card runs no eager fallback (set "
                    "MXNET_MODULE_FUSED_STEP=0 for the legacy step)"
                    % (type(exc).__name__, exc)) from exc
        self.captured = {k: c - before[k] for k, c in capture_counts().items()
                         if c > before[k]}
        self.graph = graph
        self.captures += 1
        _FUSED_CAPTURES.inc()
