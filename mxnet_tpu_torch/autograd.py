"""Imperative autograd (port of ``mxnet_tpu/autograd.py``: the recording
scopes, ``mark_variables``, ``backward``, ``grad`` and ``Function``).

Built on ``torch.autograd``: PyTorch's tape takes the place of the JAX
package's per-op tape and ``jax.vjp``.  The framework keeps its own
thread-local recording and training flags; every place that runs ops
(``imperative_invoke``, a block's forward) runs them with PyTorch's grad
mode set to :func:`is_recording`, so nothing is taped outside a
``record()`` scope, and ``pause()`` stops taping inside one.

A marked variable (``attach_grad``, a Parameter's data) is a leaf tensor
that requires grad.  Its gradient buffer is an NDArray; after each
``backward`` a hook on the leaf moves PyTorch's accumulated ``.grad``
into that buffer by the variable's ``grad_req`` ('write' replaces it,
'add' adds to it, 'null' drops it) and clears ``.grad``.

``grad`` is ``torch.autograd.grad``: it fills no gradient buffer, and with
``create_graph`` its results are on the tape, so they can be
differentiated again.  A custom ``Function`` runs as a
``torch.autograd.Function`` whose backward calls the user's.
"""

from __future__ import annotations

import threading

import torch

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_recording", "set_training", "mark_variables",
           "backward", "grad", "Function"]

_state = threading.local()


def _st():
    if not hasattr(_state, "recording"):
        _state.recording = False
        _state.training = False
    return _state


class _RecordingScope:
    def __init__(self, recording, training):
        self.r = recording
        self.t = training

    def __enter__(self):
        st = _st()
        self.prev = (st.recording, st.training)
        if self.r is not None:
            st.recording = self.r
        if self.t is not None:
            st.training = self.t
        return self

    def __exit__(self, *exc):
        st = _st()
        st.recording, st.training = self.prev


def record(train_mode=True):
    """Scope that turns on recording (and train mode by default)."""
    return _RecordingScope(True, train_mode)


def pause(train_mode=False):
    """Scope that turns recording off (and predict mode by default)."""
    return _RecordingScope(False, train_mode)


def train_mode():
    return _RecordingScope(None, True)


def predict_mode():
    return _RecordingScope(None, False)


def is_recording():
    return _st().recording


def is_training():
    return _st().training


def set_recording(flag):
    prev = _st().recording
    _st().recording = bool(flag)
    return prev


def set_training(flag):
    prev = _st().training
    _st().training = bool(flag)
    return prev


def _leaf_hook(grad_nd, grad_req):
    def hook(t):
        g = t.grad
        t.grad = None
        if grad_req == "add":
            grad_nd._data.add_(g.to(grad_nd._data.dtype))
        else:
            grad_nd._data = g.to(grad_nd._data.dtype)
    return hook


def mark_variables(variables, gradients, grad_reqs="write"):
    """Make each NDArray of *variables* a leaf of the tape whose gradient
    lands in the matching NDArray of *gradients* by *grad_reqs*
    (reference: imperative.cc MarkVariables).  The leaf shares storage
    with the array's previous tensor."""
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for v, g, req in zip(variables, gradients, grad_reqs):
        if req not in ("write", "add", "null"):
            raise ValueError("grad_req must be 'write', 'add' or 'null', "
                             "got %r" % (req,))
        leaf = v._data.detach().requires_grad_(req != "null")
        if req != "null":
            leaf.register_post_accumulate_grad_hook(_leaf_hook(g, req))
        v._data = leaf
        v._grad = g


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Gradients of *heads* with respect to every marked variable that
    reaches them, landed in the variables' gradient buffers.  A missing
    head gradient is ones; heads that nothing recorded are skipped."""
    from .ndarray import NDArray
    if isinstance(heads, NDArray):
        heads = [heads]
    if head_grads is None:
        head_grads = [None] * len(heads)
    elif isinstance(head_grads, NDArray):
        head_grads = [head_grads]
    outs, grads = [], []
    for h, hg in zip(heads, head_grads):
        if not h._data.requires_grad:
            continue
        outs.append(h._data)
        grads.append(torch.ones_like(h._data) if hg is None
                     else hg._data.to(h._data.dtype))
    if outs:
        torch.autograd.backward(outs, grads, retain_graph=retain_graph)


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """The gradients of *heads* with respect to *variables* (marked
    variables or arrays computed under ``record()``), returned instead of
    written to any gradient buffer; a variable the heads do not reach
    gets zeros.  With *create_graph* the gradients are themselves on the
    tape.  The graph is kept unless *retain_graph* is False."""
    from .ndarray import NDArray
    single = isinstance(variables, NDArray)
    if single:
        variables = [variables]
    if isinstance(heads, NDArray):
        heads = [heads]
    if head_grads is None:
        head_grads = [None] * len(heads)
    elif isinstance(head_grads, NDArray):
        head_grads = [head_grads]
    for v in variables:
        if not v._data.requires_grad:
            raise ValueError(
                "cannot take gradient w.r.t. an array that is not on the "
                "tape (call attach_grad() / use it under record())")
    outs, grads = [], []
    for h, hg in zip(heads, head_grads):
        if h._data.requires_grad:
            outs.append(h._data)
            grads.append(torch.ones_like(h._data) if hg is None
                         else hg._data.to(h._data.dtype))
    inputs = [v._data for v in variables]
    res = [None] * len(inputs)
    if outs:
        res = torch.autograd.grad(
            outs, inputs, grads,
            retain_graph=True if retain_graph is None else retain_graph,
            create_graph=create_graph, allow_unused=True)
    out = [NDArray(g if g is not None else torch.zeros_like(x.detach()))
           for g, x in zip(res, inputs)]
    return out[0] if single else out


class _FunctionNode(torch.autograd.Function):
    """The tape node of a custom :class:`Function`."""

    @staticmethod
    def forward(ctx, func, *tensors):
        from .ndarray import NDArray
        with pause():
            outputs = func.forward(*[NDArray(t) for t in tensors])
        func._single = not isinstance(outputs, (list, tuple))
        ctx.func = func
        outs = [outputs] if func._single else list(outputs)
        return tuple(o._data for o in outs)

    @staticmethod
    def backward(ctx, *out_grads):
        from .ndarray import NDArray
        # ops of the user's backward are taped only under create_graph
        with _RecordingScope(torch.is_grad_enabled(), None):
            grads = ctx.func.backward(*[NDArray(g) for g in out_grads])
        if isinstance(grads, NDArray):
            grads = [grads]
        return (None,) + tuple(g._data if g is not None else None
                               for g in grads)


class Function:
    """A custom differentiable function: subclass it with
    ``forward(self, *inputs)`` and ``backward(self, *output_grads)`` over
    NDArrays (``save_for_backward`` keeps what backward needs).  Under
    ``record()`` a call puts one node on the tape whose backward is
    yours; the forward itself is not taped."""

    def __init__(self):
        self._saved = None
        self._single = True

    def save_for_backward(self, *arrays):
        self._saved = arrays

    @property
    def saved_tensors(self):
        return self._saved

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError

    def __call__(self, *inputs):
        from .ndarray import NDArray
        if not is_recording():
            with pause():
                return self.forward(*inputs)
        outs = [NDArray(t) for t in
                _FunctionNode.apply(self, *[x._data for x in inputs])]
        return outs[0] if self._single else outs
