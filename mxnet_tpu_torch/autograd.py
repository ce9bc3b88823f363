"""Imperative autograd (port of ``mxnet_tpu/autograd.py``, subset: the
recording scopes, ``mark_variables`` and ``backward``).

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

Not ported yet: ``grad`` (functional gradients, create_graph) and the
custom ``Function``.
"""

from __future__ import annotations

import threading

import torch

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_recording", "set_training", "mark_variables",
           "backward"]

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
