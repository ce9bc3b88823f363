"""Device context (port of ``mxnet_tpu/context.py``).

A ``Context`` names a device (``cpu(0)``, ``gpu(0)``) and maps it onto a
``torch.device`` through :attr:`Context.torch_device`.  As in the JAX
package, the default context is the accelerator: ``gpu(0)``, which is
``cuda:0``.  ``tpu`` is an alias of ``gpu`` so scripts written for the
JAX package run unchanged (mirrors ``mxnet_tpu/context.py:119-124``).

There is no silent CPU fallback: resolving a gpu context on a machine
without CUDA raises :class:`MXNetError`.  Code that means to run on the
CPU says so with ``ctx=mx.cpu()``.
"""

from __future__ import annotations

import threading

import torch

from .base import MXNetError

__all__ = ["Context", "cpu", "gpu", "tpu", "current_context"]

# the reference's device type ids (include/mxnet/base.h Context)
_DEVTYPE2ID = {"cpu": 1, "gpu": 2}


class Context:
    """A device context: 'cpu' or 'gpu' ('tpu' is accepted as 'gpu')."""

    _default_ctx = threading.local()

    def __init__(self, device_type, device_id=0):
        if isinstance(device_type, Context):
            device_type, device_id = (device_type.device_type,
                                      device_type.device_id)
        if device_type == "tpu":
            device_type = "gpu"
        if device_type not in ("cpu", "gpu"):
            raise ValueError("unknown device type %r" % (device_type,))
        self.device_type = device_type
        self.device_id = int(device_id)

    @property
    def device_typeid(self):
        return _DEVTYPE2ID[self.device_type]

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __repr__(self):
        return "%s(%d)" % (self.device_type, self.device_id)

    __str__ = __repr__

    @property
    def torch_device(self):
        """The ``torch.device`` this context names.  A gpu context on a
        machine without CUDA raises instead of running on the CPU."""
        if self.device_type == "cpu":
            return torch.device("cpu")
        if not torch.cuda.is_available():
            raise MXNetError(
                "context %s needs a CUDA device and none is available; "
                "pass ctx=mx.cpu() to run on the CPU" % self)
        return torch.device("cuda", self.device_id)

    def __enter__(self):
        if not hasattr(Context._default_ctx, "stack"):
            Context._default_ctx.stack = []
        Context._default_ctx.stack.append(self)
        return self

    def __exit__(self, *exc):
        Context._default_ctx.stack.pop()

    def empty_cache(self):
        """Release the caching allocator's unused device memory
        (``torch.cuda.empty_cache`` on this context's card; nothing on
        the CPU)."""
        if self.device_type == "gpu":
            with torch.cuda.device(self.torch_device):
                torch.cuda.empty_cache()


def cpu(device_id=0):
    """A CPU context."""
    return Context("cpu", device_id)


def gpu(device_id=0):
    """A CUDA device context (``cuda:<device_id>``)."""
    return Context("gpu", device_id)


tpu = gpu


def current_context():
    """The innermost ``with ctx:`` context, else ``gpu(0)``."""
    stack = getattr(Context._default_ctx, "stack", None)
    if stack:
        return stack[-1]
    return Context("gpu", 0)


def context_of(tensor):
    """The Context a tensor lives on."""
    dev = tensor.device
    if dev.type == "cuda":
        return Context("gpu", dev.index or 0)
    return Context("cpu", 0)
