"""Device mesh (port of ``mxnet_tpu/parallel/mesh.py``, one device).

In the JAX package a mesh is a ``jax.sharding.Mesh`` whose named axes
(dp, tp, pp, sp, ep) tell XLA where to place shards and collectives.
The port runs on one device, so its :class:`Mesh` is a ``dp`` axis of
size 1 over one ``torch.device``: ``make_mesh({"dp": 1}, [dev])``.  The
default device is ``cuda:0``; a CPU mesh names the CPU device
explicitly, and the default raises without CUDA.  An axis of size > 1,
or an axis other than ``dp``, raises ``MXNetError``: more than one device
needs NCCL, which is not ported.
"""

from __future__ import annotations

import contextlib
import threading

import numpy as _np
import torch

from ..base import MXNetError
from ..context import Context

__all__ = ["Mesh", "make_mesh", "current_mesh", "use_mesh",
           "data_parallel_mesh"]

_state = threading.local()


def _device(dev):
    """A ``torch.device`` from a torch device, its name or a Context; a
    CUDA device without CUDA raises."""
    if isinstance(dev, Context):
        return dev.torch_device
    dev = torch.device(dev)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise MXNetError("mesh device %s needs a CUDA device and none is "
                         "available; pass [torch.device('cpu')] to run on "
                         "the CPU" % dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    return dev


class Mesh:
    """Named axes over an array of devices (the port's: ``dp`` of size 1
    over one device)."""

    def __init__(self, devices, axis_names):
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def device(self):
        """The mesh's one ``torch.device``."""
        return self.devices.reshape(-1)[0]

    def __repr__(self):
        return "Mesh(%s, %s)" % (self.shape, list(self.devices.reshape(-1)))


def make_mesh(axes=None, devices=None):
    """A Mesh over *devices* (default ``[cuda:0]``) with *axes*
    ({axis name: size}, a -1 size inferred; default ``{"dp": n}``)."""
    if devices is None:
        devices = [_device("cuda")]
    devices = [_device(d) for d in devices]
    n = len(devices)
    if axes is None:
        axes = {"dp": n}
    names = list(axes)
    n_known = 1
    for s in axes.values():
        if s != -1:
            n_known *= s
    sizes = [s if s != -1 else n // n_known for s in axes.values()]
    if int(_np.prod(sizes)) != n:
        raise ValueError("mesh axes %s do not cover %d devices"
                         % (dict(zip(names, sizes)), n))
    if names != ["dp"] or sizes != [1]:
        raise MXNetError("mesh %s over %d devices is not ported: the port "
                         "runs a 'dp' axis of size 1 on one device (more "
                         "than one device needs NCCL, ROADMAP queue A item "
                         "14)" % (dict(zip(names, sizes)), n))
    arr = _np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(sizes), names)


def data_parallel_mesh(n=None):
    """A 'dp' mesh over the first *n* CUDA devices (default: all)."""
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count == 0:
        raise MXNetError("data_parallel_mesh needs a CUDA device and none "
                         "is available")
    n = count if n is None else n
    return make_mesh({"dp": n}, [torch.device("cuda", i) for i in range(n)])


def current_mesh():
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh):
    prev = getattr(_state, "mesh", None)
    _state.mesh = mesh
    try:
        yield mesh
    finally:
        _state.mesh = prev
