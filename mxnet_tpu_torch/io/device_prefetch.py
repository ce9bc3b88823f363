"""Device-resident input pipeline — host/device overlap (port of
``mxnet_tpu/io/device_prefetch.py``).

``PrefetchingIter`` alone overlaps host decode with device compute but
hands out HOST batches, and the training step then pays the host to
device copy inside its loop.  :class:`DevicePrefetcher` goes one layer
lower: its producer thread runs the host decode **and** the copy onto
the training device, parking finished batches in a ring of depth K, so
by the time the consumer asks for batch N its bytes are on the card and
the step only copies device to device into its graph's input buffers.

On the card the copy goes through pinned staging buffers on a CUDA
stream of the prefetcher's own, and each batch carries an event the
consumer's stream waits on (``io.py``'s ``_Stager``), so the copy of
batch N+1 runs beside step N and is ordered before the step that reads
it.  Arrays already on the target (an ``ImageRecordIter`` places its
batches itself) are passed through and counted in
``device_put_elided_total`` (the counter of ``serve/predictor.py``).

Placement: ``device=`` (a Context, a ``torch.device`` or a string;
default the current context's device) or ``mesh=`` (the port's mesh: a
``dp`` axis of size 1 over one device, which is the target).  The
reference's ``state_dict``/``load_state`` pass-through waits for the
iterators' resumable positions (ROADMAP queue A item 15).
"""

from __future__ import annotations

import torch

from .io import PrefetchingIter
from ..base import MXNetError
from ..context import Context, current_context
from ..observability import metrics as _obs_metrics
from ..serve.predictor import _DEVICE_PUT_ELIDED

__all__ = ["DevicePrefetcher", "maybe_wrap"]

# module-level instrument refs — observed once per consumed batch
_INPUT_WAIT = _obs_metrics.histogram(
    "input_wait_seconds",
    "host time the training loop waited on the device-prefetch ring "
    "for its next batch (steady-state overlap keeps this near zero)")
_STEPS_STALLED = _obs_metrics.counter(
    "steps_input_stalled_total",
    "training steps that found the device-prefetch ring empty and had "
    "to wait on input (the input pipeline is the bottleneck)")
_RING_OCCUPANCY = _obs_metrics.gauge(
    "device_prefetch_ring_occupancy",
    "device-resident batches parked in the DevicePrefetcher ring when "
    "the consumer asked for one (0 = consumer outrunning the producer)")


def _resolve_device(device, mesh):
    if mesh is not None:
        dev = mesh.device
    elif device is None:
        dev = current_context().torch_device
    elif isinstance(device, (Context, str)) and not (
            isinstance(device, str) and ":" in device):
        dev = Context(device).torch_device
    else:
        dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise MXNetError(
                "DevicePrefetcher: target %s needs CUDA and none is "
                "available; pass device=mx.cpu() to run on the CPU" % dev)
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class DevicePrefetcher(PrefetchingIter):
    """Wrap a ``DataIter``-style iterator so batches arrive on the
    training device.

    Parameters
    ----------
    iters : DataIter
        The host-side iterator to wrap.
    depth : int
        Ring depth K: how many decoded-and-copied batches may wait ahead
        of the consumer (device memory: K x batch bytes).
    device : Context, torch.device or str, optional
        Placement target; defaults to the current context's device.
    mesh : parallel.Mesh, optional
        Place on the mesh's device (a ``ParallelTrainer``'s
        ``trainer.mesh``); *spec* and *label_spec* are accepted for the
        reference's signature (the port's mesh has one device).
    retry : dict, optional
        Passed to :class:`PrefetchingIter`.
    """

    def __init__(self, iters, depth=2, device=None, mesh=None, spec=None,
                 label_spec=None, rename_data=None, rename_label=None,
                 retry=None):
        super().__init__(iters, rename_data=rename_data,
                         rename_label=rename_label, prefetch_depth=depth,
                         retry=retry, device=_resolve_device(device, mesh))

    def _note_elided(self):
        _DEVICE_PUT_ELIDED.inc()

    # -- consumer side (the ring-pop protocol lives in PrefetchingIter) --
    def _note_occupancy(self, occupancy):
        _RING_OCCUPANCY.set(occupancy)

    def _note_delivery(self, occupancy, wait_s):
        _INPUT_WAIT.observe(wait_s)
        if occupancy == 0:
            # the batch arrived only after the consumer blocked on an
            # empty ring: this step was input-bound
            _STEPS_STALLED.inc()


def maybe_wrap(train_data, device_prefetch, device=None, mesh=None,
               decode_only=False):
    """Resolve the ``fit(device_prefetch=...)`` / ``MXNET_DEVICE_PREFETCH``
    knob: returns ``(iterator, created)``, *created* saying a wrapper was
    built here (the caller closes it when its loop ends).

    ``None`` consults the env knob; ``True`` is depth 2; an int is that
    depth; ``0``/``False`` is off (and overrides the env knob).  A
    DevicePrefetcher is never wrapped again.  ``decode_only=True`` wraps
    with a host-side :class:`PrefetchingIter` instead (and leaves any
    PrefetchingIter as it is)."""
    if device_prefetch is None:
        from ..config import get_env
        device_prefetch = get_env("MXNET_DEVICE_PREFETCH")
    if not device_prefetch:
        return train_data, False
    depth = 2 if device_prefetch is True else int(device_prefetch)
    if decode_only:
        if isinstance(train_data, PrefetchingIter):
            return train_data, False
        return PrefetchingIter(train_data, prefetch_depth=depth), True
    if isinstance(train_data, DevicePrefetcher):
        return train_data, False
    return DevicePrefetcher(train_data, depth=depth, device=device,
                            mesh=mesh), True
