"""CUDA graph capture and replay for the serving programs: the
predictor's bucket rungs, the dense decoder's step, and the decode
engine's tick, prefill and verify programs.

A program is captured on its owner's own stream into its owner's graph
pool, after one eager run on that stream (library handles, workspaces
and kernel builds land there).  Replays run on the same stream, which
first waits for the caller's stream; the caller's waits for it after, so
callers on any stream are safe.  The owner's lock orders replays on the
host, so programs that share a pool never replay at once.  Capture runs
with ``capture_error_mode="thread_local"``, so work that other threads
queue meanwhile does not break it.
"""

from __future__ import annotations

import contextlib

import torch

from .buckets import ServeError
from ..ops.attention import capture_counts

__all__ = ["capture", "on_stream"]


def capture(dev, pool, stream, run, what, warm=None):
    """Run *warm* (default *run*) once eagerly on *stream*, then capture
    *run* into a CUDA graph on *stream* in *pool*.  Returns (the graph,
    what *run* returned under capture — the static outputs — and the
    kernel launches the capture recorded, ``{kernel: n}``).  A capture
    that fails raises :class:`~.buckets.ServeError` naming *what*;
    nothing falls back to eager execution."""
    with torch.cuda.device(dev):
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream), torch.no_grad():
            (warm or run)()
        before = capture_counts()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.no_grad(), torch.cuda.graph(
                    graph, pool=pool, stream=stream,
                    capture_error_mode="thread_local"):
                outputs = run()
        except Exception as exc:
            raise ServeError(
                "%s: CUDA graph capture failed (%s: %s); the card runs no "
                "eager fallback" % (what, type(exc).__name__, exc)) from exc
        captured = {k: c - before[k] for k, c in capture_counts().items()
                    if c > before[k]}
    return graph, outputs, captured


@contextlib.contextmanager
def on_stream(dev, stream):
    """Run the block on *stream* after the work the caller's current
    stream has queued, and order the caller's stream after the block.
    Yields the caller's stream."""
    with torch.cuda.device(dev):
        caller = torch.cuda.current_stream(dev)
        stream.wait_stream(caller)
        with torch.cuda.stream(stream):
            yield caller
        caller.wait_stream(stream)
