"""Padding-bucket ladder (port of ``mxnet_tpu/serve/buckets.py``, subset:
``BucketLadder`` and ``ServeError``).

The serving path never runs a request at its natural batch: it pads up
to the nearest rung of a small, finite ladder of batch sizes and trims
the outputs.  ``batch_for(n)`` and ``pad_shape(shape)`` are pure
functions of the rungs, so the set of shapes a model can run at is known
up front.  The JAX package's sequence-axis rounding (``seq_axes``) is not
ported yet.
"""

from __future__ import annotations

__all__ = ["BucketLadder", "ServeError"]


class ServeError(RuntimeError):
    """Typed failure of the serving subsystem (bad shapes, unknown
    models)."""


#: default batch rungs: powers of two through 32
DEFAULT_BATCHES = (1, 2, 4, 8, 16, 32)

#: hard cap on one rung
MAX_BATCH_RUNG = 4096

#: hard cap on the rung count
MAX_RUNGS = 64


class BucketLadder:
    """The finite set of padded batch sizes the serving path may run at.

    batches : strictly ascending positive ints; a request of n rows runs
        at the smallest rung >= n.
    """

    def __init__(self, batches=DEFAULT_BATCHES):
        rungs = [int(b) for b in batches]
        if not rungs or rungs[0] < 1:
            raise ServeError("bucket ladder needs positive batch rungs, "
                             "got %r" % (batches,))
        for lo, hi in zip(rungs, rungs[1:]):
            if hi <= lo:
                raise ServeError("bucket ladder rungs must be strictly "
                                 "ascending (got %r)" % (list(batches),))
        if rungs[-1] > MAX_BATCH_RUNG:
            raise ServeError("bucket ladder rung %d exceeds the %d cap"
                             % (rungs[-1], MAX_BATCH_RUNG))
        if len(rungs) > MAX_RUNGS:
            raise ServeError("bucket ladder has %d rungs, over the %d cap"
                             % (len(rungs), MAX_RUNGS))
        self.batches = tuple(rungs)

    @property
    def max_batch(self):
        return self.batches[-1]

    def batch_for(self, n):
        """Smallest batch rung >= *n*."""
        n = int(n)
        if n < 1:
            raise ServeError("batch size must be >= 1, got %d" % n)
        for b in self.batches:
            if b >= n:
                return b
        raise ServeError("request batch %d exceeds the ladder's top rung %d"
                         " — split the request or extend the ladder"
                         % (n, self.max_batch))

    def pad_shape(self, shape):
        """The padded full shape for a natural input *shape*: the batch
        axis at its rung, the other axes unchanged."""
        shape = tuple(int(s) for s in shape)
        if not shape:
            return shape
        return (self.batch_for(shape[0]),) + shape[1:]

    def bucket_key(self, shapes):
        """Canonical hashable key for a {name: padded_shape} dict."""
        return tuple(sorted((n, tuple(s)) for n, s in shapes.items()))

    def __repr__(self):
        return "BucketLadder(batches=%r)" % (list(self.batches),)
