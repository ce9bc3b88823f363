"""Padding-bucket ladder — the static-shape contract of the serving path
(port of ``mxnet_tpu/serve/buckets.py``).

The serving path never runs a request at its natural shape: it pads up
to the nearest rung of a small, finite ladder of shapes, each of which
has one program built at load time (see predictor.py; on the card a
rung's program is one captured CUDA graph, which replays only at the
shapes it was captured at).  Two padding dimensions:

* **batch** — rung ladder, default powers of two (``1,2,4,...,32``);
  a request of n rows runs at the smallest rung >= n, extra rows are
  zero-padding that the caller trims off;
* **sequence-style axes** — any non-batch axis can carry a round-up
  rule (``seq_axes={1: 64}``: axis 1 rounds up to the next multiple of
  64), bounding the program count for variable-length inputs.

``batch_for(n)`` and ``pad_shape(shape)`` are pure functions of the
configuration, so the set of programs a model can ever build is known
up front.
"""

from __future__ import annotations

__all__ = ["BucketLadder", "ServeError", "OverloadError",
           "DeadlineExceededError", "RequestCancelled"]


class ServeError(RuntimeError):
    """Typed failure of the serving subsystem (bad shapes, closed
    batchers, unknown models)."""


class OverloadError(ServeError):
    """Admission rejected: the batcher queue is at its request-count
    or byte cap (``MXNET_SERVE_MAX_QUEUE`` / ``_BYTES``).  Shedding at
    submit time is deliberate — an unbounded queue turns overload into
    OOM and every queued caller's tail latency into the backlog's."""


class DeadlineExceededError(ServeError):
    """The request's deadline passed before it was dispatched.  The
    dispatcher sheds expired requests *before* padding/dispatch, so an
    expired row never rides through the device."""


class RequestCancelled(ServeError):
    """The caller abandoned the request (:meth:`ServeFuture.cancel`)
    and its queue slot was reclaimed before dispatch."""


#: default batch rungs: powers of two through 32
DEFAULT_BATCHES = (1, 2, 4, 8, 16, 32)

#: hard cap on one rung
MAX_BATCH_RUNG = 4096

#: hard cap on the rung COUNT — the ladder's whole point is a small
#: finite program set; past this the warm cost stops being a load-time
#: detail
MAX_RUNGS = 64


class BucketLadder:
    """The finite set of padded shapes the serving path may run at.

    Parameters
    ----------
    batches : sequence of int
        Batch rungs — any strictly ascending list of positive ints,
        not just powers of two.  Validated strictly ascending (a
        duplicate or out-of-order rung is a config typo worth failing
        loudly on) and
        capped at :data:`MAX_BATCH_RUNG` per rung /
        :data:`MAX_RUNGS` rungs.  A request of n rows maps to the
        smallest rung >= n; n larger than the top rung is the
        caller's problem (the batcher splits, direct callers get a
        :class:`ServeError`).
    seq_axes : dict axis -> multiple, optional
        Non-batch axes rounded UP to the next multiple.  Axis numbers
        are into the full input shape (batch is axis 0, so the first
        sequence-ish axis is 1).
    seq_max : dict axis -> cap, optional
        Hard upper bound per rounded axis — a longer input raises
        instead of compiling an unplanned program.
    """

    def __init__(self, batches=DEFAULT_BATCHES, seq_axes=None,
                 seq_max=None):
        rungs = [int(b) for b in batches]
        if not rungs or rungs[0] < 1:
            raise ServeError("bucket ladder needs positive batch rungs, "
                             "got %r" % (batches,))
        for lo, hi in zip(rungs, rungs[1:]):
            if hi <= lo:
                raise ServeError(
                    "bucket ladder rungs must be strictly ascending "
                    "(got %r — a duplicate or out-of-order rung is a "
                    "config typo, not an ordering preference)"
                    % (list(batches),))
        if rungs[-1] > MAX_BATCH_RUNG:
            raise ServeError(
                "bucket ladder rung %d exceeds the %d cap — each rung "
                "is one program at that batch size"
                % (rungs[-1], MAX_BATCH_RUNG))
        if len(rungs) > MAX_RUNGS:
            raise ServeError(
                "bucket ladder has %d rungs, over the %d cap — the "
                "ladder must stay a small finite program set"
                % (len(rungs), MAX_RUNGS))
        self.batches = tuple(rungs)
        self.seq_axes = {int(a): int(m)
                         for a, m in (seq_axes or {}).items()}
        for a, m in self.seq_axes.items():
            if a == 0 or m < 1:
                raise ServeError(
                    "seq_axes rounds non-batch axes up to a positive "
                    "multiple (got axis %d multiple %d)" % (a, m))
        self.seq_max = {int(a): int(m) for a, m in (seq_max or {}).items()}

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
        raise ServeError(
            "request batch %d exceeds the ladder's top rung %d — split "
            "the request or extend the ladder" % (n, self.max_batch))

    def round_axis(self, axis, size):
        """*size* rounded up per this ladder's rule for *axis* (identity
        when the axis carries no rule)."""
        mult = self.seq_axes.get(int(axis))
        if mult is None:
            return int(size)
        rounded = ((int(size) + mult - 1) // mult) * mult
        cap = self.seq_max.get(int(axis))
        if cap is not None and rounded > cap:
            raise ServeError(
                "axis %d size %d rounds to %d, over the ladder cap %d"
                % (axis, size, rounded, cap))
        return rounded

    def pad_shape(self, shape):
        """The bucketed (padded) full shape for a natural input
        *shape*: batch to its rung, rounded axes up to their multiple,
        everything else unchanged."""
        shape = tuple(int(s) for s in shape)
        if not shape:
            return shape
        out = [self.batch_for(shape[0])]
        for ax in range(1, len(shape)):
            out.append(self.round_axis(ax, shape[ax]))
        return tuple(out)

    def bucket_key(self, shapes):
        """Canonical hashable key for a {name: padded_shape} dict —
        what the predictor's program table is keyed on."""
        return tuple(sorted((n, tuple(s)) for n, s in shapes.items()))

    def __repr__(self):
        extra = ""
        if self.seq_axes:
            extra = ", seq_axes=%r" % (self.seq_axes,)
        return "BucketLadder(batches=%r%s)" % (list(self.batches), extra)
