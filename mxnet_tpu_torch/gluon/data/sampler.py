"""Samplers (port of ``mxnet_tpu/gluon/data/sampler.py``; reference:
python/mxnet/gluon/data/sampler.py).  Pure index logic."""

from __future__ import annotations

import numpy as _np

__all__ = ["Sampler", "SequentialSampler", "RandomSampler", "BatchSampler",
           "ElasticBatchSampler"]


class Sampler:
    def __len__(self):
        raise NotImplementedError

    def __iter__(self):
        raise NotImplementedError


class SequentialSampler(Sampler):
    def __init__(self, length):
        self._length = length

    def __iter__(self):
        return iter(range(self._length))

    def __len__(self):
        return self._length


class RandomSampler(Sampler):
    """Uniform shuffle.  With *seed*, each epoch's permutation is
    drawn from a PRIVATE ``RandomState([seed, epoch])`` stream, which
    makes the shuffle order resumable: ``state_dict()`` records
    ``(seed, epochs drawn)`` and a restored sampler re-draws the
    in-progress epoch's exact permutation.  Without a seed the legacy
    global-``np.random`` behavior is kept (order not capturable)."""

    def __init__(self, length, seed=None):
        self._length = length
        self._seed = seed
        self._drawn = 0         # permutations handed out so far

    def __iter__(self):
        if self._seed is None:
            indices = _np.random.permutation(self._length)
        else:
            rs = _np.random.RandomState([self._seed, self._drawn])
            indices = rs.permutation(self._length)
        self._drawn += 1
        return iter(indices.tolist())

    def __len__(self):
        return self._length

    def state_dict(self):
        return {"seed": self._seed, "drawn": self._drawn}

    def load_state(self, state, in_progress=False):
        """Restore the stream position.  *in_progress* = the captured
        state was taken mid-epoch: rewind one draw so the next
        ``iter()`` regenerates that epoch's exact permutation."""
        self._seed = state["seed"]
        self._drawn = int(state["drawn"])
        if in_progress and self._drawn > 0:
            self._drawn -= 1


class ElasticBatchSampler(Sampler):
    """Worker-sharded batches over a SHARED deterministic global order
    — the gluon-side elastic partition (docs/resilience.md "Elastic
    training").

    Every worker constructs it with the same ``(length, batch_size,
    seed)``; epoch *e*'s global order is drawn from
    ``RandomState([seed, e])`` (or ``arange`` when ``shuffle=False``),
    walked in GLOBAL rounds of ``batch_size * num_parts`` samples, and
    each worker yields only its ``part_index``-th slice of each round
    — so the union of all parts covers each epoch index exactly once.

    ``repartition()`` re-shards at the next batch boundary: the
    generator reads the partition and the global cursor live, so a
    mid-epoch shrink/grow keeps exactly-once coverage.  A mid-epoch
    joiner restores a survivor's ``state_dict()`` (``load_state(...,
    in_progress=True)`` resumes at the exact global cursor — the
    sampler sets ``exact_resume`` so DataLoader does no extra batch
    skipping) and repartitions to its own slot; the post-resize stream
    is bit-reproducible from that state alone.

    ``last_batch``: ``'discard'`` drops a final partial global round;
    ``'keep'`` splits its tail contiguously by position (ragged or
    empty per-worker batches — exactly-once, no padding)."""

    #: DataLoader.load_state: this sampler resumes at its own exact
    #: global cursor; do NOT fast-forward by delivered-batch count
    #: (batch->sample mapping changes across resizes).
    exact_resume = True

    def __init__(self, length, batch_size, part_index=0, num_parts=1,
                 shuffle=True, seed=0, last_batch="discard"):
        if last_batch not in ("discard", "keep"):
            raise ValueError("last_batch must be 'discard' or 'keep', "
                             "got %r" % (last_batch,))
        self._length = int(length)
        self._batch_size = int(batch_size)
        self._shuffle = bool(shuffle)
        self._seed = int(seed)
        self._last_batch = last_batch
        self._part = 0
        self._parts = 1
        self.repartition(part_index, num_parts)
        self._drawn = 0      # epochs begun
        self._epoch = -1     # epoch currently iterating
        self._cursor = 0     # global samples consumed this epoch
        self._pending = None  # (epoch, cursor) resume position

    def repartition(self, part_index, num_parts):
        """Become slice *part_index* of *num_parts* starting at the
        NEXT batch boundary (the live generator reads these fields per
        round; the global cursor is untouched)."""
        part_index, num_parts = int(part_index), int(num_parts)
        if not 0 <= part_index < num_parts:
            raise ValueError("part_index %d not in [0, %d)"
                             % (part_index, num_parts))
        if self._length < self._batch_size * num_parts:
            raise ValueError(
                "global batch (batch_size %d * num_parts %d) must not "
                "exceed the dataset length %d"
                % (self._batch_size, num_parts, self._length))
        self._part, self._parts = part_index, num_parts

    def _order(self, epoch):
        if not self._shuffle:
            return _np.arange(self._length)
        return _np.random.RandomState(
            [self._seed, epoch]).permutation(self._length)

    def __iter__(self):
        if self._pending is not None:
            epoch, cursor = self._pending
            self._pending = None
        else:
            epoch, cursor = self._drawn, 0
        self._epoch = epoch
        self._drawn = epoch + 1
        self._cursor = cursor
        order = self._order(epoch)
        n = self._length
        while True:
            b = self._batch_size
            round_ = b * self._parts
            start = self._cursor
            if start >= n:
                return
            if start + round_ > n:
                if self._last_batch == "discard":
                    self._cursor = n
                    return
                # 'keep': the tail splits contiguously by position
                tail = order[start:]
                lo = min(self._part * b, len(tail))
                hi = min(lo + b, len(tail))
                self._cursor = n
                if hi > lo:
                    yield [int(i) for i in tail[lo:hi]]
                return
            sel = order[start + self._part * b:
                        start + (self._part + 1) * b]
            self._cursor = start + round_
            yield [int(i) for i in sel]

    def __len__(self):
        round_ = self._batch_size * self._parts
        full = self._length // round_
        if self._last_batch == "discard":
            return full
        # 'keep': the tail splits contiguously by position — THIS
        # part yields a final (ragged) batch only if the tail reaches
        # its slice
        tail = self._length - full * round_
        return full + (1 if tail > self._part * self._batch_size
                       else 0)

    def state_dict(self):
        return {"type": type(self).__name__,
                "seed": self._seed, "shuffle": self._shuffle,
                "epoch": self._epoch, "drawn": self._drawn,
                "cursor": int(self._cursor),
                "part_index": self._part, "num_parts": self._parts}

    def load_state(self, state, in_progress=False):
        """Restore; *in_progress* resumes the captured epoch at its
        exact global cursor (a joiner then ``repartition()``s to its
        own slot), otherwise the next ``iter()`` starts the next
        epoch in lockstep with the captured stream."""
        self._seed = int(state["seed"])
        self._shuffle = bool(state.get("shuffle", True))
        self._drawn = int(state["drawn"])
        self.repartition(int(state.get("part_index", 0)),
                         int(state.get("num_parts", 1)))
        if in_progress:
            self._pending = (int(state["epoch"]),
                             int(state["cursor"]))
        else:
            self._pending = None


class BatchSampler(Sampler):
    """Wrap a sampler into batches; last_batch in {keep, discard,
    rollover}."""

    def __init__(self, sampler, batch_size, last_batch="keep"):
        self._sampler = sampler
        self._batch_size = batch_size
        self._last_batch = last_batch
        self._prev = []
        self._epoch_prev = []   # leftovers the CURRENT epoch started with

    def __iter__(self):
        batch, self._prev = self._prev, []
        # remember what this epoch consumed from the previous one: a
        # mid-epoch resume must regenerate the SAME epoch stream,
        # leftovers included (rollover semantics)
        self._epoch_prev = list(batch)
        for i in self._sampler:
            batch.append(i)
            if len(batch) == self._batch_size:
                yield batch
                batch = []
        if batch:
            if self._last_batch == "keep":
                yield batch
            elif self._last_batch == "discard":
                return
            elif self._last_batch == "rollover":
                self._prev = batch
            else:
                raise ValueError(
                    "last_batch must be one of 'keep', 'discard', or "
                    "'rollover', but got %s" % self._last_batch)

    def __len__(self):
        if self._last_batch == "keep":
            return (len(self._sampler) + self._batch_size - 1) // \
                self._batch_size
        if self._last_batch == "discard":
            return len(self._sampler) // self._batch_size
        if self._last_batch == "rollover":
            return (len(self._prev) + len(self._sampler)) // \
                self._batch_size
        raise ValueError("last_batch must be one of 'keep', 'discard', or "
                         "'rollover', but got %s" % self._last_batch)

    def state_dict(self):
        st = {"prev": list(self._prev),
              "epoch_prev": list(self._epoch_prev)}
        sd = getattr(self._sampler, "state_dict", None)
        if sd is not None:
            st["sampler"] = sd()
        return st

    def load_state(self, state, in_progress=False):
        """Restore; *in_progress* = the state was captured mid-epoch,
        so the next ``iter()`` must REGENERATE that epoch — it starts
        from the leftovers that epoch consumed, and the inner sampler
        rewinds to re-draw its permutation."""
        if in_progress:
            self._prev = list(state.get("epoch_prev") or [])
        else:
            self._prev = list(state.get("prev") or [])
        inner = state.get("sampler")
        if inner is not None:
            try:
                self._sampler.load_state(inner, in_progress=in_progress)
            except TypeError:
                # custom sampler without the flag: positional restore
                self._sampler.load_state(inner)
