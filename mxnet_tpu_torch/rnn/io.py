"""Bucketing iterator for variable-length sequences (port of
``mxnet_tpu/rnn/io.py``): ``BucketSentenceIter`` puts each sentence in
the smallest bucket that fits, pads it to the bucket's length, and
yields batches tagged with ``bucket_key`` so ``BucketingModule`` picks
the executor of that length.  Shuffling uses ``random.Random(seed)``, so
one seed gives the JAX package's batches in the same order.  Batches are
host (CPU) NDArrays, as every iterator of ``mx.io`` yields.
"""

from __future__ import annotations

import random as _random

import numpy as _np

from ..context import cpu
from ..io.io import DataBatch, DataDesc, DataIter
from .. import ndarray as nd

__all__ = ["BucketSentenceIter"]


class BucketSentenceIter(DataIter):
    """Batches of bucketed sentences.

    sentences: list of lists of int token ids.  Labels are the inputs
    shifted by one (next-token prediction), padded with invalid_label.
    """

    def __init__(self, sentences, batch_size, buckets=None,
                 invalid_label=-1, data_name="data",
                 label_name="softmax_label", dtype="float32",
                 layout="NT", shuffle=True, seed=0):
        if layout != "NT":
            raise ValueError(
                "only layout='NT' (batch-major) is implemented; got %r"
                % (layout,))
        if buckets is None:
            lens = _np.bincount([len(s) for s in sentences])
            buckets = [i for i, n in enumerate(lens)
                       if n >= batch_size]
            if not buckets:
                buckets = [max(len(s) for s in sentences)]
        buckets = sorted(buckets)
        self.buckets = buckets
        self.batch_size = batch_size
        self.invalid_label = invalid_label
        self.data_name = data_name
        self.label_name = label_name
        self._dtype = dtype
        self._shuffle = shuffle
        self._rng = _random.Random(seed)

        self.data = [[] for _ in buckets]
        ndiscard = 0
        for s in sentences:
            buck = None
            for i, blen in enumerate(buckets):
                if len(s) <= blen:
                    buck = i
                    break
            if buck is None:
                ndiscard += 1
                continue
            padded = _np.full((buckets[buck],), invalid_label,
                              dtype=_np.float32)
            padded[:len(s)] = s
            self.data[buck].append(padded)
        self.data = [_np.asarray(x) if x else
                     _np.zeros((0, b)) for x, b in zip(self.data, buckets)]
        self._ndiscard = ndiscard
        if ndiscard:
            import logging
            logging.warning(
                "BucketSentenceIter: discarded %d sentences longer than "
                "the largest bucket (%d)", ndiscard, buckets[-1])

        self.default_bucket_key = max(buckets)
        super().__init__(batch_size)
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc(self.data_name,
                         (self.batch_size, self.default_bucket_key))]

    @property
    def provide_label(self):
        return [DataDesc(self.label_name,
                         (self.batch_size, self.default_bucket_key))]

    def reset(self):
        self._plan = []
        for i, d in enumerate(self.data):
            n = len(d) // self.batch_size
            order = list(range(len(d)))
            if self._shuffle:
                self._rng.shuffle(order)
            for j in range(n):
                self._plan.append(
                    (i, order[j * self.batch_size:(j + 1) *
                              self.batch_size]))
        if self._shuffle:
            self._rng.shuffle(self._plan)
        self._cursor = 0

    def next(self):
        if self._cursor >= len(self._plan):
            raise StopIteration
        bucket, rows = self._plan[self._cursor]
        self._cursor += 1
        seqs = self.data[bucket][rows]
        label = _np.full_like(seqs, self.invalid_label)
        label[:, :-1] = seqs[:, 1:]
        blen = self.buckets[bucket]
        return DataBatch(
            data=[nd.array(seqs.astype(self._dtype), ctx=cpu())],
            label=[nd.array(label.astype(self._dtype), ctx=cpu())],
            bucket_key=blen,
            provide_data=[DataDesc(self.data_name,
                                   (self.batch_size, blen))],
            provide_label=[DataDesc(self.label_name,
                                    (self.batch_size, blen))])
