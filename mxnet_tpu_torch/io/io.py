"""Data iterators (port of ``mxnet_tpu/io/io.py``: DataDesc, DataBatch,
DataIter, NDArrayIter, ResizeIter, PrefetchingIter, MNISTIter, CSVIter).

Iterators produce host batches: NDArrays on the CPU, which the executor
copies onto its device (into the fused step's static buffers on the
card).  ``PrefetchingIter`` decodes on a background thread and, given a
device, places batches there from that thread (pinned staging, a copy
stream of its own, an event a batch that the consumer's stream waits
on); ``ImageRecordIter`` and ``DevicePrefetcher`` use it so.

Not ported: ``LibSVMIter`` (CSR storage, ROADMAP queue A item 12); the
elastic partitioning and resumable positions of the reference's
iterators (item 15).
"""

from __future__ import annotations

import collections
import gzip
import logging
import queue
import struct
import time

import numpy as _np
import torch

from .. import ndarray as nd
from .. import sanitizer as _san
from ..base import MXNetError
from ..context import cpu
from ..ndarray import NDArray
from ..ndarray.ndarray import _from_numpy
from ..observability import metrics as _obs_metrics

# module-level ref — sampled once per consumed batch
_PREFETCH_DEPTH = _obs_metrics.gauge(
    "prefetch_queue_depth",
    "batches buffered in the PrefetchingIter producer queue")

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "ResizeIter",
           "PrefetchingIter", "MNISTIter", "CSVIter", "LibSVMIter"]


class DataDesc(collections.namedtuple("DataDesc", ["name", "shape"])):
    """Name and shape (and dtype, layout) of a data slot."""

    def __new__(cls, name, shape, dtype=_np.float32, layout="NCHW"):
        ret = super().__new__(cls, name, shape)
        ret.dtype = dtype
        ret.layout = layout
        return ret

    @staticmethod
    def get_batch_axis(layout):
        return 0 if layout is None else layout.find("N")


class DataBatch:
    """One mini-batch: lists of data and label arrays, the trailing pad
    rows, and the sample indices."""

    def __init__(self, data, label=None, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        if data is not None and not isinstance(data, (list, tuple)):
            data = [data]
        if label is not None and not isinstance(label, (list, tuple)):
            label = [label]
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label

    def __str__(self):
        data_shapes = [d.shape for d in self.data] if self.data else None
        label_shapes = [l.shape for l in self.label] if self.label else None
        return "{}: data shapes: {} label shapes: {}".format(
            type(self).__name__, data_shapes, label_shapes)


class DataIter:
    """The iterator protocol: ``next`` -> DataBatch or StopIteration."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self):
        raise NotImplementedError

    def getdata(self):
        raise NotImplementedError

    def getlabel(self):
        raise NotImplementedError

    def getindex(self):
        return None

    def getpad(self):
        raise NotImplementedError


def _init_data(data, allow_empty, default_name):
    """Input data as a list of (name, numpy array)."""
    assert data is not None or allow_empty
    if data is None:
        data = []
    if isinstance(data, (_np.ndarray, NDArray)):
        data = [data]
    if isinstance(data, list):
        if not allow_empty:
            assert len(data) > 0
        if len(data) == 1:
            data = collections.OrderedDict([(default_name, data[0])])
        else:
            data = collections.OrderedDict(
                [("_%d_%s" % (i, default_name), d)
                 for i, d in enumerate(data)])
    if not isinstance(data, dict):
        raise TypeError("Input must be NDArray, numpy.ndarray, a list of "
                        "them or dict with them as values")
    return [(k, v.asnumpy() if isinstance(v, NDArray) else _np.asarray(v))
            for k, v in data.items()]


class NDArrayIter(DataIter):
    """Batches over in-memory arrays, optionally shuffled each epoch.  A
    last partial batch is padded by wrapping to the epoch's start
    (``pad``, ``getpad`` counts the rows), dropped (``discard``), or
    carried into the next epoch (``roll_over``)."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label", shuffle_seed=None):
        super().__init__(batch_size)
        self.data = _init_data(data, allow_empty=False,
                               default_name=data_name)
        self.label = _init_data(label, allow_empty=True,
                                default_name=label_name)
        self.idx = _np.arange(self.data[0][1].shape[0])
        self.shuffle = shuffle
        # permutations come from a private stream seeded once from
        # numpy's global one (np.random.seed keeps runs reproducible)
        self._shuffle_seed = None
        if shuffle:
            self._shuffle_seed = int(shuffle_seed) if shuffle_seed is not \
                None else int(_np.random.randint(0, 2 ** 31 - 1))
        self._shuffle_drawn = 0
        self.last_batch_handle = last_batch_handle
        self.num_data = self.idx.shape[0]
        if self.num_data < batch_size:
            raise ValueError("batch_size %d exceeds the data size %d"
                             % (batch_size, self.num_data))
        self.cursor = -batch_size
        self.num_source = len(self.data)
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.label]

    def _reshuffle(self):
        rs = _np.random.RandomState([self._shuffle_seed,
                                     self._shuffle_drawn])
        self._shuffle_drawn += 1
        rs.shuffle(self.idx)

    def hard_reset(self):
        if self.shuffle:
            self._reshuffle()
        self.cursor = -self.batch_size

    def reset(self):
        if self.shuffle:
            self._reshuffle()
        if self.last_batch_handle == "roll_over" and \
                self.num_data - self.batch_size < self.cursor < \
                self.num_data:
            self.cursor = -self.batch_size + (self.cursor - self.num_data)
        else:
            self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        return self.cursor < self.num_data

    def next(self):
        if not self.iter_next():
            raise StopIteration
        if self.last_batch_handle == "discard" and \
                self.cursor + self.batch_size > self.num_data:
            raise StopIteration
        return DataBatch(data=self.getdata(), label=self.getlabel(),
                         pad=self.getpad(), index=self.getindex())

    def _sel(self):
        """The dataset indices of the current batch; past the end they
        wrap to the epoch's start."""
        lo, hi = self.cursor, self.cursor + self.batch_size
        if hi <= self.num_data:
            return self.idx[max(lo, 0):hi] if lo >= 0 else _np.concatenate(
                [self.idx[lo:], self.idx[:hi]])
        return _np.concatenate(
            [self.idx[lo:], self.idx[_np.arange(hi - self.num_data)
                                     % self.num_data]])

    def _getdata(self, source):
        # nd.array stores 64-bit host data as the reference does
        sel = self._sel()
        return [nd.array(v[sel], ctx=cpu()) for _, v in source]

    def getdata(self):
        return self._getdata(self.data)

    def getlabel(self):
        return self._getdata(self.label) if self.label else []

    def getpad(self):
        if self.last_batch_handle == "pad" and \
                self.cursor + self.batch_size > self.num_data:
            return self.cursor + self.batch_size - self.num_data
        return 0


class ResizeIter(DataIter):
    """*data_iter* resized to *size* batches an epoch (wrapping it)."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__()
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None
        self.provide_data = data_iter.provide_data
        self.provide_label = data_iter.provide_label
        self.batch_size = data_iter.batch_size

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


class _Stager:
    """Host tensors onto a CUDA device from a producer thread.  Each host
    tensor is copied into a pinned staging buffer, then to the device
    with ``non_blocking=True`` on the stager's own stream, so the copy
    neither waits for nor delays the kernels on the consumer's stream.
    A staging buffer is reused only after its last copy's event has
    completed (two buffers a shape and dtype, in turns)."""

    def __init__(self, device):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self._slots = {}    # (shape, dtype) -> deque of [pinned, event]

    def put(self, t):
        """A device copy of host tensor *t*, issued on the stream."""
        key = (tuple(t.shape), t.dtype)
        slots = self._slots.get(key)
        if slots is None:
            slots = self._slots[key] = collections.deque(
                [torch.empty(key[0], dtype=t.dtype, pin_memory=True), None]
                for _ in range(2))
        slot = slots[0]
        slots.rotate(-1)
        if slot[1] is not None:
            slot[1].synchronize()       # its previous copy has landed
        slot[0].copy_(t)
        with torch.cuda.stream(self.stream):
            out = torch.empty(key[0], dtype=t.dtype, device=self.device)
            out.copy_(slot[0], non_blocking=True)
            slot[1] = torch.cuda.Event()
            slot[1].record(self.stream)
        return out

    def ready(self):
        """An event recorded on the stream after everything issued so
        far (a batch's copies)."""
        ev = torch.cuda.Event()
        ev.record(self.stream)
        return ev


def _batch_tensors(batch):
    for arr in (batch.data or []) + (batch.label or []):
        if isinstance(arr, NDArray):
            yield arr._data


class PrefetchingIter(DataIter):
    """One iterator read ahead on a background thread, *prefetch_depth*
    batches deep (reference: io.py PrefetchingIter, C++
    iter_prefetcher.h).

    Failure semantics: an exception in the producer is raised from
    ``next`` once, then the epoch ends (never a hang on a dead
    producer); ``reset`` stops the producer (it only blocks in a
    stop-aware put) and starts a fresh one.  An optional *retry* spec
    (kwargs for :func:`..resilience.retry.retry_call`) retries transient
    inner-iterator failures with jittered backoff.

    With a CUDA *device* (``ImageRecordIter`` passes the caller's
    context, :class:`DevicePrefetcher` its target) the producer also
    places each batch there: host arrays go through pinned staging
    buffers and a copy stream of its own (:class:`_Stager`), and the
    batch carries an event recorded after its copies.  The consumer's
    ``next`` makes its current stream wait on that event and marks the
    tensors as used on that stream (``record_stream``), so the caching
    allocator keeps them until the consumer's work is done.  Without a
    device, batches pass through as the inner iterator made them.

    Not ported: ``state_dict``/``load_state``/``repartition`` (the
    resumable position; ROADMAP queue A item 15)."""

    def __init__(self, iters, rename_data=None, rename_label=None,
                 prefetch_depth=2, retry=None, device=None):
        super().__init__()
        if not isinstance(iters, list):
            iters = [iters]
        assert len(iters) == 1, "PrefetchingIter wraps one iterator"
        self.iters = iters
        self.rename_data = rename_data
        self.rename_label = rename_label
        self.batch_size = iters[0].batch_size
        self._depth = prefetch_depth
        self._retry = dict(retry) if retry else None
        # the target is resolved on the caller's thread (contexts are
        # thread-local) before the producer starts
        self._device = device
        self._stager = _Stager(device) if device is not None and \
            device.type == "cuda" else None
        self._queue = None
        self._stop = None
        self._thread = None
        self._peek = None
        self.current_batch = None
        self._start()

    @property
    def provide_data(self):
        return self.iters[0].provide_data

    @property
    def provide_label(self):
        return self.iters[0].provide_label

    @staticmethod
    def _put(q, stop, item):
        """Stop-aware put: never blocks past a reset() request."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _next_inner(self):
        if self._retry:
            from ..resilience.retry import retry_call
            cfg = dict(self._retry)
            cfg.setdefault("retry_on", (Exception,))
            give_up = tuple(cfg.pop("give_up_on", ()))
            return retry_call(self.iters[0].next,
                              give_up_on=give_up + (StopIteration,),
                              **cfg)
        return self.iters[0].next()

    def _put_array(self, arr):
        """One array of a batch on the target device (producer thread)."""
        if isinstance(arr, NDArray):
            t = arr._data
        elif isinstance(arr, torch.Tensor):
            t = arr
        else:
            t = _from_numpy(_np.asarray(arr))
        if t.device == self._device:
            self._note_elided()
            return arr if isinstance(arr, NDArray) else NDArray(t)
        if self._stager is None:
            return NDArray(t.to(self._device))
        return NDArray(self._stager.put(t.detach()))

    def _transform(self, batch):
        """Producer-side per-batch hook, run before the batch enters the
        ring: places it on the target device when there is one."""
        if self._device is None:
            return batch
        out = DataBatch(
            data=[self._put_array(a) for a in batch.data or []],
            label=[self._put_array(a) for a in batch.label or []],
            pad=batch.pad, index=batch.index, bucket_key=batch.bucket_key,
            provide_data=batch.provide_data,
            provide_label=batch.provide_label)
        if self._stager is not None:
            out._ready = self._stager.ready()
        return out

    def _producer(self, q, stop):
        # q/stop are bound per thread: a producer abandoned by reset()
        # keeps talking to ITS queue and stop event.  On the card the
        # thread's current stream is the stager's, so an inner
        # iterator's device batches are waited for there, not on the
        # consumer's stream.
        if self._stager is not None:
            with torch.cuda.stream(self._stager.stream):
                self._produce(q, stop)
        else:
            self._produce(q, stop)

    def _produce(self, q, stop):
        while not stop.is_set():
            try:
                batch = self._transform(self._next_inner())
            except StopIteration:
                self._put(q, stop, None)
                return
            except Exception as e:      # travels to the consumer
                self._put(q, stop, e)
                self._put(q, stop, None)
                return
            if not self._put(q, stop, batch):
                return

    def _start(self):
        self._closed = False
        self._queue = _san.queue(maxsize=self._depth)
        self._stop = _san.event()
        self._thread = _san.thread(target=self._producer,
                                   args=(self._queue, self._stop),
                                   daemon=True)
        self._thread.start()

    def _stop_producer(self):
        self._stop.set()
        # drain-then-join: the producer can only block in the stop-aware
        # _put, so freeing slots always unwedges it.  Bounded: a
        # producer wedged inside the inner iterator is detached
        deadline = time.monotonic() + 10.0
        while self._thread is not None and self._thread.is_alive():
            try:
                while True:
                    self._queue.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.1)
            if time.monotonic() > deadline:
                logging.getLogger(__name__).warning(
                    "PrefetchingIter: producer thread did not exit "
                    "within 10s (inner iterator wedged?); detaching it")
                break

    def reset(self):
        self._stop_producer()
        self.iters[0].reset()
        self._peek = None
        self.current_batch = None
        self._start()

    def close(self):
        """Stop the producer and drop buffered batches (a ring on the
        card holds depth x batch bytes of device memory); ``reset``
        starts a fresh producer."""
        self._stop_producer()
        self._closed = True
        self._peek = None
        self.current_batch = None

    def _note_elided(self):
        """Producer-side hook: an array already on the target was passed
        through without a copy."""

    def _note_occupancy(self, occupancy):
        """Consumer-side hook with the ring occupancy before the pop
        (0 = the consumer is about to block on input)."""
        _PREFETCH_DEPTH.set(occupancy)

    def _note_delivery(self, occupancy, wait_s):
        """Consumer-side hook after a real batch was popped: *wait_s* is
        how long the consumer blocked on the ring."""

    def _receive(self, batch):
        """Order the consumer's stream after the batch's copies."""
        ready = getattr(batch, "_ready", None)
        if ready is None:
            return
        stream = torch.cuda.current_stream(self._stager.device)
        stream.wait_event(ready)
        for t in _batch_tensors(batch):
            if t.device.type == "cuda":
                t.record_stream(stream)

    def next(self):
        if self._peek is not None:
            batch, self._peek = self._peek, None
            self.current_batch = batch
            return batch
        if self._closed:
            raise RuntimeError(
                "%s.next() after close(): the producer is stopped and the "
                "ring drained; reset() starts a fresh producer"
                % type(self).__name__)
        occupancy = self._queue.qsize()
        self._note_occupancy(occupancy)
        t0 = time.perf_counter()
        item = self._queue.get()
        if item is None:
            raise StopIteration
        if isinstance(item, Exception):
            raise item
        self._note_delivery(occupancy, time.perf_counter() - t0)
        self._receive(item)
        self.current_batch = item
        return item

    def iter_next(self):
        """A True return makes the batch the next ``next()``'s too."""
        if self._peek is not None:
            return True
        try:
            self._peek = self.next()
        except StopIteration:
            return False
        return True

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


def _open_maybe_gz(path):
    return gzip.open(path, "rb") if path.endswith(".gz") else \
        open(path, "rb")


def _read_idx_images(path):
    with _open_maybe_gz(path) as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        if magic != 2051:
            raise MXNetError("bad idx image magic in %s" % path)
        return _np.frombuffer(f.read(n * rows * cols),
                              dtype=_np.uint8).reshape(n, rows, cols)


def _read_idx_labels(path):
    with _open_maybe_gz(path) as f:
        magic, n = struct.unpack(">II", f.read(8))
        if magic != 2049:
            raise MXNetError("bad idx label magic in %s" % path)
        return _np.frombuffer(f.read(n), dtype=_np.uint8)


class _Wrapped(DataIter):
    """An iterator that serves an inner NDArrayIter."""

    @property
    def provide_data(self):
        return self._inner.provide_data

    @property
    def provide_label(self):
        return self._inner.provide_label

    def reset(self):
        self._inner.reset()

    def next(self):
        return self._inner.next()

    def iter_next(self):
        return self._inner.iter_next()


class MNISTIter(_Wrapped):
    """MNIST idx-ubyte files (optionally gzipped), scaled to [0, 1], as
    (N, 1, rows, cols) or flat; the last partial batch is dropped
    (reference: src/io/iter_mnist.cc)."""

    def __init__(self, image, label, batch_size=128, shuffle=True,
                 flat=False, silent=False, seed=0, input_shape=None,
                 **kwargs):
        data, labels = _read_idx_images(image), _read_idx_labels(label)
        if flat:
            data = data.reshape(data.shape[0], -1)
        else:
            data = data.reshape(data.shape[0], 1, data.shape[1],
                                data.shape[2])
        if input_shape is not None:
            data = data.reshape((data.shape[0],) + tuple(input_shape))
        data = data.astype(_np.float32) / 255.0
        self._inner = NDArrayIter(data, labels.astype(_np.float32),
                                  batch_size=batch_size, shuffle=shuffle,
                                  last_batch_handle="discard")
        super().__init__(batch_size)


class CSVIter(_Wrapped):
    """Dense CSV files of data (and labels), each row reshaped to
    *data_shape* (reference: src/io/iter_csv.cc)."""

    def __init__(self, data_csv, data_shape, label_csv=None,
                 label_shape=(1,), batch_size=1, round_batch=True,
                 **kwargs):
        data = _np.loadtxt(data_csv, delimiter=",", dtype=_np.float32,
                           ndmin=2).reshape((-1,) + tuple(data_shape))
        if label_csv is not None:
            label = _np.loadtxt(label_csv, delimiter=",", dtype=_np.float32,
                                ndmin=1)
        else:
            label = _np.zeros((data.shape[0],), _np.float32)
        self._inner = NDArrayIter(
            data, label, batch_size=batch_size,
            last_batch_handle="pad" if round_batch else "discard")
        super().__init__(batch_size)


class LibSVMIter(DataIter):
    """LibSVM files as CSR batches: not ported (CSR storage, ROADMAP queue
    A item 12)."""

    def __init__(self, *args, **kwargs):
        raise MXNetError("LibSVMIter is not ported to mxnet_tpu_torch (it "
                         "yields CSR batches; ROADMAP queue A item 12)")
