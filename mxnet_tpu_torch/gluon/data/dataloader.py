"""Gluon DataLoader (port of ``mxnet_tpu/gluon/data/dataloader.py``;
reference: python/mxnet/gluon/data/dataloader.py).

The reference forks worker processes and ships NDArrays through POSIX shared
memory (cpu_shared context, dataloader.py:26-110).  Two worker modes here:

- ``thread_workers=True``: a thread pool.  Each job runs under the
  caller's context (contexts are per thread).
- ``num_workers>0`` (default mode): worker **processes** with batches
  returned as numpy through POSIX shared memory
  (``multiprocessing.shared_memory``).  Workers are *spawned* (never
  forked) with ``CUDA_VISIBLE_DEVICES=""`` in their environment, run
  with the default context set to ``cpu(0)`` and one torch thread each,
  so they never touch the card and do not oversubscribe the cores.  The
  parent builds the batch's tensors on the host and, with
  ``pin_memory=True`` on a machine with CUDA, pins them so their copy to
  the card is a DMA.
"""

from __future__ import annotations

import logging
import os
import queue
import traceback
from concurrent.futures import ThreadPoolExecutor

import numpy as _np

log = logging.getLogger(__name__)

import torch

from ... import ndarray as nd
from ... import sanitizer as _san
from ...context import cpu, current_context
from ...ndarray.ndarray import _from_numpy
from ...observability import metrics as _obs_metrics

# module-level ref — sampled once per consumed batch
_INFLIGHT_BATCHES = _obs_metrics.gauge(
    "dataloader_inflight_batches",
    "batches issued to DataLoader workers but not yet consumed")
from ...ndarray import NDArray
from .sampler import SequentialSampler, RandomSampler, BatchSampler

__all__ = ["DataLoader", "default_batchify_fn"]


# ---------------------------------------------------------------------------
# Multiprocess worker machinery (reference: dataloader.py:26-110 —
# worker_loop + rebuild_ndarray via cpu_shared storage).
# ---------------------------------------------------------------------------

def _np_batchify(data):
    """Worker-side batchify: like default_batchify_fn but with numpy
    leaves (workers never build device arrays)."""
    first = data[0]
    if isinstance(first, NDArray):
        return _np.stack([d.asnumpy() for d in data])
    if isinstance(first, tuple):
        return tuple(_np_batchify(list(i)) for i in zip(*data))
    if isinstance(first, list):
        return [_np_batchify(list(i)) for i in zip(*data)]
    a = _np.asarray(data)
    return a.astype(_np.float32) if a.dtype == _np.float64 else a


def _tree_to_shm(obj):
    """numpy leaves -> ('shm', name, shape, dtype) descriptors; the parent
    owns the segment lifecycle (workers unregister from their tracker)."""
    from multiprocessing import shared_memory, resource_tracker
    if isinstance(obj, _np.ndarray):
        if obj.nbytes == 0:
            return ("raw", obj)
        shm = shared_memory.SharedMemory(create=True, size=obj.nbytes)
        view = _np.ndarray(obj.shape, obj.dtype, buffer=shm.buf)
        view[...] = obj
        name = shm.name
        # parent unlinks; drop this process's tracker registration so the
        # worker's exit doesn't double-unlink
        try:
            resource_tracker.unregister(shm._name, "shared_memory")
        except Exception as exc:
            # tracker internals vary across Pythons; a failed
            # unregister only risks a spurious tracker warning at
            # worker exit — keep it diagnosable, not fatal
            log.debug("shm tracker unregister failed for %s: %s",
                      shm._name, exc)
        shm.close()
        return ("shm", name, obj.shape, str(obj.dtype))
    if isinstance(obj, tuple):
        return ("tuple", [_tree_to_shm(o) for o in obj])
    if isinstance(obj, list):
        return ("list", [_tree_to_shm(o) for o in obj])
    return ("raw", obj)


def _host_array(arr, pin):
    """A host NDArray over numpy *arr* (which nothing else holds), pinned
    when asked and CUDA is there to pin for."""
    t = _from_numpy(arr)
    if pin and torch.cuda.is_available():
        t = t.pin_memory()
    return NDArray(t)


def _tree_from_shm(desc, pin=False):
    """Rebuild host NDArray leaves from shared-memory descriptors
    (parent)."""
    from multiprocessing import shared_memory
    tag = desc[0]
    if tag == "shm":
        _, name, shape, dtype = desc
        shm = shared_memory.SharedMemory(name=name)
        try:
            view = _np.ndarray(shape, dtype, buffer=shm.buf)
            # explicit host copy: the segment is about to be unmapped
            arr = _host_array(_np.array(view), pin)
        finally:
            shm.close()
            shm.unlink()
        return arr
    if tag == "tuple":
        return tuple(_tree_from_shm(d, pin) for d in desc[1])
    if tag == "list":
        return [_tree_from_shm(d, pin) for d in desc[1]]
    val = desc[1]
    return _host_array(val, pin) if isinstance(val, _np.ndarray) else val


def _worker_loop(dataset, batchify_fn, work_q, res_q):
    """Long-lived worker: pull (seq, indices), push (seq, shm_tree, err).
    Samples are built on the CPU, with one torch thread."""
    torch.set_num_threads(1)
    with cpu(0):
        _serve(dataset, batchify_fn, work_q, res_q)


def _serve(dataset, batchify_fn, work_q, res_q):
    while True:
        job = work_q.get()
        if job is None:
            break
        seq, indices = job
        try:
            batch = batchify_fn([dataset[i] for i in indices])
            res_q.put((seq, _tree_to_shm(batch), None))
        except Exception:
            # the traceback travels to the consumer and is raised there;
            # log here too so a worker whose result is never consumed
            # (shutdown race) still leaves a trace
            log.debug("dataloader worker failed on batch %d:\n%s", seq,
                      traceback.format_exc())
            res_q.put((seq, None, traceback.format_exc()))


class _MultiWorkerIter:
    """Ordered iterator over worker-process results (reference:
    dataloader.py _MultiWorkerIter with rcvd_idx ordering).

    Each worker owns a PRIVATE index queue (jobs are round-robined):
    a worker killed while blocked in ``Queue.get`` dies holding that
    queue's reader semaphore, and with a shared queue that one death
    would wedge every other reader forever.  Private queues make a
    crashed worker fully disposable — its queue is dropped, a
    replacement is spawned (with retry/backoff) onto a fresh queue,
    and exactly the batches assigned to the dead worker are
    resubmitted."""

    def __init__(self, dataset, batchify_fn, batch_sampler, num_workers,
                 prefetch, max_respawns=None, pin_memory=False):
        import multiprocessing as mp
        # spawn, never fork: the parent holds a live CUDA context and
        # threads that must not leak into children; spawned children
        # start with no visible card (set in the env below)
        self._ctx = mp.get_context("spawn")
        self._dataset = dataset
        self._batchify_fn = batchify_fn
        self._pin = pin_memory
        self._res_q = self._ctx.Queue()
        if max_respawns is None:
            from ...config import get_env
            max_respawns = get_env("MXNET_DATALOADER_RESPAWNS")
        self._max_respawns = max(0, max_respawns)
        self._respawns = 0
        self._work_qs = [self._ctx.Queue() for _ in range(num_workers)]
        self._workers = [self._spawn_worker(q) for q in self._work_qs]
        self._batches = iter(batch_sampler)
        self._sent = 0
        self._rcvd = 0
        self._buffer = {}
        self._inflight = {}     # seq -> (worker slot, indices)
        self._exhausted = False
        for _ in range(prefetch):
            self._push_next()

    #: two loaders (or a loader and a respawn) starting workers
    #: concurrently would interleave their os.environ mutation and
    #: could leave the card hidden from the parent permanently —
    #: serialize the mutate-start-restore window
    _spawn_env_lock = _san.lock(label="dataloader._spawn_env_lock")

    def _spawn_worker(self, work_q):
        worker = self._ctx.Process(
            target=_worker_loop,
            args=(self._dataset, self._batchify_fn, work_q,
                  self._res_q),
            daemon=True)
        # children inherit the env at start(): hide the card from them
        with self._spawn_env_lock:
            prev = os.environ.get("CUDA_VISIBLE_DEVICES")
            os.environ["CUDA_VISIBLE_DEVICES"] = ""
            try:
                worker.start()
            finally:
                if prev is None:
                    del os.environ["CUDA_VISIBLE_DEVICES"]
                else:
                    os.environ["CUDA_VISIBLE_DEVICES"] = prev
        return worker

    def _push_next(self):
        try:
            indices = next(self._batches)
        except StopIteration:
            self._exhausted = True
            return
        slot = self._sent % len(self._workers)
        self._inflight[self._sent] = (slot, indices)
        self._work_qs[slot].put((self._sent, indices))
        self._sent += 1

    def _revive_dead_workers(self):
        """Respawn crashed workers (retry/backoff on the spawn itself)
        onto fresh queues and resubmit exactly the batches the dead
        workers owned.  False when the respawn budget is exhausted."""
        dead = [i for i, w in enumerate(self._workers)
                if not w.is_alive()]
        if not dead:
            return True
        if self._respawns + len(dead) > self._max_respawns:
            return False
        from ...resilience.retry import retry_call
        from ...observability import events as _obs_events
        from ...observability import metrics as _metrics
        for i in dead:
            w = self._workers[i]
            log.warning("DataLoader worker pid=%s died (exitcode=%s); "
                        "respawning (%d/%d respawns used)", w.pid,
                        w.exitcode, self._respawns + 1,
                        self._max_respawns)
            self._respawns += 1
            _metrics.counter("dataloader_worker_respawns_total",
                             "dead DataLoader workers respawned").inc()
            _obs_events.emit("respawn", what="dataloader_worker",
                             slot=i, pid=w.pid, exitcode=w.exitcode,
                             used=self._respawns,
                             budget=self._max_respawns)
            # the dead worker's queue may be semaphore-poisoned (killed
            # mid-get) — discard it wholesale
            self._work_qs[i] = self._ctx.Queue()
            self._workers[i] = retry_call(
                self._spawn_worker, (self._work_qs[i],), attempts=3,
                base_delay=0.05, max_delay=0.5,
                retry_on=(OSError, RuntimeError))
            for seq in range(self._rcvd, self._sent):
                if seq in self._buffer or seq not in self._inflight:
                    continue
                slot, indices = self._inflight[seq]
                if slot == i:
                    self._work_qs[i].put((seq, indices))
        return True

    def __iter__(self):
        return self

    #: consecutive result-less seconds with live workers before the
    #: loader concludes the SHARED result queue is wedged (a worker
    #: killed mid-put can die holding its write lock — the one shared
    #: resource respawning cannot replace) and fails loudly
    _STALL_LIMIT_S = 60

    def __next__(self):
        # queue depth = batches issued to workers but not yet consumed
        # (sampled per batch: a scraper watching this gauge fall to 0
        # has found an input-bound training loop)
        _INFLIGHT_BATCHES.set(self._sent - self._rcvd)
        if self._rcvd == self._sent:
            self.shutdown()
            raise StopIteration
        stalled = 0
        while self._rcvd not in self._buffer:
            if stalled >= self._STALL_LIMIT_S:
                self.shutdown()
                raise RuntimeError(
                    "DataLoader produced no batch for %ds despite live "
                    "workers — the shared result queue is likely "
                    "poisoned (a worker was killed while holding its "
                    "write lock). Restart the loader; lower batch "
                    "sizes/augmentation cost if workers are being "
                    "OOM-killed." % self._STALL_LIMIT_S)
            try:
                seq, payload, err = self._res_q.get(timeout=1.0)
            except queue.Empty:
                stalled += 1
                # liveness check: a crashed worker (OOM-kill, segfault,
                # failed spawn import) would otherwise hang this get
                # forever — workers only exit after the shutdown sentinel
                if any(not w.is_alive() for w in self._workers) and \
                        not self._revive_dead_workers():
                    self.shutdown()
                    raise RuntimeError(
                        "DataLoader worker died unexpectedly (killed or "
                        "crashed before producing its batch; %d "
                        "respawn(s) already attempted). If this "
                        "happened at startup, the training script likely "
                        "lacks an `if __name__ == \"__main__\":` guard — "
                        "workers are spawned (never forked: the parent "
                        "holds a live CUDA context), so the main module "
                        "must be importable; alternatively pass "
                        "thread_workers=True." % self._respawns)
                continue
            if seq < self._rcvd or seq in self._buffer:
                # duplicate delivery after a respawn resubmission: the
                # original worker produced it after all — drop it and
                # unlink its shm segments
                if payload is not None:
                    self._unlink_tree(payload)
                continue
            stalled = 0
            self._buffer[seq] = (payload, err)
        payload, err = self._buffer.pop(self._rcvd)
        self._inflight.pop(self._rcvd, None)
        self._rcvd += 1
        self._push_next()
        if err is not None:
            self.shutdown()
            raise RuntimeError("DataLoader worker failed:\n%s" % err)
        return _tree_from_shm(payload, self._pin)

    @staticmethod
    def _unlink_tree(desc):
        """Release shm segments of an unconsumed result (workers
        unregistered them from their tracker; the parent owns cleanup)."""
        from multiprocessing import shared_memory
        tag = desc[0]
        if tag == "shm":
            try:
                shm = shared_memory.SharedMemory(name=desc[1])
                shm.close()
                shm.unlink()
            except FileNotFoundError:
                pass
        elif tag in ("tuple", "list"):
            for d in desc[1]:
                _MultiWorkerIter._unlink_tree(d)

    def shutdown(self):
        for q in self._work_qs:
            try:
                q.put(None)
            except (OSError, ValueError) as exc:
                # queue already closed/broken mid-teardown: the join
                # below falls back to terminate(), but say what happened
                log.debug("work queue rejected shutdown sentinel: %s",
                          exc)
        for w in self._workers:
            w.join(timeout=5)
            if w.is_alive():
                w.terminate()
        self._workers = []
        self._work_qs = []
        # drain prefetched-but-unconsumed results: their shm segments
        # survive process exit unless unlinked here (early `break` from a
        # training loop would otherwise leak /dev/shm permanently)
        while True:
            try:
                seq, payload, err = self._res_q.get_nowait()
            except (queue.Empty, OSError, ValueError):
                break
            self._buffer[seq] = (payload, err)
        for payload, _err in self._buffer.values():
            if payload is not None:
                self._unlink_tree(payload)
        self._buffer.clear()

    def __del__(self):
        if getattr(self, "_workers", None):
            self.shutdown()


def default_batchify_fn(data):
    """Stack samples into a batch (reference: dataloader.py
    default_batchify_fn): NDArray samples where they lie, host data on
    the current context."""
    if isinstance(data[0], NDArray):
        return NDArray(torch.stack([d._data for d in data]))
    if isinstance(data[0], tuple):
        data = zip(*data)
        return [default_batchify_fn(i) for i in data]
    # nd.array stores 64-bit host data as the reference does (float64 as
    # float32, int64 as int32)
    return nd.array(_np.asarray(data))


class DataLoader:
    def __init__(self, dataset, batch_size=None, shuffle=False,
                 sampler=None, last_batch=None, batch_sampler=None,
                 batchify_fn=None, num_workers=0, pin_memory=False,
                 prefetch=None, thread_workers=False):
        self._dataset = dataset
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError("batch_size must be specified unless "
                                 "batch_sampler is specified")
            if sampler is None:
                if shuffle:
                    # a private, captured seed (drawn once from the
                    # global stream, so np.random.seed reproducibility
                    # is preserved) makes the shuffle order resumable
                    # through state_dict() — see docs/resilience.md
                    sampler = RandomSampler(
                        len(dataset),
                        seed=int(_np.random.randint(0, 2 ** 31 - 1)))
                else:
                    sampler = SequentialSampler(len(dataset))
            elif shuffle:
                raise ValueError("shuffle must not be specified if sampler "
                                 "is specified")
            batch_sampler = BatchSampler(
                sampler, batch_size, last_batch if last_batch else "keep")
        elif batch_size is not None or shuffle or sampler is not None or \
                last_batch is not None:
            raise ValueError("batch_size, shuffle, sampler and last_batch "
                             "must not be specified if batch_sampler is "
                             "specified.")
        self._batch_sampler = batch_sampler
        self._batchify_fn = batchify_fn or default_batchify_fn
        self._pin_memory = bool(pin_memory)
        self._num_workers = max(0, num_workers)
        self._thread_workers = thread_workers
        self._prefetch = max(0, prefetch if prefetch is not None
                             else 2 * self._num_workers)
        self._cursor = 0        # batches delivered this epoch
        self._resume_skip = 0   # pending load_state fast-forward
        self._worker_iter = None  # live _MultiWorkerIter, if any
        self._mp_ok = None
        if self._num_workers > 0 and not thread_workers:
            # probe once (not per epoch): spawn needs picklable
            # dataset/batchify — the reference's Windows-path constraint
            batchify = (self._batchify_fn
                        if self._batchify_fn is not default_batchify_fn
                        else _np_batchify)
            try:
                import pickle

                # stream to a discarding sink: pickle.dumps would
                # materialize a full serialized copy of the dataset
                # (momentarily doubling memory for big in-memory sets)
                # just to learn whether pickling WORKS
                class _Null:
                    def write(self, b):
                        return len(b)
                pickle.Pickler(_Null()).dump(self._dataset)
                pickle.Pickler(_Null()).dump(batchify)
                self._mp_ok = True
            except Exception as exc:
                import warnings
                warnings.warn(
                    "DataLoader: dataset/batchify_fn not picklable "
                    "(%s: %s); using thread workers instead of "
                    "processes" % (type(exc).__name__, exc))
                self._mp_ok = False

    def _make_batch(self, indices):
        return self._batchify_fn([self._dataset[i] for i in indices])

    # -- resumable position (resilience subsystem) -------------------------
    def state_dict(self):
        """Mid-epoch resume position: the batch cursor (batches
        DELIVERED to the consumer this epoch — the worker-respawn
        machinery below this level resubmits crashed workers' batches,
        so issued-but-unconsumed work is deliberately not counted)
        plus the sampler's shuffle-order state."""
        st = {"type": "DataLoader", "cursor": int(self._cursor)}
        sd = getattr(self._batch_sampler, "state_dict", None)
        if sd is not None:
            st["batch_sampler"] = sd()
        return st

    def load_state(self, state):
        """Restore a :meth:`state_dict` position: the next ``iter()``
        regenerates the in-progress epoch (the sampler rewinds and
        re-draws its exact permutation, rollover leftovers included)
        and skips the already-consumed batches — index skipping only,
        no decode work is replayed."""
        if state.get("type") not in (None, "DataLoader"):
            raise ValueError("not a DataLoader state: %r"
                             % (state.get("type"),))
        bs = state.get("batch_sampler")
        cursor = int(state["cursor"])
        if bs is not None and \
                getattr(self._batch_sampler, "load_state", None):
            self._batch_sampler.load_state(bs, in_progress=cursor > 0)
            if getattr(self._batch_sampler, "exact_resume", False):
                # the sampler resumes at its own exact (global) cursor
                # — e.g. ElasticBatchSampler, whose batch->sample
                # mapping changes across resizes, so fast-forwarding
                # by delivered-batch count would skip the wrong work
                self._resume_skip = 0
                return
        self._resume_skip = cursor

    def repartition(self, part_index, num_parts):
        """Elastic re-shard (docs/resilience.md "Elastic training"):
        delegate to the batch sampler — with an
        :class:`~.sampler.ElasticBatchSampler` the change
        takes effect at the next yielded batch, mid-epoch included.

        Mid-epoch re-sharding requires the synchronous
        ``num_workers=0`` path: a worker-prefetched loader has already
        issued indices prefetch-depth batches past the consumer, and
        that skew differs per rank — the fleet would switch layouts at
        different global rounds, consuming some samples twice and
        others never.  A live multi-process iteration therefore
        refuses; repartition between epochs (no live iterator) is fine
        in any mode."""
        rp = getattr(self._batch_sampler, "repartition", None)
        if rp is None:
            raise AttributeError(
                "DataLoader.repartition needs a batch sampler with "
                "repartition() (e.g. ElasticBatchSampler); got %s"
                % type(self._batch_sampler).__name__)
        if self._worker_iter is not None:
            raise RuntimeError(
                "DataLoader.repartition mid-epoch over process workers "
                "would re-shard prefetch-depth batches late (and by a "
                "per-rank amount — exactly-once coverage breaks): use "
                "num_workers=0 for elastic training, or repartition "
                "between epochs")
        rp(part_index, num_parts)

    def __iter__(self):
        skip = self._resume_skip
        self._resume_skip = 0
        self._cursor = skip
        for batch in self._iter_batches(skip):
            self._cursor += 1
            yield batch

    def _skip_batches(self, skip):
        """Iterator over the epoch's index lists minus the first
        *skip* (cheap: indices only, nothing is decoded)."""
        it = iter(self._batch_sampler)
        for _ in range(skip):
            try:
                next(it)
            except StopIteration:
                return iter(())
        return it

    def _iter_batches(self, skip):
        batches_src = self._skip_batches(skip) if skip else \
            iter(self._batch_sampler)
        if self._num_workers == 0:
            for indices in batches_src:
                yield self._make_batch(indices)
            return
        if not self._thread_workers and self._mp_ok:
            # process workers + shared-memory transport
            batchify = (self._batchify_fn
                        if self._batchify_fn is not default_batchify_fn
                        else _np_batchify)
            it = _MultiWorkerIter(
                self._dataset, batchify, batches_src,
                self._num_workers,
                prefetch=max(self._prefetch, self._num_workers),
                pin_memory=self._pin_memory)
            # exposed for respawn-bookkeeping introspection (tests,
            # job-state capture coordination)
            self._worker_iter = it
            try:
                yield from it
            finally:
                # early break from the consuming loop must still reap
                # workers and unlink prefetched shm segments
                it.shutdown()
                self._worker_iter = None
            return
        # threaded prefetch: submit up to `prefetch` batch jobs ahead,
        # each under the caller's context
        ctx = current_context()

        def job(indices):
            with ctx:
                return self._make_batch(indices)

        with ThreadPoolExecutor(max_workers=self._num_workers) as pool:
            batches = batches_src
            futures = []
            try:
                for _ in range(self._prefetch or self._num_workers * 2):
                    futures.append(pool.submit(job, next(batches)))
            except StopIteration:
                pass
            while futures:
                fut = futures.pop(0)
                try:
                    futures.append(pool.submit(job, next(batches)))
                except StopIteration:
                    pass
                yield fut.result()

    def __len__(self):
        return len(self._batch_sampler)
