"""KVStore implementations (port of ``mxnet_tpu/_kvstore_impl.py``).

Reference: ``src/kvstore/`` — KVStoreLocal (kvstore_local.h), the comm layer
(comm.h), KVStoreNCCL (kvstore_nccl.h), KVStoreDist worker + server
(kvstore_dist.h / kvstore_dist_server.h over ps-lite ZeroMQ).

The stores:
- 'local'/'device'/'local_allreduce_*' -> an in-process sum of the pushed
  values and a copy out on pull (the reference's CommCPU/CommDevice).
- 'nccl' (and 'tpu', the JAX package's name for its device store, so its
  scripts run unchanged) -> the same store whose dense reduce of values
  on several cards is ``torch.cuda.comm.reduce_add``; on one card it is
  the on-device sum.
- 'dist_sync'/'dist_async' -> a parameter server over TCP (replaces
  ps-lite): sync mode aggregates pushes from all workers before applying
  the updater; async applies immediately; the optimizer can run
  server-side via set_optimizer exactly like kvstore_dist_server.h:346.
  Roles and addresses use the reference's DMLC_* env names.  The server
  is a host process by design, as the reference's ps-lite servers are:
  its values are NDArrays on ``cpu()`` and it never creates a CUDA
  context, so workers that share a card lose no memory to it.
- 2-bit gradient compression with error feedback rides the dist push path
  (gradient_compression.cc), computed per tensor and packed 4 lanes/byte
  on the wire.

Tensors cross the wire as host numpy arrays in the JAX package's frame
format, byte for byte, so a worker of either package talks to a server
of the other: a device tensor is read back before it is framed, and a
pulled value is written into the caller's array on its device.
"""

from __future__ import annotations

import json
import logging
import os
import pickle
import socket
import struct
import time
from collections import OrderedDict as _OrderedDict

import numpy as _np

import torch

from . import ndarray as nd
from . import sanitizer as _san
from .context import cpu
from .ndarray import NDArray
from .base import MXNetError
from .observability import events as _obs_events
from .observability import metrics as _metrics
from .resilience import netchaos as _netchaos

__all__ = ["create", "KVStoreBase", "KVStoreLocal", "KVStoreNCCL",
           "KVStoreDist", "KVStoreServer", "RPCTimeoutError",
           "SyncTimeoutError", "EvictedWorkerError"]

log = logging.getLogger(__name__)


class RPCTimeoutError(MXNetError):
    """A bulk KVStore RPC hit its per-call socket timeout
    (``MXNET_KVSTORE_RPC_TIMEOUT``) — the server died mid-reply or the
    network stalled.  The worker transport treats this as retryable:
    it reconnects and resends the SAME ``(rank, seq)`` request id, and
    the server's dedup window keeps the retried mutation
    exactly-once."""


class SyncTimeoutError(MXNetError):
    """A dist_sync push or barrier round expired with contributors
    still missing whose heartbeats are FRESH — an alive-but-slow
    straggler (provably-dead ranks are evicted instead, and the
    survivors proceed).  The message names the laggard rank(s)."""


class EvictedWorkerError(MXNetError):
    """A dist_sync contribution arrived from a worker that is not a
    CURRENT member of the expected-contributor set — it was evicted
    (heartbeat went provably stale and the surviving ranks completed
    rounds without it), retired by an operator ``kv.resize()``, or is
    a joiner that has not been admitted yet.  Silently merging such a
    gradient into a later round is exactly the stale-contributor
    corruption the membership epoch exists to kill, so the server
    rejects the push with this typed error instead; the worker must
    re-sync (pull current params through the reinit path, refresh its
    membership view) before contributing again — or exit cleanly if
    its rank was resized away."""

# push/pull traffic instruments (module-level refs: these sit on the
# per-step gradient exchange path).  For the local store "bytes" is
# the logical value size moved through the aggregator; for the dist
# store it is what actually crosses the wire (compressed/rsp pushes
# count their packed size)
_PUSH_BYTES = _metrics.counter(
    "kvstore_push_bytes_total", "bytes pushed through kvstore")
_PULL_BYTES = _metrics.counter(
    "kvstore_pull_bytes_total", "bytes pulled through kvstore")

# distributed fault-tolerance instruments (module-level refs — the
# RPC/heartbeat paths must not pay a registry lookup per call)
_RPC_RETRIES = _metrics.counter(
    "kvstore_rpc_retries_total",
    "bulk RPC transport retries (timeout/connection failure; the same "
    "request id is resent and deduped server-side)")
_HB_FAILURES = _metrics.counter(
    "kvstore_heartbeat_failures_total",
    "failed worker->server heartbeat attempts")
_SYNC_TIMEOUTS = _metrics.counter(
    "kvstore_sync_timeouts_total",
    "dist_sync push/barrier rounds that hit the sync deadline")
_EVICTIONS = _metrics.counter(
    "kvstore_evictions_total",
    "provably-dead ranks evicted from the expected-contributor set")
_DEDUP_HITS = _metrics.counter(
    "kvstore_dedup_hits_total",
    "duplicate mutating RPCs answered from the server dedup window "
    "instead of re-applied (exactly-once)")
_SERVER_RESTARTS = _metrics.counter(
    "kvstore_server_restarts_detected_total",
    "server restarts detected via a heartbeat epoch-token change")
_APPLIES = _metrics.counter(
    "kvstore_server_applies_total",
    "server-side state mutations (aggregated sync applies + async "
    "per-push applies + first-push creates)")
_ACTIVE_WORKERS = _metrics.gauge(
    "kvstore_active_workers",
    "workers currently admitted to the dist expected-contributor set "
    "(server-side live membership view; moves on evict/join/rejoin/"
    "resize)")
_STALE_REJECTS = _metrics.counter(
    "kvstore_stale_contributions_rejected_total",
    "sync pushes rejected with EvictedWorkerError because the pusher "
    "is not a current member (evicted/retired/unadmitted) or its "
    "membership view predates its eviction fence")

# after this many consecutive heartbeat failures to one server: one
# WARN (not a log line per beat) and a backed-off cadence
_HB_FAIL_WARN_AFTER = 3
_HB_BACKOFF = 5.0


def _as_list(v):
    return v if isinstance(v, (list, tuple)) else [v]


def _host(t):
    """A tensor (or NDArray, or array-like) as a host numpy array: a
    device tensor is read back."""
    if isinstance(t, NDArray):
        t = t._data
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return _np.asarray(t)


def _write(dst, src):
    """Put *src* (a tensor or a host numpy array) into NDArray *dst*: in
    place on its device and in its dtype when the shapes agree (a
    Parameter's data stays the tensor autograd marked), else rebound."""
    if not isinstance(src, torch.Tensor):
        src = torch.from_numpy(_np.ascontiguousarray(src))
    d = dst._data
    if tuple(d.shape) == tuple(src.shape):
        with torch.no_grad():
            d.copy_(src)
    else:
        dst._data = src.detach().to(d.device, d.dtype, copy=True)


def compress_2bit(arr, residual, threshold):
    """A worker's 2-bit gradient compression with error feedback
    (reference: gradient_compression.cc Quantize2Bit): ``arr +
    residual`` ternarized to codes {-1, 0, 1} x *threshold*, packed four
    to a byte.  Returns ``(packed, n, residual')``, the new residual
    what the codes left out (float64, as the JAX package keeps it)."""
    from .ops.quantization import pack_2bit
    acc = arr + residual
    codes = _np.where(acc >= threshold, 1,
                      _np.where(acc <= -threshold, -1, 0)).astype(_np.int8)
    packed, n = pack_2bit(codes)
    return packed, n, acc - codes * threshold


def _rss_mb():
    """This process's resident memory now, MB (``/proc/self/statm``), or
    None where that file is missing.  (``getrusage``'s peak is no use
    here: a spawned server inherits its parent's peak across the
    fork and exec.)"""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
    except (OSError, IndexError, ValueError):
        return None
    return pages * os.sysconf("SC_PAGE_SIZE") / 1e6


def _value_bytes(arr):
    """Logical payload size of an NDArray/numpy value (metadata only —
    never forces a device sync)."""
    data = getattr(arr, "_data", arr)
    try:
        return int(getattr(data, "nbytes", 0))
    except (TypeError, ValueError):
        return 0     # exotic nbytes (mock/lazy proxy): skip accounting


class KVStoreBase:
    """Abstract API (reference: include/mxnet/kvstore.h:59-411)."""

    def __init__(self):
        self._updater = None
        self._compression = None

    @property
    def rank(self):
        return 0

    @property
    def num_workers(self):
        return 1

    def set_updater(self, updater):
        self._updater = updater

    def set_optimizer(self, optimizer):
        from . import optimizer as opt
        self.set_updater(opt.get_updater(optimizer))

    def set_gradient_compression(self, compression_params):
        self._compression = dict(compression_params or {})

    def init(self, key, value):
        raise NotImplementedError

    def push(self, key, value, priority=0):
        raise NotImplementedError

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        raise NotImplementedError

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        raise NotImplementedError

    def barrier(self):
        pass

    def get_optimizer_states(self, dump_optimizer=False):
        assert self._updater is not None, "updater is not set"
        return self._updater.get_states(dump_optimizer)

    def save_optimizer_states(self, fname, dump_optimizer=False):
        from .resilience.checkpoint import atomic_write
        atomic_write(fname, self.get_optimizer_states(dump_optimizer))

    def load_optimizer_states(self, fname):
        assert self._updater is not None, "updater is not set"
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())


def _key_list(key, value):
    """Normalize (key, value) to ([keys], [[vals per key]])."""
    if isinstance(key, (str, int)):
        return [key], [_as_list(value)]
    assert len(key) == len(value)
    return list(key), [_as_list(v) for v in value]


def _str_key_index(table, key):
    """Deterministic insertion-order index for string keys (the reference
    maps str keys to ints the same way; Python's hash() is randomized per
    process and would break optimizer-state save/load and idx2name
    lookups).  Int keys pass through."""
    if isinstance(key, int):
        return key
    if key not in table:
        table[key] = len(table)
    return table[key]


class KVStoreLocal(KVStoreBase):
    """Single-process store with device reduction
    (reference: kvstore_local.h; comm.h Reduce/Broadcast)."""

    def __init__(self, name="local"):
        super().__init__()
        self.name = name
        self._store = {}
        self._str_idx = {}

    def _key_index(self, k):
        return _str_key_index(self._str_idx, k)

    @property
    def type(self):
        return self.name

    def init(self, key, value):
        keys, values = _key_list(key, value)
        for k, vs in zip(keys, values):
            if k in self._store:
                raise MXNetError("key %r already initialized" % (k,))
            self._store[k] = vs[0].copy() if isinstance(vs[0], NDArray) \
                else vs[0]

    def _reduce(self, vals):
        from .ndarray import sparse as _sp
        if len(vals) == 1:
            if isinstance(vals[0], _sp.BaseSparseNDArray):
                return vals[0]
            return vals[0].copy()
        if isinstance(vals[0], _sp.RowSparseNDArray):
            out = vals[0]
            for v in vals[1:]:
                out = _sp.sparse_add(out, v)
            return out
        if isinstance(vals[0], _sp.BaseSparseNDArray):
            vals = [v.todense() for v in vals]
        total = vals[0]._data.clone()
        for v in vals[1:]:
            total += _sp._dense_of(v).to(total.device)
        return NDArray(total)

    def push(self, key, value, priority=0):
        from .ndarray import sparse as _sp
        keys, values = _key_list(key, value)
        for k, vs in zip(keys, values):
            merged = self._reduce(vs)
            _PUSH_BYTES.inc(_value_bytes(merged))
            if isinstance(merged, _sp.BaseSparseNDArray):
                merged = merged.todense()
            if self._updater is not None:
                self._updater(self._key_index(k), merged, self._store[k])
            else:
                # no updater: the merged value REPLACES the stored one
                # (reference kvstore_local.h PushImpl: ``local = merged``)
                stored = self._store[k]
                if isinstance(stored, _sp.BaseSparseNDArray):
                    self._store[k] = merged.as_in_context(
                        stored.context).tostype(stored.stype)
                else:
                    _write(stored, merged._data)

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        from .ndarray import sparse as _sp
        keys, outs = _key_list(key, out)
        for k, os_ in zip(keys, outs):
            src = self._store[k]
            if isinstance(src, _sp.BaseSparseNDArray):
                src = src.todense()
            _PULL_BYTES.inc(_value_bytes(src) * len(os_))
            for o in os_:
                _write(o, src._data)

    def assign(self, key, value):
        """Overwrite the stored value of each initialized *key* with its
        *value*, no updater run: weights moved outside the store (a
        Module's fused step) go back into it."""
        keys, values = _key_list(key, value)
        for k, vs in zip(keys, values):
            if k not in self._store:
                raise MXNetError("key %r is not initialized" % (k,))
            _write(self._store[k], vs[0]._data)

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        """Pull only requested rows (reference: kvstore_local.h:244;
        row ids are deduplicated first like the reference's Unique pass —
        duplicate ids in a RowSparseNDArray would double-count under the
        gradient-sum todense semantics)."""
        from .ndarray import sparse as _sp
        keys, outs = _key_list(key, out)
        rids = _as_list(row_ids)
        for k, os_ in zip(keys, outs):
            src = self._store[k]
            if not isinstance(src, _sp.RowSparseNDArray):
                src = _sp.cast_storage(src, "row_sparse")
            for o, rid in zip(os_, rids * len(os_)):
                rid_np = _np.unique(_host(rid).astype(_np.int64))
                retained = _sp.retain(src, torch.from_numpy(rid_np))
                _set_rsp(o, retained._data, retained._aux[0],
                         retained._shape)


def _set_rsp(o, vals, ids, shape):
    """Make NDArray *o* the row-sparse array (*vals*, *ids*) of *shape*,
    on *o*'s device."""
    dev = o._data.device
    o._data = vals.to(dev)
    o._aux = [ids.to(dev, torch.int32)]
    o._shape = tuple(int(s) for s in shape)
    o._stype = "row_sparse"


class KVStoreNCCL(KVStoreLocal):
    """The device store (replaces kvstore_nccl.h, and the JAX package's
    ICI store 'tpu'): a push of dense values that lie on distinct cards
    reduces with ``torch.cuda.comm.reduce_add`` onto the first value's
    card; values on one card (or on the CPU) sum there."""

    def __init__(self, name="nccl"):
        super().__init__(name)

    def _reduce(self, vals):
        from .ndarray import sparse as _sp
        if len(vals) > 1 and not any(
                isinstance(v, _sp.BaseSparseNDArray) for v in vals):
            devs = [v._data.device for v in vals]
            if all(d.type == "cuda" for d in devs) and \
                    len(set(devs)) == len(devs):
                return NDArray(torch.cuda.comm.reduce_add(
                    [v._data for v in vals], destination=devs[0].index))
        return super()._reduce(vals)


# ---------------------------------------------------------------------------
# Distributed parameter server over TCP
# ---------------------------------------------------------------------------

_MSG_INIT = 0
_MSG_PUSH = 1
_MSG_PULL = 2
_MSG_BARRIER = 3
_MSG_CMD = 4
_MSG_STOP = 5
_MSG_SET_OPT = 6
_MSG_ROWPULL = 7
_MSG_HEARTBEAT = 8
_MSG_DEADQUERY = 9
_MSG_REPLY = 100

# ---------------------------------------------------------------------------
# Wire format: length-prefixed frames with JSON metadata and raw tensor
# sections — the analogue of ps-lite's zero-copy ZPush/ZPull
# (reference: kvstore_dist.h:161-169).  Tensor payloads travel as raw
# C-order bytes (no pickle: a network peer can at most hand us bytes to
# reinterpret as a numpy array, never code to run); control metadata is
# JSON.  The ONE exception is SET_OPT, whose body is a pickled optimizer
# exactly like the reference's set_optimizer — that call is rank-0
# control plane, not a tensor path, and the trust stance matches the
# reference's.
#
#   frame  := u64 body_len | body
#   body   := u8 kind | u32 meta_len | meta (UTF-8 JSON)
#             | u8 n_tensors | tensor*
#   tensor := u8 name_len | dtype name (ascii, numpy dtype .name)
#             | u8 ndim | u64 shape[ndim] | u64 nbytes | raw bytes
#
# dtype travels by numpy name ('float32', 'bfloat16', ...) so extension
# dtypes registered by ml_dtypes round-trip; endianness is native on
# both ends (homogeneous cluster assumption, same as ps-lite's).

_MAX_FRAME = 1 << 38  # 256 GiB sanity bound against corrupt streams


def _pack_tensor(arr):
    arr = _np.asarray(arr)
    shape = arr.shape  # BEFORE ascontiguousarray: it promotes 0-d to (1,)
    name = arr.dtype.name.encode("ascii")
    hdr = struct.pack("<B", len(name)) + name + struct.pack("<B", len(shape))
    if shape:
        hdr += struct.pack("<%dQ" % len(shape), *shape)
    hdr += struct.pack("<Q", arr.nbytes)
    # flat uint8 view: extension dtypes (bfloat16) don't implement the
    # buffer protocol, so memoryview(arr) would raise on them
    flat = _np.ascontiguousarray(arr).reshape(-1)
    return hdr, memoryview(flat.view(_np.uint8))


_COALESCE_BYTES = 1 << 16  # parts under this are copied+batched


def _frame_parts(kind, meta, tensors):
    """The body parts of one wire frame (shared by the zero-copy
    sender and the netchaos torn-frame path — one wire format, two
    consumers, no drift)."""
    meta_b = json.dumps(meta).encode() if meta else b"{}"
    parts = [struct.pack("<BI", kind, len(meta_b)), meta_b,
             struct.pack("<B", len(tensors))]
    for t in tensors:
        hdr, body = _pack_tensor(t)
        parts.append(hdr)
        parts.append(body)
    return parts


def _frame_bytes(kind, meta=None, tensors=()):
    """One frame fully materialized (length prefix included) — used
    only by the torn-frame injections, never the hot path."""
    parts = _frame_parts(kind, meta, tensors)
    return (struct.pack("<Q", sum(len(p) for p in parts))
            + b"".join(bytes(p) for p in parts))


def _send_frame(sock, kind, meta=None, tensors=()):
    parts = _frame_parts(kind, meta, tensors)
    # coalesce the length prefix + small parts into single writes so a
    # control frame is ONE TCP segment (a write-write-read pattern would
    # hit Nagle + delayed-ACK ~40ms stalls); large tensor bodies still go
    # out zero-copy via their own sendall
    pending = bytearray(struct.pack(
        "<Q", sum(len(p) for p in parts)))
    for p in parts:
        if len(p) >= _COALESCE_BYTES:
            if pending:
                sock.sendall(pending)
                pending = bytearray()
            sock.sendall(p)
        else:
            pending += p
    if pending:
        sock.sendall(pending)


def _recv_exact(sock, n):
    buf = bytearray(n)
    mv = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(mv[got:], n - got)
        if not r:
            raise ConnectionError("peer closed")
        got += r
    return buf


def _recv_frame(sock):
    (n,) = struct.unpack("<Q", bytes(_recv_exact(sock, 8)))
    if n > _MAX_FRAME:
        raise ConnectionError("oversized frame (%d bytes)" % n)
    mv = memoryview(_recv_exact(sock, n))
    kind, meta_len = struct.unpack_from("<BI", mv, 0)
    off = 5
    meta = json.loads(bytes(mv[off:off + meta_len]).decode())
    off += meta_len
    (n_tensors,) = struct.unpack_from("<B", mv, off)
    off += 1
    tensors = []
    for _ in range(n_tensors):
        (name_len,) = struct.unpack_from("<B", mv, off)
        off += 1
        dtype = _np.dtype(bytes(mv[off:off + name_len]).decode("ascii"))
        off += name_len
        (ndim,) = struct.unpack_from("<B", mv, off)
        off += 1
        shape = struct.unpack_from("<%dQ" % ndim, mv, off) if ndim else ()
        off += 8 * ndim
        (nbytes,) = struct.unpack_from("<Q", mv, off)
        off += 8
        # views the frame buffer (writable bytearray) — no extra copy
        tensors.append(_np.frombuffer(mv[off:off + nbytes],
                                      dtype=dtype).reshape(shape))
        off += nbytes
    return kind, meta, tensors


def _connect_retry(host, port, deadline):
    """Connect with retry until *deadline* (a ``time.monotonic()``
    instant — wall-clock deadlines die to NTP steps, graftlint JG012),
    a FRESH socket per attempt.

    Reusing one socket across attempts is not portable: after a
    ``connect`` fails with ECONNREFUSED (server still importing/binding),
    some kernels and sandboxes leave the fd permanently broken — every
    retry then fails with ECONNABORTED until the deadline, which is
    exactly the "worker never connects although the server came up 2s
    later" flakiness the dist drills showed.  A fresh socket per attempt
    connects on the first try once the server listens."""
    while True:
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        try:
            sock.connect((host, port))
            return sock
        except (ConnectionRefusedError, OSError):
            sock.close()
            if time.monotonic() > deadline:
                raise
            time.sleep(0.1)


def _rpc_call(sock, kind, meta=None, tensors=(), inject=False):
    """Round-trip one request on *sock*; raises on an 'err' reply.

    ``inject=True`` consults the netchaos worker-side fault points
    (the bulk data-plane RPCs of ``KVStoreDist``; control sockets and
    raw test callers opt out).  A socket timeout surfaces as the typed
    :class:`RPCTimeoutError` so callers can distinguish "server died
    mid-reply" from a server-reported error."""
    dup = False
    if inject:
        directives = _netchaos.on_worker_send(kind)
        if directives.get("torn"):
            payload = _frame_bytes(kind, meta, tensors)
            try:
                sock.sendall(payload[:max(9, len(payload) // 2)])
            finally:
                sock.close()
            raise ConnectionError("netchaos: torn request frame")
        dup = bool(directives.get("dup"))
    try:
        _send_frame(sock, kind, meta, tensors)
        if dup:
            # identical bytes, same request id: the server handles the
            # first copy and answers the second from its dedup window
            _send_frame(sock, kind, meta, tensors)
        rkind, rmeta, rtensors = _recv_frame(sock)
        if dup:
            rkind, rmeta, rtensors = _recv_frame(sock)
    except socket.timeout as exc:
        raise RPCTimeoutError(
            "kvstore RPC (kind %d) timed out after %.1fs waiting for "
            "the server's reply (MXNET_KVSTORE_RPC_TIMEOUT)"
            % (kind, sock.gettimeout() or -1.0)) from exc
    if rkind != _MSG_REPLY:
        raise ConnectionError("protocol desync: reply kind %d" % rkind)
    if rmeta.get("status") != "ok":
        if rmeta.get("code") == "sync_timeout":
            raise SyncTimeoutError(
                "kvstore server error: %s" % rmeta.get("msg"))
        if rmeta.get("code") == "evicted":
            raise EvictedWorkerError(
                "kvstore server error: %s" % rmeta.get("msg"))
        raise MXNetError("kvstore server error: %s" % rmeta.get("msg"))
    return rmeta, rtensors


def _node_rank(node):
    """The worker rank encoded in a heartbeat node id ('worker3' ->
    3); None for foreign node ids."""
    if isinstance(node, str) and node.startswith("worker"):
        try:
            return int(node[len("worker"):])
        except ValueError:
            return None
    return None


# mutating RPCs carry a ``(rank, seq, incarnation)`` request id (seq
# per-worker monotonic, incarnation per-process); the server's dedup
# window answers a retried id from cache so the mutation applies
# exactly once
_MUTATING_KINDS = frozenset((_MSG_INIT, _MSG_PUSH, _MSG_BARRIER,
                             _MSG_SET_OPT))
# data-plane kinds eligible for netchaos server-side reply faults
# (control/failure-detection traffic stays clean: injected heartbeat
# faults would just retest the heartbeat-failure counter)
_BULK_KINDS = frozenset((_MSG_INIT, _MSG_PUSH, _MSG_PULL, _MSG_ROWPULL,
                         _MSG_BARRIER, _MSG_SET_OPT, _MSG_CMD))


class _InFlight:
    """One dedup-window entry: the first arrival of a ``(rank, seq)``
    owns it and publishes the reply through ``event``; duplicates wait
    on the event and answer from ``result`` instead of re-applying."""

    __slots__ = ("event", "result")

    def __init__(self, done=False, result=None):
        self.event = _san.event()
        self.result = result
        if done:
            self.event.set()


class _SnapRecord:
    __slots__ = ("seq", "params_path", "states_path")

    def __init__(self, seq, params_path, states_path):
        self.seq, self.params_path, self.states_path = \
            seq, params_path, states_path


class _Snapshots:
    """The server's snapshot files, written synchronously: snapshot
    *seq* is ``<prefix>-<seq>.params`` (``nd.save``, arg-prefixed keys),
    an optional ``<prefix>-<seq>.states`` (the optimizer blob) and a
    ``<prefix>-<seq>.json`` manifest written last, atomically, which
    commits it; the newest *keep_last* are kept."""

    def __init__(self, prefix, keep_last=2):
        self.prefix = prefix
        self.keep_last = keep_last
        d = os.path.dirname(os.path.abspath(prefix))
        os.makedirs(d, exist_ok=True)

    def _path(self, seq, ext):
        return "%s-%08d.%s" % (self.prefix, seq, ext)

    def epochs(self):
        d = os.path.dirname(os.path.abspath(self.prefix))
        base = os.path.basename(self.prefix) + "-"
        out = []
        for f in os.listdir(d):
            if f.startswith(base) and f.endswith(".json"):
                try:
                    out.append(int(f[len(base):-5]))
                except ValueError:
                    pass
        return sorted(out)

    def save_checkpoint(self, seq, arg_params, optimizer_states=None):
        from .ndarray import utils as nd_utils
        from .resilience.checkpoint import atomic_write
        nd_utils.save(self._path(seq, "params"),
                      {"arg:" + k: v for k, v in arg_params.items()})
        if optimizer_states is not None:
            atomic_write(self._path(seq, "states"), optimizer_states)
        atomic_write(self._path(seq, "json"), json.dumps(
            {"seq": seq, "states": optimizer_states is not None}).encode())
        for old in self.epochs()[:-self.keep_last]:
            for ext in ("json", "params", "states"):
                try:
                    os.unlink(self._path(old, ext))
                except OSError:
                    pass

    def restore_latest(self):
        """The newest committed snapshot's record, or None."""
        for seq in reversed(self.epochs()):
            try:
                with open(self._path(seq, "json")) as f:
                    man = json.load(f)
            except (OSError, ValueError):
                continue
            params = self._path(seq, "params")
            states = self._path(seq, "states") if man.get("states") \
                else None
            if os.path.exists(params) and (
                    states is None or os.path.exists(states)):
                return _SnapRecord(seq, params, states)
        return None

    def wait(self):
        """Writes are synchronous: nothing to wait for."""


class KVStoreServer:
    """Server process body (reference: kvstore_dist_server.h:155 —
    DataHandleEx:325, sync-mode ApplyUpdates:346, async immediate
    apply; ps-lite-grade fault tolerance: request-id dedup, heartbeat
    eviction, snapshot recovery — see docs/resilience.md)."""

    def __init__(self, sync_mode, num_workers, host="127.0.0.1",
                 port=None, server_id=0, snapshot_prefix=None):
        self.sync = sync_mode
        self.server_id = int(server_id)
        # -- live membership (elastic distributed training) -------------
        # The launch-time DMLC_NUM_WORKER is only the INITIAL world: the
        # expected-contributor set is versioned dynamic state.  Every
        # change (evict / join / rejoin / operator resize) bumps
        # ``membership_epoch``, which rides every heartbeat and sync
        # reply so workers re-shard at the next batch boundary.
        self.world = int(num_workers)     # operator-commanded target size
        self.joined = set(range(self.world))   # admitted members
        self.pending_join = set()   # heartbeating, admitted at a barrier
        self._rejoining = set()     # pending_join ranks that are rejoins
        self.pending_world = None   # resize target, applied at a barrier
        self.membership_epoch = 0
        # rank -> minimum membership epoch a sync push must declare:
        # set at eviction/retirement/admission so a push SENT before
        # the rank lost (or regained) membership can never merge into
        # a later round (the stale-contributor corruption)
        self.rank_fence = {}
        self.admitted_round = {r: 0 for r in range(self.world)}
        self.barrier_membership = {}   # completed round -> snapshot
        self.jobmeta = None    # opaque worker-published join metadata
        self.store = {}
        self.pending = {}       # key -> [accum, rank set, req-id set]
        # key -> ranks whose contribution was DROPPED when a sync
        # round was abandoned on timeout: their conn threads, still in
        # cv.wait, must raise too — 'key left pending' alone cannot
        # distinguish round-applied from round-abandoned, and an 'ok'
        # for a discarded gradient is exactly the silent failure this
        # subsystem exists to kill
        self.aborted_rounds = {}
        self._str_idx = {}      # deterministic string-key -> int index
        self.updater = None
        self._opt_blob = None   # pickled optimizer (snapshot restore)
        # barrier round-tracking by (round, worker rank) — robust to
        # overlapping rounds under worker skew, unlike a modulo counter
        self.barrier_rounds = {}   # round -> set of ranks arrived
        self.barrier_done = set()  # completed rounds (pruned)
        # heartbeat-based failure detection (reference: ps-lite
        # Postoffice::GetDeadNodes, kvstore_dist.h:119-128)
        self.heartbeats = {}       # node id -> last beat (monotonic)
        self.evicted = set()       # ranks removed from the expected set
        self.dedup = {}    # (rank, inc) -> OrderedDict(seq -> _InFlight)
        # request ids whose MUTATION is committed to the store but
        # whose reply is not yet sent: a snapshot taken inside the
        # apply must record them as done, or a post-restart retry of
        # the very push that triggered the snapshot double-applies
        self._applied_inflight = set()
        self.applies = 0           # state mutations (exactly-once proof)
        self.pushes_received = 0
        self.apply_seconds = 0.0   # host time in the mutations
        from .config import get_env as _get_env
        self.sync_timeout = _get_env("MXNET_KVSTORE_SYNC_TIMEOUT")
        self.evict_timeout = _get_env("MXNET_KVSTORE_EVICT_TIMEOUT")
        self.dedup_window = max(8, _get_env("MXNET_KVSTORE_DEDUP_WINDOW"))
        self.snapshot_every = _get_env("MXNET_KVSTORE_SNAPSHOT_EVERY")
        self.cv = _san.condition(label="KVStoreServer.cv")
        self.lock = _san.rlock(label="KVStoreServer.lock")
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind((host, port or 0))
        self.port = self.sock.getsockname()[1]
        self.sock.listen(64)
        self._stop = _san.event()
        # Resolve handler-thread imports NOW, on the constructing thread.
        # The server may be started while the package is still marked
        # initializing (a ``run_server`` call inside an import); a
        # ``from . import x`` in a handler thread would deadlock on the
        # package import lock.  The constructing thread holds that lock
        # reentrantly, so importing here is safe.
        from . import optimizer as _opt_mod
        from .ops import quantization as _quant_mod
        self._opt_mod = _opt_mod
        self._quant_mod = _quant_mod
        # epoch token: changes on every incarnation so workers detect a
        # restart through the heartbeat reply.  With a snapshot the
        # restored token + 1 keeps it monotonic; without one,
        # ms-resolution wall time makes a bounce distinguishable.
        self.epoch_token = int(time.time() * 1000) & 0x7FFFFFFFFFFF
        self._snap_seq = 0
        self._ckpt = None
        prefix = (snapshot_prefix if snapshot_prefix is not None
                  else _get_env("MXNET_KVSTORE_SNAPSHOT_PREFIX"))
        if prefix:
            if self.server_id:
                # each server of a group snapshots its own shard
                prefix = "%s-s%d" % (prefix, self.server_id)
            # synchronous on purpose: the reply to a push must leave
            # AFTER the snapshot covering its apply is durable, or a
            # hard kill loses state a client was already told is
            # committed (and its dedup entry with it — the retried
            # push would then double-apply or, worse, never come)
            self._ckpt = _Snapshots(prefix, keep_last=2)
            try:
                self._restore_snapshot()
            except Exception as exc:
                # a snapshot too corrupt for restore_latest's manifest
                # walk must not keep the parameter server down — start
                # fresh but say so loudly
                log.error("kvstore server %d: snapshot restore failed "
                          "(%s: %s); starting with an empty store",
                          self.server_id, type(exc).__name__, exc)
        # attributes conn-handler threads share; every one of these
        # must be consistently guarded (store/heartbeats/evicted/dedup/
        # applies by self.lock; pending/barrier_* by self.cv;
        # updater/sync rebinding by self.lock — the SET_OPT/'mode'
        # handlers race _apply's reads otherwise, which is exactly what
        # the lockset detector reports)
        _san.track(self, ("store", "pending", "updater", "sync",
                          "heartbeats", "barrier_rounds",
                          "barrier_done", "evicted", "dedup",
                          "applies", "pushes_received", "_opt_blob",
                          "_applied_inflight", "aborted_rounds",
                          "world", "joined", "pending_join",
                          "pending_world", "membership_epoch",
                          "rank_fence", "admitted_round", "jobmeta",
                          "_rejoining"),
                   "KVStoreServer")
        _ACTIVE_WORKERS.set(len(self.joined))

    @property
    def num_workers(self):
        """The CURRENT world size (operator-commanded target).  Kept
        as a property so legacy readers of the once-frozen constructor
        value see the live membership view; the expected-contributor
        set itself is :meth:`_expected_ranks`."""
        with self.lock:
            return self.world

    def _membership_snapshot(self):
        """One consistent view of the live membership (self.lock taken
        inside) — the payload attached to heartbeat and barrier
        replies and recorded per completed barrier round."""
        with self.lock:
            return {"mep": self.membership_epoch,
                    "members": sorted(self.joined),
                    "world": self.world}

    def _bump_membership_locked(self, action, ranks=(), **extra):
        """Callers hold self.lock already; it is an RLock, and taking
        it here keeps the write discipline lexically checkable.  One
        membership transition — bump the epoch, refresh the
        active-workers gauge, emit the ``membership`` event (old/new
        epoch + member list, the satellite contract)."""
        with self.lock:
            old = self.membership_epoch
            self.membership_epoch = old + 1
            members = sorted(self.joined)
            new = self.membership_epoch
            world = self.world
        _ACTIVE_WORKERS.set(len(members))
        _obs_events.emit("membership", action=action,
                         ranks=sorted(ranks), old_epoch=old,
                         new_epoch=new, members=members, world=world,
                         server=self.server_id, **extra)
        return old, new

    def run(self):
        """Serve until a STOP message (reference: RunServer blocks the
        server process, python/mxnet/kvstore_server.py)."""
        threads = []
        conns = []
        self.sock.settimeout(0.5)
        while not self._stop.is_set():
            try:
                conn, _ = self.sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            t = _san.thread(target=self._serve_conn, args=(conn,),
                            daemon=True)
            t.start()
            threads.append(t)
            conns.append(conn)
        # shut every accepted connection so blocked conn threads wake
        # and peers see a dead server — a process kill closes these
        # fds implicitly; an in-process stop (tests, embedded servers)
        # must behave identically or workers keep heartbeating a ghost
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass
        for t in threads:
            t.join(timeout=1)

    def _apply(self, key, grad_np, applied_reqs=()):
        """Mutate the stored value; *applied_reqs* are the request ids
        whose mutation this apply commits (recorded so a snapshot
        taken right here already covers them — the reply hasn't been
        sent yet, but the state change is durable)."""
        t0 = time.perf_counter()
        grad = nd.array(grad_np, ctx=cpu(), dtype=grad_np.dtype)
        with self.lock:
            if key not in self.store:
                self.store[key] = grad.copy()
            elif self.updater is not None:
                self.updater(_str_key_index(self._str_idx, key), grad,
                             self.store[key])
            elif self.sync:
                # sync, no updater: the fully aggregated value replaces
                # the stored one (reference kvstore_dist_server.h: "if
                # no updater, just copy" — CopyFromTo(merged, &stored))
                grad.copyto(self.store[key])
            else:
                # async applies per-push; without an updater concurrent
                # workers would blindly overwrite each other (reference
                # asserts CHECK(updater_) on this path)
                raise MXNetError(
                    "dist_async push for key %r before an optimizer was "
                    "set — call kv.set_optimizer() first (async mode "
                    "requires the server-side updater)" % (key,))
            # counted AFTER the mutation branches: a push that raised
            # above mutated nothing, and bumping the exactly-once
            # proof counter for it breaks snapshot accounting (found
            # by graftsched's kvserver scenario — an owner push that
            # beat SET_OPT left applies == pushes despite applying 0)
            self.applies += 1
            self.apply_seconds += time.perf_counter() - t0
            _APPLIES.inc()
            if applied_reqs:
                self._applied_inflight.update(applied_reqs)
            self._maybe_snapshot()

    # -- state snapshots (recovery after a server kill) --------------------
    def _maybe_snapshot(self):
        """self.lock held.  Counter-based: every Nth apply commits a
        snapshot synchronously, so the caller's reply cannot leave
        before the state it acknowledges is durable."""
        if self._ckpt is None or self.snapshot_every <= 0:
            return
        if self.applies % self.snapshot_every:
            return
        self._snapshot_locked()

    def _snapshot_locked(self):
        # callers hold self.lock already; it is an RLock, and taking
        # it here keeps the write discipline lexically checkable
        with self.lock:
            self._snap_seq += 1
            return self._snapshot_body()

    def _snapshot_body(self):
        completed = {}
        for (rank, inc), per_client in self.dedup.items():
            seqs = [s for s, e in per_client.items()
                    if e.event.is_set()
                    or (rank, inc, s) in self._applied_inflight]
            if seqs:
                # the tail of the window is what a post-restart retry
                # can realistically replay
                completed["%d:%d" % (rank, inc)] = sorted(seqs)[-64:]
        snap_meta = {"epoch_token": self.epoch_token,
                     "applies": self.applies,
                     "str_idx": dict(self._str_idx),
                     "dedup": completed,
                     "evicted": sorted(self.evicted),
                     "world": self.world,
                     "joined": sorted(self.joined),
                     "membership_epoch": self.membership_epoch,
                     "rank_fence": {str(r): f for r, f in
                                    self.rank_fence.items()},
                     "admitted_round": {str(r): rnd for r, rnd in
                                        self.admitted_round.items()}}
        # store keys may be ints or strings; json round-trips both
        # exactly (a raw str(key) would fold 3 and "3" together)
        params = {json.dumps(k): v for k, v in self.store.items()}
        params[json.dumps("__kvmeta__")] = nd.array(_np.frombuffer(
            json.dumps(snap_meta).encode("utf-8"), _np.uint8).copy(),
            ctx=cpu(), dtype="uint8")
        states = None
        if self.updater is not None:
            states = pickle.dumps((self._opt_blob,
                                   self.updater.get_states(False)))
        self._ckpt.save_checkpoint(self._snap_seq, arg_params=params,
                                   optimizer_states=states)
        _obs_events.emit("kvstore", action="snapshot",
                         server=self.server_id, seq=self._snap_seq,
                         applies=self.applies, keys=len(self.store))

    def _restore_snapshot(self):
        """Restore the newest intact snapshot.  Runs on the
        constructor thread before any conn thread exists; the lock is
        held anyway so the write discipline is uniform."""
        rec = self._ckpt.restore_latest()
        if rec is None:
            return False
        from .ndarray import utils as nd_utils
        from .model import _split_save_dict
        arg_params, _aux = _split_save_dict(
            nd_utils.load(rec.params_path, ctx=cpu()),
            context="kvstore snapshot %r" % rec.params_path)
        meta_arr = arg_params.pop(json.dumps("__kvmeta__"), None)
        snap_meta = {}
        if meta_arr is not None:
            snap_meta = json.loads(
                meta_arr.asnumpy().astype(_np.uint8).tobytes().decode(
                    "utf-8"))
        with self.lock:
            self.store = {json.loads(name): v
                          for name, v in arg_params.items()}
            self._str_idx = dict(snap_meta.get("str_idx") or {})
            self.applies = int(snap_meta.get("applies", 0))
            self.epoch_token = int(snap_meta.get(
                "epoch_token", self.epoch_token - 1)) + 1
            self.evicted = set(int(r)
                               for r in snap_meta.get("evicted", ()))
            if "world" in snap_meta:
                self.world = int(snap_meta["world"])
                self.joined = set(int(r)
                                  for r in snap_meta.get("joined", ()))
                self.membership_epoch = int(
                    snap_meta.get("membership_epoch", 0))
                self.rank_fence = {
                    int(r): int(f) for r, f in
                    (snap_meta.get("rank_fence") or {}).items()}
                self.admitted_round = {
                    int(r): int(rnd) for r, rnd in
                    (snap_meta.get("admitted_round") or {}).items()}
                _ACTIVE_WORKERS.set(len(self.joined))
            for client_s, seqs in (snap_meta.get("dedup") or {}).items():
                rank_s, _, inc_s = client_s.partition(":")
                client = (int(rank_s), int(inc_s or 0))
                per_client = self.dedup.setdefault(client,
                                                   _OrderedDict())
                for s in seqs:
                    per_client[int(s)] = _InFlight(
                        done=True, result=({"restored": True}, ()))
            if rec.states_path is not None:
                with open(rec.states_path, "rb") as f:
                    opt_blob, states = pickle.loads(f.read())
                self._opt_blob = opt_blob
                if opt_blob is not None:
                    self.updater = self._opt_mod.get_updater(
                        pickle.loads(opt_blob))
                    self.updater.set_states(states)
            self._snap_seq = max(self._ckpt.epochs() or [0])
        log.warning(
            "kvstore server %d: restored snapshot seq %d (%d keys, "
            "%d applies committed); epoch token now %d — workers will "
            "re-init anything newer than the snapshot",
            self.server_id, self._snap_seq, len(self.store),
            self.applies, self.epoch_token)
        _obs_events.emit("kvstore", action="restore",
                         server=self.server_id, seq=self._snap_seq,
                         keys=len(self.store), applies=self.applies,
                         epoch=self.epoch_token)
        return True

    def _serve_conn(self, conn):
        try:
            while True:
                kind, meta, tensors = _recv_frame(conn)
                if kind == _MSG_STOP:
                    self._stop.set()
                    _send_frame(conn, _MSG_REPLY, {"status": "ok"})
                    return
                # every other message replies exactly once; ANY handler
                # exception becomes an 'err' reply instead of killing
                # this thread and leaving the worker blocked in recv
                try:
                    rmeta, rtensors = self._handle(kind, meta, tensors)
                except SyncTimeoutError as e:
                    # typed on the wire: the worker re-raises the same
                    # class instead of a generic server error
                    rmeta, rtensors = {"status": "err",
                                       "code": "sync_timeout",
                                       "msg": str(e)}, ()
                except EvictedWorkerError as e:
                    rmeta, rtensors = {"status": "err",
                                       "code": "evicted",
                                       "msg": str(e)}, ()
                except MXNetError as e:
                    rmeta, rtensors = {"status": "err", "msg": str(e)}, ()
                except Exception as e:
                    rmeta, rtensors = {"status": "err", "msg": "%s: %s"
                                       % (type(e).__name__, e)}, ()
                rmeta.setdefault("status", "ok")
                if kind in (_MSG_PUSH, _MSG_BARRIER, _MSG_HEARTBEAT):
                    # the membership epoch rides EVERY heartbeat/sync
                    # reply so a worker notices a resize/evict/join
                    # within one sync round and re-shards at the batch
                    # boundary.  setdefault: a barrier reply already
                    # carries its completed round's CONSISTENT snapshot
                    # (mep + members together) — never mix in a newer
                    # epoch without its member list
                    if "mep" not in rmeta:
                        with self.lock:
                            rmeta["mep"] = self.membership_epoch
                if kind in _BULK_KINDS:
                    action = _netchaos.on_server_reply(kind)
                    if action == "drop":
                        # state already mutated; the worker's retried
                        # request id answers from the dedup window
                        continue
                    if action == "torn":
                        payload = _frame_bytes(_MSG_REPLY, rmeta,
                                               rtensors)
                        conn.sendall(payload[:max(9, len(payload) // 2)])
                        conn.close()
                        return
                _send_frame(conn, _MSG_REPLY, rmeta, rtensors)
        except (ConnectionError, OSError):
            return

    def _handle(self, kind, meta, tensors):
        """Dedup wrapper around :meth:`_dispatch`: the first arrival
        of a mutating ``(rank, seq)`` executes and caches its reply;
        duplicates (worker retries, netchaos dup injections) wait for
        the original and answer from cache — exactly-once."""
        req = meta.get("req") if isinstance(meta, dict) else None
        if req is None or kind not in _MUTATING_KINDS:
            return self._dispatch(kind, meta, tensors)
        rank, seq = int(req[0]), int(req[1])
        inc = int(req[2]) if len(req) > 2 else 0
        client = (rank, inc)
        with self.lock:
            per_client = self.dedup.get(client)
            if per_client is None:
                # a fresh incarnation of this rank: keep only a few
                # dead incarnations' windows around (their retries can
                # still arrive for a short while after a rejoin)
                stale = [c for c in self.dedup if c[0] == rank]
                if len(stale) >= 4:
                    self.dedup.pop(stale[0], None)
                per_client = self.dedup[client] = _OrderedDict()
            entry = per_client.get(seq)
            owner = entry is None
            if owner:
                entry = _InFlight()
                per_client[seq] = entry
                while len(per_client) > self.dedup_window:
                    oldest = next(iter(per_client))
                    if not per_client[oldest].event.is_set():
                        break       # never drop an in-flight entry
                    per_client.pop(oldest)
        if not owner:
            _DEDUP_HITS.inc()
            entry.event.wait(timeout=self.sync_timeout + 5.0)
            result = entry.result
            if result is None:
                raise MXNetError(
                    "duplicate request (%d, %d) whose original attempt "
                    "failed or is still in flight" % (rank, seq))
            rmeta = dict(result[0])
            rmeta["dup"] = True
            return rmeta, result[1]
        try:
            rmeta, rtensors = self._dispatch(kind, meta, tensors)
        except Exception:
            # no partial state survives a failed mutating RPC (sync
            # timeouts drop their accumulator), so let a future retry
            # re-execute instead of replaying the failure from cache
            with self.lock:
                self.dedup.get(client, {}).pop(seq, None)
                self._applied_inflight.discard((rank, inc, seq))
            entry.event.set()
            raise
        entry.result = (dict(rmeta), tuple(rtensors))
        entry.event.set()
        # the set event now records completion; the applied-in-flight
        # marker (set if a snapshot-covered apply ran) is redundant
        with self.lock:
            self._applied_inflight.discard((rank, inc, seq))
        return rmeta, rtensors

    def _dispatch(self, kind, meta, tensors):
        """Handle one request; returns (reply_meta, reply_tensors)."""
        if kind == _MSG_INIT:
            key = meta["key"]
            with self.lock:
                if key not in self.store:
                    self.store[key] = nd.array(tensors[0], ctx=cpu(),
                                               dtype=tensors[0].dtype)
            return {}, ()
        if kind == _MSG_PUSH:
            _netchaos.on_server_push()   # hard-kill drill point
            key = meta["key"]
            with self.lock:
                self.pushes_received += 1
            if meta.get("compressed"):
                codes = self._quant_mod.unpack_2bit(
                    tensors[0], meta["n"]).astype(
                    _np.float32) * meta["threshold"]
                val = codes.reshape(meta["shape"])
            elif meta.get("rsp"):
                # row-sparse wire format: (row_ids, row values);
                # reconstruct dense for aggregation/updater
                # (reference: kvstore_dist_server.h DataHandleRowSparse)
                idx, vals = tensors
                dense = _np.zeros(tuple(meta["shape"]), vals.dtype)
                _np.add.at(dense, _np.asarray(idx, _np.int64), vals)
                val = dense
            else:
                val = tensors[0]
            # self.sync is rebound by the rank-0 'mode' command on a
            # DIFFERENT conn thread — unsynchronized, this read raced
            # the write (caught by the graftsan lockset detector); a
            # worker's first pushes could land on the wrong
            # consistency path
            with self.lock:
                sync = self.sync
            # the pusher's rank comes from the request id (every
            # KVStoreDist push carries one); raw legacy pushers may
            # declare it as meta['rank'] instead
            req = meta.get("req")
            req_id = None
            if req:
                rank = int(req[0])
                req_id = (rank, int(req[2]) if len(req) > 2 else 0,
                          int(req[1]))
            else:
                rank = int(meta.get("rank", 0))
            if sync:
                self._reject_stale_contributor(rank, meta.get("mep"),
                                               key)
                self._push_sync(key, val, rank, req_id)
            else:
                self._apply(key, val,
                            applied_reqs=(req_id,) if req_id else ())
            return {}, ()
        if kind == _MSG_PULL:
            with self.lock:
                arr = self.store[meta["key"]].asnumpy()
            return {}, (arr,)
        if kind == _MSG_ROWPULL:
            # server-side row retain: only the requested rows go on the
            # wire (reference: kvstore_dist_server.h row-sparse pull
            # path).  Out-of-range/negative ids return zero rows (retain
            # semantics) instead of wrapping.
            with self.lock:
                full = self.store[meta["key"]].asnumpy()
            ids = _np.asarray(tensors[0], _np.int64)
            valid = (ids >= 0) & (ids < full.shape[0])
            rows = full[_np.clip(ids, 0, full.shape[0] - 1)]
            rows[~valid] = 0
            return {}, (rows,)
        if kind == _MSG_BARRIER:
            snap = self._barrier(meta.get("rank", 0),
                                 meta.get("round", 0))
            # the completed round's membership snapshot rides the
            # reply: every waiter of round r receives the SAME
            # (epoch, members, world) triple, so all survivors apply
            # a resize/join/evict at the same batch boundary
            return dict(snap or {}), ()
        if kind == _MSG_HEARTBEAT:
            node = meta["node"]
            with self.lock:
                # monotonic: heartbeat staleness is an ELAPSED-time
                # comparison within this process — an NTP step must not
                # spuriously evict a healthy worker (graftlint JG012)
                self.heartbeats[node] = time.monotonic()
                # a fresh heartbeat from an evicted rank is a rejoin,
                # and one from an unknown rank inside the (possibly
                # pending-resize) world is a join — both become
                # join-PENDING: admission happens at the next barrier
                # completion, the only point with no sync push in
                # flight, so every survivor re-shards at the same
                # round boundary
                rank = _node_rank(node)
                unevicted = rank is not None and rank in self.evicted
                joining = False
                if unevicted:
                    self.evicted.discard(rank)
                    self.pending_join.add(rank)
                    self._rejoining.add(rank)
                elif (rank is not None
                        and rank not in self.joined
                        and rank not in self.pending_join):
                    # any heartbeating non-member is join-PENDING
                    # (visible in stats) — admission itself is gated
                    # by rank < world at the barrier boundary, so a
                    # rank beyond the (possibly pending-resize) world
                    # just waits for the operator to grow it in
                    self.pending_join.add(rank)
                    joining = True
                reply = {"epoch": self.epoch_token,
                         "mep": self.membership_epoch,
                         "members": sorted(self.joined),
                         "world": self.world}
            if unevicted:
                log.warning("kvstore server %d: rank %d heartbeating "
                            "again — rejoin pending (admitted at the "
                            "next sync-round boundary)",
                            self.server_id, rank)
                _obs_events.emit("kvstore", action="rejoin", rank=rank,
                                 server=self.server_id)
            elif joining:
                log.info("kvstore server %d: rank %d announced itself "
                         "— join pending admission", self.server_id,
                         rank)
            # the epoch token lets workers detect a server restart and
            # re-init only the keys the new incarnation lost
            return reply, ()
        if kind == _MSG_DEADQUERY:
            now = time.monotonic()
            with self.lock:
                dead = [n for n, ts in self.heartbeats.items()
                        if now - ts > meta["timeout"]]
                evicted = sorted(self.evicted)
            return {"dead": dead, "evicted": evicted}, ()
        if kind == _MSG_SET_OPT:
            # control plane: optimizer ships pickled from rank 0, same
            # trust stance as the reference's set_optimizer.  The
            # rebinding must hold self.lock: _apply reads self.updater
            # under it from other conn threads (an unlocked write here
            # raced a concurrent async push — the lockset detector's
            # first real finding)
            blob = tensors[0].tobytes()
            optimizer = pickle.loads(blob)
            updater = self._opt_mod.get_updater(optimizer)
            with self.lock:
                self.updater = updater
                self._opt_blob = blob   # snapshots re-create the updater
            return {}, ()
        if kind == _MSG_CMD:
            # rank-0 command channel (reference: kvstore.h
            # SendCommandToServers:377); "mode" declares the consistency
            # model so one server binary serves both dist_sync and
            # dist_async launches; "profiler:*" drives this server
            # process's profiler (reference: kvstore.h:43-56)
            head = meta.get("head", "")
            body = meta.get("body")
            if head == "mode":
                with self.lock:
                    self.sync = "async" not in str(body)
            elif head == "stats":
                # consistency/health introspection: restart detection
                # (which keys survived), exactly-once drills (applies),
                # eviction + live membership state — one locked
                # snapshot of the counters
                with self.lock:
                    return {"applies": self.applies,
                            "apply_seconds": self.apply_seconds,
                            # a host process: this stays False
                            "cuda_initialized": torch.cuda.is_initialized(),
                            "rss_mb": _rss_mb(),
                            "pushes": self.pushes_received,
                            "epoch": self.epoch_token,
                            "keys": sorted(self.store, key=repr),
                            "evicted": sorted(self.evicted),
                            "snapshots": self._snap_seq,
                            "server_id": self.server_id,
                            "mep": self.membership_epoch,
                            "members": sorted(self.joined),
                            "world": self.world,
                            "pending_world": self.pending_world,
                            "pending_join": sorted(self.pending_join),
                            "admitted_round":
                                {str(r): rnd for r, rnd in
                                 self.admitted_round.items()}}, ()
            elif head == "resize":
                # operator-commanded scale: N -> M in either direction
                # WITHOUT a restart.  Recorded as pending and applied
                # at the next barrier completion — the only instant a
                # dist_sync job provably has no push in flight — so
                # the transition lands on a batch boundary for every
                # worker at once.
                m = int(body)
                if m < 1:
                    raise MXNetError(
                        "resize target must be >= 1 worker, got %d" % m)
                with self.lock:
                    reply = {"world": self.world, "pending_world": m,
                             "mep": self.membership_epoch}
                    self.pending_world = m
                log.warning("kvstore server %d: operator resize to %d "
                            "worker(s) requested (world now %d); "
                            "applies at the next sync-round boundary",
                            self.server_id, m, reply["world"])
                _obs_events.emit("membership", action="resize_requested",
                                 world=reply["world"], target=m,
                                 server=self.server_id)
                return reply, ()
            elif head == "jobmeta":
                # opaque JSON blob the surviving workers publish (data
                # cursor, sampler state, round number): a mid-epoch
                # joiner fetches it to take over its shard assignment
                with self.lock:
                    self.jobmeta = body
            elif head == "jobmeta_get":
                with self.lock:
                    return {"meta": self.jobmeta}, ()
            elif head.startswith("profiler:"):
                # the server's profiler (reference: kvstore.h:43-56) waits
                # on the port's profiler, queue A item 15
                raise MXNetError(
                    "kvstore server command %r is not ported: the "
                    "profiler is queue A item 15" % head)
            return {}, ()
        raise MXNetError("unknown kvstore message kind %d" % kind)

    # -- straggler tolerance / live membership ------------------------------
    def _expected_ranks(self):
        """THE accessor for the ranks a sync round must hear from —
        the live membership view (self.lock taken inside; callers may
        hold self.cv — cv-before-lock is the one ordering this class
        uses).  Everything that used to derive an expected set or
        count from the frozen constructor ``num_workers`` routes
        through here (or :meth:`expected_count`)."""
        with self.lock:
            return set(self.joined)

    def expected_count(self):
        with self.lock:
            return len(self.joined)

    def _reject_stale_contributor(self, rank, mep, key):
        """A sync push from a non-member must fail TYPED, never merge
        into a later round (silent apply) or answer from the dedup
        cache: evicted ranks, ranks retired by a resize, and joiners
        not yet admitted all get :class:`EvictedWorkerError`.  The
        per-rank fence additionally rejects a push whose declared
        membership view predates the rank's own eviction — the push
        that was already on the wire when the round completed without
        it."""
        with self.lock:
            if rank in self.joined:
                fence = self.rank_fence.get(rank)
                if mep is None or fence is None or mep >= fence:
                    return
                reason = ("its membership view (epoch %d) predates its "
                          "eviction fence (epoch %d)" % (mep, fence))
            elif rank in self.pending_join and rank < self.world \
                    and mep is not None \
                    and mep >= self.rank_fence.get(rank, 0):
                # admit on first post-fence contribution: in a server
                # GROUP the barrier boundary lands a beat apart per
                # server, so a joiner admitted by server 0's round may
                # reach a sibling before that sibling's own barrier
                # completes.  The fence proves the pusher has already
                # observed a post-eviction membership view of THIS
                # server, so this is a fresh contribution, not a stale
                # one.
                self.joined.add(rank)
                self.pending_join.discard(rank)
                action = ("rejoin" if rank in self._rejoining
                          else "join")
                self._rejoining.discard(rank)
                self._bump_membership_locked(action, ranks=[rank],
                                             on_push=True)
                log.warning("kvstore server %d: admitted rank %d (%s) "
                            "on its first post-fence push",
                            self.server_id, rank, action)
                return
            elif rank in self.evicted:
                reason = "it was evicted from the expected set"
            elif rank >= self.world:
                reason = ("its rank was retired by an operator resize "
                          "to %d worker(s)" % self.world)
            else:
                reason = ("it has not been admitted yet (join pending "
                          "until the next sync-round boundary)")
            epoch = self.membership_epoch
        _STALE_REJECTS.inc()
        _obs_events.emit("membership", action="stale_reject", rank=rank,
                         key=str(key), epoch=epoch,
                         server=self.server_id)
        raise EvictedWorkerError(
            "sync push for key %r from rank %d rejected: %s "
            "(membership epoch %d) — re-sync params and refresh the "
            "membership view before contributing again"
            % (key, rank, reason, epoch))

    def _apply_membership_at_barrier(self, rnd):
        """self.cv held, called when barrier round *rnd* completes:
        apply every pending membership transition (operator resize,
        join/rejoin admissions).  A completed barrier is the one
        instant a dist_sync job provably has no push in flight — every
        worker's round-``rnd`` pushes returned before it arrived here —
        so the transition lands on the same batch boundary for all
        survivors, and the round's reply snapshot tells them about it."""
        with self.lock:
            resized = retired = None
            if self.pending_world is not None and \
                    self.pending_world != self.world:
                old_world, self.world = self.world, self.pending_world
                retired = sorted(r for r in self.joined
                                 if r >= self.world)
                for r in retired:
                    self.joined.discard(r)
                    self.rank_fence[r] = self.membership_epoch + 1
                self.pending_join = {r for r in self.pending_join
                                     if r < self.world}
                self.evicted = {r for r in self.evicted
                                if r < self.world}
                resized = old_world
            self.pending_world = None
            # only admit ranks whose heartbeat is FRESH: a retired/dead
            # process's last beats can leave a ghost pending entry, and
            # admitting it would stall rounds until it is re-evicted
            now = time.monotonic()
            stale = {r for r in self.pending_join
                     if r < self.world
                     and now - self.heartbeats.get("worker%d" % r,
                                                   -1e18)
                     > self.evict_timeout}
            self.pending_join -= stale
            self._rejoining -= stale
            admitted = sorted(r for r in self.pending_join
                              if r < self.world and r not in self.joined)
            for r in admitted:
                self.pending_join.discard(r)
                self.joined.add(r)
                self.admitted_round[r] = rnd
                # deliberately NOT re-fencing at admission: the fence
                # set at EVICTION time already rejects any push born
                # before the rank lost membership, while an
                # admission-epoch fence would falsely reject the
                # joiner's first post-admission push to a server whose
                # heartbeat reply it has not seen since the admission
                # bump (sub-second window in a server group)
            if resized is not None:
                old, new = self._bump_membership_locked(
                    "resize", ranks=retired, from_world=resized,
                    round=rnd)
                log.warning(
                    "kvstore server %d: resize %d -> %d applied at "
                    "round %d (membership epoch %d -> %d; retired "
                    "ranks %s)", self.server_id, resized, self.world,
                    rnd, old, new, retired)
            if admitted:
                rejoins = [r for r in admitted if r in self._rejoining]
                joins = [r for r in admitted if r not in self._rejoining]
                self._rejoining.difference_update(admitted)
                for action, ranks in (("rejoin", rejoins),
                                      ("join", joins)):
                    if not ranks:
                        continue
                    old, new = self._bump_membership_locked(
                        action, ranks=ranks, round=rnd)
                    log.warning(
                        "kvstore server %d: admitted rank(s) %s (%s) "
                        "at round %d (membership epoch %d -> %d; "
                        "expected contributors now %d)",
                        self.server_id, ranks, action, rnd, old, new,
                        len(self.joined))
        if resized is not None:
            # a shrink can complete rounds that were waiting on the
            # retired ranks — re-check everything pending (cv held)
            self._sweep_after_eviction()

    def _evict_dead(self, missing, context):
        """self.cv held.  Split *missing* ranks into provably-dead
        (heartbeat stale beyond the evict timeout — evicted, so the
        survivors make progress) and alive-but-slow laggards (the
        caller raises loudly, naming them)."""
        now = time.monotonic()
        evicted_now, laggards = [], []
        with self.lock:
            for r in sorted(missing):
                ts = self.heartbeats.get("worker%d" % r)
                if ts is not None and now - ts > self.evict_timeout:
                    self.evicted.add(r)
                    self.joined.discard(r)
                    self.pending_join.discard(r)
                    # any push of this rank's already on the wire was
                    # born before the eviction: fence it out until the
                    # rank observes a post-eviction membership view
                    self.rank_fence[r] = self.membership_epoch + 1
                    # the dead-node listing shrinks too: an evicted
                    # rank is no longer an expected cluster member
                    self.heartbeats.pop("worker%d" % r, None)
                    evicted_now.append(r)
                else:
                    laggards.append(r)
            if evicted_now:
                # eviction takes effect IMMEDIATELY (it is what
                # unblocks the waiting survivors), unlike join/resize
                # which defer to a barrier boundary
                self._bump_membership_locked("evict", ranks=evicted_now,
                                             reason=context)
            expected_now = len(self.joined)
        for r in evicted_now:
            _EVICTIONS.inc()
            log.warning(
                "kvstore server %d: evicted dead worker rank %d (%s; "
                "last heartbeat > %.1fs ago); expected contributors "
                "now %d", self.server_id, r, context,
                self.evict_timeout, expected_now)
            _obs_events.emit("kvstore", action="evict", rank=r,
                             server=self.server_id, reason=context)
        return evicted_now, laggards

    def _try_apply_pending(self, key):
        """self.cv held: apply *key*'s accumulator if every currently
        expected rank contributed; True when the round is finished."""
        acc = self.pending.get(key)
        if acc is None:
            return True
        expected = self._expected_ranks()
        if not expected or not expected <= acc[1]:
            return False
        self.pending.pop(key)
        # every contributor's request id is committed by this apply —
        # a snapshot inside it must cover the whole round
        self._apply(key, acc[0], applied_reqs=acc[2])
        self.cv.notify_all()
        return True

    def _try_complete_barrier(self, rnd):
        """self.cv held: complete barrier *rnd* if every currently
        expected rank arrived; True when the round is done."""
        if rnd in self.barrier_done:
            return True
        arrived = self.barrier_rounds.get(rnd)
        if arrived is None:
            return False
        expected = self._expected_ranks()
        if not expected or not expected <= arrived:
            return False
        self.barrier_done.add(rnd)
        del self.barrier_rounds[rnd]
        # the round boundary: apply pending membership transitions,
        # then record the round's consistent snapshot for its waiters
        self._apply_membership_at_barrier(rnd)
        self.barrier_membership[rnd] = self._membership_snapshot()
        # prune: done rounds older than any pending round
        if len(self.barrier_done) > 1024:
            keep = max(self.barrier_done)
            self.barrier_done = {r for r in self.barrier_done
                                 if r > keep - 1024}
            self.barrier_membership = {
                r: s for r, s in self.barrier_membership.items()
                if r in self.barrier_done}
        self.cv.notify_all()
        return True

    def _sweep_after_eviction(self):
        """self.cv held: an eviction shrank the expected set — every
        pending sync key and barrier round must be re-checked, not
        just the one whose deadline noticed the death."""
        for key in list(self.pending):
            self._try_apply_pending(key)
        for rnd in list(self.barrier_rounds):
            self._try_complete_barrier(rnd)

    def _push_sync(self, key, val, rank, req_id=None):
        """Aggregate until all expected workers pushed, then apply once
        (reference: ApplyUpdates:346-358).  On deadline expiry the
        heartbeat table decides: provably-dead ranks are evicted and
        the round completes for the survivors; an alive-but-slow
        laggard raises a loud typed error naming it."""
        with self.cv:
            if key in self.pending:
                self.pending[key][0] = self.pending[key][0] + val
                self.pending[key][1].add(rank)
                if req_id is not None:
                    self.pending[key][2].add(req_id)
            else:
                self.pending[key] = [val, {rank},
                                     {req_id} if req_id else set()]
            if self._try_apply_pending(key):
                return
            deadline = time.monotonic() + self.sync_timeout
            while key in self.pending and time.monotonic() < deadline:
                self.cv.wait(timeout=0.1)
            if key not in self.pending:
                self._raise_if_aborted(key, rank)
                return
            arrived = set(self.pending[key][1])
            missing = self._expected_ranks() - arrived
            evicted_now, laggards = self._evict_dead(
                missing, "sync push key=%r" % (key,))
            if evicted_now:
                self._sweep_after_eviction()
            if self._try_apply_pending(key):
                return
            # drop the stale accumulator so a late worker cannot mix
            # gradients across rounds after the failure; the OTHER
            # contributors still in cv.wait find their rank here and
            # raise the same typed error instead of a false 'ok'
            dropped = self.pending.pop(key)[1]
            got = len(dropped)
            dropped.discard(rank)      # this thread raises directly
            if dropped:
                self.aborted_rounds[key] = dropped
            self.cv.notify_all()
            _SYNC_TIMEOUTS.inc()
            _obs_events.emit("kvstore", action="sync_timeout",
                             key=str(key), got=got,
                             expected=self.expected_count(),
                             laggards=laggards, server=self.server_id)
            raise SyncTimeoutError(
                "dist_sync push for key %r timed out after %.1fs: got "
                "%d contributor(s), still waiting on alive-but-slow "
                "rank(s) %s — straggling worker, not a crash (dead "
                "ranks would have been evicted)"
                % (key, self.sync_timeout, got, laggards))

    def _raise_if_aborted(self, key, rank):
        """self.cv held: a waiter whose round vanished from pending
        checks whether it was APPLIED (fine — return ok) or ABANDONED
        with its gradient dropped (raise the same typed error the
        abandoning thread raised)."""
        aborted = self.aborted_rounds.get(key)
        if not aborted or rank not in aborted:
            return
        aborted.discard(rank)
        if not aborted:
            del self.aborted_rounds[key]
        raise SyncTimeoutError(
            "dist_sync push for key %r was abandoned after a sync "
            "timeout — rank %d's gradient was dropped with the round"
            % (key, rank))

    def _barrier(self, rank, rnd):
        """Round-aware barrier: each worker reports (rank, its own round
        number); a round completes when every expected rank has arrived.
        Immune to overlapping rounds under skew (a fast worker in round
        r+1 cannot be miscounted into round r); deadline expiry evicts
        provably-dead ranks exactly like :meth:`_push_sync`.  Returns
        the completed round's membership snapshot — the same
        (epoch, members, world) triple for every waiter of the round."""
        with self.cv:
            if rnd in self.barrier_done:
                return (self.barrier_membership.get(rnd)
                        or self._membership_snapshot())
            self.barrier_rounds.setdefault(rnd, set()).add(rank)
            if self._try_complete_barrier(rnd):
                return self.barrier_membership.get(rnd)
            deadline = time.monotonic() + self.sync_timeout
            while rnd not in self.barrier_done and \
                    time.monotonic() < deadline:
                self.cv.wait(timeout=0.1)
            if rnd in self.barrier_done:
                return (self.barrier_membership.get(rnd)
                        or self._membership_snapshot())
            arrived = set(self.barrier_rounds.get(rnd, ()))
            missing = self._expected_ranks() - arrived
            evicted_now, laggards = self._evict_dead(
                missing, "barrier round=%d" % rnd)
            if evicted_now:
                self._sweep_after_eviction()
            if self._try_complete_barrier(rnd):
                return self.barrier_membership.get(rnd)
            got = len(self.barrier_rounds.get(rnd, ()))
            expected = self.expected_count()
            _SYNC_TIMEOUTS.inc()
            _obs_events.emit("kvstore", action="barrier_timeout",
                             round=rnd, got=got, expected=expected,
                             laggards=laggards, server=self.server_id)
            raise SyncTimeoutError(
                "kvstore barrier timed out: %d/%d workers arrived for "
                "round %d; alive-but-slow rank(s): %s"
                % (got, expected, rnd, laggards))


class KVStoreDist(KVStoreBase):
    """Worker side (reference: kvstore_dist.h:44 — ZPush/ZPull).

    Keys are sharded across ``DMLC_NUM_SERVER`` servers by stable hash,
    and arrays larger than ``MXNET_KVSTORE_BIGARRAY_BOUND`` elements are
    split into per-server chunks (reference: PSKV key/len caching,
    kvstore_dist.h:161-169 and the big-array sharding at :58).  A
    daemon heartbeat thread feeds server-side failure detection
    (num_dead_node); a restarted worker with the same rank reconnects
    statelessly (async-mode rejoin, reference is_recovery
    kvstore_dist.h:52)."""

    def __init__(self, name="dist_sync"):
        super().__init__()
        self.name = name
        self._host = os.environ.get("DMLC_PS_ROOT_URI", "127.0.0.1")
        self._root_port = int(os.environ.get("DMLC_PS_ROOT_PORT", "9091"))
        self._rank = int(os.environ.get("DMLC_WORKER_RANK",
                                        os.environ.get("DMLC_RANK", "0")))
        self._num_workers = int(os.environ.get("DMLC_NUM_WORKER", "1"))
        self._num_servers = int(os.environ.get("DMLC_NUM_SERVER", "1"))
        from .config import get_env as _get_env
        self._big_bound = _get_env("MXNET_KVSTORE_BIGARRAY_BOUND")
        self._rpc_timeout = _get_env("MXNET_KVSTORE_RPC_TIMEOUT")
        self._rpc_attempts = max(1, _get_env("MXNET_KVSTORE_RPC_RETRIES"))
        self._connect_timeout = _get_env("MXNET_KVSTORE_CONNECT_TIMEOUT")
        # mutating RPCs carry (rank, seq, incarnation): one id per
        # logical request, reused verbatim across transport retries.
        # The incarnation token distinguishes a RESTARTED worker with
        # the same rank (async rejoin, reference is_recovery) whose
        # fresh seq counter would otherwise collide with — and be
        # wrongly deduped against — its previous life's request ids.
        self._req_seq = 0
        self._incarnation = ((int(time.time() * 1000) << 16)
                             ^ os.getpid()) & 0x7FFFFFFFFFFF
        self._seq_lock = _san.lock(label="KVStoreDist.seq")
        # live membership view (elastic training): seeded from the
        # launch env, then updated from every heartbeat reply, every
        # sync reply's membership epoch, and each barrier's completed-
        # round snapshot.  ``num_workers`` reads THIS, never the
        # frozen env value.
        self._mview_lock = _san.lock(label="KVStoreDist.mview")
        self._mview = {"mep": 0,
                       "members": list(range(self._num_workers)),
                       "world": self._num_workers}
        # membership epochs are PER-SERVER counters: pushes declare
        # the last epoch seen from the server they go to (the fence
        # comparison must be same-server), while the partitioning
        # view above follows server 0 alone
        self._server_meps = {}
        # init-time values, kept so a restarted server's lost keys can
        # be re-initialized (only what the snapshot didn't cover)
        self._init_cache = {}
        self._cache_lock = _san.lock(label="KVStoreDist.init_cache")
        self._server_epochs = {}   # heartbeat thread only
        # server s listens on root port + s (tools/launch.py convention)
        self._socks = []
        self._locks = []
        for s in range(self._num_servers):
            self._socks.append(self._connect(s))
            self._locks.append(_san.lock())
        self._residual = {}
        self._sharded_keys = set()
        self._barrier_round = 0
        # declare the consistency mode to every server (idempotent)
        for s in range(self._num_servers):
            self._rpc(_MSG_CMD, {"head": "mode", "body": name}, server=s)
        self._start_heartbeat()

    def _connect(self, s):
        """Fresh bulk-RPC socket to server *s*: connect-with-retry up
        to the connect deadline, then the per-call RPC timeout so a
        server dying mid-reply can never hang a worker in recv."""
        sock = _connect_retry(self._host, self._root_port + s,
                              time.monotonic() + self._connect_timeout)
        if self._rpc_timeout > 0:
            sock.settimeout(self._rpc_timeout)
        return sock

    def _start_heartbeat(self):
        from .config import get_env as _get_env
        interval = _get_env("MXNET_KVSTORE_HEARTBEAT_INTERVAL")
        node = "worker%d" % self._rank
        # dedicated sockets: heartbeats must not contend with bulk RPCs
        host, port = self._host, self._root_port

        def beat():
            socks = {}
            fails = {}   # server -> consecutive failures (bounded noise)
            defer = {}   # server -> monotonic time to retry after
            while not getattr(self, "_closed", False):
                for s in range(self._num_servers):
                    if time.monotonic() < defer.get(s, 0.0):
                        continue    # backed-off: THIS server only —
                        # healthy peers must keep seeing us at full
                        # cadence or they'd evict a live worker
                    try:
                        if s not in socks:
                            hs = socket.socket(socket.AF_INET,
                                               socket.SOCK_STREAM)
                            hs.setsockopt(socket.IPPROTO_TCP,
                                          socket.TCP_NODELAY, 1)
                            hs.settimeout(5)
                            hs.connect((host, port + s))
                            socks[s] = hs
                        rmeta, _ = _rpc_call(socks[s], _MSG_HEARTBEAT,
                                             {"node": node})
                    except (RPCTimeoutError, ConnectionError, OSError) \
                            as exc:
                        # transient (server restarting): retry next
                        # beat — but visibly and boundedly, not a
                        # silent forever-loop: count every failure,
                        # WARN once per outage, back off the cadence
                        hs = socks.pop(s, None)
                        if hs is not None:
                            try:
                                hs.close()
                            except OSError:
                                pass
                        _HB_FAILURES.inc()
                        fails[s] = fails.get(s, 0) + 1
                        if fails[s] == _HB_FAIL_WARN_AFTER:
                            log.warning(
                                "kvstore heartbeat to server %d failed "
                                "%d consecutive times (%s: %s); "
                                "failure detection degraded — backing "
                                "off to %.1fs between attempts",
                                s, fails[s], type(exc).__name__, exc,
                                interval * _HB_BACKOFF)
                        if fails[s] >= _HB_FAIL_WARN_AFTER:
                            defer[s] = (time.monotonic()
                                        + interval * _HB_BACKOFF)
                        continue
                    except Exception:
                        # unexpected: the beat loop stops, loudly (the
                        # next RPC to a server that evicts us says so)
                        log.exception("kvstore heartbeat thread failed")
                        return
                    if fails.get(s, 0) >= _HB_FAIL_WARN_AFTER:
                        log.info("kvstore heartbeat to server %d "
                                 "recovered after %d failures",
                                 s, fails[s])
                    fails[s] = 0
                    defer.pop(s, None)
                    # heartbeat replies carry the live membership
                    # snapshot (per-server epoch tracked for the push
                    # fence; server 0 is the partitioning authority)
                    self._update_mview(rmeta, server=s)
                    # restart detection: the server stamps every
                    # heartbeat reply with its incarnation's epoch token
                    epoch = rmeta.get("epoch")
                    if epoch is not None:
                        last = self._server_epochs.get(s)
                        self._server_epochs[s] = epoch
                        if last is not None and epoch != last:
                            self._on_server_restart(s, last, epoch)
                time.sleep(interval)

        self._hb_thread = _san.thread(target=beat, daemon=True)
        self._hb_thread.start()

    def _on_server_restart(self, s, old_epoch, new_epoch):
        """Heartbeat thread: server *s*'s epoch token changed — it
        restarted.  The re-init work runs on its OWN daemon thread:
        it issues blocking bulk RPCs (shared per-server socket locks),
        and stalling the beat loop on them would stop proving this
        worker's liveness to every OTHER server — long enough, the
        worker itself gets evicted as 'provably dead'."""
        _SERVER_RESTARTS.inc()
        log.warning("kvstore server %d restarted (epoch %s -> %s); "
                    "checking for lost keys", s, old_epoch, new_epoch)
        _obs_events.emit("kvstore", action="server_restart_detected",
                         server=s, old_epoch=old_epoch,
                         new_epoch=new_epoch, rank=self._rank)
        _san.thread(target=self._reinit_lost_keys, args=(s,),
                    daemon=True).start()

    def _reinit_lost_keys(self, s):
        """Re-init ONLY the keys restarted server *s* lost (a
        snapshot-restored server reports survivors in 'stats'), so
        rejoin pulls resume from committed state instead of zeros or
        KeyErrors.  Rank 0 holds the init-time cache (it is also the
        rank that sent the INITs originally); INIT is idempotent, so
        racing a concurrent snapshot-restored key is harmless."""
        try:
            have = set(self._rpc(_MSG_CMD, {"head": "stats"},
                                 server=s)[0].get("keys", ()))
            with self._cache_lock:
                cached = list(self._init_cache.items())
            sent = 0
            for k, arr in cached:
                for wire_key, value in self._wire_entries(k, arr, s):
                    if wire_key not in have:
                        self._rpc(_MSG_INIT, {"key": wire_key},
                                  (value,), server=s)
                        sent += 1
            if sent:
                log.warning(
                    "kvstore: re-initialized %d lost key(s) on "
                    "restarted server %d from their init-time values "
                    "(training state for those keys reset to init)",
                    sent, s)
                _obs_events.emit("kvstore", action="reinit", server=s,
                                 keys=sent, rank=self._rank)
        except (MXNetError, ConnectionError, OSError) as exc:
            # best effort from a daemon thread: a failed re-init must
            # not kill heartbeating — a later pull of a lost key will
            # fail loudly anyway
            log.warning("kvstore: re-init after server %d restart "
                        "failed (%s: %s)", s, type(exc).__name__, exc)

    def _wire_entries(self, k, arr, server):
        """(wire key, numpy value) pairs of key *k* that live on
        *server* — one per shard for sharded keys, the key itself when
        the stable hash picks this server."""
        if k in self._sharded_keys:
            flat = arr.ravel()
            off = 0
            for s2, ln in enumerate(self._shard_splits(arr.size)):
                if s2 == server:
                    yield "%s#shard%d" % (k, s2), flat[off:off + ln]
                off += ln
        elif self._server_for_key(k) == server:
            yield k, arr

    def _server_for_key(self, k):
        import zlib
        return zlib.crc32(str(k).encode()) % self._num_servers

    def num_dead_node(self, node_id="all", timeout=60):
        """Count nodes whose heartbeat is older than *timeout* seconds
        (reference: kvstore_dist.h:119-128 get_num_dead_node)."""
        dead = self._rpc(_MSG_DEADQUERY, {"timeout": timeout},
                         server=0)[0]["dead"]
        if node_id == "all":
            return len(dead)
        return int(("worker%d" % node_id) in dead)

    def server_stats(self, server=0):
        """One server's health/consistency counters: ``applies`` (the
        exactly-once proof), ``pushes``, ``epoch`` (incarnation
        token), ``keys``, ``evicted``, ``snapshots``."""
        return self._rpc(_MSG_CMD, {"head": "stats"}, server=server)[0]

    @property
    def type(self):
        return self.name

    @property
    def rank(self):
        return self._rank

    @property
    def num_workers(self):
        """The number of CURRENTLY active workers — the live
        membership view, not the launch-time ``DMLC_NUM_WORKER``
        (which only seeds it).  Moves on evict/join/rejoin/resize."""
        with self._mview_lock:
            return max(1, len(self._mview["members"]))

    # -- live membership (elastic training) ---------------------------------
    def _update_mview(self, rmeta, server=0):
        """Fold a reply's membership payload into the local view.
        Every server's epoch is tracked (pushes declare the last epoch
        seen from THAT server — the fence comparison is same-server);
        the partitioning view follows server 0, the authority.  A bare
        ``mep`` (sync replies) advances the epoch only; a full
        snapshot (heartbeat replies, barrier completed-round
        snapshots) replaces members/world atomically with its epoch —
        never mix a newer epoch with an older member list."""
        mep = rmeta.get("mep")
        if mep is None:
            return
        with self._mview_lock:
            if mep > self._server_meps.get(server, -1):
                self._server_meps[server] = int(mep)
            if server != 0:
                return
            if "members" in rmeta:
                if mep >= self._mview["mep"]:
                    self._mview = {
                        "mep": int(mep),
                        "members": [int(r) for r in rmeta["members"]],
                        "world": int(rmeta.get(
                            "world", self._mview["world"]))}
            elif mep > self._mview["mep"]:
                self._mview["mep"] = int(mep)

    def membership(self):
        """The worker's current view: ``{"mep", "members", "world"}``.
        After :meth:`barrier` this is the completed round's consistent
        server-0 snapshot — every worker of the round sees the same
        triple, so re-sharding decisions land on the same batch
        boundary everywhere."""
        with self._mview_lock:
            return {"mep": self._mview["mep"],
                    "members": list(self._mview["members"]),
                    "world": self._mview["world"]}

    def refresh_membership(self):
        """Force-refresh the view from server 0's stats (the
        authoritative membership for data partitioning) and return it."""
        st = self.server_stats(server=0)
        self._update_mview({"mep": st.get("mep", 0),
                            "members": st.get("members", []),
                            "world": st.get("world", 1)})
        return self.membership()

    def my_position(self):
        """This rank's index in the sorted member list (its shard
        assignment), or None when the rank is not currently a member
        (evicted / retired / not yet admitted)."""
        with self._mview_lock:
            members = sorted(self._mview["members"])
        try:
            return members.index(self._rank)
        except ValueError:
            return None

    def resize(self, world):
        """Operator-commanded rescale to *world* workers, in either
        direction, without a restart.  The target is recorded on every
        server and APPLIED at the next sync-round boundary (barrier
        completion): shrunk-away ranks see themselves retired in that
        round's membership snapshot and exit cleanly; grown slots are
        filled as new workers heartbeat in and are admitted.  Returns
        server 0's acknowledgement."""
        replies = [self._rpc(_MSG_CMD, {"head": "resize",
                                        "body": int(world)}, server=s)[0]
                   for s in range(self._num_servers)]
        _obs_events.emit("membership", action="resize_requested",
                         target=int(world), rank=self._rank)
        return replies[0]

    def put_job_meta(self, meta):
        """Publish the opaque job-state blob (JSON-able: data cursor,
        sampler state, round number) a mid-epoch joiner needs to take
        over its shard; kept on server 0."""
        self._rpc(_MSG_CMD, {"head": "jobmeta", "body": meta}, server=0)

    def get_job_meta(self):
        return self._rpc(_MSG_CMD, {"head": "jobmeta_get"},
                         server=0)[0].get("meta")

    def wait_admission(self, timeout=None, poll=None):
        """Block until this rank is ADMITTED to the expected set (a
        joiner/rejoiner becomes a member at a barrier completion), then
        align the local barrier-round counter with the round the server
        admitted it at — the joiner's next ``barrier()`` lands on the
        same round number as the survivors'.  Returns the refreshed
        membership view."""
        from .config import get_env as _get_env
        if timeout is None:
            timeout = _get_env("MXNET_KVSTORE_JOIN_TIMEOUT")
        if poll is None:
            poll = _get_env("MXNET_KVSTORE_ADMIT_POLL")
        deadline = time.monotonic() + timeout
        while True:
            st = self.server_stats(server=0)
            if self._rank in st.get("members", ()):
                self._update_mview({"mep": st.get("mep", 0),
                                    "members": st["members"],
                                    "world": st.get("world", 1)})
                admitted = (st.get("admitted_round") or {}).get(
                    str(self._rank))
                if admitted is not None:
                    self._barrier_round = int(admitted)
                _obs_events.emit("membership", action="admitted",
                                 rank=self._rank,
                                 round=self._barrier_round,
                                 mep=st.get("mep"))
                log.warning(
                    "kvstore rank %d admitted at round %d (membership "
                    "epoch %s, members %s)", self._rank,
                    self._barrier_round, st.get("mep"),
                    st.get("members"))
                return self.membership()
            if time.monotonic() > deadline:
                raise MXNetError(
                    "rank %d was not admitted within %.1fs "
                    "(members=%s, pending=%s, world=%s) — is a sync "
                    "round/barrier actually completing? admission "
                    "happens at barrier boundaries"
                    % (self._rank, timeout, st.get("members"),
                       st.get("pending_join"), st.get("world")))
            time.sleep(poll)

    def _rpc(self, kind, meta=None, tensors=(), server=None, key=None):
        """One framed round-trip; returns (reply_meta, reply_tensors).

        Mutating kinds get a ``(rank, seq)`` request id; every kind
        gets transport retries: a timeout or broken connection closes
        the socket, reconnects, and resends the SAME request — the
        server's dedup window makes retried mutations exactly-once."""
        s = (server if server is not None
             else self._server_for_key(key) if key is not None else 0)
        if kind in _MUTATING_KINDS:
            with self._seq_lock:
                self._req_seq += 1
                seq = self._req_seq
            meta = dict(meta or {})
            meta["req"] = [self._rank, seq, self._incarnation]
            if kind == _MSG_PUSH:
                # declare the membership view this contribution was
                # computed under (per-server epoch): the server's
                # per-rank fence uses it to reject a push born before
                # this rank's eviction
                with self._mview_lock:
                    meta["mep"] = self._server_meps.get(s, 0)
        with self._locks[s]:
            reply = self._rpc_with_retry(s, kind, meta, tensors)
        if isinstance(reply[0], dict):
            self._update_mview(reply[0], server=s)
        # wire-level traffic accounting (payload bytes, post
        # compression/rsp packing — the number a capacity planner
        # multiplies by worker count)
        if kind == _MSG_PUSH and tensors:
            _PUSH_BYTES.inc(sum(int(getattr(t, "nbytes", 0))
                                for t in tensors))
        elif kind in (_MSG_PULL, _MSG_ROWPULL) and reply[1]:
            _PULL_BYTES.inc(sum(int(getattr(t, "nbytes", 0))
                                for t in reply[1]))
        return reply

    def _rpc_with_retry(self, s, kind, meta, tensors):
        """self._locks[s] held.  One request id, up to
        ``MXNET_KVSTORE_RPC_RETRIES`` transport attempts with jittered
        backoff (resilience.retry).  Server-reported errors (MXNetError
        that is not a transport timeout) propagate immediately — only
        the transport retries, never the semantics."""
        def attempt():
            if self._socks[s] is None:
                self._socks[s] = self._connect(s)
            try:
                return _rpc_call(self._socks[s], kind, meta, tensors,
                                 inject=True)
            except (RPCTimeoutError, ConnectionError, OSError):
                # the stream is unusable (half-read reply, torn frame,
                # dead peer): drop it; the next attempt reconnects
                sock, self._socks[s] = self._socks[s], None
                if sock is not None:
                    try:
                        sock.close()
                    except OSError:
                        pass
                raise
        from .resilience.retry import retry_call
        return retry_call(
            attempt, attempts=self._rpc_attempts, base_delay=0.05,
            max_delay=1.0, jitter=0.5,
            retry_on=(RPCTimeoutError, ConnectionError, OSError),
            logger=log,
            on_retry=lambda _a, _e, _d: _RPC_RETRIES.inc())

    def _rpc_fanout(self, calls):
        """Round-trip one request per server CONCURRENTLY — sharded
        keys touch every server, and N sequential TCP round trips would
        serialize what ps-lite pipelines (kvstore_dist.h ZPush over
        per-server channels).  calls: [(server, kind, meta, tensors)];
        returns replies in call order.

        Daemon threads rather than a ThreadPoolExecutor: the executor's
        atexit hook joins its (non-daemon) workers unconditionally, so a
        thread stuck in a timeout-less recv against a dead server would
        wedge process EXIT — with daemon threads a wedged fan-out can
        only block this call, exactly like the sequential code did."""
        if len(calls) <= 1:
            return [self._rpc(kind, meta, tensors, server=s)
                    for s, kind, meta, tensors in calls]
        results = [None] * len(calls)
        errors = []

        def work(i, s, kind, meta, tensors):
            try:
                results[i] = self._rpc(kind, meta, tensors, server=s)
            except BaseException as e:  # surfaced on the caller thread
                errors.append(e)

        threads = [_san.thread(target=work, args=(i,) + c, daemon=True)
                   for i, c in enumerate(calls)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        return results

    def _shard_splits(self, n):
        """Contiguous per-server chunk lengths for a flat size-n array."""
        base, rem = divmod(n, self._num_servers)
        return [base + (1 if i < rem else 0)
                for i in range(self._num_servers)]

    def init(self, key, value):
        from .ndarray import sparse as _sp
        keys, values = _key_list(key, value)
        for k, vs in zip(keys, values):
            arr = _host(vs[0].todense() if isinstance(
                vs[0], _sp.BaseSparseNDArray) else vs[0])
            # only rank 0 caches the init-time values (it is the rank
            # that sends INITs, so restart re-init mirrors the same
            # authority) — the cache is a full host-side parameter
            # copy, and paying that on every worker would double host
            # memory for a restart-only path
            if self._rank == 0:
                with self._cache_lock:
                    self._init_cache[k] = arr
            # the sharding decision is taken ONCE at init and recorded:
            # later compression toggles must not change a key's layout
            # (every worker runs init, so every worker records it).
            # Sparse-typed keys are NEVER sharded: their pushes travel in
            # the compact row_sparse wire format to the hash-picked
            # server, which would silently miss the '#shard' keys — the
            # canonical big-embedding case would train on garbage.
            if (self._num_servers > 1 and arr.size > self._big_bound
                    and not self._compression
                    and not isinstance(vs[0], _sp.BaseSparseNDArray)):
                self._sharded_keys.add(k)
            if self._rank == 0:
                if k in self._sharded_keys:
                    flat = arr.ravel()
                    off = 0
                    for s, ln in enumerate(self._shard_splits(arr.size)):
                        self._rpc(_MSG_INIT,
                                  {"key": "%s#shard%d" % (k, s)},
                                  (flat[off:off + ln],), server=s)
                        off += ln
                else:
                    self._rpc(_MSG_INIT, {"key": k}, (arr,), key=k)
        self.barrier()

    def push(self, key, value, priority=0):
        keys, values = _key_list(key, value)
        for k, vs in zip(keys, values):
            total = vs[0]
            for v in vs[1:]:
                total = total + v
            from .ndarray import sparse as _sp
            if isinstance(total, _sp.RowSparseNDArray) and \
                    not self._compression and \
                    k not in self._sharded_keys:
                # compact wire format: only touched rows travel
                # (reference: kvstore_dist.h PushRowSparse).  A key that
                # was initialized dense AND sharded lives only as
                # '#shard' sub-keys, so its sparse gradients fall through
                # to the dense sharded path below.
                self._rpc(_MSG_PUSH,
                          {"key": k, "rsp": True,
                           "shape": [int(s) for s in total.shape]},
                          (_host(total._aux[0]), _host(total._data)),
                          key=k)
                continue
            if isinstance(total, _sp.BaseSparseNDArray):
                total = total.todense()
            arr = _host(total)
            if k in self._sharded_keys:
                # big-array sharding: contiguous chunks pushed to every
                # server concurrently (reference: kvstore_dist.h:58
                # MXNET_KVSTORE_BIGARRAY_BOUND + ps-lite channels)
                flat = arr.ravel()
                calls = []
                off = 0
                for s, ln in enumerate(self._shard_splits(arr.size)):
                    calls.append((s, _MSG_PUSH,
                                  {"key": "%s#shard%d" % (k, s)},
                                  (flat[off:off + ln],)))
                    off += ln
                self._rpc_fanout(calls)
                continue
            meta = {"key": k}
            if self._compression and \
                    self._compression.get("type") == "2bit":
                threshold = float(self._compression.get("threshold", 0.5))
                packed, n_, self._residual[k] = compress_2bit(
                    arr, self._residual.get(k, _np.zeros_like(arr)),
                    threshold)
                meta.update(compressed=True, threshold=threshold,
                            n=int(n_), shape=list(arr.shape))
                arr = packed
            self._rpc(_MSG_PUSH, meta, (arr,), key=k)

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        keys, outs = _key_list(key, out)
        for k, os_ in zip(keys, outs):
            shape = tuple(int(s) for s in os_[0].shape)
            size = 1
            for s in shape:
                size *= s
            if k in self._sharded_keys:
                # pull every server's chunk concurrently, reassemble in
                # split order (same split rule as init/push)
                calls = [(s, _MSG_PULL,
                          {"key": "%s#shard%d" % (k, s)}, ())
                         for s, _ln in enumerate(
                             self._shard_splits(size))]
                replies = self._rpc_fanout(calls)
                arr = _np.concatenate(
                    [r[1][0].ravel() for r in replies]).reshape(shape)
            else:
                arr = self._rpc(_MSG_PULL, {"key": k}, key=k)[1][0]
            arr = torch.from_numpy(_np.ascontiguousarray(arr))
            for o in os_:
                _write(o, arr)

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        keys, outs = _key_list(key, out)
        rids = _as_list(row_ids)
        for k, os_ in zip(keys, outs):
            fetched = {}  # unique rid tuple -> rows, one RPC per set
            for o, rid in zip(os_, rids * len(os_)):
                rid_np = _np.unique(_host(rid).astype(_np.int64))
                cache_key = rid_np.tobytes()
                if cache_key not in fetched:
                    # server-side retain: only requested rows come back
                    fetched[cache_key] = self._rpc(
                        _MSG_ROWPULL, {"key": k}, (rid_np,), key=k)[1][0]
                vals = torch.from_numpy(_np.ascontiguousarray(
                    fetched[cache_key]))
                _set_rsp(o, vals, torch.from_numpy(rid_np), o.shape)

    def set_optimizer(self, optimizer):
        """Ship the optimizer to every server (reference: kvstore.py
        set_optimizer:450 pickles the optimizer to servers)."""
        if self._rank == 0:
            blob = _np.frombuffer(pickle.dumps(optimizer), _np.uint8)
            for s in range(self._num_servers):
                self._rpc(_MSG_SET_OPT, None, (blob,), server=s)
        self.barrier()

    def barrier(self):
        # every server coordinates its own copy of the round (the
        # round number makes overlapping barriers under worker skew
        # unambiguous): membership transitions apply at barrier
        # completion, and they must land on EVERY server at the same
        # round boundary or a resize would split one logical step's
        # expected sets across the key shards.  Server 0's completed-
        # round snapshot (folded into the view by _rpc) stays the
        # authoritative membership for data partitioning.
        self._barrier_round += 1
        meta = {"rank": self._rank, "round": self._barrier_round}
        if self._num_servers == 1:
            self._rpc(_MSG_BARRIER, meta, server=0)
        else:
            self._rpc_fanout([(s, _MSG_BARRIER, meta, ())
                              for s in range(self._num_servers)])

    def _send_command_to_servers(self, head, body):
        for s in range(self._num_servers):
            self._rpc(_MSG_CMD, {"head": head, "body": body}, server=s)

    def stop_server(self):
        self._closed = True
        # deliberately NOT routed through the retry transport: a dead
        # server must not cost reconnect deadlines at shutdown — one
        # best-effort STOP per live socket
        for s in range(self._num_servers):
            try:
                with self._locks[s]:
                    sock = self._socks[s]
                    if sock is None:
                        continue
                    _rpc_call(sock, _MSG_STOP)
            except (RPCTimeoutError, ConnectionError, OSError):
                pass


def create(name="local"):
    """Factory (reference: kvstore.cc:40-72 — contains 'dist' -> dist;
    'nccl'/'tpu' -> the device store; 'local', 'device',
    'local_allreduce_*' -> local)."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    if "dist" in name:
        if os.environ.get("DMLC_ROLE", "worker") == "server":
            raise MXNetError("server role should run "
                             "mxnet_tpu_torch.kvstore_server.run_server()")
        return KVStoreDist(name)
    if name in ("tpu", "nccl"):
        return KVStoreNCCL(name)
    if name in ("local", "device", "local_allreduce_cpu",
                "local_allreduce_device"):
        return KVStoreLocal(name)
    raise MXNetError("unknown kvstore type %r" % name)
