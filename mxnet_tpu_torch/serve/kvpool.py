"""Paged KV-cache pool — fixed device blocks shared by every decode
session (port of ``mxnet_tpu/serve/kvpool.py``).

The dense :class:`~.predictor.DecodeSession` gives each session its own
worst-case-length cache: N concurrent sessions pay N full caches of
device memory and N dispatches per token.  This module allocates ONE
fixed pool of cache blocks per model at load time, hands each session a
*block table* of indices into it, and lets the decode engine's programs
(one CUDA graph per rung on the card) gather/scatter through the table.
Memory is bounded by the pool — many sessions share it, each holding
only the blocks its sequence has actually reached.

Layout, per cache leaf (e.g. per-layer K and V):

    pool leaf:   (num_blocks, block_size, *per_token_shape)
    block table: (max_blocks_per_session,) int32 per session
    dense view:  (S, padded_len, *per_token_shape)   gathered per tick

Block 0 is the reserved **null block**: unused table entries point at
it, padding rows of a partially-filled session rung write their garbage
into it, and no session ever owns it — so a co-tenant's writes can land
there without corrupting anyone.

The pool's tensors are allocated once and then only ever written in
place: the engine's CUDA graphs captured their addresses, so
:meth:`KVPool.set_arrays` copies into them and a rebuild takes them over
zeroed (:meth:`KVPool.clone_empty` with ``reuse_arrays``).

Admission control: an ``alloc`` that cannot be satisfied raises the
typed :class:`KVPoolExhausted` (an :class:`~.buckets.OverloadError`)
instead of queueing or running out of memory.

Knobs: ``MXNET_SERVE_KV_BLOCK_SIZE`` (tokens per block) and
``MXNET_SERVE_KV_BLOCKS`` (pool capacity).  Gauges
``serve_kv_blocks_in_use`` / ``serve_kv_blocks_total`` are
delta-maintained so multiple pools aggregate.
"""

from __future__ import annotations

import torch

from .buckets import OverloadError, ServeError
from .. import sanitizer as _san
from ..base import torch_dtype
from ..context import Context, current_context
from ..observability import events as _obs_events
from ..observability import metrics as _obs_metrics

__all__ = ["KVPool", "KVPoolExhausted"]

_BLOCKS_TOTAL = _obs_metrics.gauge(
    "serve_kv_blocks_total",
    "allocatable KV-cache blocks across all live paged pools "
    "(delta-maintained; excludes each pool's reserved null block)")
_BLOCKS_IN_USE = _obs_metrics.gauge(
    "serve_kv_blocks_in_use",
    "KV-cache blocks currently owned by live decode sessions "
    "(delta-maintained across pools)")


class KVPoolExhausted(OverloadError):
    """The paged KV pool has no free block.  Raised at session admission
    (shed at the front door) or when a live session's sequence crosses a
    block boundary with the pool full (that session fails typed and
    releases its blocks)."""


def as_device(device):
    """A ``torch.device`` from a Context, a torch device or its name
    (default: the current context's device, ``gpu(0)``)."""
    if device is None:
        return current_context().torch_device
    if isinstance(device, Context):
        return device.torch_device
    return torch.device(device)


class KVPool:
    """A fixed pool of device-resident cache blocks + its allocator.

    Parameters
    ----------
    token_spec : dict name -> spec
        Shape/dtype of ONE token's cache slice per leaf; a spec is
        anything with ``shape`` and ``dtype`` (a meta tensor, say
        ``torch.empty((heads, dim), device="meta")``).  Pool leaves are
        allocated as ``(num_blocks, block_size) + spec.shape``.
    num_blocks : int, optional
        Total blocks including the reserved null block (default the
        ``MXNET_SERVE_KV_BLOCKS`` knob).
    block_size : int, optional
        Tokens per block (default ``MXNET_SERVE_KV_BLOCK_SIZE``).
    device : Context or torch.device, optional
        Where the pool lives (default: the current context, ``gpu(0)``).

    The tensors are :attr:`arrays` (a dict like *token_spec*); they are
    written in place, never re-bound.
    """

    def __init__(self, token_spec, num_blocks=None, block_size=None,
                 device=None, _arrays=None):
        from ..config import get_env

        if num_blocks is None:
            num_blocks = get_env("MXNET_SERVE_KV_BLOCKS")
        if block_size is None:
            block_size = get_env("MXNET_SERVE_KV_BLOCK_SIZE")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        if self.block_size < 1:
            raise ServeError("KV block size must be >= 1, got %d"
                             % self.block_size)
        if self.num_blocks < 2:
            raise ServeError(
                "KV pool needs >= 2 blocks (block 0 is the reserved "
                "null block), got %d" % self.num_blocks)
        self._device = as_device(device)
        if not token_spec:
            raise ServeError("KV pool token_spec has no leaves")
        self._spec = {n: (tuple(int(d) for d in s.shape),
                          torch_dtype(s.dtype))
                      for n, s in token_spec.items()}
        if _arrays is None:
            self.arrays = {
                n: torch.zeros((self.num_blocks, self.block_size) + shape,
                               dtype=dt, device=self._device)
                for n, (shape, dt) in self._spec.items()}
        else:
            self.arrays = _arrays
            for a in _arrays.values():
                a.zero_()
        # bytes, for operators sizing the pool
        self.bytes_per_block = sum(
            self.block_size * torch.empty((), dtype=dt).element_size()
            * _prod(shape) for shape, dt in self._spec.values())
        self._lock = _san.lock(label="serve.kvpool")
        # free list: every block except the reserved null block 0
        self._free = list(range(self.num_blocks - 1, 0, -1))
        self._in_use = 0
        self._closed = False
        _san.track(self, ("_free", "_in_use", "_closed", "arrays"),
                   label="serve.kvpool")
        _BLOCKS_TOTAL.inc(self.num_blocks - 1)

    # -- state (engine-side) ------------------------------------------------
    def set_arrays(self, arrays):
        """Write *arrays* ({leaf: tensor of the leaf's shape}) into the
        pool's tensors in place — the programs captured their
        addresses."""
        for n, a in arrays.items():
            self.arrays[n].copy_(a)

    @property
    def device(self):
        return self._device

    # -- allocator ----------------------------------------------------------
    @property
    def blocks_total(self):
        """Allocatable blocks (the null block is not allocatable)."""
        return self.num_blocks - 1

    @property
    def blocks_in_use(self):
        with self._lock:
            return self._in_use

    @property
    def blocks_free(self):
        with self._lock:
            return len(self._free)

    def alloc(self, n, owner="?"):
        """Take *n* blocks; returns their ids.  Raises the typed
        :class:`KVPoolExhausted` (and emits a ``decode`` event) when
        fewer than *n* are free — all-or-nothing, so a partially
        admitted session never strands blocks."""
        n = int(n)
        if n < 1:
            raise ServeError("KV alloc needs n >= 1, got %d" % n)
        with self._lock:
            if self._closed:
                raise ServeError("KV pool is closed")
            if len(self._free) < n:
                free = len(self._free)
                in_use = self._in_use
            else:
                blocks = [self._free.pop() for _ in range(n)]
                self._in_use += n
                _BLOCKS_IN_USE.inc(n)
                return blocks
        _obs_events.emit("decode", kind="pool_exhausted", owner=owner,
                         requested=n, free=free, in_use=in_use,
                         total=self.blocks_total)
        raise KVPoolExhausted(
            "KV pool exhausted: %d block(s) requested, %d free "
            "(%d/%d in use) — shed the session or grow "
            "MXNET_SERVE_KV_BLOCKS" % (n, free, in_use, self.blocks_total))

    def clone_empty(self, reuse_arrays=False):
        """A fresh, empty pool with this pool's token spec, geometry and
        device — the quarantine-and-rebuild primitive.  With
        *reuse_arrays* the clone takes over this pool's tensors, zeroed
        in place, so every program built against this pool (a CUDA graph
        captured their addresses) runs the clone with ZERO new builds;
        otherwise it allocates its own.  The suspect pool itself is
        quarantined by :meth:`close`."""
        spec = {n: torch.empty(shape, dtype=dt, device="meta")
                for n, (shape, dt) in self._spec.items()}
        return KVPool(spec, num_blocks=self.num_blocks,
                      block_size=self.block_size, device=self._device,
                      _arrays=self.arrays if reuse_arrays else None)

    def free(self, blocks):
        """Return *blocks* to the pool (session end, any reason)."""
        if not blocks:
            return
        with self._lock:
            if self._closed:
                return
            for b in blocks:
                if int(b) == 0:
                    raise ServeError("block 0 is the reserved null "
                                     "block — it is never allocated")
            self._free.extend(int(b) for b in blocks)
            self._in_use -= len(blocks)
            _BLOCKS_IN_USE.dec(len(blocks))

    def close(self):
        """Release the pool: gauges drop, the tensors are unreferenced
        (memory returns when the engine drops its programs too).
        Idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            in_use = self._in_use
            self._in_use = 0
            self._free = []
        if in_use:
            _BLOCKS_IN_USE.dec(in_use)
        _BLOCKS_TOTAL.dec(self.num_blocks - 1)
        self.arrays = None


def _prod(shape):
    out = 1
    for s in shape:
        out *= int(s)
    return out
