"""The wire framing of the distributed kvstore (port of
``mxnet_tpu/_kvstore_impl.py``, subset: the length-framed frame format
the serving fleet speaks; the stores themselves are queue A item 14).

Every message between a fleet router and its replica processes is one
frame:

    frame  := u64 body_len | body
    body   := u8 kind | u32 meta_len | meta (UTF-8 JSON)
              | u8 n_tensors | tensor*
    tensor := u8 name_len | dtype name (ascii, numpy dtype .name)
              | u8 ndim | u64 shape[ndim] | u64 nbytes | raw bytes

The bytes are the JAX package's, byte for byte, so a router of either
package talks to a replica of the other.  Tensors cross as numpy arrays
(a device tensor is read back to the host before it is framed); the
dtype travels by its numpy name and endianness is native on both ends.
"""

from __future__ import annotations

import json
import socket
import struct
import time

import numpy as _np

__all__ = ["_frame_parts", "_frame_bytes", "_send_frame", "_recv_exact",
           "_recv_frame", "_connect_retry", "_MAX_FRAME",
           "_COALESCE_BYTES"]

_MAX_FRAME = 1 << 38  # 256 GiB sanity bound against corrupt streams

_COALESCE_BYTES = 1 << 16  # parts under this are copied+batched


def _pack_tensor(arr):
    arr = _np.asarray(arr)
    shape = arr.shape  # BEFORE ascontiguousarray: it promotes 0-d to (1,)
    name = arr.dtype.name.encode("ascii")
    hdr = struct.pack("<B", len(name)) + name + struct.pack("<B", len(shape))
    if shape:
        hdr += struct.pack("<%dQ" % len(shape), *shape)
    hdr += struct.pack("<Q", arr.nbytes)
    # flat uint8 view: extension dtypes don't implement the buffer
    # protocol, so memoryview(arr) would raise on them
    flat = _np.ascontiguousarray(arr).reshape(-1)
    return hdr, memoryview(flat.view(_np.uint8))


def _frame_parts(kind, meta, tensors):
    """The body parts of one wire frame (shared by the zero-copy sender
    and the torn-frame test path — one wire format, no drift)."""
    meta_b = json.dumps(meta).encode() if meta else b"{}"
    parts = [struct.pack("<BI", kind, len(meta_b)), meta_b,
             struct.pack("<B", len(tensors))]
    for t in tensors:
        hdr, body = _pack_tensor(t)
        parts.append(hdr)
        parts.append(body)
    return parts


def _frame_bytes(kind, meta=None, tensors=()):
    """One frame fully materialized (length prefix included) — used only
    to inject torn frames, never on the hot path."""
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
    instant), a FRESH socket per attempt: after a ``connect`` fails with
    ECONNREFUSED (server still importing/binding) some kernels leave the
    fd broken, and every retry on it fails until the deadline."""
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
