"""ctypes binding for the native RecordIO reader (port of
``mxnet_tpu/recordio_native.py``; src/io/recordio_reader.cc; reference:
the C++ record readers in src/io/iter_image_recordio_2.cc).

``NativeRecordReader`` mirrors MXRecordIO's read surface with the
framing/IO in C++.  The library is built from ``src/io`` at first use
(``runtime/native.py``); a failed build raises with the compiler's
output."""

from __future__ import annotations

import ctypes

from .runtime import native as _native

__all__ = ["available", "NativeRecordReader", "build_index"]


def _bind(lib):
    lib.RIOGetLastError.restype = ctypes.c_char_p
    lib.RIOOpen.restype = ctypes.c_void_p
    lib.RIOOpen.argtypes = [ctypes.c_char_p]
    lib.RIOClose.argtypes = [ctypes.c_void_p]
    lib.RIOReset.argtypes = [ctypes.c_void_p]
    lib.RIOSeek.restype = ctypes.c_int
    lib.RIOSeek.argtypes = [ctypes.c_void_p, ctypes.c_long]
    lib.RIOTell.restype = ctypes.c_long
    lib.RIOTell.argtypes = [ctypes.c_void_p]
    lib.RIONext.restype = ctypes.c_int
    lib.RIONext.argtypes = [ctypes.c_void_p,
                            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
                            ctypes.POINTER(ctypes.c_uint64)]
    lib.RIOBuildIndex.restype = ctypes.c_long
    lib.RIOBuildIndex.argtypes = [ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.c_uint64),
                                  ctypes.c_long]


def _lib():
    return _native.load("recordio_reader", _bind)


def available():
    """True once the native library is built (this builds it)."""
    return _lib() is not None


class NativeRecordReader(object):
    """Sequential + seekable record reader over the native library."""

    def __init__(self, path):
        lib = _lib()
        self._lib = lib
        self._h = lib.RIOOpen(path.encode())
        if not self._h:
            raise IOError(lib.RIOGetLastError().decode())

    def _handle(self):
        if not self._h:
            raise IOError("reader is closed")
        return self._h

    def read(self):
        """Next record bytes, or None at EOF."""
        h = self._handle()
        data = ctypes.POINTER(ctypes.c_uint8)()
        size = ctypes.c_uint64()
        rc = self._lib.RIONext(h, ctypes.byref(data), ctypes.byref(size))
        if rc == 0:
            return None
        if rc < 0:
            raise IOError(self._lib.RIOGetLastError().decode())
        return ctypes.string_at(data, size.value)

    def seek(self, offset):
        """Position at a byte *offset* (record boundary)."""
        if self._lib.RIOSeek(self._handle(), offset) != 0:
            raise IOError("seek failed")

    def read_idx(self, offset):
        """Record at a byte *offset* (from the .idx file)."""
        self.seek(offset)
        return self.read()

    def reset(self):
        self._lib.RIOReset(self._handle())

    def tell(self):
        return self._lib.RIOTell(self._handle())

    def close(self):
        if self._h:
            self._lib.RIOClose(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def build_index(path):
    """Record start offsets for a .rec file (native full-file scan;
    reference: tools/im2rec index generation).  Grows the offset buffer
    in chunks so arbitrarily large files index completely."""
    lib = _lib()
    h = lib.RIOOpen(path.encode())
    if not h:
        raise IOError(lib.RIOGetLastError().decode())
    try:
        lib.RIOReset(h)
        out = []
        chunk = 1 << 16
        arr = (ctypes.c_uint64 * chunk)()
        while True:
            # scans forward from the current position, so repeated
            # calls with a bounded buffer index files of any size
            n = lib.RIOBuildIndex(h, arr, chunk)
            if n < 0:
                raise IOError(lib.RIOGetLastError().decode())
            out.extend(int(arr[i]) for i in range(n))
            if n < chunk:
                return out
    finally:
        lib.RIOClose(h)
