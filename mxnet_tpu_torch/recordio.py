"""RecordIO file format (port of ``mxnet_tpu/recordio.py``; reference:
python/mxnet/recordio.py and src/io/image_recordio.h).

Binary framing: [magic u32][lrecord u32][data][pad to 4B], where lrecord
encodes cflag (3 bits) + length (29 bits); identical layout to the
reference so .rec files interoperate.  ``IRHeader`` packs image records the
same way as ``mx.recordio.pack``.

Reads go through the native C++ reader (``src/io/recordio_reader.cc``,
built at first use) unless ``MXNET_USE_NATIVE_RECORDIO=0``.  A reader
pickles by path and reopens where it is unpickled (as upstream MXNet's
does), so a dataset over a record file crosses to DataLoader worker
processes; ``read_idx`` holds a lock so thread workers may share one.
"""

from __future__ import annotations

import collections
import os
import struct
import threading

import numpy as _np

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader", "pack", "unpack",
           "pack_img", "unpack_img"]

_MAGIC = 0xced7230a


def _lrecord(cflag, length):
    return (cflag << 29) | length


def _parse_lrecord(lrec):
    return lrec >> 29, lrec & ((1 << 29) - 1)


class MXRecordIO:
    """Sequential .rec reader/writer (reference: recordio.py MXRecordIO)."""

    def __init__(self, uri, flag):
        self.uri = uri
        self.flag = flag
        self.fid = None
        self.open()

    def open(self):
        self._native = None
        # seek + read of read_idx as one step: DataLoader thread workers
        # share a dataset's reader
        self._lock = threading.Lock()
        if self.flag == "w":
            self.fid = open(self.uri, "wb")
            self.writable = True
        elif self.flag == "r":
            # read path goes through the native C++ reader, built at
            # first use (src/io/recordio_reader.cc — the reference reads
            # records natively too, iter_image_recordio_2.cc); gated by
            # MXNET_USE_NATIVE_RECORDIO
            from .config import get_env
            from . import recordio_native
            if get_env("MXNET_USE_NATIVE_RECORDIO"):
                self._native = recordio_native.NativeRecordReader(self.uri)
                self.fid = None
            else:
                self.fid = open(self.uri, "rb")
            self.writable = False
        else:
            raise ValueError("Invalid flag %s" % self.flag)

    def close(self):
        if self._native is not None:
            self._native.close()
            self._native = None
        if self.fid is not None:
            self.fid.close()
            self.fid = None

    def reset(self):
        self.close()
        self.open()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()

    def __getstate__(self):
        # an open handle does not pickle: the copy reopens the path
        if self.flag != "r":
            raise TypeError("a RecordIO writer cannot be pickled")
        return {k: v for k, v in self.__dict__.items()
                if k not in ("fid", "_native", "_lock", "idx", "keys")}

    def __setstate__(self, state):
        self.__dict__.update(state)
        self.fid = None
        self.open()

    def tell(self):
        if self._native is not None:
            return self._native.tell()
        return self.fid.tell()

    def write(self, buf):
        assert self.writable
        self.fid.write(struct.pack("<II", _MAGIC, _lrecord(0, len(buf))))
        self.fid.write(buf)
        pad = (4 - len(buf) % 4) % 4
        if pad:
            self.fid.write(b"\x00" * pad)

    def read(self):
        assert not self.writable
        if self._native is not None:
            return self._native.read()
        header = self.fid.read(8)
        if len(header) < 8:
            return None
        magic, lrec = struct.unpack("<II", header)
        assert magic == _MAGIC, "invalid record magic"
        _cflag, length = _parse_lrecord(lrec)
        buf = self.fid.read(length)
        pad = (4 - length % 4) % 4
        if pad:
            self.fid.read(pad)
        return buf


class MXIndexedRecordIO(MXRecordIO):
    """Random-access .rec with .idx file
    (reference: recordio.py MXIndexedRecordIO)."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        super().__init__(uri, flag)

    def open(self):
        super().open()
        self.idx = {}
        self.keys = []
        if self.flag == "r" and os.path.isfile(self.idx_path):
            with open(self.idx_path) as fin:
                for line in fin:
                    parts = line.strip().split("\t")
                    if len(parts) < 2:
                        continue
                    key = self.key_type(parts[0])
                    self.idx[key] = int(parts[1])
                    self.keys.append(key)

    def close(self):
        if self.fid is not None and self.writable:
            with open(self.idx_path, "w") as fout:
                for key in self.keys:
                    fout.write("%s\t%d\n" % (str(key), self.idx[key]))
        super().close()

    def seek(self, idx):
        assert not self.writable
        if self._native is not None:
            self._native.seek(self.idx[idx])
            return
        self.fid.seek(self.idx[idx])

    def read_idx(self, idx):
        with self._lock:
            self.seek(idx)
            return self.read()

    def write_idx(self, idx, buf):
        key = self.key_type(idx)
        pos = self.tell()
        self.write(buf)
        self.idx[key] = pos
        self.keys.append(key)


IRHeader = collections.namedtuple("IRHeader",
                                  ["flag", "label", "id", "id2"])
_IR_FORMAT = "IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


def pack(header, s):
    """Pack a header + byte payload (reference: recordio.py pack)."""
    flag = header.flag
    label = header.label
    if isinstance(label, (list, tuple, _np.ndarray)) and \
            not _np.isscalar(label):
        label = _np.asarray(label, dtype=_np.float32)
        header = IRHeader(len(label), 0.0, header.id, header.id2)
        return struct.pack(_IR_FORMAT, *header) + label.tobytes() + s
    header = IRHeader(0, float(label), header.id, header.id2)
    return struct.pack(_IR_FORMAT, *header) + s


def unpack(s):
    """Unpack bytes into (IRHeader, payload)."""
    header = IRHeader(*struct.unpack(_IR_FORMAT, s[:_IR_SIZE]))
    s = s[_IR_SIZE:]
    if header.flag > 0:
        label = _np.frombuffer(s[:header.flag * 4], dtype=_np.float32)
        header = IRHeader(header.flag, label, header.id, header.id2)
        s = s[header.flag * 4:]
    return header, s


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    """Pack an image array; encodes via PIL if available else raw npy."""
    try:
        from io import BytesIO
        from PIL import Image
        buf = BytesIO()
        fmt = "JPEG" if img_fmt.lower() in (".jpg", ".jpeg") else "PNG"
        Image.fromarray(img.astype(_np.uint8)).save(buf, format=fmt,
                                                    quality=quality)
        return pack(header, buf.getvalue())
    except ImportError:
        from io import BytesIO
        buf = BytesIO()
        _np.save(buf, img)
        return pack(header, buf.getvalue())


def unpack_img(s, iscolor=-1):
    header, payload = unpack(s)
    from io import BytesIO
    if payload[:6] == b"\x93NUMPY":
        img = _np.load(BytesIO(payload))
    else:
        from PIL import Image
        img = _np.asarray(Image.open(BytesIO(payload)))
    return header, img
