"""RecordIO in the PyTorch port (``mxnet_tpu_torch/recordio.py``,
``recordio_native.py``) against the JAX package's: each package reads
the other's files, files written for the same records are byte-equal,
and the native reader (built from ``src/io`` at first use) frames,
reassembles and rejects as the reference's does."""

import io
import os
import pickle
import struct
import sys
import threading

import numpy as np
import pytest

from mxnet_tpu import recordio as jrec
from mxnet_tpu_torch import recordio as trec
from mxnet_tpu_torch import recordio_native as tnative


def _records(seed=0, n=9):
    rs = np.random.RandomState(seed)
    out = []
    for i in range(n):
        size = int(rs.randint(0, 300))
        out.append(rs.randint(0, 256, size).astype(np.uint8).tobytes())
    out.append(b"")
    out.append(b"x" * 4096)
    return out


def _write(mod, tmp_path, tag, recs, indexed):
    rec = str(tmp_path / ("%s.rec" % tag))
    idx = str(tmp_path / ("%s.idx" % tag))
    if indexed:
        w = mod.MXIndexedRecordIO(idx, rec, "w")
        for i, r in enumerate(recs):
            w.write_idx(3 * i + 1, r)
    else:
        w = mod.MXRecordIO(rec, "w")
        for r in recs:
            w.write(r)
    w.close()
    return rec, idx


def _read_all(mod, rec):
    r = mod.MXRecordIO(rec, "r")
    out = []
    while True:
        b = r.read()
        if b is None:
            break
        out.append(b)
    r.close()
    return out


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("indexed", [False, True])
def test_files_byte_equal_across_packages(tmp_path, indexed):
    recs = _records()
    jr, ji = _write(jrec, tmp_path, "jax", recs, indexed)
    tr, ti = _write(trec, tmp_path, "torch", recs, indexed)
    assert _bytes(jr) == _bytes(tr)
    if indexed:
        assert _bytes(ji) == _bytes(ti)


@pytest.mark.parametrize("native", ["1", "0"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_each_package_reads_the_others_files(tmp_path, monkeypatch, native,
                                             writer):
    monkeypatch.setenv("MXNET_USE_NATIVE_RECORDIO", native)
    recs = _records(seed=1)
    wmod, rmod = (jrec, trec) if writer == "jax" else (trec, jrec)
    rec, idx = _write(wmod, tmp_path, writer, recs, True)
    assert _read_all(rmod, rec) == recs
    r = rmod.MXIndexedRecordIO(idx, rec, "r")
    assert r.keys == [3 * i + 1 for i in range(len(recs))]
    for i in (5, 0, 10, 2):
        assert r.read_idx(3 * i + 1) == recs[i]
    r.close()


def test_reader_is_native_by_default_and_python_when_off(tmp_path,
                                                         monkeypatch):
    monkeypatch.delenv("MXNET_USE_NATIVE_RECORDIO", raising=False)
    rec, _ = _write(trec, tmp_path, "n", [b"one", b"two"], False)
    r = trec.MXRecordIO(rec, "r")
    assert r._native is not None
    assert r.read() == b"one" and r.read() == b"two"
    r.close()
    monkeypatch.setenv("MXNET_USE_NATIVE_RECORDIO", "0")
    r = trec.MXRecordIO(rec, "r")
    assert r._native is None
    assert r.read() == b"one"
    r.close()


def test_native_library_built_from_src_io_with_its_log():
    from mxnet_tpu_torch.runtime import native
    info = native.build("recordio_reader")
    path = info["path"]
    assert os.path.dirname(path) == native.BUILD_DIR
    assert os.path.exists(path) and os.path.exists(path + ".log")
    assert "recordio_reader.cc" in info["command"]


def test_failed_native_build_raises_with_the_compiler_log(tmp_path,
                                                          monkeypatch):
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.runtime import native
    src = tmp_path / "broken.cc"
    src.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE_DIR", str(tmp_path))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "out"))
    monkeypatch.setitem(native.LIBS, "broken", ("broken.cc", []))
    with pytest.raises(MXNetError, match="broken.cc failed") as ei:
        native.build("broken")
    assert "error" in str(ei.value)


def test_native_roundtrip_and_index(tmp_path):
    recs = [b"hello", b"x" * 7, b"", b"payload" * 1000]
    rec, _ = _write(trec, tmp_path, "t", recs, False)
    r = tnative.NativeRecordReader(rec)
    got = []
    while True:
        b = r.read()
        if b is None:
            break
        got.append(b)
    assert got == recs
    offs = tnative.build_index(rec)
    assert len(offs) == len(recs)
    assert r.read_idx(offs[2]) == recs[2]
    assert r.read_idx(offs[3]) == recs[3]
    r.close()


def test_native_multipart_reassembly(tmp_path):
    p = str(tmp_path / "mp.rec")
    with open(p, "wb") as f:
        for cflag, data in [(1, b"abcd"), (2, b"efgh"), (3, b"ij")]:
            f.write(struct.pack("<II", 0xced7230a, (cflag << 29) | len(data)))
            f.write(data)
            f.write(b"\x00" * ((4 - len(data) % 4) % 4))
    r = tnative.NativeRecordReader(p)
    assert r.read() == b"abcdefghij"
    assert r.read() is None
    r.close()


def test_native_corrupt_length_rejected(tmp_path):
    p = str(tmp_path / "bad.rec")
    with open(p, "wb") as f:
        f.write(struct.pack("<II", 0xced7230a, (1 << 29) - 1))
        f.write(b"tiny")
    r = tnative.NativeRecordReader(p)
    with pytest.raises(IOError, match="exceeds file size"):
        r.read()
    r.close()


def test_native_closed_handle_raises(tmp_path):
    rec, _ = _write(trec, tmp_path, "c", [b"x"], False)
    r = tnative.NativeRecordReader(rec)
    r.close()
    with pytest.raises(IOError, match="closed"):
        r.read()
    with pytest.raises(IOError, match="closed"):
        r.tell()


@pytest.mark.parametrize("label", [7.0, [1.0, 2.0, 3.0]])
def test_pack_unpack_equal_to_the_reference(label):
    header = trec.IRHeader(0, label, 42, 5)
    s = trec.pack(header, b"imagebytes")
    assert s == jrec.pack(jrec.IRHeader(0, label, 42, 5), b"imagebytes")
    h2, payload = trec.unpack(s)
    j2, jpayload = jrec.unpack(s)
    assert payload == jpayload == b"imagebytes"
    np.testing.assert_array_equal(np.asarray(h2.label),
                                  np.asarray(j2.label))
    assert (h2.flag, h2.id, h2.id2) == (j2.flag, j2.id, j2.id2)


@pytest.mark.parametrize("fmt", [".jpg", ".png"])
def test_pack_img_unpack_img_equal_to_the_reference(fmt):
    rs = np.random.RandomState(3)
    img = rs.randint(0, 256, (20, 17, 3)).astype(np.uint8)
    header = trec.IRHeader(0, 4.0, 9, 0)
    s = trec.pack_img(header, img, quality=90, img_fmt=fmt)
    assert s == jrec.pack_img(jrec.IRHeader(0, 4.0, 9, 0), img, quality=90,
                              img_fmt=fmt)
    h, got = trec.unpack_img(s)
    _, want = jrec.unpack_img(s)
    assert h.label == 4.0
    np.testing.assert_array_equal(got, want)
    if fmt == ".png":
        np.testing.assert_array_equal(got, img)


def test_pack_img_falls_back_to_npy_without_pil(monkeypatch):
    img = np.arange(24, dtype=np.uint8).reshape(2, 4, 3)
    monkeypatch.setitem(sys.modules, "PIL", None)
    s = trec.pack_img(trec.IRHeader(0, 1.0, 2, 0), img)
    assert s == jrec.pack_img(jrec.IRHeader(0, 1.0, 2, 0), img)
    h, got = trec.unpack_img(s)
    np.testing.assert_array_equal(got, img)
    assert h.label == 1.0


@pytest.mark.parametrize("native", ["1", "0"])
def test_reader_pickles_by_path_and_reopens(tmp_path, monkeypatch, native):
    monkeypatch.setenv("MXNET_USE_NATIVE_RECORDIO", native)
    recs = _records(seed=2)
    rec, idx = _write(trec, tmp_path, "p", recs, True)
    r = trec.MXIndexedRecordIO(idx, rec, "r")
    r.read_idx(4)
    r2 = pickle.loads(pickle.dumps(r))
    assert r2.keys == r.keys
    assert r2.read_idx(7) == recs[2] and r.read_idx(7) == recs[2]
    w = trec.MXRecordIO(str(tmp_path / "w.rec"), "w")
    with pytest.raises(TypeError, match="writer"):
        pickle.dumps(w)
    w.close()


def test_read_idx_is_safe_across_threads(tmp_path):
    recs = [bytes([i]) * (50 + 37 * i) for i in range(40)]
    rec, idx = _write(trec, tmp_path, "s", recs, True)
    r = trec.MXIndexedRecordIO(idx, rec, "r")
    errors = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def reader(k):
        rs = np.random.RandomState(k)
        for i in rs.randint(0, len(recs), 300):
            if r.read_idx(3 * int(i) + 1) != recs[int(i)]:
                errors.append(int(i))

    try:
        threads = [threading.Thread(target=reader, args=(k,))
                   for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    r.close()
    assert errors == []


def test_jax_reader_reads_port_written_image_records(tmp_path):
    from PIL import Image
    rs = np.random.RandomState(4)
    img = rs.randint(0, 256, (12, 10, 3)).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    rec, idx = _write(trec, tmp_path, "img",
                      [trec.pack(trec.IRHeader(0, float(i), i, 0),
                                 buf.getvalue()) for i in range(3)], True)
    r = jrec.MXIndexedRecordIO(idx, rec, "r")
    h, got = jrec.unpack_img(r.read_idx(4))
    assert h.label == 1.0
    np.testing.assert_array_equal(got, img)
    r.close()
