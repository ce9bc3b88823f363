"""NDArray save/load (port of ``mxnet_tpu/ndarray/utils.py``).

The file format is the JAX package's, so either package reads what the
other wrote: a numpy ``.npz`` archive with a ``__magic__`` entry holding
``mxnet_tpu_ndarray_v1``; dict keys are stored as ``key:<name>``, list
items as ``idx:<i>``.  A bfloat16 array, which ``.npz`` cannot hold, is
stored as ``<name>/bits`` (its uint16 bit patterns), ``<name>/shape`` and
a ``<name>/__dtype__`` tag.  A sparse array is stored as ``<name>/data``,
``<name>/indices`` (and ``<name>/indptr`` for CSR), ``<name>/shape`` and
a ``<name>/__stype__`` tag.
"""

from __future__ import annotations

import io
import os

import numpy as _np
import torch

from .ndarray import NDArray, array

__all__ = ["save", "load", "save_bytes", "load_bytes"]

_MAGIC = "mxnet_tpu_ndarray_v1"

# dtypes the npz container round-trips natively
_NPZ_DTYPES = {"float16", "float32", "float64", "int8", "int16", "int32",
               "int64", "uint8", "uint16", "uint32", "uint64", "bool"}


def _entries(data):
    if isinstance(data, NDArray):
        data = [data]
    if isinstance(data, (list, tuple)):
        items = [("idx:%d" % i, v) for i, v in enumerate(data)]
    elif isinstance(data, dict):
        items = [("key:%s" % k, v) for k, v in data.items()]
    else:
        raise ValueError("save expects NDArray, list or dict")
    entries = {}
    for name, v in items:
        if getattr(v, "stype", "default") != "default":
            entries[name + "/__stype__"] = _np.array(v.stype)
            entries[name + "/data"] = v.data.asnumpy()
            entries[name + "/indices"] = v.indices.asnumpy()
            entries[name + "/shape"] = _np.array(v.shape)
            if v.stype == "csr":
                entries[name + "/indptr"] = v.indptr.asnumpy()
            continue
        t = v._data if isinstance(v, NDArray) else torch.as_tensor(v)
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            entries[name + "/__dtype__"] = _np.array("bfloat16")
            bits = t.reshape(-1) if t.dim() == 0 else t
            entries[name + "/bits"] = \
                bits.view(torch.int16).numpy().view(_np.uint16)
            entries[name + "/shape"] = _np.array(tuple(t.shape), _np.int64)
        else:
            arr = t.numpy()
            if arr.dtype.name not in _NPZ_DTYPES:
                raise ValueError("cannot save dtype %s" % arr.dtype)
            entries[name] = arr
    return entries


def save(fname, data):
    """Save NDArrays (a dict, a list or one array) to *fname*.  The file
    is written beside its target and renamed over it, so a crash never
    leaves a torn file at *fname*."""
    entries = _entries(data)
    entries["__magic__"] = _np.array(_MAGIC)
    tmp = "%s.tmp%d" % (fname, os.getpid())
    with open(tmp, "wb") as f:
        _np.savez(f, **entries)
    os.replace(tmp, fname)


def save_bytes(data):
    """NDArrays (a dict, a list or one array) as the bytes of a
    :func:`save` file."""
    entries = _entries(data)
    entries["__magic__"] = _np.array(_MAGIC)
    buf = io.BytesIO()
    _np.savez(buf, **entries)
    return buf.getvalue()


def load_bytes(raw, ctx=None):
    """NDArrays from bytes of :func:`save_bytes` or of a :func:`save`
    file (either package's), onto *ctx* (default: the current
    context)."""
    return load(io.BytesIO(raw), ctx=ctx)


def _sparse_entry(z, base, ctx):
    from . import sparse as _sp
    stype = str(z[base + "/__stype__"])
    shape = tuple(int(s) for s in z[base + "/shape"])
    if stype == "row_sparse":
        return _sp.row_sparse_array(
            (z[base + "/data"], z[base + "/indices"]), shape=shape, ctx=ctx)
    if stype == "csr":
        return _sp.csr_matrix((z[base + "/data"], z[base + "/indices"],
                               z[base + "/indptr"]), shape=shape, ctx=ctx)
    raise ValueError("entry %r: unknown storage type %r" % (base, stype))


def load(fname, ctx=None):
    """Load NDArrays saved by :func:`save` (from either package; a path
    or a file object) onto *ctx* (default: the current context)."""
    with _np.load(fname, allow_pickle=False) as z:
        groups = {}
        for k in z.files:
            if k == "__magic__":
                continue
            groups.setdefault(k.split("/")[0], []).append(k)

        def build(base):
            sub = groups[base]
            if len(sub) == 1 and "/" not in sub[0]:
                return array(z[base], ctx=ctx)
            if base + "/__stype__" in sub:
                return _sparse_entry(z, base, ctx)
            dt = str(z[base + "/__dtype__"])
            if dt != "bfloat16":
                raise ValueError("entry %r: unknown dtype tag %r"
                                 % (base, dt))
            shape = tuple(int(s) for s in z[base + "/shape"])
            bits = torch.from_numpy(
                _np.ascontiguousarray(z[base + "/bits"]).view(_np.int16))
            return array(bits.view(torch.bfloat16).reshape(shape), ctx=ctx)

        if groups and all(b.startswith("idx:") for b in groups):
            out = [None] * len(groups)
            for base in groups:
                out[int(base[4:])] = build(base)
            return out
        return {(base[4:] if base.startswith("key:") else base): build(base)
                for base in groups}
