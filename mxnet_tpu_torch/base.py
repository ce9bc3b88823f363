"""Shared base utilities (port of ``mxnet_tpu/base.py``, subset).

The dtype tables map the framework's dtype names onto numpy dtypes (the
file formats speak numpy) and onto ``torch.dtype`` (the tensors).
``bfloat16`` has no numpy dtype of its own; ``np_dtype`` reaches for
``ml_dtypes`` only when a caller asks for it by name.

The reference runs JAX without x64, so a 64-bit dtype that a user names
narrows where it enters (int64 -> int32, uint64 -> uint32, float64 ->
float32: :func:`narrow_dtype`), unless the caller opts in with
:func:`enable_x64`, the counterpart of ``jax.experimental.enable_x64``.
"""

from __future__ import annotations

import contextlib
import threading

import numpy as _np
import torch

__all__ = ["MXNetError", "np_dtype", "dtype_name", "torch_dtype",
           "narrow_dtype", "enable_x64"]


class MXNetError(RuntimeError):
    """Framework error type (mirrors ``mxnet_tpu.base.MXNetError``)."""


_NP_NAMES = ("float32", "float64", "float16", "uint8", "uint16", "uint32",
             "int8", "int16", "int32", "int64", "bool")

_TORCH = {
    "float32": torch.float32,
    "float64": torch.float64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "uint8": torch.uint8,
    # (torch.uint16 and torch.uint32 exist from PyTorch 2.3)
    "uint16": getattr(torch, "uint16", None),
    "uint32": getattr(torch, "uint32", None),
    "uint64": getattr(torch, "uint64", None),
    "int8": torch.int8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "bool": torch.bool,
}
_TORCH = {k: v for k, v in _TORCH.items() if v is not None}
_TORCH_NAMES = {v: k for k, v in _TORCH.items()}


def np_dtype(dtype):
    """Normalize a dtype-ish (str / numpy / torch dtype / None) to a numpy
    dtype; ``None`` means float32, as in the JAX package."""
    if dtype is None:
        return _np.dtype(_np.float32)
    if isinstance(dtype, torch.dtype):
        dtype = _TORCH_NAMES[dtype]
    if isinstance(dtype, str) and dtype == "bfloat16":
        import ml_dtypes
        return _np.dtype(ml_dtypes.bfloat16)
    return _np.dtype(dtype)


def dtype_name(dtype):
    """Canonical name ('float32', 'bfloat16', ...) of a dtype-ish."""
    if isinstance(dtype, torch.dtype):
        return _TORCH_NAMES[dtype]
    if isinstance(dtype, str) and dtype == "bfloat16":
        return dtype
    dt = _np.dtype(dtype) if dtype is not None else _np.dtype("float32")
    return "bfloat16" if dt.name == "bfloat16" else dt.name


def torch_dtype(dtype):
    """The ``torch.dtype`` for a dtype-ish (None means float32)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return _TORCH[dtype_name(dtype)]


# the 64-bit dtype names and what they narrow to outside enable_x64()
_WIDE = {"float64": "float32", "int64": "int32", "uint64": "uint32"}
_x64_lock = threading.Lock()
_x64_depth = 0


@contextlib.contextmanager
def enable_x64():
    """A scope in which user dtypes keep 64 bits (process-wide, nestable):
    the port's counterpart of ``jax.experimental.enable_x64``.  Outside it,
    :func:`narrow_dtype` narrows them as the reference does."""
    global _x64_depth
    with _x64_lock:
        _x64_depth += 1
    try:
        yield
    finally:
        with _x64_lock:
            _x64_depth -= 1


def narrow_dtype(dtype):
    """The canonical name of a user-given dtype as the port stores it: a
    64-bit name narrows to 32 bits unless :func:`enable_x64` is open."""
    name = dtype_name(dtype)
    if _x64_depth > 0:
        return name
    return _WIDE.get(name, name)
