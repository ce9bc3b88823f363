"""Contrib namespace (port of ``mxnet_tpu/contrib``, subset:
``quantization``, the MXNet 1.3 int8 ``quantize_model`` API)."""

from . import quantization  # noqa: F401

__all__ = ["quantization"]
