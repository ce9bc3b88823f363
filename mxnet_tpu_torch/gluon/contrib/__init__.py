"""Gluon contrib (port of ``mxnet_tpu/gluon/contrib/``, subset)."""

from . import nn  # noqa: F401
