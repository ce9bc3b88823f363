"""Gluon contrib (port of ``mxnet_tpu/gluon/contrib/``, subset)."""

from . import nn  # noqa: F401
from . import rnn  # noqa: F401
