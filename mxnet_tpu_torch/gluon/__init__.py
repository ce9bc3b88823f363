"""Gluon — the high-level model API (port of ``mxnet_tpu/gluon/``, subset)."""

from .parameter import Parameter, ParameterDict  # noqa: F401
from .block import Block, HybridBlock  # noqa: F401
from . import nn  # noqa: F401
from . import contrib  # noqa: F401
from . import model_zoo  # noqa: F401
from .utils import load_jax_params  # noqa: F401
