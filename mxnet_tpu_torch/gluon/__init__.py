"""Gluon — the high-level model API (port of ``mxnet_tpu/gluon/``, subset)."""

from .parameter import Parameter, ParameterDict, Constant  # noqa: F401
from .block import Block, HybridBlock, SymbolBlock  # noqa: F401
from . import nn  # noqa: F401
from . import loss  # noqa: F401
from . import rnn  # noqa: F401
from .trainer import Trainer  # noqa: F401
from . import contrib  # noqa: F401
from . import model_zoo  # noqa: F401
from . import data  # noqa: F401
from . import utils  # noqa: F401
from .utils import (split_data, split_and_load, clip_global_norm,  # noqa
                    load_jax_params)
