"""mxnet_tpu_torch — the PyTorch and CUDA port of ``mxnet_tpu``.

The same user surface, op names, parameter names, symbol JSON and
checkpoint files as the JAX package, running on PyTorch; the JAX
package's Pallas kernels become hand-written CUDA kernels for Hopper
(``csrc/``).  Entry points run on the CUDA device (``mx.gpu(0)``) unless
the caller passes ``ctx=mx.cpu()``.

This package imports neither ``jax`` nor ``mxnet_tpu``.
"""

__version__ = "0.1.0"

from .base import MXNetError, enable_x64  # noqa: F401
from .context import Context, cpu, gpu, tpu, current_context  # noqa: F401
from . import autograd  # noqa: F401
from . import ndarray  # noqa: F401
from . import ndarray as nd  # noqa: F401
from .ndarray import waitall  # noqa: F401
from . import random  # noqa: F401
from . import symbol  # noqa: F401
from . import symbol as sym  # noqa: F401
from . import initializer  # noqa: F401
from . import initializer as init  # noqa: F401
from . import optimizer  # noqa: F401
from . import lr_scheduler  # noqa: F401
from . import gluon  # noqa: F401
from . import rnn  # noqa: F401
from . import model  # noqa: F401
from . import io  # noqa: F401
from . import recordio  # noqa: F401
from . import image  # noqa: F401
from . import metric  # noqa: F401
from . import callback  # noqa: F401
from . import module  # noqa: F401
from . import module as mod  # noqa: F401
from .module import Module  # noqa: F401
from . import name  # noqa: F401
from . import attribute  # noqa: F401
from .symbol import AttrScope  # noqa: F401
from . import serve  # noqa: F401
from . import parallel  # noqa: F401
from . import contrib  # noqa: F401
from . import quantize  # noqa: F401
from . import autotune  # noqa: F401
from . import operator  # noqa: F401
from . import subgraph  # noqa: F401
