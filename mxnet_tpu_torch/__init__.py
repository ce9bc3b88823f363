"""mxnet_tpu_torch — the PyTorch and CUDA port of ``mxnet_tpu``.

The same user surface, op names, parameter names, symbol JSON and
checkpoint files as the JAX package, running on PyTorch; the JAX
package's Pallas kernels become hand-written CUDA kernels for Hopper
(``csrc/``).  Entry points run on the CUDA device (``mx.gpu(0)``) unless
the caller passes ``ctx=mx.cpu()``.

This package imports neither ``jax`` nor ``mxnet_tpu``.
"""

__version__ = "0.1.0"

from .base import MXNetError  # noqa: F401
from .context import Context, cpu, gpu, tpu, current_context  # noqa: F401
from . import autograd  # noqa: F401
from . import ndarray  # noqa: F401
from . import ndarray as nd  # noqa: F401
from . import symbol  # noqa: F401
from . import symbol as sym  # noqa: F401
from . import initializer  # noqa: F401
from . import initializer as init  # noqa: F401
from . import optimizer  # noqa: F401
from . import gluon  # noqa: F401
from . import model  # noqa: F401
from . import serve  # noqa: F401
