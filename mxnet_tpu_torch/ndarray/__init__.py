"""nd — the imperative NDArray API (port of ``mxnet_tpu/ndarray/``)."""

from .. import ops as _ops  # noqa: F401  (registers the ops)
from .ndarray import (NDArray, array, zeros, ones, full, empty,  # noqa: F401
                      arange, zeros_like, ones_like, concatenate, waitall,
                      imperative_invoke, moveaxis, transpose)
from .utils import save, load, save_bytes, load_bytes  # noqa: F401
from . import random  # noqa: F401
from . import register as _register

# generated op functions (nd.FullyConnected, nd.Reshape, ...)
_register.populate(globals())

from . import sparse  # noqa: F401,E402  (after the op functions exist)

from . import contrib  # noqa: F401,E402  (foreach, while_loop, cond, ...)
_register.populate_contrib(contrib.__dict__)
from . import image  # noqa: F401,E402
