"""nd — the imperative NDArray API (port of ``mxnet_tpu/ndarray/``)."""

import types as _types

from .. import ops as _ops  # noqa: F401  (registers the ops)
from .ndarray import NDArray, array, zeros, imperative_invoke  # noqa: F401
from .utils import save, load  # noqa: F401
from . import register as _register

# generated op functions (nd.FullyConnected, nd.Reshape, ...)
_register.populate(globals())

contrib = _types.ModuleType(__name__ + ".contrib",
                            "contrib ops (nd.contrib.DotProductAttention)")
_register.populate_contrib(contrib.__dict__)
