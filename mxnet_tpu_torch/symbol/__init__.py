"""sym — the symbolic graph API (port of ``mxnet_tpu/symbol/``)."""

from .. import ops as _ops  # noqa: F401  (registers the ops)
from .symbol import (Symbol, var, Variable, Group, load,  # noqa: F401
                     load_json, AttrScope)
from . import register as _register

_register.populate(globals())

zeros = globals()["_zeros"]
ones = globals()["_ones"]

from . import contrib  # noqa: E402  (foreach, while_loop, cond, ...)
_register.populate_contrib(contrib.__dict__)
from . import image  # noqa: F401,E402
