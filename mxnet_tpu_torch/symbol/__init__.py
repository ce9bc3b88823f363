"""sym — the symbolic graph API (port of ``mxnet_tpu/symbol/``)."""

import types as _types

from .. import ops as _ops  # noqa: F401  (registers the ops)
from .symbol import (Symbol, var, Variable, Group, load,  # noqa: F401
                     load_json)
from . import register as _register

_register.populate(globals())

contrib = _types.ModuleType(__name__ + ".contrib",
                            "contrib ops (sym.contrib.DotProductAttention)")
_register.populate_contrib(contrib.__dict__)
