"""Operator implementations on ``torch.Tensor`` (importing registers them)."""

from . import registry  # noqa: F401
from . import elemwise  # noqa: F401
from . import tensor  # noqa: F401
from . import nn  # noqa: F401
from . import attention  # noqa: F401
from . import reduce  # noqa: F401
from . import optimizer_ops  # noqa: F401
