"""Model zoo (port of ``mxnet_tpu/gluon/model_zoo/``, subset)."""

from . import transformer  # noqa: F401
from . import lm  # noqa: F401
from . import vision  # noqa: F401
