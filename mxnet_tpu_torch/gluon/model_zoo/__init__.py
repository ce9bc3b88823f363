"""Model zoo (port of ``mxnet_tpu/gluon/model_zoo/``)."""

from . import transformer  # noqa: F401
from . import lm  # noqa: F401
from . import vision  # noqa: F401
from . import model_store  # noqa: F401
