"""Module API (port of ``mxnet_tpu/module/``: BaseModule and Module)."""

from .base_module import BaseModule  # noqa: F401
from .module import Module  # noqa: F401
