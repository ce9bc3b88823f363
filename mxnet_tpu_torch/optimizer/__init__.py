"""Optimizers (port of ``mxnet_tpu/optimizer/``, subset)."""

from .optimizer import (Optimizer, SGD, Updater, create, register,  # noqa: F401
                        get_updater)
