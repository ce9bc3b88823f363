"""Optimizers (port of ``mxnet_tpu/optimizer/``: the 16 optimizers,
multi-precision, ``Updater``; ``tree_opt``, the fused step's tree
update)."""

from .optimizer import (Optimizer, SGD, Signum, SignSGD, FTML,  # noqa: F401
                        LBSGD, DCASGD, NAG, SGLD, Adam, AdaGrad, RMSProp,
                        AdaDelta, Ftrl, Adamax, Nadam, Test, Updater,
                        create, register, get_updater,
                        states_mismatch)
from . import tree_opt  # noqa: F401
