"""Vision model zoo with a name registry (port of
``mxnet_tpu/gluon/model_zoo/vision/``, subset: the ResNets).

``get_model(name, **kwargs)`` builds a model by its zoo name.  No hosted
weight store exists, so ``pretrained=True`` raises; carry weights over
with ``gluon.load_jax_params``.
"""

from . import resnet as _m_resnet
from .resnet import *  # noqa: F401,F403

_factories = {n: getattr(_m_resnet, n) for n in _m_resnet.__all__
              if n[0].islower() and n != "get_resnet"}


def get_model(name, pretrained=False, root=None, **kwargs):
    """The zoo model called *name* ('resnet50_v1', ...), built with
    *kwargs*."""
    name = name.lower().replace("-", "_")
    if name not in _factories:
        raise ValueError("Model %r not found. Available: %s"
                         % (name, ", ".join(sorted(_factories))))
    if pretrained:
        raise ValueError("no pretrained weights are stored; build the "
                         "model and load its weights with "
                         "gluon.load_jax_params")
    return _factories[name](**kwargs)


__all__ = list(_m_resnet.__all__) + ["get_model"]
