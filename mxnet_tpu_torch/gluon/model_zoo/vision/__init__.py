"""Vision model zoo with a name registry (port of
``mxnet_tpu/gluon/model_zoo/vision/``): AlexNet, DenseNet, Inception-v3,
MobileNet v1/v2, ResNet v1/v2, SqueezeNet and VGG.

``get_model(name, **kwargs)`` builds a model by its zoo name; with
``pretrained=True`` it loads ``<root>/<name>.params`` from the local
model directory (``model_store.get_model_file``: there is no download
path), as the JAX package does.
"""

from . import alexnet as _m_alexnet
from . import densenet as _m_densenet
from . import inception as _m_inception
from . import mobilenet as _m_mobilenet
from . import resnet as _m_resnet
from . import squeezenet as _m_squeezenet
from . import vgg as _m_vgg

_MODULES = (_m_alexnet, _m_densenet, _m_inception, _m_mobilenet, _m_resnet,
            _m_squeezenet, _m_vgg)

# every lower-case callable a model module exports, as in the JAX
# package (get_resnet and get_vgg among them)
_factories = {}
for _mod in _MODULES:
    for _name in _mod.__all__:
        _obj = getattr(_mod, _name)
        globals()[_name] = _obj
        if callable(_obj) and _name[0].islower():
            _factories[_name] = _obj


def get_model(name, pretrained=False, root=None, **kwargs):
    """The zoo model called *name* ('resnet50_v1', ...), built with
    *kwargs*.  ``pretrained=True`` loads ``<root>/<name>.params`` (root
    defaults to ``$MXNET_HOME/models``) onto the current context."""
    name = name.lower().replace("-", "_")
    if name not in _factories:
        raise ValueError("Model %r not found. Available: %s"
                         % (name, ", ".join(sorted(_factories))))
    net = _factories[name](**kwargs)
    if pretrained:
        from ..model_store import get_model_file
        net.load_parameters(get_model_file(name, root=root))
    return net


__all__ = [n for m in _MODULES for n in m.__all__] + ["get_model"]
