"""nd.image — the device-side image ops (port of
``mxnet_tpu/ndarray/image.py``; reference: mx.nd.image over
src/operator/image/)."""

from ..ops import registry as _reg
from .register import _make_fn

for _name in _reg.list_ops():
    if _name.startswith("_image_"):
        globals()[_name[len("_image_"):]] = _make_fn(_reg.get_op(_name))
del _name, _reg, _make_fn
