"""sym.image — the symbolic image ops (port of
``mxnet_tpu/symbol/image.py``; reference: mx.sym.image over
src/operator/image/)."""

from ..ops import registry as _reg
from .register import _make_fn

for _name in _reg.list_ops():
    if _name.startswith("_image_"):
        globals()[_name[len("_image_"):]] = _make_fn(_reg.get_op(_name))
del _name, _reg, _make_fn
