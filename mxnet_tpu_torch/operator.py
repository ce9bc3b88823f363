"""User Python operators (port of ``mxnet_tpu/operator.py``:
``CustomOp``, ``CustomOpProp``, ``register``).

The ``Custom`` op (``ops/nn.py``) runs the registered operator's
``forward`` and ``backward`` on port NDArrays on the op's device inside a
``torch.autograd.Function``, so a custom op composes with ``autograd``,
the executor and hybridized blocks.  The callbacks run with the tape
paused.  A user operator may read its arrays back to the host
(``asnumpy``), which a CUDA graph cannot capture: a Module whose graph
holds a ``Custom`` node takes the legacy step, never the fused one.
Shape inference on meta tensors asks the property's ``infer_shape`` and
``infer_type`` instead of running the operator.
"""

from __future__ import annotations

import numpy as _np
import torch

from .base import MXNetError, np_dtype, torch_dtype

__all__ = ["CustomOp", "CustomOpProp", "register", "get_prop"]

_REGISTRY = {}


class CustomOp:
    """Base class of user operators (reference: operator.py CustomOp)."""

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise NotImplementedError

    def assign(self, dst, req, src):
        """Write *src* into *dst* as the request says ('write', 'inplace',
        'add' or 'null')."""
        if req == "null":
            return
        if req in ("write", "inplace"):
            dst[:] = src
        elif req == "add":
            dst[:] = dst + src


class CustomOpProp:
    """An operator's arity, shapes and types (reference: operator.py
    CustomOpProp)."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad

    def list_arguments(self):
        return ["data"]

    def list_outputs(self):
        return ["output"]

    def list_auxiliary_states(self):
        return []

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]] * len(self.list_outputs()), []

    def infer_type(self, in_type):
        return (in_type, [in_type[0]] * len(self.list_outputs()),
                [in_type[0]] * len(self.list_auxiliary_states()))

    def need_top_grad(self):
        return self.need_top_grad_

    def create_operator(self, ctx, in_shapes, in_dtypes):
        return CustomOp()


def register(reg_name):
    """Class decorator registering a CustomOpProp subclass as *reg_name*."""
    def do_register(prop_cls):
        _REGISTRY[reg_name] = prop_cls
        return prop_cls
    return do_register


def get_prop(op_type):
    if op_type not in _REGISTRY:
        raise MXNetError(
            "custom op %r is not registered (use "
            "@mxnet_tpu_torch.operator.register(%r) on a CustomOpProp)"
            % (op_type, op_type))
    return _REGISTRY[op_type]


_INSTANCES = {}


def _signature(op_type, kwargs, inputs):
    """(property, operator instance, output shapes, output dtypes) for one
    call signature; the instance is made once per signature, as the
    reference's is."""
    shapes = tuple(tuple(x.shape) for x in inputs)
    dtypes = tuple(np_dtype(x.dtype) for x in inputs)
    key = (op_type, tuple(sorted((k, repr(v)) for k, v in kwargs.items())),
           shapes, dtypes)
    hit = _INSTANCES.get(key)
    if hit is None:
        prop = get_prop(op_type)(**kwargs)
        sh_in, sh_out, _ = prop.infer_shape([list(s) for s in shapes])
        ty_in, ty_out, _ = prop.infer_type(list(dtypes))
        inst = prop.create_operator(None, sh_in, ty_in)
        hit = (prop, inst, [tuple(int(d) for d in s) for s in sh_out],
               [torch_dtype(_np.dtype(t).name) for t in ty_out])
        _INSTANCES[key] = hit
    return hit


def _wrap(tensors):
    from .ndarray import NDArray
    return [NDArray(t.detach()) for t in tensors]


class _Custom(torch.autograd.Function):
    """Forward and backward through the user's operator on NDArrays."""

    @staticmethod
    def forward(ctx, sig, *ins):
        from . import autograd
        _, inst, sh_out, ty_out = sig
        dev = ins[0].device if ins else torch.device("cpu")
        in_nd = _wrap(ins)
        out_nd = _wrap([torch.zeros(s, dtype=t, device=dev)
                        for s, t in zip(sh_out, ty_out)])
        with autograd.pause():
            inst.forward(True, ["write"] * len(out_nd), in_nd, out_nd, [])
        outs = []
        for o in out_nd:
            t = o._data
            outs.append(t.clone() if any(t is x for x in ins) else t)
        ctx.sig = sig
        ctx.save_for_backward(*ins, *outs)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *cots):
        from . import autograd
        _, inst, sh_out, _ = ctx.sig
        saved = ctx.saved_tensors
        n_in = len(saved) - len(sh_out)
        ins, outs = saved[:n_in], saved[n_in:]
        cots = [c if c is not None else torch.zeros_like(o)
                for c, o in zip(cots, outs)]
        grad_nd = _wrap([torch.zeros_like(x) for x in ins])
        with autograd.pause():
            inst.backward(["write"] * n_in, _wrap(cots), _wrap(ins),
                          _wrap(outs), grad_nd, [])
        return (None,) + tuple(g._data.to(x.dtype)
                               for g, x in zip(grad_nd, ins))


def invoke_custom(inputs, op_type, **kwargs):
    """The registered ``Custom`` op's body: the outputs (a tuple)."""
    sig = _signature(op_type, kwargs, inputs)
    if any(x.is_meta for x in inputs):      # shape inference
        return tuple(torch.empty(s, dtype=t, device="meta")
                     for s, t in zip(sig[2], sig[3]))
    return _Custom.apply(sig, *inputs)
