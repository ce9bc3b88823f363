"""Optimizer update ops (port of ``mxnet_tpu/ops/optimizer_ops.py``,
subset: sgd_update, sgd_mom_update).

The JAX package runs each update as one XLA computation with the weight
and state buffers donated, so the update reuses their memory.  Here the
update is in place: the ops write the new weight (and momentum) into the
tensors they are given and return those same tensors.  They run under
``torch.no_grad()``, so a weight that is a leaf of the tape can be
updated.  These were XLA code on the TPU, not Pallas kernels, so they
stay plain PyTorch.
"""

from __future__ import annotations

import torch

from .registry import register_op


def _rescale_clip(grad, rescale_grad, clip_gradient, wd=None, weight=None):
    """The gradient the update applies, in the reference's order: rescale,
    then clip (when clip_gradient >= 0), then add weight decay."""
    grad = grad * rescale_grad
    if clip_gradient is not None and clip_gradient >= 0:
        grad = torch.clamp(grad, -clip_gradient, clip_gradient)
    if wd is not None and weight is not None:
        grad = grad + wd * weight
    return grad


@register_op("sgd_update")
def _sgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
                clip_gradient=-1.0, lazy_update=True):
    """weight -= lr * g, in place."""
    with torch.no_grad():
        g = _rescale_clip(grad, rescale_grad, clip_gradient, wd, weight)
        weight.sub_(lr * g)
    return weight


@register_op("sgd_mom_update", num_outputs=2)
def _sgd_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                    rescale_grad=1.0, clip_gradient=-1.0, lazy_update=True):
    """mom = momentum * mom - lr * g; weight += mom; both in place."""
    with torch.no_grad():
        g = _rescale_clip(grad, rescale_grad, clip_gradient, wd, weight)
        mom.mul_(momentum).sub_(lr * g)
        weight.add_(mom)
    return weight, mom
