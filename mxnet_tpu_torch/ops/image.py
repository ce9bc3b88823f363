"""Device-side image ops (port of ``mxnet_tpu/ops/image.py``; reference
capability: src/operator/image/ — to_tensor, normalize, flip, color
jitter family).

The in-graph counterparts of mx.image's host augmenters, for pipelines
that ship uint8 batches to the device and convert there.  The random ops
draw from the op's ``torch.Generator`` (PyTorch's numbers, not the JAX
package's: tests hold them by structure and moments) without reading a
value back to the host, so they stay capturable in a CUDA graph.
"""

from __future__ import annotations

import torch

from .registry import register_op

_GRAY = (0.299, 0.587, 0.114)


@register_op("_image_to_tensor", aliases=("to_tensor",))
def _to_tensor(data):
    """HWC (or NHWC) uint8 [0,255] -> CHW (NCHW) float32 [0,1]."""
    x = data.to(torch.float32) / 255.0
    if x.dim() == 3:
        return x.permute(2, 0, 1)
    return x.permute(0, 3, 1, 2)


@register_op("_image_normalize", aliases=("image_normalize",))
def _normalize(data, mean=(0.0,), std=(1.0,)):
    """Channel-wise normalize CHW/NCHW float input."""
    mean = torch.as_tensor(mean, dtype=data.dtype, device=data.device)
    std = torch.as_tensor(std, dtype=data.dtype, device=data.device)
    shape = (-1, 1, 1) if data.dim() == 3 else (1, -1, 1, 1)
    return (data - mean.reshape(shape)) / std.reshape(shape)


@register_op("_image_flip_left_right", aliases=("flip_left_right",))
def _flip_lr(data):
    return torch.flip(data, dims=(-1,))


@register_op("_image_flip_top_bottom", aliases=("flip_top_bottom",))
def _flip_tb(data):
    return torch.flip(data, dims=(-2,))


def _uniform(rng, lo, hi):
    u = torch.rand((), generator=rng, device=rng.device, dtype=torch.float32)
    return lo + (hi - lo) * u


@register_op("_image_random_flip_left_right", needs_rng=True,
             aliases=("random_flip_left_right",))
def _random_flip_lr(rng, data, p=0.5):
    flip = _uniform(rng, 0.0, 1.0) < p
    return torch.where(flip, torch.flip(data, dims=(-1,)), data)


@register_op("_image_random_flip_top_bottom", needs_rng=True,
             aliases=("random_flip_top_bottom",))
def _random_flip_tb(rng, data, p=0.5):
    flip = _uniform(rng, 0.0, 1.0) < p
    return torch.where(flip, torch.flip(data, dims=(-2,)), data)


@register_op("_image_random_brightness", needs_rng=True,
             aliases=("random_brightness",))
def _random_brightness(rng, data, min_factor=0.5, max_factor=1.5):
    return data * _uniform(rng, min_factor, max_factor)


def _luma(data):
    """0.299 R + 0.587 G + 0.114 B over the channel axis (0 of CHW, 1 of
    NCHW), which is dropped."""
    coef = torch.tensor(_GRAY, dtype=data.dtype, device=data.device)
    axis = 0 if data.dim() == 3 else 1
    return torch.tensordot(coef, torch.movedim(data, axis, 0), dims=1)


@register_op("_image_random_contrast", needs_rng=True,
             aliases=("random_contrast",))
def _random_contrast(rng, data, min_factor=0.5, max_factor=1.5):
    alpha = _uniform(rng, min_factor, max_factor)
    gray = torch.mean(_luma(data))
    return data * alpha + gray * (1.0 - alpha)


@register_op("_image_random_saturation", needs_rng=True,
             aliases=("random_saturation",))
def _random_saturation(rng, data, min_factor=0.5, max_factor=1.5):
    alpha = _uniform(rng, min_factor, max_factor)
    axis = 0 if data.dim() == 3 else 1
    gray = torch.unsqueeze(_luma(data), axis)
    return data * alpha + gray * (1.0 - alpha)
