"""Vision transforms (port of
``mxnet_tpu/gluon/data/vision/transforms.py``; reference:
python/mxnet/gluon/data/vision/transforms.py — ToTensor, Normalize,
Resize, crops, flips, color jitter).

Resizes are bilinear with antialiasing on downscale, as
``jax.image.resize(..., "bilinear")`` is: ``F.interpolate(mode="bilinear",
antialias=True, align_corners=False)`` on float32, cast back to the
input's dtype (truncation for uint8).  Random draws come from numpy's
global stream, as in the reference."""

from __future__ import annotations

import numpy as _np
import torch
import torch.nn.functional as _F

from .... import ndarray as nd
from ....ndarray import NDArray
from ...nn.basic_layers import Sequential
from ...block import Block, HybridBlock

__all__ = ["Compose", "Cast", "ToTensor", "Normalize", "Resize",
           "CenterCrop", "RandomResizedCrop", "RandomFlipLeftRight",
           "RandomFlipTopBottom", "RandomBrightness", "RandomContrast",
           "RandomSaturation", "RandomLighting"]


class Compose(Sequential):
    """Chain transforms (reference: transforms.py Compose)."""

    def __init__(self, transforms):
        super().__init__()
        for t in transforms:
            self.add(t)


class Cast(HybridBlock):
    def __init__(self, dtype="float32"):
        super().__init__()
        self._dtype = dtype

    def hybrid_forward(self, F, x):
        return F.Cast(x, dtype=self._dtype)


class ToTensor(HybridBlock):
    """HWC uint8 [0,255] -> CHW float32 [0,1]
    (reference: to_tensor op, src/operator/image/image_random.cc)."""

    def hybrid_forward(self, F, x):
        x = F.Cast(x, dtype="float32")
        x = x / 255.0
        if hasattr(x, "ndim") and x.ndim == 4:
            return F.transpose(x, axes=(0, 3, 1, 2))
        return F.transpose(x, axes=(2, 0, 1))


class Normalize(Block):
    def __init__(self, mean=0.0, std=1.0):
        super().__init__()
        self._mean = _np.asarray(mean, _np.float32).reshape(-1, 1, 1)
        self._std = _np.asarray(std, _np.float32).reshape(-1, 1, 1)

    def forward(self, x):
        return (x - nd.array(self._mean, ctx=x.context)) / \
            nd.array(self._std, ctx=x.context)


def _resize_hwc(x, h, w):
    """HWC NDArray -> (h, w, C) by antialiased bilinear in float32, cast
    back to its dtype."""
    t = x._data.to(torch.float32).permute(2, 0, 1).unsqueeze(0)
    out = _F.interpolate(t, size=(h, w), mode="bilinear",
                         align_corners=False, antialias=True)
    return NDArray(out[0].permute(1, 2, 0).to(x._data.dtype).contiguous())


class Resize(Block):
    def __init__(self, size, keep_ratio=False, interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)

    def forward(self, x):
        return _resize_hwc(x, self._size[1], self._size[0])


class CenterCrop(Block):
    def __init__(self, size, interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)

    def forward(self, x):
        w, h = self._size
        H, W = x.shape[0], x.shape[1]
        y0 = max((H - h) // 2, 0)
        x0 = max((W - w) // 2, 0)
        return x[y0:y0 + h, x0:x0 + w]


class RandomResizedCrop(Block):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)
        self._scale = scale
        self._ratio = ratio

    def forward(self, x):
        H, W = x.shape[0], x.shape[1]
        area = H * W
        for _ in range(10):
            target_area = _np.random.uniform(*self._scale) * area
            log_ratio = (_np.log(self._ratio[0]), _np.log(self._ratio[1]))
            aspect = _np.exp(_np.random.uniform(*log_ratio))
            w = int(round(_np.sqrt(target_area * aspect)))
            h = int(round(_np.sqrt(target_area / aspect)))
            if w <= W and h <= H:
                x0 = _np.random.randint(0, W - w + 1)
                y0 = _np.random.randint(0, H - h + 1)
                crop = x[y0:y0 + h, x0:x0 + w]
                return _resize_hwc(crop, self._size[1], self._size[0])
        return CenterCrop(self._size).forward(x)


class RandomFlipLeftRight(Block):
    def forward(self, x):
        if _np.random.rand() < 0.5:
            return x.flip(axis=1)
        return x


class RandomFlipTopBottom(Block):
    def forward(self, x):
        if _np.random.rand() < 0.5:
            return x.flip(axis=0)
        return x


class RandomBrightness(Block):
    def __init__(self, brightness):
        super().__init__()
        self._b = brightness

    def forward(self, x):
        alpha = 1.0 + _np.random.uniform(-self._b, self._b)
        return (x.astype("float32") * alpha).clip(0, 255).astype(
            str(x.dtype))


class RandomContrast(Block):
    def __init__(self, contrast):
        super().__init__()
        self._c = contrast

    def forward(self, x):
        alpha = 1.0 + _np.random.uniform(-self._c, self._c)
        xf = x.astype("float32")
        gray = xf.mean()
        return ((xf - gray) * alpha + gray).clip(0, 255).astype(
            str(x.dtype))


class RandomSaturation(Block):
    def __init__(self, saturation):
        super().__init__()
        self._s = saturation

    def forward(self, x):
        alpha = 1.0 + _np.random.uniform(-self._s, self._s)
        xf = x.astype("float32")
        coef = nd.array(_np.array([[[0.299, 0.587, 0.114]]], _np.float32),
                        ctx=x.context)
        gray = (xf * coef).sum(axis=2, keepdims=True)
        return (xf * alpha + gray * (1 - alpha)).clip(0, 255).astype(
            str(x.dtype))


class RandomLighting(Block):
    """AlexNet-style PCA noise (reference: transforms.py RandomLighting)."""

    _eigval = _np.array([55.46, 4.794, 1.148], _np.float32)
    _eigvec = _np.array([[-0.5675, 0.7192, 0.4009],
                         [-0.5808, -0.0045, -0.814],
                         [-0.5836, -0.6948, 0.4203]], _np.float32)

    def __init__(self, alpha):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        alpha = _np.random.normal(0, self._alpha, size=(3,)) \
            .astype(_np.float32)
        rgb = (self._eigvec * alpha * self._eigval).sum(axis=1)
        return (x.astype("float32") +
                nd.array(rgb.reshape(1, 1, 3), ctx=x.context)).clip(
                    0, 255).astype(
                    str(x.dtype))
