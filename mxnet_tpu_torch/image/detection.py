"""Detection-aware image augmenters and ImageDetIter (port of
``mxnet_tpu/image/detection.py``).

Reference capability: ``python/mxnet/image/detection.py`` and
``src/io/image_det_aug_default.cc``: geometric augmentations keep the box
labels consistent with the pixels.

Label format: per image a flat float vector, either ``[header_width,
object_width, extra..., obj0..., obj1...]`` or ``[id, x1, y1, x2, y2] *
N``; each object ``[class_id, xmin, ymin, xmax, ymax]`` with coordinates
normalized to [0, 1]; batches pad objects with class_id -1 rows.

Two routes, chosen by the current context when the iterator is made, as
``ImageRecordIter`` chooses.  On the CPU, images decode with cv2 and every
augmenter works on host numpy arrays, as in the JAX package.  On a CUDA
device, JPEG records decode onto the card with nvJPEG
(``io/native_decode.py``, ``csrc/nvjpeg_decode.cu``: the card's machine
has no libjpeg) and the augmenters work on the decoded (h, w, 3) uint8
tensors there: the crop and pad windows, the mirror and every random draw
are decided on the host exactly as on the CPU route, from the image's size
and Python's ``random``, so the labels are the CPU route's and each box
stays on the pixels it covered; only the resampling differs (torch's
bicubic against cv2's).
"""

from __future__ import annotations

import random as pyrandom

import numpy as _np
import torch
import torch.nn.functional as F

from .image import (Augmenter, ImageIter, fixed_crop, imresize, imdecode,
                    CastAug, ColorNormalizeAug)
from ..base import MXNetError
from ..context import current_context
from ..io.io import DataBatch, DataDesc
from ..ndarray import NDArray
from ..ndarray.ndarray import _from_numpy

__all__ = ["DetAugmenter", "DetBorrowAug", "DetRandomSelectAug",
           "DetHorizontalFlipAug", "DetRandomCropAug", "DetRandomPadAug",
           "CreateDetAugmenter", "ImageDetIter"]

# cv2's interpolation ids -> F.interpolate modes (4, Lanczos, as bicubic)
_TORCH_INTERP = {0: "nearest", 1: "bilinear", 2: "bicubic", 3: "area",
                 4: "bicubic"}


def _resize(src, w, h, interp=2):
    """imresize for a host array or an (h, w, c) tensor on its device."""
    if not isinstance(src, torch.Tensor):
        return imresize(src, w, h, interp)
    mode = _TORCH_INTERP.get(interp, "bilinear")
    x = src.permute(2, 0, 1)[None].to(torch.float32)
    kw = {} if mode in ("nearest", "area") else {"align_corners": False}
    out = F.interpolate(x, size=(int(h), int(w)), mode=mode, **kw)[0]
    out = out.permute(1, 2, 0)
    if src.dtype == torch.uint8:
        out = out.round_().clamp_(0, 255)
    return out.to(src.dtype)


def _borrowed(aug, src):
    """A plain augmenter on a device image: the normalization and the
    cast (the ones CreateDetAugmenter's defaults add) run as torch ops;
    the colour jitters are the host route's only."""
    if isinstance(aug, ColorNormalizeAug):
        out = src.to(torch.float32)
        if aug.mean is not None:
            out = out - torch.from_numpy(aug.mean).to(out.device)
        if aug.std is not None:
            out = out / torch.from_numpy(aug.std).to(out.device)
        return out
    if isinstance(aug, CastAug):
        return src.to(getattr(torch, aug.typ))
    raise MXNetError("%s runs on host images only; make the iterator on "
                     "the CPU (with mx.cpu():) to use it"
                     % type(aug).__name__)


class DetAugmenter:
    """Detection augmenter: ``__call__(src, label) -> (src, label)``."""

    def __call__(self, src, label):
        raise NotImplementedError


class DetBorrowAug(DetAugmenter):
    """A plain image Augmenter that does not move pixels (colour jitter,
    normalize, cast)."""

    def __init__(self, augmenter):
        assert isinstance(augmenter, Augmenter)
        self.augmenter = augmenter

    def __call__(self, src, label):
        if isinstance(src, torch.Tensor):
            return _borrowed(self.augmenter, src), label
        return self.augmenter(src), label


class DetRandomSelectAug(DetAugmenter):
    """One of the augmenters at random, or none with *skip_prob*."""

    def __init__(self, aug_list, skip_prob=0.0):
        self.aug_list = list(aug_list)
        self.skip_prob = skip_prob

    def __call__(self, src, label):
        if pyrandom.random() < self.skip_prob or not self.aug_list:
            return src, label
        return pyrandom.choice(self.aug_list)(src, label)


class DetHorizontalFlipAug(DetAugmenter):
    """Flip the image and mirror the boxes' x coordinates."""

    def __init__(self, p=0.5):
        self.p = p

    def __call__(self, src, label):
        if pyrandom.random() < self.p:
            src = src.flip(1) if isinstance(src, torch.Tensor) \
                else src[:, ::-1]
            label = label.copy()
            valid = label[:, 0] >= 0
            x1 = label[valid, 1].copy()
            x2 = label[valid, 3].copy()
            label[valid, 1] = 1.0 - x2
            label[valid, 3] = 1.0 - x1
        return src, label


def _box_iob(boxes, crop):
    """Intersection over box area of each box with the crop window."""
    x1 = _np.maximum(boxes[:, 0], crop[0])
    y1 = _np.maximum(boxes[:, 1], crop[1])
    x2 = _np.minimum(boxes[:, 2], crop[2])
    y2 = _np.minimum(boxes[:, 3], crop[3])
    inter = _np.maximum(x2 - x1, 0) * _np.maximum(y2 - y1, 0)
    area = _np.maximum((boxes[:, 2] - boxes[:, 0]) *
                       (boxes[:, 3] - boxes[:, 1]), 1e-12)
    return inter / area


class DetRandomCropAug(DetAugmenter):
    """A random crop that covers at least *min_object_covered* of some
    object (intersection over the object's area); objects left with less
    than *min_eject_coverage* are dropped, the rest clipped and
    renormalized."""

    def __init__(self, min_object_covered=0.1,
                 aspect_ratio_range=(0.75, 1.33),
                 area_range=(0.05, 1.0), min_eject_coverage=0.3,
                 max_attempts=50):
        self.min_object_covered = min_object_covered
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.min_eject_coverage = min_eject_coverage
        self.max_attempts = max_attempts

    def _sample_crop(self, label):
        for _ in range(self.max_attempts):
            area = pyrandom.uniform(*self.area_range)
            ratio = pyrandom.uniform(*self.aspect_ratio_range)
            w = min((area * ratio) ** 0.5, 1.0)
            h = min((area / ratio) ** 0.5, 1.0)
            x0 = pyrandom.uniform(0, 1 - w)
            y0 = pyrandom.uniform(0, 1 - h)
            crop = (x0, y0, x0 + w, y0 + h)
            valid = label[:, 0] >= 0
            if not valid.any():
                return crop
            cov = _box_iob(label[valid, 1:5], crop)
            if cov.max() >= self.min_object_covered:
                return crop
        return None

    def __call__(self, src, label):
        crop = self._sample_crop(label)
        if crop is None:
            return src, label
        h, w = src.shape[0], src.shape[1]
        x0, y0, x1, y1 = crop
        xi, yi = int(x0 * w), int(y0 * h)
        wi = max(int((x1 - x0) * w), 1)
        hi = max(int((y1 - y0) * h), 1)
        src = fixed_crop(src, xi, yi, wi, hi)
        out = label.copy()
        valid = out[:, 0] >= 0
        boxes = out[valid, 1:5]
        cov = _box_iob(boxes, crop)
        cw = x1 - x0
        ch = y1 - y0
        nb = _np.empty_like(boxes)
        nb[:, 0] = _np.clip((boxes[:, 0] - x0) / cw, 0, 1)
        nb[:, 1] = _np.clip((boxes[:, 1] - y0) / ch, 0, 1)
        nb[:, 2] = _np.clip((boxes[:, 2] - x0) / cw, 0, 1)
        nb[:, 3] = _np.clip((boxes[:, 3] - y0) / ch, 0, 1)
        keep = cov >= self.min_eject_coverage
        ids = _np.where(valid)[0]
        out[ids, 1:5] = nb
        out[ids[~keep], 0] = -1          # ejected objects become padding
        return src, out


class DetRandomPadAug(DetAugmenter):
    """Place the image on a larger canvas of *pad_val* (zoom out) and
    rescale the boxes."""

    def __init__(self, aspect_ratio_range=(0.75, 1.33),
                 area_range=(1.0, 3.0), max_attempts=50,
                 pad_val=(127, 127, 127)):
        self.area_range = area_range
        self.aspect_ratio_range = aspect_ratio_range
        self.pad_val = pad_val

    def __call__(self, src, label):
        h, w = src.shape[0], src.shape[1]
        area = pyrandom.uniform(*self.area_range)
        if area <= 1.0:
            return src, label
        ratio = pyrandom.uniform(*self.aspect_ratio_range)
        nw = int(w * (area * ratio) ** 0.5)
        nh = int(h * (area / ratio) ** 0.5)
        nw, nh = max(nw, w), max(nh, h)
        x0 = pyrandom.randint(0, nw - w)
        y0 = pyrandom.randint(0, nh - h)
        if isinstance(src, torch.Tensor):
            canvas = torch.empty((nh, nw, src.shape[2]), dtype=src.dtype,
                                 device=src.device)
            canvas[:] = torch.as_tensor(
                _np.asarray(self.pad_val), dtype=src.dtype).to(src.device)
        else:
            canvas = _np.empty((nh, nw, src.shape[2]), src.dtype)
            canvas[:] = _np.asarray(self.pad_val, src.dtype)
        canvas[y0:y0 + h, x0:x0 + w] = src
        out = label.copy()
        valid = out[:, 0] >= 0
        out[valid, 1] = (out[valid, 1] * w + x0) / nw
        out[valid, 3] = (out[valid, 3] * w + x0) / nw
        out[valid, 2] = (out[valid, 2] * h + y0) / nh
        out[valid, 4] = (out[valid, 4] * h + y0) / nh
        return canvas, out


class _DetResizeAug(DetAugmenter):
    """Force resize (boxes are normalized, so labels are unchanged)."""

    def __init__(self, size, interp=2):
        self.size = size
        self.interp = interp

    def __call__(self, src, label):
        return _resize(src, self.size[0], self.size[1], self.interp), label


def CreateDetAugmenter(data_shape, resize=0, rand_crop=0, rand_pad=0,
                       rand_mirror=False, mean=None, std=None,
                       brightness=0, contrast=0, saturation=0,
                       pca_noise=0, hue=0, inter_method=2,
                       min_object_covered=0.1,
                       aspect_ratio_range=(0.75, 1.33),
                       area_range=(0.05, 3.0), min_eject_coverage=0.3,
                       max_attempts=50, pad_val=(127, 127, 127)):
    """The standard detection augmenter list: random crop (probability
    *rand_crop*), random pad (*rand_pad*), resize to *data_shape*, mirror,
    colour jitter, PCA noise, normalization (``True`` takes the ImageNet
    constants) and a float32 cast."""
    from .image import (BrightnessJitterAug, ContrastJitterAug,
                        SaturationJitterAug, HueJitterAug, LightingAug)
    auglist = []
    if rand_crop > 0:
        crop = DetRandomCropAug(min_object_covered, aspect_ratio_range,
                                (area_range[0], min(area_range[1], 1.0)),
                                min_eject_coverage, max_attempts)
        auglist.append(DetRandomSelectAug([crop], 1 - rand_crop))
    if rand_pad > 0:
        pad = DetRandomPadAug(aspect_ratio_range,
                              (max(area_range[0], 1.0), area_range[1]),
                              max_attempts, pad_val)
        auglist.append(DetRandomSelectAug([pad], 1 - rand_pad))
    auglist.append(_DetResizeAug((data_shape[2], data_shape[1]),
                                 inter_method))
    if rand_mirror:
        auglist.append(DetHorizontalFlipAug(0.5))
    if brightness:
        auglist.append(DetBorrowAug(BrightnessJitterAug(brightness)))
    if contrast:
        auglist.append(DetBorrowAug(ContrastJitterAug(contrast)))
    if saturation:
        auglist.append(DetBorrowAug(SaturationJitterAug(saturation)))
    if hue:
        auglist.append(DetBorrowAug(HueJitterAug(hue)))
    if pca_noise > 0:
        eigval = _np.array([55.46, 4.794, 1.148])
        eigvec = _np.array([[-0.5675, 0.7192, 0.4009],
                            [-0.5808, -0.0045, -0.8140],
                            [-0.5836, -0.6948, 0.4203]])
        auglist.append(DetBorrowAug(LightingAug(pca_noise, eigval,
                                                eigvec)))
    if mean is True:
        mean = _np.array([123.68, 116.28, 103.53])
    if std is True:
        std = _np.array([58.395, 57.12, 57.375])
    if mean is not None or std is not None:
        auglist.append(DetBorrowAug(ColorNormalizeAug(mean, std)))
    auglist.append(DetBorrowAug(CastAug()))
    return auglist


class ImageDetIter(ImageIter):
    """ImageIter over detection labels with the detection augmenters.
    Batches hold data (B, C, H, W) and labels (B, max objects, 5), padded
    with -1 rows; they lie on the host on the CPU route and on the card on
    the nvJPEG route (see the module docstring).  ``routes`` counts the
    batches of each: ``native`` (nvJPEG) and ``chain`` (cv2)."""

    def __init__(self, batch_size, data_shape, path_imgrec=None,
                 path_imglist=None, path_root="", shuffle=False,
                 aug_list=None, imglist=None, data_name="data",
                 label_name="label", label_shape=None, **kwargs):
        if aug_list is None:
            aug_list = CreateDetAugmenter(data_shape)
        self.device = current_context().torch_device
        super().__init__(batch_size, data_shape, label_width=-1,
                         path_imgrec=path_imgrec,
                         path_imglist=path_imglist, path_root=path_root,
                         shuffle=shuffle, aug_list=[], imglist=imglist,
                         data_name=data_name, label_name=label_name,
                         **kwargs)
        self.det_aug_list = aug_list
        self._decoder = None
        if self.device.type == "cuda":
            from ..io.native_decode import NvjpegDecodePool
            self._decoder = NvjpegDecodePool(self._n_threads, (8, 8),
                                             device=self.device)
        if label_shape is not None:
            self._max_objects = int(label_shape[0])
        elif self._list is not None:
            self._max_objects = max(
                (self._parse_label(lab).shape[0]
                 for _, lab in self._list), default=1)
        else:
            self._max_objects = self._scan_max_objects()

    @staticmethod
    def _parse_label(raw):
        """Raw flat vector -> (n_obj, 5) [id, x1, y1, x2, y2].  The header
        form needs an integral header width >= 2 and object width >= 5
        that tile the rest exactly; a size divisible by 5 is the flat
        form (2 + 5n never is)."""
        raw = _np.asarray(raw, _np.float32).ravel()
        if raw.size % 5 == 0 and raw.size > 0:
            return raw.reshape(-1, 5).astype(_np.float32)
        if raw.size >= 2:
            header, obj_w = float(raw[0]), float(raw[1])
            if (header.is_integer() and obj_w.is_integer() and
                    header >= 2 and obj_w >= 5 and raw.size > header and
                    (raw.size - int(header)) % int(obj_w) == 0):
                body = raw[int(header):]
                n = body.size // int(obj_w)
                return body[:n * int(obj_w)].reshape(n, int(obj_w))[:, :5] \
                    .astype(_np.float32)
        raise MXNetError(
            "label length %d is not a multiple of 5 and has no valid "
            "header" % raw.size)

    def _scan_max_objects(self):
        self.reset()
        mx_obj = 1
        while True:
            raw = self._read_raw()
            if raw is None:
                break
            mx_obj = max(mx_obj, self._parse_label(raw[0]).shape[0])
        self.reset()
        return mx_obj

    @property
    def provide_label(self):
        return [DataDesc(self.label_name,
                         (self.batch_size, self._max_objects, 5))]

    def _decode_all(self, raws):
        """The batch's images: host arrays (cv2) on the CPU route, (h, w,
        3) uint8 tensors on the card on the nvJPEG route (an image that is
        not a JPEG decodes on the host and is copied there)."""
        bufs = [buf for _, buf in raws]
        if self._decoder is None:
            return [imdecode(b) if isinstance(b, (bytes, bytearray)) else b
                    for b in bufs]
        jpeg = [isinstance(b, (bytes, bytearray)) and b[:2] == b"\xff\xd8"
                for b in bufs]
        out = [None] * len(bufs)
        idx = [i for i, j in enumerate(jpeg) if j]
        if idx:
            with torch.cuda.device(self.device):
                sel = [bytes(bufs[i]) for i in idx]
                hw, rcs = self._decoder.info(sel)
                if (rcs != 0).any():
                    raise MXNetError("nvjpegGetImageInfo failed on a record "
                                     "(nvjpegStatus %d)" % rcs[rcs != 0][0])
                for i, img in zip(idx, self._decoder.decode_full(sel, hw)):
                    out[i] = img
        for i, j in enumerate(jpeg):
            if not j:
                host = imdecode(bufs[i]) if isinstance(
                    bufs[i], (bytes, bytearray)) else bufs[i]
                out[i] = torch.from_numpy(_np.ascontiguousarray(host)).to(
                    self.device)
        return out

    def next(self):
        raws = []
        while len(raws) < self.batch_size:
            raw = self._read_raw()
            if raw is None:
                break
            raws.append(raw)
        if not raws:
            raise StopIteration
        imgs = self._decode_all(raws)
        on_card = self._decoder is not None
        c, h, w = self.data_shape
        if on_card:
            data = torch.zeros((self.batch_size, c, h, w),
                               dtype=torch.float32, device=self.device)
        else:
            data = _np.zeros((self.batch_size, c, h, w), _np.float32)
        labels = _np.full((self.batch_size, self._max_objects, 5), -1.0,
                          _np.float32)
        for n, ((lab, _), img) in enumerate(zip(raws, imgs)):
            objs = self._parse_label(lab)
            padded = _np.full((self._max_objects, 5), -1.0, _np.float32)
            padded[:objs.shape[0]] = objs[:self._max_objects]
            for aug in self.det_aug_list:
                img, padded = aug(img, padded)
            if on_card:
                arr = img.to(torch.float32)
                if tuple(arr.shape[:2]) != (h, w):
                    arr = _resize(arr, w, h, 1)
                data[n] = arr.permute(2, 0, 1)
            else:
                arr = _np.asarray(img, _np.float32)
                if arr.shape[:2] != (h, w):
                    arr = _np.asarray(imresize(arr, w, h), _np.float32)
                data[n] = arr.transpose(2, 0, 1)
            labels[n] = padded
        pad = self.batch_size - len(raws)
        if on_card:
            self.routes["native"] += 1
            return DataBatch(
                data=[NDArray(data)],
                label=[NDArray(_from_numpy(labels).to(self.device))],
                pad=pad, provide_data=self.provide_data,
                provide_label=self.provide_label)
        self.routes["chain"] += 1
        return DataBatch(data=[NDArray(_from_numpy(data))],
                         label=[NDArray(_from_numpy(labels))], pad=pad,
                         provide_data=self.provide_data,
                         provide_label=self.provide_label)
