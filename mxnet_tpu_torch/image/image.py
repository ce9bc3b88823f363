"""Image decode + augmentation pipeline (port of
``mxnet_tpu/image/image.py``).

Reference capability: `python/mxnet/image/image.py` (imdecode/ImageIter/
augmenters) and `src/io/image_aug_default.cc` (the default augmenter
set).  The cv2 chain and the libjpeg team decode and augment on host
threads and hand over a host (CPU) NDArray, as every iterator of the
port does; the nvJPEG route (a CUDA device in the native pipeline spec)
decodes onto the card and hands over a device NDArray.
``ImageRecordIter`` places host batches on the caller's device from its
prefetch thread (pinned staging, a copy stream: ``io/io.py``).
``routes`` counts the batches each route decoded: ``native`` (the
libjpeg team on the CPU, nvJPEG and the team's geometry on a CUDA
device) and ``chain`` (cv2 and the augmenters).
"""

from __future__ import annotations

import os
import random as pyrandom

import numpy as _np
import torch

from ..base import MXNetError
from ..io.io import DataIter, DataBatch, DataDesc
from ..ndarray import NDArray
from ..ndarray.ndarray import _from_numpy

try:
    import cv2 as _cv2
except ImportError:  # pragma: no cover
    _cv2 = None

_INTERP = {0: 0, 1: 1, 2: 2, 3: 3, 4: 4}  # cv2 interp enums match ids


def _require_cv2():
    if _cv2 is None:
        raise MXNetError("OpenCV (cv2) is required for mx.image")


def _jpeg_dims(buf):
    """(height, width) from a JPEG SOF marker without decoding, or None.
    Lets the decoder pick a reduced-scale IDCT when the target size is
    much smaller than the stored image (the hot-path trick the
    reference gets from libjpeg scale_denom)."""
    if len(buf) < 4 or buf[0] != 0xFF or buf[1] != 0xD8:
        return None
    i = 2
    n = len(buf)
    while i + 9 < n:
        if buf[i] != 0xFF:
            i += 1
            continue
        marker = buf[i + 1]
        if marker == 0xFF:      # fill byte (B.1.1.2): resync on next FF
            i += 1
            continue
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            return (buf[i + 5] << 8 | buf[i + 6],
                    buf[i + 7] << 8 | buf[i + 8])
        if marker == 0xDA:      # SOS: entropy data follows; SOF is
            return None         # always before it, so give up
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            i += 2
            continue
        i += 2 + (buf[i + 2] << 8 | buf[i + 3])
    return None


def imdecode(buf, flag=1, to_rgb=True, approx_size=0):
    """Decode an encoded image buffer to an HWC uint8 numpy array
    (reference: image.py imdecode over src/io/image_io.cc).

    ``approx_size``: smallest output side the caller will resize to; a
    JPEG at >=2x that size decodes at reduced scale (libjpeg's
    scale_denom via IMREAD_REDUCED_COLOR_*), cutting decode cost up to
    ~4x while staying above the resample target's resolution."""
    _require_cv2()
    if not isinstance(buf, (bytes, bytearray)):
        buf = bytes(buf)
    dec_flag = int(flag)
    if approx_size and flag == 1:
        dims = _jpeg_dims(buf)
        if dims:
            ratio = min(dims) // max(int(approx_size), 1)
            # REDUCED_k divides each side by k; require the reduced
            # image to still be >= approx_size so the resample only
            # ever downscales
            if ratio >= 8:
                dec_flag = _cv2.IMREAD_REDUCED_COLOR_8
            elif ratio >= 4:
                dec_flag = _cv2.IMREAD_REDUCED_COLOR_4
            elif ratio >= 2:
                dec_flag = _cv2.IMREAD_REDUCED_COLOR_2
    arr = _np.frombuffer(buf, dtype=_np.uint8)
    img = _cv2.imdecode(arr, dec_flag)
    if img is None:
        raise MXNetError("imdecode failed (truncated or unsupported "
                         "image)")
    if to_rgb and img.ndim == 3:
        img = _cv2.cvtColor(img, _cv2.COLOR_BGR2RGB)
    if img.ndim == 2:
        img = img[:, :, None]
    return img


def imread(filename, flag=1, to_rgb=True):
    with open(filename, "rb") as f:
        return imdecode(f.read(), flag=flag, to_rgb=to_rgb)


def imresize(src, w, h, interp=1):
    _require_cv2()
    return _cv2.resize(src, (int(w), int(h)),
                       interpolation=_INTERP.get(interp, 1))


def scale_down(src_size, size):
    """Scale (w, h) down to fit within src_size keeping aspect."""
    w, h = size
    sw, sh = src_size
    if sh < h:
        w, h = float(w * sh) / h, sh
    if sw < w:
        w, h = sw, float(h * sw) / w
    return int(w), int(h)


def resize_short(src, size, interp=2):
    """Resize so the shorter edge equals *size* (the ImageNet eval
    transform)."""
    h, w = src.shape[:2]
    if h > w:
        new_w, new_h = size, int(size * h / w)
    else:
        new_w, new_h = int(size * w / h), size
    return imresize(src, new_w, new_h, interp)


def fixed_crop(src, x0, y0, w, h, size=None, interp=2):
    out = src[y0:y0 + h, x0:x0 + w]
    if size is not None and (w, h) != size:
        out = imresize(out, size[0], size[1], interp)
    return out


def center_crop(src, size, interp=2):
    h, w = src.shape[:2]
    new_w, new_h = scale_down((w, h), size)
    x0 = (w - new_w) // 2
    y0 = (h - new_h) // 2
    return fixed_crop(src, x0, y0, new_w, new_h, size, interp), \
        (x0, y0, new_w, new_h)


def random_crop(src, size, interp=2):
    h, w = src.shape[:2]
    new_w, new_h = scale_down((w, h), size)
    x0 = pyrandom.randint(0, w - new_w)
    y0 = pyrandom.randint(0, h - new_h)
    return fixed_crop(src, x0, y0, new_w, new_h, size, interp), \
        (x0, y0, new_w, new_h)


def random_size_crop(src, size, area, ratio, interp=2):
    """Random crop with area and aspect-ratio jitter (inception-style
    training crop; reference: image.py random_size_crop)."""
    h, w = src.shape[:2]
    src_area = h * w
    if isinstance(area, (int, float)):
        area = (area, 1.0)
    for _ in range(10):
        target_area = pyrandom.uniform(*area) * src_area
        log_ratio = (_np.log(ratio[0]), _np.log(ratio[1]))
        new_ratio = _np.exp(pyrandom.uniform(*log_ratio))
        new_w = int(round((target_area * new_ratio) ** 0.5))
        new_h = int(round((target_area / new_ratio) ** 0.5))
        if new_w <= w and new_h <= h:
            x0 = pyrandom.randint(0, w - new_w)
            y0 = pyrandom.randint(0, h - new_h)
            return fixed_crop(src, x0, y0, new_w, new_h, size, interp), \
                (x0, y0, new_w, new_h)
    return center_crop(src, size, interp)


def color_normalize(src, mean, std=None):
    src = src.astype(_np.float32) - mean
    if std is not None:
        src /= std
    return src


# --------------------------------------------------------------------------
# Augmenters (reference: image.py Augmenter classes +
# src/io/image_aug_default.cc defaults)
# --------------------------------------------------------------------------

class Augmenter:
    """Image augmenter base: callable numpy HWC -> numpy HWC."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        import json
        return json.dumps([type(self).__name__, self._kwargs])

    def __call__(self, src):
        raise NotImplementedError


class SequentialAug(Augmenter):
    def __init__(self, ts):
        super().__init__()
        self.ts = ts

    def __call__(self, src):
        for t in self.ts:
            src = t(src)
        return src


class ResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return resize_short(src, self.size, self.interp)


class ForceResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return imresize(src, self.size[0], self.size[1], self.interp)


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return random_crop(src, self.size, self.interp)[0]


class RandomSizedCropAug(Augmenter):
    def __init__(self, size, area, ratio, interp=2):
        super().__init__(size=size, area=area, ratio=ratio, interp=interp)
        self.size, self.area, self.ratio, self.interp = \
            size, area, ratio, interp

    def __call__(self, src):
        return random_size_crop(src, self.size, self.area, self.ratio,
                                self.interp)[0]


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return center_crop(src, self.size, self.interp)[0]


class HorizontalFlipAug(Augmenter):
    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if pyrandom.random() < self.p:
            return src[:, ::-1]
        return src


class BrightnessJitterAug(Augmenter):
    def __init__(self, brightness):
        super().__init__(brightness=brightness)
        self.brightness = brightness

    def __call__(self, src):
        alpha = 1.0 + pyrandom.uniform(-self.brightness, self.brightness)
        return src.astype(_np.float32) * alpha


class ContrastJitterAug(Augmenter):
    _coef = _np.array([[[0.299, 0.587, 0.114]]], _np.float32)

    def __init__(self, contrast):
        super().__init__(contrast=contrast)
        self.contrast = contrast

    def __call__(self, src):
        alpha = 1.0 + pyrandom.uniform(-self.contrast, self.contrast)
        src = src.astype(_np.float32)
        gray = (src * self._coef).sum() * (3.0 / src.size)
        return src * alpha + gray * (1.0 - alpha)


class SaturationJitterAug(Augmenter):
    _coef = _np.array([[[0.299, 0.587, 0.114]]], _np.float32)

    def __init__(self, saturation):
        super().__init__(saturation=saturation)
        self.saturation = saturation

    def __call__(self, src):
        alpha = 1.0 + pyrandom.uniform(-self.saturation, self.saturation)
        src = src.astype(_np.float32)
        gray = (src * self._coef).sum(axis=2, keepdims=True)
        return src * alpha + gray * (1.0 - alpha)


class HueJitterAug(Augmenter):
    """Hue rotation in YIQ space (reference: image.py HueJitterAug)."""

    _tyiq = _np.array([[0.299, 0.587, 0.114],
                       [0.596, -0.274, -0.321],
                       [0.211, -0.523, 0.311]], _np.float32)
    _ityiq = _np.array([[1.0, 0.956, 0.621],
                        [1.0, -0.272, -0.647],
                        [1.0, -1.107, 1.705]], _np.float32)

    def __init__(self, hue):
        super().__init__(hue=hue)
        self.hue = hue

    def __call__(self, src):
        alpha = pyrandom.uniform(-self.hue, self.hue)
        u = _np.cos(alpha * _np.pi)
        w = _np.sin(alpha * _np.pi)
        bt = _np.array([[1.0, 0.0, 0.0],
                        [0.0, u, -w],
                        [0.0, w, u]], _np.float32)
        t = _np.dot(_np.dot(self._ityiq, bt), self._tyiq).T
        return _np.dot(src.astype(_np.float32), t)


class ColorJitterAug(SequentialAug):
    """Brightness/contrast/saturation jitter in random order — the order
    is reshuffled per image (reference: RandomOrderAug)."""

    def __init__(self, brightness, contrast, saturation):
        ts = []
        if brightness > 0:
            ts.append(BrightnessJitterAug(brightness))
        if contrast > 0:
            ts.append(ContrastJitterAug(contrast))
        if saturation > 0:
            ts.append(SaturationJitterAug(saturation))
        super().__init__(ts)

    def __call__(self, src):
        order = list(self.ts)
        pyrandom.shuffle(order)
        for t in order:
            src = t(src)
        return src


class LightingAug(Augmenter):
    """PCA-noise lighting (AlexNet-style)."""

    def __init__(self, alphastd, eigval, eigvec):
        super().__init__(alphastd=alphastd)
        self.alphastd = alphastd
        self.eigval = _np.asarray(eigval, _np.float32)
        self.eigvec = _np.asarray(eigvec, _np.float32)

    def __call__(self, src):
        alpha = _np.random.normal(0, self.alphastd, size=(3,))
        rgb = _np.dot(self.eigvec * alpha, self.eigval)
        return src.astype(_np.float32) + rgb


class ColorNormalizeAug(Augmenter):
    def __init__(self, mean, std):
        super().__init__()
        self.mean = None if mean is None else _np.asarray(mean,
                                                          _np.float32)
        self.std = None if std is None else _np.asarray(std, _np.float32)

    def __call__(self, src):
        return color_normalize(src, 0.0 if self.mean is None
                               else self.mean, self.std)


class RandomGrayAug(Augmenter):
    _coef = _np.array([[0.299], [0.587], [0.114]], _np.float32)

    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if pyrandom.random() < self.p:
            src = _np.broadcast_to(
                _np.dot(src.astype(_np.float32), self._coef),
                src.shape).copy()
        return src


class CastAug(Augmenter):
    def __init__(self, typ="float32"):
        super().__init__(type=typ)
        self.typ = typ

    def __call__(self, src):
        return src.astype(self.typ)


def CreateAugmenter(data_shape, resize=0, rand_crop=False,
                    rand_resize=False, rand_mirror=False, mean=None,
                    std=None, brightness=0, contrast=0, saturation=0,
                    hue=0, pca_noise=0, rand_gray=0, inter_method=2):
    """Build the default augmenter list (reference: image.py
    CreateAugmenter / image_aug_default.cc defaults).  data_shape is CHW."""
    auglist = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    crop_size = (data_shape[2], data_shape[1])
    if rand_resize:
        assert rand_crop
        auglist.append(RandomSizedCropAug(crop_size, (0.08, 1.0),
                                          (3.0 / 4.0, 4.0 / 3.0),
                                          inter_method))
    elif rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    auglist.append(CastAug())
    if brightness or contrast or saturation:
        auglist.append(ColorJitterAug(brightness, contrast, saturation))
    if hue:
        auglist.append(HueJitterAug(hue))
    if pca_noise > 0:
        eigval = _np.array([55.46, 4.794, 1.148])
        eigvec = _np.array([[-0.5675, 0.7192, 0.4009],
                            [-0.5808, -0.0045, -0.8140],
                            [-0.5836, -0.6948, 0.4203]])
        auglist.append(LightingAug(pca_noise, eigval, eigvec))
    if rand_gray > 0:
        auglist.append(RandomGrayAug(rand_gray))
    if mean is True:
        mean = _np.array([123.68, 116.28, 103.53])
    if std is True:
        std = _np.array([58.395, 57.12, 57.375])
    if mean is not None or std is not None:
        auglist.append(ColorNormalizeAug(mean, std))
    return auglist


# --------------------------------------------------------------------------
# ImageIter — python-side record/list image iterator
# --------------------------------------------------------------------------

class ImageIter(DataIter):
    """Image iterator over .rec files or image lists with augmenters
    (reference: image.py ImageIter).  Decode + augment run on a thread
    pool (cv2 releases the GIL), the assembled NCHW batch is handed to
    the device in one copy."""

    def __init__(self, batch_size, data_shape, label_width=1,
                 path_imgrec=None, path_imglist=None, path_root="",
                 shuffle=False, aug_list=None, imglist=None,
                 data_name="data", label_name="softmax_label",
                 num_threads=None, **kwargs):
        super().__init__(batch_size)
        from ..recordio import MXIndexedRecordIO, MXRecordIO
        self.data_shape = tuple(data_shape)
        # reduced-decode hint: the first resize an augmenter applies (or
        # the output side) bounds how much resolution decode must keep.
        # Area-fraction crops (RandomSizedCropAug) sample a SUB-window
        # that is later upscaled to `size`, so they need the source kept
        # at size/sqrt(min_area) to preserve the reference's detail.
        import math
        sizes = [min(self.data_shape[1:])] if \
            len(self.data_shape) == 3 else []
        for a in (aug_list or []):
            s = getattr(a, "size", None)
            if s is None:
                continue
            side = min(int(v) for v in s) if isinstance(s, (tuple, list)) \
                else int(s)
            area = getattr(a, "area", None)
            if area is not None:
                min_area = area[0] if isinstance(area, (tuple, list)) \
                    else area
                side = int(math.ceil(side / math.sqrt(max(
                    float(min_area), 1e-6))))
            sizes.append(side)
        self._decode_hint = max(sizes) if sizes else 0
        self.label_width = label_width
        self.shuffle = shuffle
        self.data_name = data_name
        self.label_name = label_name
        self._rec = None
        self._list = None
        if path_imgrec:
            idx_path = kwargs.get("path_imgidx")
            if not idx_path:
                # auto-discover the .idx next to the .rec (the reference's
                # iterator requires it only for shuffle; so do we)
                guess = os.path.splitext(path_imgrec)[0] + ".idx"
                if os.path.exists(guess):
                    idx_path = guess
            if idx_path and os.path.exists(idx_path):
                self._rec = MXIndexedRecordIO(idx_path, path_imgrec, "r")
                self._keys = list(self._rec.keys)
            else:
                if shuffle:
                    raise MXNetError(
                        "shuffle=True needs an index file; pass "
                        "path_imgidx or write one with "
                        "recordio.MXIndexedRecordIO")
                self._rec = MXRecordIO(path_imgrec, "r")
                self._keys = None
        elif path_imglist or imglist is not None:
            entries = []
            if path_imglist:
                with open(path_imglist) as f:
                    for line in f:
                        parts = line.strip().split("\t")
                        label = _np.array(
                            [float(x) for x in parts[1:-1]], _np.float32)
                        entries.append((parts[-1], label))
            else:
                for item in imglist:
                    label = _np.asarray(item[0], _np.float32).reshape(-1)
                    entries.append((item[1], label))
            self._list = entries
        else:
            raise ValueError("need path_imgrec, path_imglist or imglist")
        self.path_root = path_root
        self.aug_list = aug_list if aug_list is not None else \
            CreateAugmenter(data_shape)
        self._n_threads = num_threads or min(8, os.cpu_count() or 1)
        self._pool = None
        # native fast path: decode+resize+crop+mirror in the C++
        # libjpeg team (io/native_decode.py).  Only engaged when the
        # caller passes the pipeline spec (ImageRecordIter does for
        # plain classification configs) AND the library is built.
        self._native_cfg = None
        self._native_pool = None
        # On a CUDA device (the pipeline spec's "device") the route is
        # nvJPEG onto the card (io/native_decode.py NvjpegDecodePool),
        # else the libjpeg team on the host.  Its library is built here;
        # a failed build raises (never a silent route to the chain).
        native_pipeline = kwargs.get("native_pipeline")
        self.native_route = None
        if native_pipeline is not None:
            self._native_cfg = dict(native_pipeline)
            dev = self._native_cfg.get("device")
            if dev is not None and dev.type == "cuda":
                self.native_route = "nvjpeg"
                self._ensure_native()
            else:
                from ..io.native_decode import available as _native_ok
                _native_ok()
                self.native_route = "libjpeg"
        self.routes = {"native": 0, "chain": 0}
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc(self.data_name,
                         (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        shape = (self.batch_size,) if self.label_width == 1 else \
            (self.batch_size, self.label_width)
        return [DataDesc(self.label_name, shape)]

    def reset(self):
        self._cursor = 0
        if self._rec is not None and self._keys is None:
            self._rec.reset()
        if self.shuffle:
            if self._keys is not None:
                pyrandom.shuffle(self._keys)
            elif self._list is not None:
                pyrandom.shuffle(self._list)

    def _read_raw(self):
        """Next (label, encoded-or-path) pair, or None at end."""
        from ..recordio import unpack
        if self._rec is not None:
            if self._keys is not None:
                if self._cursor >= len(self._keys):
                    return None
                s = self._rec.read_idx(self._keys[self._cursor])
                self._cursor += 1
            else:
                s = self._rec.read()
                if s is None:
                    return None
            header, img = unpack(s)
            label = header.label
            return _np.atleast_1d(_np.asarray(label, _np.float32)), img
        if self._cursor >= len(self._list):
            return None
        path, label = self._list[self._cursor]
        self._cursor += 1
        with open(os.path.join(self.path_root, path), "rb") as f:
            return label, f.read()

    def _decode_augment(self, raw):
        label, buf = raw
        img = imdecode(buf, approx_size=self._decode_hint)
        for aug in self.aug_list:
            img = aug(img)
        # HWC -> CHW
        return label, _np.ascontiguousarray(
            _np.transpose(img, (2, 0, 1)).astype(_np.float32))

    def _ensure_native(self):
        """Build the C++ decode team lazily (first batch)."""
        if self._native_pool is None:
            from ..io import native_decode
            cfg = self._native_cfg
            kw = dict(resize=cfg.get("resize", 0),
                      rand_crop=cfg.get("rand_crop", False),
                      rand_mirror=cfg.get("rand_mirror", False))
            if self.native_route == "nvjpeg":
                self._native_pool = native_decode.NvjpegDecodePool(
                    self._n_threads, self.data_shape[1:],
                    device=cfg["device"], **kw)
            else:
                self._native_pool = native_decode.NativeDecodePool(
                    self._n_threads, self.data_shape[1:], **kw)
        return self._native_pool

    def _next_native(self, raws, pad):
        """Batch path through the libjpeg worker team
        (src/io/jpeg_decode_pool.cc): decode + resize + crop + mirror
        run in C++ threads; mean/std normalization is one vectorized
        numpy pass over the assembled batch.  Returns None when any
        record is not a decodable JPEG — the caller re-runs the batch
        through the cv2 chain, which also handles PNG-packed records.
        On the nvJPEG route the same steps run on the card and the batch
        is a device NDArray."""
        cfg = self._native_cfg
        bufs = [bytes(buf) for _, buf in raws]
        if not all(b[:2] == b"\xff\xd8" for b in bufs):
            return None
        out, ok = self._ensure_native().decode_batch(bufs)
        if not ok.all():
            return None
        labels = _np.zeros(
            (self.batch_size, self.label_width), _np.float32)
        for i, (label, _) in enumerate(raws):
            labels[i, :len(label)] = label[:self.label_width]
        if self.label_width == 1:
            labels = labels[:, 0]
        self.routes["native"] += 1
        if isinstance(out, torch.Tensor):
            return self._device_batch(out, labels, pad)
        data = out.astype(_np.float32)
        mean, std = cfg.get("mean"), cfg.get("std")
        if mean is not None:
            data -= mean
        if std is not None:
            data /= std
        data = _np.ascontiguousarray(data.transpose(0, 3, 1, 2))
        if pad:
            data = _np.concatenate(
                [data, _np.zeros((pad,) + data.shape[1:],
                                 _np.float32)])
        return _host_batch(data, labels, pad)

    def _device_batch(self, out, labels, pad):
        """The native batch's float conversion, mean/std and NCHW layout
        on the card (the host route's numpy steps, in torch)."""
        cfg = self._native_cfg
        dev = out.device
        n = out.shape[0]
        data = torch.zeros((self.batch_size,) + self.data_shape,
                           dtype=torch.float32, device=dev)
        x = out.permute(0, 3, 1, 2).to(torch.float32)
        mean, std = cfg.get("mean"), cfg.get("std")
        if mean is not None:
            x -= torch.from_numpy(_np.asarray(mean, _np.float32)).to(
                dev).view(1, -1, 1, 1)
        if std is not None:
            x /= torch.from_numpy(_np.asarray(std, _np.float32)).to(
                dev).view(1, -1, 1, 1)
        data[:n] = x
        return DataBatch(data=[NDArray(data)],
                         label=[NDArray(_from_numpy(labels).to(dev))],
                         pad=pad)

    def next(self):
        import concurrent.futures as cf
        raws = []
        while len(raws) < self.batch_size:
            raw = self._read_raw()
            if raw is None:
                break
            raws.append(raw)
        if not raws:
            raise StopIteration
        pad = self.batch_size - len(raws)
        if self._native_cfg is not None:
            batch = self._next_native(raws, pad)
            if batch is not None:
                return batch
            # non-JPEG or corrupt record: cv2 chain handles the batch
        if self._pool is None:
            self._pool = cf.ThreadPoolExecutor(self._n_threads)
        decoded = list(self._pool.map(self._decode_augment, raws))
        data = _np.zeros((self.batch_size,) + self.data_shape,
                         _np.float32)
        labels = _np.zeros(
            (self.batch_size, self.label_width), _np.float32)
        for i, (label, img) in enumerate(decoded):
            if img.shape != self.data_shape:
                raise MXNetError(
                    "augmented image shape %s != data_shape %s"
                    % (img.shape, self.data_shape))
            data[i] = img
            labels[i, :len(label)] = label[:self.label_width]
        if self.label_width == 1:
            labels = labels[:, 0]
        self.routes["chain"] += 1
        return _host_batch(data, labels, pad)


def _host_batch(data, labels, pad):
    """A DataBatch of host NDArrays over freshly built numpy batches (no
    copy: nothing else holds them)."""
    return DataBatch(data=[NDArray(_from_numpy(data))],
                     label=[NDArray(_from_numpy(labels))], pad=pad)
