"""ctypes binding for the native JPEG decode+augment worker team (port
of ``mxnet_tpu/io/native_decode.py``).

Reference capability: ``src/io/iter_image_recordio_2.cc:141-149`` — the
reference decodes and augments inside a C++ OMP team, so image
throughput scales with cores instead of paying a Python call per image.
``src/io/jpeg_decode_pool.cc`` is that team for this framework; one
``decode_batch`` call turns a list of encoded JPEG buffers into an
assembled (n, h, w, 3) uint8 RGB batch, with shorter-side resize,
center/seeded-random crop, and mirror done worker-side.

The library is built from ``src/io`` at first use (``runtime/native.py``,
linked with ``-ljpeg -lpthread``); a failed build raises with the
compiler's output, and no batch is then routed elsewhere.

The pool covers the plain classification pipeline (resize + crop +
mirror, the ResNet config).  Color/PCA/aspect augmenters stay on the
cv2 path — ``ImageIter`` sends such configs there.

On a CUDA device the same pipeline runs as :class:`NvjpegDecodePool`:
nvJPEG (``csrc/nvjpeg_decode.cu``) decodes the batch at full size onto
the card, and the team's geometry follows there as torch ops
(:func:`augment_decoded`): its choice of libjpeg scale (emulated by a
rounded area average), its fixed-point bilinear shorter-side resize
(bit-exact to ``resize_bilinear``), and its crop and mirror choices from
the same per-image seeds and xorshift generator, computed on the host.
Only the decoder differs from the team's output.
"""

from __future__ import annotations

import ctypes

import numpy as _np
import torch

from ..base import MXNetError
from ..ops import _cuda
from ..runtime import native as _native

__all__ = ["available", "NativeDecodePool", "NvjpegDecodePool",
           "augment_decoded", "draw_seeds"]

_M64 = (1 << 64) - 1


class _DecodeCfg(ctypes.Structure):
    _fields_ = [("resize", ctypes.c_int32),
                ("out_h", ctypes.c_int32),
                ("out_w", ctypes.c_int32),
                ("rand_crop", ctypes.c_int32),
                ("rand_mirror", ctypes.c_int32)]


def _bind(lib):
    lib.MXIOPoolCreate.restype = ctypes.c_void_p
    lib.MXIOPoolCreate.argtypes = [ctypes.c_int]
    lib.MXIOPoolFree.argtypes = [ctypes.c_void_p]
    lib.MXIOPoolDecodeBatch.restype = ctypes.c_int
    lib.MXIOPoolDecodeBatch.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_size_t),
        ctypes.c_int,
        ctypes.POINTER(_DecodeCfg),
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int32)]


def _load():
    return _native.load("jpeg_decode_pool", _bind)


def available():
    """True once the native library is built (this builds it)."""
    return _load() is not None


class NativeDecodePool:
    """A persistent decode worker team (one per iterator)."""

    def __init__(self, num_threads, out_hw, resize=0, rand_crop=False,
                 rand_mirror=False):
        self._lib = _load()
        self._pool = self._lib.MXIOPoolCreate(int(num_threads))
        self._cfg = _DecodeCfg(int(resize), int(out_hw[0]),
                               int(out_hw[1]), int(bool(rand_crop)),
                               int(bool(rand_mirror)))

    def decode_batch(self, bufs):
        """list[bytes] -> ((n, h, w, 3) uint8 RGB, ok mask)."""
        n = len(bufs)
        h, w = self._cfg.out_h, self._cfg.out_w
        out = _np.empty((n, h, w, 3), _np.uint8)
        rcs = _np.zeros((n,), _np.int32)
        seeds = draw_seeds(n)
        buf_arr = (ctypes.c_char_p * n)(*bufs)
        len_arr = (ctypes.c_size_t * n)(*[len(b) for b in bufs])
        rc = self._lib.MXIOPoolDecodeBatch(
            self._pool, buf_arr, len_arr, n, ctypes.byref(self._cfg),
            seeds.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            rcs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        if rc != 0:
            raise RuntimeError("MXIOPoolDecodeBatch rc=%d" % rc)
        return out, rcs == 0

    def close(self):
        if getattr(self, "_pool", None):
            self._lib.MXIOPoolFree(self._pool)
            self._pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def draw_seeds(n):
    """The per-image augment seeds of a batch.  They come from numpy's
    GLOBAL stream so np.random.seed(...) pins this path exactly like it
    pins the cv2 augmenter chain."""
    return _np.random.randint(1, 2 ** 63 - 1, size=n, dtype=_np.uint64)


def _xorshift(s):
    s ^= (s << 13) & _M64
    s ^= s >> 7
    s ^= (s << 17) & _M64
    return s


def _scale_denom(h, w, resize, out_h, out_w):
    """The team's libjpeg scale: the smallest 1/denom whose shorter side
    still covers the resize target (or the crop)."""
    need = resize if resize > 0 else max(out_h, out_w)
    short = min(h, w)
    denom = 1
    while denom < 8 and short // (denom * 2) >= need:
        denom *= 2
    return denom


def _bilinear_taps(src, dst):
    """Source rows (or columns) and weights in 1/256ths of the team's
    ``resize_bilinear``, in its float32 arithmetic."""
    f32 = _np.float32
    r = f32(src - 1) / f32(dst - 1) if dst > 1 else f32(0.0)
    f = _np.arange(dst, dtype=f32) * r
    i0 = f.astype(_np.int64)
    i1 = _np.minimum(i0 + 1, src - 1)
    wt = ((f - i0.astype(f32)) * f32(256.0) + f32(0.5)).astype(_np.int32)
    return i0, i1, wt


def _resize_fixed(img, dh, dw):
    """(h, w, 3) uint8 -> (dh, dw, 3) uint8 by the team's fixed-point
    bilinear (``jpeg_decode_pool.cc`` resize_bilinear), exactly."""
    sh, sw = img.shape[:2]
    if (sh, sw) == (dh, dw):
        return img
    dev = img.device
    y0, y1, wy = (torch.from_numpy(a).to(dev) for a in _bilinear_taps(sh, dh))
    x0, x1, wx = (torch.from_numpy(a).to(dev) for a in _bilinear_taps(sw, dw))
    x = img.to(torch.int32)
    wx = wx.view(1, -1, 1)
    wy = wy.view(-1, 1, 1)
    r0, r1 = x.index_select(0, y0), x.index_select(0, y1)
    top = r0.index_select(1, x0) * (256 - wx) + r0.index_select(1, x1) * wx
    bot = r1.index_select(1, x0) * (256 - wx) + r1.index_select(1, x1) * wx
    return ((top * (256 - wy) + bot * wy + 32768) >> 16).to(torch.uint8)


def _area_down(img, denom):
    """(h, w, 3) uint8 -> (ceil(h/denom), ceil(w/denom), 3): the rounded
    mean of each denom x denom window (edge windows over the pixels they
    hold), standing in for libjpeg's 1/denom scaled decode."""
    h, w = img.shape[:2]
    oh, ow = -(-h // denom), -(-w // denom)
    x = torch.zeros((oh * denom, ow * denom, 3), dtype=torch.int32,
                    device=img.device)
    x[:h, :w] = img
    s = x.view(oh, denom, ow, denom, 3).sum(dim=(1, 3))
    rows = torch.clamp(h - torch.arange(oh, device=img.device) * denom,
                       max=denom)
    cols = torch.clamp(w - torch.arange(ow, device=img.device) * denom,
                       max=denom)
    cnt = (rows.view(-1, 1) * cols.view(1, -1)).view(oh, ow, 1)
    return torch.div(s + cnt // 2, cnt, rounding_mode="floor").to(
        torch.uint8)


def augment_decoded(img, seed, resize, out_h, out_w, rand_crop,
                    rand_mirror):
    """The team's geometry (``decode_one`` after the decode) on a full-size
    decoded (h, w, 3) uint8 tensor, on its device: scale, shorter-side
    resize, upscale when too small, centre or seeded-random crop, seeded
    mirror.  Returns (out_h, out_w, 3) uint8."""
    h, w = img.shape[:2]
    denom = _scale_denom(h, w, resize, out_h, out_w)
    cur = _area_down(img, denom) if denom > 1 else img
    ch, cw = cur.shape[:2]
    if resize > 0 and min(h, w) != 0:
        if ch <= cw:
            dh, dw = resize, cw * resize // ch
        else:
            dh, dw = ch * resize // cw, resize
        cur = _resize_fixed(cur, dh, dw)
        ch, cw = dh, dw
    if ch < out_h or cw < out_w:
        cur = _resize_fixed(cur, out_h, out_w)
        ch, cw = out_h, out_w
    rng = int(seed) or 0x9e3779b97f4a7c15
    cy, cx = (ch - out_h) // 2, (cw - out_w) // 2
    if rand_crop:
        rng = _xorshift(rng)
        cy = rng % (ch - out_h + 1)
        rng = _xorshift(rng)
        cx = rng % (cw - out_w + 1)
    out = cur[cy:cy + out_h, cx:cx + out_w]
    if rand_mirror:
        rng = _xorshift(rng)
        if rng & 1:
            out = out.flip(1)
    return out


def _bind_nvjpeg(lib):
    vp, i32 = ctypes.c_void_p, ctypes.c_int32
    lib.mx_nvjpeg_create.restype = ctypes.c_int
    lib.mx_nvjpeg_create.argtypes = [ctypes.c_int, ctypes.POINTER(vp)]
    lib.mx_nvjpeg_free.restype = None
    lib.mx_nvjpeg_free.argtypes = [vp]
    lib.mx_nvjpeg_info.restype = ctypes.c_int
    lib.mx_nvjpeg_info.argtypes = [
        vp, ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_size_t),
        ctypes.c_int, ctypes.POINTER(i32), ctypes.POINTER(i32)]
    lib.mx_nvjpeg_decode.restype = ctypes.c_int
    lib.mx_nvjpeg_decode.argtypes = [
        vp, ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_size_t),
        ctypes.c_int, ctypes.POINTER(vp), ctypes.POINTER(i32), vp]


class NvjpegDecodePool:
    """The team's pipeline on a CUDA *device*: nvJPEG decodes the batch
    onto the card (``csrc/nvjpeg_decode.cu``, built with nvcc at first
    use), :func:`augment_decoded` does the rest there.  ``decode_batch``
    returns an (n, h, w, 3) uint8 tensor on the device, written on the
    current stream, and the ok mask.  The batch is split over
    *num_threads* host workers, each with its own nvJPEG state (the
    entropy decode runs on the host).  ``launches`` counts batched
    decodes."""

    def __init__(self, num_threads, out_hw, resize=0, rand_crop=False,
                 rand_mirror=False, device=None):
        if device is None or device.type != "cuda":
            raise MXNetError("NvjpegDecodePool decodes onto a CUDA device, "
                             "got %s" % (device,))
        self._lib = _cuda.load("nvjpeg_decode", _bind_nvjpeg)
        self.device = device
        self.out_hw = (int(out_hw[0]), int(out_hw[1]))
        self.resize = int(resize)
        self.rand_crop = bool(rand_crop)
        self.rand_mirror = bool(rand_mirror)
        self.launches = 0
        self._keep = None
        handle = ctypes.c_void_p()
        with torch.cuda.device(device):
            rc = self._lib.mx_nvjpeg_create(int(num_threads),
                                            ctypes.byref(handle))
        if rc != 0:
            raise MXNetError("nvjpegCreateSimple/JpegStateCreate failed "
                             "(nvjpegStatus %d)" % rc)
        self._dec = handle

    @staticmethod
    def _arrays(bufs):
        n = len(bufs)
        return ((ctypes.c_char_p * n)(*bufs),
                (ctypes.c_size_t * n)(*[len(b) for b in bufs]))

    def info(self, bufs):
        """((n, 2) int32 heights and widths, nvjpegStatus per image)."""
        n = len(bufs)
        hw = _np.zeros((n, 2), _np.int32)
        rcs = _np.zeros((n,), _np.int32)
        buf_arr, len_arr = self._arrays(bufs)
        self._lib.mx_nvjpeg_info(
            self._dec, buf_arr, len_arr, n,
            hw.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            rcs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return hw, rcs

    def decode_full(self, bufs, hw):
        """Full-size (h, w, 3) uint8 RGB tensors on the device, decoded on
        the current stream by one batched nvJPEG call."""
        n = len(bufs)
        outs = [torch.empty((int(h), int(w), 3), dtype=torch.uint8,
                            device=self.device) for h, w in hw]
        buf_arr, len_arr = self._arrays(bufs)
        ptrs = (ctypes.c_void_p * n)(*[o.data_ptr() for o in outs])
        widths = (ctypes.c_int32 * n)(*[int(w) for _, w in hw])
        stream = torch.cuda.current_stream(self.device).cuda_stream
        rc = self._lib.mx_nvjpeg_decode(self._dec, buf_arr, len_arr, n, ptrs,
                                        widths, ctypes.c_void_p(stream))
        self.launches += 1
        # the host buffers stay referenced until the next call
        self._keep = (bufs, buf_arr, len_arr)
        if rc != 0:
            raise MXNetError("nvjpegDecodeBatched failed (nvjpegStatus %d)"
                             % rc)
        return outs

    def decode_batch(self, bufs):
        """list[bytes] -> ((n, h, w, 3) uint8 RGB on the device, ok
        mask).  An image nvJPEG cannot read makes the mask False there
        and nothing is decoded (the caller takes the chain)."""
        n = len(bufs)
        oh, ow = self.out_hw
        seeds = draw_seeds(n)
        with torch.cuda.device(self.device):
            hw, rcs = self.info(bufs)
            ok = rcs == 0
            if not ok.all():
                return None, ok
            imgs = self.decode_full(bufs, hw)
            out = torch.empty((n, oh, ow, 3), dtype=torch.uint8,
                              device=self.device)
            for i, img in enumerate(imgs):
                out[i] = augment_decoded(img, seeds[i], self.resize, oh, ow,
                                         self.rand_crop, self.rand_mirror)
        return out, ok

    def close(self):
        if getattr(self, "_dec", None):
            self._lib.mx_nvjpeg_free(self._dec)
            self._dec = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
