"""ImageRecordIter — the ImageNet hot path (port of
``mxnet_tpu/io/image_record.py``).

Reference capability: `src/io/iter_image_recordio_2.cc:78-149`
(RecordIO chunks -> OMP-parallel JPEG decode + augment -> inline batch
assembly) behind `MXNET_REGISTER_IO_ITER(ImageRecordIter)`.  Here
`mx.image.ImageIter` decodes and augments, and a `PrefetchingIter`
reads batches ahead on a thread and places them on the caller's
context, as the reference's batches are.

Routing (``MXNET_TPU_NATIVE_DECODE``, default on): plain classification
configs (resize, crop, mirror, mean/std; no colour, PCA or aspect
jitter) take the native route — on a CUDA context nvJPEG decodes onto
the card and the geometry runs there, on the CPU the libjpeg worker
team (``src/io/jpeg_decode_pool.cc``) does it all on host threads.
Anything fancier takes the cv2 augmenter chain.
"""

from __future__ import annotations

import os

import numpy as _np

from .io import PrefetchingIter
from ..config import get_env
from ..context import current_context


def ImageRecordIter(path_imgrec, data_shape, batch_size,
                    path_imgidx=None, label_width=1, shuffle=False,
                    rand_crop=False, rand_mirror=False, resize=0,
                    rand_resize=False, mean_r=0.0, mean_g=0.0,
                    mean_b=0.0, std_r=1.0, std_g=1.0, std_b=1.0,
                    max_random_brightness=0.0, max_random_contrast=0.0,
                    max_random_saturation=0.0, max_random_hue=0.0,
                    random_gray_prob=0.0, pca_noise=0.0,
                    preprocess_threads=None, prefetch_buffer=4,
                    data_name="data", label_name="softmax_label",
                    **kwargs):
    """Build the parallel record->batch pipeline.  Accepts the
    reference's flat parameter names (mean_r/std_r etc.,
    image_aug_default.cc) and returns a prefetching DataIter whose
    batches lie on the current context's device."""
    from ..image import CreateAugmenter, ImageIter

    device = current_context().torch_device
    mean = None
    if mean_r or mean_g or mean_b:
        mean = _np.array([mean_r, mean_g, mean_b], _np.float32)
    std = None
    if std_r != 1.0 or std_g != 1.0 or std_b != 1.0:
        std = _np.array([std_r, std_g, std_b], _np.float32)
    augs = CreateAugmenter(
        data_shape, resize=resize, rand_crop=rand_crop,
        rand_resize=rand_resize, rand_mirror=rand_mirror, mean=mean,
        std=std, brightness=max_random_brightness,
        contrast=max_random_contrast,
        saturation=max_random_saturation, hue=max_random_hue,
        pca_noise=pca_noise, rand_gray=random_gray_prob)
    native = None
    if get_env("MXNET_TPU_NATIVE_DECODE") and \
            not (rand_resize or max_random_brightness
                 or max_random_contrast or max_random_saturation
                 or max_random_hue or random_gray_prob or pca_noise):
        native = {"resize": int(resize or 0), "rand_crop": rand_crop,
                  "rand_mirror": rand_mirror, "mean": mean, "std": std,
                  "device": device}
    inner = ImageIter(
        batch_size=batch_size, data_shape=data_shape,
        label_width=label_width, path_imgrec=path_imgrec,
        path_imgidx=path_imgidx, shuffle=shuffle, aug_list=augs,
        data_name=data_name, label_name=label_name,
        num_threads=preprocess_threads or
        max(1, (os.cpu_count() or 2) // 2),
        native_pipeline=native)
    return PrefetchingIter(inner, prefetch_depth=prefetch_buffer,
                           device=device)
