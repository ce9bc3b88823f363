"""mx.image — host-side image decode + augmentation (port of
``mxnet_tpu/image/``; reference capability: python/mxnet/image/).

``image/detection.py`` (``ImageDetIter``) is not ported: it needs the
detection ops (ROADMAP queue A item 12)."""

from .image import (imdecode, imread, imresize, resize_short,  # noqa
                    fixed_crop, center_crop, random_crop,
                    random_size_crop, color_normalize, scale_down,
                    Augmenter, SequentialAug, ResizeAug, ForceResizeAug,
                    RandomCropAug, RandomSizedCropAug, CenterCropAug,
                    BrightnessJitterAug, ContrastJitterAug,
                    SaturationJitterAug, HueJitterAug, ColorJitterAug,
                    LightingAug, ColorNormalizeAug, RandomGrayAug,
                    HorizontalFlipAug, CastAug, CreateAugmenter,
                    ImageIter)
