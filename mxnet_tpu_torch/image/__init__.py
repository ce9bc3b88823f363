"""mx.image — image decode + augmentation (port of ``mxnet_tpu/image/``;
reference capability: python/mxnet/image/), with the detection
augmenters and ``ImageDetIter`` (``image/detection.py``)."""

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
from .detection import (DetAugmenter, DetBorrowAug,  # noqa: F401
                        DetRandomSelectAug, DetHorizontalFlipAug,
                        DetRandomCropAug, DetRandomPadAug,
                        CreateDetAugmenter, ImageDetIter)
