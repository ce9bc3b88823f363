"""Gluon vision data (port of ``mxnet_tpu/gluon/data/vision/``;
reference: python/mxnet/gluon/data/vision/)."""

from .datasets import MNIST, FashionMNIST, CIFAR10, CIFAR100, \
    ImageRecordDataset, ImageFolderDataset  # noqa: F401
from . import transforms  # noqa: F401
