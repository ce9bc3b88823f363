"""Vision datasets (port of ``mxnet_tpu/gluon/data/vision/datasets.py``;
reference: python/mxnet/gluon/data/vision/datasets.py:36-264 — MNIST,
FashionMNIST, CIFAR10/100, ImageRecordDataset, ImageFolderDataset).

Datasets read from a local ``root`` (files in the reference's on-disk
formats) and raise a clear error when files are absent: nothing is
downloaded.  Samples are NDArrays on the current context (``cpu(0)`` in
a DataLoader worker process).
"""

from __future__ import annotations

import os
import pickle

import numpy as _np

from .... import ndarray as nd
from ....io.io import _read_idx_images, _read_idx_labels
from .. import dataset

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "ImageRecordDataset", "ImageFolderDataset"]


class _IdxDataset(dataset.Dataset):
    """Shared base for idx-format image/label pairs."""

    _train_files = ("train-images-idx3-ubyte", "train-labels-idx1-ubyte")
    _test_files = ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte")

    def __init__(self, root, train=True, transform=None):
        self._root = os.path.expanduser(root)
        self._train = train
        self._transform = transform
        self._get_data()

    def _find(self, base):
        for cand in (base, base + ".gz"):
            p = os.path.join(self._root, cand)
            if os.path.exists(p):
                return p
        raise IOError(
            "%s not found under %s. Nothing is downloaded: place the idx "
            "files there." % (base, self._root))

    def _get_data(self):
        img_base, lbl_base = self._train_files if self._train \
            else self._test_files
        data = _read_idx_images(self._find(img_base))
        label = _read_idx_labels(self._find(lbl_base))
        self._data = data.reshape(data.shape[0], data.shape[1],
                                  data.shape[2], 1)
        self._label = label.astype(_np.int32)

    def __getitem__(self, idx):
        img = nd.array(self._data[idx], dtype="uint8")
        lbl = int(self._label[idx])
        if self._transform is not None:
            return self._transform(img, lbl)
        return img, lbl

    def __len__(self):
        return len(self._label)


class MNIST(_IdxDataset):
    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "mnist"), train=True,
                 transform=None):
        super().__init__(root, train, transform)


class FashionMNIST(_IdxDataset):
    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "fashion-mnist"), train=True,
                 transform=None):
        super().__init__(root, train, transform)


class CIFAR10(dataset.Dataset):
    """CIFAR-10 from the python pickle batches
    (reference: datasets.py CIFAR10 reads the binary .bin variant)."""

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "cifar10"), train=True,
                 transform=None):
        self._root = os.path.expanduser(root)
        self._train = train
        self._transform = transform
        self._get_data()

    def _batches(self):
        if self._train:
            return ["data_batch_%d" % i for i in range(1, 6)]
        return ["test_batch"]

    def _get_data(self):
        data = []
        labels = []
        base = self._root
        sub = os.path.join(base, "cifar-10-batches-py")
        if os.path.isdir(sub):
            base = sub
        for name in self._batches():
            path = os.path.join(base, name)
            if not os.path.exists(path):
                raise IOError(
                    "%s not found (nothing is downloaded; place the "
                    "CIFAR-10 python batches under %s)" % (path, self._root))
            with open(path, "rb") as f:
                batch = pickle.load(f, encoding="bytes")
            data.append(batch[b"data"])
            labels.extend(batch[b"labels"])
        data = _np.concatenate(data).reshape(-1, 3, 32, 32)
        self._data = data.transpose(0, 2, 3, 1)  # NHWC uint8 like reference
        self._label = _np.asarray(labels, _np.int32)

    def __getitem__(self, idx):
        img = nd.array(self._data[idx], dtype="uint8")
        lbl = int(self._label[idx])
        if self._transform is not None:
            return self._transform(img, lbl)
        return img, lbl

    def __len__(self):
        return len(self._label)


class CIFAR100(CIFAR10):
    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "cifar100"), fine_label=False,
                 train=True, transform=None):
        self._fine = fine_label
        super().__init__(root, train, transform)

    def _batches(self):
        return ["train"] if self._train else ["test"]

    def _get_data(self):
        base = self._root
        sub = os.path.join(base, "cifar-100-python")
        if os.path.isdir(sub):
            base = sub
        name = self._batches()[0]
        path = os.path.join(base, name)
        if not os.path.exists(path):
            raise IOError("%s not found (nothing is downloaded)" % path)
        with open(path, "rb") as f:
            batch = pickle.load(f, encoding="bytes")
        data = batch[b"data"].reshape(-1, 3, 32, 32)
        self._data = data.transpose(0, 2, 3, 1)
        key = b"fine_labels" if self._fine else b"coarse_labels"
        self._label = _np.asarray(batch[key], _np.int32)


class ImageRecordDataset(dataset.RecordFileDataset):
    """Images from a RecordIO file (reference: datasets.py
    ImageRecordDataset)."""

    def __init__(self, filename, flag=1, transform=None):
        super().__init__(filename)
        self._flag = flag
        self._transform = transform

    def __getitem__(self, idx):
        from .... import recordio
        record = super().__getitem__(idx)
        header, img = recordio.unpack_img(record)
        img = nd.array(img, dtype="uint8")
        label = header.label
        if self._transform is not None:
            return self._transform(img, label)
        return img, label


class ImageFolderDataset(dataset.Dataset):
    """class-per-subfolder image dataset (reference: datasets.py
    ImageFolderDataset)."""

    def __init__(self, root, flag=1, transform=None):
        self._root = os.path.expanduser(root)
        self._flag = flag
        self._transform = transform
        self._exts = [".jpg", ".jpeg", ".png", ".npy"]
        self._list_images(self._root)

    def _list_images(self, root):
        self.synsets = []
        self.items = []
        for folder in sorted(os.listdir(root)):
            path = os.path.join(root, folder)
            if not os.path.isdir(path):
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for filename in sorted(os.listdir(path)):
                ext = os.path.splitext(filename)[1].lower()
                if ext not in self._exts:
                    continue
                self.items.append((os.path.join(path, filename), label))

    def __getitem__(self, idx):
        path, label = self.items[idx]
        if path.endswith(".npy"):
            img = _np.load(path)
        else:
            from PIL import Image
            img = _np.asarray(Image.open(path))
        img = nd.array(img, dtype="uint8")
        if self._transform is not None:
            return self._transform(img, label)
        return img, label

    def __len__(self):
        return len(self.items)
