"""Data iterators (port of ``mxnet_tpu/io/``)."""

from .io import (DataDesc, DataBatch, DataIter, NDArrayIter,  # noqa: F401
                 ResizeIter, PrefetchingIter, MNISTIter, CSVIter, LibSVMIter)
from .device_prefetch import DevicePrefetcher  # noqa: F401
from .image_record import ImageRecordIter  # noqa: F401
