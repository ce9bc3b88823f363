"""Data iterators (port of ``mxnet_tpu/io/``)."""

from .io import (DataDesc, DataBatch, DataIter, NDArrayIter,  # noqa: F401
                 ResizeIter, PrefetchingIter, MNISTIter, CSVIter, LibSVMIter)
