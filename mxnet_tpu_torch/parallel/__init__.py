"""Parallelism (port of ``mxnet_tpu/parallel/``, subset: the device mesh
and ``ParallelTrainer`` on one device).

A mesh of more than one device, an axis other than ``dp``, collectives,
tensor, pipeline, sequence and expert parallelism are not ported: they
need NCCL across cards."""

from .mesh import (Mesh, make_mesh, current_mesh, use_mesh,  # noqa: F401
                   data_parallel_mesh)
from .data_parallel import ParallelTrainer  # noqa: F401
