"""Post-training int8 quantization for the serving path (port of
``mxnet_tpu/quantize``).

The graph-level pipeline, in three stages:

1. :func:`calibrate` — instrumented fp32 forward over representative
   batches capturing per-tensor ranges into a sha-identified
   :class:`CalibTable` (atomic save, sha-verified load).
2. :func:`quantize_model` — lower Convolution/FullyConnected (and the
   int8-transparent ops between them) onto the ``_contrib_quantized_*``
   kernels with fused inter-layer requantize, offline int8 weights,
   int32 bias folding and fp32 fallback, under a
   :class:`QuantizePolicy`.
3. Serving integration — ``ModelRegistry.load(..., quantize=...)``
   builds the quantized rungs through the normal BucketLadder/warm
   path and gates accuracy vs fp32 at load time (failures raise
   :class:`QuantizationError`; see ``serve/registry.py``).

The port lowers to no StableHLO: ``hlo_has_int8_compute`` and
``hlo_has_int8_tensors`` keep their names and read the int8 work each
rung's program counted (``int8_work``).
"""

from .calibrate import CalibTable, calibrate, tensor_name
from .lower import (hlo_has_int8_compute, hlo_has_int8_tensors,
                    int8_work, quantize_model)
from .policy import MODES, QuantizationError, QuantizePolicy

__all__ = [
    "CalibTable",
    "MODES",
    "QuantizationError",
    "QuantizePolicy",
    "calibrate",
    "hlo_has_int8_compute",
    "hlo_has_int8_tensors",
    "int8_work",
    "quantize_model",
    "tensor_name",
]
