"""``mxnet_tpu_torch.serve`` — bucketed inference (port of
``mxnet_tpu/serve/``, subset: :class:`BucketLadder`,
:class:`CompiledPredictor`, :class:`ModelRegistry`)."""

from .buckets import BucketLadder, ServeError  # noqa: F401
from .predictor import CompiledPredictor  # noqa: F401
from .registry import ModelRegistry  # noqa: F401

__all__ = ["BucketLadder", "ServeError", "CompiledPredictor",
           "ModelRegistry"]
