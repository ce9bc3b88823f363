"""ModelRegistry — named, warmed models (port of
``mxnet_tpu/serve/registry.py``, subset: ``load``, ``load_checkpoint``,
``get``, ``predict``, ``unload``).

The batcher, health board, decode, quantization and tuning parts of the
JAX package's registry are not ported yet.
"""

from __future__ import annotations

import threading

from .buckets import ServeError
from .predictor import CompiledPredictor

__all__ = ["ModelRegistry"]


class ModelRegistry:
    """Named, warm models."""

    def __init__(self):
        self._lock = threading.RLock()
        self._models = {}

    def load(self, name, symbol, arg_params, aux_params=None,
             data_shapes=None, ladder=None, data_dtypes=None, ctx=None,
             warm=True):
        """Build a :class:`CompiledPredictor` and, by default, warm every
        rung; then register it under *name*, replacing any model of that
        name.  A failed build registers nothing."""
        pred = CompiledPredictor(symbol, arg_params, aux_params=aux_params,
                                 data_shapes=data_shapes, ladder=ladder,
                                 data_dtypes=data_dtypes, ctx=ctx, name=name)
        if warm:
            pred.warm()
        with self._lock:
            self._models[name] = pred
        return pred

    def load_checkpoint(self, name, prefix, epoch, data_shapes, ctx=None,
                        **kwargs):
        """Load ``prefix-symbol.json`` + ``prefix-NNNN.params`` (written by
        either package) onto *ctx* and register it."""
        from ..model import load_checkpoint
        sym, arg_params, aux_params = load_checkpoint(prefix, epoch, ctx=ctx)
        return self.load(name, sym, arg_params, aux_params=aux_params,
                         data_shapes=data_shapes, ctx=ctx, **kwargs)

    def get(self, name):
        with self._lock:
            pred = self._models.get(name)
        if pred is None:
            raise ServeError("no model %r is loaded (have %s)"
                             % (name, self.names()))
        return pred

    def predict(self, name, data):
        """Padded-bucket predict on model *name*."""
        return self.get(name).predict(data)

    def unload(self, name):
        with self._lock:
            if self._models.pop(name, None) is None:
                raise ServeError("no model %r to unload" % name)

    def names(self):
        with self._lock:
            return sorted(self._models)
