"""Resilience (port of ``mxnet_tpu/resilience``, subset: what serving
uses):

* :mod:`.retry` — jittered-exponential-backoff with a deadline and an
  injectable clock (the batcher's restart schedule);
* :mod:`.chaos` — the deterministic fault-injection spec;
* :mod:`.servechaos` — the serving-path injection points (dispatch
  raise / hang / slow, program-build reject, decode tick raise, and the
  fleet's replica kill / slow and router partition);
* :mod:`.netchaos` — the distributed kvstore's network injection points
  (partition, delay, duplicate, torn frames, dropped replies, server
  kill);
* the errors the Module training loop raises: ``DivergenceError`` (the
  non-finite guard's divergence action) and ``StateMismatchError`` (an
  optimizer-state file of another optimizer);
* :mod:`.checkpoint` — ``atomic_write`` only (calibration tables, tuning
  stores and traces persist through it).

The checkpoint manager, the supervisor, elastic resize and job state are
not ported (the kvstore server keeps its own snapshot files).
"""

from __future__ import annotations

from ..base import MXNetError
from . import chaos  # noqa: F401
from . import servechaos  # noqa: F401
from . import netchaos  # noqa: F401
from .retry import backoff_delays, retry_call  # noqa: F401

__all__ = ["chaos", "servechaos", "netchaos", "backoff_delays", "retry_call",
           "DivergenceError", "StateMismatchError"]


class DivergenceError(MXNetError):
    """Training diverged: the non-finite guard skipped its limit of
    consecutive steps."""


class StateMismatchError(MXNetError):
    """An optimizer-state blob written by another optimizer class or
    hyper-parameter signature."""
