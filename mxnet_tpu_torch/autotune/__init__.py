"""Measured-cost autotuning over the serving knob space (port of
``mxnet_tpu/autotune``; the TVM lesson: search over *measured* cost
beats hand tuning).

The package is three small, separable pieces plus the measurement
harness that binds them to the serving subsystem:

* :mod:`~mxnet_tpu_torch.autotune.space` — typed config spaces: ladder
  rung lists as structured choices, scalar knobs as log/linear
  ranges, with deterministic sampling and neighborhood proposals;
* :mod:`~mxnet_tpu_torch.autotune.trace` — recorded, replayable open-loop
  arrival traces (request sizes + arrival offsets; decode: prompt
  lengths + session arrivals) so two candidates see IDENTICAL load;
* :mod:`~mxnet_tpu_torch.autotune.store` — the JSON ``TuningStore`` keyed
  ``(model_name, device_kind, workload)``, each winner persisted WITH
  the measurement artifact that justified it;
* :mod:`~mxnet_tpu_torch.autotune.search` — successive-halving search
  (random + neighborhood proposals, short replays promote to full
  replays) with an analytic roofline model as a prior that prunes
  dominated candidates before paying a measurement;
* :mod:`~mxnet_tpu_torch.autotune.measure` — replays a trace against one
  candidate through the real registry/batcher/decode request path.

``python -m mxnet_tpu_torch.autotune`` is the CLI;
``ModelRegistry.load`` / ``DynamicBatcher`` / ``DecodeEngine`` consult
the store at load time with precedence explicit env > tuned store >
registered default.
"""

from __future__ import annotations

from .space import Choice, ConfigSpace, FloatRange, IntRange, \
    decode_space, serve_space
from .store import TuningStore, active_store, device_kind, lookup
from .search import Objective, decode_objective, serve_objective, tune
from .trace import Trace, synth_decode_trace, synth_serve_trace

__all__ = [
    "Choice", "ConfigSpace", "FloatRange", "IntRange",
    "serve_space", "decode_space",
    "TuningStore", "active_store", "device_kind", "lookup",
    "Objective", "serve_objective", "decode_objective", "tune",
    "Trace", "synth_serve_trace", "synth_decode_trace",
]
