"""``mxnet_tpu_torch.serve`` — batch serving (port of ``mxnet_tpu/serve/``,
subset):

* :class:`BucketLadder` — the finite set of padded shapes a model may run
  at, with batch rungs and sequence rounding (buckets.py);
* :class:`CompiledPredictor` — one program per bucket, built at load
  time: on the card one CUDA graph per rung, on the CPU the eager graph
  (predictor.py);
* :class:`DynamicBatcher` / :class:`ServeFuture` — many callers, one
  padded dispatch, with admission control (:class:`OverloadError`),
  deadlines (:class:`DeadlineExceededError`), cancellation
  (:class:`RequestCancelled`), supervised dispatcher restarts and
  graceful drain (batcher.py);
* :class:`ModelRegistry` — load/unload/alias with warm programs,
  drain-before-teardown and the ``health``/``ready``/``live`` probes
  backed by :class:`HealthBoard` (registry.py, health.py);
* decode: the dense :class:`DecodeSession`
  (``CompiledPredictor.make_decoder``), and continuously-batched paged
  decode — :class:`KVPool` / :class:`KVPoolExhausted` (kvpool.py),
  :class:`DecodeEngine` with one CUDA graph per session rung and per
  prefill rung on the card, :class:`DecodeBatcher`,
  :class:`DecodeJournal`, :class:`PagedSession` and
  :class:`SpeculativeDecoder` (decode.py).

* the fleet: :class:`ReplicaServer` — a registry behind the kvstore's
  wire framing (``mxnet_tpu_torch._kvstore_impl``, byte for byte the JAX
  package's), with idempotent predicts, cancellation, typed error codes,
  streaming decode over the wire, DRAIN with decode eviction, and the
  ``start_http_probe`` endpoint (replica.py); :class:`Router` —
  round-robin over :class:`ReplicaHandle` s with a
  :class:`CircuitBreaker` each, retry with failover on the same request
  id, hedging, heartbeat ejection and rejoin, and :class:`DecodeStream`,
  a decode session that fails over from the router's journal
  (router.py); :class:`Fleet` — replica processes spawned on one shared
  kernel build directory, replace, rolling ``deploy``, ``stats`` and
  ``scrape`` (fleet.py).  Replicas serve on ``cuda:0``; ``Fleet(...,
  ctx=cpu())`` (a spec's ``"ctx": "cpu"``) serves on the CPU.

``ModelRegistry.load(quantize=...)`` serves a model lowered to int8
(``mxnet_tpu_torch.quantize``) behind its load gate, and the registry,
the batcher and the decode engine read tuned knobs from
``MXNET_TUNING_STORE`` (``mxnet_tpu_torch.autotune``).  The C predict
ABI's registry is not ported.
"""

from .buckets import (BucketLadder, DeadlineExceededError,  # noqa: F401
                      OverloadError, RequestCancelled, ServeError)
from .health import STATES, HealthBoard  # noqa: F401
from .predictor import CompiledPredictor, DecodeSession  # noqa: F401
from .kvpool import KVPool, KVPoolExhausted  # noqa: F401
from .decode import (DecodeBatcher, DecodeEngine,  # noqa: F401
                     DecodeJournal, PagedSession, SpeculativeDecoder)
from .batcher import DynamicBatcher, ServeFuture  # noqa: F401
from .registry import ModelRegistry  # noqa: F401
from .replica import (ReplicaDraining, ReplicaServer,  # noqa: F401
                      start_http_probe)
from .router import (CircuitBreaker, DecodeStream,  # noqa: F401
                     ReplicaHandle, Router)
from .fleet import Fleet  # noqa: F401

__all__ = ["BucketLadder", "ServeError", "OverloadError",
           "DeadlineExceededError", "RequestCancelled",
           "CompiledPredictor", "DynamicBatcher", "ServeFuture",
           "ModelRegistry", "HealthBoard", "STATES", "DecodeSession",
           "KVPool", "KVPoolExhausted", "DecodeEngine", "DecodeBatcher",
           "DecodeJournal", "PagedSession", "SpeculativeDecoder",
           "ReplicaServer", "ReplicaDraining", "start_http_probe",
           "CircuitBreaker", "DecodeStream", "ReplicaHandle", "Router",
           "Fleet"]
