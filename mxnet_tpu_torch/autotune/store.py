"""The JSON ``TuningStore`` — winning configs, with receipts (port of
``mxnet_tpu/autotune/store.py``: the same store JSON; the device kind is
the card's name).

One store file holds every tuning the search has won, keyed
``(model_name, device_kind, workload)``.  An entry is never just a
config: it carries the **measurement artifact that justified it** —
the winner's measured objective, the default config's objective on
the SAME replayed trace, the gain, the trace identity (sha256 +
summary) and the trial/prune counts — so "why is production running
max_wait=0.4ms?" is answered by the store itself, not by archaeology.

Consumers (``ModelRegistry.load``, ``DynamicBatcher``,
``DecodeEngine``) consult the store named by the
``MXNET_TUNING_STORE`` env knob through :func:`lookup`; precedence at
every knob is explicit env > tuned store > registered default
(``config.resolve_env``).  An empty knob means zero lookups and zero
overhead.  Writes are atomic replaces
(``resilience.checkpoint.atomic_write``) — a torn store must not
exist.
"""

from __future__ import annotations

import json
import os
import time

from ..resilience.checkpoint import atomic_write

__all__ = ["TuningStore", "TuningStoreError", "active_store",
           "lookup", "device_kind", "install"]

_FORMAT = 1


class TuningStoreError(ValueError):
    """A store file that does not parse or does not validate."""


def device_kind(device=None):
    """The canonical device-kind string entries are keyed on: the card's
    name (``torch.cuda.get_device_name``, e.g. ``"NVIDIA H100 80GB
    HBM3"``) for a CUDA *device*, ``"cpu"`` for a CPU one.  Without a
    device: the first card's name where CUDA is available, else
    ``"cpu"``.  An entry written on the CPU, or by the JAX package for
    a TPU, never matches a card."""
    import torch
    if device is not None:
        device = torch.device(device)
        if device.type != "cuda":
            return "cpu"
        return torch.cuda.get_device_name(device)
    if torch.cuda.is_available():
        return torch.cuda.get_device_name(0)
    return "cpu"


def _key(model, device, workload):
    return "%s|%s|%s" % (model, device, workload)


class TuningStore(object):
    """Load/put/get/save over one JSON store file.

    The in-memory form is a dict ``key -> entry``; an entry is a
    plain dict with at least ``model`` / ``device_kind`` /
    ``workload`` / ``config``, and (for search-written entries)
    ``score`` / ``baseline_score`` / ``gain_pct`` / ``objective`` /
    ``trace`` / ``measurement`` / ``baseline`` / ``search``.
    """

    def __init__(self, path, entries=None):
        self.path = path
        self._entries = dict(entries or {})

    # -- persistence -------------------------------------------------------
    @classmethod
    def load(cls, path, missing_ok=False):
        if not os.path.exists(path):
            if missing_ok:
                return cls(path)
            raise TuningStoreError("no tuning store at %r" % (path,))
        try:
            with open(path, encoding="utf-8") as f:
                doc = json.load(f)
        except (OSError, ValueError) as exc:
            raise TuningStoreError("cannot read tuning store %r: %s"
                                   % (path, exc))
        if not isinstance(doc, dict) or doc.get("format") != _FORMAT:
            raise TuningStoreError(
                "%r is not a format-%d tuning store" % (path, _FORMAT))
        entries = {}
        for e in doc.get("entries", []):
            for field in ("model", "device_kind", "workload", "config"):
                if field not in e:
                    raise TuningStoreError(
                        "store entry lacks %r: %r" % (field, e))
            entries[_key(e["model"], e["device_kind"],
                         e["workload"])] = e
        return cls(path, entries)

    def save(self, path=None):
        path = path or self.path
        doc = {"format": _FORMAT,
               "entries": [self._entries[k]
                           for k in sorted(self._entries)]}
        atomic_write(path, (json.dumps(doc, indent=1, sort_keys=True)
                            + "\n").encode("utf-8"))
        return path

    # -- access ------------------------------------------------------------
    def get(self, model, workload, device=None):
        """The entry for ``(model, device, workload)`` or None.  A
        device-specific entry wins over an ``"any"``-device one (a
        store shipped across heterogeneous fleets)."""
        device = device or device_kind()
        return self._entries.get(_key(model, device, workload)) \
            or self._entries.get(_key(model, "any", workload))

    def put(self, model, workload, config, device=None, **artifact):
        """Install/replace the entry for the key; *artifact* is the
        measurement record persisted verbatim alongside the config."""
        device = device or device_kind()
        entry = {"model": model, "device_kind": device,
                 "workload": workload, "config": dict(config),
                 "created": round(time.time(), 3)}
        entry.update(artifact)
        self._entries[_key(model, device, workload)] = entry
        return entry

    def entries(self):
        return [self._entries[k] for k in sorted(self._entries)]

    def __len__(self):
        return len(self._entries)


# -- the env-named store the serving path consults ---------------------------

# tiny cache so a registry loading N models reads the file once per
# mtime, not N times; (path, mtime) -> TuningStore
_cache = {}


def active_store():
    """The store named by ``MXNET_TUNING_STORE``, or None (unset knob
    = no store, no file IO).  A missing or corrupt file is a loud
    failure — a deploy pointing at a store that is not there should
    not silently run defaults."""
    from ..config import get_env
    path = get_env("MXNET_TUNING_STORE")
    if not path:
        return None
    try:
        mtime = os.stat(path).st_mtime_ns
    except OSError:
        raise TuningStoreError(
            "MXNET_TUNING_STORE=%r but no store file is there" % path)
    cached = _cache.get(path)
    if cached is not None and cached[0] == mtime:
        return cached[1]
    store = TuningStore.load(path)
    _cache.clear()          # one active path at a time is the reality
    _cache[path] = (mtime, store)
    return store


def lookup(model, workload, device=None):
    """The active store's entry for ``(model, device, workload)``, or
    None when no store is configured / no entry matches.  *device* is a
    device-kind string, a ``torch.device`` or a Context (default: the
    process's device kind); it is resolved only when a store is set."""
    store = active_store()
    if store is None:
        return None
    if device is not None and not isinstance(device, str):
        device = device_kind(getattr(device, "torch_device", device))
    return store.get(model, workload, device=device)


def install(entry):
    """Apply a store entry's scalar knobs to the process-wide tuned
    layer (``config.tuned_override``) — the single-model replica
    path, where one tuning owns the process.  Structured params
    (``ladder``) are not env knobs and are skipped; returns the
    installed names.  Exported env vars still win at read time."""
    from ..config import _REGISTRY, tuned_override
    installed = []
    for name, value in (entry.get("config") or {}).items():
        if name in _REGISTRY:
            tuned_override(name, value)
            installed.append(name)
    return installed
