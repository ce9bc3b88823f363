"""Symbol name management (port of ``mxnet_tpu/name.py``):
``with mx.name.Prefix('layer1_'):`` prepends a prefix to every
auto-generated symbol name in scope; ``NameManager()`` installs a fresh
counter scope."""

from __future__ import annotations

from .symbol.symbol import _NameManager

__all__ = ["NameManager", "Prefix", "current"]


class NameManager:
    """Context manager installing a fresh name counter scope."""

    def __enter__(self):
        self._saved = getattr(_NameManager._tls, "inst", None)
        _NameManager._tls.inst = _NameManager()
        return _NameManager._tls.inst

    def __exit__(self, *exc):
        if self._saved is None:
            del _NameManager._tls.inst
        else:
            _NameManager._tls.inst = self._saved
        return False


class Prefix(NameManager):
    """Prefix every auto-generated symbol name in scope."""

    def __init__(self, prefix):
        self._prefix = prefix

    def __enter__(self):
        mgr = super().__enter__()
        base_fresh = mgr.fresh
        mgr.fresh = lambda hint: self._prefix + base_fresh(hint)
        return mgr


def current():
    """The active name manager."""
    return _NameManager.get()
