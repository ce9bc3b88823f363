"""Scoped symbol attributes (port of ``mxnet_tpu/attribute.py``): ``with
mx.attribute.AttrScope(ctx_group='dev1'):`` tags every symbol created in
scope."""

from __future__ import annotations

from .symbol.symbol import AttrScope

__all__ = ["AttrScope"]
