"""Checkpoints (port of ``mxnet_tpu/model.py``, subset).

The reference's layout: ``prefix-symbol.json`` (the graph) and
``prefix-NNNN.params`` (tensors keyed ``arg:<name>`` / ``aux:<name>``),
shared with the JAX package in both directions.  The JAX package's
checksum manifest is not written here.
"""

from __future__ import annotations

import logging

from . import ndarray as nd
from . import symbol as sym_mod

__all__ = ["save_checkpoint", "load_checkpoint"]


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params):
    """Write ``prefix-symbol.json`` and ``prefix-%04d.params``."""
    symbol.save("%s-symbol.json" % prefix)
    save_dict = {"arg:%s" % k: v for k, v in arg_params.items()}
    save_dict.update({"aux:%s" % k: v for k, v in (aux_params or {}).items()})
    nd.save("%s-%04d.params" % (prefix, epoch), save_dict)


def load_checkpoint(prefix, epoch, ctx=None):
    """Returns (symbol, arg_params, aux_params), the arrays on *ctx*
    (default: the current context)."""
    symbol = sym_mod.load("%s-symbol.json" % prefix)
    save_dict = nd.load("%s-%04d.params" % (prefix, epoch), ctx=ctx)
    arg_params, aux_params, unknown = {}, {}, []
    for k, v in save_dict.items():
        tp, _, name = k.partition(":")
        if tp == "arg":
            arg_params[name] = v
        elif tp == "aux":
            aux_params[name] = v
        else:
            unknown.append(k)
    if unknown:
        logging.getLogger(__name__).warning(
            "checkpoint %r epoch %d: skipped %d key(s) without an 'arg:' "
            "or 'aux:' prefix (%s)", prefix, epoch, len(unknown),
            ", ".join(repr(k) for k in unknown[:5]))
    return symbol, arg_params, aux_params
