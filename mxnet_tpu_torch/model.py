"""Checkpoints, ``BatchEndParam`` and the one-call ``fit`` (port of
``mxnet_tpu/model.py``).

The reference's layout: ``prefix-symbol.json`` (the graph) and
``prefix-NNNN.params`` (tensors keyed ``arg:<name>`` / ``aux:<name>``),
shared with the JAX package in both directions.  The JAX package's
checksum manifest is not written here.
"""

from __future__ import annotations

import logging
from collections import namedtuple

from . import ndarray as nd
from . import symbol as sym_mod

__all__ = ["BatchEndParam", "save_checkpoint", "load_checkpoint", "fit"]

BatchEndParam = namedtuple("BatchEndParams",
                           ["epoch", "nbatch", "eval_metric", "locals"])


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
    arg_params, aux_params = _split_save_dict(
        save_dict, context="checkpoint %r epoch %d" % (prefix, epoch))
    return symbol, arg_params, aux_params


def _split_save_dict(save_dict, context="params file"):
    """(arg_params, aux_params) of an ``arg:``/``aux:``-keyed dict; other
    keys are skipped with a warning (a foreign or corrupt file)."""
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
            "%s: skipped %d key(s) without an 'arg:' or 'aux:' prefix "
            "(%s)", context, len(unknown),
            ", ".join(repr(k) for k in unknown[:5]))
    return arg_params, aux_params


def fit(symbol, train_data, eval_data=None, num_epoch=None, ctx=None,
        eval_metric="acc", optimizer="sgd",
        optimizer_params=(("learning_rate", 0.01),), kvstore="local",
        data_names=("data",), label_names=("softmax_label",),
        logger=None, **kwargs):
    """Build a Module over *symbol* on *ctx* and run its ``fit``; returns
    the trained Module."""
    from .module import Module
    module = Module(symbol, data_names=data_names, label_names=label_names,
                    logger=logger or logging, context=ctx)
    module.fit(train_data, eval_data=eval_data, eval_metric=eval_metric,
               kvstore=kvstore, optimizer=optimizer,
               optimizer_params=optimizer_params, num_epoch=num_epoch,
               **kwargs)
    return module
