"""Training callbacks (port of ``mxnet_tpu/callback.py``: do_checkpoint,
module_checkpoint, log_train_metric, Speedometer, ProgressBar)."""

from __future__ import annotations

import logging
import math
import time

__all__ = ["Speedometer", "do_checkpoint", "log_train_metric",
           "ProgressBar", "module_checkpoint"]


def do_checkpoint(prefix, period=1):
    """Epoch-end callback writing prefix-symbol.json and
    prefix-NNNN.params every *period* epochs."""
    from .model import save_checkpoint
    period = int(max(1, period))

    def _callback(iter_no, sym, arg, aux):
        if (iter_no + 1) % period == 0:
            save_checkpoint(prefix, iter_no + 1, sym, arg, aux)
    return _callback


def module_checkpoint(mod, prefix, period=1, save_optimizer_states=False):
    """Epoch-end callback running ``mod.save_checkpoint`` every *period*
    epochs (optionally with the optimizer states)."""
    period = int(max(1, period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            mod.save_checkpoint(prefix, iter_no + 1, save_optimizer_states)
    return _callback


def log_train_metric(period, auto_reset=False):
    """Batch-end callback logging the metric every *period* batches."""
    def _callback(param):
        if param.nbatch % period == 0 and param.eval_metric is not None:
            for name, value in param.eval_metric.get_name_value():
                logging.info("Iter[%d] Batch[%d] Train-%s=%f",
                             param.epoch, param.nbatch, name, value)
            if auto_reset:
                param.eval_metric.reset()
    return _callback


class Speedometer:
    """Batch-end callback: every *frequent* batches, log samples/sec and
    the metric (then reset it, with *auto_reset*).  ``rate`` keeps the
    last window's samples/sec."""

    def __init__(self, batch_size, frequent=50, auto_reset=True):
        self.batch_size = batch_size
        self.frequent = frequent
        self.auto_reset = auto_reset
        self.rate = None
        self._window_start = None
        self._prev_batch = -1

    def __call__(self, param):
        batch = param.nbatch
        if batch < self._prev_batch or self._window_start is None:
            # a new epoch (the batch count restarted): restart the window
            self._window_start = time.perf_counter()
            self._prev_batch = batch
            return
        self._prev_batch = batch
        if batch == 0 or batch % self.frequent:
            return
        elapsed = time.perf_counter() - self._window_start
        self.rate = (self.frequent * self.batch_size / elapsed) if elapsed \
            else float("inf")
        parts = ["Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec"
                 % (param.epoch, batch, self.rate)]
        metric = param.eval_metric
        if metric is not None:
            parts += ["%s=%f" % kv for kv in metric.get_name_value()]
            if self.auto_reset:
                metric.reset()
        logging.info("\t".join(parts))
        self._window_start = time.perf_counter()


class ProgressBar:
    """Batch-end callback logging a text progress bar of *total* batches."""

    def __init__(self, total, length=80):
        self.bar_len = length
        self.total = total

    def __call__(self, param):
        count = param.nbatch
        filled_len = int(round(self.bar_len * count / float(self.total)))
        percents = math.ceil(100.0 * count / float(self.total))
        prog_bar = "=" * filled_len + "-" * (self.bar_len - filled_len)
        logging.info("[%s] %s%s\r", prog_bar, percents, "%")
