#!/usr/bin/env python3
"""Where the input side of chip_smoke.py's phase 12 spends its time on
the card (the PyTorch port, ``mxnet_tpu_torch``).

1. nvJPEG's batched call (``NvjpegDecodePool.decode_full``) on one batch
   of 128 of phase 12's JPEGs, at 1, 4 and 8 host workers.
2. The producer of ``ImageRecordIter`` (train_imagenet.py's config, 4
   threads) one epoch alone, then beside the fed ResNet-50 step
   (``Module.fit(device_prefetch=2)``, phase 12 (e)), with the prefetch
   threads' streams at normal and at high priority, in turns: per batch,
   the nvJPEG call, the native route (decode + geometry + float
   conversion) and the whole ``next``, host clock.

Needs one NVIDIA GPU.  Run from the root of a checkout::

    python3 tools/torch_data_probe.py
"""

from __future__ import annotations

import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def ms(values):
    return "[%s]" % ", ".join("%.1f" % (1e3 * v) for v in values)


def thread_scaling(torch, np, nd_, bufs, dev):
    for threads in (1, 4, 8):
        pool = nd_.NvjpegDecodePool(threads, (224, 224), device=dev)
        hw, _ = pool.info(bufs)
        times = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pool.decode_full(bufs, hw)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        print("nvJPEG call, 128 images, %d workers: %s ms (first includes "
              "start-up)" % (threads, ms(times)), flush=True)


def producer(torch, chip_smoke, mx, nd_, img_mod, io_mod, ctx, prefix, sym,
             weights):
    log = []
    real_full = nd_.NvjpegDecodePool.decode_full
    real_native = img_mod.ImageIter._next_native
    real_next = img_mod.ImageIter.next
    real_stager = io_mod._Stager.__init__

    def timed(name, fn):
        def wrapper(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            log.append((name, time.perf_counter() - t0))
            return out
        return wrapper

    nd_.NvjpegDecodePool.decode_full = timed("nvjpeg", real_full)
    img_mod.ImageIter._next_native = timed("native", real_native)
    img_mod.ImageIter.next = timed("next", real_next)
    runs = [("alone", 0)] + [("beside the step", p)
                             for p in (0, -1, -1, 0)]
    for mode, priority in runs:
        def stager(self, device, priority=priority):
            real_stager(self, device)
            self.stream = torch.cuda.Stream(device, priority=priority)
        io_mod._Stager.__init__ = stager
        del log[:]
        it = chip_smoke.data_iter(mx, ctx, prefix, 224, 128, 4, 0)
        rec = None
        if mode == "alone":
            for _ in it:
                pass
            torch.cuda.synchronize()
        else:
            mod, rec = chip_smoke.data_fit(torch, mx, ctx, sym, weights, it,
                                           128, 2)
            del mod
        it.close()
        by = {}
        for name, v in log:
            by.setdefault(name, []).append(v)
        print("producer %s (stream priority %d): %s" % (
            mode, priority, "; ".join("%s %s ms" % (k, ms(v))
                                      for k, v in by.items())), flush=True)
        if rec is not None:
            step_ms, ips = chip_smoke.fit_rate(rec, 128)
            print("  fit: %.2f ms a batch, %.1f images/s over batches 3-10, "
                  "steps stalled %d, ring occupancy %s" % (
                      step_ms, ips, rec["stalled"], rec["occupancy"]),
                  flush=True)


def main():
    sys.path.insert(0, HERE)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_data_probe: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import chip_smoke
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import recordio
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.image import image as img_mod
    from mxnet_tpu_torch.io import io as io_mod
    from mxnet_tpu_torch.io import native_decode as nd_
    card = chip_smoke.phase_device(torch)
    print("nproc %d" % len(os.sched_getaffinity(0)), flush=True)
    tmp = tempfile.mkdtemp(prefix="torch_data_probe_")
    prefix, _, _, _ = chip_smoke.data_records(
        np, recordio, tmp, 0, chip_smoke.DATA_EXAMPLES,
        chip_smoke.DATA_SIDES, chip_smoke.DATA_CLASSES)
    reader = recordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec",
                                        "r")
    bufs = [recordio.unpack(reader.read_idx(k))[1]
            for k in reader.keys[:128]]
    reader.close()
    dev = torch.device("cuda", 0)
    thread_scaling(torch, np, nd_, bufs, dev)
    ctx = mx.gpu(0)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(12)
    sym, args, auxs = chip_smoke.data_symbol(
        mx, vision, ctx, gen, 224, {"name": chip_smoke.RESNET,
                                    "classes": chip_smoke.DATA_CLASSES})
    producer(torch, chip_smoke, mx, nd_, img_mod, io_mod, ctx, prefix, sym,
             (args, auxs))
    print("on %s" % card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
