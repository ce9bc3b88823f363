#!/usr/bin/env python3
"""Time tile shapes of the port's flash_bwd_dq kernel on one NVIDIA GPU.

Each variant is ``mxnet_tpu_torch/csrc/flash_bwd.cu`` with the D = 64 row
of dq's tile table (``DqTile<64>``: queries a block, keys a k-tile, and how
often the loops over the head dim (UA) and over the keys (UB) are
unrolled) and the kernel's blocks-an-SM hint (``__launch_bounds__``)
replaced.  nvcc builds every variant at once under
``build/torch_kernels/tiles/``; each is called through its plain C entry
at the paths' shape (B 8, H 16, S 2048, D 64, causal), must give the
shipped kernel's bits (the tile shape does not change any element's
summation order), and is timed with CUDA events in the order given, then
in reverse, so drift shows as a difference between a variant's two
readings.

Usage: python3 tools/torch_flash_dq_tiles.py [BQxBKxUAxUBxMINB ...]
(default: 128x64x4x4x1 128x64x2x4x1 128x64x4x2x1 128x32x2x4x1 64x64x2x4x1
64x32x2x4x2)
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import math
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_flash_fwd_tiles import build  # noqa: E402

SHAPE = (8, 16, 2048, 2048, 64)
TILE_LINE = ("template <> struct DqTile<64> { static constexpr int BQ = 128, "
             "BK = 64, UA = 4, UB = 4; };")
TILE_VALUES = "BQ = 128, BK = 64, UA = 4, UB = 4"
BOUNDS = ("__global__ void __launch_bounds__(kThreads, 1)\n"
          "flash_bwd_dq_kernel(")
DEFAULT = ("128x64x4x4x1", "128x64x2x4x1", "128x64x4x2x1", "128x32x2x4x1",
           "64x64x2x4x1", "64x32x2x4x2")


def variant_source(text, bq, bk, ua, ub, minb):
    if TILE_LINE not in text or BOUNDS not in text:
        raise SystemExit("flash_bwd.cu no longer has the lines this tool "
                         "replaces")
    return text.replace(TILE_LINE, TILE_LINE.replace(
        TILE_VALUES, "BQ = %d, BK = %d, UA = %d, UB = %d"
        % (bq, bk, ua, ub))).replace(
        BOUNDS, BOUNDS.replace("kThreads, 1", "kThreads, %d" % minb))


def main(argv):
    sys.path.insert(0, ROOT)
    import torch
    from chip_smoke import kernel_bound_ms, ptxas_usage, time_ms
    from mxnet_tpu_torch.ops import attention as att
    if not torch.cuda.is_available():
        print("torch_flash_dq_tiles: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    specs = argv or list(DEFAULT)
    with open(os.path.join(ROOT, "mxnet_tpu_torch", "csrc",
                           "flash_bwd.cu")) as f:
        text = f.read()
    out_dir = os.path.join(ROOT, "build", "torch_kernels", "tiles")
    os.makedirs(out_dir, exist_ok=True)
    variants = {}
    for spec in specs:
        bq, bk, ua, ub, minb = (int(x) for x in spec.split("x"))
        variants["flash_bwd_dq_%s" % spec] = variant_source(
            text, bq, bk, ua, ub, minb)
    with concurrent.futures.ThreadPoolExecutor(len(variants)) as pool:
        built = dict(zip(variants, pool.map(
            lambda n: build(n, variants[n], out_dir), variants)))
    libs = {}
    for name, (path, log) in built.items():
        lib = ctypes.CDLL(path)
        att._bind_bwd(lib)
        libs[name] = lib
        for entry, u in ptxas_usage(log).items():
            if "flash_bwd_dq_kernelIfLi64E" in entry:
                print("%s: f32 D=64 ptxas %s" % (name, u), flush=True)

    b, h, sq, sk, d = SHAPE
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    scale = 1.0 / math.sqrt(d)
    for dtn in ("float32", "bfloat16"):
        dt = getattr(torch, dtn)
        q, k, v, do = (torch.randn((b, h, s, d), generator=gen,
                                   device="cuda").to(dt)
                       for s in (sq, sk, sk, sq))
        o, lse = att.flash_fwd(q, k, v, True, scale, with_lse=True)
        delta = att._delta(o, do)
        want = att.flash_bwd_dq(q, k, v, do, lse, delta, True, scale)
        stream = torch.cuda.current_stream().cuda_stream
        dq = torch.empty_like(q)

        def run(lib):
            rc = lib.flash_bwd_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                  do.data_ptr(), lse.data_ptr(),
                                  delta.data_ptr(), dq.data_ptr(), b * h, sq,
                                  sk, d, scale, 1, att._KERNEL_DTYPES[dt],
                                  stream)
            if rc != 0:
                raise RuntimeError("launch failed with CUDA error %d" % rc)
        times = {n: [] for n in libs}
        for name, lib in libs.items():
            dq.zero_()
            run(lib)
            torch.cuda.synchronize()
            if not torch.equal(dq, want):
                raise RuntimeError("%s %s: max |diff| %g against the shipped "
                                   "kernel, which must be bit-equal" % (
                                       name, dtn, (dq.float() - want.float())
                                       .abs().max().item()))
        for name in list(libs) + list(libs)[::-1]:
            times[name].append(time_ms(torch, lambda: run(libs[name]), 20))
        bound, _ = kernel_bound_ms("flash_bwd_dq", b, h, sq, sk, d, True, dtn,
                                   q.element_size())
        for name, ts in times.items():
            print("%s %s b%d h%d s%d d%d causal on %s: %s ms (bound %.4f, "
                  "%.1f %% of it at the mean)" % (
                      name, dtn, b, h, sq, d, card,
                      ", ".join("%.4f" % t for t in ts), bound,
                      100.0 * bound / (sum(ts) / len(ts))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
