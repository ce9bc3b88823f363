#!/usr/bin/env python3
"""Time tile shapes of the port's flash_fwd kernel on one NVIDIA GPU.

Each variant is ``mxnet_tpu_torch/csrc/flash_fwd.cu`` with the D = 64 row
of its tile table (``FwdTile<64>``: queries a block, keys a k-tile) and
the kernel's blocks-an-SM hint (``__launch_bounds__``) replaced.  nvcc
builds every variant at once under ``build/torch_kernels/tiles/``; each is
called through its plain C entry at the paths' shape (B 8, H 16, S 2048,
D 64, causal), checked against the shipped kernel (same function, another
f32 summation order: max |diff| <= 1e-4), and timed with CUDA events in
the order given, then in reverse, so drift shows as a difference between
a variant's two readings.

Usage: python3 tools/torch_flash_fwd_tiles.py [BQxBKxMINB ...]
(default: 128x64x1 128x32x1 128x32x2 64x64x1 64x64x2)
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import math
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (8, 16, 2048, 2048, 64)
TILE_LINE = ("template <> struct FwdTile<64> { static constexpr int BQ = 128, "
             "BK = 64; };")
BOUNDS = "__launch_bounds__(kThreads, 1)"
DEFAULT = ("128x64x1", "128x32x1", "128x32x2", "64x64x1", "64x64x2")


def variant_source(text, bq, bk, minb):
    if TILE_LINE not in text or BOUNDS not in text:
        raise SystemExit("flash_fwd.cu no longer has the lines this tool "
                         "replaces")
    return text.replace(TILE_LINE, TILE_LINE.replace(
        "BQ = 128, BK = 64", "BQ = %d, BK = %d" % (bq, bk))).replace(
        BOUNDS, "__launch_bounds__(kThreads, %d)" % minb)


def build(name, text, out_dir):
    from mxnet_tpu_torch.ops import _cuda
    src = os.path.join(out_dir, name + ".cu")
    lib = os.path.join(out_dir, "lib%s.so" % name)
    with open(src, "w") as f:
        f.write(text)
    proc = subprocess.run(
        [_cuda._nvcc(), *_cuda.ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
         "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", lib, src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed on %s:\n%s" % (name, proc.stdout))
    return lib, proc.stdout


def main(argv):
    sys.path.insert(0, ROOT)
    import torch
    from chip_smoke import kernel_bound_ms, ptxas_usage, time_ms
    from mxnet_tpu_torch.ops import attention as att
    if not torch.cuda.is_available():
        print("torch_flash_fwd_tiles: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    specs = argv or list(DEFAULT)
    with open(os.path.join(ROOT, "mxnet_tpu_torch", "csrc",
                           "flash_fwd.cu")) as f:
        text = f.read()
    out_dir = os.path.join(ROOT, "build", "torch_kernels", "tiles")
    os.makedirs(out_dir, exist_ok=True)
    variants = {}
    for spec in specs:
        bq, bk, minb = (int(x) for x in spec.split("x"))
        variants["flash_fwd_%s" % spec] = variant_source(text, bq, bk, minb)
    with concurrent.futures.ThreadPoolExecutor(len(variants)) as pool:
        built = dict(zip(variants, pool.map(
            lambda n: build(n, variants[n], out_dir), variants)))
    libs = {}
    for name, (path, log) in built.items():
        lib = ctypes.CDLL(path)
        att._bind_fwd(lib)
        libs[name] = lib
        for entry, u in ptxas_usage(log).items():
            if "flash_fwd_kernelIfLi64E" in entry:
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
        q, k, v = (torch.randn((b, h, s, d), generator=gen, device="cuda")
                   .to(dt) for s in (sq, sk, sk))
        want = att.flash_fwd(q, k, v, True, scale)
        stream = torch.cuda.current_stream().cuda_stream
        o = torch.empty_like(q)

        def run(lib):
            rc = lib.flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               o.data_ptr(), None, b * h, sq, sk, d, scale,
                               1, att._KERNEL_DTYPES[dt], stream)
            if rc != 0:
                raise RuntimeError("launch failed with CUDA error %d" % rc)
        times = {n: [] for n in libs}
        for name, lib in libs.items():
            run(lib)
            torch.cuda.synchronize()
            diff = (o.float() - want.float()).abs().max().item()
            tol = 1e-4 if dtn == "float32" else 2.0 ** -6
            if not diff <= tol:
                raise RuntimeError("%s %s: max |diff| %g against the shipped "
                                   "kernel" % (name, dtn, diff))
        for name in list(libs) + list(libs)[::-1]:
            times[name].append(time_ms(torch, lambda: run(libs[name]), 20))
        bound, _ = kernel_bound_ms("flash_fwd", b, h, sq, sk, d, True, dtn,
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
