#!/usr/bin/env python3
"""Time variants of the port's tensor-core flash_fwd kernel on one GPU.

Each variant is ``mxnet_tpu_torch/csrc/flash_fwd.cu`` with three lines of
its tensor-core kernel replaced: the keys a k-tile at head dim 64
(``TcTile<64>``), the stages of the K/V ring (``kTcStages``) and the
consumer warpgroups of a block (``kTcConsumers``: 64 query rows each).
nvcc builds every variant at once under
``build/torch_kernels/tc_tiles/``; each is called through its plain C
entry at the paths' shape (B 8, H 16, S 2048, D 64, causal) in bfloat16
and float16, checked against the plain version (``_chunked_attention``,
the phase-3 limit of ``chip_smoke.o_error``), and timed with CUDA events
in the order given, then in reverse, so drift shows as a difference
between a variant's two readings.  ptxas's registers and spills of each
variant's bfloat16 D = 64 instantiation are printed beside it.

``--ablate`` times the shipped tiles beside variants that leave work out,
to show where the kernel's time goes (their outputs are wrong, so they
are timed, not checked): ``no-loads`` (the producer completes each stage
without a TMA load), ``loads-only`` (the consumers compute no k-tile),
``no-softmax``, ``qk-only`` and ``pv-only`` (no loads, no softmax and
one of the two products).

Usage: python3 tools/torch_flash_fwd_tc_tiles.py [BKxSTAGESxCONSUMERS ...]
(default: 128x4x2, the shipped tiles, then 128x3x2 128x2x2 64x4x2 64x4x3
64x3x3), or python3 tools/torch_flash_fwd_tc_tiles.py --ablate
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
TILE_LINE = "template <> struct TcTile<64> { static constexpr int BK = 128; };"
STAGES_LINE = "constexpr int kTcStages = 4;"
CONSUMERS_LINE = "constexpr int kTcConsumers = 2;"
DEFAULT = ("128x4x2", "128x3x2", "128x2x2", "64x4x2", "64x4x3", "64x3x3")
ENTRY = "flash_fwd_tc_kernelI13__nv_bfloat16Li64E"
# (line of the source, its replacement) of each piece of work an ablation
# variant leaves out
NO_LOADS = [
    ("mbar_expect_tx(full(st), 2 * S::kv);", "mbar_arrive(full(st));"),
    ("          tma_load(kst(st) + c * (BK * S::SW), &kmap, full(st), "
     "c * S::CB,\n                   t * BK, bh);\n          tma_load(kst(st) "
     "+ S::kv + c * (BK * S::SW), &vmap, full(st),\n                   "
     "c * S::CB, t * BK, bh);\n", "")]
NO_SOFTMAX = [("          softmax(t);\n", "")]
NO_QK = [("tc_qk<T, DP, BK, kTcBQ>(qw, stage(t), sc);", "wgmma_commit();")]
NO_PV = [("tc_pv<T, DP, BK>(stage(t - 1) + S::kv, p, acc);",
          "wgmma_commit();"),
         ("tc_pv<T, DP, BK>(stage(nkw - 1) + S::kv, p, acc);",
          "wgmma_commit();")]
ABLATIONS = {
    "no-loads": NO_LOADS,
    "loads-only": [(
        "const int nkw = causal ? min(nk, last < 0 ? 0 : last / BK + 1) "
        ": nk;", "const int nkw = 0;")],
    "no-softmax": NO_SOFTMAX,
    "qk-only": NO_LOADS + NO_SOFTMAX + NO_PV,
    "pv-only": NO_LOADS + NO_SOFTMAX + NO_QK,
}


def variant_source(text, bk, stages, consumers):
    for line in (TILE_LINE, STAGES_LINE, CONSUMERS_LINE):
        if text.count(line) != 1:
            raise SystemExit("flash_fwd.cu no longer has the line this tool "
                             "replaces: %s" % line)
    return text.replace(TILE_LINE, TILE_LINE.replace(
        "BK = 128", "BK = %d" % bk)).replace(
        STAGES_LINE, "constexpr int kTcStages = %d;" % stages).replace(
        CONSUMERS_LINE, "constexpr int kTcConsumers = %d;" % consumers)


def ablated_source(text, name):
    for line, repl in ABLATIONS[name]:
        if line not in text:
            raise SystemExit("flash_fwd.cu no longer has the line ablation "
                             "%s replaces: %s" % (name, line))
        text = text.replace(line, repl)
    return text


def build(name, text, out_dir):
    from mxnet_tpu_torch.ops import _cuda
    src = os.path.join(out_dir, name + ".cu")
    lib = os.path.join(out_dir, "lib%s.so" % name)
    with open(src, "w") as f:
        f.write(text)
    proc = subprocess.run(
        [_cuda._nvcc(), *_cuda.ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
         "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", _cuda.SOURCE_DIR,
         "-o", lib, src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed on %s:\n%s" % (name, proc.stdout))
    return lib, proc.stdout


def main(argv):
    sys.path.insert(0, ROOT)
    import torch
    from chip_smoke import kernel_bound_ms, o_error, ptxas_usage, time_ms
    from mxnet_tpu_torch.ops import attention as att
    if not torch.cuda.is_available():
        print("torch_flash_fwd_tc_tiles: needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    ablate = argv == ["--ablate"]
    specs = [] if ablate else argv or list(DEFAULT)
    with open(os.path.join(ROOT, "mxnet_tpu_torch", "csrc",
                           "flash_fwd.cu")) as f:
        text = f.read()
    out_dir = os.path.join(ROOT, "build", "torch_kernels", "tc_tiles")
    os.makedirs(out_dir, exist_ok=True)
    variants = {}
    for spec in specs:
        bk, stages, consumers = (int(x) for x in spec.split("x"))
        variants["flash_fwd_tc_%s" % spec] = variant_source(
            text, bk, stages, consumers)
    if ablate:
        variants["flash_fwd_tc_shipped"] = text
        for name in ABLATIONS:
            variants["flash_fwd_tc_%s" % name] = ablated_source(text, name)
    with concurrent.futures.ThreadPoolExecutor(len(variants)) as pool:
        built = dict(zip(variants, pool.map(
            lambda n: build(n, variants[n], out_dir), variants)))
    libs = {}
    for name, (path, log) in built.items():
        lib = ctypes.CDLL(path)
        att._bind_fwd(lib)
        libs[name] = lib
        for entry, u in ptxas_usage(log).items():
            if ENTRY in entry:
                print("%s: bf16 D=64 ptxas %s" % (name, u), flush=True)

    b, h, sq, sk, d = SHAPE
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    scale = 1.0 / math.sqrt(d)
    for dtn in ("bfloat16", "float16"):
        dt = getattr(torch, dtn)
        q, k, v = (torch.randn((b, h, s, d), generator=gen, device="cuda")
                   .to(dt) for s in (sq, sk, sk))
        want = att._chunked_attention(q, k, v, True, scale)
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
            if any(name.endswith(a) for a in ABLATIONS):
                continue   # work left out: timed, not checked
            err, ratio = o_error(torch, att, o, want, q, k, v, True, scale,
                                 dtn)
            if not ratio <= 1.0:
                raise RuntimeError("%s %s: max |o - plain| %g, %.3f of the "
                                   "limit" % (name, dtn, err, ratio))
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
