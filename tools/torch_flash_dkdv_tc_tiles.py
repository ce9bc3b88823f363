#!/usr/bin/env python3
"""Time variants of the port's tensor-core flash_bwd_dkdv kernel on one GPU.

Each variant is ``mxnet_tpu_torch/csrc/flash_bwd.cu`` with lines of its
tensor-core dK/dV kernel replaced: the queries a q-tile at head dim 64
(``DkdvTcTile<64>``), the stages of the Q/dO ring (``kDkStages``), and
optionally the grid (``sm``: one persistent block an SM walking the
slots, instead of one block a slot) and the head chunks (``flat``: one
chunk of every head instead of chunks whose Q and dO fit in a third of
L2).  nvcc builds every variant at once under
``build/torch_kernels/dkdv_tc_tiles/``; each is called through its plain C
entry at the paths' shape (B 8, H 16, S 2048, D 64, causal) in bfloat16
and float16, checked against the plain version
(``_flash_bwd_dkdv_plain``, the phase-3 limit of ``chip_smoke.bwd_error``),
and timed with CUDA events in the order given, then in reverse, so drift
shows as a difference between a variant's two readings.  ptxas's
registers and spills of each variant's bfloat16 D = 64 instantiation are
printed beside it.

``--ablate`` times the shipped tiles beside variants that leave work out
(their outputs are wrong, so they are timed, not checked): ``no-loads``
(the producer completes each stage without a TMA load), ``no-grads`` (p
and ds are not computed: the products run on the raw accumulators),
``sdp-only`` (S^T and dP^T alone, no loads) and ``dkdv-only`` (dV and dK
alone, no loads).

Usage: python3 tools/torch_flash_dkdv_tc_tiles.py [BQxSTAGES[-sm][-flat] ...]
(default: 64x3, the shipped tiles, then 64x2 64x4 64x6 32x3 64x3-sm
64x3-flat), or python3 tools/torch_flash_dkdv_tc_tiles.py --ablate
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
from torch_flash_fwd_tiles import build  # noqa: E402

SHAPE = (8, 16, 2048, 2048, 64)
TILE_LINE = "template <> struct DkdvTcTile<64> { static constexpr int BQ = 64; };"
STAGES_LINE = "constexpr int kDkStages = 3;"
GRID_LINE = "const long long grid = std::min<long long>(tiles, INT_MAX);"
SM_GRID = ("int dev = 0, sms = 0;\n  cudaGetDevice(&dev);\n  "
           "cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, "
           "dev);\n  const long long grid = std::min<long long>(tiles, sms);")
L2_LINE = "constexpr long long kDkL2Bytes = 16LL << 20;"
DEFAULT = ("64x3", "64x2", "64x4", "64x6", "32x3", "64x3-sm", "64x3-flat")
ENTRY = "flash_bwd_dkdv_tc_kernelI13__nv_bfloat16Li64E"
NO_LOADS = [
    ("mbar_expect_tx(full(st), 2 * S::rows);", "mbar_arrive(full(st));"),
    ("            tma_load(qst(st) + c * (BQ * L::SW), &qmap, full(st),\n"
     "                     c * L::CB, q_begin + t * BQ, bh);\n"
     "            tma_load(qst(st) + S::rows + c * (BQ * L::SW), &omap, "
     "full(st),\n                     c * L::CB, q_begin + t * BQ, bh);\n",
     "")]
NO_GRADS = [("    auto grads = [&](int t) {\n",
             "    auto grads = [&](int t) {\n      return;\n")]
NO_SDP = [("      tc_qk<T, DP, BQ, kDkBK>(kw, qs, sc);\n"
           "      tc_qk<T, DP, BQ, kDkBK>(vw, qs + S::rows, dpc);\n",
           "      wgmma_commit();\n      wgmma_commit();\n")]
NO_DKDV = [("      tc_pv<T, DP, BQ>(qs + S::rows, pk, dva);\n"
            "      tc_pv<T, DP, BQ>(qs, dsk, dka);\n",
            "      wgmma_commit();\n      wgmma_commit();\n")]
ABLATIONS = {
    "no-loads": NO_LOADS,
    "no-grads": NO_GRADS,
    "sdp-only": NO_LOADS + NO_GRADS + NO_DKDV,
    "dkdv-only": NO_LOADS + NO_GRADS + NO_SDP,
}


def replace_once(text, line, repl, what):
    if text.count(line) != 1:
        raise SystemExit("flash_bwd.cu no longer has the line %s replaces: "
                         "%s" % (what, line))
    return text.replace(line, repl)


def variant_source(text, spec):
    head, *opts = spec.split("-")
    bq, stages = (int(x) for x in head.split("x"))
    text = replace_once(text, TILE_LINE,
                        TILE_LINE.replace("BQ = 64", "BQ = %d" % bq), spec)
    text = replace_once(text, STAGES_LINE,
                        "constexpr int kDkStages = %d;" % stages, spec)
    for opt in opts:
        if opt == "sm":
            text = replace_once(text, GRID_LINE, SM_GRID, spec)
        elif opt == "flat":
            text = replace_once(text, L2_LINE,
                                "constexpr long long kDkL2Bytes = 1LL << 62;",
                                spec)
        else:
            raise SystemExit("unknown option %r in %s" % (opt, spec))
    return text


def ablated_source(text, name):
    for line, repl in ABLATIONS[name]:
        text = replace_once(text, line, repl, "ablation " + name)
    return text


def main(argv):
    sys.path.insert(0, ROOT)
    import torch
    from chip_smoke import (bwd_error, bwd_inputs, bwd_magnitudes,
                            kernel_bound_ms, ptxas_usage, time_ms)
    from mxnet_tpu_torch.ops import attention as att
    if not torch.cuda.is_available():
        print("torch_flash_dkdv_tc_tiles: needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    ablate = argv == ["--ablate"]
    specs = [] if ablate else argv or list(DEFAULT)
    with open(os.path.join(ROOT, "mxnet_tpu_torch", "csrc",
                           "flash_bwd.cu")) as f:
        text = f.read()
    out_dir = os.path.join(ROOT, "build", "torch_kernels", "dkdv_tc_tiles")
    os.makedirs(out_dir, exist_ok=True)
    variants = {}
    for spec in specs:
        variants["dkdv_tc_%s" % spec] = variant_source(text, spec)
    if ablate:
        variants["dkdv_tc_shipped"] = text
        for name in ABLATIONS:
            variants["dkdv_tc_%s" % name] = ablated_source(text, name)
    with concurrent.futures.ThreadPoolExecutor(len(variants)) as pool:
        built = dict(zip(variants, pool.map(
            lambda n: build(n, variants[n], out_dir), variants)))
    libs = {}
    for name, (path, log) in built.items():
        lib = ctypes.CDLL(path)
        att._bind_bwd(lib)
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
    for dtn in ("bfloat16", "float16"):
        dt = getattr(torch, dtn)
        q, k, v, do, o, lse, delta, scale = bwd_inputs(
            torch, att, gen, b, h, sq, sk, d, True, dt)
        if att._dkdv_route(dt, d, att._aligned16(q, k, v, do)) != "wgmma":
            raise RuntimeError("the inputs do not take the wgmma route")
        want = att._flash_bwd_dkdv_plain(q, k, v, do, lse, delta, True, scale)
        _, m_dk, m_dv = bwd_magnitudes(torch, att, q, k, v, do, lse, delta,
                                       True, scale)
        stream = torch.cuda.current_stream().cuda_stream
        dk, dv = torch.empty_like(k), torch.empty_like(v)

        def run(lib):
            rc = lib.flash_bwd_dkdv(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), b * h, sq, sk, d, scale, 1,
                att._KERNEL_DTYPES[dt], stream)
            if rc != 0:
                raise RuntimeError("launch failed with CUDA error %d" % rc)
        times = {n: [] for n in libs}
        for name, lib in libs.items():
            run(lib)
            torch.cuda.synchronize()
            if any(name.endswith(a) for a in ABLATIONS):
                continue   # work left out: timed, not checked
            ratio = max(bwd_error(torch, dk, want[0], m_dk, dtn)[1],
                        bwd_error(torch, dv, want[1], m_dv, dtn)[1])
            if not ratio <= 1.0:
                raise RuntimeError("%s %s: %.3f of the limit"
                                   % (name, dtn, ratio))
            print("%s %s: worst error/limit %.3f" % (name, dtn, ratio),
                  flush=True)
        for name in list(libs) + list(libs)[::-1]:
            times[name].append(time_ms(torch, lambda: run(libs[name]), 20))
        bound, _ = kernel_bound_ms("flash_bwd_dkdv", b, h, sq, sk, d, True,
                                   dtn, q.element_size())
        for name, ts in times.items():
            print("%s %s b%d h%d s%d d%d causal on %s: %s ms (bound %.4f, "
                  "%.1f %% of it at the mean)" % (
                      name, dtn, b, h, sq, d, card,
                      ", ".join("%.4f" % t for t in ts), bound,
                      100.0 * bound / (sum(ts) / len(ts))), flush=True)
        del q, k, v, do, o, lse, delta, want, m_dk, m_dv, dk, dv
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
