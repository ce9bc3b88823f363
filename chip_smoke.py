#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``mxnet_tpu_torch``) on one NVIDIA GPU.

Phases, each reported on its own line; any failure exits non-zero:

1. device  — require CUDA; print ``nvidia-smi`` name and power limit.
2. build   — compile every hand-written kernel of the path from
             ``mxnet_tpu_torch/csrc`` with nvcc for sm_90a.
3. kernel  — hold each kernel against its plain PyTorch version on the
             card over a grid of cases, then time kernel, plain version
             and one PyTorch library call at the serving path's shape.
4. serve   — the main path at full width: build the transformer LM
             (vocab 32000, dim 1024, heads 16, 12 layers, seq 2048),
             hybridize, forward, export a checkpoint, load it into a
             ``serve.ModelRegistry`` and answer requests of 1, 3 and 8
             rows.  Every answer is checked against the same exported
             graph evaluated with the plain attention, and the kernel
             launch counts show the path ran the kernel.

The line before the last is a JSON object ``{"kernels": [...]}``; the last
line is ``{"ok": true, "device": {...}}``.

Usage: python3 chip_smoke.py [--seed 0]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# the serving path's shape: batch 8 (top rung), 16 heads, seq 2048, d 64
PATH_SHAPE = (8, 16, 2048, 2048, 64)
VOCAB, DIM, HEADS, LAYERS, SEQ = 32000, 1024, 16, 12, 2048
KERNELS = ("flash_fwd",)
RUNGS = (1, 2, 4, 8)
REQUESTS = (1, 3, 8)

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, FLOP/s by type
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "float16": 989e12}

# kernel vs plain tolerances.  Both compute the same f32 online softmax
# over exact f32 products of the storage dtype; they differ only in f32
# summation order.  f32 o is held to one absolute limit.  For a 16-bit
# dtype each rounds every p to v's dtype, relative to its own running
# max, so each p carries its own relative error of at most u = 2**-(bits
# + 1); the two o differ by at most 2u * A, A = sum_j p_j |v_j| / l (the
# attention of |v|), before each rounds o once.  So a 16-bit o is held per
# element to 2**-bits * A + 2 ulps of the dtype at |plain|.
TOL_F32 = 1e-4
ULP_BITS = {"bfloat16": 7, "float16": 10}       # explicit mantissa bits
TOL_LSE = 1e-4
# served logits vs the plain-attention graph, relative to max |logit|
TOL_SERVE = 1e-3


def log(*a):
    print(*a, flush=True)


def o_error(torch, att, got, want, q, k, v, causal, scale, dtn):
    """(max |got - want|, worst ratio of error to its limit)."""
    err = (got.float() - want.float()).abs()
    if dtn == "float32":
        tol = torch.full_like(err, TOL_F32)
    else:
        bits = ULP_BITS[dtn]
        mag = want.float().abs().clamp_min(2.0 ** -24)
        ulp = torch.exp2(torch.floor(torch.log2(mag)) - bits)
        a = att._chunked_attention(q.float(), k.float(), v.float().abs(),
                                   causal, scale)
        tol = 2 * ulp + 2.0 ** -bits * a
    return err.max().item(), (err / tol).max().item()


def time_ms(torch, fn, iters, warmup=2):
    """Mean ms of *fn* over *iters* runs, timed with CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def visible_pairs(sq, sk, causal):
    """(query, key) pairs the attention must compute for these lengths."""
    if not causal:
        return sq * sk
    off = sk - sq
    return sum(max(0, min(sk, i + 1 + off)) for i in range(sq))


def attention_bound_ms(b, h, sq, sk, d, causal, dtype, itemsize, with_lse):
    """Least time the card could take: the larger of this work's flops
    over the dtype's peak and its bytes (q, k, v read once, o and lse
    written once) over HBM bandwidth.  Returns (ms, 'operations'|'bytes')."""
    flops = 4.0 * d * b * h * visible_pairs(sq, sk, causal)
    nbytes = (2 * b * h * sq * d + 2 * b * h * sk * d) * itemsize
    if with_lse:
        nbytes += b * h * sq * 4
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, \
        "operations" if t_ops >= t_bytes else "bytes"


def phase_device(torch):
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    card = smi[torch.cuda.current_device()].strip()
    log("card: %s" % card)
    log("device: %s, count %d, torch %s, cuda %s" % (
        torch.cuda.get_device_name(0), torch.cuda.device_count(),
        torch.__version__, torch.version.cuda))
    # f32 products stay full f32 everywhere (the JAX package's HIGHEST)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


def phase_build():
    from mxnet_tpu_torch.ops import _cuda
    for name in KERNELS:
        info = _cuda.build(name)
        log("build: %s in %.2f s (nvcc %s)" % (
            name, info["seconds"], " ".join(_cuda.ARCH_FLAGS)))
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                log("  ptxas %s: %s" % (name, line.strip()))


def _rand(torch, shape, dtype, gen):
    return torch.randn(shape, generator=gen, device="cuda",
                       dtype=torch.float32).to(dtype)


def tol_text(dtn):
    if dtn == "float32":
        return "%g" % TOL_F32
    return "2 ulp(|plain|) + 2**-%d * attention of |v|" % ULP_BITS[dtn]


def phase_kernel(torch, card, seed):
    from mxnet_tpu_torch.ops import attention as att
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    dts = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}
    # (b, h, sq, sk, d, causal, dtype, with_lse)
    cases = [
        (2, 4, 256, 256, 64, True, "float32", True),
        (2, 4, 256, 256, 64, False, "float32", False),
        (2, 4, 256, 256, 64, True, "bfloat16", True),
        (2, 4, 256, 256, 64, False, "bfloat16", False),
        (1, 2, 256, 256, 64, True, "float16", True),
        (1, 4, 100, 300, 64, True, "float32", True),     # Sq < Sk
        (1, 4, 300, 100, 64, True, "float32", True),     # Sq > Sk: empty rows
        (1, 4, 300, 100, 64, True, "bfloat16", True),
        (1, 2, 1000, 1537, 64, False, "float32", True),  # ragged
        (1, 2, 1537, 1000, 64, True, "float32", False),
        (1, 2, 1000, 1537, 64, True, "bfloat16", True),
        (1, 4, 384, 384, 128, True, "float32", True),    # D = 128
        (1, 4, 384, 384, 128, False, "bfloat16", True),
        (1, 2, 1000, 1537, 128, True, "float32", True),
        (1, 2, 200, 200, 80, True, "float32", True),     # D not a tile
        (1, 2, 200, 200, 32, False, "bfloat16", True),
        (1, 2, 256, 256, 256, True, "float32", True),    # D = 256
    ]
    for (b, h, sq, sk, d, causal, dtn, with_lse) in cases:
        dt = dts[dtn]
        q = _rand(torch, (b, h, sq, d), dt, gen)
        k = _rand(torch, (b, h, sk, d), dt, gen)
        v = _rand(torch, (b, h, sk, d), dt, gen)
        scale = 1.0 / math.sqrt(d)
        got = att.flash_fwd(q, k, v, causal, scale, with_lse=True)
        want = att._chunked_attention(q, k, v, causal, scale,
                                      with_lse=True)
        torch.cuda.synchronize()
        err_o, ratio = o_error(torch, att, got[0], want[0], q, k, v,
                               causal, scale, dtn)
        lse_ok = torch.isfinite(want[1]) | (want[1] == 1e30)
        err_l = (got[1] - want[1]).abs().max().item()
        empty = (want[1] == 1e30).sum().item()
        ok = ratio <= 1.0 and err_l <= TOL_LSE and \
            bool(lse_ok.all()) and bool(torch.isfinite(got[0]).all())
        if not with_lse:
            # the no-lse launch must give the same o
            o2 = att.flash_fwd(q, k, v, causal, scale)
            ok = ok and bool(torch.equal(o2, got[0]))
        log("kernel flash_fwd %s b%d h%d sq%d sk%d d%d causal=%s lse=%s: "
            "max|o-plain| %.3g (worst error/limit %.3f, limit %s), "
            "max|lse-plain| %.3g (tol %g), empty rows %d -> %s" % (
                dtn, b, h, sq, sk, d, causal, with_lse, err_o, ratio,
                tol_text(dtn), err_l, TOL_LSE, empty,
                "ok" if ok else "FAIL"))
        if not ok:
            raise RuntimeError("flash_fwd disagrees with its plain version")

    # timing at the serving path's shape
    b, h, sq, sk, d = PATH_SHAPE
    rows = {}
    for dtn in ("float32", "bfloat16"):
        dt = dts[dtn]
        q = _rand(torch, (b, h, sq, d), dt, gen)
        k = _rand(torch, (b, h, sk, d), dt, gen)
        v = _rand(torch, (b, h, sk, d), dt, gen)
        scale = 1.0 / math.sqrt(d)
        o = att.flash_fwd(q, k, v, True, scale)
        ref = att._chunked_attention(q, k, v, True, scale)
        err, ratio = o_error(torch, att, o, ref, q, k, v, True, scale, dtn)
        if not ratio <= 1.0:
            raise RuntimeError("flash_fwd at the path shape: max err %g, "
                               "worst error/limit %.3f (limit %s)"
                               % (err, ratio, tol_text(dtn)))
        ms = time_ms(torch, lambda: att.flash_fwd(q, k, v, True, scale), 20)
        plain_ms = time_ms(torch, lambda: att._chunked_attention(
            q, k, v, True, scale), 5, warmup=1)
        import torch.nn.functional as F
        lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, scale=scale), 20)
        bound, by = attention_bound_ms(b, h, sq, sk, d, True, dtn,
                                       q.element_size(), False)
        rows[dtn] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound, "bound_by": by, "library_ms": lib_ms}
        log("kernel flash_fwd timing %s b%d h%d s%d d%d causal on %s: "
            "kernel %.4f ms, plain %.4f ms, sdpa %.4f ms, bound %.4f ms "
            "(%s), kernel at %.1f%% of bound, max err %.3g (worst "
            "error/limit %.3f)" % (
                dtn, b, h, sq, d, card, ms, plain_ms, lib_ms, bound, by,
                100.0 * bound / ms, err, ratio))
    return rows


def phase_serve(torch, card, seed):
    import numpy as np
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.executor import _build_eval
    from mxnet_tpu_torch.gluon.model_zoo.transformer import \
        get_transformer_lm
    from mxnet_tpu_torch.ops import attention as att

    ctx = mx.gpu(0)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    rng = np.random.RandomState(seed)
    torch.cuda.reset_peak_memory_stats()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    prefix = os.path.join(tmp, "lm")

    att.flash_fwd.launches = 0      # the main path's count starts here
    t0 = time.perf_counter()
    net = get_transformer_lm(vocab=VOCAB, dim=DIM, heads=HEADS,
                             layers=LAYERS, max_seq=SEQ)
    net.initialize(ctx=ctx, generator=gen)
    net.hybridize()
    tok = mx.nd.array(rng.randint(0, VOCAB, (1, SEQ)).astype("float32"),
                      ctx=ctx)
    first = net(tok).asnumpy()
    net.export(prefix, 0)
    n_params = sum(int(np.prod(p.shape))
                   for p in net.collect_params().values())
    del net
    torch.cuda.empty_cache()
    log("serve: built, ran and exported the LM (%d layers, %d params) in "
        "%.2f s" % (LAYERS, n_params, time.perf_counter() - t0))
    if first.shape != (1, SEQ, VOCAB) or not np.isfinite(first).all():
        raise RuntimeError("first forward: bad output %s" % (first.shape,))

    reg = mx.serve.ModelRegistry()
    t0 = time.perf_counter()
    pred = reg.load_checkpoint(
        "lm", prefix, 0, data_shapes={"data0": (1, SEQ)},
        ladder=mx.serve.BucketLadder(batches=RUNGS), ctx=ctx)
    log("serve: load_checkpoint + warm of %d rungs in %.2f s" % (
        len(RUNGS), time.perf_counter() - t0))
    answers = []
    for rows in REQUESTS:
        x = rng.randint(0, VOCAB, (rows, SEQ)).astype("float32")
        before = att.flash_fwd.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = reg.predict("lm", x)[0]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        grew = att.flash_fwd.launches - before
        log("serve: request of %d rows (rung %d): %.2f ms, %.0f tokens/s, "
            "flash_fwd launches +%d on %s" % (
                rows, pred.ladder.batch_for(rows), dt * 1e3,
                rows * SEQ / dt, grew, card))
        if grew != LAYERS:
            raise RuntimeError("request of %d rows launched flash_fwd %d "
                               "times, expected %d (one per layer)"
                               % (rows, grew, LAYERS))
        answers.append((x, out._data))
    launches = att.flash_fwd.launches
    expected = LAYERS * (1 + len(RUNGS) + len(REQUESTS))
    log("serve: flash_fwd launches on the main path %d (expected %d: "
        "%d layers x (1 forward + %d warm rungs + %d requests))" % (
            launches, expected, LAYERS, len(RUNGS), len(REQUESTS)))
    if launches != expected:
        raise RuntimeError("main path launch count %d != %d"
                           % (launches, expected))
    log("serve: peak device memory %.3f GB" % (
        torch.cuda.max_memory_allocated() / 1e9))

    # the same exported graph, with the plain attention called explicitly
    def plain_dpa(query, key, value, causal=False, sm_scale=None,
                  chunk=512):
        return att._chunked_attention(query, key, value, bool(causal),
                                      sm_scale, chunk)
    ev = _build_eval(pred._symbol, False, op_impls={
        "_contrib_DotProductAttention": plain_dpa})
    for x, got in answers:
        rows = x.shape[0]
        rung = pred.ladder.batch_for(rows)
        pad = torch.zeros((rung, SEQ), dtype=torch.float32, device="cuda")
        pad[:rows] = torch.from_numpy(x).cuda()
        amap = dict(pred._params, data0=pad)
        with torch.no_grad():
            want = ev(amap, {})[0][0][:rows]
        if tuple(got.shape) != (rows, SEQ, VOCAB) or \
                not bool(torch.isfinite(got).all()):
            raise RuntimeError("request of %d rows: bad output" % rows)
        scale = max(1.0, want.abs().max().item())
        err = (got - want).abs().max().item()
        ok = err <= TOL_SERVE * scale
        log("serve: request of %d rows vs plain-attention graph: max abs "
            "err %.3g, max |logit| %.3g (tol %g x max(1, max|logit|)) -> %s"
            % (rows, err, scale, TOL_SERVE, "ok" if ok else "FAIL"))
        if not ok:
            raise RuntimeError("served logits disagree with the plain graph")
    profile_request(torch, reg, answers[-1][0], card)
    import shutil
    shutil.rmtree(tmp, ignore_errors=True)
    return launches


def profile_request(torch, reg, x, card):
    """Where one request's device time goes, by kernel (torch.profiler);
    reported as not measured when the trace holds no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    reg.predict("lm", x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        reg.predict("lm", x)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue        # host-side ops also carry their kernels' time
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            rows.append((us, e.key, e.count))
    total = sum(r[0] for r in rows)
    if total <= 0:
        log("serve profile: device time not measured (the trace holds "
            "no CUDA kernel time)")
        return

    def share(pred):
        return sum(r[0] for r in rows if pred(r[1].lower())) / total

    attn = share(lambda k: "flash_fwd" in k)
    gemm = share(lambda k: "gemm" in k or "cutlass" in k or "sm90" in k)
    if total > wall_us:
        # kernels of one stream cannot outlast the wall: the sum counted
        # something twice, so no idle share can be read from it
        idle = "not measured (summed kernel time exceeds the wall)"
    else:
        idle = "%.3f" % (1.0 - total / wall_us)
    log("serve profile, request of %d rows on %s: device busy %.3f ms of "
        "%.3f ms wall (idle share %s); flash_fwd %.3f, GEMM %.3f, other "
        "%.3f of device time" % (
            x.shape[0], card, total / 1e3, wall_us / 1e3, idle, attn, gemm,
            1.0 - attn - gemm))
    for us, key, count in sorted(rows, reverse=True)[:8]:
        log("  %9.3f ms  x%-4d %s" % (us / 1e3, count, key[:110]))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import mxnet_tpu_torch  # noqa: F401  (fails outside a checkout)

    t_start = time.perf_counter()
    card = phase_device(torch)
    phase_build()
    timing = phase_kernel(torch, card, args.seed)
    launches = phase_serve(torch, card, args.seed)
    b, h, sq, sk, d = PATH_SHAPE
    row = dict(timing["float32"])
    kernels = [dict({
        "name": "flash_fwd", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "mxnet_tpu/ops/attention.py:164",
        "launches": launches}, **row,
        dtype="float32", shape=[b, h, sq, sk, d], causal=True,
        bfloat16=timing["bfloat16"], card=card)]
    log("total %.1f s" % (time.perf_counter() - t_start))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
