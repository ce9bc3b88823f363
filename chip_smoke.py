#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``mxnet_tpu_torch``) on one NVIDIA GPU.

Phases, each reported on its own line; any failure exits non-zero:

1. device  — require CUDA; print ``nvidia-smi`` name and power limit.
2. build   — compile every hand-written kernel source of the paths in
             ``mxnet_tpu_torch/csrc`` with nvcc for sm_90a, one nvcc per
             source, all started together; print ptxas's registers and
             spills, and fail if the training path's dkdv (f32, D = 64)
             spills.
3. kernel  — hold each kernel against its plain PyTorch version on the
             card over a grid of cases, then time kernel, plain version
             and one PyTorch library call at the paths' shape.
4. serve   — the serving path at full width: build the transformer LM
             (vocab 32000, dim 1024, heads 16, 12 layers, seq 2048),
             hybridize, forward, export a checkpoint, load it into a
             ``serve.ModelRegistry`` and answer requests of 1, 3 and 8
             rows.  Every answer is checked against the same exported
             graph evaluated with the plain attention, and the kernel
             launch counts show the path ran the kernel.
5. train   — the training path at full width: the same LM, batch 8 x
             2048 tokens, ``autograd.record`` -> SoftmaxCrossEntropyLoss
             -> ``backward`` -> ``gluon.Trainer.step`` (SGD lr 0.01,
             momentum 0.9).  A check step from one set of weights with
             the kernels and with a plain attention agrees in the loss,
             in each layer's attention gradients at the op and, with the
             ReLU branches fixed, in every parameter's gradient; then four
             steps must lower the loss on the fixed batch, each launching
             flash_fwd, flash_bwd_dkdv and flash_bwd_dq once per layer.

The line before the last is a JSON object ``{"kernels": [...]}``; the last
line is ``{"ok": true, "device": {...}}``.

Usage: python3 chip_smoke.py [--seed 0]
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# the paths' attention shape: batch 8 (top serving rung, training
# batch), 16 heads, seq 2048, d 64
PATH_SHAPE = (8, 16, 2048, 2048, 64)
VOCAB, DIM, HEADS, LAYERS, SEQ = 32000, 1024, 16, 12, 2048
BATCH = 8
SOURCES = ("flash_fwd", "flash_bwd")
# the mangled name of flash_bwd_dkdv_kernel<float, 64, ...>: its spills fail
# the build phase
DKDV_PATH_ENTRY = "flash_bwd_dkdv_kernelIfLi64E"
RUNGS = (1, 2, 4, 8)
REQUESTS = (1, 3, 8)
TRAIN_STEPS = 4

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, FLOP/s by type
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "float16": 989e12}

# kernel vs plain tolerances.  Forward: both compute the same f32 online
# softmax over exact f32 products of the storage dtype; they differ only
# in f32 summation order.  f32 o is held to one absolute limit.  For a
# 16-bit dtype each rounds every p to v's dtype, relative to its own
# running max, so each p carries its own relative error of at most
# u = 2**-(bits + 1); the two o differ by at most 2u * A, A = sum_j p_j
# |v_j| / l (the attention of |v|), before each rounds o once.  So a 16-bit
# o is held per element to 2**-bits * A + 2 ulps of the dtype at |plain|.
TOL_F32 = 1e-4
ULP_BITS = {"bfloat16": 7, "float16": 10}       # explicit mantissa bits
TOL_LSE = 1e-4
# Backward: both versions recompute the same p from the forward's lse
# (not a running max) and sum in f32 in another order.  Held per element
# against M, the sum of the absolute terms behind it (bwd_magnitudes):
# each version is within n * 2**-24 * M of the exact sum over n <= 2**11
# terms, so f32 is held to 2**-12 * M.  A 16-bit dtype rounds p (for dv)
# and ds (for dk, dq) to the dtype; both round the same f32 value, so a
# term differs only where the f32 noise straddles a rounding boundary,
# by one ulp <= 2**-bits * |term|: held to (2**-bits + 2**-12) * M plus 2
# ulps of the dtype at |plain| for the final rounding.
BWD_F32_BITS = 12
# served logits vs the plain-attention graph, relative to max |logit|
TOL_SERVE = 1e-3
# training check step, kernels vs plain attention, from one set of
# weights.  The loss is held to 1e-5 of max(1, |loss|): the two differ in
# attention's f32 summation order (~1e-7 relative) carried through 12
# layers.  Gradients are held in two places.  (1) At the attention op's
# boundary: each layer's own q, k, v and dO, taken from the plain run, go
# through the kernels, and dq, dk, dv are held per element to phase 3's f32
# limit 2**-BWD_F32_BITS * M; the same inputs rounded to bf16 through the
# bf16 kernels must break that limit, or the check could not see a
# lower-precision backward.  (2) End to end, with every run's ReLU masks
# frozen to the plain run's: each parameter's gradient is held to
# TOL_TRAIN_GRAD of its max |g|.  Without the freeze, a unit whose fc1
# pre-activation lies within f32 noise of 0 takes the other branch under
# another summation order and moves its whole row of the gradients below
# it; the script counts those flips and prints the unfrozen gaps beside
# the same gaps between two plain block sizes (PERF.md, Findings).  With
# the branches fixed, the gradient is a smooth function of the attention
# gradients, and f32 summation order alone moves it by far less than
# 1e-4 of max |g|; a bf16 attention backward must move some parameter
# beyond that, which the script checks.
TOL_TRAIN_LOSS = 1e-5
TOL_TRAIN_GRAD = 1e-4


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


def bwd_magnitudes(torch, att, q, k, v, do, lse, delta, causal, scale,
                   chunk=256):
    """Per gradient element, the sum of the absolute terms behind it, in
    f32: M_dq = sum_j w_ij |k_j|, M_dk = sum_i w_ij |q_i| with
    w_ij = p_ij * scale * (|dO_i|.|v_j| + |delta_i|) (a bound on |ds_ij|
    and on its rounding inputs), and M_dv = sum_i p_ij |dO_i|."""
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    sq, sk = q.shape[2], k.shape[2]
    m_dq = torch.empty_like(qf)
    m_dk, m_dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for c0 in range(0, sq, chunk):
        sl = slice(c0, c0 + chunk)
        p = att._bwd_p(qf[:, :, sl], kf, lse[:, :, sl], c0, 0, sq, sk,
                       causal, scale)
        w = p * scale * (torch.matmul(dof[:, :, sl].abs(),
                                      vf.abs().transpose(-1, -2))
                         + delta[:, :, sl, None].abs())
        m_dq[:, :, sl] = torch.matmul(w, kf.abs())
        m_dk += torch.matmul(w.transpose(-1, -2), qf[:, :, sl].abs())
        m_dv += torch.matmul(p.transpose(-1, -2), dof[:, :, sl].abs())
    return m_dq, m_dk, m_dv


def bwd_error(torch, got, want, mag, dtn):
    """(max |got - want|, worst ratio of error to its limit)."""
    err = (got.float() - want.float()).abs()
    tol = 2.0 ** -BWD_F32_BITS * mag
    if dtn != "float32":
        bits = ULP_BITS[dtn]
        a = want.float().abs().clamp_min(2.0 ** -24)
        tol = tol + 2.0 ** -bits * mag + \
            2 * torch.exp2(torch.floor(torch.log2(a)) - bits)
    return err.max().item(), (err / tol.clamp_min(1e-30)).max().item()


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


def bound_ms(flops, nbytes, dtype):
    """Least time the card could take: the larger of *flops* over the
    dtype's peak and *nbytes* over HBM bandwidth.  Returns (ms,
    'operations'|'bytes')."""
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, \
        "operations" if t_ops >= t_bytes else "bytes"


def kernel_bound_ms(kernel, b, h, sq, sk, d, causal, dtype, itemsize):
    """The bound of one launch at these shapes.  flash_fwd: 4*D flop per
    visible (query, key) pair, q, k, v read and o written once.
    flash_bwd_dkdv: 8*D flop (four products), q, k, v, dO, lse, delta read
    and dk, dv written once.  flash_bwd_dq: 6*D flop (three products), the
    same reads and dq written once."""
    pairs = b * h * visible_pairs(sq, sk, causal)
    qkv = (2 * sq * d + 2 * sk * d) * itemsize * b * h
    if kernel == "flash_fwd":
        return bound_ms(4.0 * d * pairs, qkv, dtype)
    reads = qkv + 2 * b * h * sq * 4
    if kernel == "flash_bwd_dkdv":
        return bound_ms(8.0 * d * pairs,
                        reads + 2 * b * h * sk * d * itemsize, dtype)
    return bound_ms(6.0 * d * pairs, reads + b * h * sq * d * itemsize,
                    dtype)


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


def ptxas_usage(text):
    """{entry function: {"registers", "spill_stores", "spill_loads"}} from
    the ``-Xptxas -v`` lines of an nvcc log."""
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_stores"] = int(m.group(1))
            cur["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return out


def path_dkdv_usage(text):
    """ptxas usage of the dkdv instantiation on the training path (f32,
    D = 64); raises unless the log holds exactly one, without spills."""
    hits = [(n, u) for n, u in ptxas_usage(text).items()
            if DKDV_PATH_ENTRY in n]
    if len(hits) != 1 or len(hits[0][1]) != 3:
        raise RuntimeError("ptxas -v: %d complete entries match %s"
                           % (len(hits), DKDV_PATH_ENTRY))
    name, usage = hits[0]
    if usage["spill_stores"] or usage["spill_loads"]:
        raise RuntimeError("%s spills: %s" % (name, usage))
    return usage


def phase_build():
    from mxnet_tpu_torch.ops import _cuda
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(SOURCES)) as pool:
        infos = list(pool.map(_cuda.build, SOURCES))
    log("build: %d sources in %.2f s wall (nvcc %s, one process each)" % (
        len(SOURCES), time.perf_counter() - t0, " ".join(_cuda.ARCH_FLAGS)))
    for name, info in zip(SOURCES, infos):
        log("build: %s in %.2f s%s" % (
            name, info["seconds"],
            "" if info["seconds"] else " (built before; ptxas lines from "
            "its kept nvcc log)"))
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log("  ptxas %s: %s" % (name, line.strip()))
    usage = path_dkdv_usage(infos[SOURCES.index("flash_bwd")]["log"])
    log("build: flash_bwd_dkdv float32 D=64 (the training path's): %d "
        "registers, %d bytes spill stores, %d bytes spill loads -> ok" % (
            usage["registers"], usage["spill_stores"], usage["spill_loads"]))
    return usage


def _rand(torch, shape, dtype, gen):
    return torch.randn(shape, generator=gen, device="cuda",
                       dtype=torch.float32).to(dtype)


def tol_text(dtn):
    if dtn == "float32":
        return "%g" % TOL_F32
    return "2 ulp(|plain|) + 2**-%d * attention of |v|" % ULP_BITS[dtn]


def bwd_tol_text(dtn):
    if dtn == "float32":
        return "2**-%d * M" % BWD_F32_BITS
    return "(2**-%d + 2**-%d) * M + 2 ulp(|plain|)" % (ULP_BITS[dtn],
                                                       BWD_F32_BITS)


# the PyTorch call timed beside each kernel (library_ms): sdpa's forward,
# and for the two backward kernels together sdpa's backward alone
LIBRARY_CALL = {
    False: "scaled_dot_product_attention(is_causal=True)",
    True: "backward of scaled_dot_product_attention(is_causal=True), "
          "the work of both backward kernels"}

# (b, h, sq, sk, d, causal, dtype, with_lse)
CASES = [
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


def check_fwd_case(torch, att, gen, case):
    b, h, sq, sk, d, causal, dtn, with_lse = case
    dt = getattr(torch, dtn)
    q = _rand(torch, (b, h, sq, d), dt, gen)
    k = _rand(torch, (b, h, sk, d), dt, gen)
    v = _rand(torch, (b, h, sk, d), dt, gen)
    scale = 1.0 / math.sqrt(d)
    got = att.flash_fwd(q, k, v, causal, scale, with_lse=True)
    want = att._chunked_attention(q, k, v, causal, scale, with_lse=True)
    torch.cuda.synchronize()
    err_o, ratio = o_error(torch, att, got[0], want[0], q, k, v, causal,
                           scale, dtn)
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
            tol_text(dtn), err_l, TOL_LSE, empty, "ok" if ok else "FAIL"))
    if not ok:
        raise RuntimeError("flash_fwd disagrees with its plain version")
    return ratio


def bwd_inputs(torch, att, gen, b, h, sq, sk, d, causal, dt):
    """q, k, v, a random dO, and o, lse from flash_fwd; delta."""
    q = _rand(torch, (b, h, sq, d), dt, gen)
    k = _rand(torch, (b, h, sk, d), dt, gen)
    v = _rand(torch, (b, h, sk, d), dt, gen)
    do = _rand(torch, (b, h, sq, d), dt, gen)
    scale = 1.0 / math.sqrt(d)
    o, lse = att.flash_fwd(q, k, v, causal, scale, with_lse=True)
    return q, k, v, do, o, lse, att._delta(o, do), scale


def check_bwd(torch, att, inputs, causal, dtn):
    """Both backward kernels against their plain versions; returns
    {kernel: (max abs err, worst error/limit)}."""
    q, k, v, do, o, lse, delta, scale = inputs
    dk, dv = att.flash_bwd_dkdv(q, k, v, do, lse, delta, causal, scale)
    dq = att.flash_bwd_dq(q, k, v, do, lse, delta, causal, scale)
    pdk, pdv = att._flash_bwd_dkdv_plain(q, k, v, do, lse, delta, causal,
                                         scale)
    pdq = att._flash_bwd_dq_plain(q, k, v, do, lse, delta, causal, scale)
    torch.cuda.synchronize()
    m_dq, m_dk, m_dv = bwd_magnitudes(torch, att, q, k, v, do, lse, delta,
                                      causal, scale)
    res = {}
    for name, pairs in (("flash_bwd_dkdv", ((dk, pdk, m_dk),
                                            (dv, pdv, m_dv))),
                        ("flash_bwd_dq", ((dq, pdq, m_dq),))):
        errs = [bwd_error(torch, g, w, m, dtn) for g, w, m in pairs]
        finite = all(bool(torch.isfinite(g).all()) for g, _, _ in pairs)
        res[name] = (max(e for e, _ in errs),
                     max(r for _, r in errs) if finite else math.inf)
    # no atomics: a second launch of each kernel gives the same bits
    dk2, dv2 = att.flash_bwd_dkdv(q, k, v, do, lse, delta, causal, scale)
    res["deterministic"] = bool(torch.equal(dk2, dk)) and \
        bool(torch.equal(dv2, dv)) and bool(torch.equal(
            att.flash_bwd_dq(q, k, v, do, lse, delta, causal, scale), dq))
    return res


def phase_kernel(torch, card, seed):
    from mxnet_tpu_torch.ops import attention as att
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    worst = {}
    for case in CASES:
        ratio = check_fwd_case(torch, att, gen, case)
        worst[("flash_fwd", case[6])] = max(
            worst.get(("flash_fwd", case[6]), 0.0), ratio)
    for (b, h, sq, sk, d, causal, dtn, _) in CASES:
        inputs = bwd_inputs(torch, att, gen, b, h, sq, sk, d, causal,
                            getattr(torch, dtn))
        res = check_bwd(torch, att, inputs, causal, dtn)
        empty = (inputs[5] == 1e30).sum().item()
        for name in ("flash_bwd_dkdv", "flash_bwd_dq"):
            err, ratio = res[name]
            ok = ratio <= 1.0 and res["deterministic"]
            worst[(name, dtn)] = max(worst.get((name, dtn), 0.0), ratio)
            log("kernel %s %s b%d h%d sq%d sk%d d%d causal=%s: max|grad-"
                "plain| %.3g (worst error/limit %.3f, limit %s), empty rows "
                "%d, repeat bit-equal %s -> %s" % (
                    name, dtn, b, h, sq, sk, d, causal, err, ratio,
                    bwd_tol_text(dtn), empty, res["deterministic"],
                    "ok" if ok else "FAIL"))
            if not ok:
                raise RuntimeError("%s disagrees with its plain version"
                                   % name)
    for (name, dtn), r in sorted(worst.items()):
        log("kernel worst error/limit over the cases: %s %s %.3f"
            % (name, dtn, r))

    # timing at the paths' shape
    b, h, sq, sk, d = PATH_SHAPE
    rows = {}
    for dtn in ("float32", "bfloat16"):
        dt = getattr(torch, dtn)
        inputs = bwd_inputs(torch, att, gen, b, h, sq, sk, d, True, dt)
        q, k, v, do, o, lse, delta, scale = inputs
        itemsize = q.element_size()

        ref = att._chunked_attention(q, k, v, True, scale)
        err, ratio = o_error(torch, att, o, ref, q, k, v, True, scale, dtn)
        del ref
        if not ratio <= 1.0:
            raise RuntimeError("flash_fwd at the path shape: max err %g, "
                               "worst error/limit %.3f (limit %s)"
                               % (err, ratio, tol_text(dtn)))
        errs = {"flash_fwd": err}
        res = check_bwd(torch, att, inputs, True, dtn)
        if not res["deterministic"]:
            raise RuntimeError("a backward kernel at the path shape gave "
                               "other bits on a second launch")
        for name in ("flash_bwd_dkdv", "flash_bwd_dq"):
            if not res[name][1] <= 1.0:
                raise RuntimeError("%s at the path shape: max err %g, worst "
                                   "error/limit %.3f (limit %s)" % (
                                       name, res[name][0], res[name][1],
                                       bwd_tol_text(dtn)))
            errs[name] = res[name][0]

        # one PyTorch call per function: sdpa forward, and sdpa's backward
        # alone (on a retained graph) for the pair of backward kernels
        qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
        out = F.scaled_dot_product_attention(qr, kr, vr, is_causal=True,
                                             scale=scale)
        lib_bwd = time_ms(torch, lambda: torch.autograd.grad(
            out, (qr, kr, vr), do, retain_graph=True), 20)
        del out, qr, kr, vr
        timed = {
            "flash_fwd": (
                lambda: att.flash_fwd(q, k, v, True, scale),
                lambda: att._chunked_attention(q, k, v, True, scale),
                lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, scale=scale)),
            "flash_bwd_dkdv": (
                lambda: att.flash_bwd_dkdv(q, k, v, do, lse, delta, True,
                                           scale),
                lambda: att._flash_bwd_dkdv_plain(q, k, v, do, lse, delta,
                                                  True, scale),
                None),
            "flash_bwd_dq": (
                lambda: att.flash_bwd_dq(q, k, v, do, lse, delta, True,
                                         scale),
                lambda: att._flash_bwd_dq_plain(q, k, v, do, lse, delta,
                                                True, scale),
                None),
        }
        for name, (kern, plain, lib) in timed.items():
            ms = time_ms(torch, kern, 20)
            plain_ms = time_ms(torch, plain, 5, warmup=1)
            lib_ms = time_ms(torch, lib, 20) if lib is not None else lib_bwd
            bound, by = kernel_bound_ms(name, b, h, sq, sk, d, True, dtn,
                                        itemsize)
            rows[(name, dtn)] = {
                "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound, "bound_by": by, "library_ms": lib_ms,
                "library": LIBRARY_CALL[lib is None]}
            log("kernel %s timing %s b%d h%d s%d d%d causal on %s: kernel "
                "%.4f ms, plain %.4f ms, library %.4f ms (%s), bound %.4f ms "
                "(%s), kernel at %.1f%% of bound, max err %.3g" % (
                    name, dtn, b, h, sq, d, card, ms, plain_ms, lib_ms,
                    LIBRARY_CALL[lib is None], bound, by,
                    100.0 * bound / ms, errs[name]))
        del inputs, q, k, v, do, o, lse, delta
        torch.cuda.empty_cache()
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

    att.flash_fwd.launches = 0      # the serving path's count starts here
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
    log("serve: flash_fwd launches on the serving path %d (expected %d: "
        "%d layers x (1 forward + %d warm rungs + %d requests))" % (
            launches, expected, LAYERS, len(RUNGS), len(REQUESTS)))
    if launches != expected:
        raise RuntimeError("serving path launch count %d != %d"
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
    x = answers[-1][0]
    reg.predict("lm", x)
    profile(torch, lambda: reg.predict("lm", x),
            "serve profile, request of %d rows" % x.shape[0], card)
    del answers, reg, pred, ev
    shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return launches


def profile(torch, run, what, card):
    """Where one run's device time goes, by kernel (torch.profiler);
    reported as not measured when the trace holds no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
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
        log("%s: device time not measured (the trace holds no CUDA kernel "
            "time)" % what)
        return

    def share(pred):
        return sum(r[0] for r in rows if pred(r[1].lower())) / total

    shares = {"flash_fwd": share(lambda k: "flash_fwd" in k),
              "flash_bwd_dkdv": share(lambda k: "dkdv" in k),
              "flash_bwd_dq": share(lambda k: "flash_bwd_dq" in k),
              "GEMM": share(lambda k: "gemm" in k or "cutlass" in k or
                            "sm90" in k)}
    if total > wall_us:
        # kernels of one stream cannot outlast the wall: the sum counted
        # something twice, so no idle share can be read from it
        idle = "not measured (summed kernel time exceeds the wall)"
    else:
        idle = "%.3f" % (1.0 - total / wall_us)
    log("%s on %s: device busy %.3f ms of %.3f ms wall (idle share %s); "
        "%s, other %.3f of device time" % (
            what, card, total / 1e3, wall_us / 1e3, idle,
            ", ".join("%s %.3f" % kv for kv in shares.items() if kv[1] > 0),
            1.0 - sum(shares.values())))
    for us, key, count in sorted(rows, reverse=True)[:10]:
        log("  %9.3f ms  x%-4d %s" % (us / 1e3, count, key[:110]))


def attention_op(torch, att, chunk=512, backward="plain", boundary=None):
    """A ``_contrib_DotProductAttention`` for the check step whose forward
    is the plain PyTorch version, *chunk* keys at a time.  Its backward is
    the plain version (*backward* "plain"), or the bf16 kernels on the
    inputs rounded to bf16 ("bf16").  *boundary* (q, k, v, o, lse, dO,
    plain grads) is called in each plain backward."""
    class Plain(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, causal, scale):
            o, lse = att._chunked_attention(q, k, v, causal, scale, chunk,
                                            with_lse=True)
            ctx.save_for_backward(q, k, v, o, lse)
            ctx.causal, ctx.scale = causal, scale
            return o

        @staticmethod
        def backward(ctx, do):
            q, k, v, o, lse = ctx.saved_tensors
            q, k, v, o, lse, do = (t.contiguous()
                                   for t in (q, k, v, o, lse, do))
            if backward == "bf16":
                b16 = [t.to(torch.bfloat16) for t in (q, k, v, o, do)]
                grads = tuple(g.to(q.dtype) for g in att.flash_bwd(
                    *b16[:4], lse, b16[4], ctx.causal, ctx.scale))
            else:
                grads = att._flash_bwd_plain(q, k, v, o, lse, do,
                                             ctx.causal, ctx.scale, chunk)
                if boundary is not None:
                    boundary(q, k, v, o, lse, do, grads, ctx.causal,
                             ctx.scale)
            return grads + (None, None)

    def op(query, key, value, causal=False, sm_scale=None, **_graph_chunk):
        scale = sm_scale if sm_scale is not None else \
            1.0 / math.sqrt(query.shape[-1])
        return Plain.apply(query, key, value, bool(causal), float(scale))
    return op


def relu_op(torch, frozen=None):
    """An ``Activation`` (relu) for the check step that records each
    call's mask (x > 0) in graph order; given *frozen* masks of another
    run, it applies those (x * mask), so both runs take the same branch at
    every unit.  Returns (op, recorded masks)."""
    seen = []

    def op(x, act_type="relu"):
        if act_type != "relu":
            raise RuntimeError("check step: Activation %r" % act_type)
        seen.append(x.detach() > 0)
        if frozen is None:
            return torch.relu(x)
        return x * frozen[len(seen) - 1].to(x.dtype)
    return op, seen


def boundary_checker(torch, att, worst):
    """The attention op's boundary check: each layer's q, k, v, o, lse and
    dO from the plain run go through flash_fwd and the two backward
    kernels, held to phase 3's f32 limits; the same inputs rounded to bf16
    through the bf16 kernels are held to the f32 limit too and must break
    it.  Worst ratios accumulate in *worst*."""
    def check(q, k, v, o, lse, do, grads, causal, scale):
        ko, klse = att.flash_fwd(q, k, v, causal, scale, with_lse=True)
        _, fwd = o_error(torch, att, ko, o, q, k, v, causal, scale,
                         "float32")
        lse_err = (klse - lse).abs().max().item()
        delta = att._delta(o, do)
        dk, dv = att.flash_bwd_dkdv(q, k, v, do, lse, delta, causal, scale)
        dq = att.flash_bwd_dq(q, k, v, do, lse, delta, causal, scale)
        b16 = [t.to(torch.bfloat16) for t in (q, k, v, o, do)]
        low = att.flash_bwd(*b16[:4], lse, b16[4], causal, scale)
        mags = bwd_magnitudes(torch, att, q, k, v, do, lse, delta, causal,
                              scale)
        ratio = max(bwd_error(torch, g, w, m, "float32")[1]
                    for g, w, m in zip((dq, dk, dv), grads, mags))
        teeth = min(bwd_error(torch, g, w, m, "float32")[1]
                    for g, w, m in zip(low, grads, mags))
        worst["fwd"] = max(worst.get("fwd", 0.0), fwd)
        worst["lse"] = max(worst.get("lse", 0.0), lse_err)
        worst["bwd"] = max(worst.get("bwd", 0.0), ratio)
        worst["bf16"] = min(worst.get("bf16", math.inf), teeth)
        worst["layers"] = worst.get("layers", 0) + 1
    return check


def grad_gaps(torch, a, b):
    """Per parameter (max |a - b| / max |b|, ||a - b|| / ||b||); inf where
    a is not finite."""
    out = {}
    for n in b:
        d = a[n] - b[n]
        if not bool(torch.isfinite(a[n]).all()):
            out[n] = (math.inf, math.inf)
            continue
        out[n] = (d.abs().max().item() / max(b[n].abs().max().item(), 1e-30),
                  d.norm().item() / max(b[n].norm().item(), 1e-30))
    return out


def gap_text(gaps):
    """The worst max-relative and L2-relative gaps, with their parameters."""
    by_max = max(gaps, key=lambda n: gaps[n][0])
    by_l2 = max(gaps, key=lambda n: gaps[n][1])
    return "worst %.4g of max |g| (%s), worst L2 %.4g (%s)" % (
        gaps[by_max][0], by_max, gaps[by_l2][1], by_l2)


def check_step(torch, card, net, params, loss_fn, x, y):
    """Phase 5 (a): the kernels' gradient against a plain attention from
    one set of weights (see TOL_TRAIN_* above).  Returns the kernels'
    mean loss."""
    import numpy as np
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.executor import _build_eval
    from mxnet_tpu_torch.ndarray import NDArray
    from mxnet_tpu_torch.ops import attention as att

    def grads():
        return {n: p.grad()._data.clone() for n, p in params.items()}

    # the user's path, through the kernels
    with autograd.record():
        loss = loss_fn(net(x), y)
    loss.backward()
    got_loss, got = loss.asnumpy(), grads()

    def run(attention=None, relu=None):
        """One step of the net's train graph with the ops swapped."""
        impls = {}
        if attention is not None:
            impls["_contrib_DotProductAttention"] = attention
        if relu is not None:
            impls["Activation"] = relu
        ev = _build_eval(net._cached_graph.symbol, True, op_impls=impls)
        amap = {n: p.data()._data for n, p in params.items()}
        amap["data0"] = x._data
        with autograd.record(), torch.enable_grad():
            loss = loss_fn(NDArray(ev(amap, {})[0][0]), y)
        loss.backward()
        return loss.asnumpy(), grads()

    worst = {}
    relu512, masks = relu_op(torch)
    want_loss, want = run(attention_op(
        torch, att, 512, boundary=boundary_checker(torch, att, worst)),
        relu512)
    gaps = {"kernels": grad_gaps(torch, got, want)}
    del got
    relu256, masks256 = relu_op(torch)
    spread_loss, spread = run(attention_op(torch, att, 256), relu256)
    gaps["plain 256"] = grad_gaps(torch, spread, want)
    del spread
    flips = {"plain 256": sum(int((a != b).sum()) for a, b in
                              zip(masks256, masks))}
    del masks256
    frozen = {}
    for name, attention in (("kernels", None),
                            ("plain 256", attention_op(torch, att, 256)),
                            ("bf16 backward", attention_op(
                                torch, att, 512, backward="bf16"))):
        relu, seen = relu_op(torch, masks)
        _, g = run(attention, relu)
        frozen[name] = grad_gaps(torch, g, want)
        if name == "kernels":
            flips[name] = sum(int((a != b).sum())
                              for a, b in zip(seen, masks))
        del g, seen
    units = sum(int(m.numel()) for m in masks)
    del want, masks

    loss_err = float(np.abs(got_loss - want_loss).max())
    loss_tol = TOL_TRAIN_LOSS * max(1.0, float(np.abs(want_loss).max()))
    log("train: check step on %s: mean loss, kernels %.6f, plain %.6f, "
        "max abs err %.3g (tol %.3g; plain 256 vs 512 blocks %.3g)" % (
            card, float(got_loss.mean()), float(want_loss.mean()), loss_err,
            loss_tol, float(np.abs(spread_loss - want_loss).max())))
    log("train: check step at the attention op over %d layers: flash_fwd o "
        "worst error/limit %.3f (limit %g), max|lse-plain| %.3g (tol %g); "
        "flash_bwd dq, dk, dv worst error/limit %.3f (limit %s); the same "
        "inputs in bf16 through the bf16 kernels: least worst error/limit "
        "%.3f (must exceed 1)" % (
            worst["layers"], worst["fwd"], TOL_F32, worst["lse"], TOL_LSE,
            worst["bwd"], bwd_tol_text("float32"), worst["bf16"]))
    log("train: check step, ReLU units that take the other branch than "
        "plain-512's, of %d: kernels %d, plain 256 %d" % (
            units, flips["kernels"], flips["plain 256"]))
    for name, g in gaps.items():
        log("train: check step, %s vs plain 512, ReLU free: %s"
            % (name, gap_text(g)))
    for name, g in frozen.items():
        log("train: check step, %s vs plain 512, ReLU masks frozen: %s"
            % (name, gap_text(g)))
    k_worst = max(v[0] for v in frozen["kernels"].values())
    b_worst = max(v[0] for v in frozen["bf16 backward"].values())
    ok = loss_err <= loss_tol and worst["layers"] == LAYERS and \
        worst["fwd"] <= 1.0 and worst["lse"] <= TOL_LSE and \
        worst["bwd"] <= 1.0 and worst["bf16"] > 1.0 and \
        k_worst <= TOL_TRAIN_GRAD < b_worst
    log("train: check step: kernels' gradients with frozen masks worst "
        "%.4g of max |g| (limit %g), a bf16 attention backward %.4g (must "
        "exceed the limit) -> %s" % (k_worst, TOL_TRAIN_GRAD, b_worst,
                                     "ok" if ok else "FAIL"))
    if not ok:
        raise RuntimeError("the training check step failed (above)")
    return float(got_loss.mean())


def phase_train(torch, card, seed):
    import numpy as np
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.gluon.model_zoo.transformer import \
        get_transformer_lm
    from mxnet_tpu_torch.ops import attention as att

    ctx = mx.gpu(0)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 1)
    rng = np.random.RandomState(seed + 1)
    x = mx.nd.array(rng.randint(0, VOCAB, (BATCH, SEQ)).astype("float32"),
                    ctx=ctx)
    y = mx.nd.array(rng.randint(0, VOCAB, (BATCH, SEQ)).astype("float32"),
                    ctx=ctx)
    t0 = time.perf_counter()
    net = get_transformer_lm(vocab=VOCAB, dim=DIM, heads=HEADS,
                             layers=LAYERS, max_seq=SEQ)
    net.initialize(ctx=ctx, generator=gen)
    net.hybridize()
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    params = net.collect_params()

    # (a) the check step: one set of weights, kernels vs plain attention
    check_loss = check_step(torch, card, net, params, loss_fn, x, y)
    log("train: built the LM (%d params) and ran the check step in %.2f s"
        % (sum(int(np.prod(p.shape)) for p in params.values()),
           time.perf_counter() - t0))

    # (b) the main path: trainer steps on the fixed batch
    trainer = gluon.Trainer(params, "sgd",
                            {"learning_rate": 0.01, "momentum": 0.9})
    counters = (att.flash_fwd, att.flash_bwd_dkdv, att.flash_bwd_dq)

    def step():
        before = [c.launches for c in counters]
        with autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(BATCH)
        value = float(loss.asnumpy().mean())       # waits for the step
        grew = [c.launches - b for c, b in zip(counters, before)]
        if grew != [LAYERS] * 3:
            raise RuntimeError("a training step launched flash_fwd, "
                               "flash_bwd_dkdv, flash_bwd_dq %s times, "
                               "expected %d each (one per layer)"
                               % (grew, LAYERS))
        return value

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()    # the steps' peak, not the check's
    for c in counters:
        c.launches = 0      # the training path's counts start here
    losses, times = [], []
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        losses.append(step())
        times.append(time.perf_counter() - t0)
        log("train: step %d: loss %.6f, %.2f ms on %s" % (
            i + 1, losses[-1], times[-1] * 1e3, card))
    profile(torch, step, "train profile, one step of batch %d x %d"
            % (BATCH, SEQ), card)
    launches = {c.__name__: c.launches for c in counters}
    steps = TRAIN_STEPS + 1
    ms = 1e3 * sum(times[1:]) / len(times[1:])
    log("train: %d steps (the last profiled): ms per step %.2f (steps 2-%d), "
        "%.0f tokens/s, peak device memory %.3f GB on %s; launches %s "
        "(expected %d each: %d layers x %d steps)" % (
            steps, ms, TRAIN_STEPS, BATCH * SEQ / ms * 1e3,
            torch.cuda.max_memory_allocated() / 1e9, card, launches,
            LAYERS * steps, LAYERS, steps))
    if not all(math.isfinite(v) for v in losses) or \
            not losses[-1] < losses[0]:
        raise RuntimeError("the loss did not fall over %d steps: %s"
                           % (TRAIN_STEPS, losses))
    # step 1 starts from the checked weights, through the same path
    if abs(losses[0] - check_loss) > TOL_TRAIN_LOSS * max(1.0,
                                                         abs(check_loss)):
        raise RuntimeError("step 1's loss %.6f is not the check step's %.6f"
                           % (losses[0], check_loss))
    if any(n != LAYERS * steps for n in launches.values()):
        raise RuntimeError("training path launch counts %s" % launches)
    del net, trainer, params
    torch.cuda.empty_cache()
    return launches


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
    dkdv_ptxas = phase_build()
    timing = phase_kernel(torch, card, args.seed)
    serve_launches = phase_serve(torch, card, args.seed)
    train_launches = phase_train(torch, card, args.seed)
    b, h, sq, sk, d = PATH_SHAPE
    kernels = []
    for name, source, replaces in (
            ("flash_fwd", "flash_fwd.cu", "mxnet_tpu/ops/attention.py:164"),
            ("flash_bwd_dkdv", "flash_bwd.cu",
             "mxnet_tpu/ops/attention.py:335"),
            ("flash_bwd_dq", "flash_bwd.cu",
             "mxnet_tpu/ops/attention.py:380")):
        by_path = {"train": train_launches[name]}
        if name == "flash_fwd":
            by_path = {"serve": serve_launches, **by_path}
        kernels.append(dict({
            "name": name, "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/" + source,
            "replaces": replaces, "launches": sum(by_path.values())},
            **timing[(name, "float32")], launches_by_path=by_path,
            dtype="float32", shape=[b, h, sq, sk, d], causal=True,
            bfloat16=timing[(name, "bfloat16")], card=card))
        if name == "flash_bwd_dkdv":
            kernels[-1]["ptxas"] = dkdv_ptxas
    log("total %.1f s" % (time.perf_counter() - t_start))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
