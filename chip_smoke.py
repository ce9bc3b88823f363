#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``mxnet_tpu_torch``) on one NVIDIA GPU.

Phases, each reported on its own line; any failure exits non-zero:

1. device  — require CUDA; print ``nvidia-smi`` name and power limit.
2. build   — compile every hand-written kernel source of the paths in
             ``mxnet_tpu_torch/csrc`` with nvcc for sm_90a, one nvcc per
             source, all started together; print ptxas's registers and
             spills, and fail if an instantiation the paths run
             (``PATH_ENTRIES``: flash_fwd, flash_bwd_dkdv and
             flash_bwd_dq, f32, D = 64) spills or is missing.
3. kernel  — hold each kernel against its plain PyTorch version on the
             card over a grid of cases, each relaunched for bit-equality,
             head dims past 256 up to the kernels' bound among them, and
             at B*H = 65600 (past grid.y's 65535); then time kernel,
             plain version and one PyTorch library call at the paths'
             shape, and the wide-head kernels beside their plain
             versions.
4. serve   — batch serving at full width: build the transformer LM
             (vocab 32000, dim 1024, heads 16, 12 layers, seq 2048),
             hybridize, forward, export a checkpoint, load it into a
             ``serve.ModelRegistry`` on the ladder (1, 2, 4, 8) with the
             sequence rounded to 512, one CUDA graph captured per rung;
             answer direct requests of 1, 3 and 8 rows; then serve
             ``registry.submit`` traffic through the DynamicBatcher: a
             closed loop of 8 client threads x 13 requests of 1-4 rows,
             an open loop of 100 requests at half its request rate, and
             two direct requests of 700 and 900 tokens (one capture of
             the 1024 rung).  Every answer is held against the same
             graph with the plain attention; every coalesced answer is
             bit-equal to predict of its stacked batch (by CRC-32, so
             the loops hold no answer past its digest); the 700-token
             answer's first 700 positions match an unpadded eager
             forward; replay matches eager at each rung (timed side by
             side); the requests coalesce, no capture happens beyond the
             planned one, no future is left unresolved, and replays x
             captured launches equal 12 layers x dispatches; a profiled
             replay runs flash_fwd.
5. train   — the training path at full width: the same LM, batch 8 x
             2048 tokens, ``autograd.record`` -> SoftmaxCrossEntropyLoss
             -> ``backward`` -> ``gluon.Trainer.step`` (SGD lr 0.01,
             momentum 0.9).  A check step from one set of weights with
             the kernels and with a plain attention agrees in the loss,
             in each layer's attention gradients at the op and, with the
             ReLU branches fixed, in every parameter's gradient; then four
             steps must lower the loss on the fixed batch, each launching
             flash_fwd, flash_bwd_dkdv and flash_bwd_dq once per layer.
6. resnet  — ResNet-50 v1 (classes 1000, conv7 stem, f32) at full width
             and depth on the same paths, with Convolution, BatchNorm,
             Pooling and Flatten on PyTorch and cuDNN (no TPU kernel lies
             on it).  Serve: hybridize, export, ``ModelRegistry``, warm
             rungs 1, 8, 32 (a CUDA graph each) and answer requests of 1,
             8 and 32 images of 224 x 224, each held against the same
             graph and weights in float64 on the card; the same requests
             with TF32 convolutions must break that limit; graph against
             eager per rung, timed.  Check step, batch 32:
             loss, every gradient (ReLU masks frozen to the f64 run's) and
             the running statistics against a float64 step; a TF32 run
             must break the gradient limit (SGD lr 0.1, momentum 0.9).
             Train: a fresh net, batch 128, six steps of SGD (lr 0.01,
             momentum 0.9), steps 2-6 timed, the loss must fall, peak
             memory, and one profiled step beside its f32 bound.
7. north-star — ``parallel.ParallelTrainer`` as bench.py and
             tools/benchmark_lm.py drive it: bf16 compute weights with
             float32 masters.  (a) ResNet-50, lbsgd (lr 0.1, eta 0.001,
             momentum 0.9), batch 128 x 224^2: 2 warm-up and 10 timed
             steps, images/s beside the bf16 bound, device-time shares
             (convolutions, BatchNorm and elementwise, the optimizer by
             its profiler range), idle share with ``coalesce_small`` on
             and off, peak memory; the loss must fall from step 1 to 6.
             (e) Its checkpoint loads into a fresh trainer bit for bit.
             (b) At batch 32, one step's gradients applied by the
             coalesced and the per-tensor paths against a float64 LARS +
             mp_sgd_mom update (two wrong variants must fail).  (c) The
             bf16 loss and gradients against float64 (ReLU masks
             frozen).  (d) The LM, sgd lr 0.01 momentum 0.9, int32 ids,
             batch 8 x 2048: the main path whose launches are counted
             (the bf16 kernels, 12 of each a step), the loss must fall
             over four steps, step 1's loss against the plain
             attention's, shares; then the same step with PyTorch's SDPA
             in the kernels' place, timed only.
8. decode  — generation from the same LM at full width and depth:
             export, ``registry.load_checkpoint`` ->
             ``pred.make_paged_decoder`` (blocks of 16 tokens, sessions up
             to 1024, a CUDA graph per tick rung 1-16 and per prefill rung
             16-1024, a pool of 1025 blocks) -> ``DecodeBatcher.start``,
             16 client threads x 2 sessions (prompts 64-512, 64-256 new
             tokens): tokens/s, time to first token, per-token latency,
             ticks and rung occupancy, graph against eager per tick
             rung, prefill replays; the prefill runs the model's graph,
             so flash_fwd (the main path's launches counted).  Checks: (a)
             the step's teacher-forced logits against the forward; (b)
             4 sessions served batched against their serial dense decode
             through ``make_decoder`` (the reference's comparison, timed),
             a divergence allowed only at a tie within the limit; (c) no
             failed session, no build under traffic, no block left in
             use; (d) a prompt with ids 32000 and -1 gets NaN logits and
             the argmax over NaN, and the same 4 sessions served again on
             its freed NaN blocks are bit-equal.
9. user    — the eager user surface: every op name of the slice (the
             cases of ``test_utils.op_sweep_cases``) through ``nd`` on the
             card against the CPU (exact ones equal, float ones within
             2**-18 of their scale, samplers and Dropout by moments and
             by repeating under one seed); then the loop of
             ``examples/train_transformer_lm.py`` (its TransformerBlock,
             ``qkv[0]``, a standalone Parameter, ``Trainer(dict,
             "adam")``, the copy task) at the LM's full width, eagerly
             through ``nd``, ``gluon`` and ``autograd``: a check step
             against the plain attention (loss within 1e-5), then six
             steps whose loss must fall, each launching flash_fwd,
             flash_bwd_dkdv and flash_bwd_dq 12 times.
10. module — the symbolic training path: the same LM traced to a Symbol
             with a SoftmaxOutput head (normalization "valid"), trained
             through ``mx.mod.Module(context=mx.gpu(0))`` on an
             ``NDArrayIter`` of the copy task (lag 7), SGD lr 0.01,
             momentum 0.9, rescale_grad 1/batch.  (a) A check step binds
             the same weights with the kernels and with the plain
             attention (``op_impls``): the loss within 1e-5, each layer's
             dq, dk, dv at the op within phase 3's limits.  (b) One step
             through the fused step (one CUDA graph) and one through
             ``forward_backward`` + ``update`` from the same weights and
             batch: weights and momenta bit-equal; then 5 timed steps of
             each after 3 warm-ups (host clock, readback at the end); the
             graph captured once and replayed every fused step.  (c)
             ``fit``: one epoch of 6 batches, 2 eval batches,
             ``eval_metric='perplexity'``, ``Speedometer(8, 1)``; the
             training loss falls from batch 1 to 6, ``score`` equals the
             perplexity of ``predict``'s outputs; tokens/s, peak memory.
             (d) ``save_checkpoint`` with optimizer states ->
             ``Module.load``: its next step bit-equal to the original's.
             12 launches of each kernel a step, captured and replayed.
11. lstm   — recurrent networks; no kernel of the repo lies on this path
             (the JAX op is ``lax.scan``): the RNN op runs on cuDNN
             through PyTorch's fused recurrent functions.  (a) The op's
             route against its plain per-step version on the card: 11
             cases (the four modes, 1 and 2 layers, bidirectional,
             state outputs, the LSTM clip with and without clip_nan) at
             T 256 in f32 and bf16, outputs, states and the gradients of
             data, parameters and states, each relaunched bit-equal, a
             TF32 f32 run must break the f32 limit; foreach, while_loop
             and cond on the card against the CPU; a foreach RNN trained
             through a Module's fused step (one CUDA graph) bit-equal to
             the legacy step.  (b) ``tools/benchmark_lm.py --arch lstm``
             at its defaults: ``get_lstm_lm(32000, 1024, 2)`` (82,329,600
             parameters) through ``ParallelTrainer`` (sgd lr 0.01,
             momentum 0.9, bf16 compute weights, f32 masters), int32 ids,
             batch 8 x 2048: a check step against the plain op bound in
             (f32) and against f32 (bf16), five steps whose f32 loss must
             fall, ms a step, tokens/s, peak memory, the RNN op's and the
             head's shares of device time, the op alone on each route.
             (c) The loop of ``examples/train_lm.py`` at PTB-medium width
             (vocab 10000, 650 x 2, batch 32, buckets 8-20, adam) through
             ``BucketingModule.fit`` for one epoch of a sparse Markov
             corpus: ms a batch by bucket, tokens/s, idle share; shared
             arrays, one updater, one bind a bucket, perplexity falls,
             ``score`` against ``predict``, a checkpoint's next step.
12. data   — the data path; no kernel of the repo lies on it.  (a) The
             decode route (the card has no libjpeg: nvJPEG onto the card,
             ``csrc/nvjpeg_decode.cu``, then the libjpeg team's geometry
             as torch ops), its builds, ``nproc``, cv2 and PIL.  (b)
             1,280 JPEGs (quality 90, sides 333-500, label i % 1000)
             through ``MXIndexedRecordIO``.  (c) The route against a
             full-size decode by the same library with the geometry in
             plain torch: resize 0 centre and random crop bit-equal,
             resize 256 mean |d| < 8, two passes bit-equal.  (d)
             ``ImageRecordIter`` alone, images/s at 4 and ``nproc``
             threads.  (e) ``examples/train_imagenet.py``'s module flow:
             ResNet-50 v1 (classes 1000) from ``build_symbol``'s way,
             ``ImageRecordIter`` (shuffle, random crop and mirror, 4
             threads) -> ``Module.fit(device_prefetch=2)`` (sgd lr 0.1,
             momentum 0.9, wd 1e-4, rescale_grad 1/128, Xavier, local
             kvstore, Speedometer) for one epoch of 10 batches of 128 x
             224^2: ms a batch, images/s, the input-stall share, steps
             stalled, ring occupancy, peak memory; again at depth 0 and
             from an in-memory ``NDArrayIter``; the loss finite, every
             batch native.  (f) With deterministic cuDNN, 3 batches at
             depth 2, at 0 and on the legacy step: weights, running
             statistics and momenta bit-equal, the statistics moved.
             (g) The gluon flow: ``ImageRecordDataset`` ->
             ``RandomResizedCrop``, flip, ``ToTensor``, ``Normalize`` ->
             ``DataLoader`` (8 spawned workers, pin_memory) -> the
             hybridized ResNet-50, 6 batches: images/s, the share
             waiting on the loader; deterministic transforms through the
             workers bit-equal to ``num_workers=0``'s.

13. quant  — post-training int8 serving and serving autotuning.  (a)
             ResNet-50 v1 at phase 6's width (seeded weights): registry.load
             with quantize="int8" and calib_batches (8 batches of 32
             seeded images: calibrate, lower, warm rungs 1, 8, 32, one
             CUDA graph each, the load gate at every rung), 54 of 54
             layers int8; per rung the int8 products and tensors each
             graph's capture counted (no float product left), the compute
             bytes of int8 and fp32 and their ratio, held to the ratio the
             fp32 graph's shapes give, the replay ms of int8 and fp32 (CUDA
             events), the gate's error; requests of 1 and 8 images against
             the port's CPU run of the same quantized graph: every int8
             product bit-equal, every quantize code within 1 (equal on
             99.9 %) and every dequantized value within 1e-6 on the CPU
             run's own inputs, and the answers within a limit per model
             and mode that lies below the quantized answers' distance from
             the fp32 twin's on the same request; closed-loop traffic of
             1-32 images a request through the DynamicBatcher; then the
             same with "int8-weight-only".  (c) Tuning, a check of the
             mechanism: a seeded trace of 500 requests of 1-4 images ->
             autotune.tune over three ladders topping at 32 (trials 4,
             neighbours 2) -> a TuningStore keyed on the card's name; the
             winner and the default measured once more; a fresh
             registry.load under MXNET_TUNING_STORE takes the tuned ladder
             and batcher window and shows health()["tuning"].  (b) The LM
             at phase 4's width (rungs 1, 2, 4, 8, the sequence bucketed to
             512) the same way, int8 then int8-weight-only, every rung's
             graph capturing flash_fwd once a layer (the main path's
             launches counted), a 512-token request against the CPU run,
             and the same graph on the card with the plain attention in
             flash_fwd's place, which must stay within the int8 limit (how
             far another f32 summation order moves the int8 answers); the
             default policy's gate must accept the model.  Peak memory and
             the phase's seconds.
14. fleet  — the serving fleet (``serve.Fleet``: replica processes on the
             one card, each serving on cuda:0 behind ``serve.Router``), as
             bench.py --serve-fleet and --serve-decode --failover measure
             it.  The LM at phase 4's width is exported twice (v1 from
             --seed, v2 from --seed + 1); each replica serves it on the
             ladder 1, 2, 4 (a CUDA graph a rung, flash_fwd inside).
             Requests of 1-2 rows x 2048 tokens draw their rows from a
             seeded pool of 8; the parent replays every pool row at every
             rung of both versions and keeps SHA-256 hashes of the logits.
             (a) One replica: a closed loop of 2 clients x 4 requests, then
             an open loop of 60 at half its rate; a second replica
             spawned, the same open loop again, then closed loops of 2 x 4
             and 4 x 4: up and scale-out seconds, requests/s, p50 and the
             slowest request (from each send in a closed loop, whose
             answers are hashed after it; from each scheduled arrival in
             an open loop), the router's mean beside the replicas'
             submit-to-answer; every
             answer bit-equal to the parent's replay at some rung, the
             replicas' dispatches equal to the answers, no dedup hit.  (b)
             ``fleet.replace(key, extra_env={"MXNET_CHAOS":
             "replica_kill_at=3"})`` under 8 requests: rc 137, every
             request answered bit-equal (or failed typed, none expected),
             the successor with 0 nvcc seconds.  (c) ``fleet.deploy`` onto
             v2 under the same open loop: zero dropped, answers v1 or v2
             during and v2 only after, each drain record not timed out.
             Every replica's STATS is read before it is stopped: a graph a
             rung and no more (no capture in the request path), no nvcc,
             its peak memory, and its flash_fwd launches (the killed
             replica's are lost); dispatches over all replicas equal the
             answers less the killed replica's.  (d) The reference's
             decode_lm (vocab 32, dim 16, seed 5) on 2 replicas, one armed
             with replica_kill_decode_at=30: 6 streams of 48 tokens, each
             bit-equal to the dense decode, rc 137, at least one failed
             over (resume p50 and slowest), tokens/s steady and in the
             dip, no capture on the survivors, no KV block left in use.

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
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# the paths' attention shape: batch 8 (top serving rung, training
# batch), 16 heads, seq 2048, d 64
PATH_SHAPE = (8, 16, 2048, 2048, 64)
VOCAB, DIM, HEADS, LAYERS, SEQ = 32000, 1024, 16, 12, 2048
BATCH = 8
SOURCES = ("flash_fwd", "flash_bwd")
DATA_SOURCES = ("nvjpeg_decode",)       # phase 12's nvJPEG binding (nvcc)
HOST_SOURCES = ("recordio_reader",)     # phase 12's g++ library (src/io)
# (kernel, source, part of the mangled name) of the instantiations the
# paths run, f32 and D = 64 (flash_fwd_kernel<float, 64, ...>,
# flash_bwd_dkdv_kernel<float, 64, ...>, flash_bwd_dq_kernel<float, 64,
# ...>): a spill in any fails the build phase
PATH_ENTRIES = (("flash_fwd", "flash_fwd", "flash_fwd_kernelIfLi64E"),
                ("flash_bwd_dkdv", "flash_bwd",
                 "flash_bwd_dkdv_kernelIfLi64E"),
                ("flash_bwd_dq", "flash_bwd", "flash_bwd_dq_kernelIfLi64E"))
# phase 3's case past grid.y's 65535 (b, h, sq, sk, d), causal, f32, and
# the most extra device memory its plain versions may take: a few tensors
# of q's 134 MB, as they hold no score matrix larger than q
BIG_BH = (1, 65600, 16, 16, 32)
BIG_BH_PLAIN_MB = 1024
RUNGS = (1, 2, 4, 8)
REQUESTS = (1, 3, 8)
TRAIN_STEPS = 4
# phase 4's batched serving, shaped as bench.py --serve drives it
# (bench.py:709-903): closed-loop client threads, then an open loop at a
# fixed arrival rate, requests of 1 to 4 rows; the ladder rounds the
# sequence axis to 512 up to the model's 2048
SERVE_SEQ_AXES, SERVE_SEQ_MAX = {1: 512}, {1: SEQ}
CLOSED_THREADS, CLOSED_PER_THREAD = 8, 13      # 104 requests
MAX_ROWS = 4
MAX_WAIT_MS = 2.0
OPEN_SHARE, OPEN_REQUESTS = 0.5, 100    # at half the closed loop's rate
# a nearest-rank p99 of fewer requests is the slowest one or next to it:
# below this sample it is reported as not measured
P99_MIN_REQUESTS = 100
DIGEST_WORKERS = 3                      # threads that CRC the answers
DIRECT_SEQS = (700, 900)                # both round to the 1024 rung
GRAPH_ITERS = 3                         # runs per rung, graph and eager

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
# terms, so f32 is held to 2**-12 * M.  Every case stays within 2**11
# terms: sequences of at most 2048, and head dims at most the kernels'
# bound of 2048 = 2**11 (the wide cases sum at most 2048 terms in a dot
# product and 300 in a gradient).  A 16-bit dtype rounds p (for dv)
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

# phase 6: ResNet-50 v1 at the published width and depth of bench.py's
# north-star model (bench.py:1814-1815): classes 1000, 224 x 224, conv7
# stem, f32; weights Xavier(gaussian, in, 2) (examples/train_imagenet.py
# :37).  The check step runs SGD lr 0.1, momentum 0.9 (bench.py:253-256,
# without LARS).  The timed steps run lr 0.01: bench.py's 0.1 is scaled
# per layer by LARS's trust ratio (eta 0.001), and plain SGD at 0.1 on a
# fixed batch lowers the loss for two steps and then climbs (PERF.md,
# ResNet-50 findings), so whether it fell by step 6 would be chance.
RESNET = "resnet50_v1"
RESNET_CLASSES, RESNET_IMAGE = 1000, 224
RESNET_RUNGS = (1, 8, 32)
RESNET_REQUESTS = (1, 8, 32)
RESNET_CHECK_BATCH = 32      # the f64 copy of the check step must fit
RESNET_BATCH = 128
RESNET_STEPS = 6
RESNET_CHECK_LR, RESNET_LR, RESNET_MOMENTUM = 0.1, 0.01, 0.9
# forward flop of one 224 x 224 image (bench.py:270); a training step
# does three times the forward's work
RESNET_FWD_FLOP = 4.089e9
# Limits against the float64 oracle (the same graph and weights, in f64
# on the card: no TF32, no f32 rounding).  f32 and TF32 differ in the
# rounding of every product's inputs, 2**-24 against 2**-11 relative,
# and both errors grow alike through the 53 convolutions.  Each limit
# sits near the geometric mean of the two, as first measured on an H100
# (PERF.md, ResNet-50 findings): served logits, f32 2.2e-6 and TF32
# 4.3e-4 of max |logit|; gradients with the ReLU masks frozen, f32
# 1.9e-3 and TF32 0.149 of max |g| (the worst is the stem's weight,
# each element a sum of 401,408 products behind BatchNorm's
# mean-removing backward).  The script shows that TF32 convolutions
# break the serve and gradient limits.  The loss and the running
# statistics are held to 1e-5.
TOL_RESNET_SERVE = 3e-5      # x max(1, max |logit|) of the f64 answer
TOL_RESNET_LOSS = 1e-5       # x max(1, |loss|)
TOL_RESNET_GRAD = 1e-2       # x each parameter's max |g| (masks frozen)
TOL_RESNET_STATS = 1e-5      # x max(1, max |stat|) per running stat
# cuDNN kernel names by what they do, for the training profile's shares
CONV_KEYS = ("conv", "fprop", "dgrad", "wgrad", "winograd", "fft",
             "implicit", "cudnn")
NORM_KEYS = ("elementwise", "reduce", "welford", "norm", "pointwise",
             "vectorized", "unrolled", "copy", "fill")
RESNET_SHARES = (
    ("TF32 kernels", lambda k: "tf32" in k),
    ("convolution", lambda k: "tf32" not in k and
     any(c in k for c in CONV_KEYS)),
    ("BatchNorm and elementwise",
     lambda k: not any(c in k for c in CONV_KEYS) and
     any(c in k for c in NORM_KEYS)),
    ("GEMM", lambda k: not any(c in k for c in CONV_KEYS + NORM_KEYS) and
     ("gemm" in k or "cutlass" in k)),
    ("pooling", lambda k: "pool" in k and
     not any(c in k for c in CONV_KEYS + NORM_KEYS)))


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
    # f32 products stay full f32 everywhere (the JAX package's HIGHEST);
    # convolutions set their own precision (mxnet_tpu_torch/ops/nn.py),
    # so cuDNN's process default is left as it is: phase 6 runs its f32
    # convolutions under that default
    torch.backends.cuda.matmul.allow_tf32 = False
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


def path_usage(logs):
    """{kernel: ptxas usage} of each instantiation in ``PATH_ENTRIES``,
    from the nvcc logs by source; raises unless each source's log holds
    exactly one complete entry of it, without spills."""
    out = {}
    for kernel, source, entry in PATH_ENTRIES:
        hits = [(n, u) for n, u in ptxas_usage(logs.get(source, "")).items()
                if entry in n]
        if len(hits) != 1 or len(hits[0][1]) != 3:
            raise RuntimeError("ptxas -v of %s: %d complete entries match %s"
                               % (source, len(hits), entry))
        name, usage = hits[0]
        if usage["spill_stores"] or usage["spill_loads"]:
            raise RuntimeError("%s spills: %s" % (name, usage))
        out[kernel] = usage
    return out


def phase_build():
    from mxnet_tpu_torch.ops import _cuda
    from mxnet_tpu_torch.runtime import native
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(
            len(SOURCES) + len(DATA_SOURCES) + len(HOST_SOURCES)) as pool:
        host = [pool.submit(native.build, n) for n in HOST_SOURCES]
        data = [pool.submit(_cuda.build, n) for n in DATA_SOURCES]
        infos = list(pool.map(_cuda.build, SOURCES))
        for name, fut in zip(DATA_SOURCES + HOST_SOURCES, data + host):
            info = fut.result()
            log("build: %s (phase 12's path) in %.2f s" % (name,
                                                           info["seconds"]))
    log("build: %d sources in %.2f s wall (nvcc %s, one process each)" % (
        len(SOURCES) + len(DATA_SOURCES) + len(HOST_SOURCES),
        time.perf_counter() - t0, " ".join(_cuda.ARCH_FLAGS)))
    for name, info in zip(SOURCES, infos):
        log("build: %s in %.2f s%s" % (
            name, info["seconds"],
            "" if info["seconds"] else " (built before; ptxas lines from "
            "its kept nvcc log)"))
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log("  ptxas %s: %s" % (name, line.strip()))
    usage = path_usage({name: info["log"]
                        for name, info in zip(SOURCES, infos)})
    for kernel, u in usage.items():
        log("build: %s float32 D=64 (on the paths): %d registers, %d bytes "
            "spill stores, %d bytes spill loads -> ok" % (
                kernel, u["registers"], u["spill_stores"], u["spill_loads"]))
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
    # head dims past 256: the wide kernels (the case at the kernels' bound,
    # attention.KERNEL_MAX_HEAD_DIM, is added in phase_kernel)
    (1, 2, 200, 300, 300, True, "float32", True),
    (1, 2, 300, 200, 300, True, "bfloat16", True),
    (1, 1, 256, 256, 1024, False, "float32", True),
]
# the wide-head shapes timed beside their plain versions (b, h, sq, sk, d,
# causal)
WIDE_TIMED = ((1, 2, 200, 300, 300, True), (1, 1, 256, 256, 1024, False))


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
    # no atomics: a relaunch gives the same bits
    again = att.flash_fwd(q, k, v, causal, scale, with_lse=True)
    same = bool(torch.equal(again[0], got[0])) and \
        bool(torch.equal(again[1], got[1]))
    if not with_lse:
        # the no-lse launch must give the same o
        o2 = att.flash_fwd(q, k, v, causal, scale)
        same = same and bool(torch.equal(o2, got[0]))
    ok = ok and same
    log("kernel flash_fwd %s b%d h%d sq%d sk%d d%d causal=%s lse=%s: "
        "max|o-plain| %.3g (worst error/limit %.3f, limit %s), "
        "max|lse-plain| %.3g (tol %g), empty rows %d, repeat bit-equal %s "
        "-> %s" % (
            dtn, b, h, sq, sk, d, causal, with_lse, err_o, ratio,
            tol_text(dtn), err_l, TOL_LSE, empty, same,
            "ok" if ok else "FAIL"))
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


def check_big_bh(torch, att, gen, worst):
    """All three kernels at ``BIG_BH`` (causal, f32), past the 65535 of
    grid.y, against their plain versions, each relaunched for
    bit-equality; the plain versions' extra device memory is held to
    ``BIG_BH_PLAIN_MB``."""
    b, h, sq, sk, d = BIG_BH
    inputs = bwd_inputs(torch, att, gen, b, h, sq, sk, d, True,
                        torch.float32)
    q, k, v, do, o, lse, delta, scale = inputs
    again = att.flash_fwd(q, k, v, True, scale, with_lse=True)
    same = bool(torch.equal(again[0], o)) and bool(torch.equal(again[1], lse))
    del again
    want = att._chunked_attention(q, k, v, True, scale, with_lse=True)
    err_o, ratio = o_error(torch, att, o, want[0], q, k, v, True, scale,
                           "float32")
    err_l = (lse - want[1]).abs().max().item()
    del want
    res = check_bwd(torch, att, inputs, True, "float32")

    def extra_mb(fn):
        """Peak device memory *fn* takes beyond what is held before it,
        its outputs included."""
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        del out
        return (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    plain_mb = max(
        extra_mb(lambda: att._chunked_attention(q, k, v, True, scale,
                                                with_lse=True)),
        extra_mb(lambda: att._flash_bwd_dkdv_plain(q, k, v, do, lse, delta,
                                                   True, scale)),
        extra_mb(lambda: att._flash_bwd_dq_plain(q, k, v, do, lse, delta,
                                                 True, scale)))
    ok = ratio <= 1.0 and err_l <= TOL_LSE and same and \
        res["deterministic"] and plain_mb <= BIG_BH_PLAIN_MB and \
        all(res[n][1] <= 1.0 for n in ("flash_bwd_dkdv", "flash_bwd_dq"))
    worst[("flash_fwd", "float32")] = max(worst[("flash_fwd", "float32")],
                                          ratio)
    for n in ("flash_bwd_dkdv", "flash_bwd_dq"):
        worst[(n, "float32")] = max(worst[(n, "float32")], res[n][1])
    log("kernel all three float32 b%d h%d (B*H %d) sq%d sk%d d%d causal: "
        "flash_fwd worst error/limit %.3f, max|lse-plain| %.3g; dkdv %.3f, "
        "dq %.3f of their limits; repeat bit-equal %s; plain versions' "
        "peak extra device memory %.1f MB (limit %d) -> %s" % (
            b, h, b * h, sq, sk, d, ratio, err_l, res["flash_bwd_dkdv"][1],
            res["flash_bwd_dq"][1], same and res["deterministic"], plain_mb,
            BIG_BH_PLAIN_MB, "ok" if ok else "FAIL"))
    if not ok:
        raise RuntimeError("the kernels at B*H = %d disagree with their plain "
                           "versions" % (b * h))
    del inputs, q, k, v, do, o, lse, delta
    torch.cuda.empty_cache()


def time_wide(torch, att, gen, card):
    """The wide-head kernels (D > 256) at ``WIDE_TIMED``, f32, beside
    their plain versions; printed, not part of the kernels line."""
    for b, h, sq, sk, d, causal in WIDE_TIMED:
        inputs = bwd_inputs(torch, att, gen, b, h, sq, sk, d, causal,
                            torch.float32)
        q, k, v, do, o, lse, delta, scale = inputs
        for name, kern, plain in (
                ("flash_fwd",
                 lambda: att.flash_fwd(q, k, v, causal, scale),
                 lambda: att._chunked_attention(q, k, v, causal, scale)),
                ("flash_bwd_dkdv",
                 lambda: att.flash_bwd_dkdv(q, k, v, do, lse, delta, causal,
                                            scale),
                 lambda: att._flash_bwd_dkdv_plain(q, k, v, do, lse, delta,
                                                   causal, scale)),
                ("flash_bwd_dq",
                 lambda: att.flash_bwd_dq(q, k, v, do, lse, delta, causal,
                                          scale),
                 lambda: att._flash_bwd_dq_plain(q, k, v, do, lse, delta,
                                                 causal, scale))):
            ms = time_ms(torch, kern, 20)
            plain_ms = time_ms(torch, plain, 20)
            bound, by = kernel_bound_ms(name, b, h, sq, sk, d, causal,
                                        "float32", 4)
            log("kernel %s wide-head timing float32 b%d h%d sq%d sk%d d%d "
                "causal=%s on %s: kernel %.4f ms, plain %.4f ms, bound "
                "%.4f ms (%s), kernel at %.1f%% of bound" % (
                    name, b, h, sq, sk, d, causal, card, ms, plain_ms, bound,
                    by, 100.0 * bound / ms))
        del inputs, q, k, v, do, o, lse, delta


def phase_kernel(torch, card, seed):
    from mxnet_tpu_torch.ops import attention as att
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    worst = {}
    cases = CASES + [(1, 2, 128, 160, att.KERNEL_MAX_HEAD_DIM, True,
                      "float32", True)]
    for case in cases:
        ratio = check_fwd_case(torch, att, gen, case)
        worst[("flash_fwd", case[6])] = max(
            worst.get(("flash_fwd", case[6]), 0.0), ratio)
    for (b, h, sq, sk, d, causal, dtn, _) in cases:
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
    check_big_bh(torch, att, gen, worst)
    for (name, dtn), r in sorted(worst.items()):
        log("kernel worst error/limit over the cases: %s %s %.3f"
            % (name, dtn, r))
    time_wide(torch, att, gen, card)

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


def percentile(values, q):
    """The *q*-th percentile of *values*, by nearest rank."""
    s = sorted(values)
    rank = int(math.ceil(q / 100.0 * len(s)))
    return s[min(len(s), max(1, rank)) - 1]


def request_tokens(rng, n, seq=SEQ):
    """*n* requests of 1 to MAX_ROWS rows (uniform) of *seq* token ids."""
    return [rng.randint(0, VOCAB, (int(rng.randint(1, MAX_ROWS + 1)), seq))
            .astype("float32") for _ in range(n)]


def record_batches(pred):
    """Keep each stacked input the batcher dispatches (it calls
    ``pred.predict``).  Returns (the list, a function that restores
    ``pred.predict``)."""
    real = pred.predict
    batches = []

    def recording(data, key=None):
        batches.append(data["data0"].copy())
        return real(data, key=key)

    pred.predict = recording
    return batches, lambda: pred.__dict__.pop("predict", None)


class Answers:
    """The answered requests of one loop, each reduced by a few worker
    threads to its latency (submit to answer), its rows and the CRC-32
    of its output, then let go: an LM answer is 262 MB a row, so a loop
    of 100 requests cannot keep them all."""

    def __init__(self, n, timeout=600.0):
        self.records = [None] * n
        self._pool = concurrent.futures.ThreadPoolExecutor(DIGEST_WORKERS)
        self._jobs = []
        self._timeout = timeout

    def add(self, i, fut):
        """Digest request *i*'s future once it resolves."""
        self._jobs.append(self._pool.submit(self._digest, i, fut))

    def _digest(self, i, fut):
        out = fut.result(self._timeout)[0]
        self.records[i] = {"latency": fut._t_resolved - fut._t_enq,
                           "resolved": fut._t_resolved,
                           "rows": out.shape[0], "crc": crc32(out)}

    def wait(self):
        """Every record (None for a request never answered); re-raises
        the first failed answer."""
        try:
            for job in self._jobs:
                job.result()
        finally:
            self._pool.shutdown()
        return self.records


def crc32(a):
    """CRC-32 of a C-contiguous array's bytes (zlib drops the GIL)."""
    import zlib
    return zlib.crc32(memoryview(a).cast("B"))


def closed_loop(reg, name, xs, threads, answers, timeout=600.0):
    """*threads* clients, each submitting its share of *xs* one after
    another through ``reg.submit``, waiting for each answer and handing
    it to *answers*.  Returns the wall seconds until the last answer."""
    errors = []

    def client(mine):
        try:
            for i in mine:
                fut = reg.submit(name, xs[i])
                fut.result(timeout)
                answers.add(i, fut)
        except Exception as e:          # re-raised below
            errors.append(e)

    share = [list(range(t, len(xs), threads)) for t in range(threads)]
    workers = [threading.Thread(target=client, args=(m,)) for m in share]
    t0 = time.perf_counter()
    for w in workers:
        w.start()
    for w in workers:
        w.join(timeout)
    wall = time.perf_counter() - t0
    if any(w.is_alive() for w in workers):
        raise RuntimeError("a closed-loop client did not finish in %.0f s"
                           % timeout)
    if errors:
        raise errors[0]
    return wall


def open_loop(reg, name, xs, rate, answers):
    """Submit xs[i] at i / *rate* seconds after the first, whatever the
    answers, each handed to *answers*; then wait for all.  Returns the
    seconds from the first submit to the last answer."""
    t0 = time.monotonic()
    for i, x in enumerate(xs):
        delay = t0 + i / rate - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        answers.add(i, reg.submit(name, x))
    return max(r["resolved"] for r in answers.wait()) - t0


def traffic_stats(records, wall, seq=SEQ):
    """Latency percentiles and rates of one loop's answered *records*.
    p99 is None below P99_MIN_REQUESTS requests."""
    lat = [r["latency"] for r in records]
    rows = sum(r["rows"] for r in records)
    return {"requests": len(records), "rows": rows,
            "p50_ms": percentile(lat, 50) * 1e3,
            "p99_ms": percentile(lat, 99) * 1e3
            if len(lat) >= P99_MIN_REQUESTS else None,
            "requests_s": len(records) / wall,
            "tokens_s": rows * seq / wall, "wall_s": wall}


def batch_members(stacked, xs):
    """[(request index, first row)] of the requests a dispatched batch
    carried, in order: the batcher concatenates whole requests."""
    first = {x[0].tobytes(): i for i, x in enumerate(xs)}
    out, j = [], 0
    while j < len(stacked):
        i = first.get(stacked[j].tobytes())
        if i is None or not (stacked[j:j + len(xs[i])] == xs[i]).all():
            raise RuntimeError("batch row %d is no request's" % j)
        out.append((i, j))
        j += len(xs[i])
    return out


def check_coalesced(torch, pred, ev, batches, xs, records):
    """Hold each coalesced answer against the predictor's own predict of
    the stacked batch, bit for bit (the CRC-32 of each request's rows),
    and that predict against the same graph with the plain attention at
    the batch's rung (TOL_SERVE): an answer bit-equal to a predict within
    the limit is within it too.  Returns the mean occupancy (rows /
    rung), whether every answer was bit-equal, and the worst ratio of
    error to its limit."""
    bit_equal, worst, occupancy = True, 0.0, []
    dev = pred._dev
    host = None                         # one pinned readback buffer
    pool = concurrent.futures.ThreadPoolExecutor(DIGEST_WORKERS)
    try:
        for stacked in batches:
            rows = stacked.shape[0]
            shape = pred.ladder.pad_shape(stacked.shape)
            occupancy.append(rows / float(shape[0]))
            want = pred.predict(stacked)[0]._data
            pad = torch.zeros(shape, dtype=torch.float32, device=dev)
            pad[:rows, :stacked.shape[1]] = torch.from_numpy(stacked).to(dev)
            with torch.no_grad():
                plain = ev(dict(pred._params, data0=pad), {})[0][0][:rows]
            scale = max(1.0, plain.abs().max().item())
            err = (want - plain).abs().max().item()
            worst = max(worst, err / (TOL_SERVE * scale))
            if host is None or host.numel() < want.numel():
                host = torch.empty(want.numel(), dtype=want.dtype,
                                   pin_memory=dev.type == "cuda")
            got = host[:want.numel()].view(want.shape)
            got.copy_(want)
            got = got.numpy()
            members = batch_members(stacked, xs)
            crcs = pool.map(lambda m: crc32(got[m[1]:m[1] + len(xs[m[0]])]),
                            members)
            for (i, _), crc in zip(members, crcs):
                bit_equal = bit_equal and records[i]["crc"] == crc
            del want, plain, pad, got
    finally:
        pool.shutdown()
    return {"occupancy": sum(occupancy) / len(occupancy),
            "bit_equal": bit_equal, "worst": worst}


def serve_failures(s):
    """The checks of phase 4 over its record *s*; returns what failed
    (an empty list when every check passed)."""
    out = []
    if not s["closed_batches"] < s["closed_requests"]:
        out.append("the closed loop did not coalesce: %d batches for %d "
                   "requests" % (s["closed_batches"], s["closed_requests"]))
    if s["compiles_after"] != s["compiles_warm"] + 1:
        out.append("compile_count %d -> %d through the traffic, expected "
                   "one capture (the 1024 rung)"
                   % (s["compiles_warm"], s["compiles_after"]))
    if s["unresolved"]:
        out.append("%d futures unresolved" % s["unresolved"])
    for rung, got in sorted(s["captured"].items()):
        if got != {"flash_fwd": LAYERS}:
            out.append("rung %s captured launches %s, expected flash_fwd %d"
                       % (rung, got, LAYERS))
    if s["graph_launches"] != LAYERS * s["dispatches"]:
        out.append("graph launches %d != %d layers x %d dispatches"
                   % (s["graph_launches"], LAYERS, s["dispatches"]))
    if s["replays"] != s["dispatches"]:
        out.append("%d replays for %d dispatches" % (s["replays"],
                                                     s["dispatches"]))
    if s["traffic_wrapper"] != LAYERS:
        out.append("the traffic launched flash_fwd %d times from its "
                   "wrapper, expected %d (the 1024 rung's warm-up)"
                   % (s["traffic_wrapper"], LAYERS))
    if s["traffic_captured"] != LAYERS:
        out.append("the traffic captured flash_fwd %d times, expected %d "
                   "(the 1024 rung's capture)"
                   % (s["traffic_captured"], LAYERS))
    for what in ("bit_equal_closed", "bit_equal_open"):
        if not s[what]:
            out.append("%s: a coalesced answer is not bit-equal to predict "
                       "of its stacked batch" % what)
    for what in ("worst_closed", "worst_open", "worst_direct",
                 "worst_graph_eager", "pad_ratio"):
        if not s[what] <= 1.0:
            out.append("%s: %.4g of the limit" % (what, s[what]))
    if not s["profile_flash_fwd"] > 0:
        out.append("no flash_fwd kernel in the profiled replay")
    return out


def graph_vs_eager(torch, pred, rng, card, what, rows_list, make_input,
                   limit):
    """For each rung: ms of a request, from its host input to its
    answer on the device, through the graph (``predict``: pad on the
    host, copy in, replay, clone out) against the same eager graph (pad
    on the host, copy in, run op by op), each over GRAPH_ITERS runs, and
    the replay's error against eager as a share of *limit* x max(1,
    max |eager|).  Returns the worst share."""
    worst = 0.0
    name = next(iter(pred._data_shapes))
    for rows in rows_list:
        x = make_input(rng, rows)
        shape = pred.ladder.pad_shape(x.shape)
        times, peak = {}, {}

        def eager():
            pad = torch.zeros(shape, dtype=torch.float32)
            pad[:rows] = torch.from_numpy(x)
            return pred._run({name: pad.to(pred._dev)})[0][:rows]
        for mode, run in (
                ("graph", lambda: pred.predict(x)[0]._data),
                ("eager", eager)):
            out = run()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            for _ in range(GRAPH_ITERS):
                out = run()
            torch.cuda.synchronize()
            times[mode] = (time.perf_counter() - t0) * 1e3 / GRAPH_ITERS
            peak[mode] = torch.cuda.max_memory_allocated() / 1e9
            if mode == "graph":
                got = out
            else:
                want = out
        scale = max(1.0, want.abs().max().item())
        share = (got - want).abs().max().item() / (limit * scale)
        worst = max(worst, share)
        log("%s: %d rows (rung %d): graph %.3f ms, eager %.3f ms per "
            "request (%d runs each), peak device memory %.3f / %.3f GB; "
            "replay vs eager %.4f of the limit (%g x max(1, max|eager|)), "
            "bit-equal %s on %s" % (
                what, rows, shape[0], times["graph"], times["eager"],
                GRAPH_ITERS, peak["graph"], peak["eager"], share, limit,
                torch.equal(got, want), card))
        del got, want, out
    return worst


def phase_serve(torch, card, seed):
    """Phase 4: the LM served through ``registry.submit`` with one CUDA
    graph per rung.  Raises without CUDA: it never runs on the CPU.
    Returns the path's flash_fwd launches: the wrapper's ("eager": the
    first forward and each rung's warm-up run; a capture only records)
    and the graphs' (replays x captured) of the warm replays and direct
    requests ("direct") and of the batched traffic's dispatches
    ("traffic")."""
    if not torch.cuda.is_available():
        raise RuntimeError("phase 4 needs a CUDA device")
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
    rec = {}

    # the main path, in segments: the wrapper's count is set to 0 before
    # each and read after it; comparisons run between segments
    att.flash_fwd.launches = att.flash_fwd.captured = 0
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
    ladder = mx.serve.BucketLadder(batches=RUNGS, seq_axes=SERVE_SEQ_AXES,
                                   seq_max=SERVE_SEQ_MAX)
    t0 = time.perf_counter()
    pred = reg.load_checkpoint("lm", prefix, 0,
                               data_shapes={"data0": (1, SEQ)},
                               ladder=ladder, ctx=ctx)
    rec["captured"] = {b: pred.captured_launches(pred.rung_shapes(b))
                       for b in RUNGS}
    rec["compiles_warm"] = pred.compile_count
    log("serve: load_checkpoint + warm of %r in %.2f s: %d CUDA graphs "
        "captured (compile_count), flash_fwd launches captured per rung %s; "
        "graph pool and the rest: %.3f GB allocated, %.3f GB reserved" % (
            ladder, time.perf_counter() - t0, pred.compile_count,
            rec["captured"], torch.cuda.memory_allocated() / 1e9,
            torch.cuda.memory_reserved() / 1e9))
    answers = []
    for rows in REQUESTS:
        x = rng.randint(0, VOCAB, (rows, SEQ)).astype("float32")
        w0, g0 = att.flash_fwd.launches, pred.graph_launches()["flash_fwd"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = reg.predict("lm", x)[0]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        grew = (att.flash_fwd.launches - w0,
                pred.graph_launches()["flash_fwd"] - g0)
        log("serve: request of %d rows (rung %d): %.2f ms, %.0f tokens/s, "
            "flash_fwd wrapper +%d, graph launches +%d on %s" % (
                rows, pred.ladder.batch_for(rows), dt * 1e3,
                rows * SEQ / dt, grew[0], grew[1], card))
        if grew != (0, LAYERS):
            raise RuntimeError("request of %d rows: flash_fwd wrapper and "
                               "graph launches grew %s, expected (0, %d)"
                               % (rows, grew, LAYERS))
        answers.append((x, out._data))
    wrapper, captured = att.flash_fwd.launches, att.flash_fwd.captured
    direct_graph = pred.graph_launches()["flash_fwd"]
    expected = (LAYERS * (1 + len(RUNGS)), LAYERS * len(RUNGS))
    log("serve: flash_fwd on the load path: %d launches from the wrapper "
        "(expected %d: %d layers x (1 forward + %d rung warm-ups)), %d "
        "recorded by captures (expected %d)"
        % (wrapper, expected[0], LAYERS, len(RUNGS), captured, expected[1]))
    if (wrapper, captured) != expected:
        raise RuntimeError("serving path launches and captures %s != %s"
                           % ((wrapper, captured), expected))

    # the direct requests against the same graph with the plain attention
    def plain_dpa(query, key, value, causal=False, sm_scale=None,
                  chunk=512):
        return att._chunked_attention(query, key, value, bool(causal),
                                      sm_scale, chunk)
    ev = _build_eval(pred._symbol, False, op_impls={
        "_contrib_DotProductAttention": plain_dpa})
    rec["worst_direct"] = 0.0
    for x, got in answers:
        rows = x.shape[0]
        pad = torch.zeros((pred.ladder.batch_for(rows), SEQ),
                          dtype=torch.float32, device="cuda")
        pad[:rows] = torch.from_numpy(x).cuda()
        with torch.no_grad():
            want = ev(dict(pred._params, data0=pad), {})[0][0][:rows]
        if tuple(got.shape) != (rows, SEQ, VOCAB) or \
                not bool(torch.isfinite(got).all()):
            raise RuntimeError("request of %d rows: bad output" % rows)
        scale = max(1.0, want.abs().max().item())
        err = (got - want).abs().max().item()
        rec["worst_direct"] = max(rec["worst_direct"],
                                  err / (TOL_SERVE * scale))
        log("serve: request of %d rows vs plain-attention graph: max abs "
            "err %.3g, max |logit| %.3g (tol %g x max(1, max|logit|)) -> %s"
            % (rows, err, scale, TOL_SERVE,
               "ok" if err <= TOL_SERVE * scale else "FAIL"))
    del answers

    # the batched traffic: closed loop, open loop at half its rate, then
    # two direct requests that round to the 1024 rung
    batcher = reg.batcher("lm", max_wait_ms=MAX_WAIT_MS)
    xs_closed = request_tokens(rng, CLOSED_THREADS * CLOSED_PER_THREAD)
    rec.update(traffic_wrapper=0, traffic_captured=0, replays=0,
               dispatches=0, graph_launches=0, unresolved=0)

    def segment(run):
        """Run one traffic segment with the wrapper's counts set to 0;
        returns (its result, its graph launches)."""
        att.flash_fwd.launches = att.flash_fwd.captured = 0
        r0, d0 = pred.replay_count, pred.dispatch_count
        g0 = pred.graph_launches()["flash_fwd"]
        out = run()
        grew = pred.graph_launches()["flash_fwd"] - g0
        rec["traffic_wrapper"] += att.flash_fwd.launches
        rec["traffic_captured"] += att.flash_fwd.captured
        rec["replays"] += pred.replay_count - r0
        rec["dispatches"] += pred.dispatch_count - d0
        rec["graph_launches"] += grew
        return out, grew

    loops, traffic_graph = {}, 0
    for loop in ("closed", "open"):
        batches, restore = record_batches(pred)
        b0, q0 = batcher.batch_count, batcher.request_count
        torch.cuda.reset_peak_memory_stats()
        if loop == "closed":
            xs = xs_closed
            answers = Answers(len(xs))
            wall, grew = segment(lambda: closed_loop(
                reg, "lm", xs, CLOSED_THREADS, answers))
            records = answers.wait()
        else:
            rate = OPEN_SHARE * loops["closed"]["requests_s"]
            xs = request_tokens(rng, OPEN_REQUESTS)
            answers = Answers(len(xs))
            wall, grew = segment(lambda: open_loop(reg, "lm", xs, rate,
                                                   answers))
            records = answers.records
        traffic_graph += grew
        restore()
        peak = torch.cuda.max_memory_allocated()
        rec["unresolved"] += sum(1 for r in records if r is None)
        rec["%s_batches" % loop] = batcher.batch_count - b0
        rec["%s_requests" % loop] = batcher.request_count - q0
        st = loops[loop] = traffic_stats([r for r in records if r], wall)
        chk = check_coalesced(torch, pred, ev, batches, xs, records)
        rec["bit_equal_%s" % loop] = chk["bit_equal"]
        rec["worst_%s" % loop] = chk["worst"]
        log("serve %s loop on %s: %d requests (%d rows of %d tokens) in %d "
            "batches%s: p50 %.2f ms, p99 %s, %.3f requests/s, %.0f "
            "tokens/s over %.3f s; occupancy %.3f rows/rung; every answer "
            "bit-equal to predict of its stacked batch: %s; worst vs the "
            "plain-attention graph %.4f of the limit; peak device memory "
            "%.3f GB" % (
                loop, card, st["requests"], st["rows"], SEQ,
                len(batches), "" if loop == "closed" else
                " (arrivals at %.3f requests/s, %.0f %% of the closed "
                "loop's)" % (rate, 100 * OPEN_SHARE), st["p50_ms"],
                "not measured (fewer than %d requests)" % P99_MIN_REQUESTS
                if st["p99_ms"] is None else "%.2f ms" % st["p99_ms"],
                st["requests_s"], st["tokens_s"], st["wall_s"],
                chk["occupancy"], chk["bit_equal"], chk["worst"],
                peak / 1e9))
        del answers, records, batches

    def direct():
        outs = []
        for seq in DIRECT_SEQS:
            x = rng.randint(0, VOCAB, (1, seq)).astype("float32")
            outs.append((x, reg.predict("lm", x)[0]._data))
            log("serve: direct request of %d tokens -> bucket %s, "
                "compile_count %d" % (seq, ladder.pad_shape(x.shape),
                                      pred.compile_count))
        return outs
    short, grew = segment(direct)
    rec["compiles_after"] = pred.compile_count
    wrapper += rec["traffic_wrapper"]
    direct_graph += grew

    # pad invariance: the first 700 positions of the 1024-padded answer
    x, got = short[0]
    with torch.no_grad():
        want = pred._run({"data0": torch.from_numpy(x).cuda()})[0]
    scale = max(1.0, want.abs().max().item())
    err = (got[:, :x.shape[1]] - want).abs().max().item()
    rec["pad_ratio"] = err / (TOL_SERVE * scale)
    log("serve: %d tokens padded to %d vs unpadded eager: max abs err %.3g, "
        "%.4f of the limit" % (x.shape[1], got.shape[1], err,
                               rec["pad_ratio"]))
    del short, got, want

    rec["worst_graph_eager"] = graph_vs_eager(
        torch, pred, rng, card, "serve graph vs eager", RUNGS,
        lambda r, rows: r.randint(0, VOCAB, (rows, SEQ)).astype("float32"),
        TOL_SERVE)
    x8 = rng.randint(0, VOCAB, (RUNGS[-1], SEQ)).astype("float32")
    shares = profile(torch, lambda: reg.predict("lm", x8),
                     "serve profile, one graph replay of rung %d"
                     % RUNGS[-1], card)
    rec["profile_flash_fwd"] = (shares or {}).get("flash_fwd", 0.0)
    # the batcher's readback of a coalesced answer, alone
    out = reg.predict("lm", x8)[0]._data
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    host = out.cpu()
    dt = time.perf_counter() - t0
    gb = out.numel() * out.element_size() / 1e9
    log("serve: readback of one rung-%d answer (%.3f GB, .cpu() as the "
        "batcher does): %.2f ms, %.2f GB/s on %s" % (
            RUNGS[-1], gb, dt * 1e3, gb / dt, card))
    del out, host
    log("serve: the path's flash_fwd launches: %d from the wrapper (first "
        "forward, %d rung warm-ups), %d by graph replays x captured of the "
        "warm replays and direct requests, %d of the batched traffic's "
        "dispatches; %d replays for %d dispatches in the traffic; peak "
        "device memory %.3f GB" % (
            wrapper, len(RUNGS) + 1, direct_graph, traffic_graph,
            rec["replays"], rec["dispatches"],
            torch.cuda.max_memory_allocated() / 1e9))
    failures = serve_failures(rec)
    reg.close()
    del reg, pred, ev
    shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    if failures:
        raise RuntimeError("phase 4 failed: " + "; ".join(failures))
    return {"eager": wrapper, "direct": direct_graph,
            "traffic": traffic_graph}


# kernel-name shares the attention paths' profiles report
ATTENTION_SHARES = (
    ("flash_fwd", lambda k: "flash_fwd" in k),
    ("flash_bwd_dkdv", lambda k: "dkdv" in k),
    ("flash_bwd_dq", lambda k: "flash_bwd_dq" in k),
    ("GEMM", lambda k: "gemm" in k or "cutlass" in k or "sm90" in k))


def profile(torch, run, what, card, shares=ATTENTION_SHARES, ranges=()):
    """Where one run's device time goes, by kernel (torch.profiler):
    the device-time share of each (label, predicate on the lowercased
    kernel name) of *shares*, the idle share and the top kernels; for each
    ``record_function`` name in *ranges*, the share of the kernels launched
    inside it.  Returns {label: share} (ranges under their names, and
    "idle" when it can be read), or None when the trace holds no device
    time (reported as not measured)."""
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
        if e.device_type != DeviceType.CUDA or e.key in ranges:
            # host-side ops also carry their kernels' time, and a range
            # also appears as a device-side annotation spanning its kernels
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            rows.append((us, e.key, e.count))
    total = sum(r[0] for r in rows)
    if total <= 0:
        log("%s: device time not measured (the trace holds no CUDA kernel "
            "time)" % what)
        return None

    def share(pred):
        return sum(r[0] for r in rows if pred(r[1].lower())) / total

    shares = {label: share(pred) for label, pred in shares}
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
    for name in ranges:
        us = sum(e.device_time_total for e in prof.events()
                 if e.name == name and e.device_type == DeviceType.CPU)
        shares[name] = us / total
        log("  range %s: %.3f ms of device time, share %.3f"
            % (name, us / 1e3, us / total))
    if total <= wall_us:
        shares["idle"] = 1.0 - total / wall_us
    for us, key, count in sorted(rows, reverse=True)[:10]:
        log("  %9.3f ms  x%-4d %s" % (us / 1e3, count, key[:110]))
    return shares


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


def within(err, scale, tol):
    """(ratio of *err* to its limit tol * max(1, scale), ok)."""
    ratio = err / (tol * max(1.0, scale))
    return ratio, ratio <= 1.0


def worst_share(gaps):
    """The largest per-parameter gap as a share of max |g| (the first of
    each ``grad_gaps`` pair)."""
    return max(v[0] for v in gaps.values())


def resnet_net(mx, vision, gen, ctx, dtype="float32", prefix=None):
    """The phase's ResNet-50 v1, initialized from *gen*."""
    net = vision.get_model(RESNET, classes=RESNET_CLASSES, prefix=prefix)
    net.initialize(mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                  magnitude=2), ctx=ctx, generator=gen)
    if dtype != "float32":
        net.cast(dtype)
    return net


def tf32_convolutions(torch):
    """A scope in which the port's f32 convolutions run in TF32 (forward
    and backward): the pass that the f64 limits must catch."""
    from unittest import mock
    from mxnet_tpu_torch.ops import nn as nn_ops
    return mock.patch.object(
        nn_ops, "conv_precision",
        lambda dtype: "tf32" if dtype == torch.float32 else None)


def resnet_serve(torch, card, mx, ctx, net, rng, tmp):
    """Phase 6 (a): export, serve requests of 1, 8 and 32 images, hold
    each answer against the f64 graph, and show TF32 convolutions break
    that limit."""
    from mxnet_tpu_torch.executor import _build_eval
    prefix = os.path.join(tmp, "resnet")
    net.export(prefix, 0)
    reg = mx.serve.ModelRegistry()
    t0 = time.perf_counter()
    shape = (1, 3, RESNET_IMAGE, RESNET_IMAGE)
    pred = reg.load_checkpoint(
        "resnet", prefix, 0, data_shapes={"data0": shape},
        ladder=mx.serve.BucketLadder(batches=RESNET_RUNGS), ctx=ctx)
    log("resnet serve: load_checkpoint (%d arg, %d aux arrays) + warm of "
        "rungs %s in %.2f s" % (len(pred._params), len(pred._aux),
                                RESNET_RUNGS, time.perf_counter() - t0))
    answers = []
    for rows in RESNET_REQUESTS:
        x = rng.randn(rows, *shape[1:]).astype("float32")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = reg.predict("resnet", x)[0]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        log("resnet serve: request of %d images (rung %d): %.3f ms, %.1f "
            "images/s on %s" % (rows, pred.ladder.batch_for(rows), dt * 1e3,
                                rows / dt, card))
        if tuple(out.shape) != (rows, RESNET_CLASSES) or \
                not bool(torch.isfinite(out._data).all()):
            raise RuntimeError("request of %d images: bad output %s"
                               % (rows, out.shape))
        answers.append((x, out._data))

    ev = _build_eval(pred._symbol, False)
    p64 = {n: t.double() for n, t in pred._params.items()}
    a64 = {n: t.double() for n, t in pred._aux.items()}
    ok = True
    for x, got in answers:
        rows = x.shape[0]
        pad = torch.zeros((pred.ladder.batch_for(rows),) + shape[1:],
                          dtype=torch.float32, device=ctx.torch_device)
        pad[:rows] = torch.from_numpy(x)
        with torch.no_grad():
            with mx.enable_x64():       # the f64 oracle keeps 64 bits
                want = ev(dict(p64, data0=pad.double()), a64)[0][0][:rows]
            with tf32_convolutions(torch):
                low = ev(dict(pred._params, data0=pad), pred._aux)[0][0]
        scale = want.abs().max().item()
        err = (got.double() - want).abs().max().item()
        err_tf32 = (low[:rows].double() - want).abs().max().item()
        ratio, good = within(err, scale, TOL_RESNET_SERVE)
        ratio_tf32, tf32_passes = within(err_tf32, scale, TOL_RESNET_SERVE)
        ok = ok and good and not tf32_passes
        log("resnet serve: request of %d images vs the f64 graph: max abs "
            "err %.4g, max |logit| %.4g, %.4f of the limit (%g x max(1, "
            "max|logit|)); TF32 convolutions: max abs err %.4g, %.3f of "
            "the limit (must exceed 1) -> %s" % (
                rows, err, scale, ratio, TOL_RESNET_SERVE, err_tf32,
                ratio_tf32, "ok" if good and not tf32_passes else "FAIL"))
    if not ok:
        raise RuntimeError("served ResNet logits against the f64 graph "
                           "failed (above)")
    del answers, ev, p64, a64
    worst = graph_vs_eager(
        torch, pred, rng, card, "resnet serve graph vs eager",
        RESNET_REQUESTS,
        lambda r, rows: r.randn(rows, *shape[1:]).astype("float32"),
        TOL_RESNET_SERVE)
    if not worst <= 1.0:
        raise RuntimeError("a ResNet replay disagrees with eager: %.4f of "
                           "the limit" % worst)
    reg.close()
    del reg, pred


def resnet_check_step(torch, card, mx, ctx, vision, net, loss_fn, trainer,
                      rng):
    """Phase 6 (b): one step at batch 32 from one set of weights in f32
    and in f64 on the card: the loss, every gradient (ReLU masks frozen
    to the f64 run's) and the running statistics after the step; a TF32
    run must break the gradient limit."""
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.executor import _build_eval
    from mxnet_tpu_torch.ndarray import NDArray
    b = RESNET_CHECK_BATCH
    x = mx.nd.array(rng.randn(b, 3, RESNET_IMAGE, RESNET_IMAGE)
                    .astype("float32"), ctx=ctx)
    y = mx.nd.array(rng.randint(0, RESNET_CLASSES, (b,)).astype("float32"),
                    ctx=ctx)
    graph = net._cached_graph
    params = net.collect_params()
    # the f64 oracle keeps 64 bits only inside enable_x64(): outside it
    # cast("float64") narrows, as the reference does without x64
    with mx.enable_x64():
        net64 = resnet_net(mx, vision, None, ctx, "float64",
                           prefix=net.prefix)
        params64 = net64.collect_params()
        for n, p in params64.items():
            p.set_data(params[n].data())

    def run(ps, data, relu, low=False):
        """One forward and backward of the net's train graph on the
        parameters *ps*; returns (loss, grads, running stats after)."""
        ev = _build_eval(graph.symbol, True, op_impls={"Activation": relu})
        amap = {n: ps[n].data()._data for n in graph.param_names}
        amap["data0"] = data
        aux = {n: ps[n].data()._data for n in graph.aux_names}
        with autograd.record(), torch.enable_grad():
            if low:
                with tf32_convolutions(torch):
                    outs, stats = ev(amap, aux)
            else:
                outs, stats = ev(amap, aux)
            loss = loss_fn(NDArray(outs[0]), y)
            loss.backward()
        grads = {n: ps[n].grad()._data.clone() for n in graph.param_names}
        return loss.asnumpy(), grads, stats

    t0 = time.perf_counter()
    relu64, masks = relu_op(torch)
    with mx.enable_x64():
        loss64, g64, stats64 = run(params64, x._data.double(), relu64)
    torch.cuda.synchronize()
    t64 = time.perf_counter() - t0
    del net64, params64
    relu32, seen = relu_op(torch, masks)
    _, g32, _ = run(params, x._data, relu32)
    flips = sum(int((a != m).sum()) for a, m in zip(seen, masks))
    units = sum(int(m.numel()) for m in masks)
    del seen
    relu_low, _ = relu_op(torch, masks)
    _, g_low, _ = run(params, x._data, relu_low, low=True)
    del masks
    gaps = grad_gaps(torch, g32, {n: g.float() for n, g in g64.items()})
    gaps_low = grad_gaps(torch, g_low, {n: g.float() for n, g in g64.items()})
    del g32, g_low, g64

    # the user's path: record -> loss -> backward -> Trainer.step
    with autograd.record():
        loss = loss_fn(net(x), y)
    loss.backward()
    trainer.step(b)
    loss32 = loss.asnumpy()
    stat_worst, stat_name = 0.0, None
    for n, want in stats64.items():
        got = params[n].data()._data.double()
        r, _ = within((got - want).abs().max().item(),
                      want.abs().max().item(), TOL_RESNET_STATS)
        if r >= stat_worst:
            stat_worst, stat_name = r, n
    loss_ratio, loss_ok = within(
        float(abs(loss32.mean() - loss64.mean())), abs(loss64.mean()),
        TOL_RESNET_LOSS)
    g_worst, l_worst = worst_share(gaps), worst_share(gaps_low)
    ok = loss_ok and stat_worst <= 1.0 and \
        len(stats64) == len(graph.aux_names) > 0 and \
        g_worst <= TOL_RESNET_GRAD < l_worst
    log("resnet check step, batch %d on %s (f64 forward and backward "
        "%.2f s): mean loss f32 %.7f, f64 %.7f, %.4f of the limit (%g x "
        "max(1, |loss|))" % (b, card, t64, float(loss32.mean()),
                             float(loss64.mean()), loss_ratio,
                             TOL_RESNET_LOSS))
    log("resnet check step: %d running statistics after the step vs f64: "
        "worst %.4f of the limit (%g x max(1, max|stat|), %s)" % (
            len(stats64), stat_worst, TOL_RESNET_STATS, stat_name))
    log("resnet check step: ReLU units that take the other branch than "
        "f64's, of %d: %d (frozen to f64's masks below)" % (units, flips))
    log("resnet check step, f32 vs f64, masks frozen: %s" % gap_text(gaps))
    log("resnet check step, TF32 convolutions vs f64, masks frozen: %s"
        % gap_text(gaps_low))
    log("resnet check step: f32 gradients worst %.4g of max |g| (limit "
        "%g), TF32 convolutions %.4g (must exceed the limit) -> %s" % (
            g_worst, TOL_RESNET_GRAD, l_worst, "ok" if ok else "FAIL"))
    if not ok:
        raise RuntimeError("the ResNet check step failed (above)")


def resnet_train(torch, card, mx, ctx, net, loss_fn, trainer, rng):
    """Phase 6 (c): six steps at batch 128 on a fixed batch, steps 2-6
    timed; the loss must fall from step 1 to step 6; peak memory; one
    profiled step beside the f32 bound."""
    from mxnet_tpu_torch import autograd
    b = RESNET_BATCH
    x = mx.nd.array(rng.randn(b, 3, RESNET_IMAGE, RESNET_IMAGE)
                    .astype("float32"), ctx=ctx)
    y = mx.nd.array(rng.randint(0, RESNET_CLASSES, (b,)).astype("float32"),
                    ctx=ctx)

    def step():
        with autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(b)
        return float(loss.asnumpy().mean())     # waits for the step

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for i in range(RESNET_STEPS):
        t0 = time.perf_counter()
        losses.append(step())
        times.append(time.perf_counter() - t0)
        log("resnet train: step %d: loss %.6f, %.2f ms on %s" % (
            i + 1, losses[-1], times[-1] * 1e3, card))
    peak = torch.cuda.max_memory_allocated()
    ms = 1e3 * sum(times[1:]) / len(times[1:])
    flop = 3 * RESNET_FWD_FLOP * b
    bound = flop / PEAK_FLOPS["float32"] * 1e3
    log("resnet train: batch %d x %d^2: ms per step %.2f (steps 2-%d), "
        "%.1f images/s; f32 bound %.2f ms (3 x %.4g x %d flop over %.0f "
        "TFLOP/s), step at %.1f%% of it; peak device memory %.3f GB of "
        "%.1f on %s" % (
            b, RESNET_IMAGE, ms, RESNET_STEPS, b / ms * 1e3, bound,
            RESNET_FWD_FLOP, b, PEAK_FLOPS["float32"] / 1e12,
            100.0 * bound / ms, peak / 1e9,
            torch.cuda.get_device_properties(0).total_memory / 1e9, card))
    shares = profile(torch, step, "resnet train profile, one step of batch "
                     "%d x %d^2" % (b, RESNET_IMAGE), card, RESNET_SHARES)
    if shares is not None:
        log("resnet train profile: device time in kernels named tf32: "
            "%.4f (must be 0: the f32 convolutions run in full f32)"
            % shares["TF32 kernels"])
    if not all(math.isfinite(v) for v in losses) or \
            not losses[-1] < losses[0]:
        raise RuntimeError("the ResNet loss did not fall over %d steps: %s"
                           % (RESNET_STEPS, losses))
    if shares is not None and shares["TF32 kernels"] > 0:
        raise RuntimeError("the f32 training step ran TF32 kernels")
    return {"ms": ms, "images_s": b / ms * 1e3, "bound_ms": bound,
            "peak_gb": peak / 1e9, "losses": losses, "shares": shares}


def phase_resnet(torch, card, seed):
    """Phase 6: ResNet-50 v1 served, checked against f64 and trained on
    the card.  Raises without CUDA: it never runs on the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError("phase 6 needs a CUDA device")
    import numpy as np
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon.model_zoo import vision

    log("resnet: cuDNN's process default f32 convolution precision: %r "
        "(the port's Convolution runs f32 in 'ieee' whatever it is)"
        % torch.backends.cudnn.conv.fp32_precision)
    ctx = mx.gpu(0)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 2)
    rng = np.random.RandomState(seed + 2)
    t0 = time.perf_counter()
    net = resnet_net(mx, vision, gen, ctx)
    net.hybridize()
    first = net(mx.nd.array(rng.randn(1, 3, RESNET_IMAGE, RESNET_IMAGE)
                            .astype("float32"), ctx=ctx))
    params = net.collect_params()
    trainable = [p for p in params.values() if p.grad_req != "null"]
    log("resnet: built %s (%d trainable arrays, %d values; %d running "
        "statistics, %d values), hybridized and ran one forward in %.2f s"
        % (RESNET, len(trainable),
           sum(int(np.prod(p.shape)) for p in trainable),
           len(params) - len(trainable),
           sum(int(np.prod(p.shape)) for p in params.values()
               if p.grad_req == "null"), time.perf_counter() - t0))
    if tuple(first.shape) != (1, RESNET_CLASSES) or \
            not np.isfinite(first.asnumpy()).all():
        raise RuntimeError("first forward: bad output %s" % (first.shape,))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_resnet_")
    try:
        resnet_serve(torch, card, mx, ctx, net, rng, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = gluon.Trainer(params, "sgd", {
        "learning_rate": RESNET_CHECK_LR, "momentum": RESNET_MOMENTUM})
    resnet_check_step(torch, card, mx, ctx, vision, net, loss_fn, trainer,
                      rng)
    del net, trainer, params
    torch.cuda.empty_cache()
    # the timed steps train a fresh net from the same generator
    net = resnet_net(mx, vision, gen, ctx)
    net.hybridize()
    trainer = gluon.Trainer(net.collect_params(), "sgd", {
        "learning_rate": RESNET_LR, "momentum": RESNET_MOMENTUM})
    res = resnet_train(torch, card, mx, ctx, net, loss_fn, trainer, rng)
    del net, trainer
    torch.cuda.empty_cache()
    return res


# phase 7: the north-star trainer, ``ParallelTrainer`` with bf16 compute
# weights, float32 masters and LARS, as bench.py:223-272 drives it
# (lbsgd, lr 0.1, eta 0.001, momentum 0.9, multi_precision, dp = 1 mesh,
# batch 128 x 224^2, bench.py:1814-1838), and the transformer LM as
# tools/benchmark_lm.py:60-92 drives it (sgd, lr 0.01, momentum 0.9,
# multi_precision, int32 ids, batch 8 x 2048).
NS_OPT = {"learning_rate": 0.1, "eta": 0.001, "momentum": 0.9}
NS_WARMUP, NS_STEPS = 2, 10
NS_FALL = 6                  # the loss must fall from step 1 to step 6
NS_OFF_STEPS = 3             # timed steps with coalesce_small=False
NS_CHECK_BATCH = 32
LM_NS_OPT = {"learning_rate": 0.01, "momentum": 0.9}
LM_NS_STEPS = 4              # the loss must fall from step 1 to step 4
# (b) the update against float64 LARS + mp_sgd_mom from the same
# gradients and masters.  The float32 update rounds w + m, momentum * m
# and lr_n * g' once each (2**-24 relative), and lr_n carries the float32
# norms' summation error (a reduction over up to 2.4e6 terms that adds
# some tens of terms in sequence in each thread before its tree: some
# tens of units of 2**-24 relative): each master element is held to
# 2**-UPDATE_BITS times |w| + momentum |m| + |lr_n g'|, 256 units of
# float32 rounding.  Both wrong variants move an element by far more:
# dropping eta scales the step by 1000, and starting from the bf16
# weight moves w by up to 2**-9 |w|.
UPDATE_BITS = 16
# (c) and (d): bf16 compute against float64 and the LM's kernels against
# the plain attention, both in units of bf16's unit roundoff 2**-8.  bf16
# rounds every convolution output, and BatchNorm's mean subtraction
# amplifies that rounding wherever a channel's mean is large against its
# spread, 53 times over: at ResNet-50's initial weights (batch 32, ReLU
# masks frozen) the first H100 run measured the bf16 loss 13.2 units from
# f64's and the whole gradient 103.5 units (L2, 0.40 relative), against
# 1.8e-5 and 0.034 units for f32; the bf16 gradient of another batch sits
# at 363 units.  The gradient limit is near the geometric mean of 103.5
# and 363, the loss limit the power of two above 2 x 13.2 (PERF.md,
# north-star findings); f32 must sit within 1/16 of each.
BF16_U = 2.0 ** -8
TOL_NS_LOSS = 32.0           # x BF16_U x max(1, |loss|)
TOL_NS_GRAD = 192.0          # x BF16_U, ||g - g64|| / ||g64|| over all
TOL_LM_NS_LOSS = 1.0         # x BF16_U x max(1, |loss|)
# device-time shares of the north-star ResNet step: kernels by name, the
# optimizer by its profiler range
NS_RANGE = "ParallelTrainer._apply_update"
GEMM_KEYS = ("gemm", "cutlass", "nvjet", "sm90_xmma")
NS_SHARES = (
    ("convolution", lambda k: any(c in k for c in CONV_KEYS)),
    ("GEMM", lambda k: not any(c in k for c in CONV_KEYS) and
     any(g in k for g in GEMM_KEYS)))
LM_NS_SHARES = (
    ("flash_fwd bf16", lambda k: "flash_fwd" in k and "bfloat16" in k),
    ("flash_bwd_dkdv bf16", lambda k: "dkdv" in k and "bfloat16" in k),
    ("flash_bwd_dq bf16", lambda k: "flash_bwd_dq" in k and
     "bfloat16" in k),
    ("flash, not bf16", lambda k: "flash" in k and "bfloat16" not in k),
    ("bf16 GEMM", lambda k: "flash" not in k and
     any(g in k for g in GEMM_KEYS)))


def ns_trainer(torch, mx, net, optimizer, opt_params, device, **kw):
    """A multi-precision ``ParallelTrainer`` on a dp = 1 mesh of
    *device*."""
    from mxnet_tpu_torch.parallel import ParallelTrainer, make_mesh
    return ParallelTrainer(
        net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), optimizer=optimizer,
        optimizer_params=dict(opt_params),
        mesh=make_mesh({"dp": 1}, [device]), multi_precision=True, **kw)


def lars_mp_f64(torch, w, m, g, lr, opt, eta=True):
    """One LARS + mp_sgd_mom update in float64 from master *w*, momentum
    *m* and gradient *g*: (new w, new m, the bound's scale |w| + momentum
    |m| + |lr_n g'|).  ``eta=False`` is the wrong variant that drops eta
    from the trust ratio."""
    w, m, g = w.double(), m.double(), g.double()
    wd = float(opt.get("wd", 0.0))
    momentum = float(opt.get("momentum", 0.0))
    wn, gn = torch.linalg.vector_norm(w), torch.linalg.vector_norm(g)
    trust = (float(opt.get("eta", 0.001)) if eta else 1.0) * wn / (
        gn + wd * wn + float(opt.get("epsilon", 1e-9)))
    if not (wn > 0 and gn > 0):
        trust = torch.ones_like(wn)
    step = lr * trust * (g * float(opt.get("rescale_grad", 1.0)) + wd * w)
    m_new = momentum * m - step
    return w + m_new, m_new, w.abs() + momentum * m.abs() + step.abs()


def copy_state(torch, src, dst):
    """Give trainer *dst* the params, optimizer states, aux and update
    count of *src* (same net, both built)."""
    with torch.no_grad():
        for n in src.param_names:
            dst._params[n].copy_(src._params[n])
            for a, b in zip(src._opt_state[n], dst._opt_state[n]):
                b.copy_(a)
        for n in src.aux_names:
            dst._aux[n].copy_(src._aux[n])
    dst._num_update = src._num_update


def check_update(torch, coalesced, per_tensor, x, y):
    """Phase 7 (b) on two built trainers of one net, LARS with
    mp_sgd_mom, one coalesced and one per-tensor: *per_tensor* takes
    *coalesced*'s state, the gradients of one step come from
    *coalesced*'s own gradient function, and both apply them.  Returns the
    worst error/limit (limit ``2**-UPDATE_BITS`` x the f64 update's scale)
    of {"f64": either path's masters against the float64 update, "paths":
    coalesced against per-tensor, "no eta" and "bf16 weight": the
    coalesced masters against the wrong variants (each must exceed 1)},
    with "bf16_equal" (every bf16 weight is its master rounded) and
    "small" (the coalesced count)."""
    copy_state(torch, coalesced, per_tensor)
    opt = coalesced.opt_params
    _, grads, _ = coalesced._value_and_grad(coalesced._device_batch(x),
                                            coalesced._label_batch(y))
    lr = coalesced._current_lr()
    t = coalesced._num_update + 1
    before = {n: (coalesced._opt_state[n][-1].double(),
                  coalesced._opt_state[n][0].double(),
                  coalesced._params[n].double())
              for n in coalesced.param_names}
    for tr in (coalesced, per_tensor):
        tr._apply_update(grads, lr, t)
    res = {"f64": 0.0, "paths": 0.0, "no eta": 0.0, "bf16 weight": 0.0,
           "bf16_equal": True, "small": len(coalesced._small)}

    def worst(key, a, b, scale):
        ratio = ((a - b).abs() / scale).max().item()
        res[key] = max(res[key], ratio)

    for n, (w, m, wb) in before.items():
        want, _, scale = lars_mp_f64(torch, w, m, grads[n], lr, opt)
        scale = (2.0 ** -UPDATE_BITS * scale).clamp_min(1e-30)
        got = [tr._opt_state[n][-1].double() for tr in (coalesced,
                                                          per_tensor)]
        for a in got:
            worst("f64", a, want, scale)
        worst("paths", got[0], got[1], scale)
        worst("no eta", got[0], lars_mp_f64(torch, w, m, grads[n], lr, opt,
                                            eta=False)[0], scale)
        worst("bf16 weight", got[0],
              lars_mp_f64(torch, wb, m, grads[n], lr, opt)[0], scale)
        for tr in (coalesced, per_tensor):
            res["bf16_equal"] &= bool(torch.equal(
                tr._params[n], tr._opt_state[n][-1].to(tr._params[n].dtype)))
    return res


def graph_loss_grads(torch, graph, params, aux, x, y, dtype, op_impls):
    """Loss (mean of the loss output in float64 for a float64 run, else
    float32) and the gradient of every parameter, of *graph*'s training
    evaluation with *params*, *aux* and *x* cast to *dtype* (floats only).
    Returns (loss, {name: grad})."""
    from mxnet_tpu_torch.executor import _build_eval
    ev = _build_eval(graph, True, op_impls=op_impls)
    leaves = {n: t.detach().to(dtype).requires_grad_()
              for n, t in params.items()}
    amap = dict(leaves, data0=x.to(dtype) if x.is_floating_point() else x,
                label0=y)
    with torch.enable_grad():
        outs, _ = ev(amap, {n: a.to(torch.float64 if dtype == torch.float64
                                    else a.dtype) for n, a in aux.items()})
        acc = torch.float64 if dtype == torch.float64 else torch.float32
        loss = torch.mean(outs[0].to(acc))
        grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.item(), dict(zip(leaves, grads))


def total_l2(torch, a, b):
    """||a - b|| / ||b|| over all the gradients together, in float64."""
    num = sum(float(((a[n].double() - b[n].double()) ** 2).sum()) for n in b)
    den = sum(float((b[n].double() ** 2).sum()) for n in b)
    return math.sqrt(num / max(den, 1e-300))


def check_bf16_vs_f64(torch, card, trainer, x, y, x_other):
    """Phase 7 (c): the bf16 step's loss and gradients against float64 on
    the same weights (the bf16 compute weights) and batch, ReLU masks
    frozen to the float64 run's; the float32 run beside it; and the bf16
    gradients of the batch *x_other*, which must break the limit.
    Returns {"loss": (bf16, f32) gaps in units of BF16_U x max(1,
    |loss|), "grad": (bf16, f32, other batch) gaps ||g - g64|| / ||g64||
    over all parameters, in units of BF16_U}."""
    graph, params, aux = trainer._graph, trainer._params, trainer._aux
    xd, yd = trainer._device_batch(x), trainer._label_batch(y)
    relu64, masks = relu_op(torch)
    t0 = time.perf_counter()
    loss64, g64 = graph_loss_grads(torch, graph, params, aux, xd, yd,
                                   torch.float64, {"Activation": relu64})
    t64 = time.perf_counter() - t0     # .item() waited for the loss
    out = {"loss": [], "grad": []}
    for dtype in (torch.bfloat16, torch.float32):
        relu, seen = relu_op(torch, masks)
        loss, g = graph_loss_grads(torch, graph, params, aux, xd, yd, dtype,
                                   {"Activation": relu})
        flips = sum(int((a != b).sum()) for a, b in zip(seen, masks))
        gaps = grad_gaps(torch, {n: v.float() for n, v in g.items()},
                         {n: v.float() for n, v in g64.items()})
        out["loss"].append(abs(loss - loss64) / (BF16_U * max(1.0,
                                                              abs(loss64))))
        out["grad"].append(total_l2(torch, g, g64) / BF16_U)
        log("north-star check, batch %d on %s: %s vs f64 (f64 forward and "
            "backward %.2f s): loss %.7f vs %.7f; ReLU units on the other "
            "branch %d of %d (frozen to f64's); gradients, masks frozen: "
            "all together L2 %.4g, per parameter %s" % (
                x.shape[0], card, str(dtype).split(".")[-1], t64, loss,
                loss64, flips, sum(int(m.numel()) for m in masks),
                out["grad"][-1] * BF16_U, gap_text(gaps)))
        del g, seen
    _, g = graph_loss_grads(torch, graph, params, aux,
                            trainer._device_batch(x_other), yd,
                            torch.bfloat16, {})
    out["grad"].append(total_l2(torch, g, g64) / BF16_U)
    return out


def ns_steps(torch, trainer, x, y, n):
    """*n* ``fit_batch`` calls; returns (the loss tensors, host seconds to
    the readback of the last)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [trainer.fit_batch(x, y) for _ in range(n)]
    float(losses[-1])
    return losses, time.perf_counter() - t0


def ranged(torch, trainer):
    """Wrap *trainer*'s update in a profiler range named ``NS_RANGE``."""
    apply = trainer._apply_update

    def wrapped(*args):
        with torch.profiler.record_function(NS_RANGE):
            return apply(*args)
    trainer._apply_update = wrapped


def ns_resnet(torch, card, mx, vision, gen, rng, ctx, failures):
    """Phase 7 (a) and (e): the mp LARS ResNet-50 step at batch 128,
    timed and profiled with coalesce_small on and off; then the
    checkpoint round trip."""
    b = RESNET_BATCH
    x = mx.nd.array(rng.randn(b, 3, RESNET_IMAGE, RESNET_IMAGE)
                    .astype("float32"), ctx=ctx)
    y = mx.nd.array(rng.randint(0, RESNET_CLASSES, (b,)).astype("float32"),
                    ctx=ctx)
    dev = ctx.torch_device
    net = resnet_net(mx, vision, gen, ctx)
    trainer = ns_trainer(torch, mx, net, "lbsgd", NS_OPT, dev)
    off = ns_trainer(torch, mx, net, "lbsgd", NS_OPT, dev,
                     coalesce_small=False)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    warm, _ = ns_steps(torch, trainer, x, y, NS_WARMUP)
    log("north-star resnet: built the trainer (%d arrays, %d coalesced) and "
        "ran %d warm-up steps in %.2f s" % (
            len(trainer.param_names), len(trainer._small), NS_WARMUP,
            time.perf_counter() - t0))
    timed, dt = ns_steps(torch, trainer, x, y, NS_STEPS)
    peak = torch.cuda.max_memory_allocated()
    losses = [float(v) for v in warm + timed]
    ms = 1e3 * dt / NS_STEPS
    bound = 3 * RESNET_FWD_FLOP * b / PEAK_FLOPS["bfloat16"] * 1e3
    log("north-star resnet: losses of steps 1-%d: %s" % (
        len(losses), ", ".join("%.4f" % v for v in losses)))
    log("north-star resnet: batch %d x %d^2, lbsgd (eta %g) lr %g momentum "
        "%g, bf16 compute weights, f32 masters, coalesce_small on: ms per "
        "step %.3f (%d steps after %d warm-up, to a readback of the last "
        "loss), %.1f images/s; bf16 bound %.3f ms (3 x %.4g x %d flop over "
        "%.0f TFLOP/s), step at %.2f%% of it; peak device memory %.3f GB "
        "on %s" % (
            b, RESNET_IMAGE, NS_OPT["eta"], NS_OPT["learning_rate"],
            NS_OPT["momentum"], ms, NS_STEPS, NS_WARMUP, b / ms * 1e3, bound,
            RESNET_FWD_FLOP, b, PEAK_FLOPS["bfloat16"] / 1e12,
            100.0 * bound / ms, peak / 1e9, card))
    ranged(torch, trainer)
    shares = profile(torch, lambda: float(trainer.fit_batch(x, y)),
                     "north-star resnet profile, one step, coalesce_small "
                     "on", card, NS_SHARES, ranges=(NS_RANGE,))
    if shares is not None:
        rest = 1.0 - shares["convolution"] - shares["GEMM"] - \
            shares[NS_RANGE]
        log("north-star resnet shares of device time: convolutions %.3f, "
            "BatchNorm and elementwise (the rest) %.3f, optimizer with LARS "
            "%.3f, GEMM %.3f; idle %s" % (
                shares["convolution"], rest, shares[NS_RANGE],
                shares["GEMM"], "%.3f" % shares["idle"]
                if "idle" in shares else "not measured"))
    _, dt_off = ns_steps(torch, off, x, y, NS_OFF_STEPS + 1)
    _, dt_off = ns_steps(torch, off, x, y, NS_OFF_STEPS)
    ranged(torch, off)
    profile(torch, lambda: float(off.fit_batch(x, y)),
            "north-star resnet profile, one step, coalesce_small off", card,
            NS_SHARES, ranges=(NS_RANGE,))
    log("north-star resnet: coalesce_small off: ms per step %.3f (%d steps); "
        "on: %.3f" % (1e3 * dt_off / NS_OFF_STEPS, NS_OFF_STEPS, ms))
    if not all(math.isfinite(v) for v in losses) or \
            not losses[NS_FALL - 1] < losses[0]:
        failures.append("the north-star ResNet loss did not fall from step "
                        "1 to step %d: %s" % (NS_FALL, losses))
    del off
    ns_checkpoint(torch, mx, vision, gen, ctx, trainer, x, y, failures)
    del trainer, net
    torch.cuda.empty_cache()
    return {"ms": ms, "images_s": b / ms * 1e3, "bound_ms": bound,
            "peak_gb": peak / 1e9, "losses": losses, "shares": shares}


def bits(torch, t):
    """*t*'s bit patterns as integers (so a NaN equals itself)."""
    return t.view({1: torch.int8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


def ns_checkpoint(torch, mx, vision, gen, ctx, trainer, x, y, failures):
    """Phase 7 (e): save *trainer*, build a fresh trainer on a fresh net
    (``fit_batch`` once), load, and hold params, states, aux and
    num_update bit-equal."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ns_")
    try:
        path = trainer.save_checkpoint(os.path.join(tmp, "ns"), 3)
        fresh = ns_trainer(torch, mx, resnet_net(mx, vision, gen, ctx),
                           "lbsgd", NS_OPT, ctx.torch_device)
        fresh.fit_batch(x, y)
        fresh.load_checkpoint(os.path.join(tmp, "ns"), 3)
        size = os.path.getsize(path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # the fresh net's names carry another counter: match by graph order
    names = list(zip(trainer.param_names, fresh.param_names))
    pairs = [(trainer._params[a], fresh._params[b]) for a, b in names]
    pairs += [(s, t) for a, b in names
              for s, t in zip(trainer._opt_state[a], fresh._opt_state[b])]
    pairs += [(trainer._aux[a], fresh._aux[b])
              for a, b in zip(trainer.aux_names, fresh.aux_names)]
    equal = sum(bool(torch.equal(bits(torch, a), bits(torch, b)))
                for a, b in pairs)
    ok = equal == len(pairs) and fresh._num_update == trainer._num_update
    log("north-star checkpoint: %.1f MB written; %d of %d arrays (params, "
        "optimizer states, aux) bit-equal after load, num_update %d vs %d "
        "-> %s" % (size / 2 ** 20, equal, len(pairs), fresh._num_update,
                   trainer._num_update, "ok" if ok else "FAIL"))
    if not ok:
        failures.append("the checkpoint round trip changed the state")


def ns_checks(torch, card, mx, vision, gen, rng, ctx, failures):
    """Phase 7 (b) and (c) at batch 32 on a fresh net."""
    b = NS_CHECK_BATCH
    x = mx.nd.array(rng.randn(b, 3, RESNET_IMAGE, RESNET_IMAGE)
                    .astype("float32"), ctx=ctx)
    y = mx.nd.array(rng.randint(0, RESNET_CLASSES, (b,)).astype("float32"),
                    ctx=ctx)
    net = resnet_net(mx, vision, gen, ctx)
    coalesced = ns_trainer(torch, mx, net, "lbsgd", NS_OPT, ctx.torch_device)
    per_tensor = ns_trainer(torch, mx, net, "lbsgd", NS_OPT,
                            ctx.torch_device, coalesce_small=False)
    for tr in (coalesced, per_tensor):
        tr.fit_batch(x, y)       # builds; the momenta are not zero after
    with mx.enable_x64():       # the f64 update oracle keeps 64 bits
        res = check_update(torch, coalesced, per_tensor, x, y)
    ok = res["f64"] <= 1.0 and res["paths"] <= 1.0 and res["bf16_equal"] \
        and res["no eta"] > 1.0 and res["bf16 weight"] > 1.0
    log("north-star update check, batch %d on %s (%d arrays, %d coalesced): "
        "f32 masters vs the f64 LARS + mp_sgd_mom update, worst error/limit "
        "%.4f (limit 2**-%d x (|w| + momentum |m| + |lr_n g|)); coalesced vs "
        "per-tensor %.4f; every bf16 weight its master rounded: %s; wrong "
        "variants (must exceed 1): trust ratio without eta %.4g, update "
        "from the bf16 weight %.4g -> %s" % (
            b, card, len(coalesced.param_names), res["small"], res["f64"],
            UPDATE_BITS, res["paths"], res["bf16_equal"], res["no eta"],
            res["bf16 weight"], "ok" if ok else "FAIL"))
    if not ok:
        failures.append("the update check failed")
    del per_tensor
    x_other = mx.nd.array(rng.randn(*x.shape).astype("float32"), ctx=ctx)
    with mx.enable_x64():       # the f64 oracle keeps 64 bits
        gaps = check_bf16_vs_f64(torch, card, coalesced, x, y, x_other)
    ok = gaps["loss"][0] <= TOL_NS_LOSS and gaps["grad"][0] <= TOL_NS_GRAD \
        and gaps["loss"][1] <= TOL_NS_LOSS / 16 and \
        gaps["grad"][1] <= TOL_NS_GRAD / 16 and gaps["grad"][2] > TOL_NS_GRAD
    log("north-star check, bf16 vs f64: loss gap %.4f units of 2**-8 x "
        "max(1, |loss|) (limit %g), gradient gap (all together, L2) %.4f "
        "units of 2**-8 (limit %g); f32 vs f64: loss %.4g, gradients %.4g "
        "(each within 1/16 of its limit); the bf16 gradients of another "
        "batch %.4f (must exceed the limit) -> %s" % (
            gaps["loss"][0], TOL_NS_LOSS, gaps["grad"][0], TOL_NS_GRAD,
            gaps["loss"][1], gaps["grad"][1], gaps["grad"][2],
            "ok" if ok else "FAIL"))
    if not ok:
        failures.append("bf16 compute against f64 broke its limits")
    del coalesced, net
    torch.cuda.empty_cache()
    return res, gaps


def ns_lm(torch, card, mx, gen, rng, ctx, failures):
    """Phase 7 (d): the mp LM trainer at 8 x 2048 through the bf16
    kernels; the main path whose launches are counted."""
    from mxnet_tpu_torch.executor import _build_eval
    from mxnet_tpu_torch.gluon.model_zoo.transformer import \
        get_transformer_lm
    from mxnet_tpu_torch.ops import attention as att
    x = mx.nd.array(rng.randint(0, VOCAB, (BATCH, SEQ)).astype("int32"),
                    ctx=ctx, dtype="int32")
    y = mx.nd.array(rng.randint(0, VOCAB, (BATCH, SEQ)).astype("float32"),
                    ctx=ctx)
    net = get_transformer_lm(vocab=VOCAB, dim=DIM, heads=HEADS,
                             layers=LAYERS, max_seq=SEQ)
    net.initialize(ctx=ctx, generator=gen)
    trainer = ns_trainer(torch, mx, net, "sgd", LM_NS_OPT, ctx.torch_device)
    t0 = time.perf_counter()
    first = float(trainer.evaluate_batch(x, y))     # builds the trainer

    def plain_dpa(query, key, value, causal=False, sm_scale=None,
                  chunk=512):
        return att._chunked_attention(query, key, value, bool(causal),
                                      sm_scale, chunk)
    ev = _build_eval(trainer._graph, True, op_impls={
        "_contrib_DotProductAttention": plain_dpa})
    with torch.no_grad():
        outs, _ = ev(dict(trainer._params, data0=x._data, label0=y._data),
                     trainer._aux)
        plain = torch.mean(outs[0].float()).item()
    del outs, ev
    log("north-star LM: built the trainer (%d arrays) and the plain-"
        "attention loss in %.2f s" % (len(trainer.param_names),
                                      time.perf_counter() - t0))
    counters = (att.flash_fwd, att.flash_bwd_dkdv, att.flash_bwd_dq)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0      # the north-star LM path's counts start here
    step1, _ = ns_steps(torch, trainer, x, y, 1)
    timed, dt = ns_steps(torch, trainer, x, y, LM_NS_STEPS - 1)
    shares = profile(torch, lambda: float(trainer.fit_batch(x, y)),
                     "north-star LM profile, one step of batch %d x %d"
                     % (BATCH, SEQ), card, LM_NS_SHARES)
    launches = {c.__name__: c.launches for c in counters}
    peak = torch.cuda.max_memory_allocated()
    losses = [float(v) for v in step1 + timed]
    steps = LM_NS_STEPS + 1
    ms = 1e3 * dt / (LM_NS_STEPS - 1)
    gap = abs(losses[0] - plain) / (BF16_U * max(1.0, abs(plain)))
    log("north-star LM: vocab %d, dim %d, %d heads, %d layers, batch %d x "
        "%d int32 ids, sgd lr %g momentum %g, bf16 compute weights: losses "
        "%s; ms per step %.3f (steps 2-%d), %.0f tokens/s, peak device "
        "memory %.3f GB on %s; launches %s (expected %d each: %d layers x %d "
        "steps)" % (
            VOCAB, DIM, HEADS, LAYERS, BATCH, SEQ,
            LM_NS_OPT["learning_rate"], LM_NS_OPT["momentum"],
            ", ".join("%.5f" % v for v in losses), ms, LM_NS_STEPS,
            BATCH * SEQ / ms * 1e3, peak / 1e9, card, launches,
            LAYERS * steps, LAYERS, steps))
    log("north-star LM: step 1's loss with the bf16 kernels %.6f, the same "
        "weights through the plain attention %.6f (inference evaluation "
        "%.6f): gap %.4f of 2**-8 x max(1, |loss|) (limit %g)"
        % (losses[0], plain, first, gap, TOL_LM_NS_LOSS))
    if shares is not None:
        log("north-star LM shares of device time: bf16 flash kernels "
            "together %.3f (fwd %.3f, dkdv %.3f, dq %.3f), bf16 GEMMs %.3f, "
            "the rest %.3f; flash kernels not in bf16 %.3f (must be 0)" % (
                sum(shares[k] for k in ("flash_fwd bf16",
                                        "flash_bwd_dkdv bf16",
                                        "flash_bwd_dq bf16")),
                shares["flash_fwd bf16"], shares["flash_bwd_dkdv bf16"],
                shares["flash_bwd_dq bf16"], shares["bf16 GEMM"],
                1.0 - sum(v for k, v in shares.items() if k != "idle"),
                shares["flash, not bf16"]))
        if shares["flash, not bf16"] > 0 or not all(
                shares[k] > 0 for k in ("flash_fwd bf16",
                                        "flash_bwd_dkdv bf16",
                                        "flash_bwd_dq bf16")):
            failures.append("the mp LM step did not run the bf16 "
                            "instantiations of all three kernels")
    if any(n != LAYERS * steps for n in launches.values()):
        failures.append("north-star LM launch counts %s" % launches)
    if not all(math.isfinite(v) for v in losses) or \
            not losses[-1] < losses[0]:
        failures.append("the north-star LM loss did not fall: %s" % losses)
    if not gap <= TOL_LM_NS_LOSS:
        failures.append("the LM step's loss with the kernels is %.4f units "
                        "of 2**-8 from the plain attention's" % gap)
    lib_ms = sdpa_step_ms(torch, trainer, x, y)
    log("north-star LM with PyTorch's scaled_dot_product_attention in place "
        "of the three kernels (a measurement only, after the counted path: "
        "what tensor-core attention would leave of the step): ms per step "
        "%.3f (%d steps), %.0f tokens/s, against %.3f with the kernels"
        % (lib_ms, LM_NS_STEPS - 1, BATCH * SEQ / lib_ms * 1e3, ms))
    del trainer, net
    torch.cuda.empty_cache()
    return launches, {"ms": ms, "tokens_s": BATCH * SEQ / ms * 1e3,
                      "peak_gb": peak / 1e9, "losses": losses,
                      "shares": shares, "plain_gap": gap}


def sdpa_step_ms(torch, trainer, x, y):
    """ms per ``fit_batch`` of *trainer* with its attention op evaluated by
    ``scaled_dot_product_attention`` (fresh weights do not matter: only
    the time is kept); the trainer's own evaluation is restored after."""
    import torch.nn.functional as F
    from mxnet_tpu_torch.executor import _build_eval

    def sdpa(query, key, value, causal=False, sm_scale=None, chunk=512):
        return F.scaled_dot_product_attention(query, key, value,
                                              is_causal=bool(causal),
                                              scale=sm_scale)
    own = trainer._eval
    trainer._eval = _build_eval(trainer._graph, True, op_impls={
        "_contrib_DotProductAttention": sdpa})
    try:
        ns_steps(torch, trainer, x, y, 1)
        _, dt = ns_steps(torch, trainer, x, y, LM_NS_STEPS - 1)
    finally:
        trainer._eval = own
    return 1e3 * dt / (LM_NS_STEPS - 1)


def phase_north_star(torch, card, seed):
    """Phase 7: the north-star trainer on the card.  Raises without CUDA:
    it never runs on the CPU; raises after the phase when any check
    failed.  Returns the LM path's launches."""
    if not torch.cuda.is_available():
        raise RuntimeError("phase 7 needs a CUDA device")
    import numpy as np
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo import vision

    ctx = mx.gpu(0)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 3)
    rng = np.random.RandomState(seed + 3)
    from mxnet_tpu_torch.ops import nn as nn_ops
    failures = []
    # bf16 convolutions take cuDNN's default (tensor-core) path and set
    # no precision; the process default must come out as it went in
    before = torch.backends.cudnn.conv.fp32_precision
    ns_resnet(torch, card, mx, vision, gen, rng, ctx, failures)
    ns_checks(torch, card, mx, vision, gen, rng, ctx, failures)
    launches, _ = ns_lm(torch, card, mx, gen, rng, ctx, failures)
    after = torch.backends.cudnn.conv.fp32_precision
    log("north-star: bf16 convolutions set precision %r; cuDNN's process "
        "default f32 convolution precision %r before the phase, %r after"
        % (nn_ops.conv_precision(torch.bfloat16), before, after))
    if after != before or nn_ops.conv_precision(torch.bfloat16) is not None:
        failures.append("the phase changed cuDNN's convolution precision")
    if failures:
        raise RuntimeError("phase 7 failed: " + "; ".join(failures))
    return launches


# phase 8: paged decode of the LM of tools/benchmark_lm.py:40-45 at full
# width and depth (vocab 32000, dim 1024, 16 heads, 12 layers, max_seq
# 2048, f32).  The engine: blocks of 16 tokens, sessions of up to 1024
# (64 blocks each), tick rungs 1-16, prefill rungs 16-1024, a pool of
# 16 x 64 blocks + the null block (1.61 GB: 98,304 B a token).  Traffic:
# 16 client threads x 2 sessions, prompts of 64-512 ids, 64-256 new
# tokens each, the batcher's default coalescing window — what a chat or
# completion endpoint sees.
DEC_BLOCK, DEC_MAX_LEN = 16, 1024
DEC_RUNGS = (1, 2, 4, 8, 16)
DEC_PREFILL_RUNGS = (16, 32, 64, 128, 256, 512, 1024)
DEC_BLOCKS = DEC_RUNGS[-1] * DEC_MAX_LEN // DEC_BLOCK + 1
DEC_THREADS, DEC_PER_THREAD = 16, 2
DEC_PROMPT, DEC_NEW = (64, 512), (64, 256)
# (a)'s teacher-forced prompt; the reference's serial-vs-batched
# comparison (bench.py:1206-1325): sessions x prompt x new tokens
DEC_CHECK_LEN = 300
DEC_CMP = (4, 64, 32)
DEC_TIMED_RUNGS, DEC_TIMED_PREFILL = (1, 4, 16), (64, 512)
# (d): ids past the table and below zero in one prompt
DEC_BAD = {10: VOCAB, 20: -1}
DEC_CHECK_WAIT_MS = 200.0   # the check batcher coalesces 4 starts


def lm_decode_fns(torch, pred, heads, with_logits=False):
    """The decode contract's plug-in for the transformer LM served by
    *pred* (``get_transformer_lm``): ``(step_fn, prefill_fn, token_spec,
    input_spec)`` reading the predictor's parameters by name.

    The cache holds each layer's K and V per token, ``(layers, heads,
    dim / heads)`` each.  ``prefill_fn`` runs the model's own graph over
    the zero-padded prefix and records every layer's K and V at its
    ``_contrib_DotProductAttention`` (flash_fwd on the card).
    ``step_fn`` runs one query per session: embedding plus
    ``pos_embed[pos]``, the pre-norm blocks writing K and V exactly at
    ``pos``, attention over the view on PyTorch with scores AND values
    past ``pos`` masked (a freed block may hold NaN, and 0 * NaN is
    NaN), the final LayerNorm, the head and the argmax (int32).  With
    *with_logits* it returns ``(tokens, logits)``."""
    from mxnet_tpu_torch.executor import _build_eval
    from mxnet_tpu_torch.ops import attention as att
    from mxnet_tpu_torch.ops import registry as reg

    params = pred._params
    pre, layers, _, dh = lm_geometry(pred, heads)
    dim = heads * dh
    scale = 1.0 / math.sqrt(dh)
    layer_norm = reg.get_op("LayerNorm").fn
    embedding = reg.get_op("Embedding").fn
    data_name = next(iter(pred._data_shapes))

    def ln(x, name):
        out = layer_norm(x, params[name + "_gamma"], params[name + "_beta"])
        return out[0] if isinstance(out, (tuple, list)) else out

    def dense(x, name, bias=False):
        out = torch.matmul(x, params[name + "_weight"].t())
        return out + params[name + "_bias"] if bias else out

    def step_fn(p, view, inputs, pos):
        tok = inputs["tok"]
        s = tok.shape[0]
        at = pos.long()
        x = embedding(tok, p[pre + "embedding0_weight"]) + \
            p[pre + "pos_embed"][0][at]
        kv, vv = view["k"], view["v"]          # (S, L, layers, H, dh)
        idx = torch.arange(s, device=x.device)
        seen = torch.arange(kv.shape[1], device=x.device)[None, :] <= \
            at[:, None]                        # (S, L)
        for i in range(layers):
            b = "%sh%d_" % (pre, i)
            a = b + "multiheadattention0_"
            h = ln(x, b + "layernorm0")
            q = dense(h, a + "query").view(s, heads, dh)
            kv[idx, at, i] = dense(h, a + "key").view(s, heads, dh)
            vv[idx, at, i] = dense(h, a + "value").view(s, heads, dh)
            # (masked_fill with a Python number: capture copies nothing
            # from the host)
            sc = (torch.einsum("shd,slhd->shl", q, kv[:, :, i]) * scale) \
                .masked_fill(~seen[:, None, :], float("-inf"))
            v = vv[:, :, i].masked_fill(~seen[:, :, None, None], 0.0)
            o = torch.einsum("shl,slhd->shd", torch.softmax(sc, dim=-1), v)
            x = x + dense(o.reshape(s, dim), a + "out")
            h = torch.relu(dense(ln(x, b + "layernorm1"), b + "dense0",
                                 True))
            x = x + dense(h, b + "dense1", True)
        logits = dense(ln(x, pre + "layernorm0"), pre + "dense0")
        out = torch.argmax(logits, dim=-1).to(torch.int32)
        return ((out, logits) if with_logits else out), view

    recorded = []

    def recording_dpa(query, key, value, causal=False, sm_scale=None,
                      chunk=512):
        recorded.append((key, value))
        return att._dot_product_attention(query, key, value, causal=causal,
                                          sm_scale=sm_scale, chunk=chunk)
    graph = _build_eval(pred._symbol, False, op_impls={
        "_contrib_DotProductAttention": recording_dpa})

    def prefill_fn(p, inputs, length):
        del recorded[:]
        graph(dict(p, **{data_name: inputs["tok"].float()}), {})
        # (1, H, Lr, dh) per layer -> (1, Lr, layers, H, dh)
        k = torch.stack([kk[0].transpose(0, 1) for kk, _ in recorded], 1)
        v = torch.stack([vv[0].transpose(0, 1) for _, vv in recorded], 1)
        del recorded[:]
        return {"k": k[None], "v": v[None]}

    meta = torch.empty((layers, heads, dh), dtype=torch.float32,
                       device="meta")
    return (step_fn, prefill_fn, {"k": meta, "v": meta},
            {"tok": torch.empty((), dtype=torch.int32, device="meta")})


def dense_decoder(torch, pred, step_fn, max_len, heads):
    """A dense ``DecodeSession`` (``pred.make_decoder``) of *step_fn*
    over one worst-case cache: one dispatch a token."""
    _, layers, _, dh = lm_geometry(pred, heads)
    dev = pred._dev
    cache = {n: torch.zeros((1, max_len, layers, heads, dh), device=dev)
             for n in ("k", "v")}

    def step(p, c, inputs, t):
        return step_fn(p, c, inputs, t.reshape(1))
    return pred.make_decoder(step, cache, {"tok": (1,)},
                             input_dtypes={"tok": "int32"})


def dense_stream(sess, prompt, n_new):
    """Greedy decode through a dense session, the reference's serial
    path: the prompt fed token by token, the last prompt token's output
    the first generated token, one readback a token."""
    import numpy as np
    cur = None
    for tok in prompt:
        cur = int(sess.step({"tok": np.asarray([tok], np.int32)})[0])
    stream = []
    for _ in range(n_new):
        stream.append(cur)
        if len(stream) >= n_new:
            break
        cur = int(sess.step({"tok": np.asarray([cur], np.int32)})[0])
    return stream


def dense_logits(torch, sess, tokens):
    """Teacher-forced logits, one row a token, through a dense session of
    the ``with_logits`` step."""
    import numpy as np
    return torch.cat([sess.step({"tok": np.asarray([t], np.int32)})[1]
                      for t in tokens])


def lm_geometry(pred, heads):
    """(parameter name prefix, layers, heads, head dim) of the LM *pred*
    serves, read from its parameter names."""
    params = pred._params
    pre = next(n[:-len("pos_embed")] for n in params
               if n.endswith("pos_embed"))
    layers = sum(1 for n in params if n.startswith(pre + "h") and
                 n.endswith("_layernorm0_gamma"))
    return pre, layers, heads, params[pre + "pos_embed"].shape[-1] // heads


def serve_streams(batcher, prompts, n_new, timeout=600.0):
    """Start every prompt on *batcher* at once; returns (streams, the
    finished sessions)."""
    sess = [batcher.start({"tok": p}, max_new_tokens=n_new)
            for p in prompts]
    return [[int(t) for t in s.result(timeout)] for s in sess], sess


def forward_logits(pred, tokens):
    """The predictor's forward (one graph replay on the card) of one
    sequence: (len, vocab)."""
    import numpy as np
    return pred.predict(np.asarray(tokens, "float32")[None])[0]._data[0]


def divergence(torch, pred, heads, a, b, prompt, max_len):
    """Where streams *a* and *b* of *prompt* first differ: (index, error
    of the dense step's logits there against the forward, the forward's
    margin between the two tokens, the limit), or None when they are
    equal.  The paged tick emits tokens only, so the forward is the
    arbiter: the step's logits must be within the serve limit of it, and
    the two tokens' logits closer than the limit — a tie within f32
    noise, which either order of summation may break."""
    if a == b:
        return None
    i = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
    ctx = list(prompt) + a[:i]
    step_l, _, _, _ = lm_decode_fns(torch, pred, heads, with_logits=True)
    sess = dense_decoder(torch, pred, step_l, max_len, heads)
    got = dense_logits(torch, sess, ctx)[-1]
    want = forward_logits(pred, ctx)[-1]
    scale = max(1.0, want.abs().max().item())
    err = (got - want).abs().max().item()
    margin = abs(want[a[i]].item() - want[b[i]].item())
    return i, err, margin, TOL_SERVE * scale


def record_ticks(eng):
    """Keep (sessions, rung) of each tick the batcher dispatches, and the
    monotonic start of each prefill.  Returns (ticks, prefill starts, a
    function that restores ``eng.tick`` and ``eng.prefill``)."""
    real_tick, real_prefill = eng.tick, eng.prefill
    ticks, prefills = [], []

    def tick(sessions):
        ready = real_tick(sessions)
        if ready:
            ticks.append((len(ready), eng.ladder.batch_for(len(ready))))
        return ready

    def prefill(sess):
        prefills.append(time.monotonic())
        return real_prefill(sess)

    eng.tick, eng.prefill = tick, prefill

    def restore():
        eng.__dict__.pop("tick", None)
        eng.__dict__.pop("prefill", None)
    return ticks, prefills, restore


def decode_traffic(batcher, specs, threads):
    """*threads* clients, each starting its share of *specs* (prompt,
    new tokens) one after another and waiting for each stream.  Returns
    (per session: (start stamp, delivery stamps, tokens, error), wall
    seconds)."""
    out = [None] * len(specs)
    per = len(specs) // threads

    def client(c):
        for i in range(c * per, (c + 1) * per):
            prompt, n_new = specs[i]
            t0 = time.monotonic()
            try:
                s = batcher.start({"tok": prompt}, max_new_tokens=n_new)
                toks = s.result(600)
                out[i] = (t0, s.stamps(), len(toks), None)
            except Exception as exc:   # recorded, and fails the phase
                out[i] = (t0, [], 0, "%s: %s" % (type(exc).__name__, exc))

    t0 = time.monotonic()
    pool = [threading.Thread(target=client, args=(c,)) for c in
            range(threads)]
    for t in pool:
        t.start()
    for t in pool:
        t.join()
    return out, time.monotonic() - t0


def decode_failures(s):
    """The checks of phase 8 over its record *s*; returns what failed
    (an empty list when every check passed)."""
    out = []
    if s["session_errors"]:
        out.append("%d sessions failed: %s" % (len(s["session_errors"]),
                                                s["session_errors"][:3]))
    if s["tokens"] != s["tokens_asked"]:
        out.append("%d tokens delivered, %d asked"
                   % (s["tokens"], s["tokens_asked"]))
    if s["compiles_after"] != s["compiles_before"]:
        out.append("compile_count %d -> %d under traffic"
                   % (s["compiles_before"], s["compiles_after"]))
    if s["blocks_in_use"]:
        out.append("%d pool blocks in use after the last session"
                   % s["blocks_in_use"])
    if not s["mean_sessions"] > 1.0:
        out.append("ticks served %.3f sessions on average: no batching"
                   % s["mean_sessions"])
    if s["tick_captured"]:
        out.append("a tick program captured kernel launches %s (decode "
                   "attention is PyTorch's)" % s["tick_captured"])
    for rung, got in sorted(s["prefill_captured"].items()):
        if got != {"flash_fwd": s["layers"]}:
            out.append("prefill rung %d captured %s, expected flash_fwd %d"
                       % (rung, got, s["layers"]))
    if s["traffic_wrapper"]:
        out.append("the traffic launched flash_fwd %d times from its "
                   "wrapper (the card runs graphs only)"
                   % s["traffic_wrapper"])
    if s["traffic_prefill_graph"] != s["layers"] * s["prefills"]:
        out.append("prefill graph launches %d != %d layers x %d prefills"
                   % (s["traffic_prefill_graph"], s["layers"],
                      s["prefills"]))
    if not s["logits_ratio"] <= 1.0:
        out.append("(a) teacher-forced logits at %.4g of the limit"
                   % s["logits_ratio"])
    for i, d in enumerate(s["divergences"]):
        if d is not None and not (d[1] <= d[3] and d[2] <= d[3]):
            out.append("(b) session %d diverged at token %d: step logits "
                       "%.3g from the forward, margin %.3g, limit %.3g"
                       % ((i,) + tuple(d)))
    if not s["bad_nan_logits"]:
        out.append("(d) the bad ids did not give NaN logits")
    if s["bad_stream"] != s["bad_expected"]:
        out.append("(d) the bad session's stream %s is not the argmax "
                   "over NaN %s" % (s["bad_stream"][:4],
                                    s["bad_expected"][:4]))
    if not s["poisoned_blocks"]:
        out.append("(d) no freed block held NaN")
    if not s["reused_blocks"]:
        out.append("(d) the next sessions reused none of the NaN blocks")
    if not s["after_bad_equal"]:
        out.append("(d) the sessions served on the NaN blocks are not "
                   "bit-equal to the same sessions before them")
    if not s["prefill_launches"] > 0:
        out.append("the decode prefill launched no flash_fwd")
    return out


def phase_decode(torch, card, seed):
    """Phase 8: generation from the full-width LM through
    ``registry.load_checkpoint`` -> ``pred.make_paged_decoder`` ->
    ``DecodeBatcher.start``, one CUDA graph per session rung and per
    prefill rung.  Raises without CUDA: it never runs on the CPU; raises
    after the phase when any check failed.  Returns the flash_fwd
    launches of its main path (engine build and traffic)."""
    if not torch.cuda.is_available():
        raise RuntimeError("phase 8 needs a CUDA device")
    import numpy as np
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo.transformer import \
        get_transformer_lm
    from mxnet_tpu_torch.ops import attention as att

    t_phase = time.perf_counter()
    ctx = mx.gpu(0)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 8)
    rng = np.random.RandomState(seed + 8)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_decode_")
    prefix = os.path.join(tmp, "lm")
    net = get_transformer_lm(vocab=VOCAB, dim=DIM, heads=HEADS,
                             layers=LAYERS, max_seq=SEQ)
    net.initialize(ctx=ctx, generator=gen)
    net.hybridize()
    net(mx.nd.array(np.zeros((1, DEC_BLOCK), "float32"), ctx=ctx))
    net.export(prefix, 0)
    del net
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reg = mx.serve.ModelRegistry()
    pred = reg.load_checkpoint(
        "lm", prefix, 0, data_shapes={"data0": (1, DEC_MAX_LEN)},
        ladder=mx.serve.BucketLadder(batches=(1,)), ctx=ctx, warm=False)
    rec = {"layers": LAYERS}

    # the main path: the engine's build and the traffic, with the
    # wrapper's counts set to 0 before it and read after it
    att.flash_fwd.launches = att.flash_fwd.captured = 0
    t0 = time.perf_counter()
    step_fn, prefill_fn, token_spec, input_spec = lm_decode_fns(
        torch, pred, HEADS)
    eng = pred.make_paged_decoder(
        step_fn, prefill_fn, token_spec, input_spec, max_len=DEC_MAX_LEN,
        block_size=DEC_BLOCK, num_blocks=DEC_BLOCKS,
        session_rungs=DEC_RUNGS, prefill_rungs=DEC_PREFILL_RUNGS)
    warm_s = time.perf_counter() - t0
    warm_wrapper = att.flash_fwd.launches
    rec["compiles_before"] = eng.compile_count
    rec["tick_captured"] = {r: c for r in DEC_RUNGS for c in
                            [eng.captured_launches("tick", r)] if c}
    rec["prefill_captured"] = {r: eng.captured_launches("prefill", r)
                               for r in DEC_PREFILL_RUNGS}
    warm_graph = eng.graph_launches("prefill").get("flash_fwd", 0)
    log("decode: make_paged_decoder built %d CUDA graphs in %.2f s (tick "
        "rungs %s, prefill rungs %s); pool %d blocks of %d tokens, %.3f GB "
        "(%d B a token); flash_fwd: %d wrapper launches (the prefill "
        "rungs' warm-ups), %d captured, %d by the priming replays; %.3f GB "
        "allocated on %s" % (
            eng.compile_count, warm_s, DEC_RUNGS, DEC_PREFILL_RUNGS,
            DEC_BLOCKS, DEC_BLOCK,
            DEC_BLOCKS * eng.pool.bytes_per_block / 1e9,
            eng.pool.bytes_per_block // DEC_BLOCK, warm_wrapper,
            att.flash_fwd.captured, warm_graph,
            torch.cuda.memory_allocated() / 1e9, card))

    batcher = mx.serve.DecodeBatcher(eng)
    specs = [(rng.randint(0, VOCAB, int(rng.randint(DEC_PROMPT[0],
                                                    DEC_PROMPT[1] + 1)))
              .astype(np.int32), int(rng.randint(DEC_NEW[0],
                                                 DEC_NEW[1] + 1)))
             for _ in range(DEC_THREADS * DEC_PER_THREAD)]
    ticks, _, restore = record_ticks(eng)
    d0 = eng.dispatch_count
    sessions, wall = decode_traffic(batcher, specs, DEC_THREADS)
    restore()
    batcher.close()
    rec["compiles_after"] = eng.compile_count
    rec["blocks_in_use"] = eng.pool.blocks_in_use
    rec["traffic_wrapper"] = att.flash_fwd.launches - warm_wrapper
    prefill_graph = eng.graph_launches("prefill").get("flash_fwd", 0)
    rec["traffic_prefill_graph"] = prefill_graph - warm_graph
    rec["prefills"] = eng.dispatch_count - d0 - len(ticks)
    rec["prefill_launches"] = att.flash_fwd.launches + prefill_graph
    main_launches = rec["prefill_launches"]
    rec["session_errors"] = [e for _, _, _, e in sessions if e]
    rec["tokens"] = sum(n for _, _, n, _ in sessions)
    rec["tokens_asked"] = sum(n for _, n in specs)
    ttft = [(st[0] - t) * 1e3 for t, st, _, _ in sessions if st]
    gaps = [(b - a) * 1e3 for _, st, _, _ in sessions
            for a, b in zip(st, st[1:])]
    rec["mean_sessions"] = sum(n for n, _ in ticks) / max(1, len(ticks))
    occupancy = sum(n for n, _ in ticks) / max(1, sum(r for _, r in ticks))
    by_rung = {r: sum(1 for _, x in ticks if x == r) for r in DEC_RUNGS}
    peak = torch.cuda.max_memory_allocated()
    log("decode traffic on %s: %d sessions (%d threads x %d), prompts "
        "%d-%d, %d tokens generated in %.3f s = %.1f tokens/s; time to "
        "first token p50 %.2f ms, p99 %.2f ms (%d sessions); per-token "
        "latency p50 %.2f ms, p99 %.2f ms (%d gaps); %d ticks, %.3f "
        "sessions a tick, rung occupancy %.3f, ticks by rung %s; "
        "compile_count %d before, %d after; peak device memory %.3f GB"
        % (card, len(specs), DEC_THREADS, DEC_PER_THREAD,
           min(len(p) for p, _ in specs), max(len(p) for p, _ in specs),
           rec["tokens"], wall, rec["tokens"] / wall,
           percentile(ttft, 50), percentile(ttft, 99), len(ttft),
           percentile(gaps, 50), percentile(gaps, 99), len(gaps),
           len(ticks), rec["mean_sessions"], occupancy, by_rung,
           rec["compiles_before"], rec["compiles_after"], peak / 1e9))
    log("decode: flash_fwd on the main path: %d wrapper launches (%d in "
        "the traffic), %d by prefill graph replays (%d priming, %d for "
        "the traffic's %d prefills): %d in all"
        % (att.flash_fwd.launches, rec["traffic_wrapper"], prefill_graph,
           warm_graph, rec["traffic_prefill_graph"], rec["prefills"],
           main_launches))

    # graph against eager per tick rung, and the prefill rungs' replays
    # (zero tables: every write lands in the null block)
    with eng._lock:
        for prog in eng._programs():
            for b in prog._buffers.values():
                b.zero_()
        for r in DEC_TIMED_RUNGS:
            prog = eng._tick_progs[r]
            g = time_ms(torch, lambda: prog({}), 10)
            with torch.no_grad():
                e = time_ms(torch, lambda: prog._body(prog._buffers), 10)
            log("decode tick rung %d on %s: graph %.3f ms, eager %.3f ms "
                "(%.3f ms a session)" % (r, card, g, e, g / r))
        for r in DEC_TIMED_PREFILL:
            prog = eng._prefill_progs[r]
            log("decode prefill rung %d on %s: graph %.3f ms"
                % (r, card, time_ms(torch, lambda: prog({}), 5)))

    # (a) the step's teacher-forced logits against the forward
    step_l, _, _, _ = lm_decode_fns(torch, pred, HEADS, with_logits=True)
    x = rng.randint(0, VOCAB, DEC_CHECK_LEN)
    got = dense_logits(torch, dense_decoder(torch, pred, step_l,
                                            DEC_MAX_LEN, HEADS), x)
    want = forward_logits(pred, x)
    scale = max(1.0, want.abs().max().item())
    err = (got - want).abs().max().item()
    rec["logits_ratio"] = err / (TOL_SERVE * scale)
    log("decode (a): %d-token teacher-forced step logits vs the "
        "predictor's forward: max abs err %.3g, max |logit| %.3g (tol %g "
        "x max(1, max|logit|)) -> %.4f of the limit"
        % (DEC_CHECK_LEN, err, scale, TOL_SERVE, rec["logits_ratio"]))
    del got, want

    # (b) serial (make_decoder, one dispatch a token) against batched
    # (DecodeBatcher), the reference's comparison; the streams must agree
    n_cmp, l_cmp, new_cmp = DEC_CMP
    prompts = [rng.randint(0, VOCAB, l_cmp).astype(np.int32)
               for _ in range(n_cmp)]
    dense = [dense_decoder(torch, pred, step_fn, DEC_MAX_LEN, HEADS)
             for _ in prompts]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    serial = [dense_stream(s, p, new_cmp) for s, p in zip(dense, prompts)]
    serial_s = time.perf_counter() - t0
    del dense
    check = mx.serve.DecodeBatcher(eng, max_wait_ms=DEC_CHECK_WAIT_MS,
                                   name="check")
    ticks, prefills, restore = record_ticks(eng)
    batched, sess = serve_streams(check, prompts, new_cmp)
    restore()
    # from the first prefill (the coalescing window over) to the last
    # delivery
    batched_s = max(s.stamps()[-1] for s in sess) - prefills[0]
    total = n_cmp * new_cmp
    rec["divergences"] = [divergence(torch, pred, HEADS, a, b, p,
                                     DEC_MAX_LEN)
                          for a, b, p in zip(serial, batched, prompts)]
    log("decode (b) on %s: %d sessions of %d-token prompts x %d new "
        "tokens: serial through make_decoder %.1f tokens/s (%.3f s), "
        "batched through the DecodeBatcher %.1f tokens/s (%.3f s from its "
        "first prefill, after a %.0f ms coalescing window; ticks at rungs "
        "%s): %.2fx"
        % (card, n_cmp, l_cmp, new_cmp, total / serial_s, serial_s,
           total / batched_s, batched_s, DEC_CHECK_WAIT_MS,
           sorted({r for _, r in ticks}), serial_s / batched_s))
    for i, d in enumerate(rec["divergences"]):
        log("decode (b) session %d: %s" % (i, "bit-equal to its solo dense "
            "decode" if d is None else "first divergence at token %d: the "
            "dense step's logits %.3g from the forward, the two tokens' "
            "forward margin %.3g, limit %.3g" % d))

    # (d) a prompt holding ids past the table and below zero: the
    # reference's rows (NaN for 32000, row 31999 for -1), so NaN logits
    # and the argmax over NaN; its freed blocks hold NaN, and the same 4
    # sessions served again on them stay bit-equal
    bad = rng.randint(0, VOCAB, l_cmp).astype(np.int32)
    for at, tok in DEC_BAD.items():
        bad[at] = tok
    (bad_stream,), (bad_sess,) = serve_streams(check, [bad], new_cmp)
    bad_blocks = sorted(int(b) for b in bad_sess.table if b)
    idx = torch.tensor(bad_blocks, device=eng.device)
    rec["poisoned_blocks"] = [b for b, nan in zip(
        bad_blocks, torch.isnan(eng.pool.arrays["k"][idx]).flatten(1)
        .any(1).tolist()) if nan]
    bad_logits = dense_logits(torch, dense_decoder(
        torch, pred, step_l, DEC_MAX_LEN, HEADS), bad)[-1]
    rec["bad_nan_logits"] = bool(torch.isnan(bad_logits).all())
    nan_argmax = int(torch.argmax(torch.full((VOCAB,), float("nan"),
                                             device=eng.device)))
    rec["bad_stream"] = bad_stream
    rec["bad_expected"] = [nan_argmax] * new_cmp
    again, sess = serve_streams(check, prompts, new_cmp)
    rec["reused_blocks"] = sorted(set(bad_blocks) & {
        int(b) for s in sess for b in s.table if b})
    rec["after_bad_equal"] = again == batched
    check.close()
    log("decode (d): ids %s at %s: logits all NaN %s, stream %s... "
        "(argmax over NaN is %d); %d of its %d freed blocks hold NaN, the "
        "next %d sessions took %d of them and are bit-equal to the same "
        "sessions before: %s" % (
            list(DEC_BAD.values()), list(DEC_BAD), rec["bad_nan_logits"],
            bad_stream[:4], nan_argmax, len(rec["poisoned_blocks"]),
            len(bad_blocks), n_cmp, len(rec["reused_blocks"]),
            rec["after_bad_equal"]))
    rec["blocks_in_use"] += eng.pool.blocks_in_use
    log("decode: peak device memory %.3f GB; phase %.1f s"
        % (torch.cuda.max_memory_allocated() / 1e9,
           time.perf_counter() - t_phase))
    failures = decode_failures(rec)
    reg.close()
    del reg, pred, eng
    shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    if failures:
        raise RuntimeError("phase 8 failed: " + "; ".join(failures))
    return main_launches


# phase 9: the eager user surface.  The loop of
# examples/train_transformer_lm.py:91-183 (its TransformerBlock of gluon
# Dense / LayerNorm, qkv[0] slicing, a standalone gluon.Parameter for the
# positions, nd.contrib.DotProductAttention, Trainer(dict, "adam"), the
# copy task with lag 7) at the full width of tools/benchmark_lm.py:40-45,
# f32.  The loss must fall from step 1 to step 6; steps 2-6 are timed.
# The learning rate is 1e-4, not the example's 3e-3: adam's first steps
# move every weight by about lr whatever its gradient, and at dim 1024
# 3e-3 throws the loss up (10.61 to 50.69 over six steps on an H100; at
# dim 1024 and 2 layers on the CPU the JAX package goes 10.436 to 66.911
# and the port alike), while 1e-4 lowers it there (10.436 to 9.411).
USER_STEPS = 6
USER_LR = 1e-4
USER_LAG = 7
# the op sweep, card against the port's CPU path: an "exact" case (shape,
# index, comparison, integer and exactly-rounded ops) must be equal.  A
# "float" case is held to 2**-18 (64 ulps of f32 at the array's scale,
# max(1, max |cpu|)): CUDA's f32 math library and the CPU's differ by a
# few ulps per call (the CUDA C Programming Guide lists maximum errors of
# 1-9 ulps for these functions, more for lgammaf near its poles), and
# the summing ops (sum, mean, norm, dot, ...) of at most 60 terms differ
# by summation order, well under 2**-18 of the scale.  A "random" case is
# held by distribution (4 standard errors) and must repeat under one seed.
TOL_SWEEP = 2.0 ** -18
SWEEP_DRAWS = 200000


def sweep_equal(np, a, b):
    if a.dtype.kind in "fc":
        return bool(np.all((a == b) | (np.isnan(a) & np.isnan(b))))
    return bool(np.all(a == b))


def op_sweep(torch, mx, card, seed, devices=None, draws=SWEEP_DRAWS):
    """Phase 9 (a): every case of ``test_utils.op_sweep_cases`` through
    ``nd`` on the card and on the CPU (*devices*, default (gpu(0),
    cpu())).  Returns the worst float ratio."""
    import numpy as np
    from mxnet_tpu_torch.test_utils import (SAMPLER_MOMENTS, moments_within,
                                            op_sweep_cases)
    from mxnet_tpu_torch.ops import registry as reg
    cases = op_sweep_cases(seed=seed, draws=draws)
    gpu, cpu = devices or (mx.gpu(0), mx.cpu())
    failures, worst, kinds = [], 0.0, {}

    def run(case, ctx):
        ins = [mx.nd.array(a, ctx=ctx, dtype=a.dtype) for a in case["inputs"]]
        out = mx.nd.imperative_invoke(case["name"], *ins, ctx=ctx,
                                      **case["params"])
        outs = out if isinstance(out, list) else [out]
        return [o.asnumpy() for o in outs]

    t0 = time.perf_counter()
    for case in cases:
        kinds[case["kind"]] = kinds.get(case["kind"], 0) + 1
        try:
            if case["kind"] == "random":
                mx.random.seed(seed)
                got = run(case, gpu)
                mx.random.seed(seed)
                again = run(case, gpu)
                if not all(np.array_equal(g, a) for g, a in zip(got, again)):
                    failures.append("%s: one seed gave other draws"
                                    % case["id"])
                    continue
                want = run(case, cpu)
                if [g.shape for g in got] != [w.shape for w in want] or \
                        [g.dtype for g in got] != [w.dtype for w in want]:
                    failures.append("%s: shape or dtype" % case["id"])
                    continue
                canon = reg.get_op(case["name"]).name
                out = got[0].astype(np.float64)
                if canon == "Dropout":
                    p = case["params"]["p"]
                    kept = out != 0
                    ok, text = moments_within(kept.reshape(-1).astype(
                        np.float64), 1 - p, p * (1 - p))
                    ok = ok and bool(np.all(out[kept] ==
                                            np.float32(1 / (1 - p))))
                elif canon == "shuffle":
                    ok = sorted(map(tuple, got[0])) == \
                        sorted(map(tuple, case["inputs"][0]))
                    text = "not a permutation of the rows"
                else:
                    mean, var = SAMPLER_MOMENTS[canon]
                    rows = out.reshape(len(np.atleast_1d(mean)), -1)
                    ok, text = True, ""
                    for row, m, v in zip(rows, np.atleast_1d(mean),
                                         np.atleast_1d(var)):
                        r_ok, r_text = moments_within(row, m, v)
                        ok, text = ok and r_ok, text + r_text + "; "
                if not ok:
                    failures.append("%s: %s" % (case["id"], text))
                continue
            got, want = run(case, gpu), run(case, cpu)
            for g, w in zip(got, want):
                if g.shape != w.shape or g.dtype != w.dtype:
                    failures.append("%s: shape/dtype %s %s vs %s %s" % (
                        case["id"], g.shape, g.dtype, w.shape, w.dtype))
                elif case["kind"] == "exact":
                    if not sweep_equal(np, g, w):
                        failures.append("%s: not equal (max diff %s)" % (
                            case["id"], np.nanmax(np.abs(
                                g.astype(np.float64) - w))))
                else:
                    fin = np.isfinite(w)
                    if not np.array_equal(fin, np.isfinite(g)):
                        failures.append("%s: non-finite at other places"
                                        % case["id"])
                        continue
                    scale = max(1.0, float(np.max(np.abs(w[fin])))
                                if fin.any() else 1.0)
                    err = float(np.max(np.abs(g[fin].astype(np.float64) -
                                              w[fin]))) if fin.any() else 0.0
                    ratio = err / (TOL_SWEEP * scale)
                    worst = max(worst, ratio)
                    if ratio > 1.0:
                        failures.append("%s: %.3g of the limit"
                                        % (case["id"], ratio))
        except Exception as e:       # recorded, and the phase fails below
            failures.append("%s: %s: %s" % (case["id"], type(e).__name__, e))
    names = {c["name"] for c in cases}
    log("user surface: op sweep of %d cases over %d op names (%s) on %s "
        "and the CPU in %.1f s; worst float case %.3g of 2**-18 x scale; "
        "%d failures" % (len(cases), len(names), ", ".join(
            "%s %d" % kv for kv in sorted(kinds.items())), card,
            time.perf_counter() - t0, worst, len(failures)))
    if failures:
        for f in failures[:40]:
            log("  sweep failure: %s" % f)
        raise RuntimeError("the op sweep failed %d of %d cases: %s"
                           % (len(failures), len(cases), failures[:5]))
    return worst


def user_lm(mx, gen):
    """The example's model at full width on the card, its parameters
    collected as the example collects them."""
    sys.path.insert(0, os.path.join(HERE, "examples"))
    from train_transformer_lm import TransformerBlock
    gluon = mx.gluon
    embed = gluon.nn.Embedding(VOCAB, DIM, prefix="embed_")
    blocks = [TransformerBlock(mx, DIM, HEADS, "blk%d_" % i)
              for i in range(LAYERS)]
    head = gluon.nn.Dense(VOCAB, flatten=False, prefix="head_")
    pos = gluon.Parameter("pos_embed", shape=(1, SEQ, DIM))
    all_blocks = [embed, head] + [b for blk in blocks for b in blk.blocks]
    for b in all_blocks:
        b.initialize(mx.init.Xavier(), generator=gen)
    pos.initialize(mx.init.Normal(0.02), generator=gen)
    params = {}
    for b in all_blocks:
        params.update(b.collect_params())
    params[pos.name] = pos
    return embed, blocks, head, pos, params


def user_loss(mx, model, x, y, attention_fn):
    """The example's forward and loss, under ``autograd.record``."""
    embed, blocks, head, pos, _ = model
    with mx.autograd.record():
        h = embed(x) + pos.data()
        for blk in blocks:
            h = blk(h, attention_fn)
        logits = head(h)
        loss = mx.nd.mean(mx.gluon.loss.SoftmaxCrossEntropyLoss()(
            mx.nd.reshape(logits, (-1, VOCAB)), mx.nd.reshape(y, (-1,))))
    return loss


def phase_user_surface(torch, card, seed):
    if not torch.cuda.is_available():
        raise RuntimeError("phase 9 needs CUDA")
    import numpy as np
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import attention as att
    sys.path.insert(0, os.path.join(HERE, "examples"))
    from train_transformer_lm import copy_task_batch

    # (a) every op name of the slice, on the card against the CPU
    op_sweep(torch, mx, card, seed)

    # (b) the eager LM
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 9)
    t0 = time.perf_counter()
    model = user_lm(mx, gen)
    params = model[-1]
    rng = np.random.RandomState(seed + 9)
    batches = [copy_task_batch(rng, BATCH, SEQ, VOCAB, USER_LAG)
               for _ in range(USER_STEPS)]

    def kernel_attention(q, k, v):
        return mx.nd.contrib.DotProductAttention(q, k, v, causal=True)

    plain_op = attention_op(torch, att)

    def plain_attention(q, k, v):
        return mx.nd.NDArray(plain_op(q._data, k._data, v._data,
                                      causal=True))

    # the check step: one batch, the same weights, kernels against the
    # plain attention (forward and backward), before any update
    x, y = mx.nd.array(batches[0][0]), mx.nd.array(batches[0][1])
    losses = {}
    for what, fn in (("kernels", kernel_attention),
                     ("plain", plain_attention)):
        loss = user_loss(mx, model, x, y, fn)
        loss.backward()
        losses[what] = float(loss.asnumpy())
    gap = abs(losses["kernels"] - losses["plain"])
    ratio, ok = within(gap, abs(losses["plain"]), TOL_TRAIN_LOSS)
    log("user surface: built the example's LM (%d params) and ran the "
        "check step in %.2f s: loss %.6f with the kernels, %.6f with the "
        "plain attention, gap %.3g (%.3f of the limit 1e-5 x max(1, "
        "|loss|))" % (sum(int(np.prod(p.shape)) for p in params.values()),
                      time.perf_counter() - t0, losses["kernels"],
                      losses["plain"], gap, ratio))
    if not ok:
        raise RuntimeError("user surface: the check step's loss with the "
                           "kernels is not the plain attention's")

    # (c) the main path: the example's adam steps, launches counted
    trainer = mx.gluon.Trainer(params, "adam", {"learning_rate": USER_LR})
    counters = (att.flash_fwd, att.flash_bwd_dkdv, att.flash_bwd_dq)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
    step_losses, times = [], []
    for i, (xb, yb) in enumerate(batches):
        t0 = time.perf_counter()
        before = [c.launches for c in counters]
        x, y = mx.nd.array(xb), mx.nd.array(yb)
        loss = user_loss(mx, model, x, y, kernel_attention)
        loss.backward()
        trainer.step(1)
        step_losses.append(float(loss.asnumpy()))    # waits for the step
        times.append(time.perf_counter() - t0)
        grew = [c.launches - b for c, b in zip(counters, before)]
        log("user surface: step %d: loss %.6f, %.2f ms on %s; launches %s"
            % (i + 1, step_losses[-1], times[-1] * 1e3, card, grew))
        if grew != [LAYERS] * 3:
            raise RuntimeError("user surface: a step launched flash_fwd, "
                               "flash_bwd_dkdv, flash_bwd_dq %s times, "
                               "expected %d each" % (grew, LAYERS))
    launches = {c.__name__: c.launches for c in counters}
    ms = 1e3 * sum(times[1:]) / len(times[1:])
    log("user surface: %d adam steps: ms per step %.2f (steps 2-%d), %.0f "
        "tokens/s, peak device memory %.3f GB on %s; launches %s (expected "
        "%d each: %d layers x %d steps)" % (
            USER_STEPS, ms, USER_STEPS, BATCH * SEQ / ms * 1e3,
            torch.cuda.max_memory_allocated() / 1e9, card, launches,
            LAYERS * USER_STEPS, LAYERS, USER_STEPS))
    if not all(math.isfinite(v) for v in step_losses) or \
            not step_losses[-1] < step_losses[0]:
        raise RuntimeError("user surface: the loss did not fall from step "
                           "1 to step %d: %s" % (USER_STEPS, step_losses))
    if abs(step_losses[0] - losses["kernels"]) > \
            TOL_TRAIN_LOSS * max(1.0, abs(losses["kernels"])):
        raise RuntimeError("user surface: step 1's loss %.6f is not the "
                           "check step's %.6f" % (step_losses[0],
                                                  losses["kernels"]))
    if any(n != LAYERS * USER_STEPS for n in launches.values()):
        raise RuntimeError("user surface: launch counts %s" % launches)
    del model, params, trainer
    torch.cuda.empty_cache()
    return launches


# Phase 10: the symbolic training path.  The LM traced to a Symbol with a
# SoftmaxOutput head with normalization "valid" and grad_scale = batch:
# with the reference's rescale_grad of 1/batch the update follows the
# token-mean gradient, as phase 5's gluon step does ("null" would sum
# 16,384 tokens a batch, a step 2,048 times as large; "valid" alone,
# one 8 times as small, which moves the loss less in six batches than
# the batches differ).
MODULE_BATCHES, MODULE_EVAL_BATCHES = 6, 2
MODULE_WARM, MODULE_TIMED = 3, 5
MODULE_OPT = {"learning_rate": 0.01, "momentum": 0.9}
MODULE_LAG = 7
MODULE_PATH = "module LM train (fused graph, legacy)"
TOL_SCORE = 1e-9             # score vs perplexity from predict, relative
# Two runs of one step are bit-equal except in the arrays an Embedding
# reads: its backward (index_select's, index_add_ on the card) sums the
# rows of repeated ids with atomic adds, in an order that changes from
# run to run, so the table's gradient, and with it its momentum and
# weight, may move by a few ulps of the summed rows.  Those arrays are
# held to 2**-18 of their largest |value|; every other array bit for bit.
TOL_SCATTER = 2.0 ** -18


def module_symbol(mx, cfg, batch):
    """The LM of *cfg* (vocab, dim, heads, layers, seq) traced to a Symbol
    on ``sym.var('data')`` with a SoftmaxOutput head for *batch* rows."""
    from mxnet_tpu_torch.gluon.model_zoo.transformer import \
        get_transformer_lm
    vocab, dim, heads, layers, seq = cfg
    net = get_transformer_lm(vocab=vocab, dim=dim, heads=heads,
                             layers=layers, max_seq=seq, prefix="modlm_")
    logits = net(mx.sym.var("data"))
    return net, mx.sym.SoftmaxOutput(
        logits, mx.sym.var("softmax_label"), preserve_shape=True,
        normalization="valid", grad_scale=float(batch), name="softmax")


def module_weights(mx, net, ctx, gen, seq):
    """Random weights of the traced net from *gen*: {name: NDArray}."""
    net.initialize(mx.init.Xavier(), ctx=ctx, generator=gen)
    net._ensure_params(mx.nd.zeros((1, seq), ctx=ctx))   # deferred shapes
    return {n: p.data() for n, p in net.collect_params().items()}


def module_batches(mx, rng, n, batch, cfg):
    """*n* batches of phase 9's copy task (lag 7) as one NDArrayIter."""
    import numpy as np
    sys.path.insert(0, os.path.join(HERE, "examples"))
    from train_transformer_lm import copy_task_batch
    pairs = [copy_task_batch(rng, batch, cfg[4], cfg[0], MODULE_LAG)
             for _ in range(n)]
    x = np.concatenate([p[0] for p in pairs])
    y = np.concatenate([p[1] for p in pairs])
    return mx.io.NDArrayIter(x, y, batch_size=batch)


def module_nll(torch, probs, label):
    """(summed negative log-likelihood in float64, tokens) of a batch."""
    p = probs._data.reshape(-1, probs.shape[-1])
    ids = label._data.to(p.device).reshape(-1).long()
    picked = p.gather(1, ids[:, None])[:, 0].double()
    return float(-torch.log(torch.clamp(picked, min=1e-10)).sum()), \
        ids.numel()


def module_check_step(torch, mx, symbol, weights, ctx, x, y):
    """(a): the same weights bound twice, with the kernels and with the
    plain attention (``op_impls``), one forward and backward each: (mean
    loss with the kernels, with the plain attention, the boundary
    checker's worst ratios; on the card only, where the kernels run)."""
    from mxnet_tpu_torch.executor import Executor
    from mxnet_tpu_torch.ops import attention as att
    shapes = {"data": x.shape, "softmax_label": y.shape}
    worst = {}
    boundary = boundary_checker(torch, att, worst) \
        if ctx.device_type == "gpu" else None
    plain = {"_contrib_DotProductAttention": attention_op(
        torch, att, 512, boundary=boundary)}
    losses = []
    ex = Executor._simple_bind(symbol, ctx, "write", None, shapes)
    ex.copy_params_from(weights)
    for impls in (None, plain):
        run = ex if impls is None else Executor._simple_bind(
            symbol, ctx, "write", None, shapes, shared_exec=ex,
            op_impls=impls)
        out = run.forward(is_train=True, data=x, softmax_label=y)[0]
        nll, n = module_nll(torch, out, y)
        losses.append(nll / n)
        run.backward()
        del run, out
    del ex
    return losses[0], losses[1], worst


def module_bits(torch, mod):
    """Copies of the weights and optimizer states of *mod*, by name."""
    args, _ = mod.get_params()
    out = {n: a._data.clone() for n, a in args.items()}
    names = mod._exec_group.param_names
    for i, s in mod._updater.states.items():
        if isinstance(s, tuple):        # adam: (mean, variance)
            for j, t in enumerate(s):
                out["state%d:%s" % (j, names[i])] = t._data.clone()
        else:
            out["mom:" + names[i]] = s._data.clone()
    return out


def module_step(torch, mod, batch, fused):
    """One step of *mod* on *batch*, through the fused step or the legacy
    forward_backward + update."""
    os.environ["MXNET_MODULE_FUSED_STEP"] = "1" if fused else "0"
    try:
        mod.forward_backward_update(batch)
    finally:
        os.environ.pop("MXNET_MODULE_FUSED_STEP", None)


def scatter_arrays(symbol):
    """The weights an Embedding of *symbol* reads (their gradients are
    summed by atomic adds on the card)."""
    return {node.inputs[1][0].name for node in symbol._topo()
            if not node.is_var and node.op.name == "Embedding"}


def module_compare(got, want, scattered):
    """(values that differ in the arrays held bit for bit, of how many,
    their names, the worst ratio of an array of *scattered* to its
    limit TOL_SCATTER x max |value|)."""
    differ, total, names, worst = 0, 0, [], 0.0
    for n, b in want.items():
        a = got[n]
        if n.split(":")[-1] in scattered:
            gap = float((a - b).abs().max())
            worst = max(worst, gap / (TOL_SCATTER * max(
                float(b.abs().max()), 1e-30)))
            continue
        d = int((a != b).sum())
        differ, total = differ + d, total + a.numel()
        if d:
            names.append(n)
    return differ, total, names, worst


def module_fused_vs_legacy(torch, mx, mod, batch, weights):
    """(b): from *weights* and zero momenta, one fused step and one
    legacy step on *batch*: {True: weights and momenta after the fused
    step, False: after the legacy step}."""
    def reset():
        mod.set_params(weights, {})
        for s in mod._updater.states.values():
            s._data.zero_()
        mod._optimizer._index_update_count.clear()
        mod._optimizer.num_update = 0

    got = {}
    for fused in (True, False):
        reset()
        module_step(torch, mod, batch, fused)
        got[fused] = module_bits(torch, mod)
    return got


def module_time(torch, mod, batch, fused, warm, timed):
    """ms a step of *timed* steps after *warm*, host clock with a readback
    at the end (bench.py:462-476)."""
    def readback():
        return float(mod.get_outputs()[0]._data[0, 0, 0])
    for _ in range(warm):
        module_step(torch, mod, batch, fused)
    readback()
    t0 = time.perf_counter()
    for _ in range(timed):
        module_step(torch, mod, batch, fused)
    readback()
    return 1e3 * (time.perf_counter() - t0) / timed


def module_fit(torch, mx, mod, train, val, batch, weights):
    """(c): one epoch of ``fit`` from *weights* with
    ``Speedometer(batch, 1)`` and a perplexity metric; returns (per-batch training loss from each batch's
    own outputs, ms per batch of batches 2 on, the Speedometer's last
    samples/s, score, the perplexity recomputed from predict)."""
    losses, stamps = [], []

    def record(param):
        nll, n = module_nll(torch, mod.get_outputs()[0],
                            param.locals["data_batch"].label[0])
        losses.append(nll / n)
        stamps.append(time.perf_counter())

    speed = mx.callback.Speedometer(batch, 1)
    mod.fit(train, eval_data=val, eval_metric="perplexity", num_epoch=1,
            batch_end_callback=[record, speed], arg_params=weights,
            optimizer="sgd", optimizer_params=dict(MODULE_OPT))
    ms = 1e3 * (stamps[-1] - stamps[0]) / (len(stamps) - 1)
    score = dict(mod.score(val, "perplexity"))["perplexity"]
    preds = mod.predict(val)
    val.reset()
    labels = mx.nd.concatenate([b.label[0] for b in val])
    nll, n = module_nll(torch, preds, labels)
    del preds
    return losses, ms, speed.rate, score, math.exp(nll / n)


def module_checkpoint(torch, mod, prefix, batch):
    """(d), first half: save *mod* with its optimizer states, then take
    its next step on *batch*; returns the weights and momenta after it."""
    mod.save_checkpoint(prefix, MODULE_BATCHES, save_optimizer_states=True)
    module_step(torch, mod, batch, True)
    return module_bits(torch, mod)


def module_launches(att, programs):
    """{kernel: launches}: the wrappers' own launches plus, for each fused
    program's (captured launches, replays), replays x captured."""
    out = dict(att.launch_counts())
    for captured, replays in programs:
        for k, c in captured.items():
            out[k] = out.get(k, 0) + replays * c
    return out


def phase_module(torch, card, seed, cfg=None, ctx=None, batch=BATCH):
    """Phase 10: the LM trained through ``mx.mod.Module`` (see the module
    docstring).  *cfg*, *ctx* and *batch* size it down for the CPU test."""
    import numpy as np
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import attention as att
    if ctx is None:
        if not torch.cuda.is_available():
            raise RuntimeError("phase 10 needs CUDA")
        ctx = mx.gpu(0)
    cfg = cfg or (VOCAB, DIM, HEADS, LAYERS, SEQ)
    layers = cfg[3]
    on_card = ctx.device_type == "gpu"
    gen = torch.Generator(device=ctx.torch_device)
    gen.manual_seed(seed + 10)
    rng = np.random.RandomState(seed + 10)
    t_phase = time.perf_counter()
    net, symbol = module_symbol(mx, cfg, batch)
    weights = module_weights(mx, net, ctx, gen, cfg[4])
    del net
    train = module_batches(mx, rng, MODULE_BATCHES, batch, cfg)
    val = module_batches(mx, rng, MODULE_EVAL_BATCHES, batch, cfg)
    first = next(iter(train))
    train.reset()
    x, y = first.data[0], first.label[0]
    record = {"card": card}

    # (a) the check step
    k_loss, p_loss, worst = module_check_step(torch, mx, symbol, weights,
                                              ctx, x, y)
    gap = abs(k_loss - p_loss)
    ratio, ok = within(gap, abs(p_loss), TOL_TRAIN_LOSS)
    record["check"] = dict(worst, loss=k_loss, plain_loss=p_loss, gap=gap)
    log("module: check step on %s: loss %.6f with the kernels, %.6f with "
        "the plain attention, gap %.3g (%.3f of 1e-5 x max(1, |loss|)); at "
        "the op over %d layers flash_fwd o worst error/limit %.3f, "
        "max|lse-plain| %.3g, dq dk dv worst error/limit %.3f, bf16 least "
        "%.3f (must exceed 1)" % (
            card, k_loss, p_loss, gap, ratio, worst.get("layers", 0),
            worst.get("fwd", 0), worst.get("lse", 0), worst.get("bwd", 0),
            worst.get("bf16", 0)))
    if not ok or on_card and not (
            worst.get("layers") == layers and worst["fwd"] <= 1.0 and
            worst["lse"] <= TOL_LSE and worst["bwd"] <= 1.0 and
            worst["bf16"] > 1.0):
        raise RuntimeError("module: the check step failed (above)")

    # the main path: the Module's steps, fused and legacy, then fit
    att_counters = (att.flash_fwd, att.flash_bwd_dkdv, att.flash_bwd_dq)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    for c in att_counters:
        c.launches = 0
        c.captured = 0
    programs = []

    # (b) fused against legacy, then timed
    mod = mx.mod.Module(symbol, context=ctx)
    mod.bind(train.provide_data, train.provide_label)
    mod.init_params(arg_params=weights)
    mod.init_optimizer(optimizer="sgd", optimizer_params=dict(MODULE_OPT))
    scattered = scatter_arrays(symbol)
    steps = module_fused_vs_legacy(torch, mx, mod, first, weights)
    differ, total, names, worst = module_compare(steps[True], steps[False],
                                                 scattered)
    del steps
    record["bits"] = (differ, total, names[:5], worst)
    log("module: one fused step against one legacy step from the same "
        "weights and batch: %d of %d weight and momentum values differ%s; "
        "the Embedding-read arrays (%s) worst gap / limit %.4f (limit "
        "2**-18 x max |value|)" % (
            differ, total, " (%s)" % ", ".join(names[:5]) if names else "",
            ", ".join(sorted(scattered)), worst))
    if differ or worst > 1.0:
        raise RuntimeError("module: the fused step is not the legacy step")
    before = {c.__name__: c.launches for c in att_counters}
    ms = {}
    for fused in (True, False):
        ms[fused] = module_time(torch, mod, first, fused, MODULE_WARM,
                                MODULE_TIMED)
    legacy_steps = MODULE_WARM + MODULE_TIMED
    grew = {c.__name__: c.launches - before[c.__name__]
            for c in att_counters}
    prog = mod.fused_step
    programs.append((dict(prog.captured), prog.replays))
    fused_steps = 1 + MODULE_WARM + MODULE_TIMED
    record["timing"] = {"fused_ms": ms[True], "legacy_ms": ms[False],
                        "captures": prog.captures, "replays": prog.replays,
                        "captured": dict(prog.captured)}
    log("module: %d timed steps after %d warm-ups on %s: fused (one CUDA "
        "graph) %.2f ms a step, %.3f steps/s; legacy (forward_backward + "
        "update) %.2f ms, %.3f steps/s; captures %d, replays %d, captured "
        "%s" % (MODULE_TIMED, MODULE_WARM, card, ms[True], 1e3 / ms[True],
                ms[False], 1e3 / ms[False], prog.captures, prog.replays,
                prog.captured))
    if on_card and (prog.captures != 1 or prog.replays != fused_steps or
                    any(prog.captured.get(c.__name__) != layers
                        for c in att_counters)):
        raise RuntimeError("module: the fused step captured %d times with "
                           "%d replays for %d steps, %s launches each"
                           % (prog.captures, prog.replays, fused_steps,
                              prog.captured))
    if on_card and any(g != layers * legacy_steps for g in grew.values()):
        raise RuntimeError("module: %d legacy steps launched %s, expected "
                           "%d each" % (legacy_steps, grew,
                                        layers * legacy_steps))
    del mod, prog

    # (c) fit from the same weights, then score against predict
    mod = mx.mod.Module(symbol, context=ctx)
    t0 = time.perf_counter()
    losses, fit_ms, rate, score, recomputed = module_fit(
        torch, mx, mod, train, val, batch, weights)
    programs.append((dict(mod.fused_step.captured), mod.fused_step.replays))
    tokens = batch * cfg[4]
    peak = torch.cuda.max_memory_allocated() / 1e9 if on_card else 0.0
    record["fit"] = {"losses": losses, "ms": fit_ms,
                     "tokens_per_s": tokens / fit_ms * 1e3,
                     "speedometer_samples_per_s": rate, "score": score,
                     "recomputed": recomputed, "peak_gb": peak,
                     "seconds": time.perf_counter() - t0}
    log("module: fit, one epoch of %d batches and %d eval batches on %s: "
        "training loss by batch %s; %.2f ms a batch (batches 2-%d), %.0f "
        "tokens/s (Speedometer %.2f samples/s); score perplexity %.6f, "
        "from predict's outputs %.6f; peak device memory %.3f GB" % (
            MODULE_BATCHES, MODULE_EVAL_BATCHES, card,
            ", ".join("%.6f" % v for v in losses), fit_ms, MODULE_BATCHES,
            tokens / fit_ms * 1e3, rate or 0.0, score, recomputed, peak))
    if not all(math.isfinite(v) for v in losses) or \
            not losses[-1] < losses[0]:
        raise RuntimeError("module: the training loss did not fall from "
                           "batch 1 to %d: %s" % (MODULE_BATCHES, losses))
    # fit's first batch is the check step's, from the same weights
    if not within(abs(losses[0] - k_loss), abs(k_loss), TOL_TRAIN_LOSS)[1]:
        raise RuntimeError("module: fit's first loss %.6f is not the check "
                           "step's %.6f" % (losses[0], k_loss))
    if abs(score - recomputed) > TOL_SCORE * abs(recomputed):
        raise RuntimeError("module: score %.9f is not the perplexity of "
                           "predict's outputs %.9f" % (score, recomputed))
    launches = module_launches(att, programs)

    # (d) the checkpoint: the original's next step against a loaded one's
    tmp = tempfile.mkdtemp(prefix="chip_smoke_module_")
    try:
        prefix = os.path.join(tmp, "lm")
        want = module_checkpoint(torch, mod, prefix, first)
        del mod
        if on_card:
            torch.cuda.empty_cache()
        mod = mx.mod.Module.load(prefix, MODULE_BATCHES,
                                 load_optimizer_states=True, context=ctx)
        mod.bind(train.provide_data, train.provide_label)
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params=dict(MODULE_OPT))
        module_step(torch, mod, first, True)
        got = module_bits(torch, mod)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    differ, total, names, worst = module_compare(got, want, scattered)
    record["checkpoint"] = (differ, worst)
    log("module: save_checkpoint (with optimizer states) -> Module.load: "
        "the next step differs from the original's in %d of %d values "
        "held bit for bit%s; the Embedding-read arrays worst gap / limit "
        "%.4f" % (differ, total, " (%s)" % ", ".join(names[:5])
                  if names else "", worst))
    if differ or worst > 1.0 or set(got) != set(want):
        raise RuntimeError("module: the loaded Module's step is not the "
                           "original's")
    del mod, want, got
    if on_card:
        torch.cuda.empty_cache()
    log("module: phase 10 took %.1f s; main-path launches %s"
        % (time.perf_counter() - t_phase, launches))
    record["launches"] = launches
    return record


# Phase 11: recurrent networks.  (a) The RNN op's card route (cuDNN
# through PyTorch's fused recurrent functions) against its plain
# per-step version on the card; control flow on the card against the
# CPU, and a foreach RNN inside a Module's fused step.  (b) The LSTM LM
# of tools/benchmark_lm.py --arch lstm at its defaults (:38-46, :70-71,
# :78-94): vocab 32000, dim 1024, max(2, 12 // 6) = 2 LSTM layers, batch
# 8 x 2048, through ParallelTrainer at dp = 1 with bf16 compute weights
# and f32 masters.  (c) The loop of examples/train_lm.py (:70-124) at the
# PTB-medium width of gluon/model_zoo/lm.py:25-27 through BucketingModule.
RNN_SHAPE = (256, 8, 64, 128)       # T, batch, input, hidden
RNN_CASES = (                       # mode, layers, bidirectional,
    ("lstm", 1, False, True, None),         # state_outputs, clip
    ("lstm", 2, True, True, None),
    ("lstm", 2, False, False, None),
    ("lstm", 1, False, True, (-0.5, 0.5, False)),
    ("lstm", 1, True, True, (-0.2, 0.2, True)),
    ("gru", 1, True, True, None),
    ("gru", 2, False, False, None),
    ("rnn_tanh", 2, True, True, None),
    ("rnn_tanh", 1, False, False, None),
    ("rnn_relu", 1, False, True, None),
    ("rnn_relu", 2, True, False, None))
# the card's route against the plain loop on the same inputs, each output
# and each gradient to max |plain| of that tensor: float32 (summation
# orders of 256 recurrent steps; TF32 products must break it); bfloat16,
# against the plain loop in float32 on the same bf16 values: the route
# computes in float32 and rounds each result once, by at most half a
# bf16 ulp, 2**-8 of its value, so the limit is one ulp of the largest
TOL_RNN = {"float32": 2.0 ** -14, "bfloat16": 2.0 ** -7}
LSTM_CFG = (32000, 1024, 2, 2048)   # vocab, dim, layers, seq
LSTM_PARAMS = 82329600
LSTM_OPT = {"learning_rate": 0.01, "momentum": 0.9}
LSTM_STEPS = 5                      # the loss must fall from step 1 to 5
TOL_LSTM_GRAD = 1e-4                # x each gradient's max |g| (plain op)
TOL_LSTM_BF16_LOSS = 1.0            # x BF16_U x max(1, |loss|)
TOL_LSTM_BF16_GRAD = 16.0           # x BF16_U, ||g - g32|| / ||g32||
RNN_RANGES = ("RNN forward", "RNN backward", "head forward",
              "head backward")
BUCKET_CFG = (10000, 650, 650, 2)   # vocab, hidden, embed, layers
BUCKETS = (8, 12, 16, 20)
BUCKET_BATCH = 32
BUCKET_SENTENCES, BUCKET_VAL = 1920, 128
BUCKET_LR = 1e-3
BUCKET_WINDOW = 10                  # batches averaged at each end of the
                                    # epoch for "perplexity falls"


def rnn_case_inputs(torch, case, dtype, dev, gen, shape=RNN_SHAPE):
    """Inputs of one op case: x, the packed parameters (uniform within
    1 / sqrt(H), PyTorch's RNN initialization), h0, c0, and the op's
    keyword arguments."""
    from mxnet_tpu_torch.ops.rnn import rnn_param_size
    mode, layers, bidir, state_outputs, clip = case
    t, b, i, h = shape
    dirs = 2 if bidir else 1
    n = rnn_param_size(mode, i, h, layers, bidir)
    bound = 1.0 / math.sqrt(h)
    par = (torch.rand(n, generator=gen, device=dev) * 2 - 1) * bound
    x = torch.randn(t, b, i, generator=gen, device=dev)
    h0 = torch.randn(layers * dirs, b, h, generator=gen, device=dev) * 0.5
    c0 = torch.randn(layers * dirs, b, h, generator=gen, device=dev) * 0.5
    kw = dict(state_size=h, num_layers=layers, bidirectional=bidir,
              mode=mode, state_outputs=state_outputs, training=True)
    if clip is not None:
        kw.update(lstm_state_clip_min=clip[0], lstm_state_clip_max=clip[1],
                  lstm_state_clip_nan=clip[2])
    ins = [x, par, h0] + ([c0] if mode == "lstm" else [])
    return [a.to(dtype) for a in ins], kw


def rnn_run(torch, fn, ins, kw, cots):
    """Outputs and input gradients (data, parameters, states) of one
    forward and backward of *fn* (the op's signature) with cotangents
    *cots* (one per output, made on the first call when None)."""
    leaves = [a.detach().clone().requires_grad_() for a in ins]
    outs = fn(None, *leaves, **kw)
    if cots is None:
        g = torch.Generator(device=outs[0].device)
        g.manual_seed(7)
        cots = [torch.randn(o.shape, generator=g, device=o.device).to(
            o.dtype) for o in outs]
    grads = torch.autograd.grad(list(outs), leaves, cots)
    return [o.detach() for o in outs] + list(grads), cots


def rnn_worst(torch, got, want):
    """max over tensors of max |got - want| / max |want| (inf where got is
    not finite)."""
    worst = 0.0
    for a, b in zip(got, want):
        a, b = a.double(), b.double()
        if not bool(torch.isfinite(a).all()):
            return math.inf
        worst = max(worst, float((a - b).abs().max()) /
                    max(float(b.abs().max()), 1e-30))
    return worst


def rnn_op_checks(torch, dev, on_card, seed, shape=RNN_SHAPE,
                  dtypes=("float32", "bfloat16")):
    """(a), the op: each case in float32 and bfloat16 through the op (the
    card's route) and through ``plain_rnn`` on the same device; relaunched
    for bit-equality; a TF32 float32 run must break the float32 limit
    (on the card).  Returns a list of per-case records; raises on a
    failed check."""
    from mxnet_tpu_torch.ops import rnn as rnn_op
    op = rnn_op._rnn
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 11)
    records, failures = [], []
    for case in RNN_CASES:
        for dtn in dtypes:
            dtype = getattr(torch, dtn)
            ins, kw = rnn_case_inputs(torch, case, dtype, dev, gen, shape)
            got, cots = rnn_run(torch, op, ins, kw, None)
            again, _ = rnn_run(torch, op, ins, kw, cots)
            equal = all(torch.equal(a, b) for a, b in zip(got, again))
            ins32 = [a.float() for a in ins]
            cots32 = [c.float() for c in cots]
            want, _ = rnn_run(torch, rnn_op.plain_rnn, ins32, kw, cots32)
            err = rnn_worst(torch, got, want)
            rec = {"case": case, "dtype": dtn, "err": err,
                   "ratio": err / TOL_RNN[dtn], "relaunch_equal": equal}
            if dtn == "float32" and on_card:
                real = rnn_op.rnn_precision
                rnn_op.rnn_precision = lambda d: "tf32"
                try:
                    tf32, _ = rnn_run(torch, op, ins, kw, cots)
                finally:
                    rnn_op.rnn_precision = real
                rec["tf32_ratio"] = rnn_worst(torch, tf32, want) / \
                    TOL_RNN["float32"]
                if not rec["tf32_ratio"] > 1.0:
                    failures.append("%s: TF32 stays within the f32 limit "
                                    "(%.3f)" % (case, rec["tf32_ratio"]))
            if dtn == "bfloat16":
                # the reference's semantics, every step rounded to bf16
                ref16, _ = rnn_run(torch, rnn_op.plain_rnn, ins, kw, cots)
                rec["plain_bf16_vs_f32"] = rnn_worst(torch, ref16, want)
                rec["f32_limit_ratio"] = err / TOL_RNN["float32"]
                if on_card and not rec["f32_limit_ratio"] > 1.0:
                    failures.append("%s bf16 within the f32 limit" % (case,))
            if not rec["ratio"] <= 1.0:
                failures.append("%s %s: error %.3g is %.3f of its limit"
                                % (case, dtn, err, rec["ratio"]))
            if not equal:
                failures.append("%s %s: a relaunch is not bit-equal"
                                % (case, dtn))
            records.append(rec)
            del got, again, want
    worst = {d: max((r["ratio"] for r in records if r["dtype"] == d),
                    default=0.0) for d in TOL_RNN}
    log("lstm (a): the RNN op's route %r on %s against plain_rnn, %d cases "
        "x f32/bf16 at T %d, batch %d, input %d, hidden %d (forward "
        "outputs and states, gradients of data, parameters and states): "
        "worst error / limit f32 %.4f (limit 2**-14 x max |plain|), bf16 "
        "%.4f (2**-7, against the plain loop in f32 on the bf16 values); "
        "relaunches bit-equal %s" % (
            rnn_op.route_of(torch.empty(0, device=dev)), dev, len(RNN_CASES),
            shape[0], shape[1], shape[2], shape[3], worst["float32"],
            worst["bfloat16"], all(r["relaunch_equal"] for r in records)))
    for r in records:
        extra = ""
        if "tf32_ratio" in r:
            extra = ", TF32 %.2f of the limit" % r["tf32_ratio"]
        if "plain_bf16_vs_f32" in r:
            extra = ", the plain loop in bf16 (every step rounded) %.4g " \
                "from f32, the bf16 route %.1f x the f32 limit" % (
                    r["plain_bf16_vs_f32"], r["f32_limit_ratio"])
        log("  %-38s %-8s error %.3g (%.4f of the limit)%s" % (
            r["case"], r["dtype"], r["err"], r["ratio"], extra))
    if failures:
        raise RuntimeError("lstm (a): " + "; ".join(failures))
    return records


def control_flow_symbols(mx):
    """(name, symbol, {argument: numpy value}) of a foreach RNN, a
    masked while loop with a closure and a cond whose branch not taken
    has an infinite derivative."""
    import numpy as np
    s = mx.sym
    rs = np.random.RandomState(5)
    wx, wh = s.var("wx"), s.var("wh")

    def body(x, st):
        h = s.tanh(s.FullyConnected(x, wx, no_bias=True, num_hidden=16) +
                   s.FullyConnected(st[0], wh, no_bias=True, num_hidden=16))
        return h, [h]
    fo, ff = s.contrib.foreach(body, s.var("data"), [s.var("h0")])
    w = s.var("w")
    wo, wf = s.contrib.while_loop(
        lambda i, v: i < 4, lambda i, v: (v * w, [i + 1, s.tanh(v * w)]),
        [s.var("i"), s.var("v")], max_iterations=6)
    x = s.var("x")
    co = s.contrib.cond(s.sum(x) > 0, lambda: x * 2, lambda: s.log(x))
    return [
        ("foreach", s.Group([fo, ff[0]]), {
            "data": rs.randn(12, 4, 8).astype("float32"),
            "h0": np.zeros((4, 16), "float32"),
            "wx": (rs.randn(16, 8) * 0.3).astype("float32"),
            "wh": (rs.randn(16, 16) * 0.3).astype("float32")}),
        ("while_loop", s.Group([wo, wf[1]]), {
            "i": np.zeros(1, "float32"),
            "v": rs.randn(8).astype("float32"),
            "w": rs.randn(8).astype("float32")}),
        ("cond", co, {"x": np.array([0.0, 1.0, 2.0], "float32")})]


def control_flow_run(mx, symbol, args, ctx):
    """Outputs and every argument's gradient (head gradients of ones) of
    *symbol* on *ctx*, as float64 numpy arrays."""
    exe = symbol.bind(ctx=ctx, args={k: mx.nd.array(v, ctx=ctx)
                                     for k, v in args.items()},
                      args_grad={k: mx.nd.zeros(v.shape, ctx=ctx)
                                 for k, v in args.items()})
    outs = exe.forward(is_train=True)
    exe.backward([mx.nd.ones(o.shape, ctx=ctx) for o in outs])
    return ([o.asnumpy().astype("float64") for o in outs] +
            [exe.grad_dict[k].asnumpy().astype("float64") for k in args])


def foreach_module(mx, batch):
    """A foreach RNN (hidden 16) over 12 steps with a SoftmaxOutput head,
    and one batch for it."""
    import numpy as np
    s = mx.sym
    wx = s.var("rnn_i2h_weight", shape=(16, 8))
    wh = s.var("rnn_h2h_weight", shape=(16, 16))

    def body(x, st):
        h = s.tanh(s.FullyConnected(x, wx, no_bias=True, num_hidden=16) +
                   s.FullyConnected(st[0], wh, no_bias=True, num_hidden=16))
        return h, [h]
    data = s.swapaxes(s.var("data"), dim1=0, dim2=1)
    _, last = s.contrib.foreach(body, data, [s.var("h0",
                                                   shape=(batch, 16))])
    net = s.SoftmaxOutput(s.FullyConnected(last[0], num_hidden=5,
                                           name="fc"),
                          s.var("softmax_label"), name="sm")
    rs = np.random.RandomState(6)
    it = mx.io.NDArrayIter(rs.randn(batch, 12, 8).astype("float32"),
                           rs.randint(0, 5, batch).astype("float32"),
                           batch_size=batch)
    return net, it


def control_flow_checks(torch, mx, ctx, card):
    """(a), control flow: each symbol on *ctx* against the CPU (outputs
    and gradients within TOL_SWEEP of their scale), the cond gradient
    finite; then a foreach RNN trained through a Module, 3 fused steps
    (one CUDA graph on the card: one capture, a replay a step) against 3
    legacy steps from the same weights, bit for bit."""
    import numpy as np
    worst = 0.0
    for name, symbol, args in control_flow_symbols(mx):
        got = control_flow_run(mx, symbol, args, ctx)
        want = control_flow_run(mx, symbol, args, mx.cpu())
        for a, b in zip(got, want):
            if not np.isfinite(a).all():
                raise RuntimeError("lstm (a): %s on %s is not finite"
                                   % (name, card))
            worst = max(worst, float(np.abs(a - b).max()) /
                        (TOL_SWEEP * max(1.0, float(np.abs(b).max()))))
    net, it = foreach_module(mx, 4)
    batch = next(iter(it))
    results, prog, weights = [], None, None
    for fused in (True, False):
        mod = mx.mod.Module(net, context=ctx, fixed_param_names=["h0"])
        mod.bind(it.provide_data, it.provide_label)
        if weights is None:
            mod.init_params(mx.init.Xavier())
            weights = mod.get_params()[0]
        mod.init_params(arg_params=weights, force_init=True)
        mod.init_optimizer(optimizer="sgd", optimizer_params={
            "learning_rate": 0.5, "momentum": 0.9})
        for _ in range(3):
            module_step(torch, mod, batch, fused)
        if fused:
            prog = mod.fused_step
        results.append({n: a._data.clone()
                        for n, a in mod.get_params()[0].items()})
    differ = sum(int((results[0][n] != results[1][n]).sum())
                 for n in results[0])
    on_card = ctx.device_type == "gpu"
    log("lstm (a): control flow on %s against the CPU: foreach, while_loop "
        "and cond (outputs, gradients) worst gap %.4f of 2**-18 x max(1, "
        "|cpu|); a foreach RNN through Module: 3 fused steps (captures %d, "
        "replays %d) against 3 legacy steps: %d values differ"
        % (card, worst, prog.captures, prog.replays, differ))
    if worst > 1.0 or differ or (on_card and (prog.captures != 1 or
                                              prog.replays != 3)):
        raise RuntimeError("lstm (a): the control-flow checks failed "
                           "(above)")
    return {"worst": worst, "captures": prog.captures,
            "replays": prog.replays, "differ": differ}


class _RangedHead:
    """A stand-in for FullyConnected whose head product (flatten=False,
    no bias) runs its forward and backward inside profiler ranges."""

    def __init__(self, torch, fn):
        self.fn = fn

        class Head(torch.autograd.Function):
            @staticmethod
            def forward(ctx, data, weight):
                with torch.profiler.record_function("head forward"):
                    out = torch.matmul(data, weight.t())
                ctx.save_for_backward(data, weight)
                return out

            @staticmethod
            def backward(ctx, g):
                data, weight = ctx.saved_tensors
                with torch.profiler.record_function("head backward"):
                    gd = torch.matmul(g, weight)
                    gw = torch.matmul(g.reshape(-1, g.shape[-1]).t(),
                                      data.reshape(-1, data.shape[-1]))
                return gd, gw
        self.head = Head

    def __call__(self, data, weight, *rest, num_hidden=0, no_bias=False,
                 flatten=True):
        if flatten or not no_bias:
            return self.fn(data, weight, *rest, num_hidden=num_hidden,
                           no_bias=no_bias, flatten=flatten)
        return self.head.apply(data, weight)


def rnn_ranges(torch):
    """Put the RNN op's card route and the LM's head in profiler ranges
    (``RNN_RANGES``) until the returned undo is called."""
    from mxnet_tpu_torch.ops import rnn as rnn_op
    from mxnet_tpu_torch.ops.registry import get_op
    cls = rnn_op._FusedRNN
    fwd, bwd = cls.forward, cls.backward

    def forward(ctx, *args):
        with torch.profiler.record_function("RNN forward"):
            return fwd(ctx, *args)

    def backward(ctx, *args):
        with torch.profiler.record_function("RNN backward"):
            return bwd(ctx, *args)
    fc = get_op("FullyConnected")
    real_fc = fc.fn
    cls.forward, cls.backward = staticmethod(forward), staticmethod(backward)
    fc.fn = _RangedHead(torch, real_fc)

    def undo():
        cls.forward, cls.backward = staticmethod(fwd), staticmethod(bwd)
        fc.fn = real_fc
    return undo


def lstm_trainer(torch, mx, ctx, gen, cfg, mp=True):
    """The LSTM LM of *cfg* (random weights from *gen*, shapes resolved)
    and its ParallelTrainer (sgd, LSTM_OPT) on *ctx*."""
    from mxnet_tpu_torch.gluon.model_zoo.lm import get_lstm_lm
    from mxnet_tpu_torch.parallel import ParallelTrainer, make_mesh
    vocab, dim, layers, _ = cfg
    net = get_lstm_lm(vocab, dim, layers, prefix="lstmlm_")
    net.initialize(init=lstm_init(mx, dim), ctx=ctx, generator=gen)
    net._ensure_params(mx.nd.zeros((1, 8), ctx=ctx, dtype="int32"))
    trainer = ParallelTrainer(
        net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), optimizer="sgd",
        optimizer_params=dict(LSTM_OPT),
        mesh=make_mesh({"dp": 1}, [ctx.torch_device]), multi_precision=mp)
    return net, trainer


def lstm_init(mx, dim):
    """PyTorch's own initialization of these layers: embeddings N(0, 1),
    LSTM and head weights U(-1/sqrt(dim), 1/sqrt(dim)), biases zero.
    (The package default, U(-0.07, 0.07) everywhere, leaves the hidden
    states near 0.01 and the logits near 0: five steps of lr 0.01 then
    move the loss by less than float32 resolves at 10.4.)"""
    return mx.init.Mixed([".*embedding.*_weight", ".*"],
                         [mx.init.Normal(1.0),
                          mx.init.Uniform(1.0 / math.sqrt(dim))])


def lstm_f32_loss(torch, trainer, x, y):
    """The mean loss of the trainer's float32 master weights on (x, y),
    inference evaluation in float32: the loss at a resolution the bf16
    per-sample losses (spaced 2**-4 near 10) do not have."""
    from mxnet_tpu_torch.executor import _build_eval
    params = {n: (trainer._opt_state[n][-1] if n not in trainer._frozen
                  else t).float() for n, t in trainer._params.items()}
    ev = _build_eval(trainer._graph, False)
    with torch.no_grad():
        outs, _ = ev(dict(params, data0=trainer._device_batch(x),
                          label0=trainer._label_batch(y)), trainer._aux)
        return torch.mean(outs[0].float()).item()


def lstm_check_step(torch, trainer, x, y):
    """(b)'s check step on the trainer's bf16 compute weights taken to
    float32: (loss, gradients) with the op's route, with ``plain_rnn``
    bound in, and in bfloat16 with the route."""
    from mxnet_tpu_torch.ops.rnn import plain_rnn
    params = {n: t.float() for n, t in trainer._params.items()}
    xd, yd = trainer._device_batch(x), trainer._label_batch(y)
    out = {}
    for name, dtype, impls in (("route", torch.float32, None),
                               ("plain", torch.float32, {"RNN": plain_rnn}),
                               ("bf16", torch.bfloat16, None)):
        out[name] = graph_loss_grads(torch, trainer._graph, params,
                                     trainer._aux, xd, yd, dtype, impls)
        if torch.cuda.is_available() and xd.is_cuda:
            torch.cuda.empty_cache()
    return out


def rnn_route_ms(torch, cfg, dev, gen):
    """ms of one forward and backward of the LM's RNN op at its full shape
    (T = seq, batch 8, dim -> dim, 2 layers) on the card's route in bf16
    and f32 (CUDA events, 3 runs after a warm-up) and on the plain route
    in bf16 (one run)."""
    from mxnet_tpu_torch.ops import rnn as rnn_op
    vocab, dim, layers, seq = cfg
    out = {}
    for name, dtn, fn, runs in (("cudnn bf16", "bfloat16", rnn_op._rnn, 3),
                                ("cudnn f32", "float32", rnn_op._rnn, 3),
                                ("plain bf16", "bfloat16",
                                 rnn_op.plain_rnn, 1)):
        case = ("lstm", layers, False, False, None)
        ins, kw = rnn_case_inputs(torch, case, getattr(torch, dtn), dev,
                                  gen, (seq, BATCH, dim, dim))
        _, cots = rnn_run(torch, fn, ins, kw, None)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        for _ in range(runs):
            rnn_run(torch, fn, ins, kw, cots)
        ev[1].record()
        torch.cuda.synchronize()
        out[name] = ev[0].elapsed_time(ev[1]) / runs
        del ins, cots
        torch.cuda.empty_cache()
    return out


def lstm_lm_phase(torch, mx, ctx, card, gen, rng, cfg):
    """(b): the north-star LSTM LM (see the phase comment)."""
    from mxnet_tpu_torch.ops import rnn as rnn_op
    vocab, dim, layers, seq = cfg
    on_card = ctx.device_type == "gpu"
    net, trainer = lstm_trainer(torch, mx, ctx, gen, cfg)
    n_params = sum(int(p.data().size) for p in
                   net.collect_params().values())
    x = mx.nd.array(rng.randint(0, vocab, (BATCH, seq)).astype("int32"),
                    ctx=ctx, dtype="int32")
    y = mx.nd.array(rng.randint(0, vocab, (BATCH, seq)).astype("float32"),
                    ctx=ctx)
    trainer._ensure_built(x._data, y._data)
    trainer._refresh_frozen(x.shape, y.shape)
    t0 = time.perf_counter()
    chk = lstm_check_step(torch, trainer, x._data, y._data)
    (lk, gk), (lp, gp), (lb, gb) = chk["route"], chk["plain"], chk["bf16"]
    gaps = grad_gaps(torch, gk, gp)
    loss_ratio, loss_ok = within(abs(lk - lp), abs(lp), TOL_TRAIN_LOSS)
    bf16_loss = abs(lb - lk) / (BF16_U * max(1.0, abs(lk)))
    bf16_grad = total_l2(torch, {n: g.float() for n, g in gb.items()},
                         gk) / BF16_U
    log("lstm (b): check step on %s (%.1f s): loss %.7f on the route, "
        "%.7f with plain_rnn bound in, gap %.3g (%.4f of 1e-5 x max(1, "
        "|loss|)); gradients %s (limit %g of max |g|); bf16 step on the "
        "same weights: loss %.7f, gap %.4f of 2**-8 x max(1, |loss|) "
        "(limit %g), whole-gradient L2 gap %.4f of 2**-8 (limit %g; the "
        "f32 limit %g of max |g| must break: %.4g)" % (
            card, time.perf_counter() - t0, lk, lp, abs(lk - lp),
            loss_ratio, gap_text(gaps), TOL_LSTM_GRAD, lb, bf16_loss,
            TOL_LSTM_BF16_LOSS, bf16_grad, TOL_LSTM_BF16_GRAD,
            TOL_LSTM_GRAD, bf16_grad * BF16_U))
    if not loss_ok or worst_share(gaps) > TOL_LSTM_GRAD or \
            bf16_loss > TOL_LSTM_BF16_LOSS or \
            bf16_grad > TOL_LSTM_BF16_GRAD or \
            not bf16_grad * BF16_U > TOL_LSTM_GRAD:
        raise RuntimeError("lstm (b): the check step failed (above)")
    del chk, gk, gp, gb
    # the main path: fit_batch steps, the route counted
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    f32_start = lstm_f32_loss(torch, trainer, x._data, y._data)
    for k in rnn_op.ROUTES:
        rnn_op.ROUTES[k] = 0
    step1, _ = ns_steps(torch, trainer, x, y, 1) if on_card else \
        ([trainer.fit_batch(x, y)], 0.0)
    if on_card:
        timed, dt = ns_steps(torch, trainer, x, y, LSTM_STEPS - 1)
    else:
        t0 = time.perf_counter()
        timed = [trainer.fit_batch(x, y) for _ in range(LSTM_STEPS - 1)]
        float(timed[-1])
        dt = time.perf_counter() - t0
    losses = [float(v) for v in step1 + timed]
    ms = 1e3 * dt / (LSTM_STEPS - 1)
    peak = torch.cuda.max_memory_allocated() / 1e9 if on_card else 0.0
    routes = dict(rnn_op.ROUTES)
    f32_end = lstm_f32_loss(torch, trainer, x._data, y._data)
    shares = None
    if on_card:
        undo = rnn_ranges(torch)
        try:
            shares = profile(
                torch, lambda: float(trainer.fit_batch(x, y)),
                "lstm (b) profile, one step of batch %d x %d" % (BATCH, seq),
                card, (("GEMM", lambda k: any(g in k for g in GEMM_KEYS)),),
                ranges=RNN_RANGES)
        finally:
            undo()
    frozen = {n: float(trainer._params[n].abs().sum())
              for n in trainer._frozen}
    route = rnn_op.route_of(x._data)
    log("lstm (b): vocab %d, dim %d, %d LSTM layers, batch %d x %d int32 "
        "ids, %d parameters, sgd lr %g momentum %g, bf16 compute weights "
        "and f32 masters on %s: losses %s (the f32 masters' loss %.7f "
        "before step 1, %.7f after step %d); %.3f ms a step (steps 2-%d, "
        "host clock, readback at the end), %.0f tokens/s, peak device "
        "memory %.3f GB; the RNN op's route %r (calls by route %s); frozen "
        "begin states %s, sum |value| %s" % (
            vocab, dim, layers, BATCH, seq, n_params,
            LSTM_OPT["learning_rate"], LSTM_OPT["momentum"], card,
            ", ".join("%.5f" % v for v in losses), f32_start, f32_end,
            LSTM_STEPS, ms, LSTM_STEPS,
            BATCH * seq / ms * 1e3, peak, route, routes,
            sorted(frozen), list(frozen.values())))
    if shares is not None:
        log("lstm (b) shares of device time: RNN forward %.3f, RNN backward "
            "%.3f, head GEMM forward %.3f, backward %.3f, the rest %.3f" % (
                shares["RNN forward"], shares["RNN backward"],
                shares["head forward"], shares["head backward"],
                1.0 - sum(shares[k] for k in RNN_RANGES)))
    failures = []
    if on_card and n_params != LSTM_PARAMS and cfg == LSTM_CFG:
        failures.append("%d parameters, not %d" % (n_params, LSTM_PARAMS))
    if not all(math.isfinite(v) for v in losses) or \
            not f32_end < f32_start:
        failures.append("the loss did not fall: %s, f32 %.7f -> %.7f"
                        % (losses, f32_start, f32_end))
    if any(v != 0.0 for v in frozen.values()) or len(frozen) != 2:
        failures.append("the frozen begin states are %s" % frozen)
    want_route = "cudnn" if on_card else "plain"
    if routes.get(want_route) != LSTM_STEPS or \
            sum(routes.values()) != LSTM_STEPS:
        failures.append("the op's calls by route %s (expected %d on %r)"
                        % (routes, LSTM_STEPS, want_route))
    if failures:
        raise RuntimeError("lstm (b): " + "; ".join(failures))
    del trainer, net, x, y
    route_ms = None
    if on_card:
        torch.cuda.empty_cache()
        route_ms = rnn_route_ms(torch, cfg, ctx.torch_device, gen)
        log("lstm (b): the RNN op alone at the LM's shape (T %d, batch %d, "
            "%d -> %d, %d layers), one forward and backward: cudnn route "
            "bf16 %.3f ms, f32 %.3f ms; plain route bf16 %.3f ms" % (
                seq, BATCH, dim, dim, layers, route_ms["cudnn bf16"],
                route_ms["cudnn f32"], route_ms["plain bf16"]))
    return {"params": n_params, "losses": losses, "ms": ms,
            "f32_loss": (f32_start, f32_end),
            "tokens_per_s": BATCH * seq / ms * 1e3, "peak_gb": peak,
            "routes": routes, "shares": shares, "route_ms": route_ms,
            "check": {"loss_ratio": loss_ratio, "grad": worst_share(gaps),
                      "bf16_loss": bf16_loss, "bf16_grad": bf16_grad}}


def markov_corpus(rng, vocab, n, lengths=BUCKETS):
    """*n* sentences of a sparse first-order Markov chain over ids 1 ..
    vocab - 1 (0 is padding): each id has 3 likely successors, taken with
    probability 0.9, else a uniform id — the chain of
    examples/train_lm.py's ``synthetic_corpus`` without its dense
    (vocab - 1)**2 table."""
    real = vocab - 1
    succ = rng.randint(0, real, (real, 3))
    sentences = []
    for _ in range(n):
        length = int(rng.choice(lengths))
        s = [int(rng.randint(real))]
        for _ in range(length - 1):
            s.append(int(succ[s[-1], rng.randint(3)])
                     if rng.rand() < 0.9 else int(rng.randint(real)))
        sentences.append([t + 1 for t in s])
    return sentences


def bucket_sym_gen(mx, cfg):
    """examples/train_lm.py's ``sym_gen`` over a stack of LSTMCells."""
    vocab, hidden, embed_dim, layers = cfg
    stack = mx.rnn.SequentialRNNCell()
    for i in range(layers):
        stack.add(mx.rnn.LSTMCell(num_hidden=hidden, prefix="lstm_l%d_" % i))

    def sym_gen(seq_len):
        embed = mx.sym.Embedding(data=mx.sym.var("data"), input_dim=vocab,
                                 output_dim=embed_dim, name="embed")
        outputs, _ = stack.unroll(seq_len, inputs=embed,
                                  merge_outputs=True)
        pred = mx.sym.reshape(outputs, shape=(-1, hidden))
        pred = mx.sym.FullyConnected(data=pred, num_hidden=vocab,
                                     name="pred")
        label = mx.sym.reshape(mx.sym.var("softmax_label"), shape=(-1,))
        pred = mx.sym.SoftmaxOutput(data=pred, label=label, use_ignore=True,
                                    ignore_label=0, name="softmax")
        return pred, ("data",), ("softmax_label",)
    return sym_gen


def bucket_nll(torch, probs, label):
    """(summed negative log-likelihood in float64, tokens) of a batch,
    label 0 ignored, as ``Perplexity(ignore_label=0)`` counts it."""
    p = probs._data.reshape(-1, probs.shape[-1])
    ids = label._data.to(p.device).reshape(-1).long()
    keep = ids != 0
    picked = p.gather(1, ids[:, None])[:, 0].double()
    nll = -torch.log(torch.clamp(picked, min=1e-10))
    return torch.where(keep, nll, torch.zeros_like(nll)).sum(), keep.sum()


def bucketing_phase(torch, mx, ctx, card, rng, cfg, n_train, n_val):
    """(c): one epoch of the example's loop through BucketingModule.fit
    (see the phase comment), with its checks."""
    on_card = ctx.device_type == "gpu"
    vocab = cfg[0]
    train = mx.rnn.BucketSentenceIter(
        markov_corpus(rng, vocab, n_train), BUCKET_BATCH,
        buckets=list(BUCKETS), invalid_label=0, seed=int(rng.randint(1000)))
    val = mx.rnn.BucketSentenceIter(
        markov_corpus(rng, vocab, n_val), BUCKET_BATCH,
        buckets=list(BUCKETS), invalid_label=0, shuffle=False)
    bm = mx.mod.BucketingModule(bucket_sym_gen(mx, cfg),
                                default_bucket_key=train.default_bucket_key,
                                context=ctx)
    binds = []
    new_module = bm._new_module

    def counted(key):
        binds.append(key)
        return new_module(key)
    bm._new_module = counted
    per_batch, stamps = [], []

    def record(param):
        batch = param.locals["data_batch"]
        nll, n = bucket_nll(torch, bm.get_outputs()[0], batch.label[0])
        per_batch.append((batch.bucket_key, nll, n))
        stamps.append(time.perf_counter())
    ppl = mx.metric.Perplexity(ignore_label=0)
    t0 = time.perf_counter()
    bm.fit(train, eval_metric=ppl, optimizer="adam",
           optimizer_params={"learning_rate": BUCKET_LR},
           initializer=mx.init.Xavier(), num_epoch=1,
           batch_end_callback=record)
    wall = time.perf_counter() - t0
    default = bm._buckets[bm._default_bucket_key]
    names = default._exec_group.param_names
    shared = all(
        m._exec_group.execs[0].arg_dict[n] is
        default._exec_group.execs[0].arg_dict[n] and
        m._exec_group.execs[0].arg_dict[n]._data.data_ptr() ==
        default._exec_group.execs[0].arg_dict[n]._data.data_ptr()
        for m in bm._buckets.values() for n in names)
    one_updater = all(m._updater is default._updater
                      for m in bm._buckets.values())
    ppls = [math.exp(float(nll) / max(int(n), 1))
            for _, nll, n in per_batch]
    k = min(BUCKET_WINDOW, len(ppls) // 2)
    first, last = sum(ppls[:k]) / k, sum(ppls[-k:]) / k
    by_bucket = {}
    for i in range(1, len(stamps)):
        key = per_batch[i][0]
        by_bucket.setdefault(key, []).append(stamps[i] - stamps[i - 1])
    tokens = sum(BUCKET_BATCH * key for key, _, _ in per_batch)
    span = stamps[-1] - stamps[0] if len(stamps) > 1 else wall
    tok_span = sum(BUCKET_BATCH * key for key, _, _ in per_batch[1:])
    score = dict(bm.score(val, mx.metric.Perplexity(ignore_label=0)))[
        "perplexity"]
    preds = bm.predict(val)
    val.reset()
    total, count = 0.0, 0
    row = 0
    for b in val:
        rows = BUCKET_BATCH * b.bucket_key
        nll, n = bucket_nll(torch, preds[row:row + rows], b.label[0])
        total, count, row = total + float(nll), count + int(n), row + rows
    recomputed = math.exp(total / count)
    del preds
    log("lstm (c): examples/train_lm.py's loop at vocab %d, hidden %d, "
        "embed %d, %d layers, batch %d, buckets %s through BucketingModule "
        "(adam lr %g, Xavier) on %s: one epoch of %d batches (%d tokens) "
        "in %.2f s; ms a batch by bucket %s; %.0f tokens/s (batches 2-%d); "
        "training perplexity mean of the first %d batches %.3f, of the "
        "last %d %.3f; score %.9f, from predict's outputs %.9f; buckets "
        "bound %s; shared arrays %s; one updater %s" % (
            vocab, cfg[1], cfg[2], cfg[3], BUCKET_BATCH, list(BUCKETS),
            BUCKET_LR, card, len(per_batch), tokens, wall,
            {k: round(1e3 * sum(v) / len(v), 3)
             for k, v in sorted(by_bucket.items())},
            tok_span / max(span, 1e-9), len(per_batch), k, first, k, last,
            score, recomputed, binds, shared, one_updater))
    failures = []
    if not shared:
        failures.append("a bucket's arrays are not the default bucket's")
    if not one_updater:
        failures.append("the buckets do not share one updater")
    if sorted(binds) != sorted(set(binds)) or \
            set(binds) != set(bm._buckets):
        failures.append("buckets bound %s" % binds)
    if not last < first:
        failures.append("perplexity did not fall: %.3f -> %.3f"
                        % (first, last))
    if abs(score - recomputed) > TOL_SCORE * abs(recomputed):
        failures.append("score %.9f is not the perplexity of predict's "
                        "outputs %.9f" % (score, recomputed))
    shares = None
    val.reset()
    batch = next(iter(val))
    if on_card:
        def one_batch():
            bm.forward_backward(batch)
            bm.update()
            float(bm.get_outputs()[0]._data[0, 0])
        shares = profile(torch, one_batch, "lstm (c) profile, one batch "
                         "of bucket %d" % batch.bucket_key, card, ())
    ckpt = bucket_checkpoint(torch, mx, bm, cfg, ctx, train, batch)
    log("lstm (c): save_checkpoint (with optimizer states) -> a fresh "
        "BucketingModule: its next step differs from the original's in %d "
        "of %d values held bit for bit; the Embedding-read arrays worst gap "
        "/ limit %.4f" % ckpt)
    if ckpt[0] or ckpt[2] > 1.0:
        failures.append("the loaded BucketingModule's step is not the "
                        "original's")
    if failures:
        raise RuntimeError("lstm (c): " + "; ".join(failures))
    return {"batches": len(per_batch), "first": first, "last": last,
            "ms_by_bucket": {k: 1e3 * sum(v) / len(v)
                             for k, v in by_bucket.items()},
            "tokens_per_s": tok_span / max(span, 1e-9), "score": score,
            "recomputed": recomputed, "binds": binds,
            "checkpoint": ckpt, "idle": (shares or {}).get("idle")}


def bucket_checkpoint(torch, mx, bm, cfg, ctx, train, batch):
    """save_checkpoint with optimizer states, loaded into a fresh
    BucketingModule (parameters, states and the update counts the states
    blob does not hold); the next step of both on *batch*: (values that
    differ among those held bit for bit, of how many, worst Embedding-read
    array gap / its limit)."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_bucketing_")
    try:
        prefix = os.path.join(tmp, "lm")
        bm.save_checkpoint(prefix, 1, save_optimizer_states=True)
        _, args, auxs = mx.model.load_checkpoint(prefix, 1, ctx=mx.cpu())
        fresh = mx.mod.BucketingModule(
            bucket_sym_gen(mx, cfg),
            default_bucket_key=train.default_bucket_key, context=ctx)
        fresh.bind(train.provide_data, train.provide_label)
        fresh.set_params(args, auxs)
        fresh.init_optimizer(optimizer="adam", optimizer_params={
            "learning_rate": BUCKET_LR})
        key = bm._default_bucket_key
        fresh._buckets[key].load_optimizer_states(prefix + "-0001.states")
        src, dst = bm._buckets[key]._optimizer, \
            fresh._buckets[key]._optimizer
        dst._index_update_count = dict(src._index_update_count)
        dst.num_update = src.num_update
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    got = []
    for mod in (bm, fresh):
        mod.forward_backward(batch)
        mod.update()
        got.append(module_bits(torch, mod._buckets[key]))
    scattered = scatter_arrays(bm._buckets[key]._symbol)
    differ, total, _, worst = module_compare(got[1], got[0], scattered)
    return differ, total, worst


def phase_lstm(torch, card, seed, ctx=None, lstm_cfg=None, bucket_cfg=None,
               sentences=None, op_shape=RNN_SHAPE,
               op_dtypes=("float32", "bfloat16")):
    """Phase 11: recurrent networks (see the phase comment).  *ctx*, the
    configurations, *sentences* (train, val) and *op_shape* size it down
    for the CPU test, where the op's route is the plain loop itself."""
    import numpy as np
    import mxnet_tpu_torch as mx
    if ctx is None:
        if not torch.cuda.is_available():
            raise RuntimeError("phase 11 needs CUDA")
        ctx = mx.gpu(0)
    on_card = ctx.device_type == "gpu"
    dev = ctx.torch_device
    t_phase = time.perf_counter()
    record = {"card": card}
    record["op"] = rnn_op_checks(torch, dev, on_card, seed, op_shape,
                                 op_dtypes)
    record["control_flow"] = control_flow_checks(torch, mx, ctx, card)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 11)
    rng = np.random.RandomState(seed + 11)
    t0 = time.perf_counter()
    record["lm"] = lstm_lm_phase(torch, mx, ctx, card, gen, rng,
                                 lstm_cfg or LSTM_CFG)
    record["lm"]["seconds"] = time.perf_counter() - t0
    if on_card:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    n_train, n_val = sentences or (BUCKET_SENTENCES, BUCKET_VAL)
    record["bucketing"] = bucketing_phase(torch, mx, ctx, card, rng,
                                          bucket_cfg or BUCKET_CFG, n_train,
                                          n_val)
    record["bucketing"]["seconds"] = time.perf_counter() - t0
    if on_card:
        torch.cuda.empty_cache()
    log("lstm: phase 11 took %.1f s ((b) %.1f s, (c) %.1f s); it launches "
        "none of the three kernels" % (
            time.perf_counter() - t_phase, record["lm"]["seconds"],
            record["bucketing"]["seconds"]))
    return record


# phase 12: the data path (ROADMAP queue A item 13) as
# examples/train_imagenet.py --trainer module drives it: JPEG records ->
# mx.io.ImageRecordIter -> DevicePrefetcher (fit(device_prefetch=2)) ->
# mx.mod.Module.fit on ResNet-50 v1; and the gluon flow,
# ImageRecordDataset -> transforms -> DataLoader -> the gluon loop.
DATA_EXAMPLES = 1280            # train_imagenet.py --num-examples
DATA_SIDES = (333, 500)         # each side drawn per image (ImageNet-like)
DATA_QUALITY = 90
DATA_BATCH = 128
DATA_IMAGE = 224
DATA_CLASSES = 1000
DATA_THREADS = 4                # train_imagenet.py --data-nthreads
DATA_OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4,
            "rescale_grad": 1.0 / DATA_BATCH}
DATA_PARITY_BATCHES = 3
DATA_GLUON_BATCHES = 6
DATA_CHECK_IMAGES = 16          # the records (c) decodes
DATA_RESIZE = 256               # (c)'s resize case
TOL_DECODE_MEAN = 8.0           # mean |d| on 0-255 (tests/test_io.py:572)
DATA_MEAN = (0.485, 0.456, 0.406)
DATA_STD = (0.229, 0.224, 0.225)
DATA_SHARES = (
    ("convolutions", lambda n: any(k in n for k in CONV_KEYS)),
    ("decode (nvJPEG)", lambda n: "jpeg" in n or "huffman" in n
     or "idct" in n),
)


def data_probe():
    """What can decode a JPEG here (ISSUE's probe list)."""
    import ctypes.util
    out = {"nproc": len(os.sched_getaffinity(0))}
    for mod in ("cv2", "PIL"):
        try:
            out[mod] = __import__(mod).__version__
        except ImportError:
            out[mod] = None
    out["jpeglib.h"] = os.path.exists("/usr/include/jpeglib.h")
    out["libjpeg"] = ctypes.util.find_library("jpeg")
    cuda = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    out["nvjpeg.h"] = os.path.exists(os.path.join(cuda, "include",
                                                  "nvjpeg.h"))
    return out


def data_builds(on_card):
    """(a): the libraries of the route, built at first use (phase 2 built
    them on the card): [(name, seconds, command)]."""
    from mxnet_tpu_torch.ops import _cuda
    from mxnet_tpu_torch.runtime import native
    out = []
    info = native.build("recordio_reader")
    out.append(("recordio_reader", info["seconds"], info["command"]))
    if on_card:
        info = _cuda.build("nvjpeg_decode")
        out.append(("nvjpeg_decode", info["seconds"],
                    " ".join(_cuda._command("nvjpeg_decode")[1])))
    else:
        info = native.build("jpeg_decode_pool")
        out.append(("jpeg_decode_pool", info["seconds"], info["command"]))
    return out


def data_image(np, seed, i, sides):
    """Record *i*'s image: a seeded smooth field plus mild texture, each
    side drawn from *sides* (tests/test_io.py:542-547's field)."""
    rs = np.random.RandomState(seed * 1000003 + i)
    h, w = (int(v) for v in rs.randint(sides[0], sides[1] + 1, 2))
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([(yy * 0.5 + i * 9) % 256, (xx * 0.4) % 256,
                    ((yy + xx) * 0.3) % 256], -1)
    img += rs.randint(0, 20, img.shape).astype(np.float32)
    return img.clip(0, 255).astype(np.uint8)


def data_records(np, recordio, tmp, seed, n, sides, classes):
    """(b): *n* JPEGs at quality 90 through ``MXIndexedRecordIO``, label
    i % classes.  Returns (prefix, file bytes, seconds, the first
    DATA_CHECK_IMAGES encoded buffers)."""
    t0 = time.perf_counter()

    def encode(i):
        return recordio.pack_img(recordio.IRHeader(0, float(i % classes), i,
                                                   0),
                                 data_image(np, seed, i, sides),
                                 quality=DATA_QUALITY)

    with concurrent.futures.ThreadPoolExecutor(
            len(os.sched_getaffinity(0))) as pool:
        packed = list(pool.map(encode, range(n)))
    prefix = os.path.join(tmp, "train")
    rec = recordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    for i, s in enumerate(packed):
        rec.write_idx(i, s)
    rec.close()
    bufs = [recordio.unpack(s)[1] for s in packed[:DATA_CHECK_IMAGES]]
    if not all(b[:2] == b"\xff\xd8" for b in bufs):
        raise RuntimeError("data (b): the records are not JPEGs (pack_img "
                           "writes JPEG only through PIL)")
    return prefix, os.path.getsize(prefix + ".rec"), \
        time.perf_counter() - t0, bufs


def data_full_decoder(torch, dev):
    """A full-size decode by the route's library: nvJPEG on the card, the
    libjpeg team (its whole image as the crop) on the CPU."""
    from mxnet_tpu_torch.io import native_decode
    from mxnet_tpu_torch.image.image import _jpeg_dims
    if dev.type == "cuda":
        pool = native_decode.NvjpegDecodePool(1, (8, 8), device=dev)

        def full(buf):
            hw, rcs = pool.info([buf])
            if rcs[0] != 0:
                raise RuntimeError("nvjpegGetImageInfo failed (%d)" % rcs[0])
            return pool.decode_full([buf], hw)[0]
        return full

    def full(buf):
        h, w = _jpeg_dims(buf)
        out, ok = native_decode.NativeDecodePool(1, (h, w)).decode_batch(
            [buf])
        if not ok.all():
            raise RuntimeError("libjpeg could not decode a record")
        return torch.from_numpy(out[0])
    return full


def xorshift(s):
    m = (1 << 64) - 1
    s ^= (s << 13) & m
    s ^= s >> 7
    return s ^ ((s << 17) & m)


def plain_geometry(torch, img, seed, resize, oh, ow, rand_crop, rand_mirror):
    """The plain version of the team's geometry on a full-size decode, in
    plain torch: the 1/denom scale as rounded window means, shorter-side
    bilinear resize (align_corners, rounded), upscale when too small,
    xorshift crop and mirror."""
    import torch.nn.functional as F
    h, w = img.shape[:2]
    need = resize if resize > 0 else max(oh, ow)
    denom = 1
    while denom < 8 and min(h, w) // (2 * denom) >= need:
        denom *= 2
    x = img.permute(2, 0, 1).to(torch.float32)
    if denom > 1:
        pad = (0, -w % denom, 0, -h % denom)
        s = F.avg_pool2d(F.pad(x, pad)[None], denom, divisor_override=1)[0]
        ones = F.pad(torch.ones_like(x[:1]), pad)
        cnt = F.avg_pool2d(ones[None], denom, divisor_override=1)[0]
        x = torch.floor((s + torch.floor(cnt / 2)) / cnt)

    def interp(x, dh, dw):
        y = F.interpolate(x[None], size=(dh, dw), mode="bilinear",
                          align_corners=True)[0]
        return torch.floor(y + 0.5)

    ch, cw = x.shape[1:]
    if resize > 0:
        dh, dw = (resize, cw * resize // ch) if ch <= cw else \
            (ch * resize // cw, resize)
        x = interp(x, dh, dw)
        ch, cw = dh, dw
    if ch < oh or cw < ow:
        x = interp(x, oh, ow)
        ch, cw = oh, ow
    rng = int(seed) or 0x9e3779b97f4a7c15
    cy, cx = (ch - oh) // 2, (cw - ow) // 2
    if rand_crop:
        rng = xorshift(rng)
        cy = rng % (ch - oh + 1)
        rng = xorshift(rng)
        cx = rng % (cw - ow + 1)
    x = x[:, cy:cy + oh, cx:cx + ow]
    if rand_mirror:
        rng = xorshift(rng)
        if rng & 1:
            x = x.flip(2)
    return x.permute(1, 2, 0).to(torch.uint8)


def data_decode_checks(torch, np, dev, bufs, image):
    """(c): the route's pool against the plain version on the same
    buffers and seeds: (resize 0, centre) bit-equal, (resize 256,
    centre) mean |d| < 8, (resize 0, random crop and mirror) bit-equal
    to the plain version and to a second pass.  Returns the errors."""
    from mxnet_tpu_torch.io import native_decode
    full = data_full_decoder(torch, dev)
    decoded = [full(b) for b in bufs]
    out = {}
    for name, cfg in (("resize 0, centre crop", dict(resize=0)),
                      ("resize %d, centre crop" % DATA_RESIZE,
                       dict(resize=DATA_RESIZE)),
                      ("resize 0, random crop and mirror",
                       dict(resize=0, rand_crop=True, rand_mirror=True))):
        if dev.type == "cuda":
            pool = native_decode.NvjpegDecodePool(
                DATA_THREADS, (image, image), device=dev, **cfg)
        else:
            pool = native_decode.NativeDecodePool(
                DATA_THREADS, (image, image), **cfg)
        passes = []
        for _ in range(2):
            np.random.seed(12)
            got, ok = pool.decode_batch(bufs)
            if not ok.all():
                raise RuntimeError("data (c): the route could not decode "
                                   "the records")
            passes.append(torch.as_tensor(got).to(dev))
        np.random.seed(12)
        seeds = native_decode.draw_seeds(len(bufs))
        plain = torch.stack([plain_geometry(
            torch, img, seeds[i], cfg.get("resize", 0), image, image,
            cfg.get("rand_crop", False), cfg.get("rand_mirror", False))
            for i, img in enumerate(decoded)])
        d = (passes[0].to(torch.int32) - plain.to(torch.int32)).abs()
        out[name] = {"max": int(d.max()), "mean": float(d.double().mean()),
                     "repeat_equal": bool(torch.equal(passes[0],
                                                      passes[1]))}
    return out


def data_iter(mx, ctx, prefix, image, batch, threads, seed, **kw):
    """train_imagenet.py's training ImageRecordIter on *ctx*, its shuffle
    and crops seeded."""
    import random
    import numpy as np
    random.seed(seed)
    np.random.seed(seed)
    args = dict(path_imgrec=prefix + ".rec", data_shape=(3, image, image),
                batch_size=batch, shuffle=True, rand_crop=True,
                rand_mirror=True, preprocess_threads=threads)
    args.update(kw)
    with ctx:
        return mx.io.ImageRecordIter(**args)


def data_decode_rate(torch, mx, ctx, prefix, image, batch, threads, seed):
    """(d): ImageRecordIter alone for one epoch: (images/s over batches 2
    on, over the whole epoch from construction, batches, its routes).
    The first batch carries the decoder's start-up (nvJPEG's per-worker
    buffers, the first kernels)."""
    def sync():
        if ctx.device_type == "gpu":
            torch.cuda.synchronize()
    t0 = time.perf_counter()
    it = data_iter(mx, ctx, prefix, image, batch, threads, seed)
    n = batches = 0
    for b in it:
        if batches == 0:
            sync()
            t1, n1 = time.perf_counter(), b.data[0].shape[0] - (b.pad or 0)
        n += b.data[0].shape[0] - (b.pad or 0)
        batches += 1
    sync()
    t2 = time.perf_counter()
    routes = dict(it.iters[0].routes)
    it.close()
    return (n - n1) / (t2 - t1), n / (t2 - t0), batches, routes


def data_symbol(mx, vision, ctx, gen, image, net_kw):
    """train_imagenet.py's build_symbol on the port: the zoo net with
    Xavier(gaussian, in, 2) from *gen*, traced to a Symbol with a
    SoftmaxOutput head.  Returns (symbol, arg_params, aux_params)."""
    net = vision.get_model(**net_kw)
    net.initialize(mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                  magnitude=2), ctx=ctx, generator=gen)
    net(mx.nd.zeros((2, 3, image, image), ctx=ctx))
    sym = mx.sym.SoftmaxOutput(data=net(mx.sym.var("data")), name="softmax")
    params = {p.name: p for p in net.collect_params().values()}
    args = {n: params[n].data() for n in sym.list_arguments()
            if n not in ("data", "softmax_label")}
    auxs = {n: params[n].data() for n in sym.list_auxiliary_states()}
    return sym, args, auxs


def module_bytes(torch, mod):
    """{name: bytes} of the weights, running statistics and momenta."""
    args, auxs = mod.get_params()
    out = {("arg", k): v.asnumpy().tobytes() for k, v in args.items()}
    out.update({("aux", k): v.asnumpy().tobytes() for k, v in auxs.items()})
    out[("opt", "states")] = mod._updater.get_states()
    return out


def data_fit(torch, mx, ctx, sym, weights, train, batch, depth, digests=None):
    """One epoch of train_imagenet.py's ``Module.fit`` on *train* with
    ``device_prefetch=depth``.  Returns the module and a record: host
    stamps, losses, per-batch input waits and ring occupancies, steps
    stalled, peak memory, wall seconds."""
    import hashlib
    from mxnet_tpu_torch.observability import metrics as obs
    wait_h = obs.histogram("input_wait_seconds")
    stalled_c = obs.counter("steps_input_stalled_total")
    occ_g = obs.gauge("device_prefetch_ring_occupancy")
    rec = {"stamps": [], "loss": [], "wait": [], "occupancy": []}
    wait0, stalled0 = wait_h._snap()["sum"], stalled_c.value

    def record(param):
        b = param.locals["data_batch"]
        probs = mod.get_outputs()[0]._data
        label = b.label[0]._data.to(probs.device).long()
        picked = probs.gather(1, label[:, None])[:, 0].double()
        rec["loss"].append(float(-torch.log(
            torch.clamp(picked, min=1e-30)).mean()))
        rec["stamps"].append(time.perf_counter())
        rec["wait"].append(wait_h._snap()["sum"] - wait0)
        rec["occupancy"].append(occ_g.value)
        if digests is not None:
            digests.append(hashlib.sha256(
                b.data[0].asnumpy().tobytes()).hexdigest())

    speed = mx.callback.Speedometer(batch, 5)
    mod = mx.mod.Module(sym, context=ctx)
    if ctx.device_type == "gpu":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mod.fit(train, eval_metric=["accuracy"], kvstore="local",
            optimizer="sgd", optimizer_params=dict(DATA_OPT),
            initializer=mx.init.Xavier(rnd_type="gaussian",
                                       factor_type="in", magnitude=2),
            arg_params=weights[0], aux_params=weights[1],
            allow_missing=True, num_epoch=1,
            batch_end_callback=[record, speed], device_prefetch=depth)
    if ctx.device_type == "gpu":
        torch.cuda.synchronize()
        rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    rec["wall"] = time.perf_counter() - t0
    rec["stalled"] = stalled_c.value - stalled0
    rec["speedometer"] = speed.rate
    return mod, rec


def fit_rate(rec, batch, first=2):
    """(ms a batch, images/s) over batches first+1 to the last, from the
    host stamps (each batch ends in a readback of its outputs)."""
    s = rec["stamps"]
    ms = 1e3 * (s[-1] - s[first - 1]) / (len(s) - first)
    return ms, batch / ms * 1e3


def data_main_path(torch, mx, ctx, card, sym, weights, prefix, image,
                   batch, threads, seed, nproc):
    """(e): the module flow at depth 2, at depth 0 and from memory."""
    import numpy as np
    out = {}
    for depth in (2, 0):
        it = data_iter(mx, ctx, prefix, image, batch, threads, seed)
        mod, rec = data_fit(torch, mx, ctx, sym, weights, it, batch, depth)
        routes = dict(it.iters[0].routes)
        it.close()
        del mod
        ms, ips = fit_rate(rec, batch)
        n = len(rec["stamps"])
        window = rec["stamps"][-1] - rec["stamps"][1]
        rec.update(ms=ms, images_s=ips, routes=routes, batches=n,
                   wait_share=(rec["wait"][-1] - rec["wait"][1]) / window,
                   wait_share_fit=rec["wait"][-1] / rec["wall"])
        # the producer reads ahead past the epoch's end: native >= n
        if routes["chain"] or routes["native"] < n:
            raise RuntimeError("data (e): batches took the chain: %s"
                               % routes)
        if not all(math.isfinite(v) for v in rec["loss"]):
            raise RuntimeError("data (e): the loss is not finite: %s"
                               % rec["loss"])
        out[depth] = rec
        r = rec
        ring = ("input waits %.4f s in those batches, a %.4f share of "
                "their wall (%.4f of the whole fit's %.2f s, graph capture "
                "included); steps stalled %d; ring occupancy at each pop %s"
                % (r["wait"][-1] - r["wait"][1], r["wait_share"],
                   r["wait_share_fit"], r["wall"], r["stalled"],
                   r["occupancy"])) if depth else \
            "no prefetcher: the step takes each batch from the iterator"
        log("data (e) Module.fit, device_prefetch=%d: %d batches of %d x "
            "%d^2, %.2f ms a batch and %.1f images/s over batches 3-%d "
            "(Speedometer %.1f samples/s); %s; peak device memory %s GB; "
            "loss %s; on %s, nproc %d" % (
                depth, n, batch, image, ms, ips, n,
                r["speedometer"] or 0.0, ring,
                "%.3f" % r["peak_gb"] if "peak_gb" in r else "n/a",
                ["%.4f" % v for v in r["loss"]], card, nproc))
    # the same batches from memory: one epoch decoded into host arrays
    it = data_iter(mx, ctx, prefix, image, batch, threads, seed)
    xs, ys = [], []
    for b in it:
        xs.append(b.data[0].asnumpy())
        ys.append(b.label[0].asnumpy())
    it.close()
    mem = mx.io.NDArrayIter(np.concatenate(xs), np.concatenate(ys),
                            batch_size=batch)
    del xs, ys
    mod, rec = data_fit(torch, mx, ctx, sym, weights, mem, batch, 0)
    del mod, mem
    ms, ips = fit_rate(rec, batch)
    rec.update(ms=ms, images_s=ips)
    out["memory"] = rec
    log("data (e) Module.fit from memory (NDArrayIter of the same decoded "
        "batches, host arrays: no decode, the pageable copy to the card "
        "left in the step): %.2f ms a batch, %.1f images/s over batches "
        "3-%d on %s" % (ms, ips, len(rec["stamps"]), card))
    return out


def data_parity(torch, mx, ctx, card, sym, weights, prefix, image, batch,
                threads, seed):
    """(f): three batches of fit with device_prefetch=2 and 0 (and 0 on
    the legacy step) from one set of weights and one record order, with
    deterministic cuDNN: parameters, running statistics and momenta
    bit-equal, the batches equal, the running statistics moved."""
    prev = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    runs = {}
    try:
        for name, depth, fused in (("prefetch 2", 2, "1"),
                                   ("prefetch 0", 0, "1"),
                                   ("prefetch 0, legacy step", 0, "0")):
            os.environ["MXNET_MODULE_FUSED_STEP"] = fused
            it = data_iter(mx, ctx, prefix, image, batch, threads, seed + 1)
            digests = []
            mod, _ = data_fit(torch, mx, ctx, sym, weights,
                              mx.io.ResizeIter(it, DATA_PARITY_BATCHES),
                              batch, depth, digests)
            it.close()
            runs[name] = (digests, module_bytes(torch, mod))
            del mod
    finally:
        os.environ.pop("MXNET_MODULE_FUSED_STEP", None)
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = prev
    base_d, base = runs["prefetch 0"]
    out = {}
    for name, (digests, got) in runs.items():
        differ = sorted("%s %s" % k for k in base if got[k] != base[k])
        out[name] = {"batches_equal": digests == base_d, "differ": differ}
        log("data (f) %s against prefetch 0: %d batches, batches %s, %d of "
            "%d arrays differ%s (cudnn deterministic) on %s" % (
                name, len(digests), "equal" if digests == base_d else
                "DIFFER", len(differ), len(base),
                (": " + ", ".join(differ[:6])) if differ else "", card))
    moved = sum(1 for k, v in base.items() if k[0] == "aux" and
                v != weights[1][k[1]].asnumpy().tobytes())
    out["aux_moved"] = moved
    out["aux"] = sum(1 for k in base if k[0] == "aux")
    log("data (f): %d of %d running statistics moved from their initial "
        "values in 3 steps (the fused step's write-back)" % (
            moved, out["aux"]))
    return out


def data_gluon(torch, mx, vision, ctx, card, gen, prefix, image, batch,
               workers, net_kw, batches=DATA_GLUON_BATCHES):
    """(g): ImageRecordDataset -> transforms -> DataLoader (process
    workers, pin_memory) -> autograd.record -> SoftmaxCrossEntropyLoss ->
    Trainer.step for *batches* batches; then the deterministic transforms
    through the workers against num_workers=0."""
    import numpy as np
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.gluon.data import DataLoader, SequentialSampler
    from mxnet_tpu_torch.gluon.data.vision import ImageRecordDataset
    from mxnet_tpu_torch.gluon.data.vision import transforms as T
    rec = {}
    ds = ImageRecordDataset(prefix + ".rec")
    payload = ds._record.read_idx(ds._record.keys[0])
    rec["payload"] = "JPEG" if mx.recordio.unpack(payload)[1][:2] == \
        b"\xff\xd8" else "npy"
    train = ds.transform_first(T.Compose([
        T.RandomResizedCrop(image), T.RandomFlipLeftRight(), T.ToTensor(),
        T.Normalize(DATA_MEAN, DATA_STD)]))
    loader = DataLoader(train, batch_size=batch, shuffle=True,
                        num_workers=workers, pin_memory=True,
                        last_batch="discard")
    net = vision.get_model(**net_kw)
    net.initialize(mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                  magnitude=2), ctx=ctx, generator=gen)
    net.hybridize()
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.1, "momentum": 0.9})
    waits, stamps, losses = [], [], []
    pinned = []
    batches_it = iter(loader)
    t_start = time.perf_counter()
    try:
        for _ in range(batches):
            t0 = time.perf_counter()
            x, y = next(batches_it)
            waits.append(time.perf_counter() - t0)
            pinned.append(x._data.is_pinned())
            x, y = x.as_in_context(ctx), y.as_in_context(ctx)
            with autograd.record():
                loss = loss_fn(net(x), y)
            loss.backward()
            trainer.step(batch)
            losses.append(float(loss.asnumpy().mean()))
            stamps.append(time.perf_counter())
    finally:
        batches_it.close()
    window = stamps[-1] - stamps[0]
    rec.update(images_s=batch * (len(stamps) - 1) / window,
               wait_share=sum(waits[1:]) / window,
               first_batch_s=stamps[0] - t_start, losses=losses,
               pinned=all(pinned) if ctx.device_type == "gpu" else None)
    if not all(math.isfinite(v) for v in losses):
        raise RuntimeError("data (g): the loss is not finite: %s" % losses)
    # the workers' batches of deterministic transforms against the serial
    # loader's, on the host
    det = ds.transform_first(T.Compose([
        T.Resize(image), T.ToTensor(), T.Normalize(DATA_MEAN, DATA_STD)]))
    n = min(2 * batch, len(ds))

    def load(k):
        dl = DataLoader(det, batch_size=batch, num_workers=k,
                        sampler=SequentialSampler(n), last_batch="discard")
        with mx.cpu():
            return [(x.asnumpy(), y.asnumpy()) for x, y in dl]

    a, b = load(workers), load(0)
    rec["workers_equal"] = len(a) == len(b) > 0 and all(
        np.array_equal(x, u) and np.array_equal(y, v)
        for (x, y), (u, v) in zip(a, b))
    log("data (g) gluon flow (%s records, %d process workers, pin_memory, "
        "RandomResizedCrop + flip + ToTensor + Normalize): %.1f images/s "
        "over batches 2-%d, a %.4f share of their wall waiting on the "
        "loader (first batch after %.2f s: worker start-up), batches "
        "pinned %s, loss %s; Resize(%d) + ToTensor + Normalize through the "
        "workers %s num_workers=0's (%d batches) on %s" % (
            rec["payload"], workers, rec["images_s"], batches,
            rec["wait_share"], rec["first_batch_s"], rec["pinned"],
            ["%.4f" % v for v in losses], image,
            "bit-equal to" if rec["workers_equal"] else "DIFFER from",
            len(b), card))
    return rec


def phase_data(torch, card, seed, ctx=None, n=DATA_EXAMPLES,
               sides=DATA_SIDES, image=DATA_IMAGE, batch=DATA_BATCH,
               classes=DATA_CLASSES, net_kw=None, workers=None):
    """Phase 12: the data path (see the module docstring).  *ctx*, *n*,
    *sides*, *image*, *batch*, *classes*, *net_kw* and *workers* size it
    down for the CPU test, where the route is the libjpeg team."""
    import numpy as np
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import recordio
    from mxnet_tpu_torch.gluon.model_zoo import vision
    if ctx is None:
        if not torch.cuda.is_available():
            raise RuntimeError("phase 12 needs CUDA")
        ctx = mx.gpu(0)
    on_card = ctx.device_type == "gpu"
    dev = ctx.torch_device
    net_kw = net_kw or {"name": RESNET, "classes": classes}
    t_phase = time.perf_counter()
    probe = data_probe()
    nproc = probe["nproc"]
    route = "nvjpeg" if on_card else "libjpeg"
    log("data (a) probe: %s; route: %s (%s)" % (
        ", ".join("%s %s" % kv for kv in probe.items()), route,
        "nvJPEG decodes onto the card, the team's geometry runs there as "
        "torch ops" if on_card else "the libjpeg worker team on the host"))
    for name, secs, cmd in data_builds(on_card):
        log("data (a) build %s: %s (%s)" % (
            name, cmd, "%.2f s" % secs if secs else "built before"))
    failures = []
    tmp = tempfile.mkdtemp(prefix="chip_smoke_data_")
    try:
        prefix, nbytes, secs, bufs = data_records(
            np, recordio, tmp, seed, n, sides, classes)
        log("data (b) records: %d JPEGs (quality %d, sides %d-%d, label i "
            "%% %d) through MXIndexedRecordIO: %.1f MB in %.2f s" % (
                n, DATA_QUALITY, sides[0], sides[1], classes, nbytes / 1e6,
                secs))
        checks = data_decode_checks(torch, np, dev, bufs, image)
        for name, c in checks.items():
            log("data (c) %s, %d records, %s against the plain version "
                "(full-size decode by the same library, geometry in plain "
                "torch): max |d| %d, mean |d| %.4f; two passes %s" % (
                    name, len(bufs), route, c["max"], c["mean"],
                    "bit-equal" if c["repeat_equal"] else "DIFFER"))
            limit_ok = c["mean"] < TOL_DECODE_MEAN if "resize %d" % \
                DATA_RESIZE in name else c["max"] == 0
            if not (limit_ok and c["repeat_equal"]):
                failures.append("(c) %s: %s" % (name, c))
        rates = {}
        order = [DATA_THREADS, nproc, nproc, DATA_THREADS]   # in turns
        for threads in order:
            ips, whole, nb, routes = data_decode_rate(
                torch, mx, ctx, prefix, image, batch, threads, seed)
            rates.setdefault(threads, []).append(ips)
            log("data (d) ImageRecordIter alone, preprocess_threads %d: "
                "%.1f images/s over batches 2-%d (%.1f over the epoch from "
                "construction; batches of %d x %d^2, routes %s) on %s, "
                "nproc %d" % (threads, ips, nb, whole, batch, image, routes,
                              card, nproc))
            if routes["chain"] or routes["native"] != nb:
                failures.append("(d) batches took the chain: %s" % routes)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed + 12)
        sym, args, auxs = data_symbol(mx, vision, ctx, gen, image, net_kw)
        main = data_main_path(torch, mx, ctx, card, sym, (args, auxs),
                              prefix, image, batch, DATA_THREADS, seed,
                              nproc)
        parity = data_parity(torch, mx, ctx, card, sym, (args, auxs), prefix,
                             image, batch, DATA_THREADS, seed)
        for name, p in parity.items():
            if isinstance(p, dict) and (p["differ"] or
                                        not p["batches_equal"]):
                failures.append("(f) %s: %s" % (name, p))
        if parity["aux_moved"] != parity["aux"]:
            failures.append("(f) running statistics did not move: %d of %d"
                            % (parity["aux_moved"], parity["aux"]))
        del sym, args, auxs
        if on_card:
            torch.cuda.empty_cache()
        gluon = data_gluon(torch, mx, vision, ctx, card, gen, prefix, image,
                           batch, workers or min(8, nproc), net_kw)
        if not gluon["workers_equal"]:
            failures.append("(g) the workers' batches differ from "
                            "num_workers=0's")
        if on_card and not gluon["pinned"]:
            failures.append("(g) the loader's batches were not pinned")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if on_card:
        torch.cuda.empty_cache()
    log("data: phase 12 took %.1f s; it launches none of the three kernels"
        % (time.perf_counter() - t_phase))
    if failures:
        raise RuntimeError("data: %s" % "; ".join(failures))
    return {"probe": probe, "route": route, "checks": checks,
            "rates": rates, "main": main, "parity": parity, "gluon": gluon}


# phase 13: post-training int8 serving and serving autotuning, as the
# tentpole path drives them: quantize.calibrate -> quantize.quantize_model
# -> ModelRegistry.load(quantize=..., calib_batches=...) with the load
# gate at every rung -> registry.batcher; then autotune.tune over a
# recorded trace -> a TuningStore entry keyed on the card -> a fresh load
# picking it up through MXNET_TUNING_STORE.  Answers are held against the
# port's CPU run of the same quantized symbol and weights in two ways.
# (1) Node by node: every int8 product (quantized conv and fc), quantize,
# requantize and dequantize of the graph, run on the card on the CPU run's
# own inputs: int32 accumulators bit for bit, int8 codes within 1 and
# equal on Q_CODES of the elements, dequantized values within Q_DEQUANT of
# max |CPU value| (the CPU parity rules the tests hold against the JAX
# package).  (2) End to end: the answers within cpu_limit of max |CPU
# output|, per model and mode, and argmax agreement at least argmax where
# it is set.  The 2/127 rule of the CPU tests cannot hold between two
# summation orders: a float32 op's rounding moves a value across a .5 code
# boundary and the flipped codes grow through the layers, so on one card
# the int8 LM with the plain attention in flash_fwd's place moves as far.
# Each limit is set above its readings on the card (PERF.md, the int8
# findings) and must lie below the quantized answers' distance from the
# fp32 twin's on the same request, or a quantization fault could hide
# under it: the phase checks both, and for the LM that the plain attention
# moves the int8 answers less than the limit.  The compute bytes (each
# conv/fc's operands read once and result written once, counted by the
# ops at capture) are held per rung to the ratio the fp32 graph's shapes
# give (int8 operands, int32 results, the padded input of a padded conv on
# the card), within Q_BYTE_MARGIN; the 2x bar is reported beside them.
Q_TOL = 2.0 / 127
Q_PRODUCTS = ("_contrib_quantized_conv",
              "_contrib_quantized_fully_connected")
Q_NODES = Q_PRODUCTS + ("_contrib_quantize", "_contrib_requantize",
                        "_contrib_dequantize")
Q_CODES = 0.999
Q_DEQUANT = 1e-6
Q_BYTE_RATIO = 2.0
Q_BYTE_MARGIN = 1e-3
Q_REPLAYS = 10
Q_RESNET = dict(model=RESNET, classes=RESNET_CLASSES, image=RESNET_IMAGE,
                rungs=RESNET_RUNGS, calib=(8, 32), check_rows=(1, 8),
                traffic=(4, 20, 32, 5.0), layers=54,
                cpu_limit={"int8": 0.025, "int8-weight-only": 1e-3},
                argmax={"int8": 0.99, "int8-weight-only": 0.99})
Q_LM = dict(cfg=(VOCAB, DIM, HEADS, LAYERS, SEQ), rungs=RUNGS,
            seq_axes=SERVE_SEQ_AXES, calib=(4, 2), check_seq=512,
            traffic=(2, 6, 2, 5.0),
            cpu_limit={"int8": 0.05, "int8-weight-only": 1e-3},
            argmax={"int8": None, "int8-weight-only": 0.99})
# traffic: (client threads, requests, most rows a request, the batcher's
# coalescing window in ms).  cpu_limit and argmax: see above; the int8
# LM's argmax is not held, since the plain attention alone moves it below
# 0.99.  The tuning trace: 500 requests of 1-4 images at 250 a second, so
# that a trial's p99 is the 5th slowest request and not the slowest;
# three ladders topping at 32
Q_TUNE = dict(rate=250.0, seconds=2.0, rows=(1, 4), max_rows=32,
              ladders=((1, 2, 4, 8, 16, 32), (1, 4, 16, 32), (1, 8, 32)),
              trials=4, neighbor_trials=2)


def cpu_outputs(torch, pred, x):
    """*pred*'s symbol and weights run eagerly on the CPU for *x* (float32
    numpy): (the outputs as numpy, [(op name, fn, its inputs, params, its
    first output)] of every node of Q_NODES on the way)."""
    from mxnet_tpu_torch.executor import _build_eval
    from mxnet_tpu_torch.ops.registry import get_op
    nodes = []

    def recorded(op, fn):
        def run(*ins, **params):
            out = fn(*ins, **params)
            nodes.append((op, fn, ins, params,
                          out[0] if isinstance(out, (tuple, list)) else out))
            return out
        return run
    ev = _build_eval(pred._symbol, False, op_impls={
        n: recorded(n, get_op(n).fn) for n in Q_NODES})
    amap = {n: t.cpu() for n, t in pred._params.items()}
    amap[next(iter(pred._data_shapes))] = torch.from_numpy(x)
    with torch.no_grad():
        outs, _ = ev(amap, {n: t.cpu() for n, t in pred._aux.items()})
    return [o.numpy() for o in outs], nodes


def nodes_on_device(torch, nodes, dev):
    """Each recorded node run on *dev* on the CPU run's own inputs against
    its CPU output: {"products": [bit-equal, total], "codes": [held, total,
    elements that differ, elements], "dequantized": [held, total, worst
    difference over max |CPU value|]}."""
    held = {"products": [0, 0], "codes": [0, 0, 0, 0],
            "dequantized": [0, 0, 0.0]}
    for op, fn, ins, params, want in nodes:
        got = fn(*[t.to(dev) for t in ins], **params)
        got = (got[0] if isinstance(got, (tuple, list)) else got).cpu()
        if op in Q_PRODUCTS:
            row = held["products"]
            row[0] += bool(torch.equal(got, want))
        elif op == "_contrib_dequantize":
            row = held["dequantized"]
            scale = float(want.abs().max()) or 1.0
            err = float((got - want).abs().max()) / scale
            row[0] += err <= Q_DEQUANT
            row[2] = max(row[2], err)
        else:
            row = held["codes"]
            diff = (got.to(torch.int32) - want.to(torch.int32)).abs()
            differ = int((diff != 0).sum())
            row[0] += bool(int(diff.max()) <= 1 and
                           differ <= (1 - Q_CODES) * diff.numel())
            row[2] += differ
            row[3] += diff.numel()
        row[1] += 1
    return held


def summation_order_spread(torch, np, pred, x, want):
    """Max |out - want| / max |want| of the quantized graph on its own
    device, run eagerly with the plain attention in flash_fwd's place
    (another float32 summation order, nothing else), *want* the answer
    with flash_fwd."""
    from mxnet_tpu_torch.executor import _build_eval
    from mxnet_tpu_torch.ops import attention as att
    ev = _build_eval(pred._symbol, False, op_impls={
        "_contrib_DotProductAttention": attention_op(torch, att, chunk=512)})
    amap = dict(pred._params)
    amap[next(iter(pred._data_shapes))] = torch.from_numpy(x).to(pred._dev)
    with torch.no_grad():
        out = ev(amap, pred._aux)[0][0].cpu().numpy()
    return quant_hold(np, out, want)[0]


def quant_hold(np, got, want):
    """(max |got - want| / max |want|, its share of Q_TOL, argmax agreement
    over the last axis)."""
    scale = float(np.abs(want).max()) or 1.0
    rel = float(np.abs(got - want).max()) / scale
    agree = float((got.argmax(-1) == want.argmax(-1)).mean())
    return rel, rel / Q_TOL, agree


def shape_byte_ratio(fp32, rung, on_card):
    """fp32 compute bytes over int8's for one run of *fp32*'s graph at
    *rung*, from the shapes alone: every Convolution and FullyConnected
    reads its data and weight and writes its result once, in float32;
    quantized, data and weight are int8 (a padded convolution's data
    padded first on the card) and the result int32."""
    import ast
    g = json.loads(fp32._symbol.tojson())
    internals = fp32._symbol.get_internals()
    args, outs, aux = internals.infer_shape(**fp32.rung_shapes(rung))
    shapes = dict(zip(internals.list_outputs(), outs))
    shapes.update(zip(internals.list_arguments(), args))
    shapes.update(zip(internals.list_auxiliary_states(), aux))

    def shape(entry):
        node = g["nodes"][entry[0]]
        if node["op"] == "null":
            return shapes[node["name"]]
        key = node["name"] + "_output"
        return shapes[key if key in shapes else "%s%d" % (key, entry[1])]

    def numel(s):
        return int(math.prod(s))
    f32 = i8 = 0
    for i, node in enumerate(g["nodes"]):
        if node["op"] not in ("Convolution", "FullyConnected"):
            continue
        d, w = shape(node["inputs"][0]), shape(node["inputs"][1])
        o = shape([i, 0])
        f32 += 4 * (numel(d) + numel(w) + numel(o))
        pad = ast.literal_eval(node.get("attrs", {}).get("pad", "()"))
        if on_card and any(pad):
            d = tuple(d[:2]) + tuple(n + 2 * p for n, p in zip(d[2:], pad))
        i8 += numel(d) + numel(w) + 4 * numel(o)
    return f32 / i8


def replay_ms(torch, pred, rung, on_card, iters=Q_REPLAYS):
    """ms of one run of *pred*'s program at *rung*: on the card a graph
    replay on the predictor's stream, timed with CUDA events; on the CPU
    the eager program, by the host clock."""
    shapes = pred.rung_shapes(rung)
    prog = pred.ensure_program(shapes)
    if not on_card:
        zeros = {n: torch.zeros(s) for n, s in shapes.items()}
        t0 = time.perf_counter()
        for _ in range(iters):
            prog(zeros)
        return (time.perf_counter() - t0) * 1e3 / iters
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with torch.cuda.stream(pred._stream):
        prog._graph.replay()
        start.record()
        for _ in range(iters):
            prog._graph.replay()
        end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def quant_rungs(torch, pred, fp32, on_card, what, failures, launches=None):
    """Per rung of a quantized predictor beside its fp32 twin: the int8
    work its program counted, compute bytes and their ratio, replay ms
    of both, the gate's error.  Returns {rung: row}."""
    from mxnet_tpu_torch.quantize import int8_work
    mode = pred.quantization["mode"]
    rows = {}
    for b in pred.ladder.batches:
        w, f = int8_work(pred, b), int8_work(fp32, b)
        ratio = f["compute_bytes"] / max(1, w["compute_bytes"])
        want = shape_byte_ratio(fp32, b, on_card) if mode == "int8" else 1.0
        gate = pred.quantization["gate"]["rungs"][b]
        row = {"work": w, "fp32_bytes": f["compute_bytes"],
               "byte_ratio": ratio, "shape_byte_ratio": want,
               "rel_err": gate["rel_err"],
               "int8_ms": replay_ms(torch, pred, b, on_card),
               "fp32_ms": replay_ms(torch, fp32, b, on_card)}
        if launches is not None:
            row["flash_fwd_captured"] = launches(b)
        rows[b] = row
        proof = w["int8_products"] if mode == "int8" else \
            w["int8_dequantized"]
        if not proof:
            failures.append("%s rung %d: no int8 %s counted" % (
                what, b, "products" if mode == "int8" else "tensors"))
        if mode == "int8" and w["float_products"]:
            failures.append("%s rung %d: %d float products where int8 was "
                            "lowered" % (what, b, w["float_products"]))
        if ratio < want * (1 - Q_BYTE_MARGIN):
            failures.append("%s rung %d: compute bytes %.4fx fewer than "
                            "fp32's, below the %.4fx the shapes give" % (
                                what, b, ratio, want))
        log("quant %s rung %d: int8 products %d, int8 tensors %d, int8 "
            "dequantized %d, float products %d; compute bytes %d (fp32 "
            "%d), %.3fx fewer (the shapes give %.3fx; %s the %gx bar); %s "
            "%.3f ms, fp32 %.3f ms (%s); gate rel err %.6f%s" % (
                what, b, w["int8_products"], w["int8_tensors"],
                w["int8_dequantized"], w["float_products"],
                w["compute_bytes"], f["compute_bytes"], ratio, want,
                "meets" if ratio >= Q_BYTE_RATIO else "below", Q_BYTE_RATIO,
                "replay" if on_card else "eager run", row["int8_ms"],
                row["fp32_ms"], "CUDA events" if on_card else "host clock",
                gate["rel_err"],
                "" if launches is None else
                "; flash_fwd captured %s" % row["flash_fwd_captured"]))
    return rows


def quant_traffic(reg, name, xs, threads, wait_ms, failures, what):
    """Closed-loop traffic through ``reg.submit`` (the registry's
    DynamicBatcher, its window *wait_ms*): every request answered with
    its rows, coalesced, and no program built.  Returns the stats."""
    pred = reg.get(name)
    reg.batcher(name, max_wait_ms=wait_ms)
    builds = pred.compile_count
    batches, restore = record_batches(pred)
    answers = Answers(len(xs))
    try:
        wall = closed_loop(reg, name, xs, threads, answers)
        recs = answers.wait()
    finally:
        restore()
    missing = [i for i, r in enumerate(recs) if r is None or
               r["rows"] != xs[i].shape[0]]
    lat = sorted(r["latency"] for r in recs if r is not None)
    stats = {"requests": len(xs), "batches": len(batches),
             "rows": int(sum(x.shape[0] for x in xs)), "wall_s": wall,
             "p50_ms": percentile(lat, 50) * 1e3 if lat else None,
             "builds": pred.compile_count - builds}
    if missing or stats["builds"] or len(batches) >= len(xs):
        failures.append("%s traffic: unanswered %s, %d builds, %d batches "
                        "for %d requests" % (what, missing, stats["builds"],
                                             len(batches), len(xs)))
    log("quant %s traffic: %d requests (%d rows) from %d clients in %d "
        "batches, %.3f s, p50 %.3f ms, builds under traffic %d" % (
            what, len(xs), stats["rows"], threads, len(batches), wall,
            stats["p50_ms"] or 0.0, stats["builds"]))
    return stats


def quant_cpu_checks(torch, np, pred, fp32, inputs, spec, failures, what,
                     spread=False):
    """Each input's answer from *pred* against the port's CPU run of the
    same quantized symbol and weights, node by node and end to end, and
    against *fp32*'s answer; with *spread*, also against the same graph
    with the plain attention (see Q_NODES' comment)."""
    mode = pred.quantization["mode"]
    limit, floor = spec["cpu_limit"][mode], spec["argmax"][mode]
    out = []
    for x in inputs:
        got = pred.predict(x)[0].asnumpy()
        outs, nodes = cpu_outputs(torch, pred, x)
        rel, share, agree = quant_hold(np, got, outs[0])
        held = nodes_on_device(torch, nodes, pred._dev)
        del nodes
        quant_err = quant_hold(np, got, fp32.predict(x)[0].asnumpy())[0]
        order = summation_order_spread(torch, np, pred, x, got) \
            if spread else None
        products, codes, deq = (held[k] for k in ("products", "codes",
                                                  "dequantized"))
        problems = []
        if products[0] != products[1]:
            problems.append("int8 products bit-equal %d of %d" % tuple(
                products))
        if codes[0] != codes[1]:
            problems.append("quantize codes within 1 and equal on %g in %d "
                            "of %d nodes" % (Q_CODES, codes[0], codes[1]))
        if deq[0] != deq[1]:
            problems.append("dequantized values within %g in %d of %d "
                            "nodes" % (Q_DEQUANT, deq[0], deq[1]))
        if rel > limit:
            problems.append("answers %.6f of max|out| apart, limit %g" % (
                rel, limit))
        if floor is not None and agree < floor:
            problems.append("argmax agreement %.4f, below %g" % (agree,
                                                                 floor))
        if not limit < quant_err:
            problems.append("the limit %g is not below the int8 answers' "
                            "distance %.6f from fp32's" % (limit, quant_err))
        if order is not None and not order < limit:
            problems.append("the plain attention moves the answers %.6f, "
                            "not less than the limit %g" % (order, limit))
        out.append({"shape": list(x.shape), "rel": rel, "share": share,
                    "argmax": agree, "limit": limit, "fp32_rel": quant_err,
                    "plain_attention_rel": order, "nodes": held,
                    "products_equal": products[0], "products": products[1]})
        if problems:
            failures.append("%s: %s against the CPU run: %s" % (
                what, x.shape, "; ".join(problems)))
        log("quant %s: request %s against the port's CPU run of the same "
            "quantized graph, on its inputs: int8 products bit-equal %d of "
            "%d, quantize nodes held %d of %d (%d of %d codes differ), "
            "dequantize nodes held %d of %d (worst %.3g); answers max err "
            "%.6f of max|out| (limit %g; %.4f of 2/127), argmax agreement "
            "%.4f; int8 against fp32 %.6f%s -> %s" % (
                what, x.shape, products[0], products[1], codes[0], codes[1],
                codes[2], codes[3], deq[0], deq[1], deq[2], rel, limit,
                share, agree, quant_err,
                "" if order is None else "; the plain attention in "
                "flash_fwd's place moves it %.6f" % order,
                "FAIL" if problems else "ok"))
    return out


def quant_resnet(torch, np, mx, ctx, gen, rng, spec, tmp, failures):
    """Phase 13 (a): ResNet-50 v1 quantized int8 and int8-weight-only."""
    from mxnet_tpu_torch.gluon.model_zoo import vision
    on_card = ctx.device_type == "gpu"
    image, rungs = spec["image"], spec["rungs"]
    net = vision.get_model(spec["model"], classes=spec["classes"],
                           prefix="qnet_")
    net.initialize(mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                  magnitude=2), ctx=ctx, generator=gen)
    net.hybridize()
    net(mx.nd.array(rng.randn(1, 3, image, image).astype("float32"),
                    ctx=ctx))
    prefix = os.path.join(tmp, "qresnet")
    net.export(prefix, 0)
    del net
    sym, args, aux = mx.model.load_checkpoint(prefix, 0, ctx=ctx)
    n, rows = spec["calib"]
    calib = [rng.randn(rows, 3, image, image).astype("float32")
             for _ in range(n)]
    shape = {"data0": (1, 3, image, image)}
    ladder = mx.serve.BucketLadder(batches=rungs)
    reg = mx.serve.ModelRegistry()
    rec = {}
    try:
        t0 = time.perf_counter()
        fp32 = reg.load("resnet-fp32", sym, args, aux_params=aux,
                        data_shapes=shape, ladder=ladder, ctx=ctx)
        rec["fp32_load_s"] = time.perf_counter() - t0
        for mode in spec.get("modes", ("int8", "int8-weight-only")):
            t0 = time.perf_counter()
            name = "resnet-" + mode
            pred = reg.load(name, sym, args, aux_params=aux,
                            data_shapes=shape, ladder=ladder, ctx=ctx,
                            quantize=mode,
                            calib_batches=calib if mode == "int8" else None)
            load_s = time.perf_counter() - t0
            q = reg.health(name)["quantization"]
            log("quant resnet %s: registry.load (calibrate on %d batches "
                "of %d images, lower, warm rungs %s, gate) in %.2f s: %d of "
                "%d layers covered, gate max rel err %.6f (policy limit "
                "%g), calib sha %s" % (
                    mode, n, rows, rungs, load_s, q["covered"], q["total"],
                    q["gate"]["max_rel_err"],
                    pred.quantization["policy"]["max_rel_err"],
                    (q["calib_sha"] or "none")[:12]))
            if q["covered"] != spec["layers"] or \
                    q["total"] != spec["layers"]:
                failures.append("resnet %s: %d of %d layers covered, not "
                                "%d" % (mode, q["covered"], q["total"],
                                        spec["layers"]))
            per_rung = quant_rungs(torch, pred, fp32, on_card,
                                   "resnet " + mode, failures)
            checks = quant_cpu_checks(
                torch, np, pred, fp32, [rng.randn(r, 3, image, image)
                                     .astype("float32")
                                     for r in spec["check_rows"]], spec,
                failures, "resnet " + mode)
            threads, count, most, wait = spec["traffic"]
            xs = [rng.randn(int(rng.randint(1, most + 1)), 3, image, image)
                  .astype("float32") for _ in range(count)]
            traffic = quant_traffic(reg, name, xs, threads, wait, failures,
                                    "resnet " + mode)
            rec[mode] = {"load_s": load_s, "covered": q["covered"],
                         "gate_max_rel_err": q["gate"]["max_rel_err"],
                         "rungs": per_rung, "cpu": checks,
                         "traffic": traffic}
            reg.unload(name, drain=False)
            del pred
    finally:
        reg.close()
    return rec, sym, args, aux


def quant_lm(torch, np, mx, ctx, gen, rng, spec, tmp, failures):
    """Phase 13 (b): the transformer LM quantized int8 (then
    int8-weight-only) with its attention on flash_fwd; the main path's
    flash_fwd launches counted."""
    from mxnet_tpu_torch.gluon.model_zoo.transformer import \
        get_transformer_lm
    from mxnet_tpu_torch.ops import attention as att
    on_card = ctx.device_type == "gpu"
    vocab, dim, heads, layers, seq = spec["cfg"]
    net = get_transformer_lm(vocab=vocab, dim=dim, heads=heads,
                             layers=layers, max_seq=seq, prefix="qlm_")
    net.initialize(ctx=ctx, generator=gen)
    net.hybridize()
    net(mx.nd.array(rng.randint(0, vocab, (1, seq)).astype("float32"),
                    ctx=ctx))
    prefix = os.path.join(tmp, "qlm")
    net.export(prefix, 0)
    del net
    n, rows = spec["calib"]
    calib = [{"data0": rng.randint(0, vocab, (rows, seq)).astype("float32")}
             for _ in range(n)]
    ladder = mx.serve.BucketLadder(batches=spec["rungs"],
                                   seq_axes=spec["seq_axes"],
                                   seq_max={1: seq})
    shape = {"data0": (1, seq)}
    reg = mx.serve.ModelRegistry()
    rec = {"verdicts": {}}
    try:
        fp32 = reg.load_checkpoint("lm-fp32", prefix, 0, data_shapes=shape,
                                   ladder=ladder, ctx=ctx)
        for mode in ("int8", "int8-weight-only"):
            name = "lm-" + mode
            # the main path: counts set to 0 just before, read just after
            att.flash_fwd.launches = att.flash_fwd.captured = 0
            t0 = time.perf_counter()
            # the default policy's gate must accept the model: a
            # QuantizationError fails the phase here
            pred = reg.load_checkpoint(
                name, prefix, 0, data_shapes=shape, ladder=ladder, ctx=ctx,
                quantize=mode,
                calib_batches=calib if mode == "int8" else None)
            rec["verdicts"][mode] = "pass"
            load_s = time.perf_counter() - t0
            q = reg.health(name)["quantization"]
            log("quant lm %s: registry.load_checkpoint (calibrate on %d "
                "batches of %d x %d tokens, lower, warm rungs %s, gate) in "
                "%.2f s: %d of %d layers covered, gate max rel err %.6f "
                "(policy limit %g)" % (
                    mode, n, rows, seq, spec["rungs"], load_s, q["covered"],
                    q["total"], q["gate"]["max_rel_err"],
                    pred.quantization["policy"]["max_rel_err"]))
            per_rung = quant_rungs(
                torch, pred, fp32, on_card, "lm " + mode, failures,
                launches=lambda b, p=pred: p.captured_launches(
                    p.rung_shapes(b)).get("flash_fwd", 0))
            if on_card:
                for b, row in per_rung.items():
                    if row["flash_fwd_captured"] != layers:
                        failures.append(
                            "lm %s rung %d: flash_fwd captured %d times, "
                            "not once a layer (%d)" % (
                                mode, b, row["flash_fwd_captured"], layers))
            threads, count, most, wait = spec["traffic"]
            xs = [rng.randint(0, vocab, (int(rng.randint(1, most + 1)),
                                         seq)).astype("float32")
                  for _ in range(count)]
            traffic = quant_traffic(reg, name, xs, threads, wait, failures,
                                    "lm " + mode)
            launches = {"eager": att.flash_fwd.launches,
                        "graph": pred.graph_launches().get("flash_fwd", 0)}
            checks = quant_cpu_checks(
                torch, np, pred, fp32,
                [rng.randint(0, vocab, (1, spec["check_seq"]))
                 .astype("float32")], spec, failures, "lm " + mode,
                spread=mode == "int8")
            log("quant lm %s: flash_fwd on the path: wrapper launches %d "
                "(calibration and warm-up forwards), graph launches %d "
                "(replays x captured)" % (mode, launches["eager"],
                                          launches["graph"]))
            if on_card and not launches["eager"] + launches["graph"]:
                failures.append("lm %s: flash_fwd never launched" % mode)
            rec[mode] = {"load_s": load_s, "covered": q["covered"],
                         "total": q["total"],
                         "gate_max_rel_err": q["gate"]["max_rel_err"],
                         "rungs": per_rung, "cpu": checks,
                         "traffic": traffic, "launches": launches}
            reg.unload(name, drain=False)
            del pred
            if on_card:
                torch.cuda.empty_cache()
    finally:
        reg.close()
    return rec


def quant_tune(torch, np, mx, ctx, card, spec, model, failures):
    """Phase 13 (c): tune the ResNet's serving over a recorded trace, then
    pick the entry up in a fresh load."""
    from mxnet_tpu_torch.autotune import (TuningStore, Trace, serve_space,
                                          synth_serve_trace, tune)
    from mxnet_tpu_torch.autotune.measure import ServeMeasurer
    from mxnet_tpu_torch.autotune.search import serve_objective
    from mxnet_tpu_torch.autotune.store import device_kind
    sym, args, aux, shape = model
    dim = int(np.prod(shape[1:]))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tune_")
    saved = os.environ.pop("MXNET_TUNING_STORE", None)
    env_wait = os.environ.pop("MXNET_SERVE_MAX_WAIT_MS", None)
    rec = {}
    try:
        lo, hi = spec["rows"]
        trace = synth_serve_trace(rate=spec["rate"],
                                  seconds=spec["seconds"], dim=dim,
                                  rows_lo=lo, rows_hi=hi, seed=13)
        tpath = trace.save(os.path.join(tmp, "trace.json"))
        trace = Trace.load(tpath)
        store = TuningStore.load(os.path.join(tmp, "store.json"),
                                 missing_ok=True)
        measurer = ServeMeasurer(trace, symbol=sym, arg_params=args,
                                 aux_params=aux,
                                 data_shapes={"data0": shape},
                                 name="resnet-tuned", ctx=ctx)
        t0 = time.perf_counter()
        try:
            res = tune(serve_space(max_rows=spec["max_rows"],
                                   ladders=list(spec["ladders"])),
                       measurer, serve_objective(), model="resnet-tuned",
                       workload="serve", trials=spec["trials"],
                       neighbor_trials=spec["neighbor_trials"], seed=0,
                       store=store, device=device_kind(ctx.torch_device))
            tune_s = time.perf_counter() - t0
            # a second reading of the winner's and the default's p99 on the
            # same trace: how far the p99 moves between two replays
            again = {k: measurer.measure(res[k])["p99_ms"]
                     for k in ("config", "baseline_config")}
        finally:
            measurer.close()
        entry = TuningStore.load(store.path).get(
            "resnet-tuned", "serve", device=device_kind(ctx.torch_device))
        want_kind = torch.cuda.get_device_name(0) if \
            ctx.device_type == "gpu" else "cpu"
        log("quant tune: trace of %d requests (%d-%d images, %.0f/s, sha "
            "%s), %d trials (%d pruned) in %.2f s; winner %s score %s ms "
            "p99 (the default %s ms, gain %s%%), stored for %r; measured "
            "again: winner %s ms, the default %s ms" % (
                len(trace.events), lo, hi, spec["rate"],
                trace.sha256()[:12], res["trials"], res["pruned"], tune_s,
                json.dumps(res["config"], sort_keys=True, default=list),
                res["score"], res["baseline_score"], res["gain_pct"],
                entry and entry["device_kind"], again["config"],
                again["baseline_config"]))
        if entry is None or entry["device_kind"] != want_kind:
            failures.append("tune: the store entry is keyed %r, not the "
                            "card's %r" % (entry and entry["device_kind"],
                                           want_kind))
        os.environ["MXNET_TUNING_STORE"] = store.path
        reg = mx.serve.ModelRegistry()
        try:
            pred = reg.load("resnet-tuned", sym, args, aux_params=aux,
                            data_shapes={"data0": shape}, ctx=ctx)
            bat = reg.batcher("resnet-tuned")
            h = reg.health("resnet-tuned")
            cfg = entry["config"] if entry else {}
            applied = h.get("tuning", {}).get("applied", {})
            want_wait = float(cfg.get("MXNET_SERVE_MAX_WAIT_MS", -1))
            ok = (list(pred.ladder.batches) == list(cfg.get("ladder", ()))
                  and "tuning" in h
                  and abs(bat._max_wait * 1e3 - want_wait) < 1e-9)
            log("quant tune: a fresh registry.load took ladder %s, the "
                "batcher window %.4f ms and row cap %d; health()['tuning'] "
                "%s -> %s" % (list(pred.ladder.batches),
                              bat._max_wait * 1e3, bat._max_batch,
                              json.dumps(applied, sort_keys=True),
                              "ok" if ok else "FAIL"))
            if not ok:
                failures.append("tune: the fresh load did not take the "
                                "stored entry %s" % cfg)
        finally:
            reg.close()
        rec = {"winner": res["config"], "score": res["score"],
               "baseline_score": res["baseline_score"],
               "gain_pct": res["gain_pct"], "again_p99_ms": again,
               "trials": res["trials"],
               "pruned": res["pruned"], "tune_s": tune_s,
               "device_kind": entry and entry["device_kind"]}
    finally:
        os.environ.pop("MXNET_TUNING_STORE", None)
        if saved is not None:
            os.environ["MXNET_TUNING_STORE"] = saved
        if env_wait is not None:
            os.environ["MXNET_SERVE_MAX_WAIT_MS"] = env_wait
        shutil.rmtree(tmp, ignore_errors=True)
    return rec


def phase_quant(torch, card, seed, ctx=None, resnet=None, lm=None,
                tune_spec=None):
    """Phase 13: int8 serving of ResNet-50 v1 and the LM, and serving
    autotuning (see the module docstring).  *ctx*, *resnet*, *lm* and
    *tune_spec* size it down for the CPU test.  Raises at its end if any
    check failed.  Returns the record; ``rec["lm"][mode]["launches"]``
    holds the int8 LM path's flash_fwd launches."""
    import numpy as np
    import mxnet_tpu_torch as mx
    if ctx is None:
        if not torch.cuda.is_available():
            raise RuntimeError("phase 13 needs CUDA")
        ctx = mx.gpu(0)
    on_card = ctx.device_type == "gpu"
    resnet, lm = resnet or Q_RESNET, lm or Q_LM
    tune_spec = tune_spec or Q_TUNE
    gen = torch.Generator(device=ctx.torch_device)
    gen.manual_seed(seed + 13)
    rng = np.random.RandomState(seed + 13)
    t_phase = time.perf_counter()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    failures = []
    tmp = tempfile.mkdtemp(prefix="chip_smoke_quant_")
    try:
        rec = {"card": card}
        rec["resnet"], sym, args, aux = quant_resnet(
            torch, np, mx, ctx, gen, rng, resnet, tmp, failures)
        image = resnet["image"]
        rec["tune"] = quant_tune(torch, np, mx, ctx, card, tune_spec,
                                 (sym, args, aux, (1, 3, image, image)),
                                 failures)
        del sym, args, aux
        if on_card:
            torch.cuda.empty_cache()
        rec["lm"] = quant_lm(torch, np, mx, ctx, gen, rng, lm, tmp,
                             failures)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rec["seconds"] = time.perf_counter() - t_phase
    rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9 \
        if on_card else None
    log("quant: phase 13 in %.1f s, peak device memory %s on %s; %d "
        "failed checks" % (rec["seconds"], "%.3f GB" % rec["peak_gb"]
                           if on_card else "not measured", card,
                           len(failures)))
    log("quant record: " + json.dumps(rec, default=str))
    if failures:
        raise RuntimeError("phase 13 failed: " + "; ".join(failures))
    return rec


# phase 14: the serving fleet (bench.py:1067 --serve-fleet and
# bench.py:1479 --serve-decode --failover, ci/fleet_chaos_drill.py's
# scenarios) with the LM at full width: replica processes on the one card
# behind serve.Router, requests of 1-2 rows x 2048 tokens on the ladder
# 1, 2, 4.  Requests draw their rows from a seeded pool, so the parent
# replays every pool row at every rung once and keeps SHA-256 hashes of
# the logits (262 MB a row), never the arrays.  In an open loop answers
# are hashed by a pool of threads beside the clients, which go on sending
# meanwhile; a closed loop keeps its answers and hashes them after its
# window, so no hashing competes with the router inside it.  closed:
# (clients, requests each) at 1 replica; closed_two: the same at 2 replicas.
FLEET = dict(cfg=(VOCAB, DIM, HEADS, LAYERS, SEQ), rungs=(1, 2, 4),
             rows=(1, 2), pool=8, closed=(2, 4),
             closed_two=((2, 4), (4, 4)), open_share=0.5,
             open_requests=60, kill_at=3, kill_requests=8, deploy_tail=4,
             max_wait_ms=MAX_WAIT_MS, spawn_timeout=600.0, workers=16,
             hashers=6)
# (d): the reference's own decode_lm (bench.py:1479-1500)
FLEET_DECODE = dict(streams=6, new_tokens=48, vocab=32, dim=16, seed=5,
                    kill_at=30, block_size=4, max_len=64, rungs=[1, 2, 4],
                    prompt=[3, 1, 2], window=0.05)
FLEET_PATH = "fleet serve (replica processes; the killed replica's lost)"


def sha256_rows(out):
    """The SHA-256 of each row's bytes of a C-contiguous host array."""
    import hashlib
    return [hashlib.sha256(memoryview(out[j]).cast("B")).hexdigest()
            for j in range(out.shape[0])]


def fleet_export(torch, mx, ctx, spec, prefix, seed):
    """Export the LM twice, v1 (epoch 1) from *seed* and v2 (epoch 2) from
    *seed* + 1, under one parameter prefix."""
    import numpy as np
    from mxnet_tpu_torch.gluon.model_zoo.transformer import \
        get_transformer_lm
    vocab, dim, heads, layers, seq = spec["cfg"]
    for version in (1, 2):
        gen = torch.Generator(device=ctx.torch_device)
        gen.manual_seed(seed + version - 1)
        net = get_transformer_lm(vocab=vocab, dim=dim, heads=heads,
                                 layers=layers, max_seq=seq,
                                 prefix="fleetlm_")
        net.initialize(ctx=ctx, generator=gen)
        net.hybridize()
        net(mx.nd.array(np.zeros((1, seq), "float32"), ctx=ctx))
        net.export(prefix, version)
        del net
        if ctx.device_type == "gpu":
            torch.cuda.empty_cache()


def fleet_refs(torch, mx, ctx, spec, prefix, pool):
    """{version: [{rung: hash} per pool row]}: the parent's own graph
    replay of each pool row at each rung (the rung's batch filled with
    pool rows, the rows are independent), hashed by a few threads."""
    rungs = spec["rungs"]
    refs = {}
    with concurrent.futures.ThreadPoolExecutor(8) as hashers:
        for version in (1, 2):
            reg = mx.serve.ModelRegistry()
            pred = reg.load_checkpoint(
                "v%d" % version, prefix, version,
                data_shapes={"data0": (1, spec["cfg"][4])},
                ladder=mx.serve.BucketLadder(batches=rungs), ctx=ctx)
            rows = [{} for _ in range(len(pool))]
            jobs = []
            for rung in rungs:
                for lo in range(0, len(pool), rung):
                    out = pred.predict({"data0": pool[lo:lo + rung]})[0]
                    host = out._data.cpu().numpy()
                    jobs.append((rung, lo, hashers.submit(sha256_rows,
                                                          host)))
            for rung, lo, job in jobs:
                for j, h in enumerate(job.result()):
                    rows[lo + j][rung] = h
            refs[version] = rows
            reg.close()
            del reg, pred
            if ctx.device_type == "gpu":
                torch.cuda.empty_cache()
    return refs


def fleet_versions(refs, idx, hashes, rungs):
    """The versions whose replay at one rung gives every row's hash."""
    return sorted(v for v, rows in refs.items()
                  if any(rung >= len(idx) and
                         all(rows[i].get(rung) == h
                             for i, h in zip(idx, hashes))
                         for rung in rungs))


class FleetTraffic:
    """Requests through ``router.predict``, each a list of pool-row
    indices; per request its latency (from its scheduled arrival in an
    open loop, from its send in a closed one), its rows and the
    versions its answer's hashes match, or its error and whether that
    error was typed.  Each answer goes to a few hashing threads and is
    let go: the client does not wait for its hash.  A closed loop may
    *defer* the hashing: its answers are kept and hashed after its last
    answer, outside its timed window."""

    def __init__(self, router, pool, refs, spec):
        self.router, self.pool, self.refs = router, pool, refs
        self.spec = spec
        self.records = []
        self._lock = threading.Lock()
        self._hashers = concurrent.futures.ThreadPoolExecutor(
            spec["hashers"])

    def _hash(self, rec, idx, out):
        ok = out.shape == (len(idx), self.spec["cfg"][4],
                           self.spec["cfg"][0])
        rec["versions"] = fleet_versions(self.refs, idx, sha256_rows(out),
                                         self.spec["rungs"]) if ok else []

    def _one(self, idx, t_sched, defer=False):
        from mxnet_tpu_torch.serve import ServeError
        x = self.pool[idx]
        t0 = time.monotonic()
        try:
            out = self.router.predict("lm", {"data0": x})[0]
        except Exception as e:          # recorded, judged by the caller
            rec = {"error": "%s: %s" % (type(e).__name__, str(e)[:200]),
                   "typed": isinstance(e, ServeError)}
        else:
            t1 = time.monotonic()
            rec = {"latency": t1 - (t_sched or t0), "end": t1,
                   "rows": len(idx)}
            if defer:
                rec["out"] = (idx, out)
            else:
                rec["job"] = self._hashers.submit(self._hash, rec, idx, out)
            del out
        with self._lock:
            self.records.append(rec)

    def _settled(self, n0):
        """The records since *n0*, each answer's hash matched."""
        recs = self.records[n0:]
        for r in recs:
            if "out" in r:
                idx, out = r.pop("out")
                r["job"] = self._hashers.submit(self._hash, r, idx, out)
        for r in recs:
            if "job" in r:
                r.pop("job").result()
        return recs

    def closed(self, reqs, threads, defer=False):
        """*threads* clients, each sending its share one after another;
        with *defer*, the answers are hashed after the last one.
        Returns (records, wall seconds to the last answer)."""
        n0 = len(self.records)
        t0 = time.monotonic()
        with concurrent.futures.ThreadPoolExecutor(threads) as ex:
            jobs = [ex.submit(lambda m: [self._one(reqs[i], None, defer)
                                         for i in m],
                              list(range(t, len(reqs), threads)))
                    for t in range(threads)]
            for j in jobs:
                j.result()
        wall = time.monotonic() - t0
        return self._settled(n0), wall

    def open(self, reqs, rate, stop=None):
        """reqs[i] sent at i / *rate* s after the first (until *stop* is
        set, when given), whatever the answers.  Returns (records, wall
        seconds from the first arrival to the last answer)."""
        n0 = len(self.records)
        t0 = time.monotonic()
        with concurrent.futures.ThreadPoolExecutor(
                self.spec["workers"]) as ex:
            for i, idx in enumerate(reqs):
                if stop is not None and stop.is_set():
                    break
                t_sched = t0 + i / rate
                delay = t_sched - time.monotonic()
                if delay > 0:
                    time.sleep(delay)
                ex.submit(self._one, idx, t_sched)
        recs = self._settled(n0)
        ends = [r["end"] for r in recs if "end" in r]
        return recs, (max(ends) if ends else time.monotonic()) - t0

    def close(self):
        self._hashers.shutdown()


def fleet_requests(rng, spec, n):
    return [list(rng.randint(0, spec["pool"],
                             int(rng.choice(spec["rows"]))))
            for _ in range(n)]


def fleet_summary(recs, wall):
    good = [r for r in recs if "latency" in r]
    lat = [r["latency"] for r in good]
    return {"requests": len(recs), "answered": len(good),
            "failed": len(recs) - len(good),
            "rows": sum(r["rows"] for r in good),
            "requests_s": len(good) / wall if wall else None,
            "p50_ms": percentile(lat, 50) * 1e3 if lat else None,
            "slowest_ms": max(lat) * 1e3 if lat else None,
            "wall_s": wall}


def fleet_dispatch(fleet, before=None):
    """{key: (predicts_dispatched, predict_seconds, dup_hits)} of the live
    replicas, less *before*'s."""
    out = {}
    for k in fleet.keys():
        st = fleet.stats(k)
        now = (st["predicts_dispatched"], st["predict_seconds"],
               st["dup_hits"])
        b = (before or {}).get(k, (0, 0.0, 0))
        out[k] = tuple(n - o for n, o in zip(now, b))
    return out


def fleet_stage(fleet, traffic, what, reqs, rate, card, failures,
                threads=None):
    """One stage, an open loop at *rate* or, given *threads*, a closed loop
    of that many clients whose answers are hashed after its window: the
    router's numbers beside the replicas' dispatch time; every answer
    must match a v1 hash."""
    before = fleet_dispatch(fleet)
    if threads:
        recs, wall = traffic.closed(reqs, threads, defer=True)
        how = ("in a closed loop of %d clients (latency from each send; "
               "answers hashed after the loop)" % threads)
    else:
        recs, wall = traffic.open(reqs, rate)
        how = ("offered at %.3f/s (latency from each scheduled arrival; "
               "answers hashed meanwhile)" % rate)
    st = fleet_summary(recs, wall)
    grew = fleet_dispatch(fleet, before)
    dispatched = sum(v[0] for v in grew.values())
    st["replica_ms"] = (1e3 * sum(v[1] for v in grew.values())
                        / dispatched) if dispatched else None
    st["mean_ms"] = (1e3 * sum(r["latency"] for r in recs if "latency" in r)
                     / st["answered"]) if st["answered"] else None
    st["dispatched"], st["dup_hits"] = dispatched, sum(
        v[2] for v in grew.values())
    st["v1_equal"] = sum(1 for r in recs if r.get("versions") == [1])
    log("fleet %s on %s: %d requests (%d rows of %d tokens) %s over %d "
        "replica(s): %.3f answered/s, p50 %.2f ms, slowest %.2f ms (%d "
        "requests are too few for a p99), mean %.2f ms at the router "
        "against %.2f ms submit-to-answer in the replicas (their batcher, "
        "replay and readback; the rest is the wire, the router's copies "
        "and this process's own work); %d dispatched, %d dedup hits; %d "
        "answers bit-equal to the parent's v1 replay at a rung" % (
            what, card, st["requests"], st["rows"], traffic.spec["cfg"][4],
            how, len(fleet.keys()), st["requests_s"] or 0.0,
            st["p50_ms"] or 0.0, st["slowest_ms"] or 0.0, st["requests"],
            st["mean_ms"] or 0.0, st["replica_ms"] or 0.0, dispatched,
            st["dup_hits"], st["v1_equal"]))
    if st["failed"] or st["v1_equal"] != st["requests"]:
        failures.append("%s: %d failed, %d of %d bit-equal to v1" % (
            what, st["failed"], st["v1_equal"], st["requests"]))
    if dispatched != st["answered"] or st["dup_hits"]:
        failures.append("%s: %d dispatches and %d dedup hits for %d "
                        "answers" % (what, dispatched, st["dup_hits"],
                                     st["answered"]))
    return st


def fleet_decode(np, mx, ctx, card, dec, tmp, failures):
    """(d): streams of the reference's decode_lm over 2 replicas, one
    armed to die at its kill_at-th decode request; every stream resumes
    from the router's journal bit-equal to the dense decode."""
    from mxnet_tpu_torch.test_utils import (dense_decode_reference,
                                            tiny_attention_lm)
    prompt = np.asarray(dec["prompt"], np.int32)
    blocks_per = -(-dec["max_len"] // dec["block_size"])
    spec = [{"name": "lm", "kind": "decode_lm", "vocab": dec["vocab"],
             "dim": dec["dim"], "seed": dec["seed"], "dtype": "float32",
             "max_len": dec["max_len"], "block_size": dec["block_size"],
             "num_blocks": dec["streams"] * blocks_per + 8,
             "rungs": dec["rungs"]}]
    params, step, _, _, _ = tiny_attention_lm(
        vocab=dec["vocab"], dim=dec["dim"], seed=dec["seed"], ctx=ctx)
    ref = dense_decode_reference(params, step, list(prompt),
                                 dec["new_tokens"], dec["max_len"],
                                 dec["dim"])
    fleet = mx.serve.Fleet(spec, replicas=1, workdir=tmp, max_wait_ms=1.0,
                           ctx=ctx, router_kwargs={"probe_interval": 0.2,
                                                   "retries": 4})
    stamps, errors, rec = [], [], {}
    lock = threading.Lock()

    def consume(s):
        while True:
            try:
                s.next_output(timeout=120)
            except StopIteration:
                return
            except Exception as e:      # recorded, fails the phase
                with lock:
                    errors.append("stream %d: %r" % (s.seq, e))
                return
            with lock:
                stamps.append(time.monotonic())

    try:
        fleet.start()
        armed = fleet._spawn(extra_env={
            "MXNET_CHAOS": "replica_kill_decode_at=%d" % dec["kill_at"]})
        fleet.wait_routable(count=2, model="lm")
        survivors = [k for k in fleet.keys() if k != armed]
        warm = {k: fleet.stats(k)["decode"]["lm"]["compile_count"]
                for k in survivors}
        t0 = time.monotonic()
        opened = [fleet.router.decode_open("lm", {"tok": prompt},
                                           max_new_tokens=dec["new_tokens"])
                  for _ in range(dec["streams"])]
        threads = [threading.Thread(target=consume, args=(s,))
                   for s in opened]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        wall = time.monotonic() - t0
        rec["kill_rc"] = fleet.record(armed)["proc"].wait(60)
        rec["bit_equal"] = sum(1 for s in opened if [
            int(np.asarray(t)) for t in s.tokens()] == ref)
        moved = [s for s in opened if s.failover_count >= 1]
        resume = sorted(b - a for s in moved for a, b in s.resume_stamps)
        for s in opened:
            s.close()
        after = {k: fleet.stats(k)["decode"]["lm"] for k in survivors}
        rec["request_path_captures"] = sum(
            after[k]["compile_count"] - warm[k] for k in survivors)
        rec["blocks_in_use"] = sum(after[k]["blocks_in_use"]
                                   for k in survivors)
    finally:
        fleet.stop()
    times = sorted(stamps)
    rates = []
    if len(times) > 1:
        n_win = max(1, int((times[-1] - times[0]) / dec["window"]))
        counts = [0] * n_win
        for t in times:
            counts[min(n_win - 1, int((t - times[0]) / dec["window"]))] += 1
        rates = [c / dec["window"] for c in (counts[1:-1] or counts)]
    rec.update(streams=len(opened), moved=len(moved), resumes=len(resume),
               tokens=len(stamps), tokens_s=len(stamps) / wall,
               resume_p50_ms=percentile(resume, 50) * 1e3
               if resume else None,
               resume_slowest_ms=resume[-1] * 1e3 if resume else None,
               steady_tokens_s=max(rates) if rates else None,
               dip_tokens_s=min(rates) if rates else None, errors=errors)
    log("fleet decode failover on %s (decode_lm vocab %d, dim %d, seed %d): "
        "%d streams of %d tokens over 2 replicas, one killed at its decode "
        "request %d (rc %s): %d streams bit-equal to the dense decode, %d "
        "failed over (%d resumes: p50 %s, slowest %s); %.1f tokens/s, "
        "steady %s, dip %s (%d ms windows); survivors captured %d graphs "
        "in the request path, %d KV blocks in use after; errors %s" % (
            card, dec["vocab"], dec["dim"], dec["seed"], rec["streams"],
            dec["new_tokens"], dec["kill_at"], rec["kill_rc"],
            rec["bit_equal"], rec["moved"], rec["resumes"],
            "%.2f ms" % rec["resume_p50_ms"] if resume else "none",
            "%.2f ms" % rec["resume_slowest_ms"] if resume else "none",
            rec["tokens_s"], "%.1f/s" % rec["steady_tokens_s"]
            if rates else "not measured", "%.1f/s" % rec["dip_tokens_s"]
            if rates else "not measured", int(dec["window"] * 1e3),
            rec["request_path_captures"], rec["blocks_in_use"],
            errors or "none"))
    if (errors or rec["bit_equal"] != dec["streams"] or not moved
            or rec["kill_rc"] != 137 or rec["request_path_captures"]
            or rec["blocks_in_use"]):
        failures.append("decode failover: %d/%d bit-equal, %d moved, rc "
                        "%s, %d captures, %d blocks, errors %s" % (
                            rec["bit_equal"], dec["streams"], len(moved),
                            rec["kill_rc"], rec["request_path_captures"],
                            rec["blocks_in_use"], errors[:3]))
    return rec


def phase_fleet(torch, card, seed, ctx=None, spec=None, dec=None):
    """Phase 14: the serving fleet (see the module docstring).  *ctx*,
    *spec* and *dec* size it down for the CPU test.  Raises at its end if
    any check failed.  Returns the record; ``rec["launches"]`` holds the
    replicas' flash_fwd launches (wrapper and graph replays), read from
    each one's STATS before it was stopped."""
    import numpy as np
    import mxnet_tpu_torch as mx
    if ctx is None:
        if not torch.cuda.is_available():
            raise RuntimeError("phase 14 needs CUDA")
        ctx = mx.gpu(0)
    on_card = ctx.device_type == "gpu"
    spec, dec = spec or FLEET, dec or FLEET_DECODE
    vocab, seq = spec["cfg"][0], spec["cfg"][4]
    rng = np.random.RandomState(seed + 14)
    failures = []
    t_phase = time.perf_counter()
    if on_card:
        # the replicas are processes of their own: they cannot reuse the
        # parent's cached blocks
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_fleet_")
    prefix = os.path.join(tmp, "lm")
    rec = {"card": card}
    fleet = traffic = None
    try:
        t0 = time.perf_counter()
        fleet_export(torch, mx, ctx, spec, prefix, seed)
        pool = rng.randint(0, vocab, (spec["pool"], seq)).astype("float32")
        refs = fleet_refs(torch, mx, ctx, spec, prefix, pool)
        log("fleet: exported v1 and v2 of the LM, replayed %d pool rows at "
            "rungs %s of each and hashed them in %.2f s" % (
                spec["pool"], list(spec["rungs"]),
                time.perf_counter() - t0))
        model = {"name": "lm", "prefix": prefix, "epoch": 1,
                 "data_shapes": {"data0": [1, seq]},
                 "batches": list(spec["rungs"])}
        fleet = mx.serve.Fleet(
            [model], replicas=1, workdir=tmp, ctx=ctx,
            max_wait_ms=spec["max_wait_ms"],
            spawn_timeout=spec["spawn_timeout"],
            router_kwargs={"probe_interval": 0.2, "eject_timeout": 5.0})
        traffic = FleetTraffic(fleet.router, pool, refs, spec)
        # (a) one replica, its closed-loop rate, half of it open; then two
        t0 = time.perf_counter()
        fleet.start()
        rec["up_s"] = time.perf_counter() - t0
        log("fleet: first replica up in %.2f s" % rec["up_s"])
        threads, per = spec["closed"]
        rec["closed"] = fleet_stage(
            fleet, traffic, "closed loop, 1 replica",
            fleet_requests(rng, spec, threads * per), None, card, failures,
            threads=threads)
        rate = spec["open_share"] * rec["closed"]["requests_s"]
        rec["one"] = fleet_stage(
            fleet, traffic, "open loop, 1 replica",
            fleet_requests(rng, spec, spec["open_requests"]), rate, card,
            failures)
        t0 = time.perf_counter()
        fleet._spawn()
        fleet.wait_routable(count=2)
        rec["scale_out_s"] = time.perf_counter() - t0
        log("fleet: scale-out to 2 replicas in %.2f s" % rec["scale_out_s"])
        rec["two"] = fleet_stage(
            fleet, traffic, "open loop, 2 replicas",
            fleet_requests(rng, spec, spec["open_requests"]), rate, card,
            failures)
        # the rate two replicas take in, with as many clients and twice
        rec["closed_two"] = [fleet_stage(
            fleet, traffic, "closed loop, 2 replicas",
            fleet_requests(rng, spec, threads * per), None, card, failures,
            threads=threads) for threads, per in spec["closed_two"]]
        # (b) a replica killed under traffic, then replaced
        armed = fleet.replace(fleet.keys()[0], extra_env={
            "MXNET_CHAOS": "replica_kill_at=%d" % spec["kill_at"]})
        fleet.wait_routable(count=2)
        recs, wall = traffic.open(fleet_requests(rng, spec,
                                                 spec["kill_requests"]),
                                  rate)
        kill = fleet_summary(recs, wall)
        kill["rc"] = fleet.record(armed)["proc"].wait(120)
        kill["bit_equal"] = sum(1 for r in recs if r.get("versions") == [1])
        kill["untyped"] = sum(1 for r in recs
                              if "error" in r and not r["typed"])
        t0 = time.perf_counter()
        successor = fleet.replace(armed)
        kill["replace_s"] = time.perf_counter() - t0
        st = fleet.stats(successor)
        kill["successor_nvcc_s"] = st["nvcc_seconds"]
        kill["successor_captures"] = st["compile_count"]
        log("fleet kill on %s: replica_kill_at=%d under %d requests at "
            "%.3f/s: rc %s; %d answered (%d bit-equal to v1), %d failed "
            "(%d untyped), p50 %.2f ms, slowest %.2f ms; replaced in %.2f "
            "s, the successor spent %.2f nvcc seconds and captured %s at "
            "load" % (card, spec["kill_at"], kill["requests"], rate,
                      kill["rc"],
                      kill["answered"], kill["bit_equal"], kill["failed"],
                      kill["untyped"], kill["p50_ms"] or 0.0,
                      kill["slowest_ms"] or 0.0, kill["replace_s"],
                      kill["successor_nvcc_s"], kill["successor_captures"]))
        if kill["rc"] != 137 or kill["failed"] or \
                kill["bit_equal"] != kill["requests"] or \
                kill["successor_nvcc_s"] != 0.0:
            failures.append("kill: rc %s, %d failed, %d of %d bit-equal, "
                            "successor nvcc %.2f s" % (
                                kill["rc"], kill["failed"],
                                kill["bit_equal"], kill["requests"],
                                kill["successor_nvcc_s"]))
        rec["kill"] = kill
        # (c) a rolling deploy onto v2 under the same traffic
        fleet.wait_routable(count=2)
        stop = threading.Event()
        during = {}
        feeder = threading.Thread(target=lambda: during.update(zip(
            ("recs", "wall"), traffic.open(
                fleet_requests(rng, spec, 2000), rate, stop=stop))))
        feeder.start()
        t0 = time.perf_counter()
        try:
            fleet.deploy([dict(model, epoch=2)])
        finally:
            stop.set()
            feeder.join(600)
        deploy_s = time.perf_counter() - t0
        recs_after, _ = traffic.closed(
            fleet_requests(rng, spec, spec["deploy_tail"]), 1)
        dep = fleet_summary(during["recs"], during["wall"])
        dep.update(seconds=deploy_s,
                   either=sum(1 for r in during["recs"]
                              if r.get("versions") in ([1], [2], [1, 2])),
                   v2_after=sum(1 for r in recs_after
                                if r.get("versions") == [2]),
                   after=len(recs_after),
                   drains=[{k: d.get(k) for k in ("replica",
                                                  "waited_requests",
                                                  "timed_out")}
                           for d in fleet.drain_records])
        log("fleet deploy on %s: both replicas cycled onto v2 in %.2f s "
            "under %d requests at %.3f/s: %d answered, %d dropped, %d "
            "bit-equal to v1 or v2, p50 %.2f ms, slowest %.2f ms; after "
            "it %d of %d answers bit-equal to v2 only; drains %s" % (
                card, deploy_s, dep["requests"], rate, dep["answered"],
                dep["failed"], dep["either"], dep["p50_ms"] or 0.0,
                dep["slowest_ms"] or 0.0, dep["v2_after"], dep["after"],
                dep["drains"]))
        if dep["failed"] or dep["either"] != dep["requests"] or \
                dep["v2_after"] != dep["after"] or \
                any(d["timed_out"] is not False for d in dep["drains"]) or \
                len(dep["drains"]) != 2:
            failures.append("deploy: %d dropped, %d of %d v1-or-v2, %d of "
                            "%d v2 after, drains %s" % (
                                dep["failed"], dep["either"],
                                dep["requests"], dep["v2_after"],
                                dep["after"], dep["drains"]))
        rec["deploy"] = dep
        answered = sum(1 for r in traffic.records if "latency" in r)
    finally:
        if fleet is not None:
            fleet.stop()
        if traffic is not None:
            traffic.close()
    # every replica's STATS, read before it was stopped (None: killed)
    reaped = fleet.reaped()
    final = [r["final_stats"] for r in reaped if r["final_stats"]]
    dispatched = sum(s["predicts_dispatched"] for s in final)
    rec["replicas"] = [{
        "name": r["name"], "rc": r["rc"],
        "captures": (r["final_stats"] or {}).get("compile_count"),
        "nvcc_s": (r["final_stats"] or {}).get("nvcc_seconds"),
        "peak_gb": ((r["final_stats"] or {}).get("peak_memory_bytes")
                    or 0) / 1e9 if r["final_stats"] else None,
        "dispatched": (r["final_stats"] or {}).get("predicts_dispatched")}
        for r in reaped]
    for r in rec["replicas"]:
        log("fleet replica %s: rc %s, programs built %s (a CUDA graph a "
            "rung on the card), nvcc %s s, "
            "peak device memory %s, %s predicts dispatched" % (
                r["name"], r["rc"], r["captures"], r["nvcc_s"],
                "%.3f GB" % r["peak_gb"] if r["peak_gb"] is not None
                and on_card else "not measured (killed)"
                if r["captures"] is None else "not measured",
                r["dispatched"]))
    want_captures = {"lm": len(spec["rungs"])}
    if any(r["captures"] not in (None, want_captures)
           for r in rec["replicas"]):
        failures.append("a replica captured graphs in the request path: %s"
                        % [r["captures"] for r in rec["replicas"]])
    if any(r["nvcc_s"] not in (None, 0.0) for r in rec["replicas"]):
        failures.append("a replica compiled kernels: %s"
                        % [r["nvcc_s"] for r in rec["replicas"]])
    # the killed replica dispatched kill_at - 1 predicts before it died
    if dispatched + spec["kill_at"] - 1 != answered or \
            sum(s["dup_hits"] for s in final):
        failures.append("exactly once: %d dispatched + %d by the killed "
                        "replica for %d answered, %d dedup hits" % (
                            dispatched, spec["kill_at"] - 1, answered,
                            sum(s["dup_hits"] for s in final)))
    rec["launches"] = {
        kind: sum(s["kernels"]["flash_fwd"][kind] for s in final)
        for kind in ("wrapper", "graph")}
    log("fleet: flash_fwd in the replica processes (their STATS before "
        "each was stopped; the killed replica's are lost): %d wrapper "
        "launches (warm-ups), %d by graph replays" % (
            rec["launches"]["wrapper"], rec["launches"]["graph"]))
    if on_card and not (rec["launches"]["wrapper"] and
                        rec["launches"]["graph"]):
        failures.append("the replicas launched no flash_fwd: %s"
                        % rec["launches"])
    rec["decode"] = fleet_decode(np, mx, ctx, card, dec, tmp, failures)
    shutil.rmtree(tmp, ignore_errors=True)
    rec["seconds"] = time.perf_counter() - t_phase
    log("fleet: phase 14 in %.1f s on %s; %d failed checks" % (
        rec["seconds"], card, len(failures)))
    log("fleet record: " + json.dumps(rec, default=str))
    if failures:
        raise RuntimeError("phase 14 failed: " + "; ".join(failures))
    return rec


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
    path_ptxas = phase_build()
    timing = phase_kernel(torch, card, args.seed)
    serve_launches = phase_serve(torch, card, args.seed)
    train_launches = phase_train(torch, card, args.seed)
    phase_resnet(torch, card, args.seed)
    ns_launches = phase_north_star(torch, card, args.seed)
    decode_launches = phase_decode(torch, card, args.seed)
    user_launches = phase_user_surface(torch, card, args.seed)
    module_launches = phase_module(torch, card, args.seed)["launches"]
    phase_lstm(torch, card, args.seed)
    phase_data(torch, card, args.seed)
    quant = phase_quant(torch, card, args.seed)["lm"]
    fleet = phase_fleet(torch, card, args.seed)["launches"]
    quant_launches = {
        kind: sum(quant[m]["launches"][kind]
                  for m in ("int8", "int8-weight-only"))
        for kind in ("eager", "graph")}
    b, h, sq, sk, d = PATH_SHAPE
    kernels = []
    for name, source, replaces in (
            ("flash_fwd", "flash_fwd.cu", "mxnet_tpu/ops/attention.py:164"),
            ("flash_bwd_dkdv", "flash_bwd.cu",
             "mxnet_tpu/ops/attention.py:335"),
            ("flash_bwd_dq", "flash_bwd.cu",
             "mxnet_tpu/ops/attention.py:380")):
        by_path = {"train": train_launches[name],
                   "north-star LM train (bf16)": ns_launches[name],
                   "user-surface LM train (eager nd, adam)":
                   user_launches[name],
                   MODULE_PATH: module_launches[name]}
        if name == "flash_fwd":
            by_path = {
                "serve (eager: first forward, rung warm-ups)":
                serve_launches["eager"],
                "serve (graph replays: warm, direct requests)":
                serve_launches["direct"],
                "batched serve (graph replays: traffic dispatches)":
                serve_launches["traffic"], **by_path,
                "decode prefill": decode_launches,
                "quantized LM serve (eager: calibration, warm-ups)":
                quant_launches["eager"],
                "quantized LM serve (graph replays: gate, traffic, "
                "checks)": quant_launches["graph"],
                FLEET_PATH + ", eager: warm-ups": fleet["wrapper"],
                FLEET_PATH + ", graph replays": fleet["graph"]}
        kernels.append(dict({
            "name": name, "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/" + source,
            "replaces": replaces, "launches": sum(by_path.values())},
            **timing[(name, "float32")], launches_by_path=by_path,
            dtype="float32", shape=[b, h, sq, sk, d], causal=True,
            bfloat16=timing[(name, "bfloat16")], card=card))
        if name in path_ptxas:
            kernels[-1]["ptxas"] = path_ptxas[name]
    log("total %.1f s" % (time.perf_counter() - t_start))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
