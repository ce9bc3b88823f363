"""``chip_smoke.py``'s logic on the CPU.

The build gate reads registers and spills from nvcc's ``-Xptxas -v``
logs and fails the run when an instantiation the paths run
(``PATH_ENTRIES``: flash_fwd, flash_bwd_dkdv and flash_bwd_dq, f32,
D = 64) spills or is missing from its source's log, on a fresh build and
on one that an earlier run left behind.

Phase 6 (ResNet-50): its limits against float64 pass f32-sized errors
and fail TF32-sized ones (the sizes its first run on an H100 measured),
its TF32 pass really switches the port's f32 convolutions to TF32, and
the phase raises without CUDA.

Phase 7 (the north-star trainer): the update check passes the trainer's
coalesced and per-tensor LARS + mp_sgd_mom updates against the float64
formula and fails its two wrong variants, on a small net on the CPU; the
bf16-vs-f64 check's limits pass the gaps its first H100 run measured and
fail the other batch's; the checkpoint round trip holds a ResNet
trainer's state bit for bit; the phase raises without CUDA.

Phase 9 (the eager user surface): the op sweep's checks pass every case
with the CPU standing for both devices, and fail a case whose outputs
differ; the phase raises without CUDA.

Phase 10 (the symbolic training path): on a 2-layer LM (dim 32, vocab
50, seq 32, batch 2) on the CPU, the check step's two bindings agree, one
fused step is bit-equal to one legacy step, ``fit`` lowers the loss and
its ``score`` equals the perplexity of ``predict``'s outputs, and a
checkpoint loaded into a fresh Module steps bit-equal to the original;
every check of the phase is wired; the phase raises without CUDA.

Phase 11 (recurrent networks): on the CPU at a small size (the op's
route is the plain loop there), the op checks, the control-flow checks,
the LSTM LM trainer and the bucketing loop run and pass; every check of
the phase is wired; the limits pass the gaps its first H100 run
measured; the phase raises without CUDA.

Phase 12 (the data path): at a small size on the CPU (32 x 32 crops
of 36-60 pixel JPEGs, batch 8, a thumbnail ResNet-18, the libjpeg route)
the records, the decode checks against the plain version, the decode
rate, ``Module.fit`` at depth 2, 0 and from memory, the prefetch parity
and the gluon flow through two worker processes run and pass; the plain
geometry agrees with the route's; every check of the phase is wired;
the phase raises without CUDA.

Phase 8 (paged decode): on a 2-layer LM (dim 64, vocab 97) served on the
CPU with the JAX package's weights, the decode step's teacher-forced
logits are within 1e-5 of the JAX ``TransformerLM`` forward; paged
streams equal the dense ``make_decoder`` streams; a freed block filled
with NaN — by ids past the table, or by hand — leaves the next
sessions' streams unchanged; every check of the phase is wired; the
phase raises without CUDA.

Phase 13 (int8 serving and tuning): at a small size on the CPU (a
thumbnail ResNet-18 at 32 x 32, rungs 1, 2, 4; a 2-layer LM of dim 128;
a 0.3 s trace over three ladders topping at 4) the quantized loads pass
their gates, every rung counts its int8 products, the answers match the
CPU run, the traffic coalesces, the tuned entry is picked up by a fresh
load; every check of the phase is wired; the phase raises without
CUDA."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

DKDV64 = ("_ZN12_GLOBAL__N_121flash_bwd_dkdv_kernelIfLi64ELi64ELi64EEEvPKT_"
          "S4_S4_S4_PKfS6_PS2_S7_iiifii")
DKDV64_BF16 = DKDV64.replace("kernelIf", "kernelI13__nv_bfloat16")
DQ64 = ("_ZN12_GLOBAL__N_119flash_bwd_dq_kernelIfLi64ELi128ELi64EEEvPKT_S4_"
        "S4_S4_PKfS6_PS2_iiifii")
DQ64_BF16 = DQ64.replace("kernelIf", "kernelI13__nv_bfloat16")
FWD64 = ("_ZN12_GLOBAL__N_116flash_fwd_kernelIfLi64ELi128ELi64EEEvPKT_S3_S3_"
         "PS1_Pfiiifii")
FWD64_BF16 = FWD64.replace("kernelIf", "kernelI13__nv_bfloat16")
FWD128 = FWD64.replace("Li64ELi128", "Li128ELi64")
CLEAN = {"registers": 168, "spill_stores": 0, "spill_loads": 0}


def _log(entries):
    """An nvcc -Xptxas -v log of *entries* (name, registers, stores,
    loads), in ptxas's own line format."""
    lines = ["ptxas info    : 0 bytes gmem"]
    for name, regs, st, ld in entries:
        lines += [
            "ptxas info    : Compiling entry function '%s' for 'sm_90a'"
            % name,
            "ptxas info    : Function properties for %s" % name,
            "    0 bytes stack frame, %d bytes spill stores, %d bytes spill "
            "loads" % (st, ld),
            "ptxas info    : Used %d registers, used 1 barriers, 448 bytes "
            "cmem[0]" % regs]
    return "\n".join(lines) + "\n"


def test_ptxas_usage_reads_every_entry():
    got = chip_smoke.ptxas_usage(_log([(DKDV64, 168, 0, 0),
                                       (DQ64, 214, 68, 72)]))
    assert got == {
        DKDV64: {"registers": 168, "spill_stores": 0, "spill_loads": 0},
        DQ64: {"registers": 214, "spill_stores": 68, "spill_loads": 72}}


def _logs(fwd=((FWD64, 168, 0, 0),),
          bwd=((DKDV64, 168, 0, 0), (DQ64, 168, 0, 0))):
    """{source: nvcc log}, each path entry clean unless given."""
    return {"flash_fwd": _log(fwd), "flash_bwd": _log(bwd)}


def test_path_dkdv_usage_passes_a_clean_build():
    logs = _logs(fwd=[(FWD64_BF16, 255, 96, 96), (FWD64, 190, 0, 0),
                      (FWD128, 255, 40, 40)],
                 bwd=[(DKDV64_BF16, 255, 96, 96), (DKDV64, 168, 0, 0),
                      (DQ64_BF16, 255, 68, 72), (DQ64, 214, 0, 0)])
    assert chip_smoke.path_usage(logs) == {
        "flash_fwd": {"registers": 190, "spill_stores": 0,
                      "spill_loads": 0},
        "flash_bwd_dkdv": CLEAN,
        "flash_bwd_dq": {"registers": 214, "spill_stores": 0,
                         "spill_loads": 0}}


@pytest.mark.parametrize("entries", [
    [(DKDV64, 255, 68, 0)],             # spill stores
    [(DKDV64, 255, 0, 4)],              # spill loads
    [(DKDV64_BF16, 128, 0, 0)],         # the f32 instantiation is missing
    [(DKDV64, 128, 0, 0), (DKDV64 + "x", 128, 0, 0)],   # ambiguous
])
def test_path_dkdv_usage_fails_the_run(entries):
    with pytest.raises(RuntimeError, match="flash_bwd_dkdv_kernel"):
        chip_smoke.path_usage(_logs(bwd=entries + [(DQ64, 168, 0, 0)]))


def test_path_dkdv_usage_fails_without_the_spill_line():
    logs = _logs()
    logs["flash_bwd"] = "\n".join(line for line in logs["flash_bwd"]
                                  .splitlines() if "spill" not in line)
    with pytest.raises(RuntimeError):
        chip_smoke.path_usage(logs)


ENTRY = {"flash_fwd": FWD64, "flash_bwd_dkdv": DKDV64,
         "flash_bwd_dq": DQ64}
SOURCE = {"flash_fwd": "flash_fwd", "flash_bwd_dkdv": "flash_bwd",
          "flash_bwd_dq": "flash_bwd"}


@pytest.mark.parametrize("fault", ["spill stores", "spill loads", "missing",
                                   "in the other source's log"])
@pytest.mark.parametrize("kernel", ["flash_fwd", "flash_bwd_dkdv",
                                    "flash_bwd_dq"])
def test_path_usage_fails_when_an_entry_spills_or_is_missing(kernel, fault):
    """Each path entry fails the run on its own, beside clean entries of
    the other kernels, and each is read only from its own source's log."""
    entry, source = ENTRY[kernel], SOURCE[kernel]
    other = ({"flash_fwd", "flash_bwd"} - {source}).pop()
    logs = _logs()
    assert set(chip_smoke.path_usage(logs)) == set(ENTRY)
    rest = [(ENTRY[n], 168, 0, 0) for n in ENTRY
            if n != kernel and SOURCE[n] == source]
    if fault == "spill stores":
        logs[source] = _log(rest + [(entry, 255, 68, 0)])
    elif fault == "spill loads":
        logs[source] = _log(rest + [(entry, 255, 0, 4)])
    elif fault == "missing":
        logs[source] = _log(rest)
    else:
        logs[other] = _log([(e, 168, 0, 0) for e in ENTRY.values()])
        logs[source] = _log(rest)
    with pytest.raises(RuntimeError, match="spills" if "spill" in fault
                       else "complete entries"):
        chip_smoke.path_usage(logs)


def _fake_nvcc(tmp_path, text):
    """An executable that stands in for nvcc: it prints *text* and writes
    the file named after ``-o``."""
    path = tmp_path / "nvcc"
    path.write_text(
        "#!%s\nimport sys\n"
        "open(sys.argv[sys.argv.index('-o') + 1], 'w').close()\n"
        "sys.stdout.write(%r)\n" % (sys.executable, text))
    path.chmod(0o755)
    return str(path)


@pytest.mark.parametrize("spill", [0, 68])
def test_build_gate_reads_a_library_built_before(tmp_path, monkeypatch,
                                                 spill):
    """A second run in the same checkout finds both libraries built: the
    gate reads ptxas's lines from the nvcc log kept beside each, so it
    passes a clean build and still fails a spilling one."""
    from mxnet_tpu_torch.ops import _cuda
    nvcc = _fake_nvcc(tmp_path, _log([(FWD64, 168, 0, 0),
                                      (DKDV64, 168, spill, spill),
                                      (DQ64, 214, 0, 0)]))
    monkeypatch.setattr(_cuda, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_cuda, "_nvcc", lambda: nvcc)
    results = []
    for run in range(2):
        if run:
            os.remove(nvcc)     # the second run must not compile again
        if spill:
            with pytest.raises(RuntimeError, match="spills"):
                chip_smoke.phase_build()
        else:
            results.append(chip_smoke.phase_build())
        for source, entry in (("flash_fwd", FWD64), ("flash_bwd", DKDV64)):
            info = _cuda.build(source)
            assert info["seconds"] == 0.0 and entry in info["log"]
    if not spill:
        assert results[0] == results[1] == {
            "flash_fwd": CLEAN, "flash_bwd_dkdv": CLEAN,
            "flash_bwd_dq": dict(CLEAN, registers=214)}


# phase 6's first run on an NVIDIA H100 80GB HBM3 (PERF.md): the
# served logits' error against f64 as a share of max |logit|, and the
# worst gradient gap as a share of max |g| with the ReLU masks frozen
SERVED_F32, SERVED_TF32 = 2.16e-6, 4.27e-4
GRAD_F32, GRAD_TF32 = 1.896e-3, 0.1494


@pytest.mark.parametrize("scale", [4546.0, 0.5])
def test_resnet_serve_limit_passes_f32_and_fails_tf32(scale):
    top = max(1.0, scale)
    _, ok = chip_smoke.within(SERVED_F32 * top, scale,
                              chip_smoke.TOL_RESNET_SERVE)
    ratio, tf32_ok = chip_smoke.within(SERVED_TF32 * top, scale,
                                       chip_smoke.TOL_RESNET_SERVE)
    assert ok and not tf32_ok and ratio > 1.0


def test_resnet_grad_limit_passes_f32_and_fails_tf32():
    f32 = {"stem": (GRAD_F32, 4.6e-4), "fc": (1e-6, 1e-7)}
    tf32 = {"stem": (0.02, 0.01), "bn": (GRAD_TF32, 0.142)}
    assert chip_smoke.worst_share(f32) <= chip_smoke.TOL_RESNET_GRAD
    assert chip_smoke.worst_share(tf32) > chip_smoke.TOL_RESNET_GRAD
    # a gradient that is not finite fails the limit (grad_gaps gives inf)
    import torch
    gaps = chip_smoke.grad_gaps(
        torch, {"w": torch.tensor([1.0, float("nan")])},
        {"w": torch.tensor([1.0, 2.0])})
    assert not chip_smoke.worst_share(gaps) <= chip_smoke.TOL_RESNET_GRAD


def test_resnet_tf32_pass_switches_the_f32_convolutions():
    """Inside ``tf32_convolutions`` a float32 Convolution asks cuDNN for
    TF32; outside it, full float32."""
    import torch
    from mxnet_tpu_torch.ops import nn as nn_ops
    assert nn_ops.conv_precision(torch.float32) == "ieee"
    with chip_smoke.tf32_convolutions(torch):
        assert nn_ops.conv_precision(torch.float32) == "tf32"
        assert nn_ops.conv_precision(torch.bfloat16) is None
    assert nn_ops.conv_precision(torch.float32) == "ieee"


def test_resnet_phase_raises_without_cuda(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        chip_smoke.phase_resnet(torch, "no card", 0)


def _small_trainers(coalesce=(None, False)):
    """Two multi-precision LARS trainers (bench.py's optimizer) of one
    small conv + BatchNorm net on the CPU, coalesced and per-tensor."""
    import numpy as np
    import torch
    import mxnet_tpu_torch as mx
    nn = mx.gluon.nn
    net = nn.HybridSequential(prefix="ns_")
    with net.name_scope():
        net.add(nn.Conv2D(8, 3, padding=1), nn.BatchNorm(),
                nn.Activation("relu"), nn.Conv2D(16, 3, padding=1),
                nn.BatchNorm(), nn.Activation("relu"), nn.Dense(5))
    net.initialize(mx.init.Xavier(rnd_type="gaussian"), ctx=mx.cpu())
    rs = np.random.RandomState(0)
    x = mx.nd.array(rs.randn(8, 3, 8, 8).astype("float32"), ctx=mx.cpu())
    y = mx.nd.array(rs.randint(0, 5, (8,)).astype("float32"), ctx=mx.cpu())
    net(x)
    trainers = [chip_smoke.ns_trainer(torch, mx, net, "lbsgd",
                                      chip_smoke.NS_OPT, torch.device("cpu"),
                                      coalesce_small=c) for c in coalesce]
    for tr in trainers:
        tr.fit_batch(x, y)
    return trainers, x, y


def test_update_check_passes_the_trainer_and_fails_wrong_updates():
    import torch
    (coalesced, per_tensor), x, y = _small_trainers()
    res = chip_smoke.check_update(torch, coalesced, per_tensor, x, y)
    assert res["small"] >= 2 and not per_tensor._small
    assert res["f64"] <= 1.0 and res["paths"] <= 1.0 and res["bf16_equal"]
    assert res["no eta"] > 1.0 and res["bf16 weight"] > 1.0


def test_lars_f64_reference_is_the_update_op():
    """The float64 formula of phase 7 (b) is the mp_sgd_mom update with
    the LARS rate, and its trust ratio is 1 where a norm is 0."""
    import torch
    from mxnet_tpu_torch.ops.registry import get_op
    g = torch.Generator()
    g.manual_seed(0)
    w32 = torch.randn(40, generator=g)
    mom = torch.randn(40, generator=g) * 1e-3
    grad = torch.randn(40, generator=g).to(torch.bfloat16)
    opt = dict(chip_smoke.NS_OPT, wd=1e-4)
    want, m64, scale = chip_smoke.lars_mp_f64(torch, w32, mom, grad, 0.1,
                                              opt)
    wn, gn = w32.double().norm(), grad.double().norm()
    lr_n = 0.1 * 0.001 * wn / (gn + 1e-4 * wn + 1e-9)
    w, m, w32c = w32.to(torch.bfloat16), mom.clone(), w32.clone()
    get_op("mp_sgd_mom_update").fn(w, grad, m, w32c, lr=float(lr_n),
                                   momentum=0.9, wd=1e-4)
    assert ((w32c.double() - want).abs() <= 2.0 ** -20 * scale).all()
    assert ((m.double() - m64).abs() <= 2.0 ** -20 * scale).all()
    zero, _, _ = chip_smoke.lars_mp_f64(torch, torch.zeros(3),
                                        torch.zeros(3), torch.ones(3),
                                        0.1, opt)
    assert torch.allclose(zero, torch.full((3,), -0.1, dtype=zero.dtype))


# phase 7's first run on an NVIDIA H100 80GB HBM3 (PERF.md): bf16 and f32
# against f64 at ResNet-50's initial weights, batch 32, in units of 2**-8
# (the loss times max(1, |loss|), the whole gradient's L2 gap), and the
# bf16 gradient of another batch
NS_LOSS_BF16, NS_LOSS_F32 = 13.2468, 1.83e-05
NS_GRAD_BF16, NS_GRAD_F32, NS_GRAD_OTHER = 103.4988, 0.03409, 363.2012


def test_bf16_limits_pass_the_measured_gaps_and_fail_another_batch():
    assert NS_LOSS_BF16 <= chip_smoke.TOL_NS_LOSS
    assert NS_LOSS_F32 <= chip_smoke.TOL_NS_LOSS / 16
    assert NS_GRAD_BF16 <= chip_smoke.TOL_NS_GRAD < NS_GRAD_OTHER
    assert NS_GRAD_F32 <= chip_smoke.TOL_NS_GRAD / 16
    import torch
    a = {"w": torch.tensor([3.0, 4.0]), "b": torch.tensor([0.0])}
    b = {"w": torch.tensor([3.0, 0.0]), "b": torch.tensor([0.0])}
    assert chip_smoke.total_l2(torch, a, b) == pytest.approx(4.0 / 3.0)


def test_bf16_check_runs_and_orders_the_gaps():
    """On the small net on the CPU: f32 sits far nearer f64 than bf16,
    and another batch's gradient is farther than either."""
    import numpy as np
    import mxnet_tpu_torch as mx
    import torch
    (tr,), x, y = _small_trainers(coalesce=(None,))
    other = mx.nd.array(np.random.RandomState(1).randn(*x.shape)
                        .astype("float32"), ctx=mx.cpu())
    gaps = chip_smoke.check_bf16_vs_f64(torch, "cpu", tr, x, y, other)
    assert gaps["grad"][1] < gaps["grad"][0] / 16 < gaps["grad"][2]
    assert gaps["loss"][1] < gaps["loss"][0]


def test_checkpoint_round_trip_of_a_resnet_trainer(monkeypatch):
    """Phase 7 (e) on a ResNet-18 of 10 classes (the phase's net, cut to
    size for the CPU)."""
    import numpy as np
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo import vision
    monkeypatch.setattr(chip_smoke, "RESNET", "resnet18_v1")
    monkeypatch.setattr(chip_smoke, "RESNET_CLASSES", 10)
    gen = torch.Generator()
    gen.manual_seed(0)
    rs = np.random.RandomState(0)
    x = mx.nd.array(rs.randn(2, 3, 32, 32).astype("float32"), ctx=mx.cpu())
    y = mx.nd.array(rs.randint(0, 10, (2,)).astype("float32"),
                    ctx=mx.cpu())
    tr = chip_smoke.ns_trainer(
        torch, mx, chip_smoke.resnet_net(mx, vision, gen, mx.cpu()),
        "lbsgd", chip_smoke.NS_OPT, torch.device("cpu"))
    tr.fit_batch(x, y)
    tr.fit_batch(x, y)
    failures = []
    chip_smoke.ns_checkpoint(torch, mx, vision, gen, mx.cpu(), tr, x, y,
                             failures)
    assert failures == []


def test_bits_tell_every_pattern_apart():
    import torch
    nan = torch.tensor([float("nan"), 0.0, -0.0])
    assert torch.equal(chip_smoke.bits(torch, nan), chip_smoke.bits(
        torch, nan.clone()))
    assert not torch.equal(chip_smoke.bits(torch, nan[1:2]),
                           chip_smoke.bits(torch, nan[2:3]))
    assert chip_smoke.bits(torch, nan.to(torch.bfloat16)).dtype == \
        torch.int16


def test_north_star_phase_raises_without_cuda(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        chip_smoke.phase_north_star(torch, "no card", 0)


# phase 4 (batch serving): the traffic loops, the coalesced-answer
# check and the phase's checks, on a small LM served on the CPU
def _served_small_lm(tmp_path, monkeypatch):
    import numpy as np
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo.transformer import \
        get_transformer_lm
    monkeypatch.setattr(chip_smoke, "VOCAB", 40)
    monkeypatch.setattr(chip_smoke, "SEQ", 16)
    net = get_transformer_lm(vocab=40, dim=32, heads=4, layers=2,
                             max_seq=32, prefix="p4_")
    net.initialize(ctx=mx.cpu())
    net.hybridize()
    net(mx.nd.array(np.zeros((1, 16), "float32"), ctx=mx.cpu()))
    net.export(str(tmp_path / "lm"), 0)
    reg = mx.serve.ModelRegistry()
    pred = reg.load_checkpoint(
        "lm", str(tmp_path / "lm"), 0, data_shapes={"data0": (1, 16)},
        ladder=mx.serve.BucketLadder(batches=(1, 2, 4, 8), seq_axes={1: 8},
                                     seq_max={1: 16}), ctx=mx.cpu())
    return reg, pred


def _plain_eval(pred):
    from mxnet_tpu_torch.executor import _build_eval
    from mxnet_tpu_torch.ops import attention as att

    def plain(query, key, value, causal=False, sm_scale=None, chunk=512):
        return att._chunked_attention(query, key, value, bool(causal),
                                      sm_scale, chunk)
    return _build_eval(pred._symbol, False, op_impls={
        "_contrib_DotProductAttention": plain})


def test_serve_traffic_coalesces_and_checks_pass(tmp_path, monkeypatch):
    """The closed and open loops through ``registry.submit`` on the CPU:
    every request is answered and digested, batches carry whole
    requests, each coalesced answer is bit-equal to predict of its
    stacked batch and within TOL_SERVE of the plain-attention graph —
    and a corrupted answer, or a graph outside the limit, fails."""
    import numpy as np
    import torch
    reg, pred = _served_small_lm(tmp_path, monkeypatch)
    try:
        reg.batcher("lm", max_wait_ms=50)
        rng = np.random.RandomState(0)
        ev = _plain_eval(pred)
        for loop in ("closed", "open"):
            xs = chip_smoke.request_tokens(rng, 12, seq=16)
            assert {x.shape[1] for x in xs} == {16}
            assert 1 <= min(len(x) for x in xs) <= max(len(x) for x in xs) \
                <= chip_smoke.MAX_ROWS
            batches, restore = chip_smoke.record_batches(pred)
            answers = chip_smoke.Answers(len(xs))
            if loop == "closed":
                wall = chip_smoke.closed_loop(reg, "lm", xs, 4, answers)
                records = answers.wait()
            else:
                wall = chip_smoke.open_loop(reg, "lm", xs, 200.0, answers)
                records = answers.records
            restore()
            assert "predict" not in pred.__dict__
            assert all(r is not None for r in records)
            assert [r["rows"] for r in records] == [len(x) for x in xs]
            st = chip_smoke.traffic_stats(records, wall, seq=16)
            assert st["requests"] == 12 and st["rows"] == sum(map(len, xs))
            assert st["p50_ms"] > 0 and st["tokens_s"] > 0
            assert st["p99_ms"] is None         # 12 requests: too few
            assert sum(len(b) for b in batches) == st["rows"]
            seen = sorted(i for b in batches
                          for i, _ in chip_smoke.batch_members(b, xs))
            assert seen == list(range(12))
            chk = chip_smoke.check_coalesced(torch, pred, ev, batches, xs,
                                              records)
            assert chk["bit_equal"] and chk["worst"] <= 1.0
            assert 0 < chk["occupancy"] <= 1.0
        records[0] = dict(records[0], crc=records[0]["crc"] ^ 1)
        chk = chip_smoke.check_coalesced(torch, pred, ev, batches, xs,
                                          records)
        assert not chk["bit_equal"] and chk["worst"] <= 1.0
        records[0] = dict(records[0], crc=records[0]["crc"] ^ 1)

        def off(amap, aux):
            outs, upd = ev(amap, aux)
            return [outs[0] + 1.0], upd
        chk = chip_smoke.check_coalesced(torch, pred, off, batches, xs,
                                          records)
        assert chk["bit_equal"] and chk["worst"] > 1.0
    finally:
        reg.close()


def test_answers_digest_every_row_and_re_raise():
    """A record holds the latency, rows and CRC-32 of the answer's bytes;
    a failed answer is re-raised by ``wait``."""
    import zlib
    import numpy as np

    class Fut:
        def __init__(self, out=None, exc=None):
            self._out, self._exc = out, exc
            self._t_enq, self._t_resolved = 1.0, 1.25

        def result(self, timeout=None):
            if self._exc:
                raise self._exc
            return [self._out]

    out = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    answers = chip_smoke.Answers(2)
    answers.add(1, Fut(out[1:]))
    rec = answers.wait()
    assert rec[0] is None
    assert rec[1] == {"latency": 0.25, "resolved": 1.25, "rows": 1,
                      "crc": zlib.crc32(out[1:].tobytes())}
    answers = chip_smoke.Answers(1)
    answers.add(0, Fut(exc=KeyError("lost")))
    with pytest.raises(KeyError):
        answers.wait()


def test_p99_is_reported_from_a_sample_of_100_requests():
    recs = [{"latency": i / 1e3, "rows": 1} for i in range(1, 101)]
    st = chip_smoke.traffic_stats(recs, 10.0, seq=16)
    assert st["p99_ms"] == pytest.approx(99.0) and st["p50_ms"] == \
        pytest.approx(50.0)
    assert chip_smoke.traffic_stats(recs[:99], 10.0, seq=16)["p99_ms"] \
        is None


def test_batch_members_refuses_rows_of_no_request():
    import numpy as np
    xs = [np.full((2, 3), 1.0), np.full((1, 3), 2.0)]
    stacked = np.concatenate([xs[1], xs[0]])
    assert chip_smoke.batch_members(stacked, xs) == [(1, 0), (0, 1)]
    with pytest.raises(RuntimeError, match="no request"):
        chip_smoke.batch_members(np.full((1, 3), 5.0), xs)
    with pytest.raises(RuntimeError, match="no request"):
        chip_smoke.batch_members(np.concatenate([xs[0][:1], xs[1]]), xs)


def test_percentile_by_nearest_rank():
    vals = [5.0, 1.0, 3.0, 2.0, 4.0]
    assert chip_smoke.percentile(vals, 50) == 3.0
    assert chip_smoke.percentile(vals, 99) == 5.0
    assert chip_smoke.percentile([7.0], 1) == 7.0


def _good_serve_record():
    L = chip_smoke.LAYERS
    return {"closed_batches": 12, "closed_requests": 32,
            "compiles_warm": 4, "compiles_after": 5, "unresolved": 0,
            "captured": {b: {"flash_fwd": L} for b in chip_smoke.RUNGS},
            "graph_launches": L * 30, "replays": 30, "dispatches": 30,
            "traffic_wrapper": L, "traffic_captured": L,
            "bit_equal_closed": True,
            "bit_equal_open": True, "worst_closed": 0.1, "worst_open": 0.1,
            "worst_direct": 0.1, "worst_graph_eager": 0.0,
            "pad_ratio": 0.05, "profile_flash_fwd": 0.15}


@pytest.mark.parametrize("fault,value", [
    ("closed_batches", 32), ("compiles_after", 6), ("compiles_after", 4),
    ("unresolved", 1), ("captured", {1: {"flash_fwd": 11}}),
    ("graph_launches", 12 * 29), ("replays", 31), ("traffic_wrapper", 24),
    ("traffic_captured", 0),
    ("bit_equal_closed", False), ("bit_equal_open", False),
    ("worst_closed", 1.5), ("worst_open", float("nan")),
    ("worst_direct", 2.0), ("worst_graph_eager", 1.01), ("pad_ratio", 3.0),
    ("profile_flash_fwd", 0.0)])
def test_serve_checks_are_wired(fault, value):
    """Each of phase 4's checks fails the phase on its own."""
    rec = _good_serve_record()
    assert chip_smoke.serve_failures(rec) == []
    rec[fault] = value
    assert len(chip_smoke.serve_failures(rec)) == 1


def test_serve_phase_raises_without_cuda(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        chip_smoke.phase_serve(torch, "no card", 0)


def test_last_lines_are_the_kernels_and_the_contract(monkeypatch, capsys):
    """With every phase stubbed, ``main`` prints the kernels line with
    the batched-serving launches, then exactly the contract's line."""
    import json
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "card")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(sys, "argv", ["chip_smoke.py"])
    row = {"max_abs_err": 0.0, "ms": 1.0, "plain_ms": 2.0, "bound_ms": 0.5,
           "bound_by": "operations", "library_ms": 1.5, "library": "x"}
    kernels = ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq")
    stub = {
        "phase_device": lambda t: "card, 700.00 W",
        "phase_build": lambda: {},
        "phase_kernel": lambda t, c, s: {(k, d): dict(row) for k in kernels
                                         for d in ("float32", "bfloat16")},
        "phase_serve": lambda t, c, s: {"eager": 72, "direct": 108,
                                        "traffic": 420},
        "phase_train": lambda t, c, s: {k: 60 for k in kernels},
        "phase_resnet": lambda t, c, s: None,
        "phase_north_star": lambda t, c, s: {k: 60 for k in kernels},
        "phase_decode": lambda t, c, s: 552,
        "phase_user_surface": lambda t, c, s: {k: 72 for k in kernels},
        "phase_module": lambda t, c, s: {"launches": {k: 240
                                                      for k in kernels}},
        "phase_lstm": lambda t, c, s: {},
        "phase_data": lambda t, c, s: {},
        "phase_quant": lambda t, c, s: {"lm": {
            "int8": {"launches": {"eager": 96, "graph": 300}},
            "int8-weight-only": {"launches": {"eager": 84, "graph": 240}}}},
        "phase_fleet": lambda t, c, s: {"launches": {"wrapper": 36,
                                                     "graph": 1500}}}
    for name, fn in stub.items():
        monkeypatch.setattr(chip_smoke, name, fn)
    assert chip_smoke.main() == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == {"ok": True, "device": {
        "platform": "gpu", "kind": "card", "count": 1}}
    fwd = json.loads(lines[-2])["kernels"][0]
    assert fwd["name"] == "flash_fwd"
    assert fwd["launches_by_path"]["batched serve (graph replays: "
                                   "traffic dispatches)"] == 420
    assert fwd["launches_by_path"]["decode prefill"] == 552
    assert fwd["launches_by_path"][
        "user-surface LM train (eager nd, adam)"] == 72
    assert fwd["launches_by_path"][chip_smoke.MODULE_PATH] == 240
    assert fwd["launches_by_path"][
        "quantized LM serve (eager: calibration, warm-ups)"] == 96 + 84
    assert fwd["launches_by_path"][
        "quantized LM serve (graph replays: gate, traffic, checks)"] == \
        300 + 240
    assert fwd["launches_by_path"][
        chip_smoke.FLEET_PATH + ", eager: warm-ups"] == 36
    assert fwd["launches_by_path"][
        chip_smoke.FLEET_PATH + ", graph replays"] == 1500
    assert fwd["launches"] == 72 + 108 + 420 + 60 + 60 + 552 + 72 + 240 + \
        96 + 84 + 300 + 240 + 36 + 1500
    for k in json.loads(lines[-2])["kernels"][1:]:
        assert k["launches"] == 60 + 60 + 72 + 240
    for k in json.loads(lines[-2])["kernels"]:
        assert {"name", "route", "source", "replaces", "launches",
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms"} <= set(k)


# phase 8 (paged decode), on a small LM served on the CPU
DEC_CFG = dict(vocab=97, dim=64, heads=4, layers=2, max_seq=128,
               prefix="p8_")
DEC_TOL = 1e-5     # x max(1, max |logit|): f32 summation order only


@pytest.fixture(scope="module")
def decode_lm(tmp_path_factory):
    """The JAX LM and the port's predictor serving the same weights (from
    the port's export)."""
    import numpy as np
    import mxnet_tpu as jmx
    import mxnet_tpu_torch as mx
    from mxnet_tpu.gluon.model_zoo.transformer import \
        get_transformer_lm as jax_lm
    from mxnet_tpu_torch.gluon import load_jax_params
    from mxnet_tpu_torch.gluon.model_zoo.transformer import \
        get_transformer_lm
    x = np.zeros((1, 16), "float32")
    jnet = jax_lm(**DEC_CFG)
    jnet.initialize(ctx=jmx.cpu())
    jnet.hybridize()
    jnet(jmx.nd.array(x))
    net = get_transformer_lm(**DEC_CFG)
    net.initialize(ctx=mx.cpu())
    load_jax_params(net, {k: v.data().asnumpy()
                          for k, v in jnet.collect_params().items()})
    net.hybridize()
    net(mx.nd.array(x, ctx=mx.cpu()))
    prefix = str(tmp_path_factory.mktemp("decode") / "lm")
    net.export(prefix, 0)
    reg = mx.serve.ModelRegistry()
    pred = reg.load_checkpoint(
        "lm", prefix, 0, data_shapes={"data0": (1, 64)},
        ladder=mx.serve.BucketLadder(batches=(1,)), ctx=mx.cpu(),
        warm=False)
    yield jnet, pred
    reg.close()


def _decode_engine(pred):
    import torch
    import mxnet_tpu_torch as mx
    step, prefill, token_spec, input_spec = chip_smoke.lm_decode_fns(
        torch, pred, DEC_CFG["heads"])
    eng = pred.make_paged_decoder(
        step, prefill, token_spec, input_spec, max_len=64, block_size=16,
        num_blocks=9, session_rungs=(1, 2), prefill_rungs=(16, 32, 64))
    return eng, mx.serve.DecodeBatcher(eng, max_wait_ms=100.0), step


def test_decode_step_logits_match_the_jax_forward(decode_lm):
    """The step, fed 40 tokens one at a time through a dense decoder,
    gives the JAX TransformerLM's logits at every position."""
    import numpy as np
    import torch
    import mxnet_tpu as jmx
    jnet, pred = decode_lm
    step_l, _, _, _ = chip_smoke.lm_decode_fns(torch, pred, DEC_CFG["heads"],
                                               with_logits=True)
    toks = np.random.RandomState(0).randint(0, DEC_CFG["vocab"], 40)
    got = chip_smoke.dense_logits(torch, chip_smoke.dense_decoder(
        torch, pred, step_l, 64, DEC_CFG["heads"]), toks).numpy()
    want = jnet(jmx.nd.array(toks[None].astype("float32"))).asnumpy()[0]
    scale = max(1.0, np.abs(want).max())
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= DEC_TOL * scale
    fwd = chip_smoke.forward_logits(pred, toks).numpy()
    assert np.abs(fwd - want).max() <= DEC_TOL * scale


def test_decode_paged_streams_and_nan_garbage(decode_lm):
    """Paged streams (prefill through the model's graph, batched ticks)
    equal the dense decoder's; a prompt with ids past the table and
    below zero gets NaN logits and the argmax over NaN, its freed blocks
    hold NaN, and the same sessions served again on them — and again
    after every free block is filled with NaN by hand — are unchanged."""
    import numpy as np
    import torch
    jnet, pred = decode_lm
    eng, bat, step = _decode_engine(pred)
    heads, vocab = DEC_CFG["heads"], DEC_CFG["vocab"]
    rs = np.random.RandomState(1)
    prompts = [rs.randint(0, vocab, 20).astype(np.int32) for _ in range(2)]
    first, _ = chip_smoke.serve_streams(bat, prompts, 12)
    assert first == [chip_smoke.dense_stream(chip_smoke.dense_decoder(
        torch, pred, step, 64, heads), p, 12) for p in prompts]
    bad = prompts[0].copy()
    bad[3], bad[5] = vocab, -1
    (bad_stream,), (bad_sess,) = chip_smoke.serve_streams(bat, [bad], 12)
    assert bad_stream == [0] * 12         # argmax over NaN logits
    blocks = [int(b) for b in bad_sess.table if b]
    assert bool(torch.isnan(eng.pool.arrays["k"][blocks]).any())
    again, sess = chip_smoke.serve_streams(bat, prompts, 12)
    assert again == first
    assert set(blocks) & {int(b) for s in sess for b in s.table if b}
    with eng._lock:
        for a in eng.pool.arrays.values():
            a.fill_(float("nan"))
    assert chip_smoke.serve_streams(bat, prompts, 12)[0] == first
    assert eng.pool.blocks_in_use == 0
    bat.close()
    eng.close()


def _good_decode_record():
    L = chip_smoke.LAYERS
    return {"layers": L, "session_errors": [], "tokens": 5000,
            "tokens_asked": 5000, "compiles_before": 12,
            "compiles_after": 12, "blocks_in_use": 0, "mean_sessions": 9.5,
            "tick_captured": {},
            "prefill_captured": {r: {"flash_fwd": L}
                                 for r in chip_smoke.DEC_PREFILL_RUNGS},
            "traffic_wrapper": 0, "traffic_prefill_graph": L * 32,
            "prefills": 32, "logits_ratio": 0.05,
            "divergences": [None, (3, 1e-4, 2e-4, 5e-3), None, None],
            "bad_nan_logits": True, "bad_stream": [0] * 32,
            "bad_expected": [0] * 32, "poisoned_blocks": [7, 8],
            "reused_blocks": [7], "after_bad_equal": True,
            "prefill_launches": 552}


@pytest.mark.parametrize("fault,value", [
    ("session_errors", ["ServeError: x"]), ("tokens", 4999),
    ("compiles_after", 13), ("blocks_in_use", 1), ("mean_sessions", 1.0),
    ("tick_captured", {1: {"flash_fwd": 12}}),
    ("prefill_captured", {16: {}}), ("traffic_wrapper", 12),
    ("traffic_prefill_graph", 12 * 31), ("logits_ratio", 1.5),
    ("divergences", [(3, 6e-3, 1e-4, 5e-3)]),
    ("divergences", [(3, 1e-4, 6e-3, 5e-3)]),
    ("bad_nan_logits", False), ("bad_stream", [1] * 32),
    ("poisoned_blocks", []), ("reused_blocks", []),
    ("after_bad_equal", False), ("prefill_launches", 0)])
def test_decode_checks_are_wired(fault, value):
    """Each of phase 8's checks fails the phase on its own."""
    rec = _good_decode_record()
    assert chip_smoke.decode_failures(rec) == []
    rec[fault] = value
    assert len(chip_smoke.decode_failures(rec)) == 1


def test_decode_phase_raises_without_cuda(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        chip_smoke.phase_decode(torch, "no card", 0)


# phase 9 (the eager user surface)
def test_op_sweep_passes_with_the_cpu_for_both_devices():
    import torch
    import mxnet_tpu_torch as mx
    worst = chip_smoke.op_sweep(torch, mx, "cpu", 0,
                                devices=(mx.cpu(), mx.cpu()), draws=20000)
    assert worst == 0.0


def test_op_sweep_fails_a_case_that_differs(monkeypatch):
    import numpy as np
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import registry as reg
    calls = []
    op = reg.get_op("sin")
    fn = op.fn

    def drifting(x):
        calls.append(1)
        return fn(x) * (1 + 1e-3 * (len(calls) % 2))
    monkeypatch.setattr(op, "fn", drifting)
    with pytest.raises(RuntimeError, match="sin: .* of the limit"):
        chip_smoke.op_sweep(torch, mx, "cpu", 0,
                            devices=(mx.cpu(), mx.cpu()), draws=20000)
    a = np.array([1.0, np.nan])
    assert chip_smoke.sweep_equal(np, a, a.copy())
    assert not chip_smoke.sweep_equal(np, a, np.array([1.0, 2.0]))


def test_user_surface_phase_raises_without_cuda(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        chip_smoke.phase_user_surface(torch, "no card", 0)


MODULE_CFG = (50, 32, 4, 2, 32)


def test_module_phase_runs_on_the_cpu():
    import torch
    import mxnet_tpu_torch as mx
    rec = chip_smoke.phase_module(torch, "cpu", 0, cfg=MODULE_CFG,
                                  ctx=mx.cpu(), batch=2)
    assert rec["check"]["gap"] <= 1e-5 * max(1.0, rec["check"]["loss"])
    assert rec["bits"][0] == 0 and rec["bits"][3] == 0.0
    assert rec["checkpoint"] == (0, 0.0)
    fit = rec["fit"]
    assert len(fit["losses"]) == chip_smoke.MODULE_BATCHES
    assert fit["losses"][-1] < fit["losses"][0]
    assert abs(fit["score"] - fit["recomputed"]) <= \
        chip_smoke.TOL_SCORE * fit["recomputed"]


@pytest.mark.parametrize("fault", ["bits", "scatter", "loss", "first",
                                   "score", "checkpoint"])
def test_module_checks_are_wired(monkeypatch, fault):
    """Each check of phase 10 fails the phase when its numbers break."""
    import torch
    import mxnet_tpu_torch as mx
    monkeypatch.setattr(chip_smoke, "MODULE_WARM", 1)
    monkeypatch.setattr(chip_smoke, "MODULE_TIMED", 1)
    if fault == "bits":
        real_steps = chip_smoke.module_fused_vs_legacy

        def one_bit(*a):
            steps = real_steps(*a)
            name = sorted(n for n in steps[True] if "embedding" not in n)[0]
            steps[True][name] = steps[True][name].clone()
            steps[True][name].view(-1)[0] += 1.0
            return steps
        monkeypatch.setattr(chip_smoke, "module_fused_vs_legacy", one_bit)
    elif fault == "scatter":
        real_steps = chip_smoke.module_fused_vs_legacy

        def table_moved(*a):
            steps = real_steps(*a)
            name = "modlm_embedding0_weight"
            steps[True][name] = steps[True][name] * (1 + 2.0 ** -14)
            return steps
        monkeypatch.setattr(chip_smoke, "module_fused_vs_legacy",
                            table_moved)
    elif fault == "loss":
        real = chip_smoke.module_fit

        def rising(*a):
            out = list(real(*a))
            out[0] = sorted(out[0])
            return tuple(out)
        monkeypatch.setattr(chip_smoke, "module_fit", rising)
    elif fault == "first":
        real = chip_smoke.module_fit

        def moved_first(*a):
            out = list(real(*a))
            out[0] = [out[0][0] + 1e-3] + out[0][1:]
            return tuple(out)
        monkeypatch.setattr(chip_smoke, "module_fit", moved_first)
    elif fault == "score":
        real = chip_smoke.module_fit

        def off(*a):
            out = real(*a)
            return out[:4] + (out[4] * (1 + 1e-6),)
        monkeypatch.setattr(chip_smoke, "module_fit", off)
    else:
        real = chip_smoke.module_checkpoint

        def moved(*a):
            want = real(*a)
            name = sorted(want)[0]
            want[name] = want[name] + 1.0
            return want
        monkeypatch.setattr(chip_smoke, "module_checkpoint", moved)
    message = {"bits": "not the legacy step",
               "scatter": "not the legacy step", "loss": "did not fall",
               "first": "is not the check step's",
               "score": "is not the perplexity",
               "checkpoint": "not the original's"}[fault]
    with pytest.raises(RuntimeError, match=message):
        chip_smoke.phase_module(torch, "cpu", 0, cfg=MODULE_CFG,
                                ctx=mx.cpu(), batch=2)


def test_module_phase_raises_without_cuda(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        chip_smoke.phase_module(torch, "no card", 0)


# phase 11 (recurrent networks) at a small size on the CPU
LSTM_SMALL = dict(lstm_cfg=(50, 16, 2, 12), bucket_cfg=(30, 16, 8, 2),
                  sentences=(320, 256), op_shape=(6, 2, 3, 4),
                  op_dtypes=("float32",))


def _lstm_phase(monkeypatch):
    import torch
    import mxnet_tpu_torch as mx
    # the bucketing loop's few small batches need a larger step to move
    monkeypatch.setattr(chip_smoke, "BUCKET_LR", 0.02)
    return chip_smoke.phase_lstm(torch, "cpu", 0, ctx=mx.cpu(),
                                 **LSTM_SMALL)


def test_lstm_phase_runs_on_the_cpu(monkeypatch):
    rec = _lstm_phase(monkeypatch)
    assert len(rec["op"]) == len(chip_smoke.RNN_CASES)
    assert all(r["relaunch_equal"] and r["ratio"] == 0.0
               for r in rec["op"])
    assert rec["control_flow"]["differ"] == 0
    lm = rec["lm"]
    assert lm["f32_loss"][1] < lm["f32_loss"][0]
    assert lm["routes"] == {"cudnn": 0, "plain": chip_smoke.LSTM_STEPS}
    b = rec["bucketing"]
    assert b["last"] < b["first"] and sorted(b["binds"]) == [8, 12, 16, 20]
    assert b["checkpoint"][0] == 0
    assert abs(b["score"] - b["recomputed"]) <= \
        chip_smoke.TOL_SCORE * b["recomputed"]


@pytest.mark.parametrize("fault", ["op", "fall", "routes", "score",
                                   "checkpoint"])
def test_lstm_checks_are_wired(monkeypatch, fault):
    """Each check of phase 11 fails the phase when its numbers break."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import rnn as rnn_op
    if fault == "op":
        monkeypatch.setattr(chip_smoke, "rnn_worst", lambda *a: 1.0)
    elif fault == "fall":
        real = chip_smoke.lstm_f32_loss
        calls = []

        def loss(*a):
            calls.append(1)
            return real(*a) + (1.0 if len(calls) == 2 else 0.0)
        monkeypatch.setattr(chip_smoke, "lstm_f32_loss", loss)
    elif fault == "routes":
        # the op takes the library route on the CPU: not what (b) expects
        monkeypatch.setattr(rnn_op, "route_of", lambda data: "cudnn")
    elif fault == "score":
        real = mx.mod.BucketingModule.score

        def off(self, *a, **kw):
            return [(n, v * (1 + 1e-6)) for n, v in real(self, *a, **kw)]
        monkeypatch.setattr(mx.mod.BucketingModule, "score", off)
    else:
        monkeypatch.setattr(chip_smoke, "bucket_checkpoint",
                            lambda *a: (1, 10, 0.0))
    message = {"op": "lstm \\(a\\)", "fall": "did not fall",
               "routes": "calls by route", "score": "is not the perplexity",
               "checkpoint": "not the original's"}[fault]
    with pytest.raises(RuntimeError, match=message):
        _lstm_phase(monkeypatch)


# phase 11's first passing run on an NVIDIA H100 80GB HBM3 (PERF.md): the
# op's worst error over its cases as a share of its limit, f32 and bf16;
# the least TF32 f32 error and the least bf16 error in units of the f32
# limit
RNN_F32, RNN_BF16, RNN_TF32_LEAST, RNN_BF16_IN_F32_LEAST = \
    0.3552, 0.4512, 6.20, 40.3


def test_rnn_limits_pass_the_measured_gaps_and_fail_tf32():
    assert RNN_F32 <= 1.0 and RNN_BF16 <= 1.0
    assert RNN_TF32_LEAST > 1.0 and RNN_BF16_IN_F32_LEAST > 1.0
    assert chip_smoke.TOL_RNN["bfloat16"] == 2.0 ** -7
    # a bf16 rounding moves a value by at most half an ulp, 2**-8 of it:
    # within the bf16 limit, and far outside the f32 one
    import torch
    v = torch.tensor([1.0 + 2.0 ** -8 - 2.0 ** -20, 1.5, 0.7])
    err = float(((v.to(torch.bfloat16).float() - v).abs() /
                 v.abs().max()).max())
    assert err <= chip_smoke.TOL_RNN["bfloat16"]
    assert err > chip_smoke.TOL_RNN["float32"]


def test_lstm_phase_raises_without_cuda(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        chip_smoke.phase_lstm(torch, "no card", 0)


# phase 12 (the data path) at a small size on the CPU
DATA_SMALL = dict(n=48, sides=(36, 60), image=32, batch=8, classes=10,
                  net_kw={"name": "resnet18_v1", "classes": 10,
                          "thumbnail": True}, workers=2)


def test_data_phase_runs_on_the_cpu():
    import torch
    import mxnet_tpu_torch as mx
    rec = chip_smoke.phase_data(torch, "cpu", 0, ctx=mx.cpu(), **DATA_SMALL)
    assert rec["route"] == "libjpeg"
    assert all(c["repeat_equal"] for c in rec["checks"].values())
    assert rec["checks"]["resize 0, centre crop"]["max"] == 0
    assert rec["checks"]["resize 0, random crop and mirror"]["max"] == 0
    main = rec["main"]
    for depth in (2, 0):
        assert main[depth]["batches"] == 6 and main[depth]["routes"][
            "chain"] == 0
    # the same weights, the same records and crops: the same losses
    assert main[2]["loss"] == main[0]["loss"]
    assert main[2]["stalled"] <= len(main[2]["stamps"])
    p = rec["parity"]
    assert all(v["batches_equal"] and not v["differ"]
               for k, v in p.items() if isinstance(v, dict))
    assert p["aux_moved"] == p["aux"] > 0
    assert rec["gluon"]["workers_equal"] and rec["gluon"]["payload"] == \
        "JPEG"


def test_plain_geometry_is_the_routes_geometry():
    """chip_smoke's plain version of the team's geometry (phase 12 (c))
    against the route's (io/native_decode.augment_decoded) on random
    images: equal but for the bilinear's rounding, where the plain
    version interpolates in float32."""
    import numpy as np
    import torch
    from mxnet_tpu_torch.io import native_decode
    rs = np.random.RandomState(0)
    for i in range(12):
        h, w = (int(v) for v in rs.randint(30, 140, 2))
        img = torch.from_numpy(rs.randint(0, 256, (h, w, 3)).astype(
            np.uint8))
        seed = int(rs.randint(1, 2 ** 62))
        for resize in (0, 20, 40):
            args = (seed, resize, 24, 20, bool(i % 2), bool(i % 3))
            got = native_decode.augment_decoded(img, *args)
            want = chip_smoke.plain_geometry(torch, img, *args)
            d = (got.to(torch.int32) - want.to(torch.int32)).abs()
            assert tuple(got.shape) == tuple(want.shape) == (24, 20, 3)
            assert int(d.max()) <= (0 if resize == 0 and min(h, w) < 48
                                    else 1)


@pytest.mark.parametrize("fault", ["decode", "chain", "parity", "aux",
                                   "workers"])
def test_data_checks_are_wired(monkeypatch, fault):
    """Each check of phase 12 fails the phase when its numbers break (the
    training steps stubbed where the fault is elsewhere)."""
    import torch
    import mxnet_tpu_torch as mx
    good_parity = {"prefetch 2": {"batches_equal": True, "differ": []},
                   "aux_moved": 4, "aux": 4}
    monkeypatch.setattr(chip_smoke, "data_main_path", lambda *a: {})
    monkeypatch.setattr(chip_smoke, "data_parity", lambda *a: dict(
        good_parity))
    monkeypatch.setattr(chip_smoke, "data_gluon", lambda *a, **k: {
        "workers_equal": True, "pinned": None})
    if fault == "decode":
        real = chip_smoke.data_decode_checks

        def moved(*a):
            out = real(*a)
            out["resize 0, centre crop"]["max"] = 1
            return out
        monkeypatch.setattr(chip_smoke, "data_decode_checks", moved)
    elif fault == "chain":
        monkeypatch.setattr(chip_smoke, "data_decode_rate", lambda *a: (
            1.0, 1.0, 6, {"native": 5, "chain": 1}))
    elif fault == "parity":
        monkeypatch.setattr(chip_smoke, "data_parity", lambda *a: dict(
            good_parity, **{"prefetch 2": {"batches_equal": True,
                                           "differ": ["arg fc_weight"]}}))
    elif fault == "aux":
        monkeypatch.setattr(chip_smoke, "data_parity", lambda *a: dict(
            good_parity, aux_moved=3))
    else:
        monkeypatch.setattr(chip_smoke, "data_gluon", lambda *a, **k: {
            "workers_equal": False, "pinned": None})
    message = {"decode": "\\(c\\) resize 0", "chain": "took the chain",
               "parity": "\\(f\\) prefetch 2", "aux": "did not move",
               "workers": "differ from num_workers"}[fault]
    with pytest.raises(RuntimeError, match=message):
        chip_smoke.phase_data(torch, "cpu", 0, ctx=mx.cpu(), **DATA_SMALL)


def test_data_phase_raises_without_cuda(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        chip_smoke.phase_data(torch, "no card", 0)


# phase 13 (int8 serving and tuning) at a small size on the CPU, where the
# served answers and the "CPU run" come from one device: their limit is
# 1e-6, below every small model's int8 (and weight-only) distance from fp32
QUANT_CPU_LIMIT = {"int8": 1e-6, "int8-weight-only": 1e-6}
QUANT_ARGMAX = {"int8": 0.99, "int8-weight-only": 0.99}
QUANT_SMALL = dict(
    resnet=dict(model="resnet18_v1", classes=10, image=32, rungs=(1, 2, 4),
                calib=(2, 4), check_rows=(1, 2), traffic=(3, 6, 4, 200.0),
                layers=21, cpu_limit=QUANT_CPU_LIMIT, argmax=QUANT_ARGMAX),
    lm=dict(cfg=(97, 128, 4, 2, 32), rungs=(1, 2, 4), seq_axes={1: 16},
            calib=(2, 2), check_seq=16, traffic=(3, 6, 2, 200.0),
            cpu_limit=QUANT_CPU_LIMIT, argmax=QUANT_ARGMAX),
    tune_spec=dict(rate=60.0, seconds=0.3, rows=(1, 2), max_rows=4,
                   ladders=((1, 2, 4), (1, 4), (2, 4)), trials=2,
                   neighbor_trials=1))


@pytest.fixture
def one_thread():
    """Phase 13's CPU cases in one torch thread: the suite runs beside
    other workers, and many threads each would oversubscribe the cores."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the wiring cases: phase 13 (a) in int8 only, at two rungs
QUANT_WIRING = dict(QUANT_SMALL["resnet"], modes=("int8",), rungs=(1, 2),
                    calib=(1, 4), check_rows=(2,), traffic=(3, 4, 2, 200.0))


def test_quant_phase_runs_on_the_cpu(one_thread):
    import torch
    import mxnet_tpu_torch as mx
    rec = chip_smoke.phase_quant(torch, "cpu", 0, ctx=mx.cpu(),
                                 **QUANT_SMALL)
    for mode in ("int8", "int8-weight-only"):
        r = rec["resnet"][mode]
        assert r["covered"] == 21
        assert sorted(r["rungs"]) == [1, 2, 4]
        for row in r["rungs"].values():
            key = "int8_products" if mode == "int8" else "int8_dequantized"
            assert row["work"][key] == 21
        assert all(c["rel"] == 0.0 and c["products_equal"] ==
                   c["products"] for c in r["cpu"])
        for c in r["cpu"] + rec["lm"][mode]["cpu"]:
            nodes = c["nodes"]
            assert nodes["codes"][0] == nodes["codes"][1]
            assert nodes["codes"][2] == 0
            assert nodes["dequantized"][0] == nodes["dequantized"][1] > 0
            assert c["fp32_rel"] > c["limit"]
        assert rec["lm"][mode]["traffic"]["builds"] == 0
    for model in ("resnet", "lm"):
        for row in rec[model]["int8"]["rungs"].values():
            # on the CPU no conv pads its int8 input: the counts are exact
            assert row["byte_ratio"] == pytest.approx(
                row["shape_byte_ratio"], rel=1e-12)
            assert row["byte_ratio"] > 1.0
    assert rec["lm"]["int8"]["cpu"][0]["plain_attention_rel"] == 0.0
    assert rec["tune"]["device_kind"] == "cpu"
    assert rec["lm"]["verdicts"]["int8"] == "pass"


def _quant_resnet(torch, mx, tmp_path, spec=QUANT_WIRING):
    import numpy as np
    failures = []
    gen = torch.Generator().manual_seed(0)
    rec, sym, args, aux = chip_smoke.quant_resnet(
        torch, np, mx, mx.cpu(), gen, np.random.RandomState(0), spec,
        str(tmp_path), failures)
    return failures, (sym, args, aux)


@pytest.mark.parametrize("fault", ["products", "float", "bytes", "cpu",
                                   "product", "codes", "dequantized",
                                   "fp32", "traffic", "covered"])
def test_quant_checks_are_wired(monkeypatch, tmp_path, one_thread, fault):
    """Each check of phase 13 (a) fails the phase when its numbers break."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import quantize
    real_work = quantize.int8_work
    if fault in ("products", "float", "bytes"):
        def work(pred, b):
            w = dict(real_work(pred, b))
            if pred.quantization is not None:
                if fault == "products":
                    w["int8_products"] = w["int8_dequantized"] = 0
                elif fault == "float":
                    w["float_products"] = 1
                else:
                    w["compute_bytes"] *= 100
            return w
        monkeypatch.setattr(quantize, "int8_work", work)
    elif fault == "cpu":
        real = chip_smoke.cpu_outputs

        def moved(*a):
            outs, products = real(*a)
            return [o + 1e3 * abs(o).max() for o in outs], products
        monkeypatch.setattr(chip_smoke, "cpu_outputs", moved)
    elif fault in ("product", "codes", "dequantized"):
        real = chip_smoke.cpu_outputs
        ops = {"product": chip_smoke.Q_PRODUCTS,
               "codes": ("_contrib_quantize",),
               "dequantized": ("_contrib_dequantize",)}[fault]

        def one_off(*a):
            outs, nodes = real(*a)
            last = max(i for i, n in enumerate(nodes) if n[0] in ops)
            op, fn, ins, params, want = nodes[last]
            # a product one off; two codes apart; a value 1e-5 off
            want = want + {"product": 1, "codes": 2}.get(
                fault, 1e-5 * float(want.abs().max()))
            nodes[last] = (op, fn, ins, params, want)
            return outs, nodes
        monkeypatch.setattr(chip_smoke, "cpu_outputs", one_off)
    elif fault == "fp32":
        # a limit no lower than int8's own distance from fp32
        monkeypatch.setitem(QUANT_WIRING, "cpu_limit", {"int8": 1.0})
    elif fault == "traffic":
        monkeypatch.setattr(chip_smoke, "record_batches", lambda pred: (
            [None] * 100, lambda: None))
    else:
        monkeypatch.setitem(QUANT_WIRING, "layers", 22)
    failures, _ = _quant_resnet(torch, mx, tmp_path)
    message = {"products": "no int8 products", "float": "float products",
               "bytes": "the shapes give", "cpu": "against the CPU run",
               "product": "bit-equal 20 of 21",
               "codes": "in 20 of 21 nodes",
               "dequantized": "in 20 of 21 nodes",
               "fp32": "not below the int8 answers' distance",
               "traffic": "batches for", "covered": "layers covered"}[fault]
    assert any(message in f for f in failures), failures


def _tiny_image_model(mx):
    """A one-conv, one-fc image model: (symbol, args, aux, data shape)."""
    import numpy as np
    data = mx.sym.var("data0")
    net = mx.sym.Convolution(data, kernel=(3, 3), num_filter=4, name="tc")
    net = mx.sym.FullyConnected(mx.sym.relu(net), num_hidden=5, name="tf")
    shape = (1, 3, 8, 8)
    rs = np.random.RandomState(0)
    args = {n: mx.nd.array(rs.randn(*s).astype("float32") * 0.3,
                           ctx=mx.cpu())
            for n, s in zip(net.list_arguments(),
                            net.infer_shape(data0=shape)[0])
            if n != "data0"}
    return net, args, {}, shape


def test_quant_tune_check_is_wired(monkeypatch, one_thread):
    """An entry keyed on another device kind fails phase 13 (c)."""
    import numpy as np
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.autotune import store
    model = _tiny_image_model(mx)
    failures = []
    rec = chip_smoke.quant_tune(torch, np, mx, mx.cpu(), "cpu",
                                QUANT_SMALL["tune_spec"], model, failures)
    assert failures == [] and rec["device_kind"] == "cpu"
    monkeypatch.setattr(store, "device_kind", lambda device=None: "TPU v4")
    chip_smoke.quant_tune(torch, np, mx, mx.cpu(), "cpu",
                          QUANT_SMALL["tune_spec"], model, failures)
    assert any("keyed" in f for f in failures), failures


def test_quant_phase_raises_at_its_end(monkeypatch):
    """A failure found in any part fails the phase, after every part ran."""
    import torch
    import mxnet_tpu_torch as mx
    ran = []

    def part(name, fails, out):
        def run(*a):
            ran.append(name)
            if fails:
                a[-1].append(name + " broke")
            return out
        return run
    monkeypatch.setattr(chip_smoke, "quant_resnet",
                        part("resnet", True, ({}, None, None, None)))
    monkeypatch.setattr(chip_smoke, "quant_tune", part("tune", False, {}))
    monkeypatch.setattr(chip_smoke, "quant_lm", part("lm", True, {}))
    with pytest.raises(RuntimeError, match="resnet broke; lm broke"):
        chip_smoke.phase_quant(torch, "cpu", 0, ctx=mx.cpu(), **QUANT_SMALL)
    assert ran == ["resnet", "tune", "lm"]


def test_quant_phase_raises_without_cuda(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        chip_smoke.phase_quant(torch, "no card", 0)
