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
trainer's state bit for bit; the phase raises without CUDA."""

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
