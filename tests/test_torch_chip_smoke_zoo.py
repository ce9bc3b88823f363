"""``chip_smoke.py``'s phase 15 (the layer ops, DCGAN and the vision zoo)
on the CPU at a small size: the layer op sweep and the transposed layers
(the CPU against itself: the plumbing), DCGAN at ngf 8 on 64 x 64 images
(the check iteration against f64 with frozen masks, then the example's
loop, whose D loss must fall), and two zoo models served from their
checkpoints on rungs 1 and 4 against the f64 graph.  The card's own
checks (TF32 runs, captures, timings) are the chip run's."""

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
import mxnet_tpu_torch as mx  # noqa: E402

DCGAN = dict(chip_smoke.DCGAN, nz=16, ngf=8, ndf=8, batch=8, iters=40,
             lr=1e-3)
ZOO = dict(chip_smoke.ZOO, models=(("squeezenet1_1", 64),
                                   ("mobilenet0_25", 32)),
           rungs=(1, 4), classes=10)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs files in parallel processes: one intra-op thread a
    # process keeps them from oversubscribing the cores
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_zoo_phase_runs_small_on_the_cpu():
    rec = chip_smoke.phase_zoo(torch, "cpu", 0, ctx=mx.cpu(), dcgan=DCGAN,
                               zoo=ZOO)
    assert all(r == 0.0 for r in rec["layers"].values())
    assert len(rec["layers"]) == 52 + 3
    d = rec["dcgan"]
    assert d["check"]["loss_ratio"] <= 1.0
    assert d["check"]["grad_worst"] <= chip_smoke.TOL_DCGAN_GRAD
    assert d["d_late"] < d["d_early"]
    assert d["img_shape"] == [4, 3, 64, 64]
    assert sorted(rec["zoo"]) == ["mobilenet0_25", "squeezenet1_1"]
    assert all(z["worst"] <= 1.0 for z in rec["zoo"].values())
    assert rec["attention_launches"] == {
        "flash_fwd": 0, "flash_bwd_dkdv": 0, "flash_bwd_dq": 0}


def test_dcgan_nets_have_the_published_shapes():
    gen, disc = chip_smoke.dcgan_nets(mx, chip_smoke.DCGAN)
    for net in (gen, disc):
        net.initialize(ctx=mx.cpu())
    z = mx.nd.zeros((2, 100, 1, 1), ctx=mx.cpu())
    img = gen(z)
    assert img.shape == (2, 3, 64, 64)
    assert disc(img).shape == (2, 1, 1, 1)
    assert not any(n.endswith("bias") and "batchnorm" not in n
                   for n in list(gen.collect_params()) +
                   list(disc.collect_params()))
    kinds = [type(b).__name__ for b in gen]
    assert kinds.count("Conv2DTranspose") == 5


def test_zoo_phase_refuses_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs CUDA"):
        chip_smoke.phase_zoo(torch, "cpu", 0)
