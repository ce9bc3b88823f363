"""``chip_smoke.py``'s phase 16 (the detection ops, SSD-300 and the
example's flow) on the CPU at a small size, the plumbing only: the op
sweep (the CPU against itself), ImageDetIter's route against its replay,
SSD-300 at 1/8 of its widths trained from 16 records (the check step
against f64 with frozen masks and targets, a fused step against a legacy
one, the example's loop), served on rungs 1 and 2 in the two parts, and
examples/train_ssd.py's flow shortened.  The card's own checks (TF32 runs,
captures, timings) are the chip run's."""

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
import mxnet_tpu_torch as mx  # noqa: E402

SSD = dict(chip_smoke.SSD, div=8, batch=4, check_batch=2, records=16,
           sides=(300, 360), batches=6, timed_from=2, window=2,
           rungs=(1, 2), threads=2, route_images=3, lr=0.01)
EXAMPLE = dict(chip_smoke.SSD_EXAMPLE, examples=64, epochs=3)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    # the suite runs files in parallel processes: few intra-op threads a
    # process keep them from oversubscribing the cores
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_detection_phase_runs_small_on_the_cpu():
    rec = chip_smoke.phase_detection(torch, "cpu", 0, ctx=mx.cpu(), ssd=SSD,
                                     example=EXAMPLE)
    assert not rec["ops"]["parted"]
    assert rec["route"]["route"] == "cv2" and rec["route"]["labels_equal"]
    assert rec["route"]["mean_levels"] == 0.0
    train = rec["train"]
    assert train["check"]["grad_worst"] <= chip_smoke.TOL_SSD_GRAD
    assert train["fused"]["differ"] == 0
    assert train["late"] < train["early"]
    assert train["routes"]["chain"] >= SSD["batches"]
    serve = rec["serve"]
    assert serve["parted"] == 0 and serve["worst_head"] <= 1.0
    assert sorted(serve["rungs"]) == [1, 2]
    assert rec["example"]["found"] > 0
    assert rec["example"]["epochs"][-1] < rec["example"]["epochs"][0]
    assert not any(rec["attention_launches"].values())
