"""``chip_smoke.py``'s phase 18 (the kvstore) on the CPU at a small size,
the plumbing only: the stores against themselves, the reference's worker
script on two worker processes for dist_sync and dist_async, the sparse
linear job at 2,001 features on two workers (round 1's server weight
against the CPU's AdaGrad, the loss, the accuracy) and the LM at 2
layers and dim 32 through ``gluon.Trainer(kvstore='dist_sync')`` on two
workers (step 1 against w0 + SGD(g0 + g1) in float64).  The card's own
numbers (launches, peaks, times) are the chip run's."""

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
import mxnet_tpu_torch as mx  # noqa: E402

LINEAR = dict(chip_smoke.KV_LINEAR, features=2001, batch=128, rows=2048)
LM = dict(chip_smoke.KV_LM, cfg=(64, 32, 2, 2, 16))


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_kvstore_phase_runs_small_on_the_cpu():
    rec = chip_smoke.phase_kvstore(torch, "cpu", 0, ctx=mx.cpu(),
                                   linear=LINEAR, lm=LM)
    assert rec["stores"]["worst"] == 0.0 and rec["stores"]["codes_equal"]
    for pulled in rec["ref"].values():
        assert pulled == [[3.0] * 4] * 2
    lin = rec["linear"]
    assert lin["moved"] == 0 and lin["worst"] <= 1.0
    for w in lin["workers"]:
        assert w["epoch_loss"][-1] < w["epoch_loss"][0]
        assert w["accuracy"] >= LINEAR["min_accuracy"]
        assert w["rounds"] == LINEAR["epochs"] * LINEAR["rows"] // (
            LINEAR["batch"] * 2)
    assert not lin["server"]["stats"]["cuda_initialized"]
    lm = rec["lm"]
    assert lm["bit_equal"] and lm["worst"] <= 1.0
    for w in lm["workers"]:
        assert w["losses"][-1] < w["losses"][0]
        assert w["rescale"] == 1.0 / (LM["batch"] * 2)
    assert lm["launches"] == {"flash_fwd": 0, "flash_bwd_dkdv": 0,
                              "flash_bwd_dq": 0}


def test_kvstore_phase_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="phase 18 needs CUDA"):
        chip_smoke.phase_kvstore(torch, "cpu", 0)


def test_kv_worker_refuses_a_card_job_without_cuda(tmp_path, monkeypatch):
    """A worker told to run on the card finds no CUDA: it exits non-zero
    and prints no record (its parent then fails the phase)."""
    import json
    job = tmp_path / "job.json"
    job.write_text(json.dumps({"ctx": "gpu", "seed": 0, "workers": 1,
                               "kv_type": "dist_sync"}))
    monkeypatch.setenv("DMLC_WORKER_RANK", "0")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.kv_worker("ref", str(job)) == 1
