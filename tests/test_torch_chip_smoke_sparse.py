"""``chip_smoke.py``'s phase 17 (sparse storage and the long tail) on the
CPU at a small size, the plumbing only: the sparse op sweep (the CPU
against itself), sparse linear classification at 20,001 features from
2,048 seeded LibSVM rows (the check step, two epochs of the eager loop,
the Symbol through Module on the legacy step), the example's flow, the LM
at 2 layers and dim 64 with a row-sparse Embedding gradient through
Module (against the dense-gradient Symbol, against a legacy step, six
fused steps), and the ``Custom`` operators.  The card's own checks (TF32
runs, captures, launches, timings) are the chip run's."""

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
import mxnet_tpu_torch as mx  # noqa: E402

LINEAR = dict(chip_smoke.SPARSE_LINEAR, features=20001, batch=256, rows=2048)
EXAMPLE = dict(chip_smoke.SPARSE_EXAMPLE, examples=1200)
LM = (500, 64, 4, 2, 32)        # vocab, dim, heads, layers, seq


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_sparse_phase_runs_small_on_the_cpu():
    rec = chip_smoke.phase_sparse(torch, "cpu", 0, ctx=mx.cpu(),
                                  linear=LINEAR, example=EXAMPLE, lm_cfg=LM,
                                  batch=2)
    assert max(rec["ops"]["ratios"].values()) == 0.0
    assert not rec["ops"]["tf32"]
    check = rec["linear_check"]
    assert check["moved"] == 0 and check["worst"] == 0.0 and check["touched"]
    lin = rec["linear"]
    assert lin["epoch_loss"][-1] < lin["epoch_loss"][0]
    assert lin["batches"] == 2 * LINEAR["rows"] // LINEAR["batch"]
    mod = rec["linear_module"]
    assert mod["step"] == "legacy" and mod["captures"] == 0
    assert mod["worst"] == 0.0
    assert rec["example"]["accuracy"] >= EXAMPLE["min_accuracy"]
    lm = rec["lm"]
    assert lm["vs_dense"]["differ"] == 0 and lm["vs_dense"]["gap"] <= 1.0
    assert lm["vs_legacy"]["differ"] == 0
    assert lm["moved"] == 0 and not lm["dense_buffers"]
    assert lm["losses"][-1] < lm["losses"][0]
    assert rec["custom"]["step"] == "legacy"
