"""``chip_smoke.py``'s phase 14 (the serving fleet) on the CPU.

At a small size (a 2-layer LM of dim 32 over 16 tokens, a pool of 4
rows, a few requests a stage) the whole phase runs with real replica
processes serving on the CPU: the parent's hashed replays, the closed
and open loops at 1 and 2 replicas, a replica killed under traffic and
replaced, a rolling deploy onto v2, the exactly-once count over every
replica's last STATS, and the decode failover at the reference's own
``decode_lm`` configuration.  The hash matching, the stage's checks and
the refusal without CUDA are held on their own.
"""

import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
import mxnet_tpu_torch as mx  # noqa: E402

SMALL = dict(chip_smoke.FLEET, cfg=(40, 32, 4, 2, 16), pool=4,
             closed=(1, 4), closed_two=((1, 2), (2, 2)), open_requests=8, kill_at=2, kill_requests=6,
             deploy_tail=2, spawn_timeout=120.0, workers=4)


def test_fleet_phase_runs_small_on_the_cpu():
    rec = chip_smoke.phase_fleet(torch, "cpu", 0, ctx=mx.cpu(), spec=SMALL)
    assert rec["one"]["v1_equal"] == rec["one"]["requests"] == 8
    assert rec["two"]["v1_equal"] == rec["two"]["requests"] == 8
    # closed loops hash after their window: every answer still matched
    assert rec["closed"]["v1_equal"] == rec["closed"]["requests"] == 4
    assert [(c["v1_equal"], c["requests"], c["dispatched"])
            for c in rec["closed_two"]] == [(2, 2, 2), (4, 4, 4)]
    assert rec["kill"]["rc"] == 137 and rec["kill"]["failed"] == 0
    assert rec["kill"]["successor_nvcc_s"] == 0.0
    dep = rec["deploy"]
    assert dep["failed"] == 0 and dep["either"] == dep["requests"] > 0
    assert dep["v2_after"] == dep["after"] == 2
    assert [d["timed_out"] for d in dep["drains"]] == [False, False]
    assert [r["rc"] for r in rec["replicas"]].count(137) == 1
    assert all(r["captures"] in (None, {"lm": 3}) for r in rec["replicas"])
    dec = rec["decode"]
    assert dec["kill_rc"] == 137 and dec["bit_equal"] == dec["streams"] == 6
    assert dec["moved"] >= 1 and dec["blocks_in_use"] == 0
    # no attention kernel on the CPU: the plain version ran
    assert rec["launches"] == {"wrapper": 0, "graph": 0}


def test_versions_need_one_rung_for_every_row():
    refs = {1: [{1: "a1", 2: "a2"}, {1: "b1", 2: "b2"}],
            2: [{1: "A1", 2: "A2"}, {1: "B1", 2: "B2"}]}
    rungs = (1, 2)
    assert chip_smoke.fleet_versions(refs, [0], ["a2"], rungs) == [1]
    assert chip_smoke.fleet_versions(refs, [0, 1], ["a2", "b2"],
                                     rungs) == [1]
    # two rows cannot ride rung 1, nor two rungs at once
    assert chip_smoke.fleet_versions(refs, [0, 1], ["a1", "b1"],
                                     rungs) == []
    assert chip_smoke.fleet_versions(refs, [0, 1], ["a1", "b2"],
                                     rungs) == []
    assert chip_smoke.fleet_versions(refs, [1], ["B1"], rungs) == [2]


class _Router:
    """Answers every predict with zeros: no replay's hash."""

    def predict(self, model, data):
        return [np.zeros(data["data0"].shape + (3,), np.float32)]


class _Fleet:
    router = _Router()

    def keys(self):
        return ["r"]

    def stats(self, key):
        return {"predicts_dispatched": 0, "predict_seconds": 0.0,
                "dup_hits": 0}


def test_a_stage_fails_an_answer_no_replay_gave():
    spec = dict(SMALL, cfg=(3, 4, 1, 1, 2), rungs=(1,))
    pool = np.zeros((2, 2), np.float32)
    refs = {1: [{1: "x"}, {1: "y"}]}
    traffic = chip_smoke.FleetTraffic(_Fleet.router, pool, refs, spec)
    failures = []
    try:
        st = chip_smoke.fleet_stage(_Fleet(), traffic, "stage", [[0], [1]],
                                    100.0, "cpu", failures)
    finally:
        traffic.close()
    assert st["answered"] == 2 and st["v1_equal"] == 0
    assert len(failures) == 2       # no v1 match, and no dispatch counted


def test_a_closed_stage_hashes_after_its_window():
    """Deferred answers are held to the replays all the same: a closed
    stage whose answers no replay gave fails as an open one does."""
    spec = dict(SMALL, cfg=(3, 4, 1, 1, 2), rungs=(1,))
    pool = np.zeros((2, 2), np.float32)
    refs = {1: [{1: "x"}, {1: "y"}]}
    traffic = chip_smoke.FleetTraffic(_Fleet.router, pool, refs, spec)
    failures = []
    try:
        st = chip_smoke.fleet_stage(_Fleet(), traffic, "stage",
                                    [[0], [1], [0]], None, "cpu", failures,
                                    threads=2)
    finally:
        traffic.close()
    assert st["answered"] == 3 and st["v1_equal"] == 0
    assert all("out" not in r and "versions" in r for r in traffic.records)
    assert len(failures) == 2


def test_fleet_phase_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        chip_smoke.phase_fleet(torch, "no card", 0)
