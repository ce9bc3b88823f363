"""The port's ``resilience.netchaos``: the cases of
``tests/test_netchaos.py`` on ``mxnet_tpu_torch`` — deterministic network
fault injection (counter budgets, directive semantics, the kill switch's
exact firing point).  The socket paths are driven end to end by
``tests/test_torch_kvstore.py`` (the dropped-reply drill)."""

import pytest

from mxnet_tpu_torch.resilience import chaos, netchaos


@pytest.fixture(autouse=True)
def _clean_chaos():
    chaos.reset()
    yield
    chaos.reset()


def test_idle_when_chaos_off(monkeypatch):
    monkeypatch.delenv("MXNET_CHAOS", raising=False)
    assert netchaos.on_worker_send(1) == {}
    assert netchaos.on_server_reply(1) is None
    netchaos.on_server_push()          # no tick, no exit
    assert chaos.counter("netchaos_push") == 0


def test_partition_budget_consumed_in_order():
    chaos.configure(net_partition=2)
    for _ in range(2):
        with pytest.raises(ConnectionError):
            netchaos.on_worker_send(1)
    # budget exhausted: sends flow again
    assert netchaos.on_worker_send(1) == {}
    assert chaos.fired("net_partition") == 2


def test_torn_and_dup_directives():
    chaos.configure(net_torn_request=1, net_dup_request=2)
    d1 = netchaos.on_worker_send(1)
    assert d1 == {"torn": True, "dup": True}
    d2 = netchaos.on_worker_send(1)
    assert d2 == {"dup": True}
    assert netchaos.on_worker_send(1) == {}


def test_server_reply_drop_then_torn():
    chaos.configure(net_drop_reply=1, net_torn_reply=1)
    assert netchaos.on_server_reply(2) == "drop"
    assert netchaos.on_server_reply(2) == "torn"
    assert netchaos.on_server_reply(2) is None


def test_delay_uses_net_delay_ms(monkeypatch):
    slept = []
    monkeypatch.setattr(netchaos.time, "sleep", slept.append)
    chaos.configure(net_delay_request=1, net_delay_reply=1,
                    net_delay_ms=70)
    netchaos.on_worker_send(1)
    netchaos.on_server_reply(1)
    assert slept == [0.07, 0.07]


def test_kill_fires_exactly_at_kth_push(monkeypatch):
    exits = []
    monkeypatch.setattr(netchaos, "_exit", exits.append)
    chaos.configure(net_kill_server_at=3)
    netchaos.on_server_push()
    netchaos.on_server_push()
    assert exits == []
    netchaos.on_server_push()
    assert exits == [137]
    netchaos.on_server_push()          # past K: no further kills
    assert exits == [137]


def test_spec_string_parses_net_keys(monkeypatch):
    monkeypatch.setenv("MXNET_CHAOS",
                       "net_drop_reply=2,net_delay_ms=500,"
                       "net_kill_server_at=4")
    spec = chaos.active()
    assert spec == {"net_drop_reply": 2, "net_delay_ms": 500,
                    "net_kill_server_at": 4}
