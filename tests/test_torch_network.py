"""The port's process wiring (lightgbm_tpu_torch/network.py): machine
lists, rank discovery and ``ensure_distributed``'s cases with an
injected initializer (no second host, no process group), ported from
tests/test_network.py; and ``Booster.set_network`` routing. The
collectives themselves run across spawned ranks in
tests/test_torch_parallel.py."""
import datetime

import numpy as np
import pytest

import lightgbm_tpu_torch.network as net
from lightgbm_tpu_torch.network import (ensure_distributed,
                                        local_addresses,
                                        parse_machine_list,
                                        resolve_rank_all)
from lightgbm_tpu_torch.utils.log import LightGBMError


def test_parse_machine_list():
    assert parse_machine_list("10.0.0.1:12400,10.0.0.2:12400") == \
        ["10.0.0.1:12400", "10.0.0.2:12400"]
    assert parse_machine_list(" a:1 ,\n b:2 ,") == ["a:1", "b:2"]
    assert parse_machine_list("") == []


@pytest.mark.parametrize("entry", ["10.0.0.1", ":12400", "h:0", "h:70000",
                                   "h:port"])
def test_parse_machine_list_rejects_bad_entries(entry):
    with pytest.raises(LightGBMError):
        parse_machine_list(f"10.0.0.9:12400,{entry}")


def test_resolve_rank_matches_local_address():
    machines = ["10.9.9.1:12400", "10.9.9.2:12400", "10.9.9.3:12400"]
    assert resolve_rank_all(machines, local=["10.9.9.2"]) == [1]
    assert resolve_rank_all(machines, local=["10.9.9.3", "127.0.0.1"]) \
        == [2]
    assert resolve_rank_all(machines, local=["10.0.0.7"]) == []
    # several processes on one host: every entry of the host
    assert resolve_rank_all(machines + ["10.9.9.2:12401"],
                            local=["10.9.9.2"]) == [1, 3]


def test_local_addresses_include_loopback():
    assert "127.0.0.1" in local_addresses()


def test_ensure_distributed_single_machine_noop():
    calls = []
    assert ensure_distributed("", 1, _initialize=calls.append) is False
    assert calls == []


def test_ensure_distributed_local_list_without_rank_is_one_process(
        monkeypatch):
    """Every entry on this host and no RANK: one process trains alone."""
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.delenv("LGBM_TPU_RANK", raising=False)
    calls = []
    assert ensure_distributed("127.0.0.1:12400,127.0.0.1:12401", 2,
                              _initialize=lambda **kw: calls.append(kw)) \
        is False
    assert calls == []


def test_ensure_distributed_initializes_with_rank(monkeypatch):
    """A multi-host list: a TCP store at entry 0, the world size from the
    list, this host's rank, time_out in minutes, gloo on the CPU."""
    monkeypatch.setattr(net, "local_addresses",
                        lambda: ["10.77.0.2", "127.0.0.1"])
    calls = []
    out = ensure_distributed("10.77.0.1:12400,10.77.0.2:12400", 2,
                             time_out=7, device_type="cpu",
                             _initialize=lambda **kw: calls.append(kw))
    assert out is True
    assert calls == [dict(backend="gloo",
                          init_method="tcp://10.77.0.1:12400",
                          world_size=2, rank=1,
                          timeout=datetime.timedelta(seconds=420))]


def test_ensure_distributed_multiple_local_entries(monkeypatch):
    """Two processes on one host in a mixed list: the rank comes from
    RANK; without it the call fails rather than start two rank-0
    processes."""
    monkeypatch.setattr(net, "local_addresses",
                        lambda: ["10.8.0.1", "127.0.0.1"])
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.delenv("LGBM_TPU_RANK", raising=False)
    machines = "10.8.0.1:12400,10.8.0.1:12401,10.8.0.9:12400"
    calls = []
    with pytest.raises(LightGBMError):
        ensure_distributed(machines, 3, _initialize=lambda **kw: None)
    monkeypatch.setenv("RANK", "1")
    out = ensure_distributed(machines, 3, device_type="cpu",
                             _initialize=lambda **kw: calls.append(kw))
    assert out is True
    assert calls[0]["rank"] == 1
    assert calls[0]["init_method"] == "tcp://10.8.0.1:12400"
    monkeypatch.setenv("RANK", "2")
    with pytest.raises(LightGBMError):
        ensure_distributed(machines, 3, _initialize=lambda **kw: None)


def test_ensure_distributed_unknown_host_fails(monkeypatch):
    monkeypatch.setattr(net, "local_addresses", lambda: ["10.1.1.1"])
    with pytest.raises(LightGBMError):
        ensure_distributed("10.2.0.1:1,10.2.0.2:1", 2,
                           _initialize=lambda **kw: None)


def test_ensure_distributed_retries_with_backoff(monkeypatch):
    """A refused store is retried LGBM_TPU_INIT_RETRIES times with
    growing, jittered delays; a rank mismatch is not retried."""
    monkeypatch.setattr(net, "local_addresses", lambda: ["10.77.0.2"])
    monkeypatch.setenv("LGBM_TPU_INIT_RETRIES", "3")
    sleeps, tries = [], []

    def flaky(**kw):
        tries.append(kw)
        if len(tries) < 3:
            raise RuntimeError("Connection refused")

    assert ensure_distributed("10.77.0.1:1,10.77.0.2:1", 2, device_type="cpu",
                              _initialize=flaky, _sleep=sleeps.append)
    assert len(tries) == 3 and len(sleeps) == 2
    assert 1.0 <= sleeps[0] <= 1.25 and 2.0 <= sleeps[1] <= 2.5

    def always(**kw):
        raise RuntimeError("connection refused")
    with pytest.raises(LightGBMError):
        ensure_distributed("10.77.0.1:1,10.77.0.2:1", 2,
                           _initialize=always, _sleep=lambda s: None)

    tries.clear()

    def mismatch(**kw):
        tries.append(kw)
        raise RuntimeError("rank mismatch with the store")
    with pytest.raises(LightGBMError):
        ensure_distributed("10.77.0.1:1,10.77.0.2:1", 2,
                           _initialize=mismatch, _sleep=lambda s: None)
    assert len(tries) == 1


def test_ensure_distributed_env_driven(monkeypatch):
    """An empty list with MASTER_ADDR / RANK / WORLD_SIZE set: the group
    comes from the environment; without them one process trains
    alone."""
    calls = []
    for k in ("MASTER_ADDR", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert ensure_distributed("", 2, _initialize=calls.append) is False
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.1")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    assert ensure_distributed("", 2, time_out=1, device_type="cpu",
                              _initialize=lambda **kw: calls.append(kw))
    assert calls == [dict(backend="gloo",
                          timeout=datetime.timedelta(seconds=60))]


def test_startup_health_barrier_reports_a_failure():
    def boom():
        raise RuntimeError("peer gone")
    with pytest.raises(LightGBMError):
        net._startup_health_barrier(5.0, _barrier=boom)
    net._startup_health_barrier(5.0, _barrier=lambda: None)


def test_classify_init_error():
    kinds = [net._classify_init_error(RuntimeError(m), "h:1", 0, 2)[0]
             for m in ("Socket Timeout", "Connection refused",
                       "rank 3 is already taken", "segfault")]
    assert kinds == ["timeout", "refused", "rank mismatch", "unknown"]


def test_collectives_are_identities_in_one_process():
    import torch
    x = torch.tensor([1.5, -0.0])
    assert net.psum(x) is x and net.pmax(x) is x
    assert net.all_gather(x).shape == (1, 2)


def test_booster_set_network_routes_through_ensure(monkeypatch):
    import lightgbm_tpu_torch as lgb
    seen = {}

    def fake_ensure(machines, num_machines, time_out=120, device_type=None):
        seen.update(machines=machines, num_machines=num_machines,
                    time_out=time_out, device_type=device_type)
        return False

    monkeypatch.setattr(net, "ensure_distributed", fake_ensure)
    rng = np.random.RandomState(0)
    X = rng.randn(200, 4)
    y = (X[:, 0] > 0).astype(np.float64)
    bst = lgb.train({"objective": "binary", "verbose": -1,
                     "device_type": "cpu"},
                    lgb.Dataset(X, label=y), num_boost_round=1)
    assert bst.set_network(["127.0.0.1:12400", "127.0.0.1:12401"],
                           listen_time_out=33, num_machines=2) is bst
    assert seen == dict(machines="127.0.0.1:12400,127.0.0.1:12401",
                        num_machines=2, time_out=33, device_type="cpu")
    assert bst.free_network() is bst


def test_train_wires_the_network_first(monkeypatch):
    """train() resolves the network keys' aliases and calls
    ensure_distributed before the dataset is built; a tree_learner other
    than serial in one process takes the serial learner."""
    import lightgbm_tpu_torch as lgb
    seen = []
    monkeypatch.setattr(net, "ensure_distributed",
                        lambda *a, **kw: seen.append((a, kw)) or False)
    rng = np.random.RandomState(0)
    X = rng.randn(300, 4)
    y = (X[:, 0] > 0).astype(np.float64)
    ds = lgb.Dataset(X, label=y)
    bst = lgb.train({"objective": "binary", "verbose": -1,
                     "device_type": "cpu", "num_machine": 2,
                     "workers": "10.0.0.1:1,10.0.0.2:1", "time_out": 3,
                     "tree_learner": "data"}, ds, num_boost_round=2)
    assert seen == [(("10.0.0.1:1,10.0.0.2:1", 2),
                     {"time_out": 3, "device_type": "cpu"})]
    assert type(bst._gbdt.tree_learner).__name__ == "SerialTreeGrower"
