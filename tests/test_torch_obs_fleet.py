"""The fleet plane of the port's telemetry across ranks, on the CPU.

Each case spawns 2 ranks with ``torch.multiprocessing`` that join one
gloo group through a ``FileStore`` under ``tmp_path`` (the spawn of
``test_torch_parallel.py``): ``network.fleet_allgather`` and
``straggler_stats`` over the group, and a data-parallel training with
``metrics_file`` and ``trace_file`` per rank, whose rank-0 records carry
a fleet view over both ranks, whose registries count the collective
bytes that ``network.STATS`` counts, and whose traces merge into one
process track per rank (the merge held against the JAX package's on
the same files). One process: ``fleet_allgather`` is None and
``straggler_stats`` (0.0, 0) (``test_torch_obs.py``).

Module-level code imports no JAX: the spawned ranks import this module.
"""
import os
import pickle

import numpy as np
import pytest

import torch


def _rank_main(rank, world, store_path, out_dir, job, args):
    """One rank: join the gloo group through the file store, run
    ``job`` and pickle its result to ``out_dir/<rank>.pkl``."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        out = _JOBS[job](rank, world, *args)
        with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as fh:
            pickle.dump(out, fh)
    finally:
        dist.destroy_process_group()


def _run_ranks(tmp_path, world, job, *args):
    out_dir = tmp_path / f"out_{job}"
    out_dir.mkdir()
    torch.multiprocessing.spawn(
        _rank_main, args=(world, str(tmp_path / f"store_{job}"),
                          str(out_dir), job, args), nprocs=world, join=True)
    res = []
    for r in range(world):
        with open(out_dir / f"{r}.pkl", "rb") as fh:
            res.append(pickle.load(fh))
    return res


def _job_gather(rank, world):
    from lightgbm_tpu_torch import network
    network.reset_stats()
    gathered = network.fleet_allgather([rank, 2 * rank + 1])
    return dict(gathered=gathered, stats=network.straggler_stats(rank + 1.0),
                skew=network.straggler_skew(1.0), calls=network.STATS["calls"])


def _job_train(rank, world, out_dir):
    import lightgbm_tpu_torch as tlgb
    from lightgbm_tpu_torch import network, obs
    rng = np.random.RandomState(4)
    X = rng.randn(2000, 6)
    y = (X[:, 0] - X[:, 1] + 0.3 * rng.randn(2000) > 0).astype(np.float64)
    files = {"metrics_file": os.path.join(out_dir, f"m{rank}.jsonl"),
             "trace_file": os.path.join(out_dir, f"t{rank}.json")}
    network.reset_stats()
    tlgb.train({"objective": "binary", "tree_learner": "data",
                "num_leaves": 7, "verbose": -1, "device_type": "cpu",
                **files}, tlgb.Dataset(X, label=y), num_boost_round=3,
               verbose_eval=False)
    recs = obs.read_jsonl(files["metrics_file"])
    return dict(records=recs, stats=dict(network.STATS),
                trace=files["trace_file"])


_JOBS = {"gather": _job_gather, "train": _job_train}


def test_fleet_allgather_across_ranks(tmp_path):
    res = _run_ranks(tmp_path, 2, "gather")
    for r in res:
        assert np.array_equal(r["gathered"], [[0.0, 1.0], [1.0, 3.0]])
        skew, slowest = r["stats"]
        assert slowest == 1 and skew == pytest.approx(1.0 / 1.5)
        assert r["skew"] == 0.0
        # the telemetry's own traffic is not the training's
        assert r["calls"] == 0


def test_fleet_records_over_two_ranks(tmp_path):
    from lightgbm_tpu.obs import trace as jtrace
    from lightgbm_tpu_torch.obs import report as treport
    from lightgbm_tpu_torch.obs import trace as ttrace
    res = _run_ranks(tmp_path, 2, "train", str(tmp_path))
    for r in res:
        for rec in r["records"]:
            assert "coll.host_skew" in rec["gauges"]
            assert rec["gauges"]["coll.slowest_rank"] in (0, 1)
            assert rec["fleet"]["ranks"] == 2
        counters = r["records"][-1]["counters"]
        reg_bytes = sum(v for k, v in counters.items()
                        if k.startswith("collective.")
                        and k.endswith(".bytes"))
        reg_calls = sum(v for k, v in counters.items()
                        if k.startswith("collective.")
                        and k.endswith(".calls"))
        assert reg_bytes == r["stats"]["bytes"] > 0
        assert reg_calls == r["stats"]["calls"]
        assert counters["coll.axis.data.bytes"] == reg_bytes
    fleet = res[0]["records"][-1]["fleet"]
    assert [row["rank"] for row in fleet["per_rank"]] == [0, 1]
    assert all(row["coll_bytes"] == res[row["rank"]]["stats"]["bytes"]
               for row in fleet["per_rank"])
    traces = [r["trace"] for r in res]
    merged = ttrace.merge_trace_files(traces, str(tmp_path / "merged.json"))
    assert merged == jtrace.merge_trace_files(traces,
                                              str(tmp_path / "j.json"))
    tracks = {e["pid"] for e in merged["traceEvents"]
              if e.get("name") == "process_name"}
    assert tracks == {0, 1}
    colls = [e for e in treport.load_trace(traces[0])
             if e.get("cat") == "collective"]
    assert colls and all(e["args"]["axis"] == "data" for e in colls)
