"""Telemetry of the port (``lightgbm_tpu_torch/obs/``) against the JAX
package's ``obs/``, on the CPU.

- The host modules, fed the same operations (an injected clock where
  they read one): ``MetricsRegistry`` records and bench fields,
  ``LatencyHistogram`` percentiles, ``JsonlSink`` bytes, the
  validators, ``render_prometheus``, ``report.summarize`` /
  ``format_report``, ``merge_trace_events``, the ``Tracer`` export,
  ``FleetAggregator`` and the flight recorder's SLO trigger must give
  equal output in both packages (tolerance: equality).
- Trainings of both learners with ``metrics_file`` and ``trace_file``:
  one valid record per iteration (both packages' validators), the four
  phase fields summing to ``t_iter_s`` (within the records' 1e-6
  rounding), ``metrics_interval`` sampling, phase coverage >= 95% on
  the steady iterations (the JAX package's gate), one sync event per
  learner read plus the eval read and the telemetry stream sync, and
  the model text byte-equal to the run without telemetry but the
  echoed telemetry keys.
- The counters of the fault, checkpoint, quarantine, hang and
  quantization drills equal the JAX package's on the same drills (its
  synchronous loop, ``LGBM_TPU_PIPELINE=0``).
- The live endpoint during a training, the flight recorder (a bundle on
  a hang, none under an injected ENOSPC), the profiler's trace, the
  ``tpu_warmup`` switch (no warning left), and the sync channel's patch
  staying balanced.

The fleet plane across ranks is in ``test_torch_obs_fleet.py`` (its
ranks import that module, which imports no JAX).
"""
import json
import os
import socket
import urllib.request

import numpy as np
import pytest

import torch

import lightgbm_tpu as jlgb
from lightgbm_tpu import obs as jobs
from lightgbm_tpu.obs import aggregate as jagg
from lightgbm_tpu.obs import flight as jflight
from lightgbm_tpu.obs import httpd as jhttpd
from lightgbm_tpu.obs import report as jreport
from lightgbm_tpu.obs import trace as jtrace
from lightgbm_tpu.robust import install_plan as jinstall
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch import obs as tobs
from lightgbm_tpu_torch.obs import aggregate as tagg
from lightgbm_tpu_torch.obs import flight as tflight
from lightgbm_tpu_torch.obs import httpd as thttpd
from lightgbm_tpu_torch.obs import report as treport
from lightgbm_tpu_torch.obs import spans as tspans
from lightgbm_tpu_torch.obs import trace as ttrace
from lightgbm_tpu_torch.robust import install_plan
from lightgbm_tpu_torch.utils import device as tdevice
from lightgbm_tpu_torch.utils import log as tlog

from test_torch_robust import (BASE, _jax_reference_loop,  # noqa: F401
                               _make_data, _no_residual_fault_plan, _train)

OBS_KEYS = ("metrics_file", "trace_file", "profile_dir", "obs_port",
            "flight_dir", "metrics_interval", "flight_slo_factor")
ROUNDS = 5


def _obs_text(booster) -> str:
    """The model text but its device_type line and the echoed telemetry
    keys (the parameter block records every config key)."""
    return "\n".join(
        ln for ln in booster.model_to_string().splitlines()
        if not ln.startswith("[device_type")
        and not any(ln.startswith(f"[{k}:") for k in OBS_KEYS))


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _get(port, route):
    import urllib.error
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{route}",
                                    timeout=10) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


# -- the registry, fed the same operations -------------------------------

SCRIPTS = {
    "phases": [
        ("begin", 0, 10.0), ("add_time", "hist", 0.25),
        ("add_time", "split", 0.5), ("add_time", "partition", 0.125),
        ("add_time", "update", 1.5), ("inc", "kernel.hist.calls"),
        ("set_gauge", "mem.live_bytes", 1024), ("end", 12.0),
        ("begin", 1, 12.0), ("add_time", "hist", 0.1),
        ("inc", "kernel.hist.calls", 3), ("end", 12.5, {"num_leaves": 7})],
    "collectives": [
        ("begin", 0, 0.0), ("record_collective", "psum", 4096, 0.002, "data"),
        ("record_collective", "all_gather", 128, 0.0005, "data"),
        ("record_collective", "pmax", 8, 0.25, ""),
        ("observe", "x.ms", 3.0), ("observe", "x.ms", 1.0), ("end", 1.0),
        ("begin", 1, 1.0), ("record_collective", "psum", 4096, 0.001,
                            "data"), ("end", 1.5)],
    "latency": [("begin", 0, 0.0)] + [
        ("observe_latency", "lat.fetch.device_get", v)
        for v in (0.001, 0.05, 1.0, 7.5, 250.0, 1e6)] + [
        ("observe_latency", "lat.phase.hist", 2.0),
        ("inc", "fault.fired", 2), ("inc", "ckpt.bytes", 123456),
        ("inc", "health.quarantined"), ("inc", "trace.events", 9),
        ("set_gauge", "coll.host_skew", 0.125), ("end", 0.75)],
}


def _feed(reg, script):
    records = []
    for op, *a in script:
        if op == "begin":
            reg.begin_iteration(a[0], now=a[1])
        elif op == "end":
            records.append(reg.end_iteration(
                now=a[0], extra=a[1] if len(a) > 1 else None))
        else:
            getattr(reg, op)(*a)
    return records


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_registry_records_equal(script):
    jr, tr = jobs.MetricsRegistry(), tobs.MetricsRegistry()
    recs = _feed(tr, SCRIPTS[script])
    assert recs == _feed(jr, SCRIPTS[script])
    assert tr.last_record == jr.last_record
    assert tr.bench_fields() == jr.bench_fields()
    assert tr.coll_p99_ms() == jr.coll_p99_ms()
    for rec in recs:
        assert tobs.validate_record(rec) == [] == jobs.validate_record(rec)


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_prometheus_text_equal(script):
    jr, tr = jobs.MetricsRegistry(), tobs.MetricsRegistry()
    _feed(jr, SCRIPTS[script])
    _feed(tr, SCRIPTS[script])
    assert thttpd.render_prometheus(tr) == jhttpd.render_prometheus(jr)


def test_latency_histogram_percentiles_equal():
    rng = np.random.RandomState(5)
    samples = np.exp(rng.uniform(-8, 12, 500))
    jh, th = jobs.LatencyHistogram(), tobs.LatencyHistogram()
    for v in samples:
        jh.observe(v)
        th.observe(v)
    for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
        assert th.percentile(q) == jh.percentile(q)
    assert th.snapshot() == jh.snapshot()
    assert tobs.LatencyHistogram().percentile(0.5) is None


# -- the sink and the validators ------------------------------------------

def test_jsonl_sinks_write_the_same_bytes(tmp_path):
    recs = _feed(tobs.MetricsRegistry(), SCRIPTS["phases"])
    for mod, name in ((tobs, "t.jsonl"), (jobs, "j.jsonl")):
        sink = mod.JsonlSink(str(tmp_path / name))
        for r in recs:
            sink.write(r)
        sink.close()
    assert (tmp_path / "t.jsonl").read_bytes() == \
        (tmp_path / "j.jsonl").read_bytes()
    assert tobs.read_jsonl(str(tmp_path / "t.jsonl")) == recs


def test_sink_disables_on_injected_enospc(tmp_path):
    """The ``sink.write`` seam: the first write's ENOSPC disables the
    sink, later writes count as dropped, in both packages alike."""
    recs = _feed(tobs.MetricsRegistry(), SCRIPTS["phases"]) * 2
    out = {}
    for mod, inst, name in ((tobs, install_plan, "t"),
                            (jobs, jinstall, "j")):
        inst("sink.write:enospc")
        try:
            sink = mod.JsonlSink(str(tmp_path / f"{name}.jsonl"))
            for r in recs:
                sink.write(r)
            out[name] = (sink.disabled, sink.dropped,
                         (tmp_path / f"{name}.jsonl").read_bytes())
        finally:
            inst(None)
    assert out["t"] == out["j"] == (True, len(recs) - 1, b"")


BAD_RECORDS = {
    "valid": lambda r: r,
    "newer_schema": lambda r: {**r, "schema_version": 99},
    "negative_phase": lambda r: {**r, "t_hist_s": -1.0},
    "phases_exceed_iteration": lambda r: {**r, "t_other_s": 5.0},
    "missing_counters": lambda r: {k: v for k, v in r.items()
                                   if k != "counters"},
    "bad_fleet": lambda r: {**r, "fleet": {"ranks": 2}},
    "bad_buckets": lambda r: {**r, "lat": {"x": {
        "count": 1, "sum_ms": 1, "p50_ms": 1, "p90_ms": 1, "p99_ms": 1,
        "buckets": [[1.0]]}}},
    "not_an_object": lambda r: [r],
}


@pytest.mark.parametrize("case", sorted(BAD_RECORDS))
def test_validators_agree(case):
    base = _feed(tobs.MetricsRegistry(), SCRIPTS["latency"])[0]
    rec = BAD_RECORDS[case](json.loads(json.dumps(base)))
    got = tobs.validate_record(rec)
    assert got == jobs.validate_record(rec)
    assert (got == []) == (case == "valid")


@pytest.mark.parametrize("rec", [
    {"metric": "s/iter", "value": 1.5, "unit": "s", "vs_baseline": 1.0},
    {"parsed": None},
    {"metric": "s/iter", "value": "x", "unit": "s", "vs_baseline": 1.0,
     "phase_hist_s": "slow", "trace_file": 3},
])
def test_bench_validators_agree(rec):
    assert tobs.validate_bench_record(rec) == jobs.validate_bench_record(rec)


# -- the trace: export, report, merge --------------------------------------

def _synthetic_events(n_iter=4, pid=0):
    ev = [{"ph": "M", "pid": pid, "tid": 0, "name": "process_name",
           "args": {"name": "host"}}]
    t = 0.0
    for it in range(n_iter):
        ev.append({"ph": "X", "name": f"iteration {it}", "cat": "iteration",
                   "pid": pid, "tid": 4, "ts": t, "dur": 1000.0,
                   "args": {"iteration": it}})
        s = t + 10.0
        for name, phase, dur in (("fused/leaf_histogram", "hist", 200.0),
                                 ("fused/split_scan", "split", 300.0 + it),
                                 ("fused/partition", "partition", 150.0)):
            ev.append({"ph": "X", "name": name, "cat": "phase", "pid": pid,
                       "tid": 1, "ts": s, "dur": dur,
                       "args": {"phase": phase, "iteration": it}})
            s += dur + 5.0
        ev.append({"ph": "X", "name": "device_get@pkg/f.py:3", "cat": "sync",
                   "pid": pid, "tid": 2, "ts": s, "dur": 7.0 + it,
                   "args": {"site": "pkg/f.py:3", "iteration": it}})
        ev.append({"ph": "X", "name": "psum", "cat": "collective",
                   "pid": pid, "tid": 3, "ts": s + 8, "dur": 3.0,
                   "args": {"bytes": 64, "iteration": it}})
        ev.append({"ph": "C", "name": "mem.live_bytes", "cat": "mem",
                   "pid": pid, "tid": 0, "ts": s + 20, "args": {"bytes": 5}})
        t += 1000.0
    return ev


def test_report_summary_and_text_equal():
    ev = _synthetic_events()
    ts, js = treport.summarize(ev, top_n=5), jreport.summarize(ev, top_n=5)
    assert ts == js
    assert treport.format_report(ts, "x.json") == \
        jreport.format_report(js, "x.json")
    assert treport.iteration_coverage(ev) == jreport.iteration_coverage(ev)


def test_merge_trace_events_equal(tmp_path):
    per_rank = [_synthetic_events(2, pid=0), _synthetic_events(3, pid=0)]
    assert ttrace.merge_trace_events(per_rank) == \
        jtrace.merge_trace_events(per_rank)
    paths = []
    for r, ev in enumerate(per_rank):
        p = tmp_path / f"r{r}.json"
        p.write_text(json.dumps({"traceEvents": ev}))
        paths.append(str(p))
    ttrace.merge_trace_files(paths, str(tmp_path / "t.json"))
    jtrace.merge_trace_files(paths, str(tmp_path / "j.json"))
    assert (tmp_path / "t.json").read_bytes() == \
        (tmp_path / "j.json").read_bytes()


def test_tracer_exports_equal():
    """The same recorded events export to the same trace-event list but
    the process name (each package names its own host)."""
    def record(tr):
        tr.iteration = 2
        tr.complete("fused/partition", "phase", 1000, 5000,
                    {"phase": "partition"})
        tr.sync("device_get", ("pkg/f.py", 7), 6000, 9000, 64)
        tr.sync("block_until_ready", None, 9500, 9600)
        tr.iteration = -1
        tr.complete("iteration 2", "iteration", 0, 10000)
        tr.complete("psum", "collective", 100, 300, {"bytes": 8})
        return [e for e in tr.to_perfetto()["traceEvents"]
                if e.get("name") != "process_name"]
    assert record(ttrace.Tracer(16)) == record(jtrace.Tracer(16))
    tr = ttrace.Tracer(16)
    for i in range(20):
        tr.complete(f"e{i}", "phase", i, i + 1)
    assert len(tr) == 16 and tr.dropped == 4 and tr.events_total == 20


# -- the fleet aggregator ---------------------------------------------------

def test_fleet_aggregator_updates_equal():
    rng = np.random.RandomState(2)
    ta, ja = tagg.FleetAggregator(), jagg.FleetAggregator()
    cum = np.zeros((4, len(tagg.PAYLOAD_FIELDS)))
    for _ in range(6):
        cum += rng.uniform(0, 3, cum.shape)
        cum[:, 0] = rng.uniform(0.5, 2.0, 4)
        assert ta.update(cum.copy()) == ja.update(cum.copy())
    assert ta.table() == ja.table()
    # a local payload and a step through an injected gather
    jr, tr = jobs.MetricsRegistry(), tobs.MetricsRegistry()
    _feed(jr, SCRIPTS["collectives"])
    _feed(tr, SCRIPTS["collectives"])
    assert ta.local_payload(tr, 1.25) == ja.local_payload(jr, 1.25)

    def gather(vec):
        return np.stack([vec, vec * 2.0])
    assert tagg.FleetAggregator().step(tr, 0.5, _gather=gather) == \
        jagg.FleetAggregator().step(jr, 0.5, _gather=gather)
    assert tr.gauges == jr.gauges


def test_fleet_outside_a_group_is_local():
    from lightgbm_tpu_torch import network
    assert network.fleet_allgather([1.0, 2.0]) is None
    assert network.straggler_stats(0.5) == (0.0, 0)
    assert network.straggler_skew(0.5) == 0.0
    fl = tagg.FleetAggregator().step(tobs.MetricsRegistry(), 0.25)
    assert fl["ranks"] == 1 and fl["skew"] == 0.0


# -- the flight recorder ----------------------------------------------------

def test_flight_slo_trigger_equal(tmp_path):
    """Fed the same iteration walls, both recorders breach the SLO and
    dump at the same iterations (an injected clock for the cooldown)."""
    walls = [1.0] * 9 + [5.0, 1.0, 6.0, 1.0] + [1.0] * 5 + [9.0]
    out = {}
    for mod, omod, name in ((tflight, tobs, "t"), (jflight, jobs, "j")):
        reg = omod.MetricsRegistry()
        omod.activate(reg)
        clock = iter(float(i) for i in range(100))
        fr = mod.FlightRecorder(str(tmp_path / name), slo_factor=4.0,
                                cooldown_s=1.5, clock=lambda: next(clock))
        try:
            for i, w in enumerate(walls):
                fr.observe_iteration(i, w)
        finally:
            omod.deactivate(reg)
        out[name] = (fr.dumps, reg.counters.get("slo.breaches"),
                     reg.counters.get("flight.slo"),
                     len(os.listdir(tmp_path / name)))
    assert out["t"] == out["j"] == (2, 3, 2, 2)


def test_flight_bundle_and_injected_enospc(tmp_path):
    """A dump holds the manifest, the trace, the registry and the
    stacks, and reads back through both packages' flight report alike;
    an ENOSPC at the ``sink.write`` seam leaves no bundle and no
    temporary directory."""
    reg = tobs.activate(tobs.MetricsRegistry())
    tr = ttrace.activate_tracer(ttrace.Tracer(64))
    try:
        reg.inc("watchdog.trips")
        tr.iteration = 0
        tr.complete("fused/split_scan", "phase", 0, 10, {"phase": "split"})
        tr.iteration = -1
        tr.complete("iteration 0", "iteration", 0, 20)
        fr = tflight.FlightRecorder(str(tmp_path), cooldown_s=0.0,
                                    context={"config": "x"})
        path = fr.dump("watchdog", {"iteration": 3, "stall_class": "x"})
        assert sorted(os.listdir(path)) == ["manifest.json", "registry.json",
                                           "stacks.txt", "trace.json"]
        install_plan("sink.write:enospc")
        try:
            assert fr.dump("sentinel", {"iteration": 4}) is None
        finally:
            install_plan(None)
        assert os.listdir(tmp_path) == [os.path.basename(path)]
        assert reg.counters["flight.failed"] == 1
        assert reg.counters["flight.dumps"] == 1
    finally:
        ttrace.deactivate_tracer(tr)
        tobs.deactivate(reg)
    bundle = treport.find_bundle(str(tmp_path))
    assert bundle == jreport.find_bundle(str(tmp_path))
    assert treport.format_flight_report(bundle) == \
        jreport.format_flight_report(bundle)


# -- the live pages --------------------------------------------------------

def test_status_pages_equal():
    jr, tr = jobs.MetricsRegistry(), tobs.MetricsRegistry()
    _feed(jr, SCRIPTS["latency"])
    _feed(tr, SCRIPTS["latency"])
    jobs.activate(jr)
    tobs.activate(tr)
    try:
        assert thttpd.render_healthz() == jhttpd.render_healthz()
        jst = jhttpd.render_statusz()
        tst = thttpd.render_statusz()
        # both pages have a compile block; its counters are each
        # package's own (XLA executables, nvcc libraries)
        assert isinstance(jst.pop("compile"), dict)
        assert isinstance(tst.pop("compile"), dict)
        assert tst == jst
    finally:
        jobs.deactivate(jr)
        tobs.deactivate(tr)


def test_endpoint_answers_during_training():
    X, y = _make_data()
    port = _free_port()
    pages = {}

    def probe(env):
        if env.iteration == 1:
            for route in ("/metrics", "/healthz", "/statusz", "/nope"):
                pages[route] = _get(port, route)
    _train(tlgb, dict(BASE, obs_port=port), X, y, 3, callbacks=[probe])
    assert pages["/metrics"][0] == 200
    assert "lgbm_tpu_kernel_hist_calls" in pages["/metrics"][1]
    assert "lgbm_tpu_lat_phase_hist_ms_bucket" in pages["/metrics"][1]
    assert pages["/healthz"][0] == 200
    assert json.loads(pages["/healthz"][1])["status"] == "ok"
    st = json.loads(pages["/statusz"][1])
    assert pages["/statusz"][0] == 200 and st["registry_active"]
    assert st["iteration"] == 1 and st["total_iterations"] == 3
    assert isinstance(st["compile"], dict)
    assert pages["/nope"][0] == 404
    with pytest.raises(OSError):        # the server is gone after train()
        urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                               timeout=2)


# -- trainings with telemetry, both learners --------------------------------

LEARNERS = {"fused": {}, "host_loop": {"tpu_fused": False}}
_RUNS = {}


def _port_run(learner, tmp_dir, **extra):
    """A port training with metrics_file and trace_file and a valid set;
    its records, trace events, learner syncs after each iteration,
    booster and evaluation history (cached per process)."""
    key = (learner, tuple(sorted(extra.items())))
    if key in _RUNS:
        return _RUNS[key]
    X, y = _make_data()
    Xv, yv = _make_data(200, seed=8)
    tag = f"{learner}_{len(_RUNS)}"
    params = dict(BASE, device_type="cpu", **LEARNERS[learner], **extra,
                  metrics_file=os.path.join(tmp_dir, f"m_{tag}.jsonl"),
                  trace_file=os.path.join(tmp_dir, f"t_{tag}.json"))
    syncs, hist = [], {}

    def count(env):
        gb = env.model._gbdt
        syncs.append((gb._fused or gb.tree_learner).syncs)
    ds = tlgb.Dataset(X, label=y)
    b = tlgb.train(params, ds, num_boost_round=ROUNDS,
                   valid_sets=[ds.create_valid(Xv, label=yv)],
                   verbose_eval=False, callbacks=[count], evals_result=hist)
    run = dict(params=params, records=tobs.read_jsonl(params["metrics_file"]),
               events=treport.load_trace(params["trace_file"]),
               syncs=syncs, booster=b, hist=hist, X=X, Xv=Xv, yv=yv)
    _RUNS[key] = run
    return run


@pytest.fixture(scope="module")
def obs_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("obs"))


@pytest.mark.parametrize("learner", sorted(LEARNERS))
def test_one_valid_record_per_iteration(learner, obs_dir):
    recs = _port_run(learner, obs_dir)["records"]
    assert [r["iteration"] for r in recs] == list(range(ROUNDS))
    for r in recs:
        assert tobs.validate_record(r) == []
        assert jobs.validate_record(r) == []
        assert r["num_leaves"] > 1 and r["best_gain"] > 0
        assert set(r["metrics"]) == {"valid_0/binary_logloss"}
        assert r["counters"]["kernel.hist.calls"] > 0
        assert r["gauges"]["train.total_iterations"] == ROUNDS
        assert "mem.live_bytes" not in r["gauges"]     # no CPU allocator
        assert r["gauges"]["mem.planar_state_bytes"] > 0
        assert r["schema_minor"] == jobs.SCHEMA_MINOR


@pytest.mark.parametrize("learner", sorted(LEARNERS))
def test_phase_fields_sum_to_the_iteration(learner, obs_dir):
    for r in _port_run(learner, obs_dir)["records"]:
        total = (r["t_hist_s"] + r["t_split_s"] + r["t_partition_s"]
                 + r["t_other_s"])
        assert abs(total - r["t_iter_s"]) <= 5e-6
        assert min(r["t_hist_s"], r["t_split_s"], r["t_partition_s"]) > 0


@pytest.mark.parametrize("learner", sorted(LEARNERS))
def test_phase_coverage(learner, obs_dir):
    cov = treport.iteration_coverage(_port_run(learner, obs_dir)["events"])
    assert sorted(cov) == list(range(ROUNDS))
    assert min(cov[i] for i in range(1, ROUNDS)) >= 0.95


@pytest.mark.parametrize("learner", sorted(LEARNERS))
def test_sync_events_are_the_counted_reads(learner, obs_dir):
    """One sync event per learner read, plus the eval read and the
    telemetry stream sync, each attributed to a port file:line."""
    run = _port_run(learner, obs_dir)
    per_it = {}
    for e in run["events"]:
        if e.get("cat") == "sync":
            it = e["args"]["iteration"]
            per_it[it] = per_it.get(it, 0) + 1
            assert e["args"]["site"].startswith("lightgbm_tpu_torch/")
            assert "/obs/" not in e["args"]["site"]
    learner_reads = np.diff([0] + run["syncs"]).tolist()
    assert [per_it[i] for i in range(ROUNDS)] == \
        [n + 2 for n in learner_reads]
    streams = [e for e in run["events"] if e.get("cat") == "sync"
               and e["name"].startswith("block_until_ready@")]
    assert len(streams) == ROUNDS


@pytest.mark.parametrize("learner", sorted(LEARNERS))
def test_telemetry_changes_no_result(learner, obs_dir):
    run = _port_run(learner, obs_dir)
    X, y = _make_data()
    hist = {}
    ds = tlgb.Dataset(X, label=y)
    plain = tlgb.train(dict(BASE, device_type="cpu", **LEARNERS[learner]),
                       ds, num_boost_round=ROUNDS,
                       valid_sets=[ds.create_valid(run["Xv"],
                                                   label=run["yv"])],
                       verbose_eval=False, evals_result=hist)
    assert _obs_text(plain) == _obs_text(run["booster"])
    assert np.array_equal(plain.predict(X, raw_score=True),
                          run["booster"].predict(X, raw_score=True))
    assert hist == run["hist"]
    # and nothing stays active after train()
    assert tobs.active() is None and ttrace.active_tracer() is None
    assert ttrace._SYNC_PATCH is None
    assert tdevice.device_get.__name__ == "device_get"


@pytest.mark.parametrize("learner", sorted(LEARNERS))
def test_metrics_interval_samples_the_records(learner, obs_dir):
    run = _port_run(learner, obs_dir, metrics_interval=2)
    assert [r["iteration"] for r in run["records"]] == \
        list(range(0, ROUNDS, 2))


@pytest.mark.parametrize("learner", sorted(LEARNERS))
def test_trace_report_equal_on_a_training_trace(learner, obs_dir):
    ev = _port_run(learner, obs_dir)["events"]
    assert treport.format_report(treport.summarize(ev)) == \
        jreport.format_report(jreport.summarize(ev))


def test_record_metrics_reads_the_registry(obs_dir):
    X, y = _make_data()
    store = []
    _train(tlgb, dict(BASE, trace_file=os.path.join(obs_dir, "rm.json")),
           X, y, 3, callbacks=[tlgb.record_metrics(store)])
    assert [r["iteration"] for r in store] == [0, 1, 2]
    assert all("t_hist_s" in r and "counters" in r for r in store)


def test_profile_dir_writes_a_chrome_trace(tmp_path):
    X, y = _make_data()
    _train(tlgb, dict(BASE, profile_dir=str(tmp_path / "prof")), X, y, 2)
    files = os.listdir(tmp_path / "prof")
    assert len(files) == 1 and files[0].startswith("trace_")
    with open(tmp_path / "prof" / files[0]) as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]}
    # every iteration's events stay in the trace, not only the last
    # profiler cycle's
    assert {"fused/leaf_histogram", "fused/split_scan", "fused/partition",
            "boosting_iteration#0", "boosting_iteration#1"} <= names


def test_tpu_warmup_warns_naming_a15(monkeypatch):
    """``tpu_warmup`` / ``LGBM_TPU_WARMUP`` start the kernels' background
    build now (compile/warmup.py): no warning names ROADMAP A15 any
    more, and for the CPU no build thread starts."""
    import threading
    msgs = []
    tlog.register_log_callback(msgs.append)
    try:
        X, y = _make_data()
        _train(tlgb, dict(BASE, tpu_warmup=True, verbose=0), X, y, 1)
        monkeypatch.setenv("LGBM_TPU_WARMUP", "1")
        _train(tlgb, dict(BASE, verbose=0), X, y, 1)
        monkeypatch.delenv("LGBM_TPU_WARMUP")
        _train(tlgb, dict(BASE, verbose=0), X, y, 1)
    finally:
        tlog.register_log_callback(None)
    assert sum("ROADMAP A15" in m for m in msgs) == 0
    assert not [t for t in threading.enumerate()
                if t.name == "lgbm-cuda-warmup"]


def test_disabled_path_is_a_passthrough():
    assert tobs.active() is None and ttrace.active_tracer() is None
    calls = []
    wrapped = tspans.instrument_kernel(lambda x: calls.append(x) or x * 2,
                                       "hist")
    with tspans.span("anything", phase="hist"):
        assert wrapped(3) == 6
    assert calls == [3]
    t = torch.arange(4)
    assert tdevice.device_get(t).tolist() == [0, 1, 2, 3]
    assert [a.tolist() for a in tdevice.device_get([t, t + 1])] == \
        [[0, 1, 2, 3], [1, 2, 3, 4]]
    tdevice.block_until_ready("cpu")


def test_sync_tracing_install_is_balanced():
    real = (tdevice.device_get, tdevice.block_until_ready)
    assert ttrace.install_sync_tracing() is True
    assert ttrace.install_sync_tracing() is True      # idempotent
    assert tdevice.device_get is not real[0]
    reg = tobs.activate(tobs.MetricsRegistry())
    try:
        tdevice.device_get(torch.ones(3))
        tdevice.block_until_ready("cpu")
    finally:
        tobs.deactivate(reg)
        ttrace.uninstall_sync_tracing()
        ttrace.uninstall_sync_tracing()
    assert (tdevice.device_get, tdevice.block_until_ready) == real
    assert reg.latency_histograms()["lat.fetch.device_get"].count == 1
    assert reg.latency_histograms()["lat.fetch.block_until_ready"].count == 1


def test_live_bytes_absent_on_the_cpu():
    assert ttrace.live_array_bytes("cpu") == -1
    if not torch.cuda.is_available():
        assert ttrace.live_array_bytes() == -1


# -- counters on the drills, against the JAX package ------------------------

DRILLS = {
    # the second checkpoint write fails: fault.*, ckpt.saves / write_errors
    "checkpoint_enospc": (
        {}, "checkpoint.write:enospc@2", True, 6,
        ("fault.fired", "fault.checkpoint.write", "ckpt.saves",
         "ckpt.write_errors", "ckpt.resume", "ckpt.invalid")),
    # a NaN gradient plane on the host loop: quarantine
    "quarantine": (
        {"tpu_fused": False, "numeric_sentinels": True},
        "train.iteration:nan@3", False, 6,
        ("fault.fired", "fault.train.iteration", "health.quarantined",
         "health.sentinel_trips", "health.nan")),
    # a hang healed from the last checkpoint, quantized host loop
    "hang_quantized": (
        {"tpu_fused": False, "use_quantized_grad": True, "hang_timeout": 1.2,
         "auto_resume": True}, "train.iteration:hang=3.0@4", True, 6,
        ("fault.fired", "fault.train.iteration", "watchdog.trips",
         "watchdog.stall_iteration", "watchdog.auto_resume", "ckpt.saves",
         "ckpt.resume", "hist.quant_requantize_passes")),
}
_DRILL_COUNTERS = {}


def _drill_counters(lib, drill, tmp_path):
    key = (lib.__name__, drill)
    if key not in _DRILL_COUNTERS:
        extra, plan, ckpt, rounds, names = DRILLS[drill]
        inst = install_plan if lib is tlgb else jinstall
        mfile = str(tmp_path / f"{lib.__name__}_{drill}.jsonl")
        inst(plan)
        try:
            X, y = _make_data()
            _train(lib, dict(BASE, metrics_file=mfile, **extra), X, y,
                   rounds, str(tmp_path / f"ck_{lib.__name__}_{drill}")
                   if ckpt else None)
        finally:
            inst(None)
        recs = (tobs if lib is tlgb else jobs).read_jsonl(mfile)
        last = recs[-1]["counters"]
        _DRILL_COUNTERS[key] = ({n: last.get(n, 0) for n in names}, recs)
    return _DRILL_COUNTERS[key]


@pytest.mark.parametrize("drill", sorted(DRILLS))
def test_drill_counters_equal_the_jax_packages(drill, tmp_path):
    port, port_recs = _drill_counters(tlgb, drill, tmp_path)
    jax_, jax_recs = _drill_counters(jlgb, drill, tmp_path)
    assert port == jax_
    assert any(v > 0 for v in port.values())
    # each package's validator accepts the other's records
    for r in jax_recs:
        assert tobs.validate_record(r) == []
    for r in port_recs:
        assert jobs.validate_record(r) == []


# -- the watchdog's diagnosis and the flight recorder on a hang -------------

def test_hang_writes_one_flight_bundle(tmp_path):
    X, y = _make_data()
    fdir = tmp_path / "flight"
    install_plan("train.iteration:hang=0.6@3")
    from lightgbm_tpu_torch.robust import HangTimeout
    with pytest.raises(HangTimeout) as ei:
        _train(tlgb, dict(BASE, hang_timeout=0.25, flight_dir=str(fdir),
                          trace_file=str(tmp_path / "t.json")), X, y, 5)
    d = ei.value.diagnosis
    assert d["trace_file"] == str(tmp_path / "t.json") + ".watchdog.json"
    assert os.path.isfile(d["trace_file"])
    assert d["slowest_rank"] == 0 and d["host_skew"] == 0.0
    bundles = os.listdir(fdir)
    assert len(bundles) == 1 and bundles[0].endswith("_watchdog")
    b = fdir / bundles[0]
    assert sorted(os.listdir(b)) == ["fleet.json", "manifest.json",
                                     "registry.json", "stacks.txt",
                                     "trace.json"]
    man = json.loads((b / "manifest.json").read_text())
    assert man["trigger"] == "watchdog" and man["info"]["iteration"] == 3
    assert "trace_signature" in man and "config" in man
    reg = json.loads((b / "registry.json").read_text())
    assert reg["counters"]["watchdog.trips"] == 1
    assert reg["counters"]["watchdog.stall_iteration"] == 1


@pytest.mark.parametrize("telemetry", [False, True])
@pytest.mark.parametrize("learner", sorted(LEARNERS))
def test_learner_is_freed_with_its_booster(learner, telemetry, tmp_path):
    """The instrumented dispatchers hold no learner: dropping the booster
    frees its learners (and their device tensors) by reference counting,
    with or without telemetry, and without a garbage collection."""
    import gc
    import weakref
    X, y = _make_data()
    params = dict(BASE, device_type="cpu", **LEARNERS[learner])
    if telemetry:
        params.update(metrics_file=str(tmp_path / "m.jsonl"),
                      trace_file=str(tmp_path / "t.json"))
    gc.collect()
    gc.disable()
    try:
        b = tlgb.train(params, tlgb.Dataset(X, label=y), num_boost_round=2,
                       verbose_eval=False)
        gb = b._gbdt
        refs = [weakref.ref(x) for x in (gb._fused, gb.tree_learner)
                if x is not None]
        assert refs
        del b, gb
        assert [r() for r in refs] == [None] * len(refs)
    finally:
        gc.enable()
