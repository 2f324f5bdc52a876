"""Compile and warm-up of the port (``lightgbm_tpu_torch/compile/``)
against the JAX package's ``compile/``, on the CPU.

- ``warmup_wanted`` and ``bucket_min_rows`` give the JAX package's
  answers over a grid of environments, configs and row counts
  (tolerance: equality).
- ``task=warmup`` (and the ``warmup`` subcommand) on a CSV with
  ``device_type=cpu`` returns its summary with the JAX Dataset's
  ``num_data`` and builds nothing; ``tpu_warmup`` starts no thread for
  the CPU and, on the card, starts the background build before the
  Dataset is binned (simulated here: the build replaced by a recorder).
- ``ops/cuda.py build_all`` counts each library found by its hash, each
  one built and the build's seconds (``compile.*``), without nvcc: the
  compiler and the loader are replaced by stand-ins.
- The endpoint's ``/statusz`` page has a ``compile`` block, as the JAX
  package's.
"""
import itertools
import os
import threading

import numpy as np
import pytest

import lightgbm_tpu as jlgb
from lightgbm_tpu.compile import signature as jsig
from lightgbm_tpu.compile import warmup as jwarm
from lightgbm_tpu.obs import httpd as jhttpd
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch import cli as tcli
from lightgbm_tpu_torch import obs as tobs
from lightgbm_tpu_torch.compile import manager as tman
from lightgbm_tpu_torch.compile import signature as tsig
from lightgbm_tpu_torch.compile import warmup as twarm
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.obs import httpd as thttpd
from lightgbm_tpu_torch.ops import cuda as tcuda


@pytest.fixture(autouse=True, scope="module")
def _no_aot_store():
    from lightgbm_tpu.compile.manager import get_manager
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LGBM_TPU_AOT", "0")
        mp.setattr(get_manager(), "aot_enabled", False)
        yield


@pytest.mark.parametrize("env,bucket_min", list(itertools.product(
    [None, "0", "1", "true", "false", "yes"], [None, "1000", "junk"])))
def test_warmup_wanted_matches_jax(monkeypatch, env, bucket_min):
    for var, val in (("LGBM_TPU_WARMUP", env),
                     ("LGBM_TPU_BUCKET_MIN", bucket_min)):
        if val is None:
            monkeypatch.delenv(var, raising=False)
        else:
            monkeypatch.setenv(var, val)
    assert tsig.bucket_min_rows() == jsig.bucket_min_rows()
    for flag, rows in itertools.product((False, True),
                                        (0, 999, 1000, 1 << 20)):
        cfg = Config.from_params({"tpu_warmup": flag})
        assert twarm.warmup_wanted(cfg, rows) == \
            jwarm.warmup_wanted(cfg, rows), (flag, rows)


def _csv(tmp_path, n=300):
    rng = np.random.RandomState(4)
    X = rng.randn(n, 5)
    y = (X[:, 0] + 0.3 * rng.randn(n) > 0).astype(float)
    path = tmp_path / "train.csv"
    np.savetxt(path, np.column_stack([y, X]), delimiter=",", fmt="%.6f")
    return str(path)


@pytest.mark.parametrize("subcommand", [False, True],
                         ids=["task_key", "subcommand"])
def test_task_warmup_on_cpu_builds_nothing(tmp_path, monkeypatch,
                                           subcommand):
    data = _csv(tmp_path)
    keys = [f"data={data}", "label_column=0", "num_leaves=7",
            "device_type=cpu", "verbosity=-1"]
    argv = (["warmup"] + keys) if subcommand else (["task=warmup"] + keys)
    monkeypatch.setattr(tcuda, "build_all", lambda: pytest.fail(
        "task=warmup built the kernels for device_type=cpu"))
    before = tman.snapshot()
    assert tcli.main(argv) == 0
    params = tcli.parse_args(argv)
    summary = twarm.run_warmup(Config.from_params(params), params)
    jds = jlgb.Dataset(data, params={"label_column": "0",
                                     "verbosity": -1}).construct()
    assert summary["num_data"] == jds.num_data() == 300
    assert (summary["entries"], summary["compiled"]) == (0, 0)
    assert summary["build_dir"] == tcuda.BUILD_DIR
    assert tman.snapshot() == before


def test_task_warmup_requires_data():
    with pytest.raises(ValueError, match="data="):
        twarm.run_warmup(Config.from_params({"task": "warmup"}),
                         {"task": "warmup"})


def _fake_toolchain(monkeypatch, tmp_path):
    """Point the build directory at ``tmp_path`` and stand in for nvcc
    (a process that writes its output file) and for the loader; returns
    the list of sources compiled."""
    compiled = []
    monkeypatch.setattr(tcuda, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(tcuda, "_libs", {})
    monkeypatch.setattr(tcuda, "_nvcc", lambda: "nvcc")

    class Proc:
        returncode = 0

        def __init__(self, argv, **kw):
            out = argv[argv.index("-o") + 1]
            compiled.append(os.path.basename(argv[-1]))
            with open(out, "wb") as fh:
                fh.write(b"\0")

        def communicate(self):
            return b"", b""

    class Lib:
        def __getattr__(self, name):
            return type("Fn", (), {})()
    monkeypatch.setattr(tcuda.subprocess, "Popen", Proc)
    monkeypatch.setattr(tcuda.ctypes, "CDLL", lambda path: Lib())
    return compiled


def test_build_counts_hits_misses_and_programs(tmp_path, monkeypatch):
    compiled = _fake_toolchain(monkeypatch, tmp_path)
    reg = tobs.MetricsRegistry()
    tobs.activate(reg)
    try:
        before = tman.snapshot()
        tcuda.build_all()
        cold = tman.snapshot()
        monkeypatch.setattr(tcuda, "_libs", {})
        os.remove(tcuda._lib_path("partition"))
        tcuda.build_all()
        warm = tman.snapshot()
    finally:
        tobs.deactivate(reg)
    n = len(tcuda.SOURCES)

    def delta(a, b, k):
        return b.get(k, 0) - a.get(k, 0)
    assert sorted(compiled) == sorted([f"{s}.cu" for s in tcuda.SOURCES]
                                      + ["partition.cu"])
    assert [delta(before, cold, k) for k in
            ("programs", "cache_misses", "cache_hits")] == [n, n, 0]
    assert [delta(cold, warm, k) for k in
            ("programs", "cache_misses", "cache_hits")] == [1, 1, n - 1]
    assert delta(before, warm, "compile_s") > 0
    assert reg.counters["compile.programs"] == n + 1
    assert reg.counters["compile.cache_hits"] == n - 1
    assert tcuda.all_loaded()


def test_background_warmup_builds_on_a_thread(tmp_path, monkeypatch):
    """On the card the build runs on a tracked daemon thread started
    before the Dataset is binned; none starts for the CPU, and no
    warning names the warm-up any more."""
    compiled = _fake_toolchain(monkeypatch, tmp_path)
    assert twarm.background_warmup("cpu") is None
    th = twarm.background_warmup("cuda")
    assert th is not None and th.daemon and th.name == "lgbm-cuda-warmup"
    th.join(30)
    assert len(compiled) == len(tcuda.SOURCES) and tcuda.all_loaded()
    # every library loaded: nothing to start
    assert twarm.background_warmup("cuda") is None

    started = []
    monkeypatch.setattr(tcuda, "_libs", {})
    monkeypatch.setattr("lightgbm_tpu_torch.engine.background_warmup",
                        lambda device_type: started.append(
                            (device_type, threading.current_thread())))
    from lightgbm_tpu_torch.utils import log as tlog
    msgs = []
    tlog.register_log_callback(msgs.append)
    try:
        X = np.random.RandomState(0).randn(200, 4)
        y = (X[:, 0] > 0).astype(float)
        tlgb.train({"device_type": "cpu", "verbose": 0, "tpu_warmup": True,
                    "num_leaves": 7}, tlgb.Dataset(X, label=y),
                   num_boost_round=1)
        tlgb.train({"device_type": "cpu", "verbose": 0, "num_leaves": 7},
                   tlgb.Dataset(X, label=y), num_boost_round=1)
    finally:
        tlog.register_log_callback(None)
    assert started == [("cpu", threading.main_thread())]
    assert not [m for m in msgs if "warm" in m.lower()]


def test_statusz_has_compile_block():
    for mod in (jhttpd, thttpd):
        body = mod.render_statusz()
        assert "compile" in body and isinstance(body["compile"], dict)
    tman.count("cache_hits", 0)
    assert "cache_hits" in thttpd.render_statusz()["compile"]
