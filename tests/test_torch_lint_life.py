"""The port's linter, lifetime and threading packs and the runtime
cross-checks, held against the JAX package's on the CPU.

- twin fixtures of the JAX lifelint tests (checkpoint / flight /
  telemetry escapes, pending reads that are never drained, threads),
  flagged at the same lines;
- graph-rebind, the port's counterpart of use-after-donate: a buffer a
  kept CUDA graph reads, rebound after capture;
- the whole package clean per pack, the static graph buffers and the
  spawn inventory of the port;
- the runtime cross-check on the CPU: the counted reads of three
  iterations on the persistent path, a bagging per-tree path and DART,
  each with a valid set, all lie in the static inventory and those of
  the steady updates in the hot inventory; the card-only probes raise
  without a card.
"""
import ast
import os
import textwrap

import numpy as np
import pytest

from lightgbm_tpu.analysis import core as jcore
from lightgbm_tpu.analysis import lifetime as jlifetime
from lightgbm_tpu.analysis import threads as jthreads
from lightgbm_tpu_torch.analysis import core as pcore
from lightgbm_tpu_torch.analysis import lifetime, runtime_check, threads

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def write_pkg(root, pkg_name, files):
    for rel, src in files.items():
        p = root / pkg_name / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))


def jax_pkg(tmp_path, files):
    write_pkg(tmp_path / "jax", "lightgbm_tpu", files)
    return jcore.Package.load(str(tmp_path / "jax"), subdir="lightgbm_tpu")


def port_pkg(tmp_path, files):
    write_pkg(tmp_path / "port", "lightgbm_tpu_torch", files)
    return pcore.Package.load(str(tmp_path / "port"))


def rows(findings):
    return sorted({(f.path.split("/", 1)[1], f.line, f.code)
                   for f in findings})


def jax_fixture(test):
    """The files of the first `make_pkg(tmp_path, {...})` call of one
    test of the JAX package's tests/test_lifelint.py."""
    path = os.path.join(REPO_ROOT, "tests", "test_lifelint.py")
    tree = ast.parse(open(path).read())
    env = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and isinstance(node.value,
                                                       ast.Constant):
            exec(compile(ast.Module([node], []), path, "exec"), env)
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == test)
    call = next(c for c in ast.walk(fn) if isinstance(c, ast.Call)
                and getattr(c.func, "id", None) == "make_pkg")
    return eval(compile(ast.Expression(call.args[1]), path, "eval"), env)


@pytest.fixture(scope="module")
def repo_pkg():
    return pcore.Package.load(REPO_ROOT)


# ------------------------------------------------------ the whole package

@pytest.mark.parametrize("pack", [lifetime, threads],
                         ids=["buffer-lifetime", "thread-shared-state"])
def test_package_clean(pack, repo_pkg):
    found = pack.check(repo_pkg)
    assert found == [], "\n".join(map(str, found))


def test_repo_graph_buffers(repo_pkg):
    """The captured split step's buffers: the tree state (through its
    memo getter `_tree_state`), the partition buffers, the learner's
    device tables; the graph dict is the holder; the key holds `data`'s
    address."""
    info = lifetime.graph_buffers(repo_pkg)[
        ("lightgbm_tpu_torch/treelearner/fused.py", "FusedSerialGrower")]
    assert {"_st", "_part_bufs", "feature_miss_bin", "_efb_dev",
            "meta"} <= info["attrs"]
    assert info["holders"] == {"_graph", "_graph_pool"}
    assert info["key_ptrs"] == {"data"}


def test_repo_spawn_inventory(repo_pkg):
    sites = threads.spawn_inventory(repo_pkg)
    assert {s.kind for s in sites} == {"thread", "handler"}
    assert threads.thread_names(repo_pkg) == {
        "lgbm-tpu-obs-httpd", "lgbm-torch-watchdog",
        "lgbm-startup-barrier", "lgbm-cuda-warmup"}
    assert any(s.roots == ("lightgbm_tpu_torch/obs/httpd.py::"
                           "_Handler.do_GET",) for s in sites)


# ------------------------------------------------------ twin fixtures

TWINS = {
    "test_escape_checkpoint_flagged_and_laundered": {"ck.py": """\
        import numpy as np
        import torch

        class Learner:
            def checkpoint_state(self):
                grads = torch.zeros(4)
                state = {}
                state["grads"] = grads
                state["ok"] = np.asarray(grads)
                return state
        """},
    "test_escape_flight_and_telemetry": {"fl.py": """\
        import torch

        def snap(rec, reg):
            x = torch.zeros(3)
            rec.dump("oom", x)
            reg.set_gauge("loss", x)
            reg.set_gauge("loss_host", float(x))
        """},
    "test_fetch_no_drain": {"fe.py": """\
        class NoDrain:
            def __init__(self):
                self._pending = []

            def fetch(self, arr):
                h = start_read(arr)
                self._pending.append(h)
        """},
    "test_fetch_drained_and_ckpt_reaches_drain": {"fe.py": """\
        class Drained:
            def __init__(self):
                self._pending = []

            def fetch(self, arr):
                h = start_read(arr)
                self._pending.append(h)

            def drain(self):
                self._pending = []

            def checkpoint_state(self):
                self.drain()
                return {}
        """},
    "test_fetch_ckpt_live": {"fe.py": """\
        class CkptLive:
            def __init__(self):
                self._pending = []

            def fetch(self, arr):
                h = start_read(arr)
                self._pending.append(h)

            def drain(self):
                self._pending = []

            def checkpoint_state(self):
                return {}
        """},
    # threads: the JAX fixtures themselves (no JAX spelling in them)
    "test_unlocked_mutation_on_thread_flagged": None,
    "test_thread_ok_class_pragma_suppresses": None,
    "test_generic_and_external_receivers_do_not_leak": None,
}


@pytest.mark.parametrize("test", sorted(TWINS))
def test_twin_fixture_flagged_at_the_same_lines(test, tmp_path):
    jmod, pmod = (jthreads, threads) if TWINS[test] is None \
        else (jlifetime, lifetime)
    original = jax_fixture(test)
    want = rows(jmod.check(jax_pkg(tmp_path, original)))
    got = rows(pmod.check(port_pkg(tmp_path, TWINS[test] or original)))
    assert got == want
    assert bool(want) == (test not in (
        "test_fetch_drained_and_ckpt_reaches_drain",
        "test_thread_ok_class_pragma_suppresses",
        "test_generic_and_external_receivers_do_not_leak"))


# ----------------------------------------------------- graph-rebind

_REBIND_SRC = """\
    import torch
    from .compile import manager

    class L:
        def __init__(self):
            self.buf = torch.zeros(4)
            self._st = None
            self._graph = None

        def _state(self):
            if self._st is not None:
                return self._st
            self._st = torch.zeros(8)
            return self._st

        def _step(self, st):
            st.add_(self.buf)

        def grow(self):
            st = self._state()
            self._replay(st)

        def _replay(self, st):
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                self._step(st)
            manager.count("graph_captures")
            self._graph = g

        def reset(self):
            self.buf = torch.ones(4)
            self._st = None

        def reset_all(self):
            self._st = None
            self._graph = None

        def refill(self):
            self.buf.copy_(torch.ones(4))
"""


def test_graph_rebind_flagged(tmp_path):
    pkg = port_pkg(tmp_path, {"mod.py": _REBIND_SRC})
    assert rows(lifetime.check(pkg)) == [
        ("mod.py", 31, "graph-rebind:L.buf"),
        ("mod.py", 32, "graph-rebind:L._st")]
    info = lifetime.graph_buffers(pkg)[("lightgbm_tpu_torch/mod.py", "L")]
    assert {"buf", "_st"} <= info["attrs"] and "_graph" in info["holders"]


def test_graph_rebind_annotated_twin(tmp_path):
    lines = textwrap.dedent(_REBIND_SRC).split("\n")
    for ln in (31, 32):
        lines[ln - 1] += "  # tpulint: life-ok(fixture: re-captured after)"
    assert lifetime.check(port_pkg(tmp_path,
                                   {"mod.py": "\n".join(lines)})) == []


# ---------------------------------------------- runtime, on the CPU

def _data(n, seed):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, 6).astype(np.float32)
    y = (X[:, 0] + rng.rand(n) > 1.0).astype(np.float32)
    return X, y


@pytest.mark.parametrize("extra", [
    {},
    {"bagging_fraction": 0.7, "bagging_freq": 1},
    {"boosting": "dart"},
], ids=["persistent", "bagging-per-tree", "dart"])
def test_runtime_reads_lie_in_the_static_inventory(extra, repo_pkg):
    import lightgbm_tpu_torch as lgt
    inv = runtime_check.static_inventory(repo_pkg)
    hot = runtime_check.static_hot_inventory(repo_pkg)
    X, y = _data(2000, 0)
    Xv, yv = _data(500, 1)
    ds = lgt.Dataset(X, label=y)
    vs = ds.create_valid(Xv, label=yv)
    params = {"objective": "binary", "num_leaves": 7, "verbose": -1,
              "device_type": "cpu", **extra}
    from lightgbm_tpu_torch.utils import device
    real = device.device_get
    every, steady = [], []
    with runtime_check.record_device_gets(every):
        b = lgt.train(params, ds, num_boost_round=1, valid_sets=[vs],
                      keep_training_booster=True, verbose_eval=False)
        with runtime_check.record_device_gets(steady):
            for _ in range(2):
                b.update()
                b._gbdt.eval_at_iter()
    assert steady, "no counted read in the steady updates"
    assert runtime_check.unexplained(every, inv) == []
    assert runtime_check.unexplained(steady, hot) == []
    assert device.device_get is real        # the patch is gone


def test_card_probes_raise_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        with runtime_check.transfer_guard_no_transfers():
            pass
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        with runtime_check.implicit_sync_sites([]):
            pass


@pytest.mark.parametrize("dtype", [None, "int64"])
def test_upload_on_the_cpu(dtype):
    """utils/device.py upload (the bag and the feature masks): on the CPU
    the array as a tensor, as torch.as_tensor gives it."""
    import torch
    from lightgbm_tpu_torch.utils import device
    arr = np.random.RandomState(1).permutation(1000)
    want = torch.as_tensor(arr, dtype=None if dtype is None
                           else getattr(torch, dtype))
    got = device.upload(arr, "cpu", dtype=want.dtype)
    assert got.device.type == "cpu" and got.dtype == want.dtype
    assert torch.equal(got, want)


def test_graph_shadow_check_on_the_cpu(repo_pkg):
    """No graph is captured on the CPU: the check sees none and finds
    nothing unaccounted; the holders it checks against are static."""
    import lightgbm_tpu_torch as lgt
    X, y = _data(500, 2)
    b = lgt.train({"objective": "binary", "num_leaves": 7, "verbose": -1,
                   "device_type": "cpu"}, lgt.Dataset(X, label=y),
                  num_boost_round=2, keep_training_booster=True,
                  verbose_eval=False)
    learner = b._gbdt._fused
    report = runtime_check.graph_shadow_check(
        learner, [b._gbdt._fused_state], pkg=repo_pkg)
    assert report["graphs"] == 0 and report["unaccounted"] == []
    assert "_graph" in report["static_holders"]


def test_thread_check_with_the_obs_endpoint(repo_pkg):
    from lightgbm_tpu_torch.obs import MetricsRegistry
    from lightgbm_tpu_torch.obs.httpd import ObsServer
    srv = ObsServer(0, registry=MetricsRegistry())
    try:
        srv.start()
        report = runtime_check.thread_check(pkg=repo_pkg)
        assert "lgbm-tpu-obs-httpd" in report["live"], report
        assert report["unaccounted"] == [], report
    finally:
        srv.stop()
