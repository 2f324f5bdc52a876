"""The port's linter (lightgbm_tpu_torch/analysis/), host-side packs,
held against the JAX package's (lightgbm_tpu/analysis/) on the CPU.

- (a) the shared packs: the JAX `locks` and `threads` packs over
  lightgbm_tpu_torch give exactly the port's findings, and so do both
  over the JAX test files' own fixture sources; pragma hygiene and the
  baseline functions agree on equal inputs;
- (b) the cores: on fixture packages free of third-party imports both
  `core.Package`s give equal functions, call graphs, reachable sets and
  pragmas (the port's fallback differs by design in two documented
  cases, tested apart);
- (c) twin fixtures: the JAX pack flags a JAX test's fixture and the
  port's pack flags its torch twin, laid out line for line, at the same
  lines with the mapped code; every rule new to the port has a seeded
  violation and an annotated twin;
- (d) the whole package: the gate against the checked-in baseline, the
  CLI, the obs gauges.
"""
import ast
import json
import os
import subprocess
import sys
import textwrap

import pytest

from lightgbm_tpu.analysis import core as jcore
from lightgbm_tpu.analysis import locks as jlocks
from lightgbm_tpu.analysis import sync_points as jsync
from lightgbm_tpu.analysis import threads as jthreads
from lightgbm_tpu.analysis import trace_safety as jtrace
from lightgbm_tpu.analysis import pragma_hygiene as jhygiene
from lightgbm_tpu_torch import analysis
from lightgbm_tpu_torch.analysis import core as pcore
from lightgbm_tpu_torch.analysis import (locks, recompile, sync_points,
                                         threads, trace_safety)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TESTS = ("test_tpulint", "test_meshlint", "test_lifelint")


# ------------------------------------------------------------------ helpers

def write_pkg(root, pkg_name, files):
    for rel, src in files.items():
        p = root / pkg_name / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))


def jax_pkg(tmp_path, files):
    root = tmp_path / "jax"
    write_pkg(root, "lightgbm_tpu", files)
    return jcore.Package.load(str(root), subdir="lightgbm_tpu")


def port_pkg(tmp_path, files):
    root = tmp_path / "port"
    write_pkg(root, "lightgbm_tpu_torch", files)
    return pcore.Package.load(str(root))


def rows(findings, code_map=None):
    """(path inside the package, line, code) of each finding; codes
    mapped through `code_map` (None drops a code without counterpart)."""
    out = set()
    for f in findings:
        code = f.code if code_map is None else code_map.get(f.code, f.code)
        if code is not None:
            out.add((f.path.split("/", 1)[1], f.line, code))
    return sorted(out)


def jax_fixtures(module):
    """{test name: [files dict, ...]} of every `make_pkg(tmp_path,
    {...})` call in one of the JAX package's analysis test files."""
    path = os.path.join(REPO_ROOT, "tests", f"{module}.py")
    tree = ast.parse(open(path).read())
    env = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and isinstance(node.value,
                                                       ast.Constant):
            exec(compile(ast.Module([node], []), path, "exec"), env)
    out = {}
    for fn in tree.body:
        if not isinstance(fn, ast.FunctionDef):
            continue
        for call in ast.walk(fn):
            if isinstance(call, ast.Call) \
                    and getattr(call.func, "id", None) == "make_pkg" \
                    and len(call.args) >= 2:
                files = eval(compile(ast.Expression(call.args[1]), path,
                                     "eval"), dict(env))
                out.setdefault(fn.name, []).append(files)
    return out


@pytest.fixture(scope="module")
def port_run():
    """The whole-package analysis of the port, once for this module,
    under an active obs registry (its gauges land in `GAUGES`)."""
    from lightgbm_tpu_torch import obs
    pkg = pcore.Package.load(REPO_ROOT)
    reg = obs.MetricsRegistry()
    obs.activate(reg)
    try:
        result = analysis.run(REPO_ROOT, pkg=pkg)
    finally:
        obs.activate(None)
    GAUGES.update(reg.gauges)
    return pkg, result


GAUGES = {}


@pytest.fixture(scope="module")
def jax_over_port(port_run):
    """The JAX package's core over the port's files."""
    pkg, _ = port_run
    return jcore.Package(REPO_ROOT, sorted(pkg.files),
                         pkg_name="lightgbm_tpu_torch")


# ------------------------------------------------------- (d) whole package

def test_package_is_clean_against_baseline(port_run):
    _, result = port_run
    msgs = "\n".join(f"{f.path}:{f.line} [{f.rule}:{f.code}] {f.message}"
                     for f in result.new)
    assert result.ok, f"the port's linter found new issues:\n{msgs}"
    assert result.baselined == [] and result.baseline_size == 0


def test_baseline_is_empty_and_shrink_only():
    baseline = pcore.load_baseline(analysis.DEFAULT_BASELINE)
    assert baseline == {}, "baseline entries must be named in CHANGES.md"


def test_hot_inventory_nonempty_and_annotated(port_run):
    pkg, result = port_run
    hot = sync_points.hot_sites(pkg)
    assert result.hot_sync_count == sync_points.hot_sync_count(pkg) > 0
    assert all(s.annotated for s in hot)
    # the counted reads of the fused paths are in it: the evaluation
    # read and the pending trees' one read
    rels = {(s.rel.split("/", 1)[1], s.code) for s in hot}
    assert ("boosting/gbdt.py", "device_get") in rels
    assert ("treelearner/fused.py", "device_get") in rels


def test_cli_exits_zero():
    proc = subprocess.run(
        [sys.executable, "-m", "lightgbm_tpu_torch.analysis"],
        cwd=REPO_ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("tpulint: 0 new finding(s), 0 baselined")


def test_cli_json_exits_zero_and_lists_every_pack(port_run, monkeypatch,
                                                  capsys):
    from lightgbm_tpu_torch.analysis.__main__ import main
    pkg, _ = port_run
    monkeypatch.setattr(pcore.Package, "load",
                        classmethod(lambda cls, root=None, subdir=None: pkg))
    assert main(["--json"]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload["ok"] and payload["new"] == []
    assert payload["by_pack"] == {r: 0 for r in analysis.RULE_PACKS}
    assert payload["baseline_size"] == 0 and payload["hot_sync_count"] > 0


def test_cli_json_locations_on_a_seeded_tree(tmp_path, capsys):
    from lightgbm_tpu_torch.analysis.__main__ import main
    write_pkg(tmp_path, "lightgbm_tpu_torch", {"boosting/fix.py": """\
        from ..utils import device

        class G:
            def train_one_iter(self):
                return device.device_get(self.score())
        """})
    rc = main(["--root", str(tmp_path), "--no-baseline", "--json",
               "--rules", "sync-point"])
    payload = json.loads(capsys.readouterr().out)
    assert rc == 1 and not payload["ok"]
    assert payload["by_pack"] == {"sync-point": 1}
    assert payload["new"][0]["location"] == \
        "lightgbm_tpu_torch/boosting/fix.py:5"


def test_run_publishes_obs_gauges(port_run):
    for g in ("lint.findings", "lint.baseline_size", "lint.mesh_findings",
              "lint.tile_findings", "lint.dtype_findings",
              "lint.life_findings", "lint.thread_findings"):
        assert GAUGES.get(g) == 0.0, g


# ------------------------------------------------------ (a) shared packs

@pytest.mark.parametrize("pack", ["locks", "threads"])
def test_shared_pack_matches_jax_on_the_port(pack, port_run, jax_over_port):
    pkg, _ = port_run
    jmod, pmod = {"locks": (jlocks, locks),
                  "threads": (jthreads, threads)}[pack]
    key = [(f.path, f.line, f.rule, f.code) for f in jmod.check(jax_over_port)]
    assert key == [(f.path, f.line, f.rule, f.code) for f in pmod.check(pkg)]
    assert key == []            # every shared-state site carries its reason


def test_spawn_inventory_matches_jax_on_the_port(port_run, jax_over_port):
    pkg, _ = port_run
    assert threads.thread_names(pkg) == jthreads.thread_names(jax_over_port)
    assert {"lgbm-tpu-obs-httpd", "lgbm-torch-watchdog",
            "lgbm-startup-barrier", "lgbm-cuda-warmup"} <= \
        threads.thread_names(pkg)


@pytest.mark.parametrize("module", JAX_TESTS)
@pytest.mark.parametrize("pack", ["locks", "threads"])
def test_shared_pack_matches_jax_on_jax_fixtures(module, pack, tmp_path):
    """Every fixture source of the JAX analysis tests, analyzed by both
    packages' `pack`: the same findings."""
    jmod, pmod = {"locks": (jlocks, locks),
                  "threads": (jthreads, threads)}[pack]
    n = 0
    for name, calls in sorted(jax_fixtures(module).items()):
        for i, files in enumerate(calls):
            d = tmp_path / f"{name}_{i}"
            want = rows(jmod.check(jax_pkg(d, files)))
            assert rows(pmod.check(port_pkg(d, files))) == want, name
            n += len(want)
    if (module, pack) in (("test_tpulint", "locks"),
                          ("test_lifelint", "threads")):
        assert n > 0        # the fixtures seed violations of this pack


def test_pragma_hygiene_matches_jax_on_shared_kinds(tmp_path):
    src = {"mod.py": """\
        x = 1  # tpulint: wat(some reason)
        y = 2  # tpulint: sync-ok()
        z = 3  # tpulint: lock-ok(fine)
        w = 4  # tpulint: thread-ok()
        """}
    assert rows(analysis.pragma_hygiene(port_pkg(tmp_path, src))) == \
        rows(jhygiene(jax_pkg(tmp_path, src)))


def test_pragma_kinds_differ_only_by_design(tmp_path):
    """The port drops the JAX-only kinds and adds its own."""
    assert set(pcore.PRAGMA_KINDS) - set(jcore.PRAGMA_KINDS) == {
        "capture-ok", "build-ok", "graph-ok", "life-ok"}
    assert set(jcore.PRAGMA_KINDS) - set(pcore.PRAGMA_KINDS) == {
        "jit-ok", "trace-ok", "switch-ok", "donate-ok"}
    src = {"mod.py": "a = 1  # tpulint: capture-ok(why)\n"
                     "b = 2  # tpulint: jit-ok(why)\n"}
    assert [f.code for f in analysis.pragma_hygiene(
        port_pkg(tmp_path, src))] == ["unknown-kind:jit-ok"]


def test_baseline_functions_match_jax(tmp_path):
    mk = [("sync-point", "a.py", 10, "a.py::f", "device_get", "m"),
          ("sync-point", "a.py", 99, "a.py::f", "device_get", "m"),
          ("sync-point", "a.py", 12, "a.py::g", ".item()", "m"),
          ("lock-discipline", "b.py", 3, "b.py::C.f", "C.x:assign", "m")]
    jf = [jcore.Finding(*a) for a in mk]
    pf = [pcore.Finding(*a) for a in mk]
    assert [f.key for f in jf] == [f.key for f in pf]
    assert [str(f) for f in jf] == [str(f) for f in pf]
    pj, pp = str(tmp_path / "j.json"), str(tmp_path / "p.json")
    assert jcore.save_baseline(pj, jf[:3]) == pcore.save_baseline(pp, pf[:3])
    assert open(pj).read() == open(pp).read()
    assert jcore.load_baseline(pj) == pcore.load_baseline(pp)
    assert pcore.load_baseline(str(tmp_path / "missing.json")) == {}
    base = {jf[0].key: 1, jf[3].key: 2}
    jn, jo = jcore.apply_baseline(jf, base)
    pn, po = pcore.apply_baseline(pf, base)
    assert [vars(f) for f in jn] == [vars(f) for f in pn]
    assert [vars(f) for f in jo] == [vars(f) for f in po]


def test_baseline_budget_model():
    f1 = pcore.Finding("sync-point", "a.py", 10, "a.py::f", "device_get", "m")
    f2 = pcore.Finding("sync-point", "a.py", 99, "a.py::f", "device_get", "m")
    f3 = pcore.Finding("sync-point", "a.py", 12, "a.py::g", "device_get", "m")
    new, absorbed = pcore.apply_baseline([f1, f2, f3], {f1.key: 1})
    assert len(absorbed) == 1 and len(new) == 2 and f3 in new


# --------------------------------------------------------------- (b) core

_CORE_FIXTURES = {
    "classes": {"mod.py": """\
        class Base:
            def run(self):
                return self.step()

            def step(self):
                return 1

        class Child(Base):
            def step(self):
                return super().step() + helper()

        def helper():
            return 2  # tpulint: sync-ok(fixture)

        def entry(obj):
            return obj.run()
        """},
    "modules": {
        "a.py": """\
            from . import b
            from .b import g

            def f(x):
                return b.h(x) + g(x)

            def nested(x):
                def inner(y):
                    return g(y)
                return inner(x)
            """,
        "b.py": """\
            def g(x):
                return x

            def h(x):
                # tpulint: lock-ok(fixture: reason)
                return g(x)
            """},
    "package": {
        "__init__.py": "from .sub.c import top\n",
        "sub/__init__.py": "",
        "sub/c.py": """\
            from ..util import helper

            class K:
                def __init__(self):
                    self.v = helper()

                def m(self):
                    return self.v

            def top():
                return K().m()
            """,
        "util.py": """\
            def helper():
                return 0
            """},
}


@pytest.mark.parametrize("name", sorted(_CORE_FIXTURES))
def test_core_matches_jax(name, tmp_path):
    files = _CORE_FIXTURES[name]
    j, p = jax_pkg(tmp_path, files), port_pkg(tmp_path, files)

    def strip(q):
        return q.split("/", 1)[1]
    assert sorted(map(strip, j.functions)) == sorted(map(strip, p.functions))
    jg = {strip(k): sorted(map(strip, v)) for k, v in j.call_graph().items()}
    pg = {strip(k): sorted(map(strip, v)) for k, v in p.call_graph().items()}
    assert jg == pg
    for q in j.functions:
        pq = "lightgbm_tpu_torch/" + strip(q)
        assert sorted(map(strip, j.reachable([q]))) == \
            sorted(map(strip, p.reachable([pq])))
    for rel, sf in j.files.items():
        prel = "lightgbm_tpu_torch/" + strip(rel)

        def flat(pr):
            return {ln: [(x.kind, x.reason, x.line) for x in v]
                    for ln, v in pr.items()}
        assert flat(sf.pragmas) == flat(p.files[prel].pragmas)


def test_core_fallback_differs_by_design(tmp_path):
    """The port's simple-name fallback skips nested functions (`x.t()`
    is no closure named `t`), receivers bound by an import from outside
    the package (`subprocess.run` is no package `run`) and the linter's
    own functions; the JAX core follows all three."""
    files = {"mod.py": """\
        import subprocess

        def outer():
            def t(x):
                return x
            return t

        def run():
            return 0

        def caller(x):
            subprocess.run(["true"])
            return x.t()
        """}
    j, p = jax_pkg(tmp_path, files), port_pkg(tmp_path, files)
    jc = j.call_graph()["lightgbm_tpu/mod.py::caller"]
    pc = p.call_graph()["lightgbm_tpu_torch/mod.py::caller"]
    assert jc == {"lightgbm_tpu/mod.py::outer.t", "lightgbm_tpu/mod.py::run"}
    assert pc == set()


def test_core_recognizes_torch_and_numpy_roots(tmp_path):
    p = port_pkg(tmp_path, {"mod.py": """\
        import numpy as np
        import torch
        import torch.distributed as dist
        from torch import nn

        def f(x):
            return np.sum(x) + torch.sum(x) + dist.get_rank()
        """})
    imps = p.imports["lightgbm_tpu_torch/mod.py"]
    assert imps.numpy == {"np"} and imps.torch == {"torch", "dist", "nn"}
    assert imps.torch_modules["dist"] == "torch.distributed"
    assert p.call_graph()["lightgbm_tpu_torch/mod.py::f"] == set()


# ------------------------------------------------------ (c) twin fixtures

def jax_fixture(module, test):
    return jax_fixtures(module)[test][0]


TWINS = {
    # JAX test -> (JAX pack, port pack, torch twin, JAX code -> port code)
    "sync_point_catches_hot_loop_sync": (
        ("test_tpulint", "test_sync_point_catches_hot_loop_sync"),
        jsync, sync_points,
        {"boosting/fix.py": """\
            from ..utils import device

            class G:
                def train_one_iter(self):
                    v = self.score()
                    return device.device_get(v)

                def load_data(self):      # setup: not reachable from a root
                    return device.device_get(self.raw())
            """}, {}),
    "sync_point_pragma_and_counts": (
        ("test_tpulint", "test_sync_point_pragma_and_counts"),
        jsync, sync_points,
        {"boosting/fix.py": """\
            from ..utils import device
            import numpy as np

            class G:
                def train_one_iter(self):
                    v = self.score()
                    # tpulint: sync-ok(fixture: one batched transfer)
                    host = device.device_get(v)
                    return np.asarray(host)   # host value: not a sync
            """}, {}),
    "sync_point_implicit_channels": (
        ("test_tpulint", "test_sync_point_implicit_channels"),
        jsync, sync_points,
        {"boosting/fix.py": """\
            import torch
            import numpy as np

            class G:
                def train_one_iter(self):
                    dev = torch.sum(self.grad)
                    a = np.asarray(dev)
                    b = float(dev)
                    c = dev.item()
                    return a, b, c
            """}, {}),
    "trace_safety_catches_concretization": (
        ("test_tpulint", "test_trace_safety_catches_concretization"),
        jtrace, trace_safety,
        {"mod.py": """\
            import torch


            # the capture root is at the end of the file
            def f(x):
                if float(x) > 0:
                    return x + 1
                return torch.zeros_like(x)


            def capture(g, x):
                with torch.cuda.graph(g):
                    f(x)
            """},
        {"float()": "capture-read:float()", "if-traced": "if-captured"}),
    "trace_safety_exemptions_and_pragma": (
        ("test_tpulint", "test_trace_safety_exemptions_and_pragma"),
        jtrace, trace_safety,
        {"mod.py": """\
            import torch


            # the capture root is at the end of the file
            def ok(x, n):
                if x.shape[0] > 4:        # shape metadata: concrete
                    return x[:4]
                if x is None:             # identity: concrete
                    return torch.zeros(3)
                # tpulint: capture-ok(fixture: deliberately annotated)
                return x + float(x)

            def static_ok(x, mode: bool):
                if mode:                  # host argument: concrete
                    return x * 2
                return x


            def capture(g, x, n):
                with torch.cuda.graph(g):
                    ok(x, n)
                    static_ok(x, True)
            """}, {}),
    "lock_discipline_catches_unlocked_mutation": (
        ("test_tpulint", "test_lock_discipline_catches_unlocked_mutation"),
        jlocks, locks, None, {}),
    "lock_discipline_negatives": (
        ("test_tpulint", "test_lock_discipline_negatives"),
        jlocks, locks, None, {}),
}


@pytest.mark.parametrize("name", sorted(TWINS))
def test_twin_fixture_flagged_at_the_same_lines(name, tmp_path):
    (module, test), jmod, pmod, twin, code_map = TWINS[name]
    original = jax_fixture(module, test)
    want = rows(jmod.check(jax_pkg(tmp_path, original)), code_map)
    got = rows(pmod.check(port_pkg(tmp_path, twin or original)))
    assert got == want
    if "negatives" in name or "exemptions" in name or "pragma" in name:
        assert want == []
    else:
        assert want


def test_sync_point_pragma_still_counts(tmp_path):
    twin = TWINS["sync_point_pragma_and_counts"][3]
    assert sync_points.hot_sync_count(port_pkg(tmp_path, twin)) == 1


# ------------------------------------------ new rules: capture-safety

_CAPTURE_SRC = """\
    import numpy as np
    import torch

    def step(st, data, bound: int):
        scale = torch.tensor(0.5, device=data.device)
        noise = torch.rand(4, device=data.device)
        host = np.arange(4)
        idx = torch.as_tensor(host, device=data.device)
        st.copy_(data[:bound] * scale + noise[idx])
        n = int(st.sum())
        if st.max() > 0:
            st.zero_()
        keep = st[st > 0]
        st.normal_()
        return torch.nonzero(keep) + n

    def on_cpu(data):
        if not data.is_cuda:
            return data.tolist()
        return data.view(-1)

    def capture(g, st, data):
        with torch.cuda.graph(g):
            step(st, data, 8)
            on_cpu(data)
"""


def test_capture_safety_flags_copies_draws_reads(tmp_path):
    found = rows(trace_safety.check(port_pkg(tmp_path,
                                             {"mod.py": _CAPTURE_SRC})))
    assert found == [
        ("mod.py", 5, "h2d-copy:torch.tensor"),
        ("mod.py", 6, "rng-draw:rand"),
        ("mod.py", 8, "h2d-copy:torch.as_tensor"),
        ("mod.py", 10, "capture-read:int()"),
        ("mod.py", 11, "if-captured"),
        ("mod.py", 13, "dynamic-shape:mask-index"),
        ("mod.py", 14, "rng-draw:.normal_()"),
        ("mod.py", 15, "dynamic-shape:nonzero"),
    ]


def test_capture_safety_annotated_twin_is_quiet(tmp_path):
    lines = textwrap.dedent(_CAPTURE_SRC).split("\n")
    for ln in (5, 6, 8, 10, 11, 13, 14, 15):
        lines[ln - 1] += "  # tpulint: capture-ok(fixture: deliberate)"
    pkg = port_pkg(tmp_path, {"mod.py": "\n".join(lines)})
    assert trace_safety.check(pkg) == []
    # `bound: int` is a host value and the CPU arm is not captured
    taints = trace_safety.captured_functions(pkg)
    assert taints["lightgbm_tpu_torch/mod.py::step"] == {"st", "data"}


# ----------------------------------------- new rules: sync-point channels

def test_sync_point_uploads_and_channels(tmp_path):
    pkg = port_pkg(tmp_path, {"boosting/fix.py": """\
        import numpy as np
        import torch

        class G:
            def train_one_iter(self):
                a = torch.as_tensor(np.ones(3), device=self.device)
                b = torch.from_numpy(np.ones(3)).to(self.device)
                c = torch.as_tensor(np.ones(3), device="cpu")
                torch.cuda.synchronize()
                d = torch.zeros(3, device=self.device)
                e = d.cpu()
                # utils/device.py upload's copy: non-blocking, no wait
                f = torch.from_numpy(np.ones(3)).to(self.device,
                                                    non_blocking=True)
                return a, b, c, e, f, torch.nonzero(d)
        """})
    assert rows(sync_points.check(pkg)) == [
        ("boosting/fix.py", 6, "upload:torch.as_tensor"),
        ("boosting/fix.py", 7, "upload:.to()"),
        ("boosting/fix.py", 9, "torch.cuda.synchronize"),
        ("boosting/fix.py", 11, ".cpu()"),
        ("boosting/fix.py", 15, "torch.nonzero"),
    ]



# ----------------------------------------- new rules: recompile-hazard

def test_recompile_build_unmanaged(tmp_path):
    pkg = port_pkg(tmp_path, {
        "mod.py": """\
            import ctypes
            import subprocess

            def load(path):
                return ctypes.CDLL(path)

            def build(src):
                subprocess.run(["nvcc", "-o", "x.so", src])

            def annotated(path):
                return ctypes.CDLL(path)  # tpulint: build-ok(fixture)
            """,
        "ops/cuda.py": """\
            import ctypes

            def lib(path):
                return ctypes.CDLL(path)
            """})
    assert rows(recompile.check(pkg)) == [
        ("mod.py", 5, "build-unmanaged:CDLL"),
        ("mod.py", 8, "build-unmanaged:nvcc")]


def test_recompile_capture_unmanaged(tmp_path):
    pkg = port_pkg(tmp_path, {"mod.py": """\
        import torch
        from .compile import manager

        def uncounted(fn):
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                fn()
            return g

        def counted(fn):
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                fn()
            manager.count("graph_captures")
            return g
        """, "compile/manager.py": """\
        def count(name):
            return name
        """})
    assert rows(recompile.check(pkg)) == [
        ("mod.py", 5, "capture-unmanaged"),
        ("mod.py", 6, "capture-unmanaged")]


_GRAPH_KEY_SRC = """\
    import torch
    from .compile import manager

    class L:
        def __init__(self, config):
            self.config = config
            self.fixed = 3
            self.mode = 1
            self.buf = torch.zeros(4)

        def set_mode(self, m):
            self.mode = m

        def _graph_signature(self):
            return (self.config.max_depth, self.fixed)

        def _step(self, st):
            st.add_(self.fixed + self.config.max_depth + self.mode)
            st.mul_(self.config.lambda_l1)
            st.add_(self.buf)

        def replay(self, st):
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                self._step(st)
            manager.count("graph_captures")

    def tweak(cfg):
        cfg.lambda_l1 = 2.0
"""


def test_recompile_graph_key(tmp_path):
    pkg = port_pkg(tmp_path, {"mod.py": _GRAPH_KEY_SRC,
                              "compile/manager.py": "def count(n):\n"
                                                    "    return n\n"})
    assert rows(recompile.check(pkg)) == [
        ("mod.py", 18, "graph-key:mode"),
        ("mod.py", 19, "graph-key:config.lambda_l1")]


def test_recompile_graph_key_annotated(tmp_path):
    src = _GRAPH_KEY_SRC.replace(
        "st.add_(self.fixed + self.config.max_depth + self.mode)",
        "st.add_(self.fixed + self.config.max_depth + self.mode)"
        "  # tpulint: graph-ok(fixture)").replace(
        "st.mul_(self.config.lambda_l1)",
        "st.mul_(self.config.lambda_l1)  # tpulint: graph-ok(fixture)")
    pkg = port_pkg(tmp_path, {"mod.py": src,
                              "compile/manager.py": "def count(n):\n"
                                                    "    return n\n"})
    assert recompile.check(pkg) == []


@pytest.mark.parametrize("suffixes,want", [
    ('(".cuh", ".h")', []),
    ('(".h",)', [("csrc/a.cu", 2, "build-key:fold.cuh")]),
])
def test_recompile_build_key(tmp_path, suffixes, want):
    pkg = port_pkg(tmp_path, {
        "ops/cuda.py": f"""\
            import os

            def _lib_path(name):
                return [f for f in os.listdir("csrc")
                        if f.endswith({suffixes})]
            """,
        "csrc/a.cu": '#include <cuda_runtime.h>\n#include "fold.cuh"\n',
        "csrc/fold.cuh": "// a header\n"})
    assert rows(recompile.check(pkg)) == want


def test_recompile_stale_ignored_field(tmp_path):
    pkg = port_pkg(tmp_path, {
        "compile/signature.py": """\
            _IGNORED_CONFIG_FIELDS = frozenset({"verbosity", "ghost_field"})
            """,
        "config.py": """\
            class Config:
                verbosity: int = 0
            """})
    assert rows(recompile.check(pkg)) == [
        ("compile/signature.py", 1, "stale-ignored:ghost_field")]
