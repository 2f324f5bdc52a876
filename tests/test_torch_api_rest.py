"""The rest of the port's API against the JAX package's, on the CPU:
SHAP contributions (``pred_contrib``), C++ code generation
(``models/codegen.py``), the scikit-learn estimators (with scikit-learn
and with the standalone bases), the plotting functions (matplotlib's Agg
backend) and the command line (``cli.py``).

Every model of a test is trained in both packages on the same data; the
JAX package's programs compile once per shape in a test process, so the
estimators share one data shape.
"""
import json
import os
import sys

import numpy as np
import pytest

import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu.cli as jcli
import lightgbm_tpu.plotting as jplot
import lightgbm_tpu.sklearn as jsk
import lightgbm_tpu_torch as tlgb
import lightgbm_tpu_torch.cli as tcli
import lightgbm_tpu_torch.plotting as tplot
import lightgbm_tpu_torch.sklearn as tsk
from lightgbm_tpu.models.codegen import model_to_cpp as jax_cpp
from lightgbm_tpu_torch.models.codegen import model_to_cpp as port_cpp

from test_torch_categorical import PARAMS as CAT_PARAMS
from test_torch_categorical import make_cat_data

matplotlib = pytest.importorskip("matplotlib")
matplotlib.use("Agg")


@pytest.fixture(autouse=True, scope="module")
def _no_aot_store():
    """The JAX package's AOT store off and torch on two threads, as in
    tests/test_torch_objectives.py."""
    from lightgbm_tpu.compile.manager import get_manager
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LGBM_TPU_AOT", "0")
        mp.setattr(get_manager(), "aot_enabled", False)
        yield
    torch.set_num_threads(threads)


def _data(n=600, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 5)
    X[rng.rand(n) < 0.05, 2] = np.nan
    f = X[:, 0] + 0.5 * X[:, 1] - 0.3 * np.nan_to_num(X[:, 2])
    return X, f, rng


_MODELS = {}


def _models(kind):
    """(jax booster, port booster, X) per kind, trained once."""
    if kind not in _MODELS:
        X, f, rng = _data()
        params = {"num_leaves": 7, "verbose": -1}
        if kind == "numerical":
            y = (f + 0.5 * rng.randn(len(f)) > 0).astype(float)
            params["objective"] = "binary"
        elif kind == "multiclass":
            y = np.digitize(f, [-0.5, 0.5]).astype(float)
            params.update(objective="multiclass", num_class=3)
        else:
            X, y = make_cat_data(n=600)
            params = {**CAT_PARAMS, "num_leaves": 7}
        jb = jlgb.train(dict(params), jlgb.Dataset(X, label=y),
                        num_boost_round=3)
        tb = tlgb.train({**params, "device_type": "cpu"},
                        tlgb.Dataset(X, label=y), num_boost_round=3,
                        verbose_eval=False)
        _MODELS[kind] = (jb, tb, X)
    return _MODELS[kind]


@pytest.mark.parametrize("kind", ["numerical", "categorical", "multiclass"])
def test_pred_contrib_matches_jax(kind):
    """float64 TreeSHAP values equal to the JAX package's; each row (and
    class block) sums to the raw score."""
    jb, tb, X = _models(kind)
    x = X[:150]
    got = tb.predict(x, pred_contrib=True)
    np.testing.assert_array_equal(got, jb.predict(x, pred_contrib=True))
    raw = tb.predict(x, raw_score=True)
    k = 3 if kind == "multiclass" else 1
    blocks = got.reshape(len(x), k, X.shape[1] + 1).sum(axis=2)
    np.testing.assert_allclose(blocks, raw.reshape(len(x), k), atol=1e-6)


@pytest.mark.parametrize("kind", ["numerical", "categorical", "multiclass"])
def test_model_to_cpp_matches_jax(kind):
    jb, tb, _ = _models(kind)
    text = port_cpp(tb._gbdt)
    assert text == jax_cpp(jb._gbdt)
    assert "double PredictTree0(const double* arr)" in text


# ---------------------------------------------------------------------------
# scikit-learn estimators
# ---------------------------------------------------------------------------

def _fobj2(y, p):
    return p - y, np.ones_like(p)


def _fobj3(y, p, group):
    return p - y, np.ones_like(p)


def _feval2(y, p):
    return "mae", float(np.mean(np.abs(p - y))), False


def _feval3(y, p, w):
    return "mae3", float(np.mean(np.abs(p - y))), False


def _feval4(y, p, w, group):
    return "mae4", float(np.mean(np.abs(p - y))), False


def _fit_both(name, X, y, fit_kw=None, **kw):
    out = []
    for mod, extra in ((jsk, {}), (tsk, {"device_type": "cpu"})):
        est = getattr(mod, name)(n_estimators=3, num_leaves=7, **kw,
                                 **extra)
        est.fit(X, y, **(fit_kw or {}))
        out.append(est)
    return out


# case: estimator, objective, eval_metric
SK_CASES = {
    "regressor": ("LGBMRegressor", None, "l2"),
    "regressor_fobj2": ("LGBMRegressor", _fobj2, None),
    "regressor_fobj3": ("LGBMRegressor", _fobj3, None),
    "classifier": ("LGBMClassifier", None, None),
    "classifier_3": ("LGBMClassifier", None, None),
}


@pytest.mark.parametrize("case", sorted(SK_CASES))
def test_sklearn_estimators_match_jax(case):
    name, objective, metric = SK_CASES[case]
    X, f, rng = _data()
    if name == "LGBMRegressor":
        y = 2.0 * f + rng.randn(len(f)) * 0.3
    elif case == "classifier_3":
        y = np.array(["a", "b", "c"])[np.digitize(f, [-0.5, 0.5])]
    else:
        y = np.where(f > 0, 5, 2)
    kw = {} if objective is None else {"objective": objective}
    fit_kw = {"eval_set": [(X[:200], y[:200])]}
    if metric is not None:
        fit_kw["eval_metric"] = metric
    je, te = _fit_both(name, X, y, fit_kw, **kw)
    np.testing.assert_array_equal(te.predict(X), je.predict(X))
    assert te.evals_result_ == je.evals_result_
    np.testing.assert_array_equal(te.feature_importances_,
                                  je.feature_importances_)
    if name == "LGBMClassifier":
        np.testing.assert_array_equal(te.classes_, je.classes_)
        proba = te.predict_proba(X)
        np.testing.assert_array_equal(proba, je.predict_proba(X))
        raw = te.booster_.predict(X)
        if raw.ndim == 1:
            raw = np.vstack([1.0 - raw, raw]).T
        np.testing.assert_array_equal(proba, raw)


@pytest.mark.parametrize("func", [_fobj2, _fobj3, _feval2, _feval3, _feval4],
                         ids=["fobj2", "fobj3", "feval2", "feval3", "feval4"])
def test_sklearn_function_wrappers_match_jax(func):
    """The fobj / feval signature translators in each argument form, on
    a Dataset with weights and a group in each package."""
    X, f, rng = _data(n=60)
    y, w, p = f, rng.rand(60) + 0.5, rng.randn(60)
    got = []
    for lib, mod in ((jlgb, jsk), (tlgb, tsk)):
        ds = lib.Dataset(X, label=y, weight=w, group=[20, 40],
                         free_raw_data=False)
        ds.construct()
        wrap = (mod._ObjectiveFunctionWrapper
                if func.__name__.startswith("_fobj")
                else mod._EvalFunctionWrapper)
        got.append(wrap(func)(p, ds))
    for a, b in zip(*got):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for mod in (jsk, tsk):
        with pytest.raises(TypeError):
            mod._EvalFunctionWrapper(lambda a: a)(p, None)


def test_ranker_matches_jax():
    """LGBMRanker with an eval set, and its group checks."""
    from test_torch_rank import rank_data
    X, y, sizes, Xv, yv, gv = rank_data()
    fit_kw = {"group": sizes, "eval_set": [(Xv, yv)], "eval_group": [gv]}
    je, te = _fit_both("LGBMRanker", X, y, fit_kw)
    np.testing.assert_array_equal(te.predict(X), je.predict(X))
    assert te.evals_result_ == je.evals_result_
    assert "ndcg@1" in te.evals_result_["valid_0"]
    for mod in (jsk, tsk):
        with pytest.raises(ValueError, match="group"):
            mod.LGBMRanker().fit(X, y)
        with pytest.raises(ValueError, match="Eval_group"):
            mod.LGBMRanker().fit(X, y, group=sizes, eval_set=[(Xv, yv)])


def test_sklearn_without_scikit_learn(monkeypatch):
    """With scikit-learn hidden the estimators take standalone bases and
    give the same predictions (a second copy of the module, loaded
    while scikit-learn is hidden; the package's own stays as it is)."""
    import importlib.util
    for mod in [m for m in sys.modules if m == "sklearn"
                or m.startswith("sklearn.")]:
        monkeypatch.setitem(sys.modules, mod, None)
    monkeypatch.setitem(sys.modules, "sklearn", None)
    name = "lightgbm_tpu_torch._sklearn_without_scikit_learn"
    spec = importlib.util.spec_from_file_location(name, tsk.__file__)
    alone = importlib.util.module_from_spec(spec)
    monkeypatch.setitem(sys.modules, name, alone)
    spec.loader.exec_module(alone)
    assert alone.LGBMModel.__mro__[1].__module__ == name
    assert tsk.LGBMModel.__mro__[1].__module__.startswith("sklearn")
    X, f, rng = _data()
    y = 2.0 * f + rng.randn(len(f)) * 0.3
    est = alone.LGBMRegressor(n_estimators=3, num_leaves=7,
                              device_type="cpu").fit(X, y)
    want = jsk.LGBMRegressor(n_estimators=3, num_leaves=7).fit(X, y)
    np.testing.assert_array_equal(est.predict(X), want.predict(X))


# ---------------------------------------------------------------------------
# plotting
# ---------------------------------------------------------------------------

def _bars(ax):
    return [(p.get_x(), p.get_y(), p.get_width(), p.get_height())
            for p in ax.patches]


def _texts(ax):
    return ([t.get_text() for t in ax.get_yticklabels()],
            [t.get_text() for t in ax.get_xticklabels()],
            [t.get_text() for t in ax.texts],
            ax.get_title(), ax.get_xlabel(), ax.get_ylabel(),
            ax.get_xlim(), ax.get_ylim())


def test_plotting_matches_jax(monkeypatch):
    import matplotlib.pyplot as plt
    jb, tb, _ = _models("numerical")
    for kw in ({}, {"importance_type": "gain", "max_num_features": 2}):
        ja, ta = jplot.plot_importance(jb, **kw), tplot.plot_importance(tb,
                                                                        **kw)
        assert _bars(ta) == _bars(ja) and _texts(ta) == _texts(ja)
    ja = jplot.plot_split_value_histogram(jb, 0)
    ta = tplot.plot_split_value_histogram(tb, 0)
    assert _bars(ta) == _bars(ja) and _texts(ta) == _texts(ja)
    X, f, rng = _data()
    y = 2.0 * f + rng.randn(len(f)) * 0.3
    je, te = _fit_both("LGBMRegressor", X, y,
                       {"eval_set": [(X[:200], y[:200])]})
    ja, ta = jplot.plot_metric(je), tplot.plot_metric(te)
    assert [ln.get_ydata().tolist() for ln in ta.lines] == \
        [ln.get_ydata().tolist() for ln in ja.lines]
    assert _texts(ta) == _texts(ja)
    pytest.importorskip("graphviz")
    for i in range(3):
        assert tplot.create_tree_digraph(tb, tree_index=i).source == \
            jplot.create_tree_digraph(jb, tree_index=i).source
    # plot_tree renders through graphviz's dot binary: a fixed image
    # stands in for it, in both packages
    import graphviz
    import io
    buf = io.BytesIO()
    plt.imsave(buf, np.zeros((4, 6, 3)), format="png")
    monkeypatch.setattr(graphviz.Digraph, "pipe",
                        lambda self, format=None: buf.getvalue())
    ja, ta = jplot.plot_tree(jb, tree_index=1), tplot.plot_tree(tb,
                                                                tree_index=1)
    assert ta.images[0].get_array().shape == ja.images[0].get_array().shape
    plt.close("all")


# ---------------------------------------------------------------------------
# command line
# ---------------------------------------------------------------------------

def test_cli_matches_jax(tmp_path):
    """train / predict / convert_model / refit in both packages' CLIs on
    one CSV: the same model text (but the device line), predictions and
    C++ file; the port's refit model predicts as the JAX one."""
    X, f, rng = _data(n=500)
    y = (f + 0.5 * rng.randn(len(f)) > 0).astype(float)
    data = tmp_path / "train.csv"
    np.savetxt(data, np.column_stack([y, np.nan_to_num(X)]), delimiter=",",
               fmt="%.6f")
    conf = tmp_path / "train.conf"
    conf.write_text("objective = binary\nnum_leaves = 7\n"
                    "num_iterations = 3\nlabel_column = 0\n"
                    "verbosity = -1\n")
    out = {}
    for name, cli, extra in (("jax", jcli, []),
                             ("torch", tcli, ["device_type=cpu"])):
        d = tmp_path / name
        d.mkdir()
        model, pred = d / "model.txt", d / "pred.txt"
        common = [f"config={conf}", f"data={data}"] + extra
        assert cli.main(["task=train", f"output_model={model}"]
                        + common) == 0
        assert cli.main(["task=predict", f"input_model={model}",
                         f"output_result={pred}"] + common) == 0
        assert cli.main(["task=convert_model", f"input_model={model}",
                         f"convert_model={d / 'model.cpp'}"] + common) == 0
        assert cli.main(["task=refit", f"input_model={model}",
                         f"output_model={d / 'refit.txt'}"] + common) == 0
        out[name] = d

    def text(p):
        return [ln.replace(str(p.parent), "DIR")
                for ln in p.read_text().splitlines()
                if not ln.startswith("[device_type")]
    for f_ in ("model.txt", "pred.txt", "model.cpp", "refit.txt"):
        assert text(out["torch"] / f_) == text(out["jax"] / f_), f_
    assert (out["torch"] / "model.cpp").stat().st_size > 0


@pytest.mark.parametrize("argv,item", [
    (["task=warmup"], "A15"),
])
def test_cli_unported_raise(argv, item, tmp_path):
    """Every task of the JAX package's CLI is ported: the last one that
    raised and named its ROADMAP item (``task=warmup``, A15) now runs
    on a CSV, and nothing it logs names the item."""
    from lightgbm_tpu_torch.utils import log as tlog
    X, f, rng = _data(n=200)
    data = tmp_path / "train.csv"
    np.savetxt(data, np.column_stack([(f > 0).astype(float),
                                      np.nan_to_num(X)]),
               delimiter=",", fmt="%.6f")
    argv = ["task=train", f"data={data}", "label_column=0",
            "device_type=cpu"] + argv
    msgs = []
    tlog.register_log_callback(msgs.append)
    try:
        assert tcli.main(argv) == 0
    finally:
        tlog.register_log_callback(None)
    assert not [m for m in msgs if item in m]


def _cli_data(tmp_path):
    X, f, rng = _data(n=400)
    y = (f + 0.5 * rng.randn(len(f)) > 0).astype(float)
    data = tmp_path / "train.csv"
    np.savetxt(data, np.column_stack([y, np.nan_to_num(X)]), delimiter=",",
               fmt="%.6f")
    return ["task=train", f"data={data}", "label_column=0",
            "num_leaves=7", "num_iterations=4", "verbosity=-1",
            "device_type=cpu", f"output_model={tmp_path / 'model.txt'}"]


def _cli_port(tmp_path) -> str:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return str(sock.getsockname()[1])


# flag (or key) -> (arguments, the config key they set, its value)
OBS_FLAGS = {
    "metrics_out": (["--metrics-out", "{d}/m.jsonl"], "metrics_file",
                    "{d}/m.jsonl"),
    "trace_out": (["--trace-out={d}/t.json"], "trace_file", "{d}/t.json"),
    "profile_dir": (["--profile-dir", "{d}/prof"], "profile_dir",
                    "{d}/prof"),
    "metrics_interval": (["--metrics-interval", "2", "--metrics-out",
                          "{d}/m.jsonl"], "metrics_interval", 2),
    "obs_port": (["--obs-port", "{port}"], "obs_port", "{port}"),
    "flight_dir": (["--flight-dir", "{d}/fl", "hang_timeout=0.25"],
                   "flight_dir", "{d}/fl"),
    "metrics_file_key": (["metrics_file={d}/m.jsonl"], "metrics_file",
                         "{d}/m.jsonl"),
    "trace_report": (["trace-report", "{d}/t.json"], None, None),
}


@pytest.mark.parametrize("case", sorted(OBS_FLAGS))
def test_cli_observability_flags_accepted(case, tmp_path, monkeypatch,
                                          capsys):
    """Each observability flag reaches the config and produces its file
    or endpoint; ``trace-report`` prints the JAX package's report for the
    same trace."""
    from lightgbm_tpu.obs import report as jreport
    from lightgbm_tpu_torch import obs as tobs
    from lightgbm_tpu_torch.obs import httpd as thttpd
    from lightgbm_tpu_torch.robust import install_plan
    from lightgbm_tpu_torch.config import Config
    flags, key, value = OBS_FLAGS[case]
    port = _cli_port(tmp_path)
    flags = [a.format(d=tmp_path, port=port) for a in flags]
    base = _cli_data(tmp_path)
    if case == "trace_report":
        assert tcli.main(base + [f"--trace-out={tmp_path}/t.json"]) == 0
        capsys.readouterr()
        assert tcli.main(flags) == 0
        ours = capsys.readouterr().out
        assert jreport.main([str(tmp_path / "t.json")]) == 0
        assert ours == capsys.readouterr().out
        assert "phase coverage" in ours and "host syncs" in ours
        return
    cfg = Config.from_params(tcli.parse_args(base + flags))
    if isinstance(value, str):
        value = type(getattr(cfg, key))(value.format(d=tmp_path, port=port))
    assert getattr(cfg, key) == value
    answered = {}
    if case == "obs_port":
        real_start = thttpd.ObsServer.start

        def start(self):
            bound = real_start(self)
            import urllib.request
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{bound}/healthz", timeout=10) as r:
                answered[bound] = json.loads(r.read())["status"]
            return bound
        monkeypatch.setattr(thttpd.ObsServer, "start", start)
    if case == "flight_dir":
        install_plan("train.iteration:hang=0.6@3")
    try:
        rc = tcli.main(base + flags)
    finally:
        install_plan(None)
    if case == "flight_dir":
        assert rc == 1                      # the HangTimeout, reported
        bundles = os.listdir(tmp_path / "fl")
        assert len(bundles) == 1 and bundles[0].endswith("_watchdog")
        return
    assert rc == 0
    if case in ("metrics_out", "metrics_file_key", "metrics_interval"):
        recs = tobs.read_jsonl(str(tmp_path / "m.jsonl"))
        step = 2 if case == "metrics_interval" else 1
        assert cfg.metrics_interval == step
        assert [r["iteration"] for r in recs] == list(range(0, 4, step))
        assert all(tobs.validate_record(r) == [] for r in recs)
    elif case == "trace_out":
        doc = json.loads((tmp_path / "t.json").read_text())
        assert any(e.get("cat") == "sync" for e in doc["traceEvents"])
    elif case == "profile_dir":
        files = os.listdir(tmp_path / "prof")
        assert len(files) == 1 and files[0].endswith(".json")
    elif case == "obs_port":
        assert cfg.obs_port == int(port)
        assert answered == {int(port): "ok"}


@pytest.mark.parametrize("argv", [
    ["--checkpoint-dir", "c"], ["--checkpoint-interval", "3"],
    ["checkpoint_dir=c"]])
def test_cli_checkpoint_flags_accepted(argv, capsys):
    """The checkpoint flags and keys are ported (robust/): the command
    goes on to read its data (here a missing file, the usual error)."""
    argv = ["task=train", "data=none.csv", "device_type=cpu"] + argv
    assert tcli.main(argv) == 1
    assert "not ported" not in capsys.readouterr().err


def test_python_dash_m_entry_point():
    """``python -m lightgbm_tpu_torch`` runs the CLI's main."""
    import runpy
    with pytest.raises(SystemExit) as exc:
        sys_argv = sys.argv
        sys.argv = ["lightgbm_tpu_torch", "task=nope", "device_type=cpu"]
        try:
            runpy.run_module("lightgbm_tpu_torch", run_name="__main__")
        finally:
            sys.argv = sys_argv
    assert exc.value.code == 1
    assert os.path.exists(os.path.join(os.path.dirname(tcli.__file__),
                                       "__main__.py"))
