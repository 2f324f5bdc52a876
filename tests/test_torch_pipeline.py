"""The pipelined loop of the port (``lightgbm_tpu_torch/engine.py``,
``boosting/gbdt.py``) against the JAX package's, on the CPU: the port's
counterpart of ``tests/test_pipeline.py``, at its sizes (350 training
and 150 validation rows, 7 leaves).

Every test sets ``LGBM_TPU_PIPELINE`` for both packages itself (unset =
the default, pipelined loop). Tolerances: model texts equal but the
``device_type`` line, raw predictions and counters equal; the
evaluation histories of the port's two loops equal, and the port's
against the JAX package's within 1e-7 (the float64 metric sums of both
packages, ROADMAP §C).

- C14's gate: with the default environment the port trains the same
  trees as the JAX package after early stopping (it kept one tree fewer
  before the pipelined loop).
- Early stopping, DART and the resume from a checkpoint give the same
  model under both loops, in the port and against the JAX package; the
  quantized host loop runs its quantization ahead (``PrefetchedQuant``)
  with the inline keys.
- The periodic no-more-splits check in both orders (C15).
- The ``pipeline.*`` counters, the synchronous loop's empty in-flight
  state, and at most one counted read per steady iteration from the
  loop layers (boosting/, engine.py, basic.py).
"""
from collections import Counter

import numpy as np
import pytest

import torch

import lightgbm_tpu as jlgb
from lightgbm_tpu import obs as jobs
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch import obs as tobs

from test_torch_train import _data

P = {"objective": "binary", "metric": "binary_logloss", "verbose": -1,
     "min_data_in_leaf": 20, "num_leaves": 7, "learning_rate": 0.3}


@pytest.fixture(autouse=True, scope="module")
def _no_aot_store():
    """The JAX package's AOT store off; torch on two threads, as the
    other port test modules."""
    from lightgbm_tpu.compile.manager import get_manager
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LGBM_TPU_AOT", "0")
        mp.setattr(get_manager(), "aot_enabled", False)
        yield
    torch.set_num_threads(threads)


def _pipeline_env(monkeypatch, pipe):
    """``pipe`` None: the default environment; else LGBM_TPU_PIPELINE."""
    if pipe is None:
        monkeypatch.delenv("LGBM_TPU_PIPELINE", raising=False)
    else:
        monkeypatch.setenv("LGBM_TPU_PIPELINE", pipe)


def _params(lib, extra=None):
    p = dict(P, **(extra or {}))
    if lib is tlgb:
        p["device_type"] = "cpu"
    return p


def _text(b, **kw):
    return "\n".join(ln for ln in b.model_to_string(**kw).splitlines()
                     if not ln.startswith("[device_type"))


def _cur(b):
    c = b.current_iteration
    return c() if callable(c) else c


def _noise_data(n=500, f=6, seed=3):
    """Pure-noise labels: the validation loss only gets worse, so the
    early stopper fires after ``stop`` iterations."""
    rng = np.random.RandomState(seed)
    return rng.randn(n, f).astype(np.float32), \
        (rng.rand(n) > 0.5).astype(np.float64)


def _run_earlystop(lib, extra=None, rounds=40, stop=3, ckpt=None):
    X, y = _noise_data()
    ds = lib.Dataset(X[:350], label=y[:350])
    vs = ds.create_valid(X[350:], label=y[350:])
    ev = {}
    kw = {} if ckpt is None else {"checkpoint_dir": ckpt}
    b = lib.train(_params(lib, extra), ds, num_boost_round=rounds,
                  valid_sets=[vs], early_stopping_rounds=stop,
                  evals_result=ev, verbose_eval=False, **kw)
    return b, ev


def _assert_evals_close(ev_t, ev_j):
    assert ev_t.keys() == ev_j.keys()
    for ds in ev_j:
        for m in ev_j[ds]:
            np.testing.assert_allclose(ev_t[ds][m], ev_j[ds][m], rtol=0,
                                       atol=1e-7)


# -- C14 ----------------------------------------------------------------

@pytest.mark.parametrize("extra", [{}, {"tpu_fused": False}],
                         ids=["fused", "host_loop"])
def test_c14_early_stop_gate_default_environment(monkeypatch, extra):
    """ROADMAP §C C14's inputs under the default environment of both
    packages: the same trees, iterations, best iteration, model text
    and raw predictions, bit for bit (the port kept one tree fewer
    before its loop was pipelined)."""
    _pipeline_env(monkeypatch, None)
    X, y = _data(n=2000)
    Xv, yv = _data(seed=1, n=800)
    yv = yv.copy()
    yv[::2] = 1.0 - yv[::2]
    out = {}
    for lib in (jlgb, tlgb):
        p = _params(lib, {"num_leaves": 31, "metric": "binary_logloss",
                          **extra})
        p.pop("min_data_in_leaf")
        ds = lib.Dataset(X, label=y)
        vs = lib.Dataset(Xv, label=yv, reference=ds)
        b = lib.train(p, ds, num_boost_round=30, valid_sets=[vs],
                      early_stopping_rounds=3, verbose_eval=False)
        out[lib] = (b.num_trees(), _cur(b), b.best_iteration, _text(b),
                    b.predict(X, raw_score=True))
    j, t = out[jlgb], out[tlgb]
    assert t[:3] == j[:3]
    assert j[0] > j[2]          # the stop trailed, and was truncated
    assert t[3] == j[3]
    np.testing.assert_array_equal(t[4], j[4])


# -- early stopping, DART, resume -----------------------------------------

@pytest.mark.parametrize("extra", [
    {},
    {"tpu_fused": False},
    {"tpu_fused": False, "use_quantized_grad": True,
     "num_grad_quant_bins": 16},
], ids=["fused", "host_loop", "quantized"])
def test_early_stop_parity(monkeypatch, extra):
    """Pipelined against synchronous in the port (the same best
    iteration, history and truncated model; at most one tree more), and
    each against the JAX package under the same setting."""
    runs = {}
    for pipe in ("0", "1"):
        _pipeline_env(monkeypatch, pipe)
        for lib in (jlgb, tlgb):
            runs[lib, pipe] = _run_earlystop(lib, extra)
    (b_sync, ev_sync), (b_pipe, ev_pipe) = runs[tlgb, "0"], runs[tlgb, "1"]
    assert b_sync.best_iteration > 0
    assert b_pipe.best_iteration == b_sync.best_iteration
    assert ev_pipe == ev_sync
    n = b_sync.best_iteration
    assert _text(b_pipe, num_iteration=n) == _text(b_sync, num_iteration=n)
    assert b_sync.num_trees() <= b_pipe.num_trees() \
        <= b_sync.num_trees() + 1
    for pipe in ("0", "1"):
        (bt, evt), (bj, evj) = runs[tlgb, pipe], runs[jlgb, pipe]
        assert (bt.num_trees(), bt.best_iteration) == \
            (bj.num_trees(), bj.best_iteration), pipe
        assert _text(bt) == _text(bj), pipe
        _assert_evals_close(evt, evj)


def test_quantized_prefetch_keys(monkeypatch):
    """The host loop's dispatch-ahead quantization pops the passes it
    pushed, in key order, and their levels are the inline pass's: the
    same model as with nothing pushed, and the JAX package's."""
    from lightgbm_tpu_torch.ops import quantize as Q
    _pipeline_env(monkeypatch, None)
    extra = {"tpu_fused": False, "use_quantized_grad": True,
             "num_grad_quant_bins": 16, "objective": "multiclass",
             "num_class": 3, "metric": "multi_logloss"}
    X, y = _noise_data()
    y = (X[:, 0] > 0.3).astype(float) + (X[:, 1] > 0.0)
    popped = []
    orig = Q.PrefetchedQuant.pop_match

    def pop_match(self, idx, grad, hess):
        got = orig(self, idx, grad, hess)
        popped.append((idx, got is not None))
        return got
    texts = []
    for inline in (False, True):
        with monkeypatch.context() as mp:
            mp.setattr(Q.PrefetchedQuant, "pop_match", pop_match)
            if inline:
                mp.setattr(Q.PrefetchedQuant, "push",
                           lambda self, *a: None)
            popped.clear()
            b = tlgb.train(_params(tlgb, extra),
                           tlgb.Dataset(X[:350], label=y[:350]),
                           num_boost_round=3, verbose_eval=False)
        texts.append(_text(b))
        assert [i for i, _ in popped] == list(range(9))
        # two slots: classes 0 and 1 of each iteration come from the
        # ring, class 2 is quantized inline
        assert [hit for _, hit in popped] == \
            ([False] * 9 if inline else [True, True, False] * 3)
    assert texts[0] == texts[1]
    jb = jlgb.train(_params(jlgb, extra),
                    jlgb.Dataset(X[:350], label=y[:350]),
                    num_boost_round=3, verbose_eval=False)
    assert texts[0] == _text(jb)


def test_dart_parity(monkeypatch):
    """DART turns early stopping off, so the deferred read changes
    nothing at all: both loops give one model and one history, the JAX
    package's."""
    extra = {"boosting": "dart", "drop_rate": 0.5, "drop_seed": 4}
    runs = {}
    for pipe in ("0", None):
        _pipeline_env(monkeypatch, pipe)
        for lib in (jlgb, tlgb):
            runs[lib, pipe] = _run_earlystop(lib, extra, rounds=8)
    assert runs[tlgb, None][1] == runs[tlgb, "0"][1]
    assert _text(runs[tlgb, None][0]) == _text(runs[tlgb, "0"][0])
    for pipe in ("0", None):
        assert _text(runs[tlgb, pipe][0]) == _text(runs[jlgb, pipe][0])
        _assert_evals_close(runs[tlgb, pipe][1], runs[jlgb, pipe][1])


def test_earlystop_resume_parity(tmp_path, monkeypatch):
    """A pipelined run cut by a checkpoint resumes to the stop of an
    uninterrupted synchronous run, in the port and in the JAX package,
    and the two packages' resumed models are equal."""
    out = {}
    for lib, tag in ((jlgb, "jax"), (tlgb, "torch")):
        d = str(tmp_path / tag)
        extra = {"checkpoint_interval": 2}
        _pipeline_env(monkeypatch, None)
        _run_earlystop(lib, extra, rounds=2, ckpt=d)
        resumed, ev_r = _run_earlystop(lib, extra, ckpt=d)
        _pipeline_env(monkeypatch, "0")
        fresh, ev_f = _run_earlystop(lib, extra)
        assert resumed.best_iteration == fresh.best_iteration
        n = fresh.best_iteration
        assert _text(resumed, num_iteration=n) == \
            _text(fresh, num_iteration=n)
        tail = len(ev_r["valid_0"]["binary_logloss"])
        assert ev_f["valid_0"]["binary_logloss"][-tail:] == \
            ev_r["valid_0"]["binary_logloss"]
        out[tag] = (resumed.num_trees(), _text(resumed))
    assert out["torch"] == out["jax"]


# -- the periodic stop check (C15) ---------------------------------------

@pytest.mark.parametrize("extra", [{}, {"bagging_fraction": 0.8,
                                        "bagging_freq": 1}],
                         ids=["persistent", "per_tree"])
@pytest.mark.parametrize("pipe", ["1", "0"], ids=["pipelined",
                                                  "synchronous"])
def test_trailing_stop_check_parity(monkeypatch, pipe, extra):
    """An unreachable split gain keeps every tree at one leaf, so the
    fused paths' periodic check (period 2, set on the instance) ends
    training: in the same update of both packages, in both orders (the
    pipelined verdict lands one period later), with the same model and
    the same ``pipeline.delayed_stop_iters``."""
    _pipeline_env(monkeypatch, pipe)
    rng = np.random.RandomState(0)
    X = rng.randn(200, 3).astype(np.float32)
    y = rng.rand(200)
    params = {"objective": "regression", "verbose": -1,
              "min_data_in_leaf": 20, "min_gain_to_split": 1e9, **extra}
    out = {}
    for lib, mobs in ((jlgb, jobs), (tlgb, tobs)):
        reg = mobs.MetricsRegistry()
        mobs.activate(reg)
        try:
            p = dict(params, **({"device_type": "cpu"} if lib is tlgb
                                else {}))
            b = lib.train(p, lib.Dataset(X, label=y), num_boost_round=1,
                          verbose_eval=False, keep_training_booster=True)
            if lib is jlgb:
                b._gbdt._fused_check_every = 2
            else:
                b._gbdt._stop_check_every = 2
            it = 1
            while it < 12 and not b.update():
                it += 1
        finally:
            mobs.deactivate(reg)
        out[lib] = (it, b.num_trees(), _cur(b), _text(b),
                    reg.counters.get("pipeline.delayed_stop_iters", 0))
    assert out[tlgb] == out[jlgb]
    it, _, _, _, delayed = out[tlgb]
    assert it == (3 if pipe == "1" else 1)
    assert (delayed > 0) == (pipe == "1")


# -- counters and state --------------------------------------------------

def test_pipeline_counters_flow(monkeypatch):
    """A pipelined training with a valid set counts its trailing reads
    (``pipeline.inflight_fetches``) and, on the early-stopped last
    round, the iteration the stop trailed by; the same counts as the
    JAX package's. ``pipeline.donated_bytes`` has no counterpart (the
    port updates its state in place)."""
    _pipeline_env(monkeypatch, None)
    counts = {}
    for lib, mobs in ((jlgb, jobs), (tlgb, tobs)):
        reg = mobs.MetricsRegistry()
        mobs.activate(reg)
        try:
            _run_earlystop(lib, rounds=8)
        finally:
            mobs.deactivate(reg)
        counts[lib] = {k: reg.counters.get(k, 0) for k in (
            "pipeline.inflight_fetches", "pipeline.delayed_stop_iters")}
    assert counts[tlgb]["pipeline.inflight_fetches"] > 0
    assert counts[tlgb]["pipeline.delayed_stop_iters"] > 0
    assert counts[tlgb] == counts[jlgb]


@pytest.mark.parametrize("extra", [{}, {"bagging_fraction": 0.8,
                                        "bagging_freq": 1}],
                         ids=["persistent", "per_tree"])
def test_pipeline_env_off_is_synchronous(monkeypatch, extra):
    """LGBM_TPU_PIPELINE=0 leaves no state in flight, in either package,
    with a stop check every iteration."""
    from lightgbm_tpu.boosting import gbdt as jg
    from lightgbm_tpu_torch.boosting import gbdt as tg
    _pipeline_env(monkeypatch, "0")
    for mod, attr in ((jg, "_fused_check_every"),
                      (tg, "_stop_check_every")):
        def init(self, *a, _orig=mod.GBDT.init, _attr=attr, **kw):
            _orig(self, *a, **kw)
            setattr(self, _attr, 1)
        monkeypatch.setattr(mod.GBDT, "init", init)
    for lib in (jlgb, tlgb):
        b, _ = _run_earlystop(lib, extra, rounds=6, stop=3)
        g = b._gbdt
        assert g._pipeline is False
        assert g._stop_fetch is None and g._stop_pending is None


def _traced_syncs(extra, monkeypatch):
    """The sync events of a pipelined 12-round training, each charged to
    an iteration (the tracer's, set by a before-iteration callback)."""
    _pipeline_env(monkeypatch, None)
    rng = np.random.RandomState(9)
    X = rng.randn(500, 6).astype(np.float32)
    y = (X[:, 0] + 0.3 * rng.randn(500) > 0).astype(np.float64)
    ds = tlgb.Dataset(X[:350], label=y[:350])
    vs = ds.create_valid(X[350:], label=y[350:])
    tr = tobs.Tracer()
    tobs.activate_tracer(tr)
    assert tobs.install_sync_tracing()
    try:
        def mark(env):
            tobs.active_tracer().iteration = env.iteration
        mark.before_iteration = True
        mark.order = 0
        tlgb.train(_params(tlgb, extra), ds, num_boost_round=12,
                   valid_sets=[vs], callbacks=[mark], verbose_eval=False)
    finally:
        tobs.uninstall_sync_tracing()
        tobs.deactivate_tracer(tr)
    return [ev for ev in tr.buf if ev[2] == "sync"]


@pytest.mark.parametrize("extra", [{}, {"tpu_fused": False}],
                         ids=["fused", "host_loop"])
def test_loop_layers_read_once_per_steady_iteration(monkeypatch, extra):
    """The learners' reads per split and per tree are their own cost;
    the loop layers around them (boosting/, engine.py, basic.py) add at
    most one counted read per steady iteration: the trailing
    evaluation read, charged to the iteration that dispatched it."""
    per_iter = Counter()
    for _, _, _, _, _, it, args in _traced_syncs(extra, monkeypatch):
        site = (args or {}).get("site", "")
        if it >= 0 and ("boosting/" in site or "engine.py" in site
                        or "basic.py" in site):
            per_iter[it] += 1
    steady = range(3, 10)
    assert all(per_iter[i] == 1 for i in steady), per_iter
