"""The per-tree fused path without reads (``treelearner/fused.py``
``grow_device`` built into the learner's one state buffer, the captured
step's key bounded by the learner's rows, the forced phase's ``alive``
word; ``boosting/gbdt.py`` ``_train_one_iter_fused`` appending
``PendingTree``s, DART's one materialize per iteration) against the JAX
package's per-tree path (``grow_device``, ``PendingTree``,
``forced_step``), on the CPU at small sizes: 2,000 rows (400 on the
wide-sparse layout), 15-31 leaves, 3-4 iterations, every histogram
window within one B1 tile (2,048 rows).

Tolerances: model texts equal but the ``device_type`` line; raw
predictions, leaf values and state words bit for bit; a refit's
predictions within 1e-6, as tests/test_torch_devloop.py holds them.
"""
import json

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.treelearner import fused as tfused

from test_multival import make_wide_sparse
from test_torch_multiclass import mc_data
from test_torch_multival import force_multival
from test_torch_train import _data


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


BASE = {"objective": "binary", "num_leaves": 15, "verbose": -1,
        "min_data_in_leaf": 10, "learning_rate": 0.2}
BAG = {"bagging_fraction": 0.8, "bagging_freq": 1}
# every mode of the per-tree path: its params over BASE
MODES = {
    "multiclass": {"objective": "multiclass", "num_class": 3},
    "multiclassova": {"objective": "multiclassova", "num_class": 3},
    "bagging": BAG,
    "pos_neg_bagging": {"pos_bagging_fraction": 0.6,
                        "neg_bagging_fraction": 0.8, "bagging_freq": 1},
    # learning_rate 0.5: from iteration int(1 / 0.5) = 2 on a sample
    "goss": {"boosting": "goss", "learning_rate": 0.5},
    "rf": {"boosting": "rf", "bagging_fraction": 0.632, "bagging_freq": 1,
           "feature_fraction": 0.8},
    "dart": {"boosting": "dart", "drop_rate": 0.5, "skip_drop": 0.0},
    "wide_bagging": dict(BAG, min_data_in_leaf=5),
}
ROUNDS = 4


def _params(lib, extra=None):
    p = dict(BASE, **(extra or {}))
    if lib is tlgb:
        p["device_type"] = "cpu"
    return p


def _text(b, **kw):
    return "\n".join(ln for ln in b.model_to_string(**kw).splitlines()
                     if not ln.startswith("[device_type"))


def _mode_data(mode, monkeypatch):
    if mode.startswith("multiclass"):
        X, y, _ = mc_data(n=2000)
        return X, y
    if mode == "wide_bagging":
        force_multival(monkeypatch)
        X, y = make_wide_sparse(n=400)
        return sp.csr_matrix(X), np.asarray(y)
    return _data(n=2000)


def _pending(models):
    return [t for t in models
            if isinstance(t, tfused.PendingTree) and t._tree is None]


@pytest.mark.parametrize("mode", sorted(MODES))
def test_per_tree_updates_read_nothing(mode, monkeypatch):
    """Every update() of the per-tree path takes no counted read (DART:
    exactly its one materialize per iteration, as the JAX package's
    ``_normalize``); the trees stay ``PendingTree``s until a consumer
    reads them, one ``_materialize_models`` is one read, and the model
    text and raw predictions are the JAX package's."""
    X, y = _mode_data(mode, monkeypatch)
    extra = MODES[mode]
    tb = tlgb.Booster(_params(tlgb, extra), tlgb.Dataset(X, label=y))
    jb = jlgb.Booster(_params(jlgb, extra), jlgb.Dataset(X, label=y))
    gb = tb._gbdt
    fl = gb._fused
    assert fl is not None and not gb._fused_persist
    if mode == "wide_bagging":
        assert fl.layout.mv_planes > 0
    dart = mode == "dart"
    reads = []
    for _ in range(ROUNDS):
        s0 = fl.syncs
        tb.update()
        reads.append(fl.syncs - s0)
        jb.update()
    assert reads == [1 if dart else 0] * ROUNDS, reads
    k = gb.num_tree_per_iteration
    assert len(gb.models) == ROUNDS * k
    if dart:
        assert not _pending(gb.models)
    else:
        assert len(_pending(gb.models)) == ROUNDS * k
    s0 = fl.syncs
    gb._materialize_models()
    assert fl.syncs == s0 + (0 if dart else 1)
    assert not _pending(gb.models)
    assert _text(tb) == _text(jb)
    np.testing.assert_array_equal(tb.predict(X, raw_score=True),
                                  jb.predict(X, raw_score=True))


@pytest.mark.parametrize("mode", ["multiclass", "pos_neg_bagging", "goss"])
def test_capture_key_and_state_buffer_fixed(mode, monkeypatch):
    """The key a captured split step would be replayed under is the same
    for every tree and every bagging round (the bag's rows change from
    round to round: pos/neg bagging draws a count per round, GOSS
    switches from every row to top_k + other_k), and every tree's state
    lies in the learner's one buffer."""
    X, y = _mode_data(mode, monkeypatch)
    seen = []
    orig = tfused.FusedSerialGrower._grow_tree

    def spy(self, data, n, feature_mask, *a, **kw):
        seen.append((self._graph_signature(data, self.actual_rows,
                                           feature_mask.dim() == 2),
                     data.data_ptr(), n))
        return orig(self, data, n, feature_mask, *a, **kw)
    monkeypatch.setattr(tfused.FusedSerialGrower, "_grow_tree", spy)
    tb = tlgb.Booster(_params(tlgb, MODES[mode]), tlgb.Dataset(X, label=y))
    for _ in range(ROUNDS):
        tb.update()
    fl = tb._gbdt._fused
    assert len(seen) == ROUNDS * tb._gbdt.num_tree_per_iteration
    assert len({key for key, _, _ in seen}) == 1
    assert {ptr for _, ptr, _ in seen} == {fl._tree_data.data_ptr()}
    rows = [n for _, _, n in seen]
    if mode == "multiclass":
        assert set(rows) == {len(y)}
    else:
        assert len(set(rows)) > 1, rows      # the rows change, the key not
    if mode == "goss":
        assert rows[-1] == int(len(y) * 0.2) + int(len(y) * 0.1)


# -- PendingTree consumers on the per-tree path --------------------------

def _bag_pair(rounds=3, extra=None):
    X, y = _data(n=2000)
    out = {}
    for name, lib in (("jax", jlgb), ("torch", tlgb)):
        b = lib.Booster(_params(lib, dict(BAG, **(extra or {}))),
                        lib.Dataset(X, label=y))
        for _ in range(rounds):
            b.update()
        out[name] = b
    assert _pending(out["torch"]._gbdt.models)
    return out, X, y


@pytest.mark.parametrize("op", ["save_dump_predict", "rollback", "refit"])
def test_consumers_of_per_tree_pending_trees(op, tmp_path):
    """Save, dump and predict, rollback and refit on per-tree boosters
    whose trees are still pending give the JAX package's results."""
    b, X, y = _bag_pair()
    res = {}
    for name, bst in b.items():
        if op == "save_dump_predict":
            path = str(tmp_path / f"{name}.txt")
            bst.save_model(path)
            with open(path) as fh:
                text = "\n".join(ln for ln in fh.read().splitlines()
                                 if not ln.startswith("[device_type"))
            res[name] = (text, json.dumps(bst.dump_model()["tree_info"]),
                         bst.predict(X[:300], raw_score=True))
        elif op == "rollback":
            bst.rollback_one_iter()
            bst.update()
            res[name] = _text(bst)
        else:
            nb = bst.refit(X[:800], y[:800])
            res[name] = nb.predict(X[:300], raw_score=True)
    if op == "save_dump_predict":
        assert res["torch"][:2] == res["jax"][:2]
        np.testing.assert_array_equal(res["torch"][2], res["jax"][2])
    elif op == "refit":
        np.testing.assert_allclose(res["torch"], res["jax"], rtol=0,
                                   atol=1e-6)
    else:
        assert res["torch"] == res["jax"]


@pytest.mark.parametrize("mode", ["bagging", "multiclass"])
def test_checkpoint_resume_with_pending_per_tree_trees(mode, tmp_path,
                                                       monkeypatch):
    """A checkpoint taken while per-tree trees are pending resumes to the
    uninterrupted run's model, which is the JAX package's."""
    X, y = _mode_data(mode, monkeypatch)
    p = _params(tlgb, dict(MODES[mode],
                           checkpoint_dir=str(tmp_path / "ck"),
                           checkpoint_interval=2))
    tlgb.train(dict(p), tlgb.Dataset(X, label=y), num_boost_round=2)
    resumed = tlgb.train(dict(p), tlgb.Dataset(X, label=y),
                         num_boost_round=4)
    straight = tlgb.train(_params(tlgb, MODES[mode]),
                          tlgb.Dataset(X, label=y), num_boost_round=4)
    jb = jlgb.train(_params(jlgb, MODES[mode]), jlgb.Dataset(X, label=y),
                    num_boost_round=4)

    def body(b):
        return [ln for ln in _text(b).splitlines()
                if not ln.startswith(("[checkpoint_", "[num_iterations"))]
    assert body(resumed) == body(straight) == body(jb)


@pytest.mark.parametrize("pipe", [None, "0"], ids=["pipelined", "sync"])
def test_early_stop_on_the_per_tree_path(pipe, monkeypatch):
    """ROADMAP §C C14's gate setup (a valid set with every second label
    flipped, early_stopping_rounds 3) on the per-tree path, under the
    pipelined and the synchronous loop of both packages: the same trees,
    best iteration, model text and raw predictions."""
    if pipe is None:
        monkeypatch.delenv("LGBM_TPU_PIPELINE", raising=False)
    else:
        monkeypatch.setenv("LGBM_TPU_PIPELINE", pipe)
    X, y = _data(n=2000)
    Xv, yv = _data(seed=1, n=800)
    yv = yv.copy()
    yv[::2] = 1.0 - yv[::2]
    out = {}
    for lib in (jlgb, tlgb):
        p = _params(lib, dict(BAG, num_leaves=31, metric="binary_logloss"))
        ds = lib.Dataset(X, label=y)
        vs = lib.Dataset(Xv, label=yv, reference=ds)
        b = lib.train(p, ds, num_boost_round=30, valid_sets=[vs],
                      early_stopping_rounds=3, verbose_eval=False)
        out[lib] = (b.num_trees(), b.best_iteration, _text(b),
                    b.predict(X, raw_score=True))
    j, t = out[jlgb], out[tlgb]
    assert t[:3] == j[:3]
    np.testing.assert_array_equal(t[3], j[3])
    assert t[1] < 30


def test_quarantine_on_the_per_tree_path(monkeypatch):
    """``sentinel.check:nan@3`` with numeric_sentinels on the per-tree
    path: the poisoned device leaf values trip at the JAX package's
    iteration, one tree fewer than the clean run, finite predictions,
    and the JAX package's model text under the same plan."""
    from lightgbm_tpu.robust import install_plan as jinstall
    from lightgbm_tpu_torch.robust import install_plan
    monkeypatch.setenv("LGBM_TPU_PIPELINE", "0")
    X, y = _data(n=2000)
    p = dict(BAG, numeric_sentinels=True)
    plan = "sentinel.check:nan@3"
    texts = {}
    try:
        for name, lib, inst in (("jax", jlgb, jinstall),
                                ("torch", tlgb, install_plan)):
            inst(plan)
            b = lib.train(_params(lib, p), lib.Dataset(X, label=y),
                          num_boost_round=6, verbose_eval=False)
            inst(None)
            texts[name] = (_text(b), b.num_trees())
            if lib is tlgb:
                assert np.isfinite(b.predict(X)).all()
    finally:
        jinstall(None)
        install_plan(None)
    clean = tlgb.train(_params(tlgb, p), tlgb.Dataset(X, label=y),
                       num_boost_round=6, verbose_eval=False)
    assert texts["torch"][1] == clean.num_trees() - 1
    assert texts["torch"] == texts["jax"]


# -- forced splits without reads, both learners ---------------------------

FORCED = {"feature": 3, "threshold": 0.0,
          "left": {"feature": 4, "threshold": 0.5},
          "right": {"feature": 0, "threshold": -0.25}}
# the left child (x0 <= 0) forced on x0 at 1.0 has an empty right side:
# skipped, and with it every later forced split (the right child's)
SKIPPED = {"feature": 0, "threshold": 0.0,
           "left": {"feature": 0, "threshold": 1.0},
           "right": {"feature": 1, "threshold": 0.0}}
FORCED_LEARNERS = {"persistent": {}, "per_tree": BAG}


def _forced_boosters(spec, learner, tmp_path, rounds=3):
    path = str(tmp_path / "forced.json")
    with open(path, "w") as fh:
        json.dump(spec, fh)
    X, y = _data(n=2000)
    extra = dict(FORCED_LEARNERS[learner], forcedsplits_filename=path,
                 min_data_in_leaf=5)
    tb = tlgb.Booster(_params(tlgb, extra), tlgb.Dataset(X, label=y))
    jb = jlgb.Booster(_params(jlgb, extra), jlgb.Dataset(X, label=y))
    gb = tb._gbdt
    assert gb._fused is not None
    assert gb._fused_persist == (learner == "persistent")
    reads = []
    for _ in range(rounds):
        s0 = gb._fused.syncs
        tb.update()
        reads.append(gb._fused.syncs - s0)
        jb.update()
    return tb, jb, X, reads


@pytest.mark.parametrize("learner", sorted(FORCED_LEARNERS))
@pytest.mark.parametrize("spec", ["forced", "skipped"])
def test_forced_phase_reads_nothing(spec, learner, tmp_path):
    """The forced phase on the persistent and the per-tree learner takes
    no counted read, also when a skipped split ends it (the ``alive``
    word on the device); the gain-driven loop after it splits as the
    JAX package's, and the model text and raw predictions are its."""
    tb, jb, X, reads = _forced_boosters(
        FORCED if spec == "forced" else SKIPPED, learner, tmp_path)
    assert reads == [0, 0, 0], reads
    fl = tb._gbdt._fused
    assert [s[:2] for s in fl._forced_sched] == (
        [(0, 3), (0, 4), (1, 0)] if spec == "forced"
        else [(0, 0), (0, 0), (1, 1)])
    # on the CPU the flag is a host value: no sync
    assert bool(fl._st.alive[0]) == (spec == "forced")
    assert _text(tb) == _text(jb)
    np.testing.assert_array_equal(tb.predict(X, raw_score=True),
                                  jb.predict(X, raw_score=True))
    for t in tb._gbdt.models:
        if spec == "forced":
            assert list(t.split_feature[:3]) == [3, 4, 0]
            assert list(t.split_gain[:3]) == [0.0, 0.0, 0.0]
        else:
            # the root forced, then the gain-driven loop
            assert t.split_feature[0] == 0 and t.split_gain[0] == 0.0
            assert t.num_leaves > 3 and min(t.split_gain[1:3]) > 0.0


@pytest.mark.parametrize("learner", sorted(FORCED_LEARNERS))
def test_noop_forced_steps_leave_state_identical(learner, tmp_path):
    """Once ``alive`` is false, the forced steps change no real slot of
    the tree state and no lane of the planar state."""
    tb, _, _, _ = _forced_boosters(SKIPPED, learner, tmp_path, rounds=1)
    gb = tb._gbdt
    fl = gb._fused
    st = fl._st
    assert not bool(st.alive[0])
    data = gb._fused_state if learner == "persistent" else fl._tree_data
    L = fl.num_leaves
    names = ("best_f", "best_i", "leaf_f", "leaf_i", "leaf_depth",
             "leaf_parent", "t_f", "t_i", "t_left", "t_right", "n_leaves",
             "alive", "pool")

    def real(name):
        v = getattr(st, name)
        if name in ("t_f", "t_i", "t_left", "t_right"):
            v = v[..., :L - 1]
        elif name not in ("n_leaves", "alive"):
            v = v[:L] if v.dim() == 1 or name == "pool" else v[:, :L]
        v = v.clone()
        return v.view(torch.int32) if v.dtype == torch.float32 else v
    snap = {k: real(k) for k in names}
    data0 = data.clone()
    fl._forced_phase(st, data, fl.feature_masks_for_tree(), None,
                     fl.actual_rows)
    for k in names:
        assert torch.equal(real(k), snap[k]), k
    assert torch.equal(data, data0)
