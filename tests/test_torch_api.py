"""The API surface of the port against the JAX package: model files
(``save_model`` / ``Booster(model_file=...)``, ``model_to_string``,
``dump_model``, pickling), the Booster's accessors and evaluation,
continued training (``init_model``), ``rollback_one_iter``, ``refit``,
``learning_rates``, ``cv``, the callbacks, the Dataset's fields and
subsets, its ``LGTPU1`` binary files read across both packages, and text
files with pandas and without it. Plus the gates of options that were
ported without a test (``init_score``, ``boost_from_average`` false,
``max_bin_by_feature``, ``max_cat_threshold``). Ints, text and bins must
be equal; float32 model values bit for bit; ``cv``'s means and stdvs
within 1e-9."""
import json
import os
import pickle
import sys

import numpy as np
import pytest
import scipy.sparse as sp

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb

from test_multival import make_wide_sparse
from test_torch_categorical import make_cat_data
from test_torch_multival import force_multival
from test_torch_train import _data

P = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 5,
     "metric": "auc", "verbose": -1, "device_type": "cpu"}
TREE_FIELDS = ("split_feature", "threshold", "decision_type", "left_child",
               "right_child", "internal_count", "split_gain",
               "internal_value", "leaf_value", "leaf_count")


@pytest.fixture(autouse=True, scope="module")
def _no_aot_store():
    """Keep the JAX package's on-disk AOT store out of these tests (as
    tests/test_torch_train.py does)."""
    from lightgbm_tpu.compile.manager import get_manager
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LGBM_TPU_AOT", "0")
        mp.setattr(get_manager(), "aot_enabled", False)
        yield


def assert_models_equal(jmodels, tmodels):
    """The same trees, bit for bit."""
    assert len(jmodels) == len(tmodels)
    for i, (a, b) in enumerate(zip(jmodels, tmodels)):
        k = a.num_leaves
        assert k == b.num_leaves, i
        for f in TREE_FIELDS:
            n = k if f.startswith("leaf_") else k - 1
            np.testing.assert_array_equal(getattr(a, f)[:n],
                                          getattr(b, f)[:n],
                                          err_msg=f"tree {i} {f}")


def _without_device(text: str) -> str:
    return "\n".join(l for l in text.splitlines()
                     if not l.startswith("[device_type"))


def _train_both(params, rounds=3, data=None, valid=True, **kw):
    X, y = data if data is not None else _data(n=1000)
    Xv, yv = _data(seed=3, n=300)
    out = {}
    for name, lib in (("jax", jlgb), ("torch", tlgb)):
        ds = lib.Dataset(X, label=y, free_raw_data=False)
        vs = [lib.Dataset(Xv, label=yv, reference=ds)] if valid else None
        out[name] = lib.train(dict(params), ds, num_boost_round=rounds,
                              valid_sets=vs, valid_names=["v"] if valid
                              else None, verbose_eval=False,
                              keep_training_booster=True, **kw)
    return out["jax"], out["torch"], X, Xv


@pytest.fixture(scope="module")
def both():
    return _train_both(P)


def test_model_text_and_file_match_jax(both, tmp_path):
    """save_model and model_to_string give the JAX package's text
    character for character (but the device_type parameter)."""
    jb, tb, X, _ = both
    assert_models_equal(jb._gbdt._used_models(0, -1), tb._gbdt.models)
    assert _without_device(tb.model_to_string()) == \
        _without_device(jb.model_to_string())
    jb.save_model(str(tmp_path / "j.txt"))
    tb.save_model(str(tmp_path / "t.txt"))
    jtext = open(tmp_path / "j.txt").read()
    ttext = open(tmp_path / "t.txt").read()
    assert ttext == tb.model_to_string()
    assert _without_device(ttext) == _without_device(jtext)
    assert tb.model_to_string(num_iteration=2) != ttext


def test_model_file_round_trip(both, tmp_path):
    """Booster(model_file=...) and model_from_string predict bit-equal
    to the trained booster; either package's file loads in the other."""
    jb, tb, X, Xv = both
    path = str(tmp_path / "m.txt")
    tb.save_model(path)
    loaded = tlgb.Booster(params={"device_type": "cpu"}, model_file=path)
    again = tlgb.Booster.model_from_string(tb.model_to_string(),
                                           params={"device_type": "cpu"})
    for x in (X, Xv):
        ref = tb.predict(x, raw_score=True)
        np.testing.assert_array_equal(loaded.predict(x, raw_score=True), ref)
        np.testing.assert_array_equal(again.predict(x), tb.predict(x))
        np.testing.assert_array_equal(
            jlgb.Booster(model_file=path).predict(x, raw_score=True), ref)
    assert loaded.model_to_string() == tb.model_to_string()
    assert loaded._gbdt.num_init_iteration == 3
    jpath = str(tmp_path / "j.txt")
    jb.save_model(jpath)
    np.testing.assert_array_equal(
        tlgb.Booster(params={"device_type": "cpu"}, model_file=jpath)
        .predict(Xv), jb.predict(Xv))


def test_dump_model_and_pickle(both):
    jb, tb, X, _ = both
    assert json.dumps(tb.dump_model(), sort_keys=True) == \
        json.dumps(jb.dump_model(), sort_keys=True)
    assert tb.dump_model(num_iteration=1)["tree_info"][-1]["tree_index"] == 0
    st = pickle.loads(pickle.dumps(tb))
    assert st.model_to_string() == tb.model_to_string()
    np.testing.assert_array_equal(st.predict(X), tb.predict(X))


def test_booster_accessors_match_jax(both):
    jb, tb, X, _ = both
    assert tb.current_iteration == jb.current_iteration == 3
    assert tb.num_trees() == jb.num_trees() == 3
    assert tb.num_model_per_iteration() == jb.num_model_per_iteration()
    assert tb.num_feature() == jb.num_feature() == 6
    assert tb.feature_name() == jb.feature_name()
    for kind in ("split", "gain"):
        a, b = jb.feature_importance(kind), tb.feature_importance(kind)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tb.feature_importance(iteration=1),
                                  jb.feature_importance(iteration=1))
    for feat in (0, "Column_1"):
        for a, b in zip(jb.get_split_value_histogram(feat),
                        tb.get_split_value_histogram(feat, bins=None)):
            np.testing.assert_array_equal(a, b)


def test_trees_to_dataframe(both):
    pytest.importorskip("pandas")
    jb, tb, _, _ = both
    a, b = jb.trees_to_dataframe(), tb.trees_to_dataframe()
    assert list(a.columns) == list(b.columns)
    assert a.astype(str).equals(b.astype(str))


def test_eval_methods_match_jax(both):
    jb, tb, _, _ = both
    j = jb.eval_valid()
    t = tb.eval_valid()
    assert [r[:2] for r in t] == [r[:2] for r in j] == [("v", "auc")]
    # AUC is a float64 sum on both sides (ROADMAP §C: within 1e-7)
    np.testing.assert_allclose([r[2] for r in t], [r[2] for r in j],
                               rtol=0, atol=1e-7)
    jt, tt = jb.eval_train(), tb.eval_train()
    assert [r[:2] for r in tt] == [r[:2] for r in jt] == [("training", "auc")]
    np.testing.assert_allclose(tt[0][2], jt[0][2], rtol=0, atol=1e-7)

    def feval(preds, data):
        return "mean_pred", float(np.mean(preds)), False
    assert [r[1] for r in tb.eval(tb._train_set, "training", feval)] == \
        ["auc", "mean_pred"]
    vs = tb.eval(None, "v", feval)
    assert [r[1] for r in vs] == ["auc", "mean_pred"]
    with pytest.raises(tlgb.LightGBMError, match="No validation set"):
        tb.eval(None, "nope")


@pytest.mark.parametrize("learner", ["fused", "host_loop"])
@pytest.mark.parametrize("how", ["booster", "file"])
def test_init_model_continues_like_jax(learner, how, tmp_path):
    """Continued training: scores seeded by the old model's raw
    predictions, its trees first, ``num_init_iteration`` set; the same
    trees and predictions as the JAX package, bit for bit, and a
    validation set seeded the same way."""
    params = {**P, "tpu_fused": learner == "fused"}
    X, y = _data(n=1000)
    Xv, yv = _data(seed=3, n=300)
    out = {}
    for name, lib in (("jax", jlgb), ("torch", tlgb)):
        first = lib.train(dict(params), lib.Dataset(X, label=y),
                          num_boost_round=2, verbose_eval=False)
        path = str(tmp_path / f"first_{name}.txt")
        first.save_model(path)
        init = path if how == "file" else first
        ds = lib.Dataset(X, label=y, free_raw_data=False)
        vs = lib.Dataset(Xv, label=yv, reference=ds, free_raw_data=False)
        ev = {}
        b = lib.train(dict(params), ds, num_boost_round=2, init_model=init,
                      valid_sets=[vs], valid_names=["v"], evals_result=ev,
                      verbose_eval=False)
        out[name] = (b, ev)
    (jb, jev), (tb, tev) = out["jax"], out["torch"]
    assert tb._gbdt.num_init_iteration == jb._gbdt.num_init_iteration == 2
    assert tb.current_iteration == 4
    assert_models_equal(jb._gbdt._used_models(0, -1), tb._gbdt.models)
    np.testing.assert_array_equal(tb.predict(Xv, raw_score=True),
                                  jb.predict(Xv, raw_score=True))
    np.testing.assert_allclose(tev["v"]["auc"], jev["v"]["auc"], atol=1e-9)


def test_init_model_needs_the_raw_data():
    X, y = _data(n=300)
    first = tlgb.train(P, tlgb.Dataset(X, label=y), num_boost_round=1,
                       verbose_eval=False)
    ds = tlgb.Dataset(X, label=y).construct()
    with pytest.raises(tlgb.LightGBMError, match="free_raw_data"):
        tlgb.train(P, ds, num_boost_round=1, init_model=first)


@pytest.mark.parametrize("learner", ["fused", "host_loop"])
def test_rollback_one_iter_matches_jax(learner):
    """Rollback subtracts the last tree from the scores and drops it
    (the fused learner's persistent state is synced and rebuilt); the
    next iteration then grows the JAX package's tree again."""
    params = {**P, "tpu_fused": learner == "fused"}
    X, y = _data(n=1000)
    Xv, yv = _data(seed=3, n=300)
    out = {}
    for name, lib in (("jax", jlgb), ("torch", tlgb)):
        ds = lib.Dataset(X, label=y)
        b = lib.train(dict(params), ds, num_boost_round=3,
                      valid_sets=[lib.Dataset(Xv, label=yv, reference=ds)],
                      verbose_eval=False, keep_training_booster=True)
        b.rollback_one_iter()
        assert b.current_iteration == 2
        b.update()
        out[name] = b
    jb, tb = out["jax"], out["torch"]
    assert_models_equal(jb._gbdt._used_models(0, -1), tb._gbdt.models)
    np.testing.assert_array_equal(
        tb._gbdt.get_training_score().numpy(),
        np.asarray(jb._gbdt.get_training_score()))
    np.testing.assert_array_equal(tb._gbdt.valid_score[0].score.numpy(),
                                  np.asarray(jb._gbdt.valid_score[0].score))
    np.testing.assert_array_equal(tb.predict(Xv), jb.predict(Xv))


@pytest.mark.parametrize("objective", ["binary", "regression"])
def test_refit_matches_jax(both, objective):
    """refit: the trees' leaf values refit to new rows by float64 sums on
    the host, blended by the decay rate; the same model as the JAX
    package's."""
    X2, y2 = _data(seed=7, n=800)
    if objective == "binary":
        jb, tb, _, _ = both
    else:
        params = {**P, "objective": "regression", "metric": "l2"}
        jb, tb, _, _ = _train_both(params, rounds=2, valid=False)
        y2 = y2 + X2[:, 0]
    jr = jb.refit(X2, y2, decay_rate=0.7)
    tr = tb.refit(X2, y2, decay_rate=0.7)
    assert_models_equal(jr._gbdt._used_models(0, -1), tr._gbdt.models)
    np.testing.assert_array_equal(tr.predict(X2), jr.predict(X2))
    # the original keeps its leaf values
    assert not np.array_equal(tr._gbdt.models[0].leaf_value,
                              tb._gbdt.models[0].leaf_value)


def test_learning_rates_match_jax():
    """learning_rates (through reset_parameter) as a list and as a
    function of the round, bit-equal to the JAX package."""
    for rates in ([0.3, 0.2, 0.05], lambda i: 0.1 * 0.5 ** i):
        jb, tb, _, Xv = _train_both(P, rounds=3, valid=False,
                                    learning_rates=rates)
        assert_models_equal(jb._gbdt._used_models(0, -1), tb._gbdt.models)
        np.testing.assert_array_equal(tb.predict(Xv), jb.predict(Xv))


def test_callbacks():
    """print_evaluation is log_evaluation; record_metrics keeps one
    record per iteration; reset_parameter's list must match the rounds;
    a freed training set after train unless keep_training_booster."""
    assert tlgb.print_evaluation is tlgb.log_evaluation
    X, y = _data(n=300)
    ds = tlgb.Dataset(X, label=y)
    rec = []
    b = tlgb.train(P, ds, num_boost_round=3, valid_sets=[ds],
                   callbacks=[tlgb.record_metrics(rec),
                              tlgb.print_evaluation(2, show_stdv=False)],
                   verbose_eval=False)
    assert [r["iteration"] for r in rec] == [0, 1, 2]
    assert set(rec[-1]["metrics"]) == {"training/auc"}
    assert b._train_set is None
    with pytest.raises(ValueError, match="num_boost_round"):
        tlgb.train(P, tlgb.Dataset(X, label=y), num_boost_round=3,
                   callbacks=[tlgb.reset_parameter(learning_rate=[0.1])],
                   verbose_eval=False)


# cv on the 0/1 label under the l2 objective and metric: l2 is one of the
# JAX package's float32 device metrics, which the port gives bit for bit
# (AUC agrees within 1e-7 only, ROADMAP §C)
CV_PARAMS = {**P, "objective": "regression", "metric": "l2", "num_leaves": 7}


@pytest.mark.parametrize("kind", ["stratified", "plain", "group"])
def test_cv_matches_jax(kind):
    """cv: the same folds from the same RandomState draws (stratified,
    plain, or whole queries when the data has groups), one booster per
    fold on subsets; per-round means and stdvs within 1e-9."""
    X, y = _data(n=900)
    group = np.full(30, 30) if kind == "group" else None
    res = {}
    for name, lib in (("jax", jlgb), ("torch", tlgb)):
        res[name] = lib.cv(dict(CV_PARAMS),
                           lib.Dataset(X, label=y, group=group),
                           num_boost_round=3, nfold=3,
                           stratified=kind == "stratified", seed=5,
                           return_cvbooster=True)
    j, t = res["jax"], res["torch"]
    assert sorted(k for k in t if k != "cvbooster") == \
        sorted(k for k in j if k != "cvbooster") == ["l2-mean", "l2-stdv"]
    for k in ("l2-mean", "l2-stdv"):
        assert len(t[k]) == 3
        np.testing.assert_allclose(t[k], j[k], rtol=0, atol=1e-9)
    cvb = t["cvbooster"]
    assert isinstance(cvb, tlgb.CVBooster) and len(cvb.boosters) == 3
    assert cvb.num_trees() == [3, 3, 3]
    for jbst, tbst in zip(j["cvbooster"].boosters, cvb.boosters):
        assert_models_equal(jbst._gbdt._used_models(0, -1), tbst._gbdt.models)


def test_cv_early_stopping_and_train_metric():
    X, y = _data(n=600)
    res = {}
    for name, lib in (("jax", jlgb), ("torch", tlgb)):
        res[name] = lib.cv({**CV_PARAMS, "learning_rate": 0.5},
                           lib.Dataset(X, label=y), num_boost_round=30,
                           nfold=3, early_stopping_rounds=2,
                           eval_train_metric=True, seed=1)
    assert sorted(res["torch"]) == sorted(res["jax"])
    for k in res["jax"]:
        np.testing.assert_allclose(res["torch"][k], res["jax"][k], atol=1e-9)
    assert len(res["torch"]["valid l2-mean"]) < 30


def _handles(ds_j, ds_t):
    return ds_j.construct().handle, ds_t.construct().handle


def assert_datasets_equal(a, b):
    """Byte-identical bins, bin mappers and metadata."""
    assert a.bins.dtype == b.bins.dtype
    np.testing.assert_array_equal(a.bins, b.bins)
    assert json.dumps([m.to_dict() for m in a.bin_mappers]) == \
        json.dumps([m.to_dict() for m in b.bin_mappers])
    assert a.real_feature_index == b.real_feature_index
    assert a.feature_names == b.feature_names
    assert (a.bundles is None) == (b.bundles is None)
    if a.bundles is not None:
        assert a.bundles.groups == b.bundles.groups
    for f in ("label", "weights", "init_score", "query_boundaries"):
        x, z = getattr(a.metadata, f), getattr(b.metadata, f)
        assert (x is None) == (z is None), f
        if x is not None:
            assert x.dtype == z.dtype, f
            np.testing.assert_array_equal(x, z, err_msg=f)


def test_dataset_fields_match_jax():
    X, y = _data(n=400)
    w = np.random.RandomState(1).rand(400)
    group = np.full(8, 50)
    isc = np.random.RandomState(2).randn(400)
    dj = jlgb.Dataset(X, label=y, weight=w, group=group, init_score=isc,
                      feature_name=[f"f{i}" for i in range(6)])
    dt = tlgb.Dataset(X, label=y, weight=w, group=group, init_score=isc,
                      feature_name=[f"f{i}" for i in range(6)])
    assert_datasets_equal(*_handles(dj, dt))
    assert dt.num_data() == 400 and dt.num_feature() == 6
    assert dt.get_feature_name() == dj.get_feature_name()
    for f in ("label", "weight", "group", "init_score"):
        np.testing.assert_array_equal(dt.get_field(f), dj.get_field(f))
    dt.set_field("group", np.full(4, 100))
    dj.set_field("group", np.full(4, 100))
    dt.set_weight(None).set_label(1.0 - y).set_init_score(isc * 2)
    dj.set_weight(None).set_label(1.0 - y).set_init_score(isc * 2)
    assert_datasets_equal(dj.handle, dt.handle)
    assert dt.handle.metadata.num_queries == 4
    with pytest.raises(tlgb.LightGBMError, match="query counts"):
        dt.set_group(np.full(3, 50))
    v = dt.create_valid(X[:100], label=y[:100])
    assert v.reference is dt and v.construct().handle.bin_mappers is not None


def test_subset_matches_jax():
    """subset: the parent's codes, label, weights, per-class init-score
    columns and the subset's own group."""
    X, y = _data(n=600)
    isc = np.random.RandomState(4).randn(3 * 600)
    idx = np.random.RandomState(5).choice(600, 250, replace=False)
    hs = []
    for lib in (jlgb, tlgb):
        full = lib.Dataset(X, label=y, weight=np.arange(600.0),
                           init_score=isc, free_raw_data=False)
        sub = full.subset(idx)
        sub.group = np.full(5, 50)
        hs.append(sub.construct().handle)
    assert_datasets_equal(*hs)
    np.testing.assert_array_equal(
        hs[1].metadata.init_score.reshape(3, 250),
        isc.reshape(3, 600)[:, np.sort(idx)])


def test_add_features_from_matches_jax():
    X, y = _data(n=300)
    Xw, _ = make_wide_sparse(n=300, nvars=6)
    hs = []
    for lib in (jlgb, tlgb):
        a = lib.Dataset(X, label=y)
        a.add_features_from(lib.Dataset(Xw, label=y))
        hs.append(a.handle)
    assert_datasets_equal(*hs)
    assert hs[1].num_total_features == 6 + Xw.shape[1]


@pytest.mark.parametrize("kind", ["dense", "wide_sparse"])
def test_binary_file_across_packages(kind, tmp_path, monkeypatch):
    """LGTPU1 files written by either package load in the other with
    byte-identical bins and metadata (dense codes, and the EFB bundle
    codes the multi-value layout is built from); a port model trained on
    the loaded file equals one trained on the matrix."""
    if kind == "dense":
        X, y = _data(n=500)
        kw = {"weight": np.linspace(0.5, 1.5, 500),
              "init_score": np.zeros(500), "group": np.full(10, 50)}
    else:
        X, y = make_wide_sparse(n=1000, nvars=20)
        X = sp.csr_matrix(X)
        kw = {}
    dj = jlgb.Dataset(X, label=y, **kw).construct()
    dt = tlgb.Dataset(X, label=y, **kw).construct()
    assert_datasets_equal(dj.handle, dt.handle)
    tpath, jpath = str(tmp_path / "t.bin"), str(tmp_path / "j.bin")
    dt.save_binary(tpath)
    dj.save_binary(jpath)
    assert open(tpath, "rb").read() == open(jpath, "rb").read()
    assert_datasets_equal(jlgb.Dataset(tpath).construct().handle, dt.handle)
    from_j = tlgb.Dataset(jpath).construct()
    assert_datasets_equal(from_j.handle, dj.handle)
    if kind == "wide_sparse":
        assert from_j.handle.bundles is not None      # EFB bundle codes
        force_multival(monkeypatch)
    params = {**P, "metric": "none"}
    a = tlgb.train(params, from_j, num_boost_round=2)
    b = tlgb.train(params, dt, num_boost_round=2)    # the same bins
    assert_models_equal(a._gbdt.models, b._gbdt.models)


def _write_text_files(d):
    """CSV with a header, NA strings, a quoted column, and label / weight /
    query columns; TSV without a header; LibSVM."""
    rng = np.random.RandomState(0)
    n = 300
    X = rng.randn(n, 4)
    X[rng.rand(n) < 0.1, 1] = np.nan
    y = (X[:, 0] > 0).astype(int)
    w = rng.rand(n) + 0.5
    q = np.repeat(np.arange(30), 10)
    na = ["NA", "nan", "", "null"]

    def num(v):
        return repr(float(v))
    with open(os.path.join(d, "a.csv"), "w") as fh:
        fh.write("target,wt,f0,f1,qid,f2,f3\n")
        for i in range(n):
            f1 = na[i % 4] if np.isnan(X[i, 1]) else num(X[i, 1])
            fh.write(f"{y[i]},{num(w[i])},{num(X[i, 0])},{f1},{q[i]},"
                     f"{num(X[i, 2])},\"{num(X[i, 3])}\"\n")
    with open(os.path.join(d, "b.tsv"), "w") as fh:
        for i in range(n):
            fh.write("\t".join([str(y[i])] + [num(v) for v in X[i]]) + "\n")
    with open(os.path.join(d, "c.svm"), "w") as fh:
        for i in range(n):
            toks = [f"{j + 1}:{num(X[i, j])}" for j in range(4)
                    if not np.isnan(X[i, j]) and abs(X[i, j]) > 0.5]
            fh.write(" ".join([str(y[i])] + toks) + "\n")


TEXT_CASES = {
    "csv": ("a.csv", {"header": True, "label_column": "name:target",
                      "weight_column": "name:wt",
                      "group_column": "name:qid"}),
    "tsv": ("b.tsv", {}),
    "libsvm": ("c.svm", {}),
}


@pytest.mark.parametrize("pandas", [True, False], ids=["pandas", "csv_module"])
@pytest.mark.parametrize("case", sorted(TEXT_CASES))
def test_text_files_match_jax(case, pandas, tmp_path, monkeypatch):
    """CSV / TSV / LibSVM files through both packages give identical bins
    and metadata, read by pandas and by the csv module (pandas hidden, as
    on a machine without it)."""
    if pandas:
        pytest.importorskip("pandas")
    else:
        monkeypatch.setitem(sys.modules, "pandas", None)
    _write_text_files(str(tmp_path))
    name, params = TEXT_CASES[case]
    path = str(tmp_path / name)
    dj = jlgb.Dataset(path, params=dict(params))
    dt = tlgb.Dataset(path, params=dict(params))
    assert_datasets_equal(*_handles(dj, dt))
    if case == "csv":
        assert dt.handle.metadata.num_queries == 30
        assert dt.num_feature() == 4
        assert dt.handle.metadata.weights is not None
        assert dt.handle.bin_mappers[1].missing_type == 2    # the NA strings


# options the port trained before without a gate: each bit-equal to the
# JAX package on both learners (a random init_score goes on the Dataset)
OPTION_GATES = {
    "init_score_binary": ({}, "init_score"),
    "init_score_regression": ({"objective": "regression", "metric": "l2"},
                              "init_score"),
    "boost_from_average_false": ({"boost_from_average": False}, None),
    "max_bin_by_feature": ({"max_bin_by_feature": [7, 15, 31, 63, 255, 3]},
                           None),
    "max_cat_threshold_2": ({"max_cat_threshold": 2,
                             "categorical_feature": [4, 5]}, "cat"),
}


@pytest.mark.parametrize("learner", ["fused", "host_loop"])
@pytest.mark.parametrize("case", sorted(OPTION_GATES))
def test_option_gates_bit_equal(case, learner):
    extra, data = OPTION_GATES[case]
    params = {**P, "metric": "none", **extra,
              "tpu_fused": learner == "fused"}
    X, y = make_cat_data(n=1000) if data == "cat" else _data(n=1000)
    if extra.get("objective") == "regression":
        y = y + X[:, 0]
    isc = (np.random.RandomState(9).randn(len(y)) * 0.5
           if data == "init_score" else None)
    jb = jlgb.train(dict(params), jlgb.Dataset(X, label=y, init_score=isc),
                    num_boost_round=3)
    tb = tlgb.train(dict(params), tlgb.Dataset(X, label=y, init_score=isc),
                    num_boost_round=3)
    assert (tb._gbdt._fused is not None) == (learner == "fused")
    assert_models_equal(jb._gbdt._used_models(0, -1), tb._gbdt.models)
    np.testing.assert_array_equal(tb.predict(X, raw_score=True),
                                  jb.predict(X, raw_score=True))
    np.testing.assert_array_equal(tb._gbdt.get_training_score().numpy(),
                                  np.asarray(jb._gbdt.get_training_score()))


def test_timetag_times_the_phases(monkeypatch):
    """``timetag`` turns on utils/timer.py's phase table for one train():
    the construction and every iteration, reported at its end."""
    from lightgbm_tpu_torch.utils import timer
    seen = []
    monkeypatch.setattr(timer.global_timer, "report",
                        lambda: seen.append(dict(timer.global_timer.cnt))
                        or "")
    X, y = _data(n=300)
    try:
        tlgb.train({**P, "timetag": True}, tlgb.Dataset(X, label=y),
                   num_boost_round=2)
    finally:
        timer.global_timer.set_enabled(False)
    # the telemetry spans (obs/spans.py) feed the same table, as the
    # JAX package's do: the iterations and the learner's dispatchers
    (table,) = seen
    assert table["dataset construction + learner build"] == 1
    assert table["boosting iteration (device dispatch)"] == 2
    assert table["fused/train_iter"] == 2
    assert table["fused/leaf_histogram"] > 2
    assert not timer.global_timer.acc
