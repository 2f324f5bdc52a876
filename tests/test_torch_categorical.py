"""Categorical features and the packed-forest predictor of the port
against the JAX package, on the same seeded numpy data:

- the categorical split scan (the port's ``best_split`` on metadata
  with categorical features) against the jitted JAX
  ``best_split(any_categorical=True)`` on random histograms, bit for bit in
  gain, position, family, sorted order and sums;
- the group thinning of the sorted scan against its sequential
  definition;
- training on both learners (and the quantized fused learner, NaN in a
  categorical column, the multi-value layout): trees, bitset pools,
  split gains, leaf values and predictions bit for bit;
- ``PackedForest`` (raw scores, leaf indices, prediction early stop)
  and the model carried across as text and as arrays, bit for bit.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.models.forest import PackedForest as JForest
from lightgbm_tpu.ops import split as JS
from lightgbm_tpu_torch.convert import booster_from_jax_arrays
from lightgbm_tpu_torch.models.forest import PackedForest as TForest
from lightgbm_tpu_torch.ops import split as TS

from test_torch_multival import force_multival


@pytest.fixture(autouse=True, scope="module")
def _no_aot_store():
    """Keep the JAX package's on-disk AOT executable store out of these
    tests, as tests/test_torch_train.py does; and run torch on two
    threads (restored after), as the parallel workers' thread pools
    would otherwise oversubscribe the cores."""
    from lightgbm_tpu.compile.manager import get_manager
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LGBM_TPU_AOT", "0")
        mp.setattr(get_manager(), "aot_enabled", False)
        yield
    torch.set_num_threads(threads)


def make_cat_data(n=2000, seed=0):
    """tests/test_fused_categorical.py's data (copied): 4 numerical
    columns, then categorical columns of 12 and 30 levels."""
    rng = np.random.RandomState(seed)
    Xnum = rng.randn(n, 4).astype(np.float32)
    cat1 = rng.randint(0, 12, n).astype(np.float32)
    cat2 = rng.randint(0, 30, n).astype(np.float32)
    X = np.column_stack([Xnum, cat1, cat2])
    logit = (X[:, 0] + np.where(np.isin(cat1, [2, 5, 7]), 1.5, -0.5)
             + 0.3 * (cat2 % 3))
    y = (logit + 0.3 * rng.randn(n) > 0.5).astype(np.float32)
    return X, y


PARAMS = {"objective": "binary", "num_leaves": 15, "verbose": -1,
          "categorical_feature": [4, 5]}
TREE_FIELDS = ("split_feature", "threshold", "decision_type", "left_child",
               "right_child", "internal_count", "leaf_count")


def _jax_trees(b):
    return b._gbdt._used_models(0, -1)


def assert_trees_bit_equal(jt, tt, categorical=True):
    """Structure, bitset pools, split gains and leaf values, bit for bit."""
    assert len(jt) == len(tt)
    cats = 0
    for i, (a, b) in enumerate(zip(jt, tt)):
        k = a.num_leaves
        assert k == b.num_leaves, (i, k, b.num_leaves)
        for f in TREE_FIELDS + ("split_gain",):
            m = k if f == "leaf_count" else k - 1
            np.testing.assert_array_equal(getattr(a, f)[:m],
                                          getattr(b, f)[:m],
                                          err_msg=f"tree {i} {f}")
        np.testing.assert_array_equal(a.leaf_value[:k], b.leaf_value[:k],
                                      err_msg=f"tree {i} leaf_value")
        assert a.num_cat == b.num_cat, i
        for f in ("cat_boundaries", "cat_threshold", "cat_boundaries_inner",
                  "cat_threshold_inner"):
            assert list(getattr(a, f)) == list(getattr(b, f)), (i, f)
        cats += a.num_cat
    assert (cats > 0) == categorical, cats


# ---------------------------------------------------------------------------
# the categorical split scan
# ---------------------------------------------------------------------------

F, B = 7, 64
CAT = (1, 3, 4, 5)


def _scan_meta(seed):
    """Per-feature metadata with categorical columns of 3 (one-vs-rest at
    the default max_cat_to_onehot), 20, 45 and 64 bins."""
    rng = np.random.RandomState(seed)
    num_bin = rng.randint(2, B + 1, F)
    num_bin[list(CAT)] = (3, 20, 45, 64)
    missing = rng.randint(0, 3, F)
    missing[list(CAT)] = (0, 2, 0, 2)
    default_bin = np.array([rng.randint(0, nb) for nb in num_bin])
    is_cat = np.zeros(F, bool)
    is_cat[list(CAT)] = True
    return num_bin, missing, default_bin, is_cat


def _scan_hist(rng, num_bin):
    """Zipf-like bin counts (rare bins fall under cat_smooth) with
    float grad / hess, every feature over the same rows."""
    cnt = (np.minimum(rng.zipf(1.3, (F, B)), 400)
           * rng.randint(0, 2, (F, B))).astype(np.float32)
    cnt[np.arange(B)[None, :] >= num_bin[:, None]] = 0
    hess = cnt * rng.uniform(0.05, 0.25, (F, B)).astype(np.float32)
    grad = (cnt * rng.uniform(-0.5, 0.5, (F, B))
            + rng.randn(F, B)).astype(np.float32) * (cnt > 0)
    hess *= hess[0].sum() / np.maximum(hess.sum(1, keepdims=True), 1e-9)
    return np.stack([grad, hess], -1).astype(np.float32)


SCAN_CFGS = {
    "default": {},
    "onehot_64": dict(max_cat_to_onehot=64),
    "l1": dict(lambda_l1=0.5, lambda_l2=2.0, min_gain_to_split=0.1),
    "path_smooth": dict(path_smooth=5.0, min_sum_hessian_in_leaf=1.0),
    "l1_path_smooth": dict(lambda_l1=0.5, path_smooth=2.0),
    "max_delta_step": dict(max_delta_step=0.3, min_data_in_leaf=5),
    "min_data_per_group_1": dict(min_data_per_group=1, min_data_in_leaf=2,
                                 cat_smooth=2.0),
    "min_data_per_group_100": dict(min_data_per_group=100),
    "extra_trees": dict(extra_trees=True),
}
SCAN_KEYS = ("gain", "threshold", "cat_family", "cat_used_bin",
             "left_count", "right_count", "left_sum_gradient",
             "left_sum_hessian", "right_sum_gradient", "right_sum_hessian",
             "left_output", "right_output", "default_left")


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("cfg_name", sorted(SCAN_CFGS))
def test_categorical_scan_matches_jax(cfg_name):
    """The merged scan against the jitted JAX ``best_split`` on 6 random
    histograms: every field of every feature with a split, and the
    sorted bin order of the categorical ones, bit for bit."""
    kw = SCAN_CFGS[cfg_name]
    num_bin, missing, default_bin, is_cat = _scan_meta(0)
    mono = np.zeros(F, np.int32)
    pen = np.linspace(0.5, 1.0, F).astype(np.float32)
    jmeta = JS.FeatureMeta.build(num_bin, missing, default_bin, is_cat, mono,
                                 pen)
    tmeta = TS.FeatureMeta.build(num_bin, missing, default_bin, is_cat, mono,
                                 pen)
    jcfg = dataclasses.replace(JS.SplitConfig(), **kw)
    tcfg = dataclasses.replace(TS.SplitConfig(), **kw)
    et = bool(kw.get("extra_trees"))
    fn = jax.jit(lambda h, sg, sh, n, po, r: JS.best_split(
        h, jmeta, jcfg, sg, sh, n, po, -jnp.inf, jnp.inf,
        rand_thresholds=r if et else None, any_categorical=True))
    rng = np.random.RandomState(1)
    families = set()
    for _ in range(6):
        hist = _scan_hist(rng, num_bin)
        sg, sh = hist[0, :, 0].sum(), hist[0, :, 1].sum()
        n = int(round(sh * 5))
        rt = (rng.randint(0, 1 << 30, F) % np.maximum(num_bin - 2, 1)
              ).astype(np.int32)
        want = fn(jnp.asarray(hist), jnp.float32(sg), jnp.float32(sh),
                  jnp.int32(n), jnp.float32(0.1), jnp.asarray(rt))
        t32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
        got = TS.best_split(
            torch.as_tensor(hist), tmeta, tcfg, t32(sg), t32(sh),
            torch.tensor(n, dtype=torch.int32), t32(0.1), t32(-np.inf),
            t32(np.inf), rand_thresholds=torch.as_tensor(rt) if et else None)
        found = np.isfinite(np.asarray(want["gain"]))
        np.testing.assert_array_equal(found, np.isfinite(got["gain"].numpy()))
        for k in SCAN_KEYS:
            np.testing.assert_array_equal(
                _bits(got[k].numpy())[found], _bits(want[k])[found],
                err_msg=k)
        cat_found = found & is_cat
        np.testing.assert_array_equal(
            got["cat_sorted_order"].numpy()[cat_found],
            np.asarray(want["cat_sorted_order"])[cat_found])
        assert int(got["best_feature"]) == int(want["best_feature"])
        families |= set(np.asarray(want["cat_family"])[cat_found].tolist())
    assert families, "no categorical feature found a split"


def test_categorical_scan_batches_leaves():
    """Two leaves in one call (the fused learner's batch) equal two
    single-leaf calls."""
    num_bin, missing, default_bin, is_cat = _scan_meta(2)
    meta = TS.FeatureMeta.build(num_bin, missing, default_bin, is_cat,
                                np.zeros(F), np.ones(F))
    cfg = TS.SplitConfig()
    rng = np.random.RandomState(3)
    h2 = torch.as_tensor(np.stack([_scan_hist(rng, num_bin),
                                   _scan_hist(rng, num_bin)]))
    sg, sh = h2[:, 0, :, 0].sum(1), h2[:, 0, :, 1].sum(1)
    n = torch.round(sh * 5).to(torch.int32)
    z = torch.zeros(2)
    both = TS.best_split(h2, meta, cfg, sg, sh, n, z, z - np.inf, z + np.inf)
    for i in range(2):
        one = TS.best_split(h2[i], meta, cfg, sg[i], sh[i], n[i], z[i],
                            z[i] - np.inf, z[i] + np.inf)
        for k, v in one.items():
            assert torch.equal(both[k][i], v), k


def _thinning_sequential(lc, lc_ok, m):
    """The JAX package's lax.scan, as a loop."""
    fires = np.zeros_like(lc_ok)
    for r in range(lc.shape[0]):
        gcnt, prev = 0, 0
        for i in range(lc.shape[1]):
            gcnt += lc[r, i] - prev
            prev = lc[r, i]
            if lc_ok[r, i] and gcnt >= m:
                fires[r, i] = True
                gcnt = 0
    return fires


@pytest.mark.parametrize("m", [1, 7, 100])
@pytest.mark.parametrize("monotone", [True, False])
def test_group_thinning_matches_sequential_scan(m, monotone):
    rng = np.random.RandomState(m)
    inc = rng.randint(0 if monotone else -20, 60, (40, 256))
    lc = np.cumsum(inc, axis=1).astype(np.int32)
    lc_ok = rng.rand(40, 256) < 0.8
    got = TS.group_thinning(torch.as_tensor(lc), torch.as_tensor(lc_ok), m)
    np.testing.assert_array_equal(got.numpy(),
                                  _thinning_sequential(lc, lc_ok, m))


# ---------------------------------------------------------------------------
# training gates
# ---------------------------------------------------------------------------

def _nan_in_cat(X):
    X = X.copy()
    X[np.random.RandomState(4).rand(len(X)) < 0.1, 5] = np.nan
    return X


GATES = {
    "fused": ({}, None),
    "host_loop": ({"tpu_fused": False}, None),
    "fused_quantized": ({"use_quantized_grad": True}, None),
    "host_loop_nan_l1": ({"tpu_fused": False, "lambda_l1": 0.5}, _nan_in_cat),
    # no categorical column and no missing value: the host loop's
    # forward scan is folded away and its reverse scan fuses 2·g·o
    # (ops/split.py scan_sites; ROADMAP §C)
    "host_loop_numerical": ({"tpu_fused": False,
                             "categorical_feature": []}, lambda X: X[:, :4]),
}


@pytest.mark.parametrize("case", sorted(GATES))
def test_categorical_training_bit_equal(case):
    """make_cat_data, 15 leaves, 3 trees: the same trees (bitset pools
    included), split gains, leaf values and predictions."""
    extra, mod = GATES[case]
    X, y = make_cat_data()
    if mod is not None:
        X = mod(X)
    params = {**PARAMS, **extra}
    jb = jlgb.train(dict(params), jlgb.Dataset(X, label=y),
                    num_boost_round=3)
    tb = tlgb.train({**params, "device_type": "cpu"},
                    tlgb.Dataset(X, label=y), num_boost_round=3,
                    verbose_eval=False)
    assert (tb._gbdt._fused is not None) == ("fused" in case)
    assert_trees_bit_equal(_jax_trees(jb), tb._gbdt.models,
                           categorical=case != "host_loop_numerical")
    np.testing.assert_array_equal(tb.predict(X, raw_score=True),
                                  jb.predict(X, raw_score=True))
    np.testing.assert_array_equal(tb.predict(X), jb.predict(X))


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "host_loop"])
def test_categorical_training_multival_forced(monkeypatch, fused):
    """The multi-value layout forced in both packages
    (tests/test_torch_multival.py ``force_multival``), NaN in a
    categorical column: the port's fused learner on B5's plain version
    against the JAX fused learner, and the port's host loop on B6's
    against the JAX host loop. The same trees (bitset pools and counts
    included), split gains, leaf values and predictions, bit for bit."""
    X, y = make_cat_data(n=500)
    X = _nan_in_cat(X)
    params = {**PARAMS, "min_data_in_leaf": 5, "tpu_fused": fused}
    force_multival(monkeypatch)
    jb = jlgb.train(dict(params), jlgb.Dataset(X, label=y),
                    num_boost_round=3)
    tb = tlgb.train({**params, "device_type": "cpu"},
                    tlgb.Dataset(X, label=y), num_boost_round=3,
                    verbose_eval=False)
    gb = tb._gbdt
    assert (jb._gbdt._fused is not None) == fused
    if fused:
        assert gb._fused is not None and gb._fused.layout.mv_planes > 0
    else:
        assert gb.tree_learner._mv_state is not None
    tt = gb.models
    assert len(tt) == 3 and sum(t.num_cat for t in tt) > 0
    assert_trees_bit_equal(_jax_trees(jb), tt, categorical=True)
    np.testing.assert_array_equal(tb.predict(X, raw_score=True),
                                  jb.predict(X, raw_score=True))


# ---------------------------------------------------------------------------
# the packed forest and the model carried across
# ---------------------------------------------------------------------------

def _num_data(n=2000):
    """The early-stop probe's data: 2,000 rows x 6 features, NaN in one
    column."""
    rng = np.random.RandomState(0)
    X = rng.randn(n, 6)
    X[rng.rand(n) < 0.05, 2] = np.nan
    y = (X[:, 0] + 0.5 * X[:, 1] + rng.randn(n) * 0.5 > 0).astype(float)
    return X, y


_MODELS = {}


def _model(kind):
    """A trained JAX model and its port twin, per kind, trained once per
    test process: "categorical" (make_cat_data with NaN, 6 trees) and
    "numerical" (the early-stop probe: 2,000 x 6, 15 leaves, 6 trees)."""
    if kind not in _MODELS:
        if kind == "categorical":
            X, y = make_cat_data()
            X, params = _nan_in_cat(X), PARAMS
        else:
            X, y = _num_data()
            params = {"objective": "binary", "num_leaves": 15, "verbose": -1}
        jb = jlgb.train(dict(params), jlgb.Dataset(X, label=y),
                        num_boost_round=6)
        tb = tlgb.train({**params, "device_type": "cpu"},
                        tlgb.Dataset(X, label=y), num_boost_round=6,
                        verbose_eval=False)
        _MODELS[kind] = (jb, tb, X)
    return _MODELS[kind]


def _assert_forest_matches(jtrees, ttrees, x):
    """raw_scores, leaf_indices and raw_scores_early_stop of the port's
    PackedForest over ``ttrees`` against the JAX PackedForest over
    ``jtrees``, bit for bit."""
    jf, tf = JForest(jtrees, 1), TForest(ttrees, 1, "cpu")
    xj, xt = jnp.asarray(x), torch.as_tensor(x)
    np.testing.assert_array_equal(tf.raw_scores(xt).numpy(),
                                  np.asarray(jf.raw_scores(xj)))
    np.testing.assert_array_equal(tf.leaf_indices(xt).numpy(),
                                  np.asarray(jf.leaf_indices(xj)))
    for freq, margin in ((1, 1.0), (3, 2.5)):
        np.testing.assert_array_equal(
            tf.raw_scores_early_stop(xt, freq, margin).numpy(),
            np.asarray(jf.raw_scores_early_stop(xj, freq, margin)))


@pytest.mark.parametrize("kind", ["categorical", "numerical"])
def test_packed_forest_and_predict_match_jax(kind):
    """One trained model per kind ("numerical" is the early-stop probe:
    2,000 x 6, 15 leaves, 6 trees):

    - the forests over both packages' trees, and over the trees twelve
      times over (72 trees: two forest blocks, three of xla_sum's
      32-tree windows);
    - Booster.predict with pred_early_stop (freq 1, margin 1.0: on the
      numerical model the port once ignored it, 0.438 off on 1,711 of
      2,000 rows; the option is a training parameter, read by both
      packages' predict from the model's config) and with pred_leaf."""
    jb, tb, X = _model(kind)
    x = np.asarray(X, np.float32)
    jt, tt = _jax_trees(jb), tb._gbdt.models
    _assert_forest_matches(jt, tt, x)
    _assert_forest_matches(jt * 12, tt * 12, x)
    cfgs = (jb._gbdt.config, tb._gbdt.config)
    for c in cfgs:
        c.pred_early_stop, c.pred_early_stop_freq = True, 1
        c.pred_early_stop_margin = 1.0
    try:
        got = tb.predict(X, raw_score=True)
        np.testing.assert_array_equal(got, jb.predict(X, raw_score=True))
        np.testing.assert_array_equal(tb.predict(X), jb.predict(X))
    finally:
        for c in cfgs:
            c.pred_early_stop = False
    # early stop did change the scores
    assert (tb.predict(X, raw_score=True) != got).any()
    leaf = tb.predict(X, pred_leaf=True)
    assert leaf.shape == (len(X), len(tt)) and leaf.dtype == np.int32
    np.testing.assert_array_equal(leaf, jb.predict(X, pred_leaf=True))
    if kind == "categorical":
        _assert_bridges_match(jb, tb, x)
        _assert_carried_across(jb, X)


def _assert_bridges_match(jb, tb, x):
    """Tree.leaf_index_raw and Tree.leaf_index_binned (the score
    updates' bin-space walk) against the JAX Tree's, tree by tree."""
    ds = tb._gbdt.train_data
    bins = torch.as_tensor(ds.bins.astype(np.int32))
    miss = tb._gbdt._fused.feature_miss_bin
    for a, b in zip(_jax_trees(jb), tb._gbdt.models):
        np.testing.assert_array_equal(
            b.leaf_index_raw(torch.as_tensor(x)).numpy(),
            np.asarray(a.leaf_index_raw(jnp.asarray(x))))
        np.testing.assert_array_equal(
            b.leaf_index_binned(bins, miss).numpy(),
            np.asarray(a.leaf_index_binned(jnp.asarray(ds.bins),
                                           np.asarray(miss))))


def _assert_carried_across(jb, X):
    """A JAX categorical model predicts the same through
    Booster(model_str=...) and through convert.booster_from_jax_arrays."""
    want_raw = jb.predict(X, raw_score=True)
    want = jb.predict(X)
    text = tlgb.Booster(params={"device_type": "cpu"},
                        model_str=jb.model_to_string())
    np.testing.assert_array_equal(text.predict(X, raw_score=True), want_raw)
    np.testing.assert_array_equal(text.predict(X), want)
    fields = ("split_feature", "split_gain", "threshold", "decision_type",
              "left_child", "right_child", "leaf_value", "leaf_weight",
              "leaf_count", "internal_value", "internal_weight",
              "internal_count", "threshold_in_bin")
    trees = [{f: np.asarray(getattr(t, f))[:t.num_leaves
                                            if f.startswith("leaf_")
                                            else t.num_leaves - 1]
              for f in fields}
             | {"num_leaves": t.num_leaves, "num_cat": t.num_cat,
                "cat_boundaries": list(t.cat_boundaries),
                "cat_threshold": list(t.cat_threshold)}
             for t in _jax_trees(jb)]
    assert any(t["num_cat"] for t in trees)
    arr = booster_from_jax_arrays(trees, max_feature_idx=5,
                                  params={"device_type": "cpu"})
    np.testing.assert_array_equal(arr.predict(X, raw_score=True), want_raw)
    np.testing.assert_array_equal(arr.predict(X), want)
    np.testing.assert_array_equal(arr.predict(X, pred_leaf=True),
                                  jb.predict(X, pred_leaf=True))


def test_pred_contrib_raises():
    """``pred_contrib`` on the categorical model: the JAX package's
    float64 TreeSHAP values, exactly, on 200 rows with NaN in the
    categorical columns; each row sums to its raw score."""
    jb, tb, X = _model("categorical")
    x = X[:200]
    got = tb.predict(x, pred_contrib=True)
    np.testing.assert_array_equal(got, jb.predict(x, pred_contrib=True))
    assert got.shape == (200, X.shape[1] + 1)
    np.testing.assert_allclose(got.sum(axis=1),
                               tb.predict(x, raw_score=True), atol=1e-6)
