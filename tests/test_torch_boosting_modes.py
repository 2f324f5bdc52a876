"""Row sampling and the boosting modes of the port against the JAX
package: bagging (``bagging_freq`` 1 and 2), pos/neg bagging, GOSS,
DART (both ``xgboost_dart_mode`` forms, ``uniform_drop``) and RF, on
both learners, plus multiclass with bagging, wide-sparse bagging on the
multi-value layout, and quantized / L1 training with bagging on the
host loop. The same seed-made data and params go through
``lightgbm_tpu.train`` (its CPU path) and
``lightgbm_tpu_torch.train(device_type="cpu")``: trees, split gains,
leaf values, training scores and predictions are bit-equal, metrics
within 1e-6. The GOSS selection is held against ``jax.lax.top_k`` on
tie-heavy vectors and the whole sampling round against the JAX
package's; the bag branch's traversal against the partition on the
bag's rows; an RF model's text round-trips and a JAX RF model loads."""
import numpy as np
import pytest
import scipy.sparse as sp

import jax
import jax.numpy as jnp
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.boosting.gbdt import _goss_sample_device
from lightgbm_tpu_torch.boosting.gbdt import goss_sample
from lightgbm_tpu_torch.convert import booster_from_jax_arrays

from test_multival import make_wide_sparse
from test_torch_categorical import make_cat_data
from test_torch_multival import force_multival
from test_torch_train import PARAMS, TREE_FIELDS, _data, _jax_trees


@pytest.fixture(autouse=True, scope="module")
def _no_aot_store():
    """Keep the JAX package's on-disk AOT executable store out of these
    tests, as tests/test_multival.py does."""
    from lightgbm_tpu.compile.manager import get_manager
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LGBM_TPU_AOT", "0")
        mp.setattr(get_manager(), "aot_enabled", False)
        yield


BAG = {"bagging_fraction": 0.7, "bagging_freq": 1}
# each case's params over PARAMS, with the boosting class the port builds
MODES = {
    "bagging": (BAG, "GBDT"),
    "bagging_freq_2": ({"bagging_fraction": 0.6, "bagging_freq": 2,
                        "bagging_seed": 7}, "GBDT"),
    "pos_neg_bagging": ({"pos_bagging_fraction": 0.6,
                         "neg_bagging_fraction": 0.8, "bagging_freq": 1},
                        "GBDT"),
    # learning_rate 0.5: iterations from int(1 / 0.5) = 2 on sample;
    # rows of one leaf and label share |g·h|, so the top rows tie
    "goss": ({"boosting": "goss", "learning_rate": 0.5}, "GOSS"),
    "dart": ({"boosting": "dart", "drop_rate": 0.5, "skip_drop": 0.0},
             "DART"),
    "dart_xgboost": ({"boosting": "dart", "drop_rate": 0.5,
                      "skip_drop": 0.0, "xgboost_dart_mode": True}, "DART"),
    "dart_uniform": ({"boosting": "dart", "drop_rate": 0.5,
                      "skip_drop": 0.0, "uniform_drop": True,
                      "max_drop": 2}, "DART"),
    "rf": ({"boosting": "rf", "bagging_fraction": 0.632, "bagging_freq": 1,
            "feature_fraction": 0.8}, "RF"),
}


def _binary_fobj(preds, data):
    """Binary logloss as a custom objective (float64 numpy)."""
    y = np.asarray(data.get_label(), np.float64)
    p = 1.0 / (1.0 + np.exp(-np.asarray(preds, np.float64)))
    return p - y, p * (1.0 - p)


def assert_modes_equal(params, rounds=5, data=None, fobj=None):
    """Train ``params`` in both packages with a validation set: the same
    trees, split gains, leaf values, training and validation scores and
    predictions bit for bit; the metric histories within 1e-6."""
    if data is None:
        (X, y), (Xv, yv) = _data(), _data(seed=1, n=600)
    else:
        (X, y), (Xv, yv) = data, (data[0][:300], data[1][:300])
    out = {}
    for name, lib in (("jax", jlgb), ("torch", tlgb)):
        p = dict(params)
        if name == "jax":
            p.pop("device_type", None)
        ds = lib.Dataset(X, label=y)
        vs = lib.Dataset(Xv, label=yv, reference=ds)
        ev = {}
        b = lib.train(p, ds, num_boost_round=rounds, valid_sets=[vs],
                      valid_names=["valid"], evals_result=ev, fobj=fobj,
                      verbose_eval=False)
        out[name] = (b, ev)
    (jb, jev), (tb, tev) = out["jax"], out["torch"]
    jt, tt = _jax_trees(jb), tb._gbdt.models
    assert len(jt) == len(tt) > 0
    for i, (a, b) in enumerate(zip(jt, tt)):
        k = a.num_leaves
        assert k == b.num_leaves, (i, k, b.num_leaves)
        for f in ("split_feature", "threshold", "decision_type",
                  "left_child", "right_child", "internal_count"):
            np.testing.assert_array_equal(getattr(a, f)[:k - 1],
                                          getattr(b, f)[:k - 1],
                                          err_msg=f"tree {i} {f}")
        for f, m in (("split_gain", k - 1), ("leaf_value", k),
                     ("leaf_count", k)):
            np.testing.assert_array_equal(getattr(a, f)[:m],
                                          getattr(b, f)[:m],
                                          err_msg=f"tree {i} {f}")
    np.testing.assert_array_equal(
        tb._gbdt.get_training_score().numpy(),
        np.asarray(jb._gbdt.get_training_score()))
    np.testing.assert_array_equal(tb._gbdt.valid_score[0].score.numpy(),
                                  np.asarray(jb._gbdt.valid_score[0].score))
    for x in (X, Xv):
        np.testing.assert_array_equal(tb.predict(x, raw_score=True),
                                      jb.predict(x, raw_score=True))
        np.testing.assert_array_equal(tb.predict(x), jb.predict(x))
    for m, vals in jev["valid"].items():
        np.testing.assert_allclose(tev["valid"][m], vals, rtol=0, atol=1e-6)
    return jb, tb


@pytest.mark.parametrize("learner", ["fused", "host_loop"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_boosting_mode_bit_equal(mode, learner):
    """Each mode on each learner: the fused learner runs the per-tree
    path (bag-ordered states under row sampling), never the persistent
    one."""
    extra, kind = MODES[mode]
    params = {**PARAMS, **extra, "tpu_fused": learner == "fused"}
    _, tb = assert_modes_equal(params)
    gb = tb._gbdt
    assert type(gb).__name__ == kind
    assert not gb._fused_persist
    assert (gb._fused is not None) == (learner == "fused")
    if learner == "fused" and mode.startswith("dart"):
        assert gb._fused._score_from_partition
    elif learner == "fused":
        assert not gb._fused._score_from_partition
    if kind == "RF":
        assert gb.average_output and gb.shrinkage_rate == 1.0


@pytest.mark.parametrize("extra", [
    {}, {"max_delta_step": 0.3}, {"path_smooth": 2.0},
    {"monotone_constraints": [1, -1, 0, 0, 0, 0]}, {"lambda_l2": 1.0},
], ids=["l1", "clamp", "smoothing", "monotone", "l2"])
def test_bagging_at_15_bins_under_l1(extra):
    """The per-tree program's split scans at 15 bins under L1 (the
    multiply-add sites of ops/split.py scan_sites, ROADMAP §C C9) on
    bag-ordered states."""
    params = {**PARAMS, **BAG, "min_data_in_leaf": 5, "lambda_l1": 0.5,
              "max_bin": 15, **extra}
    _, tb = assert_modes_equal(params, rounds=3)
    assert tb._gbdt._fused is not None


@pytest.mark.parametrize("extra", [
    {"use_quantized_grad": True},
    {"objective": "regression_l1", "metric": "l1"},
], ids=["quantized", "regression_l1"])
def test_bagging_on_the_host_loop(extra):
    """Quantized gradients (the full [N] arrays quantized with the
    per-tree key) and the L1 percentile refit (over the bag's rows
    only) take the host loop under bagging, in both packages."""
    params = {**PARAMS, **BAG, **extra}
    jb, tb = assert_modes_equal(params)
    assert tb._gbdt._fused is None and jb._gbdt._fused is None


@pytest.mark.parametrize("learner", ["fused", "host_loop"])
def test_multiclass_bagging(learner):
    X, y = _data()
    y = y + (X[:, 0] > 1.0)
    params = {**PARAMS, **BAG, "objective": "multiclass", "num_class": 3,
              "metric": "multi_logloss", "tpu_fused": learner == "fused"}
    _, tb = assert_modes_equal(params, rounds=3, data=(X, y))
    assert tb._gbdt.num_tree_per_iteration == 3


@pytest.mark.parametrize("learner", ["fused", "host_loop"])
def test_goss_with_custom_objective(learner):
    """GOSS samples the custom objective's gradients (learning_rate 0.5:
    from the third iteration)."""
    params = {**PARAMS, "boosting": "goss", "learning_rate": 0.5,
              "tpu_fused": learner == "fused"}
    _, tb = assert_modes_equal(params, fobj=_binary_fobj)
    assert tb._gbdt.objective is None


def test_wide_sparse_bagging_multival_forced(monkeypatch):
    """Bagging on CSR wide-sparse data with the multi-value layout forced
    in both packages: the fused learner gathers the slot planes by the
    permutation once per tree (B5 over bag-gathered slot planes on the
    card)."""
    X, y = make_wide_sparse(n=400)
    Xs = sp.csr_matrix(X)
    force_multival(monkeypatch)
    params = {**PARAMS, **BAG, "min_data_in_leaf": 5}
    _, tb = assert_modes_equal(params, data=(Xs, np.asarray(y)))
    fl = tb._gbdt._fused
    assert fl is not None and fl.layout.mv_planes > 0
    assert not fl._score_from_partition


# ---------------------------------------------------------------------------
# GOSS sampling
# ---------------------------------------------------------------------------

def _tie_vector(seed, n):
    """Non-negative float32 values with heavy ties: a few distinct
    levels, zeros and repeats, as |g·h| of a few leaves."""
    rng = np.random.RandomState(seed)
    levels = rng.rand(1 + seed % 7).astype(np.float32)
    w = levels[rng.randint(0, len(levels), n)]
    w[rng.rand(n) < 0.1] = 0.0
    return w


@pytest.mark.parametrize("seed,n,k", [(0, 1000, 200), (3, 1000, 1),
                                      (5, 4097, 2000), (6, 257, 256)])
def test_goss_selection_matches_top_k(seed, n, k):
    """The port's selection (a stable descending sort) picks the rows
    ``jax.lax.top_k`` picks on the CPU, equal values by lower index."""
    w = _tie_vector(seed, n)
    _, want = jax.lax.top_k(jnp.asarray(w), k)
    got = torch.sort(torch.as_tensor(w), descending=True, stable=True)[1][:k]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("classes,seed", [(1, 0), (1, 9), (3, 4)])
def test_goss_sample_matches_jax(classes, seed):
    """One GOSS round on tie-heavy gradients: the same scaled gradients
    and hessians and the same [bag | oob] permutation, bit for bit."""
    n = 3000
    rng = np.random.RandomState(seed)
    g = np.stack([_tie_vector(seed + c, n) - 0.5 for c in range(classes)])
    h = np.stack([_tie_vector(seed + 11 + c, n) for c in range(classes)])
    top_k, other_k = int(n * 0.2), int(n * 0.1)
    gs = int(rng.randint(1 << 31))
    jg, jh, jp = jax.jit(_goss_sample_device,
                         static_argnames=("top_k", "other_k"))(
        jnp.asarray(g), jnp.asarray(h), jnp.int32(gs), top_k=top_k,
        other_k=other_k)
    tg, th, tp = goss_sample(torch.as_tensor(g), torch.as_tensor(h), gs,
                             top_k, other_k)
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    # the bag holds top_k + other_k rows, each side in row order
    bag = tp[:top_k + other_k].numpy()
    assert (np.diff(bag) > 0).all() and (np.diff(tp[top_k + other_k:]
                                                 .numpy()) > 0).all()


# ---------------------------------------------------------------------------
# the bag branch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["dense", "categorical"])
def test_bag_traversal_matches_partition(kind):
    """On the bag branch every row's leaf comes from traversal of the
    new tree; on the bag's rows it equals the leaf the partition gave
    their lanes."""
    from lightgbm_tpu_torch.basic import Dataset
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.objective.functions import create_objective
    from lightgbm_tpu_torch.treelearner.fused import FusedSerialGrower
    if kind == "dense":
        X, y = _data()
        kw = {}
    else:
        X, y = make_cat_data()
        kw = {"categorical_feature": [4, 5]}
    cfg = Config.from_params({**PARAMS, **BAG})
    ds = Dataset(X, label=y, params={**PARAMS, **BAG}, **kw).construct()
    obj = create_objective(cfg)
    obj.init(ds._handle.metadata, ds._handle.num_data)
    fl = FusedSerialGrower(ds._handle, cfg, obj, "cpu")
    assert not fl._score_from_partition
    n = ds._handle.num_data
    rng = np.random.RandomState(2)
    g = torch.as_tensor(rng.randn(n).astype(np.float32))
    h = torch.as_tensor(rng.rand(n).astype(np.float32) + 0.1)
    bag = np.sort(rng.choice(n, int(n * 0.7), replace=False))
    perm = torch.as_tensor(np.concatenate(
        [bag, np.setdiff1d(np.arange(n), bag)]))
    data = fl.bag_state(g, h, perm)
    ta_dev, win = fl._grow_tree(data, len(bag),
                                fl.feature_masks_for_tree())
    ta = fl.read_trees([ta_dev])[0]
    assert ta["n_leaves"] > 2
    lanes = fl._lane_leaf(win, len(bag))
    rowids = data[fl.layout.rowid, :len(bag)].long()
    trav = fl.materialize_tree(ta).leaf_index_binned(
        fl.bins_device(), fl.feature_miss_bin, fl._efb_dev)
    np.testing.assert_array_equal(trav[rowids].numpy(), lanes.numpy())
    # the device traversal of the tree's device arrays, every row
    np.testing.assert_array_equal(
        fl.traverse_bins(ta_dev, fl.bins_device()).numpy(), trav.numpy())
    # the bag's rows keep their lanes' row ids; every leaf has rows
    assert sorted(rowids.tolist()) == bag.tolist()
    assert int(win[1].sum()) == len(bag)


def test_bagging_stop_rule_matches_jax_trim():
    """Under bagging an iteration of single leaves may be followed by
    one whose bag splits again. As in the JAX package, the per-tree
    fused path keeps training through it and trims only the trailing
    single-leaf iterations at the end: the same model, a single-leaf
    tree inside it included."""
    params = {**PARAMS, **BAG, "learning_rate": 0.5,
              "min_gain_to_split": 25.0}
    X, y = _data()
    jb = jlgb.train(dict(params), jlgb.Dataset(X, label=y),
                    num_boost_round=12)
    tb = tlgb.train(params, tlgb.Dataset(X, label=y), num_boost_round=12,
                    verbose_eval=False)
    jt, tt = _jax_trees(jb), tb._gbdt.models
    assert 1 < len(tt) < 12 and len(jt) == len(tt)
    leaves = [t.num_leaves for t in tt]
    assert leaves[-1] > 1 and 1 in leaves
    assert leaves == [t.num_leaves for t in jt]
    for a, b in zip(jt, tt):
        np.testing.assert_array_equal(a.leaf_value[:a.num_leaves],
                                      b.leaf_value[:b.num_leaves])
    np.testing.assert_array_equal(tb.predict(X, raw_score=True),
                                  jb.predict(X, raw_score=True))


# ---------------------------------------------------------------------------
# RF model text
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def rf_models():
    params = {**PARAMS, **MODES["rf"][0]}
    X, y = _data()
    jb = jlgb.train(dict(params), jlgb.Dataset(X, label=y),
                    num_boost_round=4)
    tb = tlgb.train(params, tlgb.Dataset(X, label=y), num_boost_round=4,
                    verbose_eval=False)
    return jb, tb, X


def test_rf_model_text_round_trip(rf_models):
    """The port's RF model text carries ``average_output`` and equals
    the JAX package's line by line (but the device parameter); loaded
    back, it predicts the same averaged scores and saves the same
    text."""
    jb, tb, X = rf_models
    ttext, jtext = tb.model_to_string(), jb.model_to_string()
    assert "\naverage_output\n" in ttext
    for a, b in zip(jtext.splitlines(), ttext.splitlines()):
        if not (a.startswith("[device_type") or a.startswith("tree_sizes")):
            assert a == b
    loaded = tlgb.Booster(params={"device_type": "cpu"}, model_str=ttext)
    assert loaded._gbdt.average_output
    assert loaded.model_to_string().split("parameters:")[0] == \
        ttext.split("parameters:")[0]
    for raw in (True, False):
        np.testing.assert_array_equal(loaded.predict(X, raw_score=raw),
                                      tb.predict(X, raw_score=raw))


def test_jax_rf_model_loads(rf_models):
    """A JAX RF booster carries across as model text and as tree arrays
    (``convert.py``), and predicts its averaged scores bit for bit, over
    all its iterations and over the first two."""
    jb, _, X = rf_models
    text = jb.model_to_string()
    loaded = tlgb.Booster(params={"device_type": "cpu"}, model_str=text)
    assert loaded.model_to_string() == \
        jlgb.Booster(model_str=text).model_to_string()
    trees = [{f: getattr(t, f)[:t.num_leaves if f.startswith("leaf_")
                                else t.num_leaves - 1]
              for f in TREE_FIELDS} | {"num_leaves": t.num_leaves}
             for t in _jax_trees(jb)]
    arrays = booster_from_jax_arrays(trees, max_feature_idx=5,
                                     average_output=True,
                                     params={"device_type": "cpu"})
    for b in (loaded, arrays):
        for raw in (True, False):
            np.testing.assert_array_equal(b.predict(X, raw_score=raw),
                                          jb.predict(X, raw_score=raw))
    np.testing.assert_array_equal(
        loaded.predict(X, num_iteration=2, raw_score=True),
        jb.predict(X, num_iteration=2, raw_score=True))
