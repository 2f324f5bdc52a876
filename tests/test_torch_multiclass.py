"""Multiclass, one-vs-all and cross_entropy_lambda in the port against
the JAX package, on seeded numpy data:

- the objectives' gradients (``get_gradients`` over [K, N] scores) and
  transforms (softmax over the classes, the OVA sigmoids,
  log1p(exp(raw))) against the jitted JAX functions, bit for bit, on
  random scores with extremes;
- training on both learners: the port's per-tree fused path
  (``grow_device``, one fresh planar state per class tree) against the
  JAX fused learner's, its host loop against the JAX host loop; trees,
  split gains, leaf values, raw and transformed predictions bit for
  bit; with weights, quantized gradients (host loop), categorical
  columns and the multi-value layout forced (fused);
- the multiclass metrics and ``cross_entropy_lambda``'s, with early
  stopping and ``feval``: the JAX package's values (it computes them on
  the host; held within 1e-9 relative);
- models carried across as text and as arrays, ``pred_leaf`` and
  prediction early stop on top1 - top2 with K classes.
"""
import types

import numpy as np
import pytest
import scipy.sparse as sp

import jax
import jax.numpy as jnp
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.objective.functions import create_objective as jax_objective
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.convert import booster_from_jax_arrays
from lightgbm_tpu_torch.objective.functions import \
    create_objective as port_objective

from test_multival import make_wide_sparse
from test_torch_categorical import make_cat_data
from test_torch_multival import force_multival
from test_torch_objectives import reg_data
from test_torch_train import TREE_FIELDS


@pytest.fixture(autouse=True, scope="module")
def _no_aot_store():
    """Keep the JAX package's on-disk AOT executable store out of these
    tests, as tests/test_torch_train.py does; torch on two threads
    (restored after), so the parallel workers do not oversubscribe."""
    from lightgbm_tpu.compile.manager import get_manager
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LGBM_TPU_AOT", "0")
        mp.setattr(get_manager(), "aot_enabled", False)
        yield
    torch.set_num_threads(threads)


def mc_data(seed=0, n=2000, k=3):
    """6 columns (NaNs in column 2, zeros in column 5), a label of k
    classes (the quantiles of a noisy score) and row weights in
    [0.5, 1.5)."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 6)
    X[rng.rand(n) < 0.05, 2] = np.nan
    X[:, 5] = np.where(rng.rand(n) < 0.4, 0.0, X[:, 5])
    f = (X[:, 0] + 0.5 * X[:, 1] - 0.3 * np.nan_to_num(X[:, 2]) * X[:, 3]
         + rng.randn(n) * 0.5)
    y = np.digitize(f, np.quantile(f, np.linspace(0, 1, k + 1)[1:-1]))
    return X, y.astype(np.float64), rng.rand(n) + 0.5


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def _assert_bits(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    nan = np.isnan(got) & np.isnan(want)
    np.testing.assert_array_equal(np.where(nan, 0, _bits(got)),
                                  np.where(nan, 0, _bits(want)))


def _scores(shape, seed=3, scale=4.0):
    """Random float32 scores with zeros, signed zeros and values at the
    ends of exp's range in the first rows."""
    rng = np.random.RandomState(seed)
    s = (rng.randn(*shape) * scale).astype(np.float32)
    ext = np.array([0.0, -0.0, 1e-3, -1e-3, 60.0, -60.0, 88.0, -95.0,
                    40.0, -104.0], np.float32)
    s.reshape(-1)[:len(ext)] = ext
    return s


def _objectives(params, y, w):
    md = types.SimpleNamespace(label=y.astype(np.float32),
                               weights=None if w is None
                               else w.astype(np.float32))
    jo = jax_objective(JConfig.from_params({**params, "verbose": -1}))
    to = port_objective(TConfig.from_params({**params, "verbose": -1,
                                             "device_type": "cpu"}))
    jo.init(md, len(y))
    to.init(md, len(y))
    return jo, to


# ---------------------------------------------------------------------------
# gradients and transforms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("weighted", [False, True],
                         ids=["unweighted", "weighted"])
@pytest.mark.parametrize("objective,k", [("multiclass", 3),
                                         ("multiclass", 5),
                                         ("multiclass", 10),
                                         ("multiclassova", 3)])
def test_multiclass_gradients_bit_equal(objective, k, weighted):
    """get_gradients over [K, N] scores against the jitted JAX
    get_gradients; boost_from_score per class equal; the transform over
    [N, K] against the JAX package's jitted convert_output (its predict)
    and its eager one (its metrics and feval)."""
    n = 4000
    _, y, w = mc_data(seed=k, n=n, k=k)
    jo, to = _objectives({"objective": objective, "num_class": k}, y,
                         w if weighted else None)
    s = _scores((k, n))
    for want, got in zip(jo.get_gradients(jnp.asarray(s)),
                         to.get_gradients(torch.as_tensor(s))):
        assert got.shape == (k, n)
        _assert_bits(got.numpy(), want)
    for c in range(k):
        assert to.boost_from_score(c) == jo.boost_from_score(c)
    raw = np.ascontiguousarray(s.T)
    got = to.convert_output(torch.as_tensor(raw)).numpy()
    _assert_bits(got, jax.jit(jo.convert_output)(jnp.asarray(raw)))
    _assert_bits(got, jo.convert_output(jnp.asarray(raw)))
    assert to.to_string() == jo.to_string()


@pytest.mark.parametrize("weighted", [False, True],
                         ids=["unweighted", "weighted"])
def test_cross_entropy_lambda_gradients_bit_equal(weighted):
    """cross_entropy_lambda's gradients (the weighted form: exp, log1p,
    true divisions, one multiply-add) against the jitted JAX
    get_gradients; boost_from_score; log1p(exp(raw)) against the JAX
    transform, jitted and eager."""
    _, y, w = reg_data("cross_entropy", n=6000)
    y[:50], y[50:100] = 0.0, 1.0
    jo, to = _objectives({"objective": "cross_entropy_lambda"}, y,
                         2.0 * w if weighted else None)
    s = _scores((len(y),), scale=3.0)
    for want, got in zip(jo.get_gradients(jnp.asarray(s)),
                         to.get_gradients(torch.as_tensor(s))):
        _assert_bits(got.numpy(), want)
    assert to.boost_from_score(0) == jo.boost_from_score(0)
    got = to.convert_output(torch.as_tensor(s)).numpy()
    _assert_bits(got, jax.jit(jo.convert_output)(jnp.asarray(s)))
    _assert_bits(got, jo.convert_output(jnp.asarray(s)))


def test_create_objective_for_custom_and_ranking():
    """``objective=none`` (a custom objective) has no objective
    function; the ranking names and their aliases give the ranking
    objectives, as in the JAX package."""
    for name in ("none", "custom", "null"):
        assert port_objective(TConfig.from_params(
            {"objective": name, "device_type": "cpu"})) is None
    for name, want in (("lambdarank", "lambdarank"),
                       ("rank_xendcg", "rank_xendcg"),
                       ("xendcg", "rank_xendcg")):
        obj = port_objective(TConfig.from_params({"objective": name,
                                                  "device_type": "cpu"}))
        jobj = jax_objective(JConfig.from_params({"objective": name}))
        assert obj.name == jobj.name == want
        assert obj.need_group and jobj.need_group
        assert obj.persistent_aux() is None


# ---------------------------------------------------------------------------
# training gates
# ---------------------------------------------------------------------------

PARAMS = {"num_leaves": 15, "min_data_in_leaf": 5, "verbose": -1}


def assert_trees_bit_equal(jb, tb, rounds, k=1):
    """The same trees (every field), split gains and leaf values, bit
    for bit."""
    jt, tt = jb._gbdt._used_models(0, -1), tb._gbdt.models
    assert len(jt) == len(tt) == rounds * k
    for i, (a, b) in enumerate(zip(jt, tt)):
        n = a.num_leaves
        assert n == b.num_leaves and n > 2, (i, n, b.num_leaves)
        for f in TREE_FIELDS:
            m = n if f.startswith("leaf_") else n - 1
            np.testing.assert_array_equal(getattr(b, f)[:m],
                                          getattr(a, f)[:m],
                                          err_msg=f"tree {i} {f}")
    if any(t.num_cat for t in jt):
        for a, b in zip(jt, tt):
            assert a.cat_threshold == b.cat_threshold


def train_both(params, X, y, w=None, rounds=4, fused=True, Xp=None,
               jax_X=None, on_fused=None, **kw):
    """Train the JAX package and the port on the same data (``fused``:
    tpu_fused; ``on_fused``: whether both land on the fused learner,
    ``fused`` by default); hold trees, raw and transformed predictions
    bit for bit; return both boosters."""
    params = {**PARAMS, **params, "tpu_fused": fused}
    fused = fused if on_fused is None else on_fused
    jb = jlgb.train(dict(params), jlgb.Dataset(X if jax_X is None
                                               else jax_X, label=y,
                                               weight=w),
                    num_boost_round=rounds, **kw)
    tb = tlgb.train({**params, "device_type": "cpu"},
                    tlgb.Dataset(X, label=y, weight=w),
                    num_boost_round=rounds, verbose_eval=False, **kw)
    assert (jb._gbdt._fused is not None) == fused
    assert (tb._gbdt._fused is not None) == fused
    k = tb._gbdt.num_tree_per_iteration
    assert_trees_bit_equal(jb, tb, rounds, k)
    Xp = X if Xp is None else Xp
    Xj = Xp if jax_X is None else jax_X
    for raw in (True, False):
        got = tb.predict(Xp, raw_score=raw)
        want = jb.predict(Xj, raw_score=raw)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    return jb, tb


MC_GATES = {
    "multiclass": ({"objective": "multiclass", "num_class": 3}, False),
    "multiclass_weighted": ({"objective": "multiclass", "num_class": 3},
                            True),
    "multiclassova": ({"objective": "multiclassova", "num_class": 3},
                      False),
}


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "host_loop"])
@pytest.mark.parametrize("case", sorted(MC_GATES))
def test_multiclass_training_bit_equal(case, fused):
    """3 classes, 15 leaves, 4 iterations (12 trees): the port's
    per-tree fused path against the JAX fused learner's, its host loop
    against the JAX host loop."""
    params, weighted = MC_GATES[case]
    X, y, w = mc_data()
    _, tb = train_both(params, X, y, w if weighted else None, fused=fused)
    gb = tb._gbdt
    assert gb.num_tree_per_iteration == 3
    assert gb.train_score.score.shape == (3, len(y))
    if fused:
        # the per-tree path: no persistent state, a fresh one per tree
        assert not gb._fused_persist and gb._fused_state is None
        assert not gb._fused.persistent_capable
    assert tb.predict(X).shape == (len(y), 3)
    assert [m.name for m in gb.metrics] == ["multi_logloss"]


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "host_loop"])
@pytest.mark.parametrize("weighted", [False, True],
                         ids=["unweighted", "weighted"])
def test_cross_entropy_lambda_training_bit_equal(weighted, fused):
    """cross_entropy_lambda on both learners (its gradients come from
    outside the fused learner's program: the per-tree path)."""
    X, y, w = reg_data("cross_entropy")
    _, tb = train_both({"objective": "cross_entropy_lambda"}, X, y,
                       2.0 * w if weighted else None, fused=fused)
    if fused:
        assert not tb._gbdt._fused_persist
    assert [m.name for m in tb._gbdt.metrics] == ["cross_entropy_lambda"]


def test_quantized_multiclass_host_loop_bit_equal():
    """use_quantized_grad with K trees per iteration: the JAX rule sends
    it to the host loop (quantized gradients outside the persistent
    path); one quantization key per class tree."""
    X, y, _ = mc_data()
    _, tb = train_both({"objective": "multiclass", "num_class": 3,
                        "use_quantized_grad": True}, X, y, fused=True,
                       rounds=3, on_fused=False)
    assert tb._gbdt._fused is None and tb._gbdt.tree_learner._quant


def test_quantized_multiclass_falls_back_to_host_loop():
    """The booster still asked for the fused learner: the quantized
    multiclass config lands on the host loop, as in the JAX package."""
    from lightgbm_tpu_torch.treelearner.fused import fused_reject_reason
    X, y, _ = mc_data(n=300)
    cfg = TConfig.from_params({"objective": "multiclass", "num_class": 3,
                               "use_quantized_grad": True,
                               "device_type": "cpu"})
    ds = tlgb.Dataset(X, label=y, params={"device_type": "cpu"}).construct()
    obj = port_objective(cfg)
    obj.init(ds.handle.metadata, ds.handle.num_data)
    assert "use_quantized_grad" in fused_reject_reason(cfg, ds.handle, obj)


def test_categorical_multiclass_fused_bit_equal():
    """Categorical columns through the per-tree fused path (the
    categorical scan, B2's bitset route on a fresh state per tree)."""
    X, yb = make_cat_data()
    y = (yb + (X[:, 0] > 0.8)).astype(np.float64)
    _, tb = train_both({"objective": "multiclass", "num_class": 3,
                        "categorical_feature": [4, 5]}, X, y, fused=True,
                       rounds=3)
    assert tb._gbdt._fused.any_categorical
    assert any(t.num_cat for t in tb._gbdt.models)


def test_wide_sparse_multiclass_multival_forced(monkeypatch):
    """The multi-value layout forced in both packages: the per-tree
    fused path builds the slot planes into every fresh state (B5's
    plain version); CSR input on both sides."""
    X, yb = make_wide_sparse(n=400)
    y = (yb + X[:, 2]).astype(np.float64)
    force_multival(monkeypatch)
    Xs = sp.csr_matrix(X)
    _, tb = train_both({"objective": "multiclass", "num_class": 3}, Xs, y,
                       fused=True, rounds=3, Xp=Xs, jax_X=None)
    assert tb._gbdt._fused.layout.mv_planes > 0


def test_grow_device_leaf_of_row_matches_traversal():
    """grow_device's leaf_of_row (the lanes' leaves scattered back
    through the row-id plane) equals each row's leaf by traversal of
    the finished tree, and its tree equals the JAX grow_device's."""
    from lightgbm_tpu.io.dataset import BinnedDataset as JDataset
    from lightgbm_tpu.treelearner.fused import FusedSerialGrower as JFused
    from lightgbm_tpu_torch.io.dataset import BinnedDataset as TDataset
    from lightgbm_tpu_torch.treelearner.fused import FusedSerialGrower
    X, y, _ = mc_data(n=1500)
    params = {**PARAMS, "objective": "multiclass", "num_class": 3}
    jcfg = JConfig.from_params(params)
    tcfg = TConfig.from_params({**params, "device_type": "cpu"})
    jds = JDataset.from_matrix(X, jcfg, label=y)
    tds = TDataset.from_matrix(X, tcfg, label=y)
    jfl, fl = JFused(jds, jcfg), FusedSerialGrower(tds, tcfg, None, "cpu")
    rng = np.random.RandomState(0)
    g = rng.randn(len(y)).astype(np.float32)
    h = (rng.rand(len(y)) + 0.1).astype(np.float32)
    ta, leaf = fl.grow_device(torch.as_tensor(g), torch.as_tensor(h))
    jta, jleaf = jfl.grow_device(jnp.asarray(g), jnp.asarray(h),
                                 jnp.arange(len(y)), len(y))
    np.testing.assert_array_equal(leaf.numpy(), np.asarray(jleaf))
    # the device tree arrays: one read brings them back
    tree = fl.materialize_tree(fl.read_trees([ta])[0])
    trav = tree.leaf_index_binned(torch.as_tensor(tds.bins.astype(np.int32)),
                                  fl.feature_miss_bin, fl._efb_dev)
    np.testing.assert_array_equal(leaf.numpy(), trav.numpy())
    jtree = jfl.materialize_tree(jax.device_get(jta))
    for f in TREE_FIELDS:
        m = tree.num_leaves if f.startswith("leaf_") else tree.num_leaves - 1
        np.testing.assert_array_equal(getattr(tree, f)[:m],
                                      getattr(jtree, f)[:m], err_msg=f)


def _l2_fobj(preds, data):
    return preds - data.get_label(), np.ones_like(preds)


STOP_CASES = {
    # no split ever: the first iteration's K constant trees stay
    "first_iteration_degenerate": ({"objective": "multiclass",
                                    "num_class": 3,
                                    "min_gain_to_split": 1e9}, "class",
                                   None),
    # a custom objective fits the label in one tree, then no split
    "fobj_fit_then_stop": ({"learning_rate": 1.0}, "reg", _l2_fobj),
    # softmax over a label one column decides: the hessian floor stops it
    "multiclass_fit_then_stop": ({"objective": "multiclass", "num_class": 3,
                                  "learning_rate": 1.0,
                                  "min_sum_hessian_in_leaf": 5.0}, "class",
                                 None),
}


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "host_loop"])
@pytest.mark.parametrize("case", sorted(STOP_CASES))
def test_no_more_splits_stop_matches_jax(case, fused):
    """An iteration whose trees are all single leaves ends training with
    the JAX package's model: the host loops stop at once, the fused
    learners (the port's per-tree path as the JAX package's) train on
    and trim their trailing degenerate iterations at the end of
    train(); the model text (but for the device line), the iteration
    count and the predictions are equal."""
    params, label, fobj = STOP_CASES[case]
    rng = np.random.RandomState(0)
    X = rng.randint(0, 3, (600, 3)).astype(np.float64)
    y = X[:, 0].copy() if label == "class" else 2.0 * (X[:, 1] > 0)
    p = {**params, "num_leaves": 4, "min_data_in_leaf": 5, "verbose": -1,
         "tpu_fused": fused}
    kw = {} if fobj is None else {"fobj": fobj}
    jb = jlgb.train(dict(p), jlgb.Dataset(X, label=y), num_boost_round=8,
                    **kw)
    tb = tlgb.train({**p, "device_type": "cpu"}, tlgb.Dataset(X, label=y),
                    num_boost_round=8, verbose_eval=False, **kw)
    assert len(tb._gbdt.models) < 8 * tb._gbdt.num_tree_per_iteration
    assert tb._gbdt.iter == jb._gbdt.iter

    def text(b):
        return [ln for ln in b.model_to_string().splitlines()
                if not ln.startswith("[device_type")]
    assert text(tb) == text(jb)
    np.testing.assert_array_equal(tb.predict(X), jb.predict(X))


# ---------------------------------------------------------------------------
# metrics, feval, early stopping
# ---------------------------------------------------------------------------

def _evals(lib, params, X, y, Xv, yv, rounds, **kw):
    ds = lib.Dataset(X, label=y)
    vs = lib.Dataset(Xv, label=yv, reference=ds)
    ev = {}
    p = dict(params)
    if lib is tlgb:
        p["device_type"] = "cpu"
    b = lib.train(p, ds, num_boost_round=rounds, valid_sets=[ds, vs],
                  valid_names=["train", "valid"], evals_result=ev,
                  verbose_eval=False, **kw)
    return b, ev


@pytest.mark.parametrize("objective", ["multiclass", "multiclassova"])
def test_multiclass_metrics_match_jax(objective):
    """multi_logloss, multi_error (top-2) and auc_mu on the training and
    validation sets, every iteration: the JAX package's values."""
    X, y, _ = mc_data()
    Xv, yv, _ = mc_data(seed=1, n=600)
    params = {**PARAMS, "objective": objective, "num_class": 3,
              "metric": ["multi_logloss", "multi_error", "auc_mu"],
              "multi_error_top_k": 2}
    _, jev = _evals(jlgb, params, X, y, Xv, yv, 3)
    _, tev = _evals(tlgb, params, X, y, Xv, yv, 3)
    for ds in ("train", "valid"):
        assert sorted(tev[ds]) == sorted(jev[ds]) == \
            ["auc_mu", "multi_error", "multi_logloss"]
        for name in jev[ds]:
            assert len(tev[ds][name]) == 3
            np.testing.assert_allclose(tev[ds][name], jev[ds][name],
                                       rtol=1e-9, err_msg=f"{ds} {name}")


def test_cross_entropy_lambda_metric_matches_jax():
    """The cross_entropy_lambda metric (weighted data), every iteration,
    within 1e-9 of the JAX package's host value."""
    X, y, w = reg_data("cross_entropy")
    Xv, yv, wv = reg_data("cross_entropy", seed=1, n=500)
    out = {}
    for lib in (jlgb, tlgb):
        p = {**PARAMS, "objective": "cross_entropy_lambda"}
        if lib is tlgb:
            p["device_type"] = "cpu"
        ds = lib.Dataset(X, label=y, weight=w)
        vs = lib.Dataset(Xv, label=yv, weight=wv, reference=ds)
        ev = {}
        lib.train(p, ds, num_boost_round=3, valid_sets=[vs],
                  valid_names=["valid"], evals_result=ev, verbose_eval=False)
        out[lib] = ev["valid"]["cross_entropy_lambda"]
    assert len(out[tlgb]) == 3
    np.testing.assert_allclose(out[tlgb], out[jlgb], rtol=1e-9)


def test_feval_and_early_stopping_on_multi_logloss():
    """feval's results are appended to each dataset's evaluation list,
    and early stopping on multi_logloss picks the JAX package's best
    iteration; the saved models (truncated to it) are equal but for the
    device line."""
    X, y, _ = mc_data(n=1500)
    Xv, yv, _ = mc_data(seed=7, n=400)
    params = {**PARAMS, "objective": "multiclass", "num_class": 3,
              "learning_rate": 0.5, "num_leaves": 31, "min_data_in_leaf": 2,
              "first_metric_only": True}
    seen = {}
    out = {}
    for lib in (jlgb, tlgb):
        calls = []

        def feval(preds, data, calls=calls):
            calls.append((preds.shape, preds.dtype, data is None))
            return [("mean_max_prob", float(np.mean(preds.max(axis=1))),
                     True)]
        b, ev = _evals(lib, params, X, y, Xv, yv, 40, feval=feval,
                       early_stopping_rounds=3)
        out[lib] = (b, ev)
        seen[lib] = calls
    (jb, jev), (tb, tev) = out[jlgb], out[tlgb]
    assert tb.best_iteration == jb.best_iteration < 40
    assert seen[tlgb][:4] == seen[jlgb][:4]
    for ds in ("train", "valid"):
        assert sorted(tev[ds]) == sorted(jev[ds]) == \
            ["mean_max_prob", "multi_logloss"]
        n = len(tev[ds]["multi_logloss"])
        for name in tev[ds]:
            np.testing.assert_allclose(tev[ds][name], jev[ds][name][:n],
                                       rtol=1e-9, err_msg=f"{ds} {name}")
    strip = [ln for ln in tb.model_to_string().splitlines()
             if not ln.startswith("[device_type")]
    assert strip == [ln for ln in jb.model_to_string().splitlines()
                     if not ln.startswith("[device_type")]


# ---------------------------------------------------------------------------
# models carried across and prediction
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_models():
    """JAX boosters of the three objectives, 3 iterations each."""
    X, y, w = mc_data()
    out = {}
    for name, params in (("multiclass", {"objective": "multiclass",
                                         "num_class": 3}),
                         ("multiclassova", {"objective": "multiclassova",
                                            "num_class": 3}),
                         ("cross_entropy_lambda",
                          {"objective": "cross_entropy_lambda"})):
        yy = y if "num_class" in params else (y > 0).astype(np.float64)
        out[name] = jlgb.train({**PARAMS, **params},
                               jlgb.Dataset(X, label=yy, weight=w),
                               num_boost_round=3)
    return out, X


@pytest.mark.parametrize("name", ["multiclass", "multiclassova",
                                  "cross_entropy_lambda"])
def test_jax_model_text_and_arrays_predict_bit_equal(jax_models, name):
    """The JAX package's model text loads in the port and predicts its
    raw scores, probabilities and leaf indices bit for bit; the text
    written back is the JAX package's; ``booster_from_jax_arrays`` with
    K classes predicts the same."""
    boosters, X = jax_models
    jb = boosters[name]
    text = jb.model_to_string()
    tb = tlgb.Booster(params={"device_type": "cpu"}, model_str=text)
    assert tb.model_to_string() == text
    for raw in (True, False):
        np.testing.assert_array_equal(tb.predict(X, raw_score=raw),
                                      jb.predict(X, raw_score=raw))
    np.testing.assert_array_equal(tb.predict(X, pred_leaf=True),
                                  jb.predict(X, pred_leaf=True))
    k = jb._gbdt.num_tree_per_iteration
    trees = [{f: getattr(t, f)[:t.num_leaves if f.startswith("leaf_")
                                else t.num_leaves - 1]
              for f in TREE_FIELDS} | {"num_leaves": t.num_leaves}
             for t in jb._gbdt._used_models(0, -1)]
    objective = [ln for ln in text.splitlines()
                 if ln.startswith("objective=")][0].split("=", 1)[1]
    ab = booster_from_jax_arrays(trees, objective=objective,
                                 num_tree_per_iteration=k,
                                 max_feature_idx=5,
                                 params={"device_type": "cpu"})
    np.testing.assert_array_equal(ab.predict(X), jb.predict(X))


@pytest.mark.parametrize("freq,margin", [(1, 0.5), (2, 2.0)])
def test_multiclass_prediction_early_stop_bit_equal(freq, margin):
    """Prediction early stop with K classes (the margin is top1 - top2
    of the class scores, checked every ``freq`` iterations) against the
    JAX predictor; the option is read from the model's config by both
    packages' predict."""
    X, y, _ = mc_data()
    jb, tb = train_both({"objective": "multiclass", "num_class": 3,
                         "learning_rate": 0.3}, X, y, rounds=6)
    full = tb.predict(X, raw_score=True)
    cfgs = (jb._gbdt.config, tb._gbdt.config)
    for c in cfgs:
        c.pred_early_stop, c.pred_early_stop_freq = True, freq
        c.pred_early_stop_margin = margin
    try:
        got = tb.predict(X, raw_score=True)
        np.testing.assert_array_equal(got, jb.predict(X, raw_score=True))
        np.testing.assert_array_equal(tb.predict(X), jb.predict(X))
    finally:
        for c in cfgs:
            c.pred_early_stop = False
    assert (got != full).any()
