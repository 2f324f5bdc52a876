"""The slice as a whole: the same data and params through
``lightgbm_tpu.train`` (CPU: scatter histograms + partition_ref) and
``lightgbm_tpu_torch.train(device_type="cpu")`` (the plain versions of
the port's kernels). Trees must be structurally equal, leaf values and
predictions within 1e-5, AUC within 1e-6; a model carried across from
the JAX package predicts within 1e-6."""
import ast
import itertools
import os

import numpy as np
import pytest

import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.convert import booster_from_jax_arrays

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _no_aot_store():
    """Keep the JAX package's on-disk AOT executable store out of these
    tests, as tests/test_multival.py does: the live manager snapshots
    the environment at construction, so patch both."""
    from lightgbm_tpu.compile.manager import get_manager
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LGBM_TPU_AOT", "0")
        mp.setattr(get_manager(), "aot_enabled", False)
        yield
PARAMS = {"objective": "binary", "num_leaves": 15, "metric": "auc",
          "verbose": -1, "device_type": "cpu"}
TREE_FIELDS = ("split_feature", "split_gain", "threshold", "decision_type",
               "left_child", "right_child", "leaf_value", "leaf_weight",
               "leaf_count", "internal_value", "internal_weight",
               "internal_count")


def _data(seed=0, n=2000, nan=True):
    """[n, 6] with NaNs in column 2 (``nan``) and zeros in column 5."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 6)
    missing = rng.rand(n) < 0.05
    if nan:
        X[missing, 2] = np.nan
    X[:, 5] = np.where(rng.rand(n) < 0.4, 0.0, X[:, 5])
    y = (X[:, 0] + 0.5 * X[:, 1] - 0.3 * np.nan_to_num(X[:, 2]) * X[:, 3]
         + rng.randn(n) * 0.5 > 0).astype(np.float64)
    return X, y


@pytest.fixture(scope="module")
def trained():
    X, y = _data()
    Xv, yv = _data(seed=1, n=600)
    out = {}
    for name, lib in (("jax", jlgb), ("torch", tlgb)):
        ds = lib.Dataset(X, label=y)
        vs = lib.Dataset(Xv, label=yv, reference=ds)
        ev = {}
        b = lib.train(dict(PARAMS), ds, num_boost_round=3,
                      valid_sets=[ds, vs], valid_names=["train", "valid"],
                      evals_result=ev, verbose_eval=False)
        out[name] = (b, ev, ds)
    return out, X, Xv


def _jax_trees(b):
    return b._gbdt._used_models(0, -1)


def test_trees_structurally_equal(trained):
    out, _, _ = trained
    jt = _jax_trees(out["jax"][0])
    tt = out["torch"][0]._gbdt.models
    assert len(jt) == len(tt) == 3
    for a, b in zip(jt, tt):
        k = a.num_leaves
        assert k == b.num_leaves and k > 2
        for f in ("split_feature", "threshold", "decision_type",
                  "left_child", "right_child", "internal_count"):
            np.testing.assert_array_equal(getattr(a, f)[:k - 1],
                                          getattr(b, f)[:k - 1], err_msg=f)
        np.testing.assert_array_equal(a.leaf_count[:k], b.leaf_count[:k])
        np.testing.assert_allclose(a.leaf_value[:k], b.leaf_value[:k],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(a.split_gain[:k - 1], b.split_gain[:k - 1],
                                   rtol=1e-5)


def test_predictions_and_auc_match(trained):
    out, X, Xv = trained
    jb, jev, _ = out["jax"]
    tb, tev, _ = out["torch"]
    for x in (X, Xv):
        np.testing.assert_allclose(tb.predict(x), jb.predict(x), atol=1e-5)
        np.testing.assert_allclose(tb.predict(x, raw_score=True),
                                   jb.predict(x, raw_score=True), atol=1e-5)
    for ds in ("train", "valid"):
        np.testing.assert_allclose(tev[ds]["auc"], jev[ds]["auc"],
                                   rtol=0, atol=1e-6)
    assert tev["valid"]["auc"][-1] > 0.75


def test_bin_mappers_byte_identical(trained):
    out, _, _ = trained
    jm = out["jax"][2].construct().handle.bin_mappers
    tm = out["torch"][2].construct().handle.bin_mappers
    for a, b in zip(jm, tm):
        da, db = a.to_dict(), b.to_dict()
        np.testing.assert_array_equal(np.asarray(da.pop("bin_upper_bound")),
                                      np.asarray(db.pop("bin_upper_bound")))
        assert da == db


def test_model_text(trained):
    """The port's model text matches the JAX package's line by line
    (values within float noise, parameters equal but device_type), and
    loading the JAX text round-trips byte-identically in both."""
    out, X, _ = trained
    jtext = out["jax"][0].model_to_string()
    ttext = out["torch"][0].model_to_string()
    jl, tl = jtext.splitlines(), ttext.splitlines()
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        key = a.split("=", 1)[0]
        if key in ("split_gain", "leaf_value", "leaf_weight",
                   "internal_value", "internal_weight"):
            np.testing.assert_allclose(
                np.asarray(b.split("=")[1].split(), float),
                np.asarray(a.split("=")[1].split(), float),
                rtol=1e-5, atol=1e-6)
        elif key == "tree_sizes" or a.startswith("[device_type"):
            continue
        else:
            assert a == b
    loaded = tlgb.Booster(params={"device_type": "cpu"}, model_str=jtext)
    assert loaded.model_to_string() == \
        jlgb.Booster(model_str=jtext).model_to_string()
    np.testing.assert_allclose(loaded.predict(X), out["jax"][0].predict(X),
                               atol=1e-6)


@pytest.mark.parametrize("objective", [
    "lambdarank", "multiclass num_class:3", "multiclassova num_class:3",
    "cross_entropy_lambda"])
def test_loading_an_untrained_objective_raises(trained, objective):
    """JAX model text of each of these objectives loads in the port: a
    JAX model of each (ranking with ten queries; 3 classes from the
    label and column 0) predicts bit-equal in the port, raw and
    transformed."""
    out, X, _ = trained
    _, y = _data()
    name, _, tok = objective.partition(" ")
    params = {"objective": name, "num_leaves": 7, "verbose": -1}
    group = None
    if tok:
        params["num_class"] = int(tok.split(":")[1])
        y = y + (X[:, 0] > 1.0)
    if name == "lambdarank":
        group = np.full(10, len(y) // 10)
        group[-1] += len(y) - group.sum()
    jb = jlgb.train(params, jlgb.Dataset(X, label=y, group=group),
                    num_boost_round=2)
    tb = tlgb.Booster(params={"device_type": "cpu"},
                      model_str=jb.model_to_string())
    assert tb._gbdt.objective.name == name
    for raw in (True, False):
        np.testing.assert_array_equal(tb.predict(X, raw_score=raw),
                                      jb.predict(X, raw_score=raw))


def test_booster_from_jax_arrays(trained):
    out, X, Xv = trained
    jb = out["jax"][0]
    trees = [{f: getattr(t, f)[:t.num_leaves if f.startswith("leaf_")
                                else t.num_leaves - 1]
              for f in TREE_FIELDS} | {"num_leaves": t.num_leaves}
             for t in _jax_trees(jb)]
    b = booster_from_jax_arrays(trees, max_feature_idx=5,
                                params={"device_type": "cpu"})
    for x in (X, Xv):
        np.testing.assert_allclose(b.predict(x), jb.predict(x), atol=1e-6)


def test_port_imports_neither_jax_nor_the_jax_package():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "lightgbm_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    names = {os.path.relpath(f, REPO) for f in files}
    for mod in ("treelearner/serial.py", "treelearner/monotone.py",
                "ops/partition.py", "ops/multival.py", "ops/cuda.py",
                "objective/rank.py", "models/shap.py", "models/codegen.py",
                "sklearn.py", "plotting.py", "cli.py", "__main__.py",
                "network.py", "io/distributed.py",
                "treelearner/parallel.py", "robust/__init__.py",
                "robust/checkpoint.py", "robust/faultinject.py",
                "robust/watchdog.py", "robust/sentinel.py",
                "compile/signature.py", "utils/device.py",
                "obs/__init__.py", "obs/registry.py", "obs/sink.py",
                "obs/trace.py", "obs/spans.py", "obs/report.py",
                "obs/aggregate.py", "obs/flight.py", "obs/httpd.py",
                *(f"analysis/{m}.py" for m in (
                    "__init__", "__main__", "core", "locks", "threads",
                    "sync_points", "trace_safety", "recompile",
                    "mesh_inventory", "collective_axis", "kernel_contract",
                    "dtype_flow", "lifetime", "runtime_check"))):
        assert os.path.join("lightgbm_tpu_torch", mod) in names, mod
    for path in files:
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for m in mods:
                top = m.split(".")[0]
                assert top not in ("jax", "jaxlib", "lightgbm_tpu"), \
                    f"{path} imports {m}"


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    X, y = _data(n=200)
    with pytest.raises(tlgb.LightGBMError, match="no CUDA device"):
        tlgb.train({"objective": "binary", "verbose": -1},
                   tlgb.Dataset(X, label=y), num_boost_round=1)


@pytest.mark.parametrize("extra,err,match", [
    ({"bagging_freq": 1, "bagging_fraction": 0.5}, None, "fused"),
    ({"use_quantized_grad": True}, None, "fused"),
    ({"forcedsplits_filename": "forced_splits.json"}, None, "fused"),
    ({"forcedsplits_filename": "forced_splits.json", "tpu_fused": False},
     None, "host_loop"),
    ({"tpu_fused": False, "use_quantized_grad": True}, None, "host_loop"),
    ({"tree_learner": "voting", "num_machines": 2}, None, "host_loop"),
    ({"objective": "lambdarank"}, None, "fused"),
])
def test_left_out_options_raise(extra, err, match, tmp_path):
    """Options the port does not train yet raise and name their ROADMAP
    item (``err``; none is left here); bagging, quantized gradients,
    forced splits, ranking and a parallel tree learner (``err`` None)
    train on the learner named by ``match``, the quantized ones with
    integer histograms, the forced ones with the file's root split,
    ranking over ten queries on the per-tree path, voting with
    num_machines 2 in one process (no process group) on the serial host
    loop (tests/test_torch_forced.py, tests/test_torch_rank.py and
    tests/test_torch_parallel.py hold them against the JAX package)."""
    X, y = _data(n=300)
    X[:, 3] = np.abs(np.round(X[:, 3]))
    if "forcedsplits_filename" in extra:
        path = str(tmp_path / extra["forcedsplits_filename"])
        with open(path, "w") as fh:
            fh.write('{"feature": 1, "threshold": 0.0}')
        extra = {**extra, "forcedsplits_filename": path}
    if err is None:
        group = [30] * 10 if extra.get("objective") == "lambdarank" else None
        b = tlgb.train({**PARAMS, **extra},
                       tlgb.Dataset(X, label=y, group=group),
                       num_boost_round=2, verbose_eval=False)
        gb = b._gbdt
        learner = gb._fused if match == "fused" else gb.tree_learner
        assert learner is not None
        assert learner._quant == bool(extra.get("use_quantized_grad"))
        assert len(gb.models) == 2 and gb.models[0].num_leaves > 2
        assert np.isfinite(b.predict(X)).all()
        if "forcedsplits_filename" in extra:
            assert all(int(t.split_feature[0]) == 1 for t in gb.models)
        return
    with pytest.raises(err, match=match):
        tlgb.train({**PARAMS, **extra}, tlgb.Dataset(X, label=y),
                   num_boost_round=1, verbose_eval=False)


def test_gbdt_defaults_to_the_card():
    """GBDT() resolves its device like every entry point: the card by
    default (raising without one), the CPU only when asked for."""
    from lightgbm_tpu_torch.boosting.gbdt import GBDT
    assert GBDT("cpu").device.type == "cpu"
    if torch.cuda.is_available():
        assert GBDT().device.type == "cuda"
    else:
        with pytest.raises(tlgb.LightGBMError, match="no CUDA device"):
            GBDT()


def test_early_stopping_and_options():
    """Early stopping on a validation set, max_depth, feature fraction,
    monotone constraints and the pool-less mode run and respect their
    limits."""
    X, y = _data(n=800)
    Xv, yv = _data(seed=5, n=300)
    ds = tlgb.Dataset(X, label=y)
    b = tlgb.train({**PARAMS, "max_depth": 3, "feature_fraction": 0.7,
                    "feature_fraction_bynode": 0.8,
                    "monotone_constraints": [1, 0, 0, 0, 0, 0],
                    "histogram_pool_size": 0.001, "learning_rate": 0.3},
                   ds, num_boost_round=40,
                   valid_sets=[tlgb.Dataset(Xv, label=yv, reference=ds)],
                   early_stopping_rounds=3, verbose_eval=False)
    assert b.best_iteration >= 1
    for t in b._gbdt.models:
        assert t.leaf_depth[:t.num_leaves].max() <= 3
    # monotone in feature 0: raising it never lowers the score
    lo, hi = X.copy(), X.copy()
    hi[:, 0] = lo[:, 0] + 1.0
    assert (b.predict(hi, raw_score=True)
            >= b.predict(lo, raw_score=True) - 1e-6).all()


# the gates of the JAX package's float32 bits (ROADMAP C1, C2): trees
# grown past 15 leaves and 3 trees, where a gradient or gain one ulp
# off flips near-ties; split gains, leaf values and predictions must be
# bit-equal. Each case's parameters, with the tree count.
BIT_GATES = {
    "c1_63_leaves": ({"num_leaves": 63, "min_data_in_leaf": 5}, 4),
    "c1_zero_as_missing": ({"num_leaves": 63, "min_data_in_leaf": 5,
                            "zero_as_missing": True}, 4),
    "c2_max_delta_step": ({"max_delta_step": 0.3}, 4),
    "default_31_leaves": ({"num_leaves": 31}, 4),
    "path_smooth_l1": ({"num_leaves": 30, "lambda_l1": 0.5,
                        "path_smooth": 2.0}, 4),
    "monotone_basic_l1": ({"num_leaves": 63, "lambda_l1": 0.5,
                           "monotone_constraints": [1, -1, 0, 0, 0, 0]}, 4),
    "quantized_63_leaves": ({"num_leaves": 63, "min_data_in_leaf": 5,
                             "use_quantized_grad": True}, 4),
    "quantized_max_delta_step": ({"max_delta_step": 0.3,
                                  "use_quantized_grad": True,
                                  "num_grad_quant_bins": 64}, 4),
    # fewer bins: the reverse scan's multiply-add site follows the bin
    # count (ops/split.py scan_sites)
    "max_bin_15": ({"max_bin": 15}, 4),
    "max_bin_15_l1": ({"max_bin": 15, "lambda_l1": 0.5}, 4),
    "max_bin_40_l1": ({"max_bin": 40, "lambda_l1": 0.5}, 4),
    "max_bin_63": ({"max_bin": 63}, 4),
    "no_nan_31_leaves": ({"num_leaves": 31}, 4),
    "no_nan_quantized_63_leaves": ({"num_leaves": 63, "min_data_in_leaf": 5,
                                    "use_quantized_grad": True}, 4),
}
# up to 16 bins under L1 each fusion of the JAX programs orders the
# gain's multiply-add its own way (ops/split.py scan_sites; ROADMAP §C,
# C9): L1 with a clamp, monotone constraints, smoothing, zero as
# missing, L2 or quantized gradients at 15 bins, and plain L1 at 16
C9 = {"min_data_in_leaf": 5, "lambda_l1": 0.5, "max_bin": 15}
BIT_GATES.update({
    "c9_max_delta_step": ({**C9, "max_delta_step": 0.3}, 3),
    "c9_monotone": ({**C9, "monotone_constraints": [1, -1, 0, 0, 0, 0]}, 3),
    "c9_path_smooth": ({**C9, "path_smooth": 2.0}, 3),
    "c9_zero_as_missing": ({**C9, "zero_as_missing": True}, 3),
    "c9_l2": ({**C9, "lambda_l2": 1.0}, 3),
    "c9_quantized": ({**C9, "use_quantized_grad": True}, 3),
    "c9_l1_max_bin_16": ({**C9, "max_bin": 16}, 3),
})
# option pairs under L1 at 16 bins or fewer, which the one-option rows
# of scan_sites did not compose into (ROADMAP §C, C11): L2 with
# monotone constraints (and with smoothing too), L2 with smoothing, a
# clamp or smoothing with quantized gradients
BIT_GATES.update({
    "c11_l2_monotone": ({**C9, "lambda_l2": 1.0,
                         "monotone_constraints": [1, -1, 0, 0, 0, 0]}, 3),
    "c11_l2_path_smooth": ({**C9, "lambda_l2": 1.0, "path_smooth": 2.0}, 3),
    "c11_l2_monotone_path_smooth": ({**C9, "lambda_l2": 1.0,
                                     "path_smooth": 2.0,
                                     "monotone_constraints":
                                     [1, -1, 0, 0, 0, 0]}, 3),
    "c11_max_delta_step_quantized_16": ({**C9, "max_bin": 16,
                                         "max_delta_step": 0.3,
                                         "use_quantized_grad": True}, 3),
})
# quantized gradients under L1, where the quantized root scan's leaf
# totals (level total x scale) meet the scan in one multiply-add
# (ROADMAP §C, C10)
C10 = {"min_data_in_leaf": 5, "lambda_l1": 0.5, "use_quantized_grad": True}
BIT_GATES.update({
    "c10_quantized_17_no_nan": ({**C10, "max_bin": 17}, 3),
    "c10_quantized_31": ({**C10, "max_bin": 31}, 3),
    "c10_path_smooth_quantized_15": ({**C10, "max_bin": 15,
                                      "path_smooth": 2.0}, 3),
    "c10_path_smooth_quantized_31": ({**C10, "max_bin": 31,
                                      "path_smooth": 2.0}, 3),
})
# gates on ``_data(nan=False)``: no feature has a missing type, so no
# feature takes two scans (but with zero as missing); the host loop's
# program folds its forward scan away, the fused program (metadata as
# arguments) does not
NO_NAN_GATES = {"no_nan_31_leaves", "no_nan_quantized_63_leaves",
                "c9_zero_as_missing", "c10_quantized_17_no_nan"}


def assert_bit_equal_training(extra, rounds, nan=True):
    """Train ``extra`` over PARAMS in both packages on ``_data(nan=nan)``:
    the same trees, split gains, leaf values and predictions, bit for
    bit."""
    X, y = _data(nan=nan)
    params = {**PARAMS, **extra}
    jb = jlgb.train(dict(params), jlgb.Dataset(X, label=y),
                    num_boost_round=rounds)
    tb = tlgb.train(params, tlgb.Dataset(X, label=y), num_boost_round=rounds,
                    verbose_eval=False)
    jt, tt = _jax_trees(jb), tb._gbdt.models
    assert len(jt) == len(tt) == rounds
    for i, (a, b) in enumerate(zip(jt, tt)):
        k = a.num_leaves
        assert k == b.num_leaves, (i, k, b.num_leaves)
        for f in ("split_feature", "threshold", "decision_type",
                  "left_child", "right_child", "internal_count"):
            np.testing.assert_array_equal(getattr(a, f)[:k - 1],
                                          getattr(b, f)[:k - 1],
                                          err_msg=f"tree {i} {f}")
        for f, m in (("split_gain", k - 1), ("leaf_value", k)):
            np.testing.assert_array_equal(getattr(a, f)[:m],
                                          getattr(b, f)[:m],
                                          err_msg=f"tree {i} {f}")
    np.testing.assert_array_equal(tb.predict(X, raw_score=True),
                                  jb.predict(X, raw_score=True))
    return jb, tb


# every pair and triple of {clamp 0.3, smoothing 2, monotone [1, -1, 0,
# 0, 0, 0], L2 1, quantized gradients} under L1 0.5 at 15 and 16 bins,
# with and without the NaN column, on the fused learner (persistent),
# the host loop and the per-tree path under bagging (ROADMAP §C, C11)
_SWEEP_OPTIONS = {"clamp": {"max_delta_step": 0.3},
                  "smooth": {"path_smooth": 2.0},
                  "mono": {"monotone_constraints": [1, -1, 0, 0, 0, 0]},
                  "l2": {"lambda_l2": 1.0},
                  "quant": {"use_quantized_grad": True}}
_SWEEP_LEARNERS = {"fused": {}, "host_loop": {"tpu_fused": False},
                   "bagging": {"bagging_fraction": 0.8, "bagging_freq": 1}}
C11_SWEEP = [
    pytest.param({**C9, "max_bin": bins,
                  **{k: v for o in combo for k, v in
                     _SWEEP_OPTIONS[o].items()},
                  **_SWEEP_LEARNERS[learner]}, nan,
                 id=f"{'+'.join(combo)}-{bins}-{'nan' if nan else 'no_nan'}"
                    f"-{learner}")
    for k in (2, 3)
    for combo in itertools.combinations(sorted(_SWEEP_OPTIONS), k)
    for bins in (15, 16) for nan in (True, False)
    for learner in sorted(_SWEEP_LEARNERS)]


@pytest.mark.slow
@pytest.mark.parametrize("extra,nan", C11_SWEEP)
def test_option_combinations_bit_equal(extra, nan):
    assert_bit_equal_training(extra, 3, nan=nan)


@pytest.mark.parametrize("case", sorted(BIT_GATES))
def test_fused_learner_bit_equal(case):
    extra, rounds = BIT_GATES[case]
    no_nan = case in NO_NAN_GATES
    _, tb = assert_bit_equal_training(extra, rounds, nan=not no_nan)
    assert tb._gbdt._fused is not None
    assert tb._gbdt._fused.meta.any_two_scan == (
        not no_nan or extra.get("zero_as_missing", False))
