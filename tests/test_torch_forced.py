"""Forced splits (``forcedsplits_filename``, reference
SerialTreeLearner::ForceSplits) on both port learners against the same
JAX learner: the fused learner's forced phase on the persistent path and
on ``grow_device`` (with and without bagging), quantized gradients, the
wide multi-value layout, a forced split that is skipped (which ends the
fused learner's forced phase), a feature the dataset does not use, and
the ``histogram_pool_size`` refusal that sends the config to the host
loop. Trees, split gains, leaf values and raw predictions must be equal
bit for bit. The forced-splits JSON mirrors
tests/test_fused_coverage.py's."""
import json

import numpy as np
import pytest
import scipy.sparse as sp

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb

from test_multival import make_wide_sparse
from test_torch_api import assert_models_equal
from test_torch_multival import force_multival
from test_torch_train import _data

FORCED = {"feature": 3, "threshold": 0.0,
          "left": {"feature": 4, "threshold": 0.5},
          "right": {"feature": 0, "threshold": -0.25}}
P = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 5,
     "verbose": -1, "device_type": "cpu"}


@pytest.fixture(autouse=True, scope="module")
def _no_aot_store():
    from lightgbm_tpu.compile.manager import get_manager
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LGBM_TPU_AOT", "0")
        mp.setattr(get_manager(), "aot_enabled", False)
        yield


def _forced_file(tmp_path, spec=FORCED):
    path = str(tmp_path / "forced.json")
    with open(path, "w") as fh:
        json.dump(spec, fh)
    return path


def train_both(params, data=None, rounds=3, fobj=None):
    X, y = data if data is not None else _data(n=1000)
    jb = jlgb.train(dict(params), jlgb.Dataset(X, label=y),
                    num_boost_round=rounds, fobj=fobj, verbose_eval=False)
    tb = tlgb.train(dict(params), tlgb.Dataset(X, label=y),
                    num_boost_round=rounds, fobj=fobj, verbose_eval=False)
    assert_models_equal(jb._gbdt._used_models(0, -1), tb._gbdt.models)
    np.testing.assert_array_equal(tb.predict(X, raw_score=True),
                                  jb.predict(X, raw_score=True))
    return jb, tb


def _binary_fobj(preds, data):
    y = data.get_label()
    p = 1.0 / (1.0 + np.exp(-preds))
    return p - y, p * (1.0 - p)


# (params over P, fused learner path): "persist" the persistent path,
# "tree" grow_device, "bag" its bag-ordered branch, None the host loop
CASES = {
    "persistent": ({}, "persist"),
    "grow_device": ({"objective": "none"}, "tree"),
    "bagging": ({"bagging_fraction": 0.8, "bagging_freq": 1}, "bag"),
    "quantized": ({"use_quantized_grad": True}, "persist"),
    "l1_smooth_monotone": ({"lambda_l1": 0.5, "path_smooth": 2.0,
                            "monotone_constraints": [1, 0, 0, 0, -1, 0],
                            "max_delta_step": 0.3}, "persist"),
    "max_bin_15": ({"max_bin": 15, "lambda_l2": 1.0}, "persist"),
}


@pytest.mark.parametrize("learner", ["fused", "host_loop"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_forced_splits_bit_equal(case, learner, tmp_path):
    extra, path = CASES[case]
    params = {**P, **extra, "forcedsplits_filename": _forced_file(tmp_path),
              "tpu_fused": learner == "fused"}
    fobj = _binary_fobj if extra.get("objective") == "none" else None
    jb, tb = train_both(params, fobj=fobj)
    gb = tb._gbdt
    for t in gb.models:
        # BFS: the root on 3, its left child on 4, its right child on 0
        assert list(t.split_feature[:3]) == [3, 4, 0]
        assert list(t.split_gain[:3]) == [0.0, 0.0, 0.0]
    if learner == "host_loop":
        assert gb._fused is None and gb.tree_learner._forced_splits
        return
    fl = gb._fused
    assert fl is not None and fl._forced_sched is not None
    assert [s[:2] for s in fl._forced_sched] == [(0, 3), (0, 4), (1, 0)]
    assert gb._fused_persist == (path == "persist")
    assert fl._score_from_partition == (path != "bag")


@pytest.mark.parametrize("learner", ["fused", "host_loop"])
def test_forced_splits_wide_multival(learner, tmp_path, monkeypatch):
    """The multi-value layout forced in both packages (B5 / B6's plain
    versions), CSR input."""
    X, y = make_wide_sparse(n=400)
    # each variable's dominant level (90% of the rows)
    spec = {"feature": 0, "threshold": 0.5,
            "left": {"feature": 8, "threshold": 0.5},
            "right": {"feature": 16, "threshold": 0.5}}
    force_multival(monkeypatch)
    params = {**P, "forcedsplits_filename": _forced_file(tmp_path, spec),
              "tpu_fused": learner == "fused"}
    _, tb = train_both(params, data=(sp.csr_matrix(X), y))
    gb = tb._gbdt
    if learner == "fused":
        assert gb._fused is not None and gb._fused.layout.mv_planes > 0
    else:
        assert gb.tree_learner._mv_state is not None
    for t in gb.models:
        assert list(t.split_feature[:3]) == [0, 8, 16]


@pytest.mark.parametrize("learner", ["fused", "host_loop"])
def test_skipped_forced_split_ends_the_phase(learner, tmp_path):
    """The left child (rows with x0 <= 0) is forced on x0 at 1.0: its
    right side is empty. The fused learner skips it and forces nothing
    after it (the right child's split is left to the gain loop). The
    host loop has no such check, in the JAX package as here: it splits
    off the empty side and divides by its zero hessian."""
    spec = {"feature": 0, "threshold": 0.0,
            "left": {"feature": 0, "threshold": 1.0},
            "right": {"feature": 1, "threshold": 0.0}}
    params = {**P, "forcedsplits_filename": _forced_file(tmp_path, spec),
              "tpu_fused": learner == "fused"}
    if learner == "host_loop":
        X, y = _data(n=1000)
        for lib in (jlgb, tlgb):
            with pytest.raises(ZeroDivisionError):
                lib.train(dict(params), lib.Dataset(X, label=y),
                          num_boost_round=1, verbose_eval=False)
        return
    _, tb = train_both(params)
    for t in tb._gbdt.models:
        assert int(t.split_feature[0]) == 0
        assert int((t.split_gain[:t.num_leaves - 1] == 0.0).sum()) == 1


def test_unused_feature_is_ignored(tmp_path):
    """A forced split on a feature the dataset does not use (a constant
    column) is skipped with a warning; the rest of the tree is forced."""
    X, y = _data(n=1000)
    X[:, 5] = 1.0
    spec = {"feature": 3, "threshold": 0.0,
            "left": {"feature": 5, "threshold": 0.5},
            "right": {"feature": 0, "threshold": -0.25}}
    params = {**P, "forcedsplits_filename": _forced_file(tmp_path, spec)}
    _, tb = train_both(params, data=(X, y))
    assert [s[1] for s in tb._gbdt._fused._forced_sched] == [3, 0]


def test_pool_size_refusal_takes_the_host_loop(tmp_path):
    """Forced splits read the pooled parent histogram: with a
    histogram_pool_size too small for the pool, both packages train on
    the host loop, which recomputes leaf histograms instead."""
    params = {**P, "forcedsplits_filename": _forced_file(tmp_path),
              "histogram_pool_size": 0.001}
    jb, tb = train_both(params)
    assert jb._gbdt._fused is None and tb._gbdt._fused is None
    assert not tb._gbdt.tree_learner._keep_hists
    for t in tb._gbdt.models:
        assert list(t.split_feature[:3]) == [3, 4, 0]
