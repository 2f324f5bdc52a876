"""Custom objectives (``fobj``) in the port against the JAX package: the
gradients come from numpy outside both learners' programs, so the
port's fused learner grows each tree on the per-tree path
(``grow_device``) and its host loop per class, as the JAX package does.
Trees, split gains, leaf values and raw predictions must be bit-equal;
``Booster.update(fobj=...)`` checks the gradients' size and takes the
[N, K] layout of K classes.
"""
import numpy as np
import pytest

import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb

from test_torch_multiclass import assert_trees_bit_equal, mc_data
from test_torch_objectives import reg_data
from test_torch_train import _data


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


def l2_fobj(preds, data):
    """Squared error: grad = pred - label, hess = 1."""
    return preds - data.get_label(), np.ones_like(preds)


def binary_fobj(preds, data):
    """Binary log loss in float64 numpy, with the row weights."""
    p = 1.0 / (1.0 + np.exp(-preds))
    y, w = data.get_label(), data.get_weight()
    g, h = p - y, p * (1.0 - p)
    if w is not None:
        g, h = g * w, h * w
    return g, h


def softmax_fobj(preds, data):
    """Multiclass softmax over the [N, K] raw scores, [N, K] out."""
    e = np.exp(preds - preds.max(axis=1, keepdims=True))
    p = e / e.sum(axis=1, keepdims=True)
    onehot = np.eye(preds.shape[1])[data.get_label().astype(int)]
    return p - onehot, 1.5 * p * (1.0 - p)


def _case(name):
    if name == "l2":
        X, y, _ = reg_data("regression")
        return X, y, None, l2_fobj, {}
    if name == "binary":
        X, y = _data()
        w = np.random.RandomState(3).rand(len(y)) + 0.5
        return X, y, w, binary_fobj, {}
    X, y, _ = mc_data()
    return X, y, None, softmax_fobj, {"num_class": 3}


PARAMS = {"num_leaves": 15, "min_data_in_leaf": 5, "verbose": -1}


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "host_loop"])
@pytest.mark.parametrize("case", ["l2", "binary", "softmax"])
def test_fobj_training_bit_equal(case, fused):
    """train(..., fobj=...) on both learners, 4 iterations: no objective
    function (``objective`` becomes "none"), trees and raw predictions
    bit for bit with the JAX package's."""
    X, y, w, fobj, extra = _case(case)
    params = {**PARAMS, **extra, "tpu_fused": fused}
    jb = jlgb.train(dict(params), jlgb.Dataset(X, label=y, weight=w),
                    num_boost_round=4, fobj=fobj)
    tb = tlgb.train({**params, "device_type": "cpu"},
                    tlgb.Dataset(X, label=y, weight=w), num_boost_round=4,
                    fobj=fobj, verbose_eval=False)
    gb = tb._gbdt
    assert gb.objective is None and (gb._fused is not None) == fused
    assert (jb._gbdt._fused is not None) == fused
    if fused:
        assert not gb._fused_persist
    k = gb.num_tree_per_iteration
    assert k == extra.get("num_class", 1)
    assert_trees_bit_equal(jb, tb, 4, k)
    got, want = tb.predict(X), jb.predict(X)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tb.predict(X, raw_score=True), got)
    head = [ln for ln in tb.model_to_string().splitlines()
            if ln.startswith(("objective", "num_class"))]
    assert head == [ln for ln in jb.model_to_string().splitlines()
                    if ln.startswith(("objective", "num_class"))]


def test_update_with_fobj_after_persistent_iterations():
    """Booster.update(fobj=...) on a booster with a built-in objective
    that runs the persistent fused learner: the first iterations use the
    objective in-program, then the custom gradients leave the
    persistent state (its scores synced back to row order) for the
    per-tree path, as in the JAX package."""
    X, y = _data()
    params = {**PARAMS, "objective": "binary"}
    out = {}
    for lib in (jlgb, tlgb):
        p = dict(params)
        if lib is tlgb:
            p["device_type"] = "cpu"
        ds = lib.Dataset(X, label=y)
        b = lib.Booster(params=p, train_set=ds)
        for _ in range(2):
            b.update()
        for _ in range(2):
            b.update(fobj=binary_fobj)
        out[lib] = b
    tb, jb = out[tlgb], out[jlgb]
    assert tb._gbdt._fused_persist and tb._gbdt._fused_state is None
    assert_trees_bit_equal(jb, tb, 4)
    np.testing.assert_array_equal(tb.predict(X, raw_score=True),
                                  jb.predict(X, raw_score=True))


def test_fobj_gradient_size_checked():
    """Gradients of the wrong size raise ValueError; [N, K] and K * N
    class-major layouts both train the same trees."""
    X, y, _ = mc_data(n=400)
    params = {**PARAMS, "objective": "none", "num_class": 3,
              "device_type": "cpu"}
    ds = tlgb.Dataset(X, label=y)
    b = tlgb.Booster(params=params, train_set=ds)
    with pytest.raises(ValueError, match="num_data"):
        b.update(fobj=lambda p, d: (np.zeros(len(y)), np.ones(len(y))))
    b.update(fobj=softmax_fobj)
    b2 = tlgb.Booster(params=params, train_set=tlgb.Dataset(X, label=y))

    def flat(p, d):
        g, h = softmax_fobj(p, d)
        return g.T.reshape(-1), h.T.reshape(-1)
    b2.update(fobj=flat)
    assert b.model_to_string() == b2.model_to_string()
    preds = b._curr_pred_for_fobj()
    assert preds.shape == (len(y), 3) and preds.dtype == np.float64
