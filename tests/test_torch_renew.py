"""The leaf refit of L1, quantile and MAPE (reference RenewTreeOutput)
in the port against the JAX package's: the host loop's numpy percentile
(``_np_weighted_percentile``, quirks included) and the fused learner's
in-program refit (``_renew_leaf_outputs``) on the same leaf windows of
the same planar state, bit for bit; and the refit takes no blocking
read of its own.
"""
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.io.dataset import BinnedDataset as JDataset
from lightgbm_tpu.objective import functions as JO
from lightgbm_tpu.treelearner.fused import FusedSerialGrower as JFused
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.io.dataset import BinnedDataset as TDataset
from lightgbm_tpu_torch.objective import functions as TO
from lightgbm_tpu_torch.treelearner.fused import FusedSerialGrower as TFused

from test_torch_objectives import reg_data


@pytest.fixture(autouse=True, scope="module")
def _no_aot_store():
    """Keep the JAX package's on-disk AOT executable store out of these
    tests, as tests/test_torch_train.py does."""
    from lightgbm_tpu.compile.manager import get_manager
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LGBM_TPU_AOT", "0")
        mp.setattr(get_manager(), "aot_enabled", False)
        yield


def _values(case):
    """(values, weights or None, alpha) of one percentile case."""
    rng = np.random.RandomState(len(case))
    v = rng.standard_cauchy(41).astype(np.float32)
    w = (rng.rand(41) * 2.5 + 0.1).astype(np.float32)
    return {
        "empty": (v[:0], None, 0.5),
        "one": (v[:1], None, 0.5),
        "one_weighted": (v[:1], w[:1], 0.3),
        "two_median": (v[:2], None, 0.5),
        "even_median": (np.asarray([1, 2, 3, 4], np.float32), None, 0.5),
        "edge_max": (v[:5], None, 0.9),       # (1 - alpha) * n < 1
        "edge_min": (v[:5], None, 0.0),       # pos >= n
        "ties": (np.round(v), None, 0.3),
        "weighted_interp": (v, w, 0.5),       # next steps >= 1.0
        "weighted_light": (v, w * 0.2, 0.7),  # next steps < 1.0
        "weighted_ties": (np.round(v), w, 0.5),
        "weighted_first": (v, w, 0.0),
    }[case]


@pytest.mark.parametrize("case", [
    "empty", "one", "one_weighted", "two_median", "even_median", "edge_max",
    "edge_min", "ties", "weighted_interp", "weighted_light",
    "weighted_ties", "weighted_first"])
def test_np_weighted_percentile_matches_jax(case):
    v, w, alpha = _values(case)
    got = TO._np_weighted_percentile(v, w, alpha)
    assert got == JO._np_weighted_percentile(v, w, alpha)
    if case == "even_median":
        assert got == 3.0                    # the reference's ArgMaxAtK


@pytest.mark.parametrize("objective,weighted", [
    ("regression_l1", False), ("quantile", False), ("mape", False)])
def test_host_loop_renew_matches_jax(objective, weighted):
    """renew_tree_output (the host loop's refit) on random leaf
    assignments of heavy-tailed float32 residuals: equal float64."""
    _, y, w = reg_data("regression", n=1200)
    md = types.SimpleNamespace(label=y.astype(np.float32),
                               weights=w.astype(np.float32) if weighted
                               else None)
    params = {"objective": objective, "alpha": 0.3, "verbose": -1}
    jo = JO.create_objective(JConfig.from_params(params))
    to = TO.create_objective(TConfig.from_params({**params,
                                                  "device_type": "cpu"}))
    jo.init(md, len(y))
    to.init(md, len(y))
    rng = np.random.RandomState(2)
    leaf = rng.randint(0, 9, len(y))
    resid = (y - rng.randn(len(y))).astype(np.float32)
    np.testing.assert_array_equal(to.renew_tree_output(leaf, resid, 10),
                                  jo.renew_tree_output(leaf, resid, 10))


def _windows(n, k, L, rng):
    """k leaf windows tiling [0, n) in a random leaf order, two of them
    empty (sharing a start with a neighbour) and one of a single row,
    as [L] starts / counts."""
    cuts = np.sort(rng.choice(np.arange(2, n), k - 4, replace=False))
    bounds = np.concatenate([[0, 1], cuts, [n]])
    starts = list(bounds[:-1]) + [bounds[3], bounds[5]]
    counts = list(np.diff(bounds)) + [0, 0]
    perm = rng.permutation(k)
    st = np.zeros(L, np.int32)
    ct = np.zeros(L, np.int32)
    st[:k] = np.asarray(starts)[perm]
    ct[:k] = np.asarray(counts)[perm]
    return st, ct


@pytest.mark.parametrize("objective,alpha,weighted", [
    ("regression_l1", 0.5, False), ("quantile", 0.8, False),
    ("quantile", 0.2, False), ("regression_l1", 0.5, True),
    ("quantile", 0.7, True), ("mape", 0.5, False), ("mape", 0.5, True)])
def test_renew_leaf_outputs_bit_equal(objective, alpha, weighted):
    """The fused learner's refit against the JAX package's
    ``_renew_leaf_outputs`` (jitted) on the same planar state and the
    same 40 leaf windows: heavy-tailed residuals with ties, weights in
    [0.5, 3) so that the weighted rule's interpolation is taken."""
    n, L, k = 3000, 63, 40
    rng = np.random.RandomState(int(alpha * 10) + 3 * weighted)
    X = rng.randn(n, 3)
    y = rng.standard_cauchy(n) * 2
    y[:200] = np.round(y[:200])                # exact residual ties
    w = rng.rand(n) * 2.5 + 0.5 if weighted else None
    params = {"objective": objective, "alpha": alpha, "num_leaves": L,
              "verbose": -1}
    jc = JConfig.from_params(params)
    tc = TConfig.from_params({**params, "device_type": "cpu"})
    jd = JDataset.from_matrix(X, jc, label=y, weight=w)
    td = TDataset.from_matrix(X, tc, label=y, weight=w)
    jo, to = JO.create_objective(jc), TO.create_objective(tc)
    jo.init(jd.metadata, n)
    to.init(td.metadata, n)
    jf, tf = JFused(jd, jc, jo), TFused(td, tc, to, "cpu")
    score = (rng.randn(n) * 0.5).astype(np.float32)
    score[:100] = 0.0
    jdata = jf.init_persistent_state(score)
    tdata = tf.init_persistent_state(score)
    st, ct = _windows(n, k, L, rng)
    spec = jo.persistent_renew_spec()
    assert spec == to.persistent_renew_spec()

    def refit(data, start, count):
        state = types.SimpleNamespace(data=data, leaf_start=start,
                                      leaf_count=count, leaf_count_g=count,
                                      n_leaves=jnp.int32(k))
        return jf._renew_leaf_outputs(state, jnp.int32(n), *spec)
    want = np.asarray(jax.jit(refit)(jdata, jnp.asarray(st),
                                     jnp.asarray(ct)))[:k]
    win = torch.as_tensor(np.stack([st[:k], ct[:k]]))
    got = tf._renew_leaf_outputs(tdata, n, win, *spec).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert (got[ct[:k] == 0] == 0).all() and (got[ct[:k] > 0] != 0).any()


def test_refit_takes_no_blocking_read():
    """A quantile training on the fused learner takes the reads of an L2
    training and no more: none in an iteration (the refit, like the
    tree, stays on the device), one at the end of training (the last
    tree's leaf count, for the trim of single-leaf iterations), and one
    that materializes every tree."""
    X, y, _ = reg_data("regression")
    syncs = {}
    for objective in ("regression", "quantile"):
        marks = []

        def mark(env):
            marks.append(env.model._gbdt._fused.syncs)
        mark.before_iteration = True
        b = tlgb.train({"objective": objective, "num_leaves": 31,
                        "min_data_in_leaf": 5, "verbose": -1,
                        "device_type": "cpu"},
                       tlgb.Dataset(X, label=y), num_boost_round=3,
                       callbacks=[mark])
        gb = b._gbdt
        after = gb._fused.syncs
        gb._materialize_models()
        assert gb._fused.syncs == after + 1
        assert all(t.num_leaves == 31 for t in gb.models)
        syncs[objective] = (marks, after)
    assert syncs["quantile"] == syncs["regression"] == ([0, 0, 0], 1)
