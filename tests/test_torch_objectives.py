"""The regression family and cross-entropy of the port against the JAX
package's: gradients in both forms, boost_from_score and convert_output
on random scores from a seed, and whole trainings on both learners.

``get_gradients`` (the host loop's form) is held against the JAX
package's jitted ``get_gradients``, which folds labels and weights as
constants; ``persistent_grads`` (the fused learner's form) against the
gradient step of the JAX fused learner's iteration program, jitted
alone over a planar state (``_jax_fused_grad_step``), because XLA fuses
the same ops differently there (gamma, tweedie; ROADMAP §C). Both bit
for bit. The training gates hold the port's fused learner against the
JAX fused learner and its host loop against the JAX host loop: trees,
split gains, leaf values and predictions, bit for bit.
"""
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.io.dataset import BinnedDataset as JDataset
from lightgbm_tpu.objective.functions import create_objective as jax_objective
from lightgbm_tpu.ops import plane as jplane
from lightgbm_tpu.treelearner.fused import FusedSerialGrower as JFused
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.objective.functions import \
    create_objective as port_objective

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


def reg_data(objective, seed=0, n=2000):
    """6 columns (NaNs in column 2, zeros in column 5) and a label of
    the objective's family: counts (poisson), positive (gamma), zeros
    and positive values (tweedie), probabilities (cross_entropy), else
    a heavy-tailed real target. Row weights in [0.5, 1.5)."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 6)
    X[rng.rand(n) < 0.05, 2] = np.nan
    X[:, 5] = np.where(rng.rand(n) < 0.4, 0.0, X[:, 5])
    f = X[:, 0] + 0.5 * X[:, 1] - 0.3 * np.nan_to_num(X[:, 2]) * X[:, 3]
    if objective == "poisson":
        y = rng.poisson(np.exp(0.5 * f))
    elif objective == "gamma":
        y = rng.gamma(2.0, np.exp(0.3 * f) / 2.0)
    elif objective == "tweedie":
        y = rng.gamma(1.5, np.exp(0.3 * f)) * (rng.rand(n) < 0.7)
    elif objective == "cross_entropy":
        y = 1.0 / (1.0 + np.exp(-f - rng.randn(n) * 0.5))
    else:
        y = 3.0 * f + rng.standard_cauchy(n) * 0.5
    return X, y.astype(np.float64), rng.rand(n) + 0.5


# objective, its params beyond the defaults
OBJECTIVES = {
    "regression": {},
    "regression_sqrt": {"reg_sqrt": True},
    "regression_l1": {},
    "huber": {"alpha": 0.7},
    "fair": {"fair_c": 0.9},
    "poisson": {"poisson_max_delta_step": 0.5},
    "quantile": {"alpha": 0.8},
    "mape": {},
    "gamma": {},
    "tweedie": {"tweedie_variance_power": 1.3},
    "cross_entropy": {},
}


def _objectives(case, weighted, n=3000, seed=5):
    """The JAX and the port objective of ``case`` on one dataset's
    labels and weights, initialised."""
    name = case.split("_sqrt")[0]
    _, y, w = reg_data(name, seed=seed, n=n)
    md = types.SimpleNamespace(
        label=y.astype(np.float32),
        weights=w.astype(np.float32) if weighted else None)
    params = {"objective": name, "verbose": -1, **OBJECTIVES[case]}
    jo = jax_objective(JConfig.from_params(params))
    to = port_objective(TConfig.from_params({**params,
                                             "device_type": "cpu"}))
    jo.init(md, n)
    to.init(md, n)
    return jo, to, params, md


def _scores(case, n, seed=3):
    """Random float32 scores, plus zeros, signed zeros and values at
    the ends of exp's range."""
    rng = np.random.RandomState(seed)
    scale = 1.5 if case in ("poisson", "gamma", "tweedie") else 5.0
    s = (rng.randn(n) * scale).astype(np.float32)
    s[:8] = [0.0, -0.0, 1e-3, -1e-3, 60.0, -60.0, 88.0, -95.0]
    return s


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted",
                                                         "weighted"])
@pytest.mark.parametrize("case", sorted(OBJECTIVES))
def test_gradients_bit_equal(case, weighted):
    """get_gradients against the jitted JAX get_gradients, bit for bit;
    boost_from_score equal; convert_output against the jitted JAX
    convert_output, bit for bit."""
    jo, to, _, md = _objectives(case, weighted)
    s = _scores(case, len(md.label))
    for want, got in zip(jo.get_gradients(jnp.asarray(s)),
                         to.get_gradients(torch.as_tensor(s))):
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    assert to.boost_from_score(0) == jo.boost_from_score(0)
    np.testing.assert_array_equal(
        _bits(to.convert_output(torch.as_tensor(s)).numpy()),
        _bits(jax.jit(jo.convert_output)(jnp.asarray(s))))
    assert to.to_string() == jo.to_string()


def _jax_fused_grad_step(fl, data):
    """The gradient step of the JAX fused learner's iteration program
    (``FusedSerialGrower._train_iter``: persistent_grads over the
    state's planes, pad lanes zeroed, written by ``set_gh``), to be
    jitted alone."""
    Ly = fl.layout
    realm = jnp.arange(Ly.num_lanes, dtype=jnp.int32) < Ly.num_rows
    w = jplane.get_f32(data, Ly.weight) if Ly.weight >= 0 else None
    g, h = fl.objective.persistent_grads(jplane.get_f32(data, Ly.score),
                                         jplane.get_f32(data, Ly.label), w)
    return jplane.set_gh(data, Ly, jnp.where(realm, g, 0.0),
                         jnp.where(realm, h, 0.0))


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted",
                                                         "weighted"])
@pytest.mark.parametrize("case", sorted(OBJECTIVES))
def test_persistent_grads_bit_equal(case, weighted):
    """persistent_aux equal, and persistent_grads over the JAX fused
    learner's planar state (random scores) against its jitted gradient
    step, bit for bit."""
    name = case.split("_sqrt")[0]
    X, y, w = reg_data(name, n=1500)
    params = {"objective": name, "num_leaves": 7, "verbose": -1,
              **OBJECTIVES[case]}
    cfg = JConfig.from_params(params)
    ds = JDataset.from_matrix(X, cfg, label=y,
                              weight=w if weighted else None)
    jo = jax_objective(cfg)
    jo.init(ds.metadata, ds.num_data)
    fl = JFused(ds, cfg, jo)
    n, Ly = ds.num_data, fl.layout
    data = fl.init_persistent_state(_scores(case, n))
    out = jax.jit(lambda d: _jax_fused_grad_step(fl, d))(data)
    to = port_objective(TConfig.from_params({**params,
                                             "device_type": "cpu"}))
    to.init(ds.metadata, n)
    for a, b in zip(jo.persistent_aux(), to.persistent_aux()):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(_bits(b), _bits(a))

    def plane_of(i):
        return torch.as_tensor(np.array(jplane.get_f32(data, i))[:n])
    got = to.persistent_grads(plane_of(Ly.score), plane_of(Ly.label),
                              plane_of(Ly.weight) if Ly.weight >= 0
                              else None)
    for i, g in zip((Ly.grad, Ly.hess), got):
        want = np.asarray(jplane.get_f32(out, i))[:n]
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(want))


# ---------------------------------------------------------------------------
# training gates
# ---------------------------------------------------------------------------

# case: (objective or None for no key, params beyond PARAMS, weighted)
GATES = {
    "default": (None, {}, False),
    "regression_l1": ("regression_l1", {}, True),
    "quantile": ("quantile", {"alpha": 0.8}, False),
    "mape": ("mape", {}, True),
    "huber": ("huber", {"alpha": 2.0}, True),
    "fair": ("fair", {}, False),
    "poisson": ("poisson", {}, True),
    "gamma": ("gamma", {}, False),
    "tweedie": ("tweedie", {"tweedie_variance_power": 1.3}, True),
    "cross_entropy": ("cross_entropy", {}, True),
}
PARAMS = {"num_leaves": 31, "min_data_in_leaf": 5, "verbose": -1}


def assert_regression_bit_equal(objective, extra, weighted, fused,
                                rounds=4):
    """Train in both packages on reg_data: the same trees, split gains,
    leaf values and predictions (raw and converted), bit for bit."""
    X, y, w = reg_data(objective or "regression")
    params = {**PARAMS, **extra, "tpu_fused": fused}
    if objective is not None:
        params["objective"] = objective
    w = w if weighted else None
    jb = jlgb.train(dict(params), jlgb.Dataset(X, label=y, weight=w),
                    num_boost_round=rounds)
    tb = tlgb.train({**params, "device_type": "cpu"},
                    tlgb.Dataset(X, label=y, weight=w),
                    num_boost_round=rounds, verbose_eval=False)
    assert (jb._gbdt._fused is not None) == fused
    assert (tb._gbdt._fused is not None) == fused
    jt, tt = jb._gbdt._used_models(0, -1), tb._gbdt.models
    assert len(jt) == len(tt) == rounds
    for i, (a, b) in enumerate(zip(jt, tt)):
        k = a.num_leaves
        assert k == b.num_leaves and k > 2, (i, k, b.num_leaves)
        for f in TREE_FIELDS:
            m = k if f.startswith("leaf_") else k - 1
            np.testing.assert_array_equal(getattr(a, f)[:m],
                                          getattr(b, f)[:m],
                                          err_msg=f"tree {i} {f}")
    np.testing.assert_array_equal(tb.predict(X, raw_score=True),
                                  jb.predict(X, raw_score=True))
    np.testing.assert_array_equal(tb.predict(X), jb.predict(X))
    head = [ln for ln in jb.model_to_string().splitlines()
            if ln.startswith("objective=")]
    assert head and head == [ln for ln in tb.model_to_string().splitlines()
                             if ln.startswith("objective=")]
    return jb, tb


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "host_loop"])
@pytest.mark.parametrize("case", sorted(GATES))
def test_training_bit_equal(case, fused):
    """Each objective on the fused learner against the JAX fused
    learner, and on the host loop against the JAX host loop."""
    objective, extra, weighted = GATES[case]
    _, tb = assert_regression_bit_equal(objective, extra, weighted, fused)
    if case == "default":
        assert tb._gbdt.objective.name == "regression"
        assert [m.name for m in tb._gbdt.metrics] == ["l2"]


@pytest.mark.parametrize("objective", ["regression", "regression_l1"])
def test_quantized_training_bit_equal(objective):
    """use_quantized_grad on the fused learner: L2 keeps the quantized
    search's leaf outputs, L1 (weighted) takes its percentile refit."""
    _, tb = assert_regression_bit_equal(
        objective, {"use_quantized_grad": True}, objective != "regression",
        True)
    assert tb._gbdt._fused._quant


def test_default_objective_trains_like_lightgbm():
    """``train({...}, Dataset(X, label=y))`` with no objective key: the
    default regression with metric l2 on a validation set, the values
    the JAX package gives."""
    X, y, _ = reg_data("regression")
    Xv, yv, _ = reg_data("regression", seed=1, n=500)
    evs = {}
    for name, lib in (("jax", jlgb), ("torch", tlgb)):
        ds = lib.Dataset(X, label=y)
        ev = {}
        params = {"verbose": -1}
        if lib is tlgb:
            params["device_type"] = "cpu"
        lib.train(params, ds, num_boost_round=3,
                  valid_sets=[lib.Dataset(Xv, label=yv, reference=ds)],
                  valid_names=["valid"], evals_result=ev,
                  verbose_eval=False)
        evs[name] = ev["valid"]["l2"]
    assert len(evs["torch"]) == 3
    np.testing.assert_array_equal(evs["torch"], evs["jax"])
