"""The port's pointwise metrics against the JAX package's on the same
scores: within 1e-9 relative where the JAX package evaluates on the host
in numpy float64, equal where it reduces on its device (a float32
value), and AUC within 1e-6 (tests/test_torch_train.py). The port
reduces every metric on the device that holds the score. Each objective
gets its default metric.
"""
import types

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.metric import metrics as JM
from lightgbm_tpu.objective.functions import create_objective as jax_objective
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.metric import metrics as TM
from lightgbm_tpu_torch.objective.functions import \
    create_objective as port_objective


@pytest.fixture(autouse=True, scope="module")
def _no_aot_store():
    """Keep the JAX package's on-disk AOT executable store out of these
    tests, as tests/test_torch_train.py does."""
    from lightgbm_tpu.compile.manager import get_manager
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LGBM_TPU_AOT", "0")
        mp.setattr(get_manager(), "aot_enabled", False)
        yield


# metric: the objective whose convert_output and labels it is taken with
METRICS = {
    "l2": "regression", "rmse": "regression", "l1": "regression",
    "quantile": "quantile", "huber": "huber", "fair": "fair",
    "poisson": "poisson", "mape": "mape", "gamma": "gamma",
    "gamma_deviance": "gamma", "tweedie": "tweedie",
    "binary_logloss": "binary", "binary_error": "binary", "auc": "binary",
    "cross_entropy": "cross_entropy", "kldiv": "cross_entropy",
}


def _labels(objective, n, rng):
    if objective == "binary":
        return (rng.rand(n) > 0.5).astype(np.float64)
    if objective == "cross_entropy":
        y = rng.rand(n)
        y[:20] = np.round(y[:20])            # hard labels among soft ones
        return y
    if objective in ("poisson", "gamma", "tweedie"):
        y = rng.gamma(2.0, 1.0, n)
        if objective != "gamma":
            y[rng.rand(n) < 0.2] = 0.0
        return y
    return rng.standard_cauchy(n) * 3


def _eval_pair(metric, objective, y, w, s):
    """(JAX value, whether the JAX package reduces it on its device,
    port value) of ``metric`` on labels y, weights w and raw scores s."""
    n = len(y)
    md = types.SimpleNamespace(
        label=y.astype(np.float32),
        weights=None if w is None else w.astype(np.float32))
    params = {"objective": objective, "metric": metric, "alpha": 0.7,
              "fair_c": 0.8, "verbose": -1}
    jc = JConfig.from_params(params)
    tc = TConfig.from_params({**params, "device_type": "cpu"})
    jo, to = jax_objective(jc), port_objective(tc)
    jo.init(md, n)
    to.init(md, n)
    jm, tm = JM.create_metric(metric, jc), TM.create_metric(metric, tc)
    jm.init(md, n)
    tm.init(md, n)
    assert tm.bigger_is_better == jm.bigger_is_better
    dev = jm.eval_device(jnp.asarray(s), jo)
    want = (float(np.asarray(dev[0][1])) if dev is not None
            else jm.eval(s, jo)[0][1])
    (name, val), = tm.eval_device(torch.as_tensor(s), to)
    assert name == metric
    return want, dev is not None, float(val)


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted",
                                                         "weighted"])
@pytest.mark.parametrize("metric", sorted(METRICS))
def test_metric_matches_jax(metric, weighted):
    objective = METRICS[metric]
    n = 3001
    rng = np.random.RandomState(len(metric) + 7 * weighted)
    y = _labels(objective, n, rng)
    w = rng.rand(n) + 0.5 if weighted else None
    scale = 0.5 if objective in ("poisson", "gamma", "tweedie") else 2.0
    s = (rng.randn(n) * scale).astype(np.float32)
    want, on_device, got = _eval_pair(metric, objective, y, w, s)
    if metric == "kldiv":
        # a hard label of 1 makes the JAX package's float32 label
        # entropy NaN (ROADMAP §C), and the port's too; the labels
        # below 1 are then held as the other metrics are
        assert np.isnan(want) and np.isnan(got)
        want, on_device, got = _eval_pair(metric, objective,
                                          np.where(y == 1, 0.0, y), w, s)
    assert np.isfinite(got)
    if metric == "auc":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    elif on_device:
        assert got == want
    else:
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=0)


@pytest.mark.parametrize("objective", [
    "regression", "regression_l1", "huber", "fair", "poisson", "quantile",
    "mape", "gamma", "tweedie", "cross_entropy"])
def test_default_metric_of_each_objective(objective):
    """With no metric given, each objective's default metric exists in
    the port and is the JAX package's."""
    params = {"objective": objective, "verbose": -1}
    tc = TConfig.from_params({**params, "device_type": "cpu"})
    assert tc.metric == JConfig.from_params(params).metric
    assert len(tc.metric) == 1
    assert TM.create_metric(tc.metric[0], tc) is not None
