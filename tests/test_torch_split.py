"""The port's numerical split scan against the JAX package on the same
histograms: the same best (feature, threshold, default_left) and gains
within 1e-5 relative, for every missing type and regularization mode."""
import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from lightgbm_tpu.ops import split as JS
from lightgbm_tpu_torch.ops import split as TS

F, B = 9, 64


def _case(seed):
    rng = np.random.RandomState(seed)
    num_bin = rng.randint(2, B + 1, F)
    num_bin[:3] = (B, 2, 3)
    missing = rng.randint(0, 3, F)
    default_bin = np.array([rng.randint(0, nb) for nb in num_bin])
    cnt = rng.randint(0, 200, (F, B)).astype(np.float32)
    cnt[np.arange(B)[None, :] >= num_bin[:, None]] = 0
    hess = cnt * rng.uniform(0.05, 0.25, (F, B)).astype(np.float32)
    grad = (cnt * rng.uniform(-0.5, 0.5, (F, B))
            + rng.randn(F, B)).astype(np.float32) * (cnt > 0)
    # every feature sees the same rows: rescale to feature 0's totals
    hess *= hess[0].sum() / np.maximum(hess.sum(1, keepdims=True), 1e-9)
    grad += (grad[0].sum() - grad.sum(1, keepdims=True)) / num_bin[:, None] \
        * (np.arange(B)[None, :] < num_bin[:, None])
    hist = np.stack([grad, hess], -1).astype(np.float32)
    monotone = rng.randint(-1, 2, F)
    return hist, num_bin, missing, default_bin, monotone


CFGS = {
    "default": {},
    "l1_l2": dict(lambda_l1=0.5, lambda_l2=2.0, min_gain_to_split=0.1),
    "max_delta_step": dict(max_delta_step=0.3, min_data_in_leaf=50),
    "path_smooth": dict(path_smooth=5.0, min_sum_hessian_in_leaf=1.0),
    "monotone": dict(use_monotone=True),
}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("cfg_name", sorted(CFGS))
def test_numerical_split_scan_matches_jax(cfg_name, seed):
    hist, num_bin, missing, default_bin, monotone = _case(seed)
    kw = CFGS[cfg_name]
    penalty = np.linspace(0.5, 1.0, F).astype(np.float32)
    jmeta = JS.FeatureMeta.build(num_bin, missing, default_bin,
                                 np.zeros(F, bool), monotone, penalty)
    tmeta = TS.FeatureMeta.build(num_bin, missing, default_bin,
                                 np.zeros(F, bool), monotone, penalty)
    jcfg = dataclasses.replace(JS.SplitConfig(), **kw)
    tcfg = dataclasses.replace(TS.SplitConfig(), **kw)
    sum_g, sum_h = float(hist[0, :, 0].sum()), float(hist[0, :, 1].sum())
    n = int(round(hist[0, :, 1].sum() * 5))
    lo, hi = (-0.4, 0.6) if cfg_name == "monotone" else (-np.inf, np.inf)
    want = JS.best_split(jnp.asarray(hist), jmeta, jcfg, jnp.float32(sum_g),
                         jnp.float32(sum_h), jnp.int32(n), jnp.float32(0.1),
                         jnp.float32(lo), jnp.float32(hi))
    f32 = torch.float32
    got = TS.best_split(torch.as_tensor(hist), tmeta, tcfg,
                        torch.tensor(sum_g, dtype=f32),
                        torch.tensor(sum_h, dtype=f32),
                        torch.tensor(n, dtype=torch.int32),
                        torch.tensor(0.1, dtype=f32), torch.tensor(lo, dtype=f32),
                        torch.tensor(hi, dtype=f32))
    wg = np.asarray(want["gain"])
    gg = got["gain"].numpy()
    found = np.isfinite(wg)
    assert found.any()
    np.testing.assert_array_equal(found, np.isfinite(gg))
    np.testing.assert_allclose(gg[found], wg[found], rtol=1e-5, atol=1e-6)
    for k in ("threshold", "default_left", "left_count"):
        np.testing.assert_array_equal(got[k].numpy()[found],
                                      np.asarray(want[k])[found])
    for k in ("left_sum_gradient", "left_sum_hessian", "left_output",
              "right_output"):
        np.testing.assert_allclose(got[k].numpy()[found],
                                   np.asarray(want[k])[found],
                                   rtol=1e-5, atol=1e-5)
    assert int(got["best_feature"]) == int(want["best_feature"])
    np.testing.assert_allclose(float(got["best_gain"]),
                               float(want["best_gain"]), rtol=1e-5)


def test_split_scan_batches_leaves():
    """Two leaves in one call equal two single-leaf calls."""
    hist, num_bin, missing, default_bin, monotone = _case(3)
    meta = TS.FeatureMeta.build(num_bin, missing, default_bin,
                                np.zeros(F, bool), monotone, np.ones(F))
    cfg = TS.SplitConfig()
    h2 = torch.as_tensor(np.stack([hist, hist * 0.5]))
    sg = torch.tensor([hist[0, :, 0].sum(), hist[0, :, 0].sum() * 0.5])
    sh = torch.tensor([hist[0, :, 1].sum(), hist[0, :, 1].sum() * 0.5])
    n = torch.tensor([900, 450], dtype=torch.int32)
    z = torch.zeros(2)
    both = TS.numerical_split_scan(h2, meta, cfg, sg, sh, n, z, z - np.inf,
                                   z + np.inf)
    for i in range(2):
        one = TS.numerical_split_scan(h2[i], meta, cfg, sg[i], sh[i], n[i],
                                      z[i], z[i] - np.inf, z[i] + np.inf)
        for k, v in one.items():
            assert torch.equal(both[k][i], v), k
