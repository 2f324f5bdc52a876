"""The port's host data plane against the JAX package: config, bin
boundaries, bin matrix, EFB bundles and occupancy must be byte-identical
on the same matrix (NaNs, constant columns, zero-heavy columns, more
than 256 distinct values)."""
import dataclasses

import numpy as np
import pytest

from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.io.binning import greedy_find_bin as j_greedy
from lightgbm_tpu.io.dataset import BinnedDataset as JDS
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.io.binning import greedy_find_bin as t_greedy
from lightgbm_tpu_torch.io.binning import \
    greedy_find_bin_python as t_greedy_py
from lightgbm_tpu_torch.io.dataset import BinnedDataset as TDS
from lightgbm_tpu_torch.native import greedy_find_bin_native


def _matrix(seed=0, n=3000):
    rng = np.random.RandomState(seed)
    X = np.empty((n, 14))
    X[:, 0] = rng.randn(n)                            # dense continuous
    X[:, 1] = rng.randn(n)
    X[rng.rand(n) < 0.1, 1] = np.nan                  # NaN-missing
    X[:, 2] = 7.0                                     # constant (trivial)
    X[:, 3] = rng.randint(0, 5, n)                    # few distinct
    X[:, 4] = np.round(rng.randn(n), 1)
    X[:, 5] = np.where(rng.rand(n) < 0.3, 0.0, rng.randn(n))
    # mutually exclusive sparse columns -> EFB bundles
    owner = rng.randint(6, 14, n)
    for c in range(6, 14):
        X[:, c] = np.where((owner == c) & (rng.rand(n) < 0.5),
                           rng.rand(n) * 10 + 1, 0.0)
    return X


@pytest.mark.parametrize("params", [
    {},
    {"max_bin": 63, "min_data_in_bin": 5},
    {"zero_as_missing": True, "enable_bundle": False},
    {"bin_construct_sample_cnt": 1000, "use_missing": False},
])
def test_dataset_byte_identical(params):
    X = _matrix()
    y = (X[:, 0] > 0).astype(np.float32)
    j = JDS.from_matrix(X, JConfig.from_params(params), label=y)
    t = TDS.from_matrix(X, TConfig.from_params(params), label=y)
    assert len(j.bin_mappers) == len(t.bin_mappers)
    for a, b in zip(j.bin_mappers, t.bin_mappers):
        da, db = a.to_dict(), b.to_dict()
        # the NaN-missing sentinel bound compares unequal in a list
        np.testing.assert_array_equal(
            np.asarray(da.pop("bin_upper_bound", [])),
            np.asarray(db.pop("bin_upper_bound", [])))
        assert da == db
    assert j.real_feature_index == t.real_feature_index
    assert j.bins.dtype == t.bins.dtype
    np.testing.assert_array_equal(j.bins, t.bins)
    assert (j.bundles is None) == (t.bundles is None)
    if j.bundles is not None:
        assert j.bundles.groups == t.bundles.groups
        for a in ("group_of", "offset_of", "nslots_of", "skip_of",
                  "group_num_bins"):
            np.testing.assert_array_equal(getattr(j.bundles, a),
                                          getattr(t.bundles, a))
    assert j.occupancy.num_groups == t.occupancy.num_groups
    assert j.occupancy.row_nnz_mean == t.occupancy.row_nnz_mean
    np.testing.assert_array_equal(j.occupancy.default_code,
                                  t.occupancy.default_code)
    # validation data through the training mappers
    Xv = _matrix(seed=1, n=500)
    np.testing.assert_array_equal(j.create_valid(Xv).bins,
                                  t.create_valid(Xv).bins)


def test_bundles_form_and_hist_tables_match():
    X = _matrix()
    j = JDS.from_matrix(X, JConfig(), label=np.zeros(len(X)))
    t = TDS.from_matrix(X, TConfig(), label=np.zeros(len(X)))
    assert t.bundles is not None and any(len(g) > 1 for g in t.bundles.groups)
    jt = j.device_hist_tables()
    tt = t.device_hist_tables("cpu")
    for a, b in zip(jt[:3], tt[:3]):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert jt[3] == tt[3]


def test_greedy_find_bin_native_and_python_agree():
    """More than 256 distinct values take the native g++ path in both
    packages; the port's native result and its pure-Python GreedyFindBin
    (the path taken when no compiler is found) both equal the JAX
    package's."""
    rng = np.random.RandomState(3)
    dv = np.unique(np.round(rng.randn(5000), 3))
    cnt = rng.randint(1, 50, len(dv)).astype(np.int64)
    assert len(dv) > 256
    for max_bin in (255, 63):
        want = j_greedy(dv, cnt, max_bin, int(cnt.sum()), 3)
        native = greedy_find_bin_native(dv, cnt, max_bin, int(cnt.sum()), 3)
        assert native is not None and native == want
        assert t_greedy(dv, cnt, max_bin, int(cnt.sum()), 3) == want
        assert t_greedy_py(dv, cnt, max_bin, int(cnt.sum()), 3) == want


def test_config_matches_jax_except_device():
    params = {"num_leaves": 63, "eta": 0.05, "min_child_samples": 7,
              "reg_lambda": 1.5, "metric": "auc,binary", "max_bins": 63,
              "device": "cpu", "tpu_hist_dtype": "float32"}
    j = dataclasses.asdict(JConfig.from_params(params))
    t = dataclasses.asdict(TConfig.from_params(params))
    assert j.pop("device_type") == "cpu" and t.pop("device_type") == "cpu"
    assert j == t
    assert TConfig().device_type == "cuda"
    assert TConfig.from_params({"device_type": "gpu"}).device_type == "cuda"
    from lightgbm_tpu_torch.utils.log import LightGBMError
    with pytest.raises(LightGBMError, match="device_type"):
        TConfig.from_params({"device_type": "tpu"})
    with pytest.raises(LightGBMError, match="tpu_hist_dtype"):
        TConfig.from_params({"tpu_hist_dtype": "float16"})
