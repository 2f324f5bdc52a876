"""The wide-sparse layout of the port against the JAX package's.

Sparse (CSR/CSC) input builds byte-identical datasets; the row-wise code
matrix and its group tables are byte-identical; kernels B5 and B6 (the
port's plain versions) match histogram_multival_planar /
histogram_multival_pallas run in interpret mode, exactly on dyadic
grad/hess and within rtol 1e-5 (float32) or the bf16 tolerance of
tests/test_kernels.py otherwise; the planar state with slot planes is
byte-identical and its partition keeps the slot planes row-aligned; the
fused learner's multival leaf histogram matches the scatter oracle; and
a whole wide-sparse training with the multi-value layout forced on both
sides gives each port learner the trees of its JAX counterpart: the host
loop bit for bit, the fused learner's leaf values and predictions bit
for bit and its split gains within 1e-6 (ROADMAP §C).
"""
import numpy as np
import pytest
import scipy.sparse as sp

import jax.numpy as jnp
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.io.dataset import BinnedDataset as JDataset
from lightgbm_tpu.ops import histogram as JH
from lightgbm_tpu.ops import multival as JMV
from lightgbm_tpu.ops import plane as jplane
from lightgbm_tpu.treelearner import fused as JF
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.io.dataset import BinnedDataset as TDataset
from lightgbm_tpu_torch.ops import histogram as TH
from lightgbm_tpu_torch.ops import multival as TMV
from lightgbm_tpu_torch.ops import plane as tplane
from lightgbm_tpu_torch.ops import split as TS

from chip_smoke import make_wide_like
from test_multival import (make_codes_fixture, make_exclusive_highcard,
                           make_wide_sparse)


@pytest.fixture(autouse=True, scope="module")
def _no_aot_store():
    """Keep the JAX package's on-disk AOT executable store out of these
    tests, as tests/test_multival.py does."""
    from lightgbm_tpu.compile.manager import get_manager
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LGBM_TPU_AOT", "0")
        mp.setattr(get_manager(), "aot_enabled", False)
        yield


def _gh(rng, n, dyadic):
    if dyadic:    # every partial sum exact: any summation order agrees
        g = (rng.randint(-1024, 1025, n) / 2048.0).astype(np.float32)
        h = (rng.randint(0, 1025, n) / 4096.0).astype(np.float32)
    else:
        g = rng.randn(n).astype(np.float32)
        h = (rng.rand(n) + 0.5).astype(np.float32)
    return g, h


def _close(got, want, dyadic, dtype):
    if dyadic:
        np.testing.assert_array_equal(got, want)
    elif dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-2, atol=0.3)


# ---------------------------------------------------------------------------
# sparse input and the layout decision
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["csr", "csc"])
def test_sparse_dataset_byte_identical(fmt):
    """CSR/CSC input: bin mappers, bin matrix, EFB bundles and occupancy
    byte-identical to the JAX package's, and to the port's own dense
    path; bin_construct_sample_cnt < n exercises the sparse row sample."""
    X, _ = make_wide_like(3000, nvars=40)
    X = X.astype(np.float64)
    X = X.tocsc() if fmt == "csc" else X
    params = {"min_data_in_leaf": 5, "bin_construct_sample_cnt": 2000}
    jd = JDataset.from_matrix(X, JConfig.from_params(params))
    td = TDataset.from_matrix(X, TConfig.from_params(params))
    dense = TDataset.from_matrix(X.toarray(), TConfig.from_params(params))
    assert td.bins.dtype == jd.bins.dtype
    np.testing.assert_array_equal(td.bins, jd.bins)
    assert td.real_feature_index == jd.real_feature_index
    for a, b in zip(jd.bin_mappers, td.bin_mappers):
        da, db = a.to_dict(), b.to_dict()
        np.testing.assert_array_equal(np.asarray(da.pop("bin_upper_bound")),
                                      np.asarray(db.pop("bin_upper_bound")))
        assert da == db
    assert td.bundles.groups == jd.bundles.groups
    for k in ("group_of", "offset_of", "nslots_of", "skip_of",
              "group_num_bins"):
        np.testing.assert_array_equal(getattr(td.bundles, k),
                                      getattr(jd.bundles, k))
    jo, to = jd.occupancy, td.occupancy
    assert (to.num_groups, to.row_nnz_mean, to.row_nnz_max,
            to.sample_rows) == (jo.num_groups, jo.row_nnz_mean,
                                jo.row_nnz_max, jo.sample_rows)
    np.testing.assert_array_equal(to.default_code, jo.default_code)
    np.testing.assert_array_equal(to.group_density, jo.group_density)
    assert dense.bins.shape[0] == td.bins.shape[0]


def test_hist_layout_agrees_on_wide_shapes():
    for X in (make_wide_sparse(n=320)[0], make_wide_like(4000)[0]):
        p = {"min_data_in_leaf": 5}
        jd = JDataset.from_matrix(X, JConfig.from_params(p))
        td = TDataset.from_matrix(X, TConfig.from_params(p))
        for q in ({}, {"tpu_hist_layout": "planar"}):
            want = JH.hist_layout(JConfig.from_params(q), jd)
            assert TH.hist_layout(TConfig.from_params(q), td) == want
        assert TH.hist_layout(TConfig.from_params({}), td) == "multival"
        assert TH.hist_method(TConfig.from_params({}), td) \
            == "multival_pallas"


# ---------------------------------------------------------------------------
# host side of the layout
# ---------------------------------------------------------------------------

def test_rowwise_codes_and_tables_byte_identical():
    bins, gnb, default = make_codes_fixture(n=400, seed=3)
    jc, jl = JMV.build_rowwise_codes(bins, gnb, default)
    tc, tl = TMV.build_rowwise_codes(bins, gnb, default)
    np.testing.assert_array_equal(tc, jc)
    assert tuple(tl) == tuple(jl)
    for k in range(0, 300, 13):
        assert TMV.bucket_row_capacity(k) == JMV.bucket_row_capacity(k)
    np.testing.assert_array_equal(TMV.flat_offsets(gnb),
                                  JMV.flat_offsets(gnb))
    occ_t, occ_j = TMV.measure_occupancy(bins), JMV.measure_occupancy(bins)
    np.testing.assert_array_equal(occ_t.default_code, occ_j.default_code)
    assert occ_t.row_nnz_mean == occ_j.row_nnz_mean
    jt = JMV.group_tables(gnb, default)
    tt = TMV.group_tables(gnb, default)
    for a, b in zip(jt, tt):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    # group reconstruction on a dyadic flat histogram: exact either way
    g, h = _gh(np.random.RandomState(4), 400, True)
    jflat = JMV.histogram_multival_xla(jnp.asarray(jc), jnp.asarray(g),
                                       jnp.asarray(h), jl.total_bins)
    tflat = TMV.histogram_multival_scatter(
        torch.as_tensor(tc), torch.as_tensor(g), torch.as_tensor(h),
        tl.total_bins)
    np.testing.assert_array_equal(tflat.numpy(), np.asarray(jflat))
    np.testing.assert_array_equal(
        TMV.group_hist_from_flat(tflat, tt).numpy(),
        np.asarray(JMV.group_hist_from_flat(jflat, jt)))


# ---------------------------------------------------------------------------
# B5 / B6
# ---------------------------------------------------------------------------

WINDOWS = [(0, 512), (96, 130), (200, 1), (300, 0)]   # full, unaligned,
                                                      # one row, empty


def _states(codes, g, h):
    """The same planar state with slot planes in both packages."""
    n = codes.shape[0]
    kp = -(-codes.shape[1] // 8) * 8
    cols = np.random.RandomState(0).randint(0, 200, (n, 5)).astype(np.uint8)
    jl = jplane.make_layout(5, 8, n, with_label=True, with_score=True,
                            tile=128, mv_planes=kp)
    jmv = JMV.slot_major(jnp.asarray(codes))
    jd = jplane.build_data(jl, jplane.build_codes_planes(jnp.asarray(cols),
                                                         jl),
                           jnp.asarray(g), jnp.asarray(h),
                           label=jnp.asarray(g), score=jnp.asarray(h),
                           mv=jmv)
    tl = tplane.make_layout(5, 8, n, with_label=True, with_score=True,
                            tile=128, mv_planes=kp)
    t = torch.as_tensor
    td = tplane.build_data(tl, tplane.build_codes_planes(t(cols), tl),
                           t(g), t(h), label=t(g), score=t(h),
                           mv=TMV.slot_major(t(codes)))
    return jl, jd, tl, td


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_b5_plain_matches_pallas(dtype):
    bins, gnb, default = make_codes_fixture(n=512, seed=5)
    codes, lay = TMV.build_rowwise_codes(bins, gnb, default)
    rng = np.random.RandomState(6)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    for dyadic in (True, False):
        g, h = _gh(rng, 512, dyadic)
        jl, jd, tl, td = _states(codes, g, h)
        assert tuple(tl) == tuple(jl)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        for start, count in WINDOWS:
            want = np.asarray(JMV.histogram_multival_planar(
                jd, start, count, mv_start=jl.mv_start,
                mv_planes=jl.mv_planes, total_bins=lay.total_bins,
                grad_plane=jl.grad, dtype=jdt, rows_per_block=128,
                interpret=True))
            got = TMV.hist_multival_planar(
                td, start, count, mv_start=tl.mv_start,
                mv_planes=tl.mv_planes, total_bins=lay.total_bins,
                grad_plane=tl.grad, dtype=getattr(torch, dtype)).numpy()
            _close(got, want, dyadic, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_b6_plain_matches_pallas(dtype):
    bins, gnb, default = make_codes_fixture(n=512, seed=7)
    codes, lay = TMV.build_rowwise_codes(bins, gnb, default)
    rng = np.random.RandomState(8)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    for dyadic in (True, False):
        g, h = _gh(rng, 512, dyadic)
        for start, count in WINDOWS:
            sel = slice(start, start + max(count, 1))
            keep = np.arange(sel.stop - sel.start) < count   # empty: masked
            gw, hw = np.where(keep, g[sel], 0), np.where(keep, h[sel], 0)
            want = np.asarray(JMV.histogram_multival_pallas(
                JMV.slot_major(jnp.asarray(codes[sel])),
                JMV.gh_planes(jnp.asarray(gw), jnp.asarray(hw)),
                total_bins=lay.total_bins, dtype=jdt, rows_per_block=128,
                interpret=True))
            tc = torch.as_tensor(codes[start:start + count])
            got = TMV.hist_multival(
                TMV.slot_major(tc),
                TMV.gh_planes(torch.as_tensor(g[start:start + count]),
                              torch.as_tensor(h[start:start + count])),
                total_bins=lay.total_bins,
                dtype=getattr(torch, dtype)).numpy()
            _close(got, want, dyadic, dtype)


def _sequential_tiles(codes_sm: np.ndarray, g: np.ndarray, h: np.ndarray,
                      cells: int, tile: int) -> np.ndarray:
    """The CUDA kernels' association written out row by row in numpy:
    per tile of ``tile`` rows each cell summed in row order from 0, then
    the tiles' sums added in tile order to a zero histogram."""
    kp, c = codes_sm.shape
    out = np.zeros((cells, 2), np.float32)
    for t0 in range(0, c, tile):
        part = np.zeros((cells, 2), np.float32)
        for r in range(t0, min(c, t0 + tile)):
            for s in range(kp):
                code = codes_sm[s, r]
                if 0 <= code < cells:
                    part[code, 0] = np.float32(part[code, 0] + g[r])
                    part[code, 1] = np.float32(part[code, 1] + h[r])
        out = (out + part).astype(np.float32)
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", [1, 511, 512, 513, 1_537, 4_500])
def test_tiled_flat_association(rows, dtype):
    """B5/B6's plain versions sum in the kernels' association (MV_TILE =
    512 rows, each cell in row order, then the tiles in order) on random
    float grad/hess, bit for bit, on both entries."""
    rng = np.random.RandomState(rows)
    groups, k = 30, 12
    gnb = rng.randint(2, 7, groups)
    off = np.concatenate([[0], np.cumsum(gnb)[:-1]])
    total = int(gnb.sum())
    codes = np.full((rows, k), -1, np.int32)
    codes[:, 0] = total
    for r in range(rows):        # distinct groups per row, as real rows
        present = rng.choice(groups, rng.randint(0, k), replace=False)
        codes[r, 1:1 + len(present)] = off[present] + rng.randint(
            0, gnb[present])
    g = rng.randn(rows).astype(np.float32)
    h = rng.rand(rows).astype(np.float32)
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    gq = torch.from_numpy(g).to(tdt).float().numpy()
    hq = torch.from_numpy(h).to(tdt).float().numpy()
    sm = TMV.slot_major(torch.from_numpy(codes))
    want = _sequential_tiles(sm.numpy(), gq, hq, total + 1, TMV.MV_TILE)
    got6 = TMV.histogram_multival_plain(
        sm, TMV.gh_planes(torch.from_numpy(g), torch.from_numpy(h)),
        total_bins=total, dtype=tdt)
    np.testing.assert_array_equal(got6.numpy().view(np.int32),
                                  want.view(np.int32))
    lay = tplane.make_layout(2, 8, rows + 7, with_label=True,
                             with_score=True, mv_planes=sm.shape[0])
    pad = torch.full((sm.shape[0], 7), -1, dtype=torch.int32)
    data = tplane.build_data(
        lay, tplane.build_codes_planes(
            torch.zeros((rows + 7, 2), dtype=torch.int32), lay),
        torch.from_numpy(np.concatenate([np.zeros(7, np.float32), g])),
        torch.from_numpy(np.concatenate([np.zeros(7, np.float32), h])),
        mv=torch.cat([pad, sm], 1))
    got5 = TMV.histogram_multival_planar_plain(
        data, 7, rows, mv_start=lay.mv_start, mv_planes=lay.mv_planes,
        total_bins=total, grad_plane=lay.grad, dtype=tdt)
    np.testing.assert_array_equal(got5.numpy().view(np.int32),
                                  want.view(np.int32))


def test_leaf_histogram_multival_matches():
    bins, gnb, default = make_codes_fixture(n=256, seed=6)
    codes, lay = TMV.build_rowwise_codes(bins, gnb, default)
    g, h = _gh(np.random.RandomState(2), 256, True)
    perm = np.random.RandomState(7).permutation(256).astype(np.int32)
    want = np.asarray(JMV.leaf_histogram_multival(
        jnp.asarray(codes), jnp.asarray(perm), 32, 150, jnp.asarray(g),
        jnp.asarray(h), 256, lay.total_bins, use_pallas=False))
    for cap in (256, None):
        got = TMV.leaf_histogram_multival(
            torch.as_tensor(codes), torch.as_tensor(perm), 32, 150,
            torch.as_tensor(g), torch.as_tensor(h), cap, lay.total_bins)
        np.testing.assert_array_equal(got.numpy(), want)


def test_partition_keeps_slot_planes_aligned():
    """B2's contract at the wide-sparse plane count: every plane moves,
    so after a partition each lane's slot planes are still its row's
    codes; bit-exact against the JAX package's partition_ref."""
    X, _ = make_wide_like(3000, nvars=40)
    td = TDataset.from_matrix(X, TConfig.from_params({}))
    gnb = td.bundles.group_num_bins
    codes, lay = TMV.build_rowwise_codes(td.bins, gnb,
                                         td.occupancy.default_code)
    n, g = td.bins.shape
    gh = _gh(np.random.RandomState(1), n, False)
    kw = dict(with_label=True, with_score=True, mv_planes=lay.row_capacity)
    tl = tplane.make_layout(g, 8, n, **kw)
    jl = jplane.make_layout(g, 8, n, **kw)
    assert tuple(tl) == tuple(jl) and tl.num_planes >= 40
    t = torch.as_tensor
    data = tplane.build_data(tl, tplane.build_codes_planes(
        t(td.bins.astype(np.int32)), tl), t(gh[0]), t(gh[1]),
        label=t(gh[0]), score=t(gh[1]), mv=TMV.slot_major(t(codes)))
    jdata = jplane.build_data(
        jl, jplane.build_codes_planes(jnp.asarray(td.bins), jl),
        jnp.asarray(gh[0]), jnp.asarray(gh[1]), label=jnp.asarray(gh[0]),
        score=jnp.asarray(gh[1]), mv=JMV.slot_major(jnp.asarray(codes)))
    np.testing.assert_array_equal(data.numpy(), np.asarray(jdata))
    start, count = 123, 2500
    rs = tplane.route_scalars(tl, 7, 0, 0, miss_bin=-1)
    data, nl = tplane.partition(data, tl, start, count, rs)
    jr = jplane.route_scalars(jl, 7, 0, 0, miss_bin=-1)
    ref, jnl = jplane.partition_ref(jdata, jl, start, count, jr,
                                    cap=jl.num_lanes - jl.tile)
    assert 0 < int(nl) == int(jnl) < count
    np.testing.assert_array_equal(data.numpy(), np.asarray(ref))
    rowid = data[tl.rowid, :n].numpy()
    mv = data[tl.mv_start:tl.mv_start + tl.mv_planes, :n].numpy().T
    np.testing.assert_array_equal(mv, codes[rowid])


def test_fused_leaf_hist_multival_matches_scatter(monkeypatch):
    """The port's fused learner on the multival layout (forced on the
    CPU, as tests/test_multival.py:412 does for the JAX package): its
    leaf histogram matches the per-feature scatter oracle and the JAX
    package's _leaf_hist_multival in interpret mode."""
    from lightgbm_tpu.treelearner.fused import FusedSerialGrower as JFused
    from lightgbm_tpu_torch.objective.functions import create_objective
    from lightgbm_tpu_torch.treelearner.fused import FusedSerialGrower
    X, y = make_wide_sparse(n=512)
    p = {"min_data_in_leaf": 5, "tpu_hist_dtype": "float32",
         "objective": "binary", "device_type": "cpu"}
    cfg = TConfig.from_params(p)
    ds = TDataset.from_matrix(X, cfg, label=y)
    obj = create_objective(cfg)
    obj.init(ds.metadata, ds.num_data)
    monkeypatch.setattr(TH, "hist_method",
                        lambda config, dataset=None: "multival_pallas")
    fl = FusedSerialGrower(ds, cfg, obj, "cpu")
    assert fl.layout.mv_planes > 0 and fl.layout.mv_start % 8 == 0
    state = fl.init_persistent_state(np.zeros(ds.num_data, np.float32))
    g, h = _gh(np.random.RandomState(11), ds.num_data, True)
    tplane.set_gh(state, fl.layout, torch.as_tensor(g), torch.as_tensor(h))
    jcfg = JConfig.from_params({k: v for k, v in p.items()
                                if k != "device_type"})
    jds = JDataset.from_matrix(X, jcfg)
    monkeypatch.setattr(JH, "_use_tpu", lambda: True)
    jfl = JFused(jds, jcfg)
    monkeypatch.setattr(JH, "_use_tpu", lambda: False)
    assert jfl.layout.mv_planes == fl.layout.mv_planes
    jdata = jplane.build_data(jfl.layout, jfl.codes_planes(),
                              jnp.asarray(g), jnp.asarray(h),
                              mv=jfl._mv_dev)
    for start, count in ((0, 512), (64, 200)):
        got = fl._leaf_hist(state, start, count)
        want = np.asarray(jfl._leaf_hist_multival(
            jdata, jnp.int32(start), jnp.int32(count), interpret=True))
        np.testing.assert_array_equal(got.numpy(), want)
        sel = slice(start, start + count)
        oracle = JH.histogram_scatter(
            jnp.asarray(jds.feature_bins()[sel].astype(np.int32)),
            jnp.asarray(g[sel]), jnp.asarray(h[sel]), jds.max_num_bin)
        np.testing.assert_allclose(got.numpy(), np.asarray(oracle),
                                   rtol=1e-4, atol=1e-3)


# ---------------------------------------------------------------------------
# end to end: wide-sparse training with the multi-value layout forced
# ---------------------------------------------------------------------------

def _jax_fused_multival_hist(self, data, start, count, interpret=False):
    """The JAX fused learner's leaf histogram on the multi-value layout
    through the JAX package's own oracle, ``histogram_multival_xla``
    (one scatter over the window's lanes, in lane order), where the
    learner would run its Pallas kernel: on the CPU that kernel runs
    only in interpret mode, whose one-hot dot sums in an order of the
    CPU's matrix product, not in lane order. The rest is the learner's
    ``_leaf_hist_multival``."""
    from lightgbm_tpu.io.efb import per_feature_hist
    Ly = self.layout
    lanes = jnp.arange(data.shape[1], dtype=jnp.int32)
    valid = (lanes >= start) & (lanes < start + count)
    codes = data[Ly.mv_start:Ly.mv_start + Ly.mv_planes].T
    g = jnp.where(valid, jplane.get_f32(data, Ly.grad), 0.0)
    h = jnp.where(valid, jplane.get_f32(data, Ly.hess), 0.0)
    flat = JMV.histogram_multival_xla(codes, g, h, self._mv_total_bins)
    ghist = JMV.group_hist_from_flat(flat, self._mv_tables)
    if self._efb_hist is None:
        return ghist
    return per_feature_hist(ghist, self._efb_hist, flat[-1][0], flat[-1][1])


def force_multival(monkeypatch):
    """The multi-value layout forced in both packages on the CPU. The JAX
    fused learner then takes the oracle histogram above and the plain
    partition (``LGBM_TPU_PART=ref``; its Pallas partition runs only on
    the TPU), so each port learner meets its own JAX counterpart."""
    monkeypatch.setattr(JH, "hist_method",
                        lambda config, dataset=None: "multival_pallas")
    monkeypatch.setattr(TH, "hist_method",
                        lambda config, dataset=None: "multival_pallas")
    monkeypatch.setenv("LGBM_TPU_PART", "ref")
    monkeypatch.setattr(JF.FusedSerialGrower, "_leaf_hist_multival",
                        _jax_fused_multival_hist)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "host_loop"])
def test_wide_sparse_training_multival_forced(monkeypatch, fused):
    """The multi-value layout forced in both packages, CSR input on both
    sides: the port's fused (B5) or host-loop (B6) learner against the
    same JAX learner. Trees, split gains, leaf values and predictions
    are bit-equal (ROADMAP §C, C7: the fused split scan on wide-sparse
    data)."""
    X, y = make_wide_sparse(n=400)
    Xs = sp.csr_matrix(X)
    params = {"objective": "binary", "num_leaves": 15, "verbose": -1,
              "min_data_in_leaf": 5, "tpu_fused": fused}
    force_multival(monkeypatch)
    jb = jlgb.train(dict(params), jlgb.Dataset(Xs, label=y),
                    num_boost_round=5)
    tb = tlgb.train({**params, "device_type": "cpu"},
                    tlgb.Dataset(Xs, label=y), num_boost_round=5)
    gb = tb._gbdt
    assert (jb._gbdt._fused is not None) == fused
    if fused:
        assert gb._fused is not None and gb._fused.layout.mv_planes > 0
    else:
        assert gb.tree_learner is not None \
            and gb.tree_learner._mv_state is not None
    jt, tt = jb._gbdt._used_models(0, -1), gb.models
    assert len(jt) == len(tt) == 5
    for i, (a, b) in enumerate(zip(jt, tt)):
        k = a.num_leaves
        assert k == b.num_leaves, (i, k, b.num_leaves)
        for f in ("split_feature", "threshold", "decision_type",
                  "left_child", "right_child", "internal_count"):
            np.testing.assert_array_equal(getattr(a, f)[:k - 1],
                                          getattr(b, f)[:k - 1],
                                          err_msg=f"tree {i} {f}")
        np.testing.assert_array_equal(a.leaf_value[:k], b.leaf_value[:k])
        np.testing.assert_array_equal(b.split_gain[:k - 1],
                                      a.split_gain[:k - 1],
                                      err_msg=f"tree {i} split_gain")
    np.testing.assert_array_equal(tb.predict(Xs, raw_score=True),
                                  jb.predict(X, raw_score=True))
    np.testing.assert_array_equal(tb.predict(Xs), jb.predict(X))
    np.testing.assert_allclose(tb.predict(X), tb.predict(Xs), rtol=0,
                               atol=0)


def test_efb_hist_from_groups_matches_jax():
    """The fused learner's EFB most-frequent-bin reconstruction on the
    planar layout (``_hist_from_groups``: the leaf totals from group 0's
    bins, then ``per_feature_hist``) has the bits of the JAX fused
    learner's jitted ``_hist_from_groups`` on random group histograms of
    ``make_wide_sparse`` data: the totals sum in XLA's reduce order.
    Its features have fewer than 64 bins, so the split scan's reverse
    gains fuse 2·g·o first (``scan_sites``)."""
    import jax
    from lightgbm_tpu.treelearner.fused import FusedSerialGrower as JFused
    from lightgbm_tpu_torch.treelearner.fused import FusedSerialGrower
    X, y = make_wide_sparse(n=400)
    params = {"objective": "binary", "num_leaves": 15, "verbose": -1,
              "min_data_in_leaf": 5}
    jcfg = JConfig.from_params(params)
    tcfg = TConfig.from_params({**params, "device_type": "cpu"})
    jds = JDataset.from_matrix(sp.csr_matrix(X), jcfg, label=y)
    tds = TDataset.from_matrix(sp.csr_matrix(X), tcfg, label=y)
    jfl, fl = JFused(jds, jcfg), FusedSerialGrower(tds, tcfg, None, "cpu")
    assert fl._efb_hist is not None and not fl.meta.any_two_scan
    assert TS.scan_sites(fl.split_cfg, fl.max_num_bin)[1] == (False, False)
    want_fn = jax.jit(jfl._hist_from_groups)
    rng = np.random.RandomState(0)
    shape = (tds.bins.shape[1], tds.group_max_bins, 2)
    for _ in range(5):
        gh = (rng.randn(*shape) * rng.rand(*shape[:2], 1) * 10
              ).astype(np.float32)
        got = fl._hist_from_groups(torch.as_tensor(gh)).numpy()
        np.testing.assert_array_equal(got.view(np.int32),
                                      np.asarray(want_fn(jnp.asarray(gh)))
                                      .view(np.int32))


def test_group_hist_from_flat_matches_jax():
    """The default cell of each group, rebuilt from the leaf totals, has
    the bits of the JAX package's jitted ``group_hist_from_flat``: the
    sum of a group's other cells runs in XLA's reduce order."""
    import jax
    rng = np.random.RandomState(0)
    for g, bg in ((5, 7), (3, 40), (20, 255), (4, 33)):
        flat = rng.randn(g * bg + 1, 2).astype(np.float32)
        flat[-1] = flat[:-1].sum(0) * 1.01
        gnb = np.full(g, bg, np.int32)
        dc = rng.randint(0, bg, g).astype(np.int32)
        want = jax.jit(JMV.group_hist_from_flat)(
            jnp.asarray(flat), JMV.group_tables(gnb, dc))
        got = TMV.group_hist_from_flat(torch.as_tensor(flat),
                                       TMV.group_tables(gnb, dc, "cpu"))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "host_loop"])
def test_uint16_bundles_train_like_jax(fused):
    """EFB bundles past 256 bins (efb_max_bundle_bins, uint16 codes: the
    fused learner's 16-bit planar codes, the host loop's int32 bin
    matrix) train the JAX package's trees on both port learners."""
    X = make_exclusive_highcard(n=600)
    y = (X[:, :6].sum(1) + np.random.RandomState(0).randn(600) * 0.5
         > 1.0).astype(float)
    p = {"objective": "binary", "num_leaves": 15, "verbose": -1,
         "min_data_in_leaf": 5, "min_data_in_bin": 1,
         "efb_max_bundle_bins": 1024, "tpu_fused": fused}
    jb = jlgb.train(dict(p), jlgb.Dataset(X, label=y), num_boost_round=3)
    tb = tlgb.train({**p, "device_type": "cpu"}, tlgb.Dataset(X, label=y),
                    num_boost_round=3)
    assert tb._gbdt.train_data.bins.dtype == np.uint16
    for a, b in zip(jb._gbdt._used_models(0, -1), tb._gbdt.models):
        k = a.num_leaves
        assert k == b.num_leaves
        for f in ("split_feature", "threshold", "left_child", "right_child"):
            np.testing.assert_array_equal(getattr(a, f)[:k - 1],
                                          getattr(b, f)[:k - 1])
    np.testing.assert_allclose(tb.predict(X), jb.predict(X), atol=1e-5)
