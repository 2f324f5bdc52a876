"""The host-loop grower of the port against the JAX package's.

Row-major histograms (kernels B4 and B7: the port's plain versions
against histogram_radix_pallas / histogram_pallas in interpret mode),
the permutation partition (bit-exact), the extra-trees split scan, the
monotone helpers, and whole trainings through each option the fused
learner turns away: same data and params in both packages on the CPU,
trees structurally equal, leaf values within 1e-5, AUC within 1e-4. A
model trained by the JAX package's serial learner loads into the port
and predicts the same.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.ops import histogram as JH
from lightgbm_tpu.ops import partition as JP
from lightgbm_tpu.ops import split as JS
from lightgbm_tpu.treelearner import monotone as JM
from lightgbm_tpu_torch.ops import histogram as TH
from lightgbm_tpu_torch.ops import partition as TP
from lightgbm_tpu_torch.ops import split as TS
from lightgbm_tpu_torch.treelearner import monotone as TM

from test_torch_train import (BIT_GATES, TREE_FIELDS, _data,
                              assert_bit_equal_training)


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


def _gh(rng, n, dyadic):
    if dyadic:    # every partial sum exact: any summation order agrees
        g = (rng.randint(-1024, 1025, n) / 2048.0).astype(np.float32)
        h = (rng.randint(0, 1025, n) / 4096.0).astype(np.float32)
    else:
        g = rng.randn(n).astype(np.float32)
        h = rng.rand(n).astype(np.float32)
    return g, h


# ---------------------------------------------------------------------------
# B4 / B7: row-major histograms
# ---------------------------------------------------------------------------

# windows around the tile rule's breakpoints: 1 row, just under, at and
# just over the minimum tile, and several tiles
RM_ROWS = [1, TH.RM_MIN_TILE - 1, TH.RM_MIN_TILE + 1, 3 * TH.RM_MIN_TILE + 56]


@pytest.mark.parametrize("rows", RM_ROWS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("num_bins", [255, 64, 16])
def test_hist_radix_plain_matches_pallas(num_bins, dtype, rows):
    """B4's plain version against histogram_radix_pallas (interpret):
    exact on dyadic grad/hess, else rtol 1e-5 (float32) or the bf16
    tolerance of tests/test_kernels.py."""
    rng = np.random.RandomState(num_bins)
    r, f = rows, 11
    bins = rng.randint(0, num_bins, size=(r, f)).astype(np.uint8)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    for dyadic in (True, False):
        g, h = _gh(rng, r, dyadic)
        want = np.asarray(JH.histogram_radix_pallas(
            jnp.asarray(bins), jnp.asarray(g), jnp.asarray(h), num_bins,
            dtype=jdt, rows_per_block=256, interpret=True))
        got = TH.hist_radix(torch.as_tensor(bins), torch.as_tensor(g),
                            torch.as_tensor(h), num_bins,
                            dtype=getattr(torch, dtype)).numpy()
        if dyadic:
            np.testing.assert_array_equal(got, want)
        elif dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-2, atol=0.3)


@pytest.mark.parametrize("rows", RM_ROWS)
def test_hist_masked_plain_matches_pallas(rows):
    """B7's plain version against histogram_pallas (interpret)."""
    rng = np.random.RandomState(7)
    n, f, nb = rows, 5, 32
    bins = rng.randint(0, nb, size=(n, f)).astype(np.uint8)
    for dyadic in (True, False):
        g, h = _gh(rng, n, dyadic)
        want = np.asarray(JH.histogram_pallas(
            jnp.asarray(bins), jnp.asarray(g), jnp.asarray(h), nb,
            rows_per_block=256, interpret=True))
        got = TH.hist_masked(torch.as_tensor(bins), torch.as_tensor(g),
                             torch.as_tensor(h), nb).numpy()
        if dyadic:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("c,f,nb,tile", [
    (0, 28, 255, TH.RM_MIN_TILE),                # empty window
    (1, 28, 255, TH.RM_MIN_TILE),
    (16_384, 28, 255, TH.RM_MIN_TILE),           # (b)'s mean smaller child
    (2_000_000, 28, 255, 7576),                  # the root: one tile a block
    (2_000_000, 40, 255, 7576),
    (100_000, 28, 65_534, 50_000),               # wide bins: 2 tiles
    (100_000, 2, 60_000, 2942)])                 # 34 tiles of partials
def test_rowmajor_tile_rule(c, f, nb, tile):
    """The row-major tile rule is a function of the shapes alone: fixed
    values, ceil(c / 264) rows at large windows, the minimum tile at
    small ones, and partials capped; B1's tile stays HIST_TILE."""
    assert TH.rowmajor_tile(c, f, nb) == tile
    ntiles = -(-c // tile)
    assert ntiles <= TH.RM_SMS * TH.RM_BLOCKS_PER_SM
    assert ntiles * f * nb <= max(TH.RM_MAX_PARTIAL_CELLS, f * nb)
    assert TH.HIST_TILE == 2048
    import inspect
    assert inspect.signature(TH.tiled_scatter).parameters["tile"].default \
        == TH.HIST_TILE


def _sequential_tiles(bins, g, h, nb, tile):
    """The kernel's association written out: each cell summed in row
    order inside a tile (float32), the tiles added in order from 0."""
    c, f = bins.shape
    out = np.zeros((f, nb, 2), np.float32)
    for t0 in range(0, c, tile):
        part = np.zeros((f, nb, 2), np.float32)
        for r in range(t0, min(c, t0 + tile)):
            for j in range(f):
                b = bins[r, j]
                if 0 <= b < nb:
                    part[j, b, 0] = np.float32(part[j, b, 0] + g[r])
                    part[j, b, 1] = np.float32(part[j, b, 1] + h[r])
        out = (out + part).astype(np.float32)
    return out


@pytest.mark.parametrize("c,f,nb", [(1, 3, 16), (2_047, 2, 16), (2_049, 2, 16),
                                    (6_200, 2, 7), (20_000, 8, 65_000)])
def test_rowmajor_plain_association(c, f, nb):
    """On random (non-dyadic) float32 g/h, B4's and B7's plain versions
    equal the kernel's association written out, bit for bit (codes
    outside [0, nb) add nothing), float32 and bfloat16-rounded."""
    rng = np.random.RandomState(c + nb)
    bins = rng.randint(-1, nb + 2, size=(c, f)).astype(np.int32)
    g = rng.randn(c).astype(np.float32)
    h = rng.rand(c).astype(np.float32)
    tile = TH.rowmajor_tile(c, f, nb)
    tb, tg, th = (torch.as_tensor(x) for x in (bins, g, h))
    want = _sequential_tiles(bins, g, h, nb, tile)
    np.testing.assert_array_equal(
        TH.histogram_radix_plain(tb, tg, th, nb).numpy(), want)
    np.testing.assert_array_equal(
        TH.histogram_masked_plain(tb, tg, th, nb).numpy(), want)
    gb, hb = (TH.round_bf16(x).numpy() for x in (tg, th))
    np.testing.assert_array_equal(
        TH.histogram_radix_plain(tb, tg, th, nb, torch.bfloat16).numpy(),
        _sequential_tiles(bins, gb, hb, nb, tile))


def test_histogram_dispatch_and_leaf_gather():
    """``histogram`` method names and the leaf gather helpers against
    the JAX package's (leaf_window / gather_leaf_rows / leaf_histogram
    with a capacity that clamps the read start)."""
    rng = np.random.RandomState(3)
    n, f, nb = 900, 4, 20
    bins = rng.randint(0, nb, size=(n, f)).astype(np.uint8)
    g, h = _gh(rng, n, True)
    perm = rng.permutation(n).astype(np.int32)
    for start, count, cap in ((100, 300, 512), (800, 100, 256),
                              (0, 900, 1024)):
        jr, jv, js = JH.leaf_window(jnp.asarray(perm), start, count, cap)
        tr, tv, ts = TH.leaf_window(torch.as_tensor(perm), start, count, cap)
        assert int(js) == ts
        np.testing.assert_array_equal(np.asarray(jr), tr.numpy())
        np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
        want = np.asarray(JH.leaf_histogram(
            jnp.asarray(bins), jnp.asarray(perm), start, count,
            jnp.asarray(g), jnp.asarray(h), cap, nb))
        for c in (cap, None):
            got = TH.leaf_histogram(
                torch.as_tensor(bins), torch.as_tensor(perm), start, count,
                torch.as_tensor(g), torch.as_tensor(h), c, nb).numpy()
            np.testing.assert_array_equal(got, want)
    tb, tg, th = (torch.as_tensor(x) for x in (bins, g, h))
    scatter = TH.histogram(tb, tg, th, nb, method="scatter")
    for m in (None, "radix_pallas", "pallas"):
        torch.testing.assert_close(TH.histogram(tb, tg, th, nb, method=m),
                                   scatter, rtol=0, atol=0)
    with pytest.raises(ValueError, match="multival"):
        TH.histogram(tb, tg, th, nb, method="multival_pallas")


# ---------------------------------------------------------------------------
# the permutation partition
# ---------------------------------------------------------------------------

_EFB = [np.array([0, 1, 1, 2]), np.array([0, 0, 40, 0]),
        np.array([250, 39, 90, 250]), np.array([250, 7, 7, 250])]


@pytest.mark.parametrize("name,start,count,kw", [
    ("numerical", 0, 1000, dict(feature=0, threshold=120, default_left=False,
                                miss_bin=-1)),
    ("missing_default_left", 37, 600,
     dict(feature=1, threshold=60, default_left=True, miss_bin=249)),
    ("missing_default_right", 400, 555,
     dict(feature=1, threshold=60, default_left=False, miss_bin=30)),
    ("efb_routed", 10, 900, dict(feature=2, threshold=20, default_left=True,
                                 miss_bin=4, efb=True)),
    ("all_left", 5, 700, dict(feature=3, threshold=255, default_left=False,
                              miss_bin=-1)),
    ("all_right", 5, 700, dict(feature=3, threshold=-1, default_left=False,
                               miss_bin=-1)),
    ("one_row", 999, 1, dict(feature=0, threshold=128, default_left=False,
                             miss_bin=-1)),
])
def test_partition_leaf_bit_exact(name, start, count, kw):
    kw = dict(kw)
    efb = kw.pop("efb", False)
    rng = np.random.RandomState(len(name))
    n = 1000
    bins = rng.randint(0, 250, size=(n, 4)).astype(np.uint8)
    bins[rng.rand(n) < 0.1, 1] = 249
    perm = rng.permutation(n).astype(np.int32)
    cap = JP.next_capacity(count)
    jefb = tuple(jnp.asarray(a, jnp.int32) for a in _EFB) if efb else None
    tefb = tuple(torch.as_tensor(a, dtype=torch.int32) for a in _EFB) \
        if efb else None
    jperm, jleft = JP.partition_leaf(
        jnp.asarray(bins), jnp.asarray(perm), start, count, kw["feature"],
        kw["threshold"], kw["default_left"], kw["miss_bin"], False,
        jnp.zeros(1, jnp.uint32), cap, efb=jefb)
    for c in (cap, None):
        tperm, tleft = TP.partition_leaf(
            torch.as_tensor(bins), torch.as_tensor(perm), start, count,
            kw["feature"], kw["threshold"], kw["default_left"],
            kw["miss_bin"], False, capacity=c, efb=tefb)
        assert tleft == int(jleft)
        np.testing.assert_array_equal(tperm.numpy(), np.asarray(jperm))
    if name == "all_left":
        assert tleft == count
    if name == "all_right":
        assert tleft == 0


def test_partition_helpers_match():
    x = np.random.RandomState(0).randint(0, 5, 5000).astype(np.int32)
    np.testing.assert_array_equal(
        TP.cumsum_1d(torch.as_tensor(x)).numpy(),
        np.asarray(JP.cumsum_1d(jnp.asarray(x))))
    for c in (0, 1, 256, 257, 100000):
        assert TP.next_capacity(c) == JP.next_capacity(c)
    assert TP.capacity_ladder(5000, 256, 4) == \
        JP.capacity_ladder(5000, 256, 4)


# ---------------------------------------------------------------------------
# extra-trees split scan and the monotone helpers
# ---------------------------------------------------------------------------

def test_extra_trees_scan_matches():
    rng = np.random.RandomState(5)
    f, b = 6, 32
    hist = np.stack([rng.randn(f, b), rng.rand(f, b) + 0.1],
                    axis=-1).astype(np.float32)
    nb = [32, 20, 3, 32, 16, 2]
    for i, k in enumerate(nb):
        hist[i, k:] = 0
    meta = dict(num_bin=nb, missing_type=[0, 2, 0, 1, 0, 0],
                default_bin=[0, 0, 0, 5, 0, 0],
                is_categorical=[False] * f, monotone=[0] * f,
                penalty=[1.0] * f)
    cfg = dict(extra_trees=True, min_data_in_leaf=1,
               min_sum_hessian_in_leaf=0.0)
    rand = (rng.randint(0, 1 << 30, f) % np.maximum(np.asarray(nb) - 2, 1)
            ).astype(np.int32)
    sums = (float(hist[0, :, 0].sum()), float(hist[0, :, 1].sum()))
    jres = JS.best_split(jnp.asarray(hist), JS.FeatureMeta.build(**meta),
                         JS.SplitConfig(**cfg), sums[0], sums[1], 2000, 0.0,
                         -np.inf, np.inf, rand_thresholds=jnp.asarray(rand))
    t32 = lambda x: torch.tensor(x, dtype=torch.float32)  # noqa: E731
    tres = TS.best_split(torch.as_tensor(hist), TS.FeatureMeta.build(**meta),
                         TS.SplitConfig(**cfg), t32(sums[0]), t32(sums[1]),
                         torch.tensor(2000, dtype=torch.int32), t32(0.0),
                         t32(-np.inf), t32(np.inf),
                         rand_thresholds=torch.as_tensor(rand))
    found = np.asarray(jres["found"])
    np.testing.assert_array_equal(tres["found"].numpy(), found)
    np.testing.assert_array_equal(tres["threshold"].numpy()[found],
                                  np.asarray(jres["threshold"])[found])
    np.testing.assert_allclose(tres["gain"].numpy()[found],
                               np.asarray(jres["gain"])[found], rtol=1e-5)
    assert int(tres["best_feature"]) == int(jres["best_feature"])


def test_monotone_helpers_match():
    for depth in range(6):
        for pen in (0.0, 0.5, 1.0, 2.5, 10.0):
            assert TM.monotone_penalty_factor(depth, pen) == \
                JM.monotone_penalty_factor(depth, pen)


# ---------------------------------------------------------------------------
# end-to-end gates on the host-loop grower
# ---------------------------------------------------------------------------

BASE = {"objective": "binary", "num_leaves": 15, "metric": "auc",
        "verbose": -1, "device_type": "cpu"}


def _train_both(extra, rounds=3, seed=0):
    X, y = _data(seed=seed, n=2000)
    Xv, yv = _data(seed=seed + 1, n=600)
    out = {}
    for name, lib in (("jax", jlgb), ("torch", tlgb)):
        ds = lib.Dataset(X, label=y)
        ev = {}
        b = lib.train({**BASE, **extra}, ds, num_boost_round=rounds,
                      valid_sets=[lib.Dataset(Xv, label=yv, reference=ds)],
                      valid_names=["valid"], evals_result=ev,
                      verbose_eval=False)
        out[name] = (b, ev)
    return out, X, Xv


@pytest.mark.parametrize("extra", [
    {"tpu_fused": False},
    {"extra_trees": True},
    {"interaction_constraints": [[0, 1], [2, 3, 4, 5]]},
    {"monotone_constraints": [1, 0, 0, -1, 0, 0],
     "monotone_constraints_method": "intermediate"},
    {"cegb_penalty_split": 0.01, "cegb_penalty_feature_coupled":
     [5.0, 0, 0, 0, 0, 0]},
    {"monotone_constraints": [1, 0, 0, 0, 0, 0], "monotone_penalty": 1.5},
], ids=["tpu_fused_false", "extra_trees", "interaction", "intermediate",
        "cegb", "monotone_penalty"])
def test_host_loop_gate(extra):
    out, X, Xv = _train_both(extra)
    jb, jev = out["jax"]
    tb, tev = out["torch"]
    assert tb._gbdt._fused is None and tb._gbdt.tree_learner is not None
    jt, tt = jb._gbdt._used_models(0, -1), tb._gbdt.models
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
    np.testing.assert_allclose(tev["valid"]["auc"], jev["valid"]["auc"],
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(tb.predict(Xv), jb.predict(Xv), atol=1e-5)


@pytest.mark.parametrize("case", sorted(BIT_GATES) + ["intermediate"])
def test_host_loop_bit_equal(case):
    """The bit-equality gates of test_torch_train.py on the host-loop
    grower, plus the intermediate monotone case [1, -1, 0, 0, 0, 0]
    whose near-tie flipped before the gain's fused multiply-add."""
    extra, rounds = BIT_GATES.get(case, (
        {"monotone_constraints": [1, -1, 0, 0, 0, 0],
         "monotone_constraints_method": "intermediate"}, 3))
    _, tb = assert_bit_equal_training({**extra, "tpu_fused": False}, rounds)
    assert tb._gbdt._fused is None


def test_serial_model_loads_into_the_port():
    """A model trained by the JAX package's serial learner carries
    across as model text and as tree arrays, and predicts the same."""
    from lightgbm_tpu_torch.convert import booster_from_jax_arrays
    X, y = _data(seed=4, n=1500)
    jb = jlgb.train({**BASE, "tpu_fused": False, "extra_trees": True},
                    jlgb.Dataset(X, label=y), num_boost_round=4)
    text = jb.model_to_string()
    loaded = tlgb.Booster(params={"device_type": "cpu"}, model_str=text)
    np.testing.assert_allclose(loaded.predict(X), jb.predict(X), atol=1e-6)
    assert loaded.model_to_string() == \
        jlgb.Booster(model_str=text).model_to_string()
    trees = [{f: getattr(t, f)[:t.num_leaves if f.startswith("leaf_")
                                else t.num_leaves - 1]
              for f in TREE_FIELDS} | {"num_leaves": t.num_leaves}
             for t in jb._gbdt._used_models(0, -1)]
    b = booster_from_jax_arrays(trees, max_feature_idx=5,
                                params={"device_type": "cpu"})
    np.testing.assert_allclose(b.predict(X), jb.predict(X), atol=1e-6)


def test_host_loop_options_and_learner_choice(capsys):
    """tree_learner=data on one device warns and takes the serial
    grower; the pool-less mode, max_depth and feature sampling keep
    their limits; the serial grower counts its host reads."""
    X, y = _data(n=800)
    b = tlgb.train({**BASE, "verbose": 0, "tree_learner": "data",
                    "max_depth": 3,
                    "feature_fraction": 0.7, "feature_fraction_bynode": 0.8,
                    "histogram_pool_size": 0.001}, tlgb.Dataset(X, label=y),
                   num_boost_round=3, verbose_eval=False)
    out = capsys.readouterr()
    assert "using serial tree learner" in out.out + out.err
    tl = b._gbdt.tree_learner
    assert tl is not None and not tl._keep_hists
    assert tl.syncs > 0
    for t in b._gbdt.models:
        assert t.leaf_depth[:t.num_leaves].max() <= 3
