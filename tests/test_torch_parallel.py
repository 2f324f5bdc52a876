"""The port's multi-device learners against the JAX package's, on the
CPU: network.py's collectives, io/distributed.py's bin finding and
treelearner/parallel.py's data-, voting- and feature-parallel learners.

The port runs one process per device. Each case spawns D ranks with
``torch.multiprocessing`` from the module-level ``_rank_main``; they
join one gloo group through a ``FileStore`` under ``tmp_path`` (no
ports, so xdist workers cannot collide), train with
``device_type="cpu"`` and write their model text and raw predictions
there. The JAX side runs in this process on the 8 virtual CPU devices
of tests/conftest.py, its data axis cut to D by ``tpu_mesh_shape``.
Trees, model text and raw predictions are held bit for bit, and every
rank's model equals every other's. Windows stay within one histogram
tile (2,048 rows per rank) so the plain histograms sum in the JAX
package's row order (ROADMAP §C, the row-major tile rule).

Module-level code imports no JAX: the spawned ranks import this module.
"""
import os
import pickle

import numpy as np
import pytest
import torch

PARAMS = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 20,
          "learning_rate": 0.1, "verbose": -1, "max_bin": 63}
ROUNDS = 5


def make_data(n=4001, f=8, seed=0, sort_labels=False):
    """The binary task of tests/test_fused_parallel.py (``_make``)."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f).astype(np.float32)
    y = (X[:, 0] + 0.4 * X[:, 1] ** 2 + 0.2 * rng.randn(n) > 0.3)
    y = y.astype(np.float32)
    if sort_labels:
        # the first ranks hold only one class (non-IID row order)
        order = np.argsort(y, kind="stable")
        X, y = X[order], y[order]
    return X, y


def make_bundled(n=4000, seed=2):
    """Mutually exclusive sparse columns that EFB bundles
    (tests/test_fused_parallel.py ``_make_bundled``)."""
    rng = np.random.RandomState(seed)
    X = np.zeros((n, 9), dtype=np.float32)
    X[:, 0] = rng.randn(n)
    X[:, 1] = rng.randn(n)
    grp = rng.randint(0, 3, n)
    for g in range(3):
        rows = grp == g
        X[rows, 2 + g] = rng.rand(rows.sum()) + 0.5
    m = rng.rand(n) < 0.5
    X[m, 5] = rng.rand(m.sum()) + 0.5
    X[~m, 6] = rng.rand((~m).sum()) + 0.5
    X[:100, 7] = 1.0
    X[2000:, 8] = rng.rand(n - 2000)
    y = (X[:, 0] + X[:, 2] - X[:, 3] + 0.5 * X[:, 5]
         + 0.2 * rng.randn(n) > 0.3).astype(np.float32)
    return X, y


# -- the ranks ------------------------------------------------------------
def _rank_main(rank, world, store_path, out_dir, job, args):
    """One rank: join the gloo group through the file store, run
    ``job`` and pickle its result to ``out_dir/<rank>.pkl``."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    try:
        out = _JOBS[job](rank, world, *args)
        with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as fh:
            pickle.dump(out, fh)
    finally:
        dist.destroy_process_group()


def run_ranks(tmp_path, world, job, *args):
    """Spawn ``world`` ranks running ``job``; their results in rank
    order."""
    out_dir = tmp_path / f"out_{job}_{world}"
    out_dir.mkdir()
    store = str(tmp_path / f"store_{job}_{world}")
    torch.multiprocessing.spawn(
        _rank_main, args=(world, store, str(out_dir), job, args),
        nprocs=world, join=True)
    res = []
    for r in range(world):
        with open(out_dir / f"{r}.pkl", "rb") as fh:
            res.append(pickle.load(fh))
    return res


def _job_collectives(rank, world, xs):
    from lightgbm_tpu_torch import network
    x = torch.as_tensor(xs[rank])
    xi = torch.as_tensor(xs[rank].view(np.int32) & 0xFFFF)
    return dict(psum=network.psum(x).numpy(), pmax=network.pmax(x).numpy(),
                gather=network.all_gather(x).numpy(),
                psum_int=network.psum(xi).numpy(),
                stats=dict(network.STATS))


def _job_train(rank, world, params, X, y, rounds, valid):
    """Train on the rank: (model text, raw predictions, learner class,
    persistent path, collective stats)."""
    import lightgbm_tpu_torch as tlgb
    from lightgbm_tpu_torch import network
    network.reset_stats()
    ds = tlgb.Dataset(X, label=y)
    bst = tlgb.train({**params, "device_type": "cpu"}, ds,
                     num_boost_round=rounds, keep_training_booster=True)
    gb = bst._gbdt
    learner = type(gb._fused if gb._fused is not None else gb.tree_learner)
    raw = bst.predict(valid, raw_score=True)
    score = gb.get_training_score().numpy().copy()
    return dict(text=bst.model_to_string(), raw=raw, score=score,
                learner=learner.__name__, persist=bool(gb._fused_persist),
                stats=dict(network.STATS))


def _job_voting_traffic(rank, world, params, X, y):
    """The bytes of one root-histogram reduction of the voting learner,
    and the histogram it returns."""
    from lightgbm_tpu_torch import network
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.io.dataset import BinnedDataset
    from lightgbm_tpu_torch.treelearner.parallel import (
        VotingParallelTreeGrower)
    cfg = Config.from_params({**params, "device_type": "cpu"})
    ds = BinnedDataset.from_matrix(X, cfg, label=y)
    g = VotingParallelTreeGrower(ds, cfg, "cpu")
    rps = g.rows_per_shard
    perm = torch.arange(rps)
    grad = torch.zeros(rps)
    hess = torch.ones(rps)
    total, count = int(g._shard_valid_rows.sum()), int(
        g._shard_valid_rows[rank])
    network.reset_stats()
    hist, sums = g._hist_call(total, perm, 0, count, grad, hess, sums=True)
    stats = dict(network.STATS)
    network.reset_stats()
    child = g._hist_call(total, perm, 0, count, grad, hess)
    return dict(hist=hist.numpy(), sums=sums.numpy(), stats=stats,
                child_hist=child.numpy(), child_stats=dict(network.STATS),
                num_bin=g.max_num_bin)


def mapper_keys(mappers):
    """The mappers as JSON text (NaN bounds compare equal as text)."""
    import json
    return [json.dumps(m.to_dict(), sort_keys=True, default=float)
            for m in mappers]


def _job_bins(rank, world, params, X):
    """The bin mappers of a num_machines dataset, built over the group."""
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.io.dataset import BinnedDataset
    cfg = Config.from_params({**params, "device_type": "cpu"})
    ds = BinnedDataset.from_matrix(X, cfg, label=np.zeros(X.shape[0]))
    return mapper_keys(ds.bin_mappers), ds.bins


def _job_resume(rank, world, params, X, y, ckpt_dir):
    """Half the rounds into a checkpoint directory every rank shares (rank
    0 writes, robust/checkpoint.py), all of them resumed from it, and
    all of them straight: (resumed text, straight text, files)."""
    import lightgbm_tpu_torch as tlgb

    def run(rounds, d):
        return tlgb.train({**params, "device_type": "cpu",
                           "checkpoint_interval": 1},
                          tlgb.Dataset(X, label=y), num_boost_round=rounds,
                          verbose_eval=False, checkpoint_dir=d
                          ).model_to_string()
    run(ROUNDS // 2, ckpt_dir)
    resumed = run(ROUNDS, ckpt_dir)
    return resumed, run(ROUNDS, None), sorted(os.listdir(ckpt_dir))


_JOBS = {"collectives": _job_collectives, "train": _job_train,
         "voting_traffic": _job_voting_traffic, "bins": _job_bins,
         "resume": _job_resume}


# -- the JAX side ---------------------------------------------------------
@pytest.fixture(autouse=True, scope="module")
def _no_aot_store():
    """Keep the JAX package's on-disk AOT executable store out of these
    tests, as tests/test_multival.py does."""
    from lightgbm_tpu.compile.manager import get_manager
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LGBM_TPU_AOT", "0")
        mp.setattr(get_manager(), "aot_enabled", False)
        yield


def jax_train(params, X, y, rounds, valid, world):
    """The JAX package's learner over ``world`` virtual devices: (model
    text, raw predictions, learner class name, training scores)."""
    import lightgbm_tpu as jlgb
    bst = jlgb.train({**params, "tpu_mesh_shape": [world]},
                     jlgb.Dataset(X, label=y), num_boost_round=rounds,
                     keep_training_booster=True, verbose_eval=False)
    gb = bst._gbdt
    learner = gb._fused if gb._fused is not None else gb.tree_learner
    return (bst.model_to_string(), bst.predict(valid, raw_score=True),
            type(learner).__name__, np.asarray(gb.get_training_score()))


def _trees(text):
    """The Tree= blocks of a model text (the parameter echo and the
    feature importances differ between the packages' keys)."""
    return text[text.index("Tree=0"):text.index("end of trees")]


def assert_parallel_equal(tmp_path, params, world, X, y, learner,
                          rounds=ROUNDS, persist=None):
    """The port's ranks against the JAX package's learner: every rank's
    model, predictions and training scores (gathered from the ranks'
    states on the persistent path) equal, and equal to the JAX
    package's bit for bit."""
    valid = X[:500]
    res = run_ranks(tmp_path, world, "train", params, X, y, rounds, valid)
    for r in res[1:]:
        assert r["text"] == res[0]["text"]
        np.testing.assert_array_equal(r["raw"], res[0]["raw"])
        np.testing.assert_array_equal(r["score"], res[0]["score"])
    assert res[0]["learner"] == learner
    if persist is not None:
        assert res[0]["persist"] == persist
    assert res[0]["stats"]["calls"] > 0
    jtext, jraw, jlearner, jscore = jax_train(params, X, y, rounds, valid,
                                              world)
    assert jlearner == learner
    assert _trees(res[0]["text"]) == _trees(jtext)
    np.testing.assert_array_equal(res[0]["raw"].view(np.int64),
                                  np.asarray(jraw).view(np.int64))
    np.testing.assert_array_equal(
        res[0]["score"].reshape(jscore.shape).view(np.int32),
        jscore.astype(np.float32).view(np.int32))
    return res


# -- tier 1 -----------------------------------------------------------------
@pytest.mark.parametrize("world", [2, 4])
def test_collectives_match_jax(tmp_path, world):
    """psum (floats: rank order onto +0.0, so -0.0 sums to +0.0),
    integer psum, pmax and all_gather equal the JAX package's
    collectives under shard_map bit for bit, on every rank."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from lightgbm_tpu.utils.compat import shard_map
    rng = np.random.RandomState(world)
    xs = (rng.randn(world, 512)
          * 10.0 ** rng.uniform(-3, 3, (world, 512))).astype(np.float32)
    xs[:, :8] = -0.0
    xs[0, 8:16] = 0.0
    xs[1, 16:24] = -xs[0, 16:24]
    res = run_ranks(tmp_path, world, "collectives", xs)
    mesh = Mesh(np.asarray(jax.devices()[:world]), ("data",))

    def sm(f):
        return jax.jit(shard_map(f, mesh=mesh, in_specs=P("data", None),
                                 out_specs=P(), check_vma=False))
    want = dict(
        psum=np.asarray(sm(lambda a: jax.lax.psum(a[0], "data"))(xs)),
        pmax=np.asarray(sm(lambda a: jax.lax.pmax(a[0], "data"))(xs)),
        gather=np.asarray(sm(lambda a: jax.lax.all_gather(a[0], "data"))(
            xs)),
        psum_int=np.asarray(sm(lambda a: jax.lax.psum(a[0], "data"))(
            jnp.asarray(xs.view(np.int32) & 0xFFFF))))
    for r in res:
        for k, v in want.items():
            np.testing.assert_array_equal(r[k].view(np.int32),
                                          v.view(np.int32), err_msg=k)
    # a sum of -0.0s is +0.0, as in the JAX psum
    assert not np.signbit(res[0]["psum"][:8]).any()
    # one float psum = one gather; four collectives in all
    assert res[0]["stats"]["calls"] == 4


@pytest.mark.parametrize("world,n", [(2, 4001), (4, 6001)])
def test_fused_data_parallel_bit_equal(tmp_path, world, n):
    """The persistent fused data-parallel learner (uneven shards: the
    last rank's pad rows never reach a histogram, a count or a score)
    equals the JAX FusedDataParallelGrower bit for bit."""
    X, y = make_data(n=n)
    assert_parallel_equal(tmp_path, {**PARAMS, "tree_learner": "data"},
                          world, X, y, "FusedDataParallelGrower",
                          persist=True)


def test_fused_data_parallel_bagging_bit_equal(tmp_path):
    """The per-tree fused path under bagging: each rank's local
    permutation holds its bag rows first."""
    X, y = make_data()
    params = {**PARAMS, "tree_learner": "data", "bagging_fraction": 0.8,
              "bagging_freq": 1, "bagging_seed": 3}
    assert_parallel_equal(tmp_path, params, 2, X, y,
                          "FusedDataParallelGrower", persist=False)


def test_host_loop_data_parallel_bit_equal(tmp_path):
    """The host-loop data-parallel learner (``tpu_fused=false``)."""
    X, y = make_data()
    params = {**PARAMS, "tree_learner": "data", "tpu_fused": False}
    assert_parallel_equal(tmp_path, params, 2, X, y,
                          "DataParallelTreeGrower")


def test_feature_parallel_bit_equal(tmp_path):
    """Feature-parallel: each rank scans its share of the features; the
    trees are the port's serial learner's and the JAX package's
    feature-parallel learner's."""
    import lightgbm_tpu_torch as tlgb
    # every rank holds every row: one histogram tile
    X, y = make_data(n=2000)
    params = {**PARAMS, "tree_learner": "feature"}
    res = assert_parallel_equal(tmp_path, params, 2, X, y,
                                "FeatureParallelTreeGrower")
    serial = tlgb.train({**PARAMS, "tpu_fused": False, "device_type": "cpu"},
                        tlgb.Dataset(X, label=y), num_boost_round=ROUNDS)
    assert _trees(serial.model_to_string()) == _trees(res[0]["text"])


def test_voting_parallel_bit_equal(tmp_path):
    """Voting with top_k 2 over 8 features: 4 histograms reduced per
    leaf."""
    X, y = make_data()
    params = {**PARAMS, "tree_learner": "voting", "top_k": 2}
    assert_parallel_equal(tmp_path, params, 2, X, y,
                          "VotingParallelTreeGrower")


def test_voting_reduces_traffic(tmp_path):
    """PV-Tree's point (tests/test_parallel.py
    test_voting_reduces_ici_traffic): a reduction carries the vote
    tally and only the 2·top_k selected features' histograms, never all
    F, plus the two leaf totals at the root only; the hessian channel
    of every selected feature sums to n."""
    rng = np.random.RandomState(5)
    n, f, top_k = 4000, 64, 4
    X = rng.randn(n, f)
    y = (X[:, 0] - X[:, 1] > 0).astype(np.float64)
    params = {"objective": "binary", "tree_learner": "voting",
              "top_k": top_k, "min_data_in_leaf": 20}
    res = run_ranks(tmp_path, 2, "voting_traffic", params, X, y)
    r = res[0]
    B = r["num_bin"]
    # [F] int32 votes + [2] f32 totals + [2k, B, 2] f32 histograms
    assert r["stats"]["bytes"] == f * 4 + 2 * 4 + 2 * top_k * B * 2 * 4
    assert r["stats"]["bytes"] < f * B * 2 * 4
    # a child's reduction carries no totals (its split record has them)
    assert r["child_stats"]["bytes"] == f * 4 + 2 * top_k * B * 2 * 4
    np.testing.assert_array_equal(r["child_hist"], r["hist"])
    assert float(r["sums"][1]) == n
    mass = r["hist"][:, :, 1].sum(axis=1)
    nz = mass[mass > 0]
    assert len(nz) == 2 * top_k
    assert np.allclose(nz, n)
    np.testing.assert_array_equal(res[1]["hist"], r["hist"])


def test_distributed_bin_finding(tmp_path):
    """num_machines 2 over a group of 2: each rank bins its share of the
    features, the mappers are all-gathered, and they equal the
    single-machine ones and the JAX package's distributed ones
    (tests/test_distributed_binning.py's case: a NaN column and a
    categorical-free mix of scales)."""
    from lightgbm_tpu.config import Config as JConfig
    from lightgbm_tpu.io.dataset import BinnedDataset as JBinned
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.io.dataset import BinnedDataset
    rng = np.random.RandomState(3)
    X = rng.randn(3000, 7) * np.asarray([1, 10, 0.1, 100, 1, 5, 2])
    X[rng.rand(3000) < 0.1, 4] = np.nan
    X[:, 6] = np.round(X[:, 6])
    params = {"num_machines": 2, "max_bin": 63}
    res = run_ranks(tmp_path, 2, "bins", params, X)
    single = BinnedDataset.from_matrix(
        X, Config.from_params({"max_bin": 63, "device_type": "cpu"}),
        label=np.zeros(3000))
    jds = JBinned.from_matrix(X, JConfig.from_params(params),
                              label=np.zeros(3000))
    want = mapper_keys(single.bin_mappers)
    assert mapper_keys(jds.bin_mappers) == want
    for maps, bins in res:
        assert maps == want
        np.testing.assert_array_equal(bins, single.bins)
    # one process with num_machines 2 and no group bins every feature
    # itself
    local = BinnedDataset.from_matrix(
        X, Config.from_params({**params, "device_type": "cpu"}),
        label=np.zeros(3000))
    assert mapper_keys(local.bin_mappers) == want


# -- slow ---------------------------------------------------------------------
@pytest.mark.slow
@pytest.mark.parametrize("case", ["multiclass", "quantized", "quantized_dp",
                                  "quantile", "efb", "efb_host_loop",
                                  "efb_voting", "skewed"])
def test_parallel_cases_bit_equal(tmp_path, case):
    """Multiclass (the per-tree fused path), quantized gradients (scales
    maxed over the ranks, each rank's threefry stream; the host loop's
    packed reductions; the leaf refit's sums), quantile regression (the
    percentile refit's counts over the ranks), EFB bundles on the fused,
    host-loop and voting learners (each rank's FixHistogram
    reconstruction in XLA's sum order; ROADMAP §C, C13), and labels
    sorted so the first rank holds one class."""
    X, y = make_data()
    params = {**PARAMS, "tree_learner": "data"}
    learner = "FusedDataParallelGrower"
    if case == "multiclass":
        y = ((X[:, 0] > 0.5).astype(int)
             + (X[:, 1] > 0).astype(int)).astype(np.float32)
        params.update(objective="multiclass", num_class=3)
    elif case == "quantized":
        params.update(use_quantized_grad=True, num_grad_quant_bins=4,
                      quant_train_renew_leaf=True)
    elif case == "quantile":
        # the percentile refit: its counts and sums over the ranks
        y = (X[:, 0] + 0.5 * X[:, 1] ** 2).astype(np.float32)
        params.update(objective="quantile", alpha=0.9)
    elif case == "quantized_dp":
        params.update(use_quantized_grad=True, num_grad_quant_bins=4,
                      quant_train_renew_leaf=True, tpu_fused=False)
        learner = "DataParallelTreeGrower"
    elif case == "efb":
        X, y = make_bundled()
    elif case == "efb_host_loop":
        X, y = make_bundled()
        params.update(tpu_fused=False)
        learner = "DataParallelTreeGrower"
    elif case == "efb_voting":
        X, y = make_bundled()
        params.update(tree_learner="voting", top_k=2)
        learner = "VotingParallelTreeGrower"
    else:
        X, y = make_data(sort_labels=True)
    assert_parallel_equal(tmp_path, params, 2, X, y, learner)


@pytest.mark.parametrize("extra", [
    {"tree_learner": "data"},
    {"tree_learner": "voting", "top_k": 5, "tpu_fused": False}],
    ids=["data_fused", "voting"])
def test_multi_rank_resume_is_bit_identical(tmp_path, extra):
    """Two gloo ranks checkpoint into one directory (rank 0 writes; the
    persistent fused learner saves every rank's lanes) and resume from
    it: on every rank the resumed model text equals the uninterrupted
    run's byte for byte."""
    X, y = make_data()
    out = run_ranks(tmp_path, 2, "resume", {**PARAMS, **extra}, X, y,
                    str(tmp_path / "ck"))
    for resumed, straight, files in out:
        assert resumed == straight
        assert files == [f"ckpt_{i:07d}.lgbckpt" for i in (3, 4)]
    assert out[0][0] == out[1][0]
