"""The port's split loop without reads, its pending trees and iteration
batching (``lightgbm_tpu_torch/treelearner/fused.py`` ``_split_step``,
``PendingTree``, ``TreeArrayBatch``, ``traverse_bins``;
``boosting/gbdt.py`` ``_materialize_models``, ``LGBM_TPU_ITER_BATCH``)
against the JAX package's ``lax.while_loop`` tree, ``PendingTree`` and
``train_iters_persistent``, on the CPU at small sizes (2,000-3,000
rows, 7-31 leaves, 2-10 iterations).

Tolerances: model texts equal but the ``device_type`` line; leaf values,
traversal leaves, partitions and the no-op steps' state bit for bit.
"""
import numpy as np
import pytest

import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.ops import plane as tplane

from test_torch_train import _data
from test_torch_categorical import make_cat_data


@pytest.fixture(autouse=True, scope="module")
def _no_aot_store():
    """The JAX package's AOT store off; torch on two threads, as the
    other port test modules."""
    from lightgbm_tpu.compile.manager import get_manager
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LGBM_TPU_AOT", "0")
        mp.setattr(get_manager(), "aot_enabled", False)
        yield
    torch.set_num_threads(threads)


BASE = {"objective": "binary", "num_leaves": 15, "verbose": -1,
        "min_data_in_leaf": 10, "learning_rate": 0.2}
CASES = {
    "plain": {},
    "quantized": {"use_quantized_grad": True, "num_grad_quant_bins": 4},
    "categorical": {"categorical_feature": [4, 5]},
    "monotone": {"monotone_constraints": [1, 0, -1, 0, 0, 0]},
    "l1_refit": {"objective": "regression_l1"},
    "max_depth": {"max_depth": 3, "num_leaves": 31},
    "early_stop": {"min_gain_to_split": 25.0, "num_leaves": 31},
}


def _case_data(case):
    if case == "categorical":
        X, y = make_cat_data()
        return X.astype(np.float64), y.astype(np.float64)
    X, y = _data()
    if case == "l1_refit":
        rng = np.random.RandomState(3)
        y = np.nan_to_num(X[:, 0]) * 2 + rng.randn(len(y))
    return X, y


def _params(lib, extra=None):
    p = dict(BASE, **(extra or {}))
    if lib is tlgb:
        p["device_type"] = "cpu"
    return p


def _text(b, **kw):
    return "\n".join(ln for ln in b.model_to_string(**kw).splitlines()
                     if not ln.startswith("[device_type"))


def _cur(b):
    c = b.current_iteration
    return c() if callable(c) else c


@pytest.mark.parametrize("case", sorted(CASES))
def test_persistent_iteration_reads_nothing(case):
    """A persistent fused iteration takes no counted read; one read
    materializes every pending tree, and the model is the JAX
    package's."""
    X, y = _case_data(case)
    rounds = 4
    marks = []

    def mark(env):
        marks.append(env.model._gbdt._fused.syncs)
    mark.before_iteration = True
    tb = tlgb.train(_params(tlgb, CASES[case]), tlgb.Dataset(X, label=y),
                    num_boost_round=rounds, callbacks=[mark])
    gb = tb._gbdt
    assert gb._fused_persist
    assert marks == [0] * rounds
    pend = [t for t in gb.models if t._tree is None]
    assert pend and all(isinstance(t, tlgb_fused().PendingTree)
                        for t in pend)
    before = gb._fused.syncs
    gb._materialize_models()
    assert gb._fused.syncs == before + 1
    assert not any(isinstance(t, tlgb_fused().PendingTree)
                   for t in gb.models)
    jb = jlgb.train(_params(jlgb, CASES[case]), jlgb.Dataset(X, label=y),
                    num_boost_round=rounds)
    assert _text(tb) == _text(jb)
    if case == "early_stop":
        assert min(t.num_leaves for t in gb.models) < 31
    if case == "max_depth":
        assert max(int(t.leaf_depth[:t.num_leaves].max())
                   for t in gb.models) <= 3


def tlgb_fused():
    from lightgbm_tpu_torch.treelearner import fused
    return fused


@pytest.mark.parametrize("valid", [False, True], ids=["train", "valid"])
def test_iter_batch_gives_batch_one_model(monkeypatch, valid):
    """LGBM_TPU_ITER_BATCH 1 and 4 over 10 iterations (a partial last
    batch): the same model text, num_trees and current_iteration in
    both packages; with a valid set the batch stays at 1."""
    X, y = _data(n=1500)
    Xv, yv = _data(seed=1, n=400)
    out = {}
    for batch in ("1", "4"):
        monkeypatch.setenv("LGBM_TPU_ITER_BATCH", batch)
        for name, lib in (("jax", jlgb), ("torch", tlgb)):
            ds = lib.Dataset(X, label=y)
            queued = []

            def watch(env):
                queued.append(len(env.model._gbdt._pq_trees))
            kw = {}
            if valid:
                kw = dict(valid_sets=[lib.Dataset(Xv, label=yv,
                                                  reference=ds)],
                          verbose_eval=False)
            b = lib.train(_params(lib, {"num_leaves": 7}), ds,
                          num_boost_round=10,
                          callbacks=[watch] if lib is tlgb else [], **kw)
            if lib is tlgb and batch == "4":
                assert b._gbdt._iter_batch == 4
                assert max(queued) == (0 if valid else 3), queued
            out[batch, name] = (_text(b), b.num_trees(), _cur(b))
    assert out["1", "torch"] == out["4", "torch"] == out["1", "jax"] \
        == out["4", "jax"]


def _pair(rounds=3, extra=None):
    X, y = _data()
    out = {}
    for name, lib in (("jax", jlgb), ("torch", tlgb)):
        b = lib.Booster(_params(lib, extra), lib.Dataset(X, label=y))
        for _ in range(rounds):
            b.update()
        out[name] = b
    return out, X, y


def test_pending_tree_contract():
    """Shrinkage and bias held pending, the device leaf values,
    attribute delegation: as the JAX package's PendingTree."""
    b, _, _ = _pair()
    jt, tt = b["jax"]._gbdt.models, b["torch"]._gbdt.models
    fused = tlgb_fused()
    assert all(isinstance(t, fused.PendingTree) for t in tt)
    for a, t in zip(jt, tt):
        assert t._tree is None
        assert t.pending_shrinkage == a.pending_shrinkage
        assert t.pending_bias == a.pending_bias
        want = np.asarray(a.leaf_values_device(), np.float32)
        got = t.leaf_values_device().numpy()
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))
    # a pending shrinkage and bias, then delegation materializes
    for m in (jt, tt):
        m[1].apply_shrinkage(0.5)
        m[1].add_bias(0.25)
    assert tt[1].num_leaves == jt[1].num_leaves       # delegation
    assert tt[1]._tree is not None
    np.testing.assert_array_equal(
        np.asarray(tt[1].leaf_value[:tt[1].num_leaves]),
        np.asarray(jt[1].leaf_value[:jt[1].num_leaves]))
    assert _text(b["torch"]) == _text(b["jax"])


@pytest.mark.parametrize("op", ["rollback", "save_predict", "refit"])
def test_consumers_of_pending_trees(op, tmp_path):
    """Rollback, save_model + predict and refit on boosters whose trees
    are still pending give the JAX package's results."""
    b, X, y = _pair()
    res = {}
    for name, bst in b.items():
        if op == "rollback":
            bst.rollback_one_iter()
            bst.update()
            res[name] = _text(bst)
        elif op == "save_predict":
            path = str(tmp_path / f"{name}.txt")
            bst.save_model(path)
            with open(path) as fh:
                text = "\n".join(ln for ln in fh.read().splitlines()
                                 if not ln.startswith("[device_type"))
            res[name] = (text, bst.predict(X[:300], raw_score=True))
        else:
            nb = bst.refit(X[:800], y[:800])
            res[name] = nb.predict(X[:300], raw_score=True)
    if op == "save_predict":
        assert res["torch"][0] == res["jax"][0]
        np.testing.assert_array_equal(res["torch"][1], res["jax"][1])
    elif op == "refit":
        np.testing.assert_allclose(res["torch"], res["jax"], rtol=0,
                                   atol=1e-6)
    else:
        assert res["torch"] == res["jax"]


def test_checkpoint_with_pending_trees(tmp_path):
    """A checkpoint taken while the trees are pending resumes to the
    uninterrupted run's model."""
    X, y = _data()
    ds = tlgb.Dataset(X, label=y)
    p = _params(tlgb, {"checkpoint_dir": str(tmp_path / "ck"),
                       "checkpoint_interval": 2})
    tlgb.train(dict(p), ds, num_boost_round=4)
    resumed = tlgb.train(dict(p), tlgb.Dataset(X, label=y),
                         num_boost_round=6)
    straight = tlgb.train(_params(tlgb), tlgb.Dataset(X, label=y),
                          num_boost_round=6)

    def body(b):
        return [ln for ln in _text(b).splitlines()
                if not ln.startswith(("[checkpoint_", "[num_iterations"))]
    assert body(resumed) == body(straight)


def _efb_data(n=2000, seed=4):
    """Numerical columns, then 8 mutually exclusive sparse columns (one
    nonzero per row at most: one EFB bundle) and NaNs in column 1."""
    rng = np.random.RandomState(seed)
    X = np.zeros((n, 11))
    X[:, :3] = rng.randn(n, 3)
    X[rng.rand(n) < 0.08, 1] = np.nan
    which = rng.randint(0, 12, n)
    for j in range(8):
        sel = which == j
        X[sel, 3 + j] = rng.rand(sel.sum()) * 5 + 1
    y = (np.nan_to_num(X[:, 0]) + X[:, 3] * 0.4 - X[:, 6] * 0.3
         + rng.randn(n) * 0.4 > 0.2).astype(np.float64)
    return X, y


@pytest.mark.parametrize("kind", ["efb_missing", "categorical"])
def test_traverse_bins_matches_jax(kind):
    """The device traversal of a pending tree's arrays against the JAX
    package's traverse_bins on the same tree and bins."""
    import jax.numpy as jnp
    if kind == "categorical":
        X, y = make_cat_data()
        extra = {"categorical_feature": [4, 5]}
    else:
        X, y = _efb_data()
        extra = {}
    p = _params(tlgb, dict(extra, num_leaves=15))
    tb = tlgb.Booster(p, tlgb.Dataset(X, label=y))
    jb = jlgb.Booster(_params(jlgb, dict(extra, num_leaves=15)),
                      jlgb.Dataset(X, label=y))
    tb.update()
    tb.update()
    jb.update()
    fl = tb._gbdt._fused
    jf = jb._gbdt._fused
    if kind == "efb_missing":
        assert fl._efb_dev is not None
    pt = tb._gbdt.models[-1]
    dev = pt.device_arrays()
    host = pt.tree_arrays
    L = fl.num_leaves
    bins_t = fl.bins_device()
    got = fl.traverse_bins(dev, bins_t).numpy()

    def pad(a, n, dt):
        out = np.zeros((n,) + np.asarray(a).shape[1:], dt)
        out[:len(a)] = a
        return jnp.asarray(out)
    jta = dict(
        n_leaves=jnp.int32(host["n_leaves"]),
        split_feature=pad(host["split_feature"], L - 1, np.int32),
        threshold_bin=pad(host["threshold_bin"], L - 1, np.int32),
        default_left=pad(host["default_left"], L - 1, bool),
        left_child=pad(host["left_child"], L - 1, np.int32),
        right_child=pad(host["right_child"], L - 1, np.int32),
        split_cat=pad(host["split_cat"], L - 1, bool),
        split_bits=pad(host["split_bits"].astype(np.int64)
                       .astype(np.uint32).view(np.int32), L - 1, np.int32))
    want = np.asarray(jf.traverse_bins(jta, jf.bins))
    np.testing.assert_array_equal(got, want)
    # and the host tree's own traversal
    tree = pt.materialize()
    np.testing.assert_array_equal(
        got, tree.leaf_index_binned(bins_t, fl.feature_miss_bin,
                                    fl._efb_dev).numpy())


@pytest.mark.parametrize("count", [0, 1, 333, 2048])
def test_partition_dev_plain_matches_host_window(count):
    """B2's device-window entry on the CPU (its plain version reading the
    window tensor) against the host-window call, bit for bit, including
    a zero count."""
    rng = np.random.RandomState(count)
    lay = tplane.make_layout(5, 8, 4000)
    data = torch.as_tensor(rng.randint(-2 ** 31, 2 ** 31 - 1,
                                       (lay.num_planes, lay.num_lanes),
                                       dtype=np.int64).astype(np.int32))
    rs = tplane.route_scalars(lay, 2, 100, 1, 7)
    start = 91
    a, na = tplane.partition(data.clone(), lay, start, count, rs)
    bufs = tplane.PartitionBuffers(lay.num_planes, 4000, "cpu")
    win = torch.tensor([start, count], dtype=torch.int32)
    b, nb = tplane.partition_dev(data.clone(), lay, win, rs, bufs)
    assert torch.equal(a, b) and int(na) == int(nb)
    c, nc = tplane.partition_plain(data.clone(), lay, win, None, rs)
    assert torch.equal(a, c) and int(nc) == int(na)
    with pytest.raises(ValueError):
        tplane.partition_dev(data.clone(), lay, win, rs,
                             tplane.PartitionBuffers(lay.num_planes,
                                                     count - 1, "cpu"))


def test_dev_status_words_rule():
    """The status words of the device-window entry: 0 while every window
    up to the bound is small, then word 0 plus the most (tile, group)
    words a count up to the bound uses."""
    P = 16
    small = tplane.PART_SMALL_BYTES // (4 * (P + 1))
    assert tplane.dev_status_words(P, small) == 0
    assert tplane.dev_status_words(P, small + 1) == 1 + 2 * 2
    assert tplane.dev_status_words(P, 2_000_000) == 1 + 977
    assert tplane.dev_status_words(128, 2_000_000) == 1 + max(
        t * -(-128 // -(-128 // min(-(-264 // t), 16)))
        for t in range(1, 978))


@pytest.mark.parametrize("extra", [{}, {"feature_fraction_bynode": 0.5}],
                         ids=["plain", "bynode"])
def test_noop_steps_leave_state_identical(extra):
    """After the stop, split steps change no real slot of the tree state
    and no lane of the planar state."""
    X, y = _data()
    b = tlgb.Booster(_params(tlgb, dict(extra, num_leaves=31,
                                        min_gain_to_split=25.0)),
                     tlgb.Dataset(X, label=y))
    b.update()
    fl = b._gbdt._fused
    st = fl._st
    L = fl.num_leaves
    assert int(st.n_leaves) < L            # stopped early
    data = b._gbdt._fused_state
    names = ("best_f", "best_i", "leaf_f", "leaf_i", "leaf_depth",
             "leaf_parent", "t_f", "t_i", "t_left", "t_right", "n_leaves",
             "pool")

    def real(name):
        v = getattr(st, name)
        if name in ("t_f", "t_i", "t_left", "t_right"):
            return v[..., :L - 1].clone()
        if name == "n_leaves":
            return v.clone()
        return (v[:L] if v.dim() == 1 or name == "pool"
                else v[:, :L]).clone()
    snap = {k: real(k) for k in names}
    data0 = data.clone()
    mask = fl.feature_masks_for_tree()
    for _ in range(3):
        fl._split_step(st, data, mask, None, fl.n_valid)
        assert not bool(st.cont)
    for k in names:
        assert torch.equal(real(k).view(torch.int32)
                           if real(k).dtype == torch.float32
                           else real(k), snap[k].view(torch.int32)
                           if snap[k].dtype == torch.float32
                           else snap[k]), k
    assert torch.equal(data, data0)
