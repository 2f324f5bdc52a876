"""Ranking in the port against the JAX package: ``lambdarank`` and
``rank_xendcg`` (objective/rank.py), the ``ndcg`` and ``map`` metrics,
and ranking models trained on both learners.

The gradients are held bit for bit against the JAX objectives'
``get_gradients`` (one jitted program per bucket of queries padded to a
power of two from 8) on every bucket size from 8 to 256, with a query
of one document and queries of exactly a power of two, and on one
query in each bucket from 512 to 2048 (MSLR-WEB10K reaches about 1,250
documents), on random, all-tied and signed-zero scores, and under each
lambdarank option. The
trainings (a few hundred queries, at most 2,048 rows so each histogram
window sums in the JAX package's order) hold trees, split gains, leaf
values and raw predictions bit for bit, and the ``ndcg@k`` / ``map@k``
values of a validation set exactly (float64 on both sides).
"""
import types
import warnings

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.objective.rank import LambdarankNDCG as JLambdarank
from lightgbm_tpu.objective.rank import RankXENDCG as JXENDCG
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.metric.metrics import MapMetric, NDCGMetric, \
    create_metric
from lightgbm_tpu_torch.objective.rank import LambdarankNDCG, RankXENDCG

from test_torch_train import TREE_FIELDS


@pytest.fixture(autouse=True, scope="module")
def _no_aot_store():
    """The JAX package's AOT store off and torch on two threads, as in
    tests/test_torch_objectives.py."""
    from lightgbm_tpu.compile.manager import get_manager
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LGBM_TPU_AOT", "0")
        mp.setattr(get_manager(), "aot_enabled", False)
        yield
    torch.set_num_threads(threads)


# one query per bucket edge (1 document; 8, 16, ... 256 exactly; one
# more than each power of two) plus random sizes: every bucket 8-256
BUCKET_SIZES = [1, 8, 9, 16, 17, 32, 33, 64, 65, 128, 129, 256, 3, 5, 12,
                27, 50, 90, 200, 31, 250]


def _queries(sizes, seed):
    rng = np.random.RandomState(seed)
    bounds = np.concatenate([[0], np.cumsum(sizes)])
    n = int(bounds[-1])
    label = rng.randint(0, 5, n).astype(np.float64)
    score = (rng.randn(n) * 2).astype(np.float32)
    meta = types.SimpleNamespace(label=label, weights=None,
                                 query_boundaries=bounds)
    return meta, n, score


def _assert_bits(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    bad = np.nonzero(got.view(np.int32) != want.view(np.int32))[0]
    assert not len(bad), (what, len(bad), bad[:5], got[bad[:3]],
                          want[bad[:3]])


# case: params, scores ("random", "zero": every score ties, as at
# iteration 0, "signed_zero": -0.0 and 0.0 mixed with random scores)
LAMBDARANK_CASES = {
    "default": ({}, "random"),
    "tied": ({}, "zero"),
    "signed_zero": ({}, "signed_zero"),
    "no_norm": ({"lambdarank_norm": False}, "random"),
    "truncation_1": ({"lambdarank_truncation_level": 1}, "random"),
    "label_gain": ({"label_gain": [0, 1, 3, 7, 15, 40]}, "random"),
    "sigmoid_2": ({"sigmoid": 2.0}, "random"),
    "sigmoid_2_no_norm": ({"sigmoid": 2.0, "lambdarank_norm": False},
                          "random"),
}


@pytest.mark.parametrize("case", sorted(LAMBDARANK_CASES))
def test_lambdarank_gradients_bit_equal(case):
    """Every bucket from 8 to 256 in one call; three steps of scores."""
    params, scores = LAMBDARANK_CASES[case]
    meta, n, s = _queries(BUCKET_SIZES, seed=1)
    if scores == "zero":
        s = np.zeros(n, np.float32)
    elif scores == "signed_zero":
        k = np.arange(n) % 3
        s = np.where(k == 0, np.float32(-0.0),
                     np.where(k == 1, np.float32(0.0), s)).astype(np.float32)
    params = {"objective": "lambdarank", **params}
    jo = JLambdarank(JConfig.from_params(dict(params)))
    jo.init(meta, n)
    to = LambdarankNDCG(TConfig.from_params(dict(params)))
    to.init(meta, n)
    assert sorted({m for m, _ in to._chunks}) == [8, 16, 32, 64, 128, 256]
    assert len(to._batches) == 6
    for step in range(3 if scores == "random" else 1):
        jg, jh = jo.get_gradients(jnp.asarray(s))
        tg, th = to.get_gradients(torch.as_tensor(s))
        _assert_bits(tg.numpy(), jg, (case, step, "grad"))
        _assert_bits(th.numpy(), jh, (case, step, "hess"))
        s = (s - np.float32(0.5) * np.asarray(jg)).astype(np.float32)


# one query in each bucket above 256 (512, 1024, and 2048 twice: the
# largest MSLR-WEB10K query has about 1,250 documents); each one is a
# chunk of its own at 2048, where the total sum windows its windows
LARGE_BUCKET_SIZES = [300, 513, 1250, 2048]
# case: params, scores, as in LAMBDARANK_CASES
LARGE_LAMBDARANK_CASES = {
    "default": ({}, "random"),
    "tied": ({}, "zero"),
    "no_norm": ({"lambdarank_norm": False}, "random"),
}


@pytest.mark.parametrize("case", sorted(LARGE_LAMBDARANK_CASES))
def test_lambdarank_gradients_bit_equal_large_buckets(case):
    """Buckets 512-2048 in one call: the window sums of 32 and the
    total sum's windows of 32 x 32 (recursive at 2048), on random and
    all-tied scores (the tied queries' unswitched loop), with and
    without the norm."""
    params, scores = LARGE_LAMBDARANK_CASES[case]
    meta, n, s = _queries(LARGE_BUCKET_SIZES, seed=3)
    if scores == "zero":
        s = np.zeros(n, np.float32)
    params = {"objective": "lambdarank", **params}
    jo = JLambdarank(JConfig.from_params(dict(params)))
    jo.init(meta, n)
    to = LambdarankNDCG(TConfig.from_params(dict(params)))
    to.init(meta, n)
    assert [m for m, _ in to._chunks] == [512, 1024, 2048, 2048]
    jg, jh = jo.get_gradients(jnp.asarray(s))
    tg, th = to.get_gradients(torch.as_tensor(s))
    _assert_bits(tg.numpy(), jg, (case, "grad"))
    _assert_bits(th.numpy(), jh, (case, "hess"))


def _xendcg_three_steps(sizes):
    meta, n, s = _queries(sizes, seed=2)
    params = {"objective": "rank_xendcg", "objective_seed": 7}
    jo = JXENDCG(JConfig.from_params(dict(params)))
    jo.init(meta, n)
    to = RankXENDCG(TConfig.from_params(dict(params)))
    to.init(meta, n)
    for step in range(3):
        jg, jh = jo.get_gradients(jnp.asarray(s))
        tg, th = to.get_gradients(torch.as_tensor(s))
        _assert_bits(tg.numpy(), jg, (step, "grad"))
        _assert_bits(th.numpy(), jh, (step, "hess"))
        s = (s - np.float32(0.5) * np.asarray(jg)).astype(np.float32)


def test_rank_xendcg_gradients_bit_equal():
    """Three iterations: each draws one rand(Q, M) per chunk from the
    objective seed, chunks in bucket order, in both packages."""
    _xendcg_three_steps(BUCKET_SIZES)


def test_rank_xendcg_gradients_bit_equal_large_buckets():
    """As above on one query in each of 512, 1024 and 2048 (the sums
    over windows of windows)."""
    _xendcg_three_steps(LARGE_BUCKET_SIZES)


def rank_data(n_queries=110, seed=0):
    """Queries of 1-33 documents (about 1,800 rows), 6 columns, graded
    labels 0-4 from a noisy score of two columns; a validation set of
    three queries."""
    rng = np.random.RandomState(seed)
    sizes = rng.randint(1, 34, n_queries)
    n = int(sizes.sum())
    X = rng.randn(n, 6)
    y = np.clip(np.floor(X[:, 0] + 0.5 * X[:, 1] + rng.randn(n) * 0.5
                         + 1.5), 0, 4)
    Xv = rng.randn(300, 6)
    yv = np.clip(np.floor(Xv[:, 0] + rng.randn(300) * 0.5 + 1.5), 0, 4)
    return X, y, sizes, Xv, yv, [100, 150, 50]


# case: objective, fused learner, extra params
TRAIN_CASES = {
    "lambdarank_fused": ("lambdarank", True, {}),
    "lambdarank_host_loop": ("lambdarank", False, {}),
    "rank_xendcg_fused": ("rank_xendcg", True, {}),
    "rank_xendcg_host_loop": ("rank_xendcg", False, {}),
    # quantized gradients leave the fused learner for a non-pointwise
    # objective, in both packages
    "lambdarank_quantized": ("lambdarank", True,
                             {"use_quantized_grad": True}),
}


def _train_both(objective, fused, extra, rounds=3):
    X, y, sizes, Xv, yv, gv = rank_data()
    params = {"objective": objective, "num_leaves": 15,
              "min_data_in_leaf": 5, "verbose": -1, "tpu_fused": fused,
              "metric": ["ndcg", "map"], "eval_at": [1, 3, 5], **extra}
    out = {}
    for name, lib in (("jax", jlgb), ("torch", tlgb)):
        p = dict(params, device_type="cpu") if lib is tlgb else dict(params)
        ds = lib.Dataset(X, label=y, group=sizes)
        ev = {}
        b = lib.train(p, ds, num_boost_round=rounds,
                      valid_sets=[lib.Dataset(Xv, label=yv, group=gv,
                                              reference=ds)],
                      evals_result=ev, verbose_eval=False)
        out[name] = (b, ev)
    return out, X


@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_ranking_training_bit_equal(case):
    objective, fused, extra = TRAIN_CASES[case]
    out, X = _train_both(objective, fused, extra)
    (jb, jev), (tb, tev) = out["jax"], out["torch"]
    on_fused = fused and not extra.get("use_quantized_grad")
    assert (jb._gbdt._fused is not None) == on_fused
    assert (tb._gbdt._fused is not None) == on_fused
    jt, tt = jb._gbdt._used_models(0, -1), tb._gbdt.models
    assert len(jt) == len(tt) == 3
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
    assert list(tev["valid_0"]) == list(jev["valid_0"]) == [
        "ndcg@1", "ndcg@3", "ndcg@5", "map@1", "map@3", "map@5"]
    for key, vals in jev["valid_0"].items():
        assert tev["valid_0"][key] == vals, key


def test_ranking_model_text_round_trip(tmp_path):
    """A lambdarank model through save_model and Booster(model_file=...):
    the same text and raw predictions, and the JAX package reads the
    port's file to the same predictions."""
    out, X = _train_both("lambdarank", True, {}, rounds=2)
    jb, tb = out["jax"][0], out["torch"][0]
    path = str(tmp_path / "rank.txt")
    tb.save_model(path)
    loaded = tlgb.Booster(params={"device_type": "cpu"}, model_file=path)
    assert loaded.model_to_string() == tb.model_to_string()
    assert loaded._gbdt.objective.name == "lambdarank"
    want = tb.predict(X, raw_score=True)
    np.testing.assert_array_equal(loaded.predict(X), want)
    np.testing.assert_array_equal(
        jlgb.Booster(model_file=path).predict(X, raw_score=True),
        jb.predict(X, raw_score=True))


def test_create_metric_takes_ndcg_and_map():
    """``ndcg`` and ``map`` are metrics of the port now; an unknown name
    still warns with the JAX package's message."""
    cfg = TConfig.from_params({"eval_at": [1, 3]})
    assert isinstance(create_metric("ndcg", cfg), NDCGMetric)
    assert isinstance(create_metric("map", cfg), MapMetric)
    records = []
    from lightgbm_tpu_torch.utils import log
    orig = log.warning
    log.warning = lambda msg, *a: records.append(msg % a)
    try:
        assert create_metric("no_such_metric", cfg) is None
    finally:
        log.warning = orig
    assert records == ["Unknown metric type name: no_such_metric"]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        meta = types.SimpleNamespace(label=np.array([0, 1, 2.0]),
                                     weights=None,
                                     query_boundaries=np.array([0, 3]))
        m = create_metric("ndcg", cfg)
        m.init(meta, 3)
        rows = m.eval_device(torch.tensor([0.1, 0.3, 0.2]))
        assert [r[0] for r in rows] == ["ndcg@1", "ndcg@3"]
