"""Quantized-gradient training of the port against the JAX package's.

- ops/threefry.py: ``PRNGKey`` / ``fold_in`` / ``split`` / ``uniform``
  bit-equal to ``jax.random`` (threefry2x32, partitionable);
- ops/quantize.py: levels and scales bit-equal to the JAX package's
  ``quantize_gradients``; pack / unpack exact;
- the int32 modes of kernels B1, B4, B5, B6 and B7 (the port's plain
  versions) bit-equal to their Pallas twins in interpret mode;
- ``dequantize_hist`` and the XLA-order root sum ``xla_sum`` bit-equal;
- whole quantized trainings on the CPU, same data and params in both
  packages, on the fused and the host-loop learner and on the dense and
  the multi-value layout: trees structurally equal, leaf values within
  1e-5 and held-out AUC within 1e-4 (ROADMAP A6's gate).
"""
import numpy as np
import pytest
import scipy.sparse as sp

import jax
import jax.numpy as jnp
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.ops import histogram as JH
from lightgbm_tpu.ops import multival as JMV
from lightgbm_tpu.ops import quantize as JQ
from lightgbm_tpu.ops import split as JS
from lightgbm_tpu_torch.ops import histogram as TH
from lightgbm_tpu_torch.ops import multival as TMV
from lightgbm_tpu_torch.ops import plane as tplane
from lightgbm_tpu_torch.ops import quantize as TQ
from lightgbm_tpu_torch.ops import split as TS
from lightgbm_tpu_torch.ops import threefry as TF

from test_multival import make_codes_fixture, make_wide_sparse
from test_torch_multival import WINDOWS, _states
from test_torch_ops import _cap_for, _make_states
from test_torch_train import _data


@pytest.fixture(autouse=True, scope="module")
def _no_aot_store():
    """Keep the JAX package's on-disk AOT executable store out of these
    tests, as tests/test_multival.py does."""
    from lightgbm_tpu.compile.manager import get_manager
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LGBM_TPU_AOT", "0")
        mp.setattr(get_manager(), "aot_enabled", False)
        yield


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x.astype(np.int64)


# ---------------------------------------------------------------------------
# threefry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 5 ^ 0x51A7, -7, 2 ** 31 - 1])
def test_threefry_keys_bit_equal(seed):
    jk, tk = jax.random.PRNGKey(seed), TF.PRNGKey(seed)
    np.testing.assert_array_equal(_bits(jk), tk.numpy())
    for i in (0, 1, 3, 1000, 2 ** 32 - 1):
        np.testing.assert_array_equal(_bits(jax.random.fold_in(jk, i)),
                                      TF.fold_in(tk, i).numpy())
    for num in (2, 3):
        np.testing.assert_array_equal(_bits(jax.random.split(jk, num)),
                                      TF.split(tk, num).numpy())


@pytest.mark.parametrize("shape", [(1,), (7,), (1000,), (2 ** 17 + 3,),
                                   (3, 5)])
def test_threefry_uniform_bit_equal(shape):
    for seed, i in ((5 ^ 0x51A7, 0), (5 ^ 0x51A7, 9), (123, 2)):
        jk = jax.random.fold_in(jax.random.PRNGKey(seed), i)
        tk = TF.fold_in(TF.PRNGKey(seed), i)
        want = np.asarray(jax.random.uniform(jk, shape))
        got = TF.uniform(tk, shape).numpy()
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))


# ---------------------------------------------------------------------------
# quantize / pack
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stochastic", [True, False])
@pytest.mark.parametrize("num_bins", [4, 16, 64])
def test_quantize_gradients_bit_equal(num_bins, stochastic):
    rng = np.random.RandomState(num_bins)
    jk = jax.random.fold_in(jax.random.PRNGKey(5 ^ 0x51A7), 3)
    tk = TF.fold_in(TF.PRNGKey(5 ^ 0x51A7), 3)
    for n in (1, 1000, 2 ** 17 + 3):
        g = (rng.randn(n) * 0.3).astype(np.float32)
        h = (rng.rand(n) * 0.25).astype(np.float32)
        want = JQ.quantize_gradients(jnp.asarray(g), jnp.asarray(h),
                                     num_bins, jk, stochastic)
        got = TQ.quantize_gradients(torch.as_tensor(g), torch.as_tensor(h),
                                    num_bins, tk, stochastic)
        for a, b in zip(want, got):
            assert b.dtype == {np.dtype(np.int32): torch.int32,
                               np.dtype(np.float32): torch.float32}[
                                   np.asarray(a).dtype]
            np.testing.assert_array_equal(_bits(b.numpy()), _bits(a))
        qmax_g, qmax_h = TQ.grad_levels(num_bins)
        assert int(got[0].abs().max()) <= qmax_g
        assert 0 <= int(got[1].min()) and int(got[1].max()) <= qmax_h


@pytest.mark.parametrize("case", ["all_zero", "max_override"])
def test_quantize_edge_cases_bit_equal(case):
    """An all-zero iteration (the 1e-35 floors) and grad_max / hess_max
    overrides (the sharded learners' pmax)."""
    n = 500
    rng = np.random.RandomState(3)
    g = np.zeros(n, np.float32) if case == "all_zero" \
        else rng.randn(n).astype(np.float32)
    h = np.zeros(n, np.float32) if case == "all_zero" \
        else rng.rand(n).astype(np.float32)
    kw = {} if case == "all_zero" else dict(grad_max=3.5, hess_max=1.25)
    jk, tk = jax.random.PRNGKey(11), TF.PRNGKey(11)
    want = JQ.quantize_gradients(jnp.asarray(g), jnp.asarray(h), 4, jk,
                                 **kw)
    got = TQ.quantize_gradients(torch.as_tensor(g), torch.as_tensor(h), 4,
                                tk, **kw)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(_bits(b.numpy()), _bits(a))
    if case == "all_zero":
        assert not got[0].any() and not got[1].any()


def test_pack_unpack_round_trip_and_packed_sum_bound():
    """pack / unpack round-trip every level pair, the packed hist helpers
    equal the JAX package's, and a packed-word SUM unpacks exactly up to
    ``packed_rows_ok``'s bound."""
    qg = np.repeat(np.arange(-31, 32, dtype=np.int32), 64)
    qh = np.tile(np.arange(0, 64, dtype=np.int32), 63)
    w = TQ.pack_gh(torch.as_tensor(qg), torch.as_tensor(qh))
    np.testing.assert_array_equal(
        w.numpy(), np.asarray(JQ.pack_gh(jnp.asarray(qg), jnp.asarray(qh))))
    ug, uh = TQ.unpack_gh(w)
    np.testing.assert_array_equal(ug.numpy(), qg)
    np.testing.assert_array_equal(uh.numpy(), qh)
    pairs = TQ.packed_hist_to_pairs(w.reshape(63, 64))
    np.testing.assert_array_equal(TQ.pairs_to_packed_hist(pairs).numpy(),
                                  w.reshape(63, 64).numpy())
    for bins in (4, 64):
        rows = (1 << 16) // (bins - 1)
        while not TQ.packed_rows_ok(rows, bins):
            rows -= 1
        assert TQ.packed_rows_ok(rows, bins) == JQ.packed_rows_ok(rows, bins)
        assert not TQ.packed_rows_ok(rows + 1, bins)
        # worst case at the bound: every row at the extreme levels
        for g in (-(bins // 2 - 1), bins // 2 - 1):
            ws = TQ.pack_gh(torch.full((rows,), g, dtype=torch.int32),
                            torch.full((rows,), bins - 1, dtype=torch.int32))
            sg, sh = TQ.unpack_gh(ws.sum(dtype=torch.int32))
            assert int(sg) == g * rows and int(sh) == (bins - 1) * rows


def test_dequantize_hist_and_xla_sum_bit_equal():
    """dequantize_hist, and the XLA-order float32 sum the learners use
    for root totals, bit-equal to the JAX package's on the CPU."""
    rng = np.random.RandomState(4)
    hist = rng.randint(-5000, 5000, size=(3, 7, 2)).astype(np.int32)
    want = np.asarray(JS.dequantize_hist(jnp.asarray(hist),
                                         np.float32(0.013),
                                         np.float32(0.0021)))
    got = TS.dequantize_hist(torch.as_tensor(hist),
                             torch.tensor(0.013, dtype=torch.float32),
                             torch.tensor(0.0021, dtype=torch.float32))
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))
    jsum = jax.jit(lambda x: jnp.sum(x[0, :, 0]))
    for b in (1, 2, 28, 32, 33, 63, 255, 256, 700, 1500, 4097):
        x = (rng.randn(2, b, 2) * rng.choice([1e-3, 1.0, 1e3])
             ).astype(np.float32)
        want = np.asarray(jsum(jnp.asarray(x)))
        got = TS.xla_sum(torch.as_tensor(x)[0, :, 0]).numpy()
        assert got.view(np.int32) == want.view(np.int32), b


# ---------------------------------------------------------------------------
# the int32 kernel modes against their Pallas twins (interpret mode)
# ---------------------------------------------------------------------------

def _levels(rng, n, num_bins):
    """Quantized levels with both extremes present (qg at its negative
    extreme exercises the sign-carrying unpack)."""
    qmax_g, qmax_h = TQ.grad_levels(num_bins)
    qg = rng.randint(-qmax_g, qmax_g + 1, n).astype(np.int32)
    qh = rng.randint(0, qmax_h + 1, n).astype(np.int32)
    qg[::7] = -qmax_g
    qh[::5] = qmax_h
    return qg, qh


@pytest.mark.parametrize("code_bits,num_bins,levels", [
    (8, 255, 4), (8, 64, 64), (4, 16, 64)])
def test_b1q_plain_matches_pallas(code_bits, num_bins, levels):
    n, g = 2048, 7
    jl, jdata, tl, tdata, _ = _make_states(n, g, seed=code_bits + num_bins,
                                           code_bits=code_bits,
                                           max_code=num_bins)
    qg, qh = _levels(np.random.RandomState(levels), jl.num_lanes, levels)
    words = np.array(JQ.pack_gh(jnp.asarray(qg), jnp.asarray(qh)))
    jdata = jdata.at[jl.grad].set(jnp.asarray(words)).at[jl.hess].set(0)
    tplane.set_gh_packed(tdata, tl, tplane.i32_as_f32(torch.as_tensor(words)))
    np.testing.assert_array_equal(tdata.numpy(), np.asarray(jdata))
    for start, count in ((200, 1500), (0, n), (n - 1, 1), (n - 97, 97),
                         (5, 0)):
        want = np.asarray(JH.histogram_planar_pallas(
            jdata, start, count, num_bins=num_bins, num_cols=g,
            code_bits=code_bits, grad_plane=jl.grad,
            cap=_cap_for(jl, count), rows_per_block=256, interpret=True,
            quant=True))
        got = TH.hist_planar(tdata, start, count, num_bins=num_bins,
                             num_cols=g, code_bits=code_bits,
                             grad_plane=tl.grad, quant=True)
        assert got.dtype == torch.int32 and want.dtype == np.int32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("num_bins", [255, 64, 16])
def test_b4q_b7q_plain_match_pallas(num_bins):
    """B4q against histogram_radix_pallas with int32 levels, and B7q
    against histogram_pallas with int32 levels."""
    rng = np.random.RandomState(num_bins)
    r, f = 1500, 11
    bins = rng.randint(0, num_bins, size=(r, f)).astype(np.uint8)
    for levels in (4, 64):
        qg, qh = _levels(rng, r, levels)
        jb, jg, jh = jnp.asarray(bins), jnp.asarray(qg), jnp.asarray(qh)
        tb, tg, th = (torch.as_tensor(x) for x in (bins, qg, qh))
        want = np.asarray(JH.histogram_radix_pallas(
            jb, jg, jh, num_bins, dtype=jnp.bfloat16, rows_per_block=256,
            interpret=True))
        got = TH.hist_radix(tb, tg, th, num_bins, dtype=torch.bfloat16)
        assert got.dtype == torch.int32 and want.dtype == np.int32
        np.testing.assert_array_equal(got.numpy(), want)
        want = np.asarray(JH.histogram_pallas(jb, jg, jh, num_bins,
                                              rows_per_block=256,
                                              interpret=True))
        got = TH.hist_masked(tb, tg, th, num_bins)
        assert got.dtype == torch.int32 and want.dtype == np.int32
        np.testing.assert_array_equal(got.numpy(), want)
        for m in ("scatter", None):
            np.testing.assert_array_equal(
                TH.histogram(tb, tg, th, num_bins, method=m).numpy(), want)


@pytest.mark.parametrize("levels", [4, 64])
def test_b5q_plain_matches_pallas(levels):
    bins, gnb, default = make_codes_fixture(n=512, seed=5)
    codes, lay = TMV.build_rowwise_codes(bins, gnb, default)
    qg, qh = _levels(np.random.RandomState(levels), 512, levels)
    words = np.array(JQ.pack_gh(jnp.asarray(qg), jnp.asarray(qh)))
    zero = np.zeros(512, np.float32)
    jl, jd, tl, td = _states(codes, zero, zero)
    jd = jd.at[jl.grad, :512].set(jnp.asarray(words))
    td[tl.grad, :512] = torch.as_tensor(words)
    for start, count in WINDOWS:
        want = np.asarray(JMV.histogram_multival_planar(
            jd, start, count, mv_start=jl.mv_start, mv_planes=jl.mv_planes,
            total_bins=lay.total_bins, grad_plane=jl.grad, dtype=jnp.bfloat16,
            rows_per_block=128, interpret=True, quant=True))
        got = TMV.hist_multival_planar(
            td, start, count, mv_start=tl.mv_start, mv_planes=tl.mv_planes,
            total_bins=lay.total_bins, grad_plane=tl.grad, quant=True)
        assert got.dtype == torch.int32 and want.dtype == np.int32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("levels", [4, 64])
def test_b6q_plain_matches_pallas(levels):
    bins, gnb, default = make_codes_fixture(n=512, seed=7)
    codes, lay = TMV.build_rowwise_codes(bins, gnb, default)
    qg, qh = _levels(np.random.RandomState(levels + 1), 512, levels)
    for start, count in WINDOWS:
        sel = slice(start, start + max(count, 1))
        keep = np.arange(sel.stop - sel.start) < count   # empty: masked
        gw, hw = np.where(keep, qg[sel], 0), np.where(keep, qh[sel], 0)
        jgh = JMV.gh_planes(jnp.asarray(gw), jnp.asarray(hw), quant=True)
        want = np.asarray(JMV.histogram_multival_pallas(
            JMV.slot_major(jnp.asarray(codes[sel])), jgh,
            total_bins=lay.total_bins, dtype=jnp.bfloat16,
            rows_per_block=128, interpret=True, quant=True))
        tgh = TMV.gh_planes(torch.as_tensor(gw), torch.as_tensor(hw),
                            quant=True)
        np.testing.assert_array_equal(tgh.numpy(), np.asarray(jgh))
        got = TMV.hist_multival(TMV.slot_major(torch.as_tensor(codes[sel])),
                                tgh, total_bins=lay.total_bins, quant=True)
        assert got.dtype == torch.int32 and want.dtype == np.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_quantized_leaf_gathers_match():
    """The learners' leaf gathers keep int32 levels int32: the row-major
    leaf_histogram and leaf_histogram_multival (plus the group and
    per-feature reconstructions) against the JAX package's."""
    bins, gnb, default = make_codes_fixture(n=256, seed=6)
    codes, lay = TMV.build_rowwise_codes(bins, gnb, default)
    qg, qh = _levels(np.random.RandomState(2), 256, 64)
    perm = np.random.RandomState(7).permutation(256).astype(np.int32)
    jargs = (jnp.asarray(perm), 32, 150, jnp.asarray(qg), jnp.asarray(qh))
    targs = (torch.as_tensor(perm), 32, 150, torch.as_tensor(qg),
             torch.as_tensor(qh))
    jflat = JMV.leaf_histogram_multival(jnp.asarray(codes), *jargs, 256,
                                        lay.total_bins, use_pallas=False)
    jt = JMV.group_tables(gnb, default)
    tt = TMV.group_tables(gnb, default)
    for cap in (256, None):
        tflat = TMV.leaf_histogram_multival(torch.as_tensor(codes), *targs,
                                            cap, lay.total_bins)
        assert tflat.dtype == torch.int32
        np.testing.assert_array_equal(tflat.numpy(), np.asarray(jflat))
        tg = TMV.group_hist_from_flat(tflat, tt)
        assert tg.dtype == torch.int32
        np.testing.assert_array_equal(
            tg.numpy(), np.asarray(JMV.group_hist_from_flat(jflat, jt)))
    nb = int(gnb.max())
    want = np.asarray(JH.leaf_histogram(jnp.asarray(bins), *jargs, 256, nb))
    got = TH.leaf_histogram(torch.as_tensor(bins), *targs, None, nb)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# end-to-end gates
# ---------------------------------------------------------------------------

BASE = {"objective": "binary", "num_leaves": 15, "metric": "auc",
        "verbose": -1, "use_quantized_grad": True}


def _assert_trees_equal(jb, tb, rounds, counts=True):
    """Tree structure equal, leaf values within 1e-5. ``counts=False``
    skips the row counts: the fused learner records each leaf's true
    count, the host-loop learner the scan's hessian-derived estimate,
    which quantized hessians move."""
    jt, tt = jb._gbdt._used_models(0, -1), tb._gbdt.models
    assert len(jt) == len(tt) == rounds
    fields = ("split_feature", "threshold", "decision_type", "left_child",
              "right_child") + (("internal_count",) if counts else ())
    for a, b in zip(jt, tt):
        k = a.num_leaves
        assert k == b.num_leaves and k > 2
        for f in fields:
            np.testing.assert_array_equal(getattr(a, f)[:k - 1],
                                          getattr(b, f)[:k - 1], err_msg=f)
        if counts:
            np.testing.assert_array_equal(a.leaf_count[:k],
                                          b.leaf_count[:k])
        np.testing.assert_allclose(a.leaf_value[:k], b.leaf_value[:k],
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("extra,fused", [
    ({}, True),
    ({"num_grad_quant_bins": 64}, True),
    ({"stochastic_rounding": False}, True),
    ({"quant_train_renew_leaf": False}, True),
    ({"tpu_fused": False}, False),
    ({"tpu_fused": False, "num_grad_quant_bins": 64,
      "quant_train_renew_leaf": False}, False),
    ({"extra_trees": True}, False),
], ids=["fused_bins4", "fused_bins64", "fused_round", "fused_no_renew",
        "serial_bins4", "serial_bins64_no_renew", "serial_extra_trees"])
def test_quantized_dense_gate(extra, fused):
    X, y = _data(seed=0, n=2000)
    Xv, yv = _data(seed=1, n=600)
    out = {}
    for name, lib, dev in (("jax", jlgb, {}),
                           ("torch", tlgb, {"device_type": "cpu"})):
        ds = lib.Dataset(X, label=y)
        ev = {}
        b = lib.train({**BASE, **extra, **dev}, ds, num_boost_round=3,
                      valid_sets=[lib.Dataset(Xv, label=yv, reference=ds)],
                      valid_names=["valid"], evals_result=ev,
                      verbose_eval=False)
        out[name] = (b, ev)
    (jb, jev), (tb, tev) = out["jax"], out["torch"]
    assert (tb._gbdt._fused is not None) == fused
    learner = tb._gbdt._fused if fused else tb._gbdt.tree_learner
    assert learner._quant
    _assert_trees_equal(jb, tb, 3)
    np.testing.assert_allclose(tev["valid"]["auc"], jev["valid"]["auc"],
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(tb.predict(Xv), jb.predict(Xv), atol=1e-5)


@pytest.mark.parametrize("fused,extra,rounds", [
    (True, {"stochastic_rounding": False}, 3),
    (True, {"num_grad_quant_bins": 64}, 1),
    (False, {}, 3),
    (False, {"num_grad_quant_bins": 64, "quant_train_renew_leaf": False},
     3),
], ids=["fused_round", "fused_bins64_one_tree", "serial_bins4",
        "serial_bins64_no_renew"])
def test_quantized_multival_gate(monkeypatch, fused, extra, rounds):
    """The multi-value layout forced in both packages (CSR input): the
    JAX package's serial learner on its multival CPU path against the
    port's fused (B5q) or host-loop (B6q) learner. The fused learner
    draws its stochastic rounding in lane order and the serial one in
    row order, so the fused cases hold to round-to-nearest, or to one
    tree (lanes still in row order)."""
    X, y = make_wide_sparse(n=400)
    Xs = sp.csr_matrix(X)
    params = {**BASE, "min_data_in_leaf": 5, **extra}
    monkeypatch.setattr(JH, "hist_method",
                        lambda config, dataset=None: "multival_pallas")
    monkeypatch.setattr(TH, "hist_method",
                        lambda config, dataset=None: "multival_pallas")
    jb = jlgb.train({**params, "tpu_fused": False},
                    jlgb.Dataset(Xs, label=y), num_boost_round=rounds)
    tb = tlgb.train({**params, "device_type": "cpu", "tpu_fused": fused},
                    tlgb.Dataset(Xs, label=y), num_boost_round=rounds)
    gb = tb._gbdt
    if fused:
        assert gb._fused is not None and gb._fused.layout.mv_planes > 0
    else:
        assert gb.tree_learner._mv_state is not None
    _assert_trees_equal(jb, tb, rounds, counts=not fused)
    np.testing.assert_allclose(tb.predict(Xs), jb.predict(X), atol=1e-5)


def test_fused_quantized_layouts_agree(monkeypatch):
    """Integer histograms do not depend on the layout: the port's fused
    learner grows bit-identical quantized trees (stochastic rounding,
    renewed leaves) on the planar and the multi-value layout."""
    X, y = make_wide_sparse(n=400)
    params = {**BASE, "min_data_in_leaf": 5, "device_type": "cpu"}
    planar = tlgb.train(dict(params), tlgb.Dataset(X, label=y),
                        num_boost_round=3)
    monkeypatch.setattr(TH, "hist_method",
                        lambda config, dataset=None: "multival_pallas")
    mv = tlgb.train(dict(params), tlgb.Dataset(X, label=y),
                    num_boost_round=3)
    assert mv._gbdt._fused.layout.mv_planes > 0
    assert planar._gbdt._fused.layout.mv_planes == 0
    assert planar.model_to_string() == mv.model_to_string()
