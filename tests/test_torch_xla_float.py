"""XLA:CPU's float32 arithmetic in the port (ops/xla_float.py) against
the JAX package, bit for bit: ``exp_f32`` against ``jax.jit(jnp.exp)``,
``fma_f32`` against exact rational arithmetic, the binary gradients
against the JAX objective's jitted functions, and the split scan (with
the multiply-adds XLA fuses) against the jitted JAX ``best_split``."""
import dataclasses
import functools
from fractions import Fraction

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.objective.functions import BinaryLogloss as JBinary
from lightgbm_tpu.ops import split as JS
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.objective.functions import BinaryLogloss as TBinary
from lightgbm_tpu_torch.ops import split as TS
from lightgbm_tpu_torch.ops import xla_float as XF

_JEXP = jax.jit(jnp.exp)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for these elementwise sweeps: under the suite's
    parallel workers each process's own thread pool oversubscribes the
    cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
SWEEP_STEP = 1021            # a prime stride through all 2^32 patterns
SWEEP_CHUNKS = 16


def _same_bits(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Per-element bit equality of float32 arrays, NaN equal to NaN."""
    return (a.view(np.uint32) == b.view(np.uint32)) | (np.isnan(a)
                                                       & np.isnan(b))


def _check_exp(x: np.ndarray) -> None:
    x = np.ascontiguousarray(x, np.float32)
    want = np.asarray(_JEXP(x))
    got = XF.exp_f32(torch.from_numpy(x)).numpy()
    ok = _same_bits(want, got)
    assert ok.all(), (x[~ok][:8], want[~ok][:8], got[~ok][:8])


@pytest.mark.parametrize("chunk", range(SWEEP_CHUNKS))
def test_exp_f32_strided_sweep(chunk):
    """Every SWEEP_STEP-th float32 bit pattern (about 4.2M in all),
    split into chunks: normals, subnormals, infinities and NaNs."""
    bits = np.arange(chunk * SWEEP_STEP // SWEEP_CHUNKS, 1 << 32,
                     SWEEP_STEP, dtype=np.uint64)[chunk::SWEEP_CHUNKS]
    _check_exp(bits.astype(np.uint32).view(np.float32))


def _ulps_around(v: float, k: int = 64) -> np.ndarray:
    b = np.float32(v).view(np.int32).astype(np.int64)
    return (b + np.arange(-k, k + 1)).astype(np.int32).view(np.float32)


@pytest.mark.parametrize("case", ["zeros_inf_nan", "clamp_edges",
                                  "flush_band", "subnormal_inputs"])
def test_exp_f32_edges(case):
    if case == "zeros_inf_nan":
        x = np.float32([0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan, 1.0,
                        -1.0, 88.7, 88.8, 89.0, -104.0])
    elif case == "clamp_edges":
        x = np.concatenate([_ulps_around(float.fromhex("-0x1.5F3334p+6")),
                            _ulps_around(float.fromhex("0x1.633334p+6")),
                            _ulps_around(np.log(np.finfo(np.float32).max))])
    elif case == "flush_band":
        # results below 2^-126 are flushed to zero by XLA:CPU
        x = np.linspace(-88.0, -87.0, 200_001, dtype=np.float32)
    else:
        x = np.concatenate([
            np.arange(1, 1 << 16, 7, dtype=np.uint32).view(np.float32),
            -np.arange(1, 1 << 16, 7, dtype=np.uint32).view(np.float32)])
    _check_exp(x)


def _exact_fma(a, b, c) -> np.float32:
    """a * b + c rounded once to float32 (round to nearest, ties to
    even), from exact rationals."""
    v = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    lo = np.float32(float(v))                # a neighbour of v
    cands = {lo, np.nextafter(lo, np.float32(np.inf)),
             np.nextafter(lo, np.float32(-np.inf))}
    best = sorted(cands, key=lambda f: (abs(Fraction(float(f)) - v),
                                        int(np.float32(f).view(np.int32))
                                        & 1))
    return np.float32(best[0])


@pytest.mark.parametrize("scale", [1.0, 1e-20, 1e20])
def test_fma_f32_random_against_rationals(scale):
    rng = np.random.RandomState(int(np.log10(scale) + 100))
    n = 2_000
    a = (rng.randn(n) * np.exp(rng.uniform(-8, 8, n))).astype(np.float32)
    b = (rng.randn(n) * np.exp(rng.uniform(-8, 8, n))).astype(np.float32)
    c = (-(a.astype(np.float64) * b) * (1 + rng.randn(n) * 1e-6)
         * scale).astype(np.float32)      # near-cancelling sums too
    got = XF.fma_f32(torch.from_numpy(a), torch.from_numpy(b),
                     torch.from_numpy(c)).numpy()
    want = np.array([_exact_fma(*t) for t in zip(a, b, c)], np.float32)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("sign_c", [1.0, -1.0])
@pytest.mark.parametrize("sign_ab", [1.0, -1.0])
def test_fma_f32_double_rounding_cases(sign_ab, sign_c):
    """a * b lands exactly on a float32 midpoint whose tie goes to the
    neighbour nearer zero, and c is far below a float64 ulp of it:
    rounding the float64 sum to float32 ties to even, while the fused
    result must round away from the midpoint toward c (a double
    rounding exactly where c has the product's sign)."""
    a = np.float32(1 + 2 ** -12) * np.float32(sign_ab)
    b = np.float32(1 + 2 ** -12)
    lo, hi = np.float32(2.0 ** -60), np.float32(2.0 ** -40)
    for mag in (lo, hi, np.float32(2.0 ** -100)):
        c = np.float32(sign_c) * mag
        got = XF.fma_f32(torch.tensor([a]), torch.tensor([b]),
                         torch.tensor([c])).numpy()[0]
        assert got.view(np.int32) == _exact_fma(a, b, c).view(np.int32)
        naive = np.float32(np.float64(a) * np.float64(b) + np.float64(c))
        if mag != hi and sign_ab == sign_c:
            assert got != naive            # the double-rounding cases


def test_flush_f32_signs_and_bounds():
    tiny = np.float32(2.0 ** -126)
    x = np.float32([tiny, -tiny, np.nextafter(tiny, np.float32(0)),
                    -np.nextafter(tiny, np.float32(0)), 1e-45, -1e-45, 0.0,
                    -0.0, 1.0, np.inf, np.nan])
    got = XF.flush_f32(torch.from_numpy(x)).numpy()
    want = np.float32([tiny, -tiny, 0.0, -0.0, 0.0, -0.0, 0.0, -0.0, 1.0,
                       np.inf, np.nan])
    assert _same_bits(got, want).all()


class _Meta:
    def __init__(self, label, weights):
        self.label, self.weights = label, weights


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted",
                                                          "weighted"])
@pytest.mark.parametrize("params", [
    {}, {"sigmoid": 0.7, "scale_pos_weight": 1.7}, {"is_unbalance": True}],
    ids=["default", "sigmoid_spw", "unbalanced"])
def test_binary_gradients_bit_equal(params, weighted):
    """BinaryLogloss.get_gradients and persistent_grads against the JAX
    objective's jitted functions, on scores up to +-120 (where exp
    overflows and the gradients underflow to flushed zeros)."""
    rng = np.random.RandomState(len(params) + 10 * weighted)
    n = 50_000
    y = (rng.rand(n) > 0.4).astype(np.float32)
    w = rng.uniform(0.1, 3, n).astype(np.float32) if weighted else None
    score = (rng.randn(n) * 3).astype(np.float32)
    score[:2_000] = rng.uniform(-120, 120, 2_000).astype(np.float32)
    jo = JBinary(JConfig.from_params({"objective": "binary", **params}))
    to = TBinary(TConfig.from_params({"objective": "binary", **params}))
    jo.init(_Meta(y, w), n)
    to.init(_Meta(y, w), n)
    for want, got in zip(jo.get_gradients(jnp.asarray(score)),
                         to.get_gradients(torch.from_numpy(score))):
        assert _same_bits(np.asarray(want), got.numpy()).all()
    aux, _ = to.persistent_aux()
    jfn = jax.jit(lambda s, lab: jo.persistent_grads(s, lab, None))
    for want, got in zip(jfn(jnp.asarray(score), jnp.asarray(aux)),
                         to.persistent_grads(torch.from_numpy(score),
                                             torch.from_numpy(aux), None)):
        assert _same_bits(np.asarray(want), got.numpy()).all()
    raw = torch.from_numpy(score)
    conv = jax.jit(jo.convert_output)(jnp.asarray(score))
    assert _same_bits(np.asarray(conv), to.convert_output(raw).numpy()).all()


F, B = 9, 64


def _scan_case(seed):
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
    hess *= hess[0].sum() / np.maximum(hess.sum(1, keepdims=True), 1e-9)
    grad += (grad[0].sum() - grad.sum(1, keepdims=True)) / num_bin[:, None] \
        * (np.arange(B)[None, :] < num_bin[:, None])
    hist = np.stack([grad, hess], -1).astype(np.float32)
    return hist, num_bin, missing, default_bin, rng.randint(-1, 2, F)


SCAN_GRID = {
    "plain": {}, "l1_l2": dict(lambda_l1=0.5, lambda_l2=2.0,
                               min_gain_to_split=0.1),
    "path_smooth": dict(path_smooth=5.0, lambda_l1=0.3),
    "monotone": dict(use_monotone=True, lambda_l1=0.2)}


@pytest.mark.parametrize("max_delta_step", [0.0, 0.3])
@pytest.mark.parametrize("grid", sorted(SCAN_GRID))
def test_split_scan_bit_equal_to_jitted_best_split(grid, max_delta_step):
    """The port's best_split against the jitted JAX best_split on random
    histograms: gains of every feature and, where a split is found, the
    threshold, direction, counts, sums and outputs, bit for bit. The
    monotone case takes the clamped bounds both monotone methods hand
    the scan."""
    kw = dict(SCAN_GRID[grid], max_delta_step=max_delta_step,
              min_data_in_leaf=5)
    jcfg = dataclasses.replace(JS.SplitConfig(), **kw)
    tcfg = dataclasses.replace(TS.SplitConfig(), **kw)
    for seed in range(6):
        hist, num_bin, missing, default_bin, monotone = _scan_case(seed)
        penalty = np.linspace(0.5, 1.0, F).astype(np.float32)
        args = (num_bin, missing, default_bin, np.zeros(F, bool), monotone,
                penalty)
        jmeta, tmeta = JS.FeatureMeta.build(*args), TS.FeatureMeta.build(*args)
        sum_g = np.float32(hist[0, :, 0].sum())
        sum_h = np.float32(hist[0, :, 1].sum())
        n = int(round(float(sum_h) * 5))
        lo, hi = (-0.4, 0.6) if tcfg.use_monotone else (-np.inf, np.inf)
        jfn = jax.jit(functools.partial(JS.best_split, meta=jmeta, cfg=jcfg))
        want = jfn(jnp.asarray(hist), sum_g=jnp.float32(sum_g),
                   sum_h=jnp.float32(sum_h), num_data=jnp.int32(n),
                   parent_output=jnp.float32(0.1), cmin=jnp.float32(lo),
                   cmax=jnp.float32(hi))
        f32 = torch.float32
        got = TS.best_split(torch.as_tensor(hist), tmeta, tcfg,
                            torch.tensor(sum_g), torch.tensor(sum_h),
                            torch.tensor(n, dtype=torch.int32),
                            torch.tensor(0.1, dtype=f32),
                            torch.tensor(lo, dtype=f32),
                            torch.tensor(hi, dtype=f32))
        wg = np.asarray(want["gain"])
        assert _same_bits(wg, got["gain"].numpy()).all(), seed
        found = np.isfinite(wg)
        assert found.any()
        for k in ("threshold", "default_left", "left_count", "right_count"):
            assert np.array_equal(np.asarray(want[k])[found],
                                  got[k].numpy()[found]), (seed, k)
        for k in ("left_sum_gradient", "left_sum_hessian", "left_output",
                  "right_output", "right_sum_gradient", "right_sum_hessian"):
            assert _same_bits(np.asarray(want[k])[found],
                              got[k].numpy()[found]).all(), (seed, k)
        assert int(want["best_feature"]) == int(got["best_feature"])


@pytest.mark.slow
def test_exp_f32_every_bit_pattern():
    """All 2^32 float32 bit patterns, in chunks of 2^22."""
    chunk = 1 << 22
    for start in range(0, 1 << 32, chunk):
        bits = np.arange(start, start + chunk, dtype=np.uint64)
        _check_exp(bits.astype(np.uint32).view(np.float32))
