"""Vectorized best-split search over histograms.

The port of the JAX package's ops/split.py (itself the re-design of the
reference's per-feature sequential threshold scan,
feature_histogram.hpp FindBestThresholdSequentially :855 and the
FuncForNumrical* lattice :115-217). Both scan directions for every
feature are evaluated at once as masked prefix sums over the histogram;
all arithmetic is float32, as in the JAX package.

Every function takes histograms with any leading batch shape
``[..., F, B, 2]`` and leaf scalars of shape ``[...]``, so the learner
scans both children of a split in one call.

Semantics replicated from the reference (see the JAX module for the
line references): hessian-derived counts round(hess * num_data /
(sum_hess + 2*kEpsilon)); min_gain_shift = parent leaf gain +
min_gain_to_split; leaf output -ThresholdL1(G)/(H + l2) with
max_delta_step, path smoothing and monotone clamps; two scans when
num_bin > 2 and the feature has a missing type; candidate order reverse
scan first (descending threshold), then forward, for argmax ties.

The categorical scan is not ported yet (ROADMAP A3): the learners
reject datasets with categorical features.
"""
from __future__ import annotations

import dataclasses
import math

import torch

K_EPSILON = 1e-15
K_MIN_SCORE = -math.inf

MISSING_NONE = 0
MISSING_ZERO = 1
MISSING_NAN = 2


@dataclasses.dataclass(frozen=True)
class SplitConfig:
    """Split-scan parameters (the JAX package's SplitConfig)."""
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    min_data_in_leaf: int = 20
    min_sum_hessian_in_leaf: float = 1e-3
    min_gain_to_split: float = 0.0
    max_delta_step: float = 0.0
    path_smooth: float = 0.0
    use_monotone: bool = False
    extra_trees: bool = False
    max_cat_threshold: int = 32
    cat_l2: float = 10.0
    cat_smooth: float = 10.0
    max_cat_to_onehot: int = 4
    min_data_per_group: int = 100


@dataclasses.dataclass
class FeatureMeta:
    """Per-feature metadata tensors."""
    num_bin: torch.Tensor       # [F] int32
    missing_type: torch.Tensor  # [F] int32
    default_bin: torch.Tensor   # [F] int32
    is_categorical: torch.Tensor  # [F] bool
    monotone: torch.Tensor      # [F] int32 in {-1,0,1}
    penalty: torch.Tensor       # [F] f32 (feature_contri)

    @classmethod
    def build(cls, num_bin, missing_type, default_bin, is_categorical,
              monotone, penalty, device="cpu") -> "FeatureMeta":
        def t(x, dt):
            return torch.as_tensor(x, dtype=dt, device=device)
        return cls(t(num_bin, torch.int32), t(missing_type, torch.int32),
                   t(default_bin, torch.int32), t(is_categorical, torch.bool),
                   t(monotone, torch.int32), t(penalty, torch.float32))


def threshold_l1(s, l1):
    reg = torch.clamp(torch.abs(s) - l1, min=0.0)
    return torch.sign(s) * reg


def _calc_output(g, h, cnt, cfg: SplitConfig, parent_output, cmin, cmax):
    """CalculateSplittedLeafOutput (feature_histogram.hpp:740-780)."""
    if cfg.lambda_l1 > 0:
        ret = -threshold_l1(g, cfg.lambda_l1) / (h + cfg.lambda_l2)
    else:
        ret = -g / (h + cfg.lambda_l2)
    if cfg.max_delta_step > 0:
        ret = torch.clamp(ret, -cfg.max_delta_step, cfg.max_delta_step)
    if cfg.path_smooth > K_EPSILON:
        ratio = cnt / cfg.path_smooth
        ret = ret * ratio / (ratio + 1.0) + parent_output / (ratio + 1.0)
    if cfg.use_monotone:
        ret = torch.minimum(torch.maximum(ret, cmin), cmax)
    return ret


def _gain_given_output(g, h, cfg: SplitConfig, output):
    """GetLeafGainGivenOutput (feature_histogram.hpp:841-851)."""
    if cfg.lambda_l1 > 0:
        g = threshold_l1(g, cfg.lambda_l1)
    return -(2.0 * g * output + (h + cfg.lambda_l2) * output * output)


def leaf_gain(g, h, cnt, cfg: SplitConfig, parent_output):
    """GetLeafGain (feature_histogram.hpp:823-839) — no monotone clamp."""
    if cfg.max_delta_step <= 0 and cfg.path_smooth <= K_EPSILON:
        gl1 = threshold_l1(g, cfg.lambda_l1) if cfg.lambda_l1 > 0 else g
        return gl1 * gl1 / (h + cfg.lambda_l2)
    out = _calc_output(g, h, cnt,
                       dataclasses.replace(cfg, use_monotone=False),
                       parent_output, 0.0, 0.0)
    return _gain_given_output(g, h, cfg, out)


# block length of XLA's CPU cumsum (its reduce-window rewriter)
_SCAN_BLOCK = 16


def _prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """float32 inclusive prefix sum over the last axis in the exact
    association of the JAX package's ``jnp.cumsum`` on the CPU: XLA
    rewrites the cumulative reduce-window into blocks of 16 summed in
    order, the block totals scanned the same way (recursively), then
    each block's exclusive carry added. Only float32 additions, so the
    card and the CPU give the same bits, and both the JAX package's."""
    n = x.shape[-1]
    if n <= _SCAN_BLOCK:
        out = x.clone()
        for i in range(1, n):
            out[..., i] += out[..., i - 1]
        return out
    nb = -(-n // _SCAN_BLOCK)
    xp = torch.nn.functional.pad(x, (0, nb * _SCAN_BLOCK - n))
    within = _prefix_sum(xp.reshape(*x.shape[:-1], nb, _SCAN_BLOCK))
    totals = _prefix_sum(within[..., -1])
    carry = torch.nn.functional.pad(totals[..., :-1], (1, 0))
    out = within + carry[..., None]
    return out.reshape(*x.shape[:-1], nb * _SCAN_BLOCK)[..., :n]


# window of XLA's CPU tree-reduction rewrite of a full reduce
_SUM_WINDOW = 32


def xla_sum(x: torch.Tensor) -> torch.Tensor:
    """float32 sum over the last axis in the exact association of the
    JAX package's ``jnp.sum`` on the CPU: XLA rewrites a long reduce
    into a reduce-window of 32 elements (the input zero-padded by
    floor(pad / 2) in front and the rest behind), each window summed in
    order from 0, then reduces the window totals the same way until at
    most 32 are left, which are summed in order. Only float32 additions,
    so the card and the CPU give the same bits, and both the JAX
    package's."""
    n = x.shape[-1]
    if n > _SUM_WINDOW:
        nb = -(-n // _SUM_WINDOW)
        lo = (nb * _SUM_WINDOW - n) // 2
        xp = torch.nn.functional.pad(x, (lo, nb * _SUM_WINDOW - n - lo))
        return xla_sum(xla_sum(xp.reshape(*x.shape[:-1], nb, _SUM_WINDOW)))
    out = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    for i in range(n):
        out = out + x[..., i]
    return out


def dequantize_hist(hist: torch.Tensor, grad_scale, hess_scale
                    ) -> torch.Tensor:
    """Integer histogram -> float32 at the split scan (the JAX package's
    dequantize_hist): quantized training keeps the histogram pool and
    the subtraction in exact int32 level sums, and this is the one
    place they meet float arithmetic. hist: [..., 2] int32 (sum qg, sum
    qh); the scales are float32 scalars of the iteration."""
    scale = torch.stack([torch.as_tensor(grad_scale, dtype=torch.float32,
                                         device=hist.device),
                         torch.as_tensor(hess_scale, dtype=torch.float32,
                                         device=hist.device)])
    return hist.to(torch.float32) * scale


def _round_int(x):
    return torch.floor(x + 0.5).to(torch.int32)


def numerical_split_scan(hist: torch.Tensor, meta: FeatureMeta,
                         cfg: SplitConfig, sum_g, sum_h, num_data,
                         parent_output, cmin, cmax, rand_thresholds=None):
    """Best numerical split per feature.

    hist: [..., F, B, 2]; sum_g / sum_h (WITHOUT the epsilon bias) /
    num_data (int32) / parent_output / cmin / cmax: leaf scalars of
    shape [...]. ``rand_thresholds`` ([F] int32): with
    ``cfg.extra_trees`` the one threshold bin each feature may split at
    (reference USE_RAND). Returns a dict of [..., F] tensors.
    """
    b_dim = hist.shape[-2]
    dev = hist.device

    def e2(x):   # leaf scalar [...] -> [..., 1, 1]
        return torch.as_tensor(x, device=dev)[..., None, None]

    sum_g2, num2 = e2(sum_g), e2(num_data)
    sh2 = e2(sum_h) + 2 * K_EPSILON
    po2, cmin2, cmax2 = e2(parent_output), e2(cmin), e2(cmax)
    bin_ar = torch.arange(b_dim, dtype=torch.int32, device=dev)[None, :]
    nb = meta.num_bin[:, None]                                    # [F,1]
    valid_bin = bin_ar < nb
    g = torch.where(valid_bin, hist[..., 0], 0.0)
    h = torch.where(valid_bin, hist[..., 1], 0.0)
    cnt = _round_int(h * (num2 / sh2))

    mt = meta.missing_type[:, None]
    two_scan = (nb > 2) & (mt != MISSING_NONE)
    miss_bin = torch.where(
        meta.missing_type == MISSING_NAN, meta.num_bin - 1,
        torch.where(meta.missing_type == MISSING_ZERO, meta.default_bin,
                    torch.full_like(meta.num_bin, -1)))[:, None]
    excl = two_scan & (bin_ar == miss_bin)

    cl_g, cl_h = _prefix_sum(torch.stack([torch.where(excl, 0.0, g),
                                          torch.where(excl, 0.0, h)]))
    cl_cnt = torch.cumsum(torch.where(excl, 0, cnt), dim=-1,
                          dtype=torch.int32)
    tot_g, tot_h, tot_cnt = cl_g[..., -1:], cl_h[..., -1:], cl_cnt[..., -1:]

    zero_mode = two_scan & (mt == MISSING_ZERO)
    thr_ok = bin_ar <= nb - 2
    if cfg.extra_trees and rand_thresholds is not None:
        thr_ok = thr_ok & (bin_ar == rand_thresholds.to(dev)[:, None])

    gain_shift = leaf_gain(sum_g2, sh2, num2, cfg, po2)
    min_gain_shift = gain_shift + cfg.min_gain_to_split          # [...,1,1]

    def eval_dir(lg, lh, lcnt, thr_invalid):
        lh_eff = lh + K_EPSILON
        rg = sum_g2 - lg
        rh = sh2 - lh_eff
        rcnt = num2 - lcnt
        ok = (thr_ok & ~thr_invalid
              & (lcnt >= cfg.min_data_in_leaf)
              & (rcnt >= cfg.min_data_in_leaf)
              & (lh_eff >= cfg.min_sum_hessian_in_leaf)
              & (rh >= cfg.min_sum_hessian_in_leaf))
        out_l = _calc_output(lg, lh_eff, lcnt, cfg, po2, cmin2, cmax2)
        out_r = _calc_output(rg, rh, rcnt, cfg, po2, cmin2, cmax2)
        gain = (_gain_given_output(lg, lh_eff, cfg, out_l)
                + _gain_given_output(rg, rh, cfg, out_r))
        if cfg.use_monotone:
            mono = meta.monotone[:, None]
            viol = (((mono > 0) & (out_l > out_r))
                    | ((mono < 0) & (out_l < out_r)))
            gain = torch.where(viol, 0.0, gain)
        ok = ok & (gain > min_gain_shift)
        gain = torch.where(ok, gain, K_MIN_SCORE)
        return gain, out_l, out_r, lg, lh_eff, lcnt

    # forward scan: missing -> right; only in two-scan mode
    f_res = eval_dir(cl_g, cl_h, cl_cnt, zero_mode & (bin_ar == miss_bin))
    f_gain = torch.where(two_scan, f_res[0], K_MIN_SCORE)

    # reverse scan: right side accumulated from the top (missing -> left)
    r_rg = tot_g - cl_g
    r_rh = tot_h - cl_h + K_EPSILON
    r_rcnt = tot_cnt - cl_cnt
    r_lg = sum_g2 - r_rg
    r_lh = sh2 - r_rh - K_EPSILON          # eval_dir re-adds K_EPSILON
    r_lcnt = num2 - r_rcnt
    r_res = eval_dir(r_lg, r_lh, r_lcnt, zero_mode & (bin_ar == miss_bin - 1))

    def order(a_rev, a_fwd):
        return torch.cat([torch.flip(a_rev, dims=[-1]), a_fwd], dim=-1)

    gains = order(r_res[0], f_gain)                               # [..., F, 2B]
    j = torch.argmax(gains, dim=-1, keepdim=True)
    best_gain = torch.gather(gains, -1, j)[..., 0]
    j = j[..., 0]
    is_rev = j < b_dim
    thr = torch.where(is_rev, b_dim - 1 - j, j - b_dim).to(torch.int32)

    def pick(k):
        return torch.gather(order(r_res[k], f_res[k]), -1, j[..., None])[..., 0]

    out_l, out_r, lg, lh, lcnt = (pick(k) for k in range(1, 6))
    default_left = is_rev & ~((meta.missing_type == MISSING_NAN)
                              & (meta.num_bin <= 2))
    found = torch.isfinite(best_gain)
    sum_g1 = torch.as_tensor(sum_g, device=dev)[..., None]
    sum_h1 = torch.as_tensor(sum_h, device=dev)[..., None]
    num1 = torch.as_tensor(num_data, device=dev)[..., None]
    gain_out = torch.where(found, (best_gain - min_gain_shift[..., 0])
                           * meta.penalty, K_MIN_SCORE)
    return {
        "gain": gain_out,
        "threshold": thr,
        "default_left": default_left,
        "left_sum_gradient": lg,
        "left_sum_hessian": lh - K_EPSILON,
        "left_count": lcnt,
        "left_output": out_l,
        "right_sum_gradient": sum_g1 - lg,
        "right_sum_hessian": sum_h1 + K_EPSILON - lh,
        "right_count": num1 - lcnt,
        "right_output": out_r,
        "found": found,
    }


def best_split(hist: torch.Tensor, meta: FeatureMeta, cfg: SplitConfig,
               sum_g, sum_h, num_data, parent_output, cmin, cmax,
               feature_mask=None, rand_thresholds=None, cegb_delta=None,
               gain_scale=None):
    """Per-feature scan + argmax over features. Returns the per-feature
    dict plus ``best_feature`` and ``best_gain`` (shape [...]).
    ``gain_scale`` ([F]) multiplies finite gains (the monotone split
    penalty, reference serial_tree_learner.cpp:728-732); ``cegb_delta``
    ([F]) is then subtracted from them (cost-effective gradient
    boosting, reference cost_effective_gradient_boosting.hpp:66)."""
    if bool(meta.is_categorical.any()):
        raise NotImplementedError(
            "the categorical split scan is not ported yet (ROADMAP A3)")
    res = numerical_split_scan(hist, meta, cfg, sum_g, sum_h, num_data,
                               parent_output, cmin, cmax, rand_thresholds)
    gains = res["gain"]
    finite = torch.isfinite(gains)
    if gain_scale is not None:
        gains = torch.where(finite, gains * gain_scale, gains)
        res["gain"] = gains
    if cegb_delta is not None:
        gains = torch.where(finite, gains - cegb_delta, gains)
        res["gain"] = gains
    if feature_mask is not None:
        gains = torch.where(feature_mask, gains, K_MIN_SCORE)
    best_f = torch.argmax(gains, dim=-1)
    res["best_feature"] = best_f.to(torch.int32)
    res["best_gain"] = torch.gather(gains, -1, best_f[..., None])[..., 0]
    return res
