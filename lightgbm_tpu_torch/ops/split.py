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

Categorical features take ``categorical_split_scan`` (reference
FindBestThresholdCategoricalInner): one-vs-rest for few bins, else the
sorted many-vs-many scan from both ends; ``best_split`` runs it on the
categorical columns only and merges it into the numerical result.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .xla_float import f32_reciprocal, fma_f32

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
    # host tuple of the categorical features' indices: the categorical
    # scan runs on these columns only
    cat_idx: tuple = ()
    # host flag: some feature takes two scans (more than 2 bins and a
    # missing type), so the forward scan is live
    any_two_scan: bool = True

    @classmethod
    def build(cls, num_bin, missing_type, default_bin, is_categorical,
              monotone, penalty, device="cpu") -> "FeatureMeta":
        def t(x, dt):
            return torch.as_tensor(x, dtype=dt, device=device)
        nb, mt = np.asarray(num_bin), np.asarray(missing_type)
        return cls(t(num_bin, torch.int32), t(missing_type, torch.int32),
                   t(default_bin, torch.int32), t(is_categorical, torch.bool),
                   t(monotone, torch.int32), t(penalty, torch.float32),
                   tuple(int(i) for i, c in enumerate(is_categorical) if c),
                   bool(((nb > 2) & (mt != MISSING_NONE)).any()))

    def cat_index(self) -> torch.Tensor:
        """``cat_idx`` as an int64 tensor on the metadata's device, made
        once (a copy to the card inside a captured CUDA graph is not
        allowed)."""
        t = self.__dict__.get("_cat_index")
        if t is None:
            # tpulint: sync-ok(once: memoized in the metadata's __dict__)
            t = torch.as_tensor(self.cat_idx, dtype=torch.int64,
                                device=self.num_bin.device)
            self.__dict__["_cat_index"] = t
        return t

    def subset(self, idx: torch.Tensor, cat_idx: tuple) -> "FeatureMeta":
        """The metadata of the features ``idx``."""
        return FeatureMeta(self.num_bin[idx], self.missing_type[idx],
                           self.default_bin[idx], self.is_categorical[idx],
                           self.monotone[idx], self.penalty[idx], cat_idx,
                           self.any_two_scan)


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
        ratio = cnt * f32_reciprocal(cfg.path_smooth)      # as XLA
        ret = ret * ratio / (ratio + 1.0) + parent_output / (ratio + 1.0)
    if cfg.use_monotone:
        ret = torch.minimum(torch.maximum(ret, cmin), cmax)
    return ret


def _gain_given_output(g, h, cfg: SplitConfig, output, fuse_hoo=False):
    """GetLeafGainGivenOutput (feature_histogram.hpp:841-851),
    -(2·g·o + (h + l2)·o·o), with the multiply-add the JAX package's
    jitted scan fuses: XLA:CPU contracts one of the two products into
    the add, 2·g·o by default and (h + l2)·o·o where ``fuse_hoo`` (which
    one follows the operand order LLVM gives the add in XLA's fusion:
    ``_fuses_hoo``)."""
    if cfg.lambda_l1 > 0:
        g = threshold_l1(g, cfg.lambda_l1)
    ho = (h + cfg.lambda_l2) * output
    if fuse_hoo:
        return -fma_f32(ho, output, 2.0 * g * output)
    return -fma_f32(2.0 * g, output, ho * output)


def _fuses_hoo(cfg: SplitConfig, site: str) -> bool:
    """Whether XLA:CPU fuses (h + l2)·o·o rather than 2·g·o into the
    gain's add at the parent-gain and categorical sites (jaxlib 0.9.0,
    held bit for bit against the JAX package's jitted scans; ROADMAP
    §C): the parent's gain of a clamped or smoothed output under L1
    (``leaf``), the one-vs-rest gains (``cat_onehot``) and the smoothed
    parent's gain (``cat_leaf``) under L1; the sorted scans
    (``cat_sorted``, both directions) never. The numerical scans' sites
    are ``scan_sites``."""
    if site in ("leaf", "cat_onehot", "cat_leaf"):
        return cfg.lambda_l1 > 0
    return False


# The L1 multiply-add sites at 16 bins or fewer, by program and by the
# config's set of the options that move them: clamp (max_delta_step),
# smooth (path_smooth), mono (monotone constraints), l2 (lambda_l2),
# quant (quantized gradients, which only the root scan dequantizes in
# its fusion). Each entry lists the option sets whose sites are the
# key's (forward left, forward right, reverse left, reverse right), 1
# where (h + l2)·o·o is fused; "-" is L1 alone. Read off the dumped IR
# (C9) and fitted per program against the JAX trees node by node (C11);
# every set of up to three options is held bit for bit by the slow
# ``test_option_combinations_bit_equal`` sweep (ROADMAP §C).
_L1_SITES = {
    "host": {
        "1011": "- l2",
        "1000": "mono+l2 clamp+mono+l2",
        "0011": "clamp smooth clamp+smooth clamp+l2",
        "0010": "smooth+l2 clamp+smooth+l2",
        "0000": "mono clamp+mono smooth+mono clamp+smooth+mono "
                "smooth+mono+l2 clamp+smooth+mono+l2",
    },
    "pair": {
        "1011": "-",
        "1000": "mono+l2 clamp+mono+l2",
        "0011": "clamp",
        "0010": "smooth clamp+smooth",
        "0000": "mono l2 clamp+mono clamp+l2 smooth+mono smooth+l2 "
                "clamp+smooth+mono clamp+smooth+l2 smooth+mono+l2 "
                "clamp+smooth+mono+l2",
    },
    "root": {
        "1011": "- mono l2 clamp+mono smooth+mono mono+l2 "
                "clamp+smooth+mono clamp+mono+l2",
        "0011": "clamp smooth clamp+smooth clamp+l2 clamp+quant "
                "smooth+quant clamp+smooth+quant clamp+mono+quant "
                "clamp+l2+quant smooth+mono+quant smooth+l2+quant "
                "clamp+smooth+mono+quant clamp+smooth+l2+quant",
        "0010": "smooth+l2 clamp+smooth+l2 smooth+mono+l2 "
                "clamp+smooth+mono+l2",
        "0000": "quant mono+quant l2+quant mono+l2+quant "
                "clamp+mono+l2+quant smooth+mono+l2+quant "
                "clamp+smooth+mono+l2+quant",
    },
}
_L1_SITE_TABLE = {
    (program, frozenset(o for o in opts.split("+") if o != "-")):
        ((bits[0] == "1", bits[1] == "1"), (bits[2] == "1", bits[3] == "1"))
    for program, rows in _L1_SITES.items()
    for bits, sets in rows.items() for opts in sets.split()}


def scan_sites(cfg: SplitConfig, num_bins: int, forward_folded: bool = False,
               program: str = "host", quantized: bool = False):
    """The numerical scans' multiply-add sites in a jitted scan over
    ``num_bins``-bin histograms: ((forward left, forward right),
    (reverse left, reverse right)), True where XLA:CPU fuses
    (h + l2)·o·o into the gain's add (LLVM contracts the add's first
    operand, whose order its Reassociate ranks set per fusion). Read off
    the JAX programs' dumped IR (``*.ir-with-opt.ll``) and held bit for
    bit against both learners (ROADMAP §C, C2, C4, C7, C9, C11).

    ``forward_folded``: XLA folds the forward scan away, as in the host
    loop's program when no feature takes two scans: 2·g·o everywhere.
    Above 16 bins the bin count decides: the reverse scan of the plain
    config (no L1, clamp, smoothing or monotone constraint) puts
    (h + l2)·o·o first from 64 bins, every other term 2·g·o. Up to 16
    bins, 2·g·o everywhere without L1; under L1 the sites of the
    config's option set in its program, ``_L1_SITES``. ``program``:
    "host" (the host loop's split program), "root" or "pair" (the fused
    learner's root scan and two-leaf scan, two fusions of one program);
    ``quantized``: the fused program dequantizes the histogram inside
    the scan's fusion."""
    none = (False, False)
    if forward_folded:
        return none, none
    if num_bins > 16:
        plain = not (cfg.lambda_l1 > 0 or cfg.max_delta_step > 0
                     or cfg.path_smooth > K_EPSILON or cfg.use_monotone)
        rev = num_bins >= _SCAN_FUSION_BINS and plain
        return none, (rev, rev)
    if not cfg.lambda_l1 > 0:
        return none, none
    opts = {name for name, on in (
        ("clamp", cfg.max_delta_step > 0),
        ("smooth", cfg.path_smooth > K_EPSILON),
        ("mono", cfg.use_monotone), ("l2", cfg.lambda_l2 > 0),
        ("quant", quantized and program == "root")) if on}
    return _L1_SITE_TABLE[program, frozenset(opts)]


def leaf_gain(g, h, cnt, cfg: SplitConfig, parent_output):
    """GetLeafGain (feature_histogram.hpp:823-839) — no monotone clamp."""
    if cfg.max_delta_step <= 0 and cfg.path_smooth <= K_EPSILON:
        gl1 = threshold_l1(g, cfg.lambda_l1) if cfg.lambda_l1 > 0 else g
        return gl1 * gl1 / (h + cfg.lambda_l2)
    out = _calc_output(g, h, cnt,
                       dataclasses.replace(cfg, use_monotone=False),
                       parent_output, 0.0, 0.0)
    return _gain_given_output(g, h, cfg, out, _fuses_hoo(cfg, "leaf"))


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
    # tpulint: sync-ok(device scales on the card paths: as_tensor copies nothing)
    scale = torch.stack([torch.as_tensor(grad_scale, dtype=torch.float32,
                                         device=hist.device),
                         # tpulint: sync-ok(device scales on the card paths: as_tensor copies nothing)
                         torch.as_tensor(hess_scale, dtype=torch.float32,
                                         device=hist.device)])
    return hist.to(torch.float32) * scale


def _round_int(x):
    return torch.floor(x + 0.5).to(torch.int32)


# from this bin count the JAX programs scan each feature in a fusion of
# their own shape: the reverse scan's (h + l2)·o·o site of the plain
# config (``scan_sites``) and the hoisted leaf totals (``sum_levels``)
_SCAN_FUSION_BINS = 64


def numerical_split_scan(hist: torch.Tensor, meta: FeatureMeta,
                         cfg: SplitConfig, sum_g, sum_h, num_data,
                         parent_output, cmin, cmax, rand_thresholds=None,
                         forward_folded=False, program="host",
                         quantized=False, sum_levels=None):
    """Best numerical split per feature.

    hist: [..., F, B, 2]; sum_g / sum_h (WITHOUT the epsilon bias) /
    num_data (int32) / parent_output / cmin / cmax: leaf scalars of
    shape [...]. ``rand_thresholds`` ([F] int32): with
    ``cfg.extra_trees`` the one threshold bin each feature may split at
    (reference USE_RAND). ``forward_folded``: the program's forward
    scan is folded away; ``program`` / ``quantized``: the JAX program
    whose multiply-add sites to take (``scan_sites``).
    ``sum_levels``: (grad level total, grad scale, hess level total,
    hess scale) as float32 leaf scalars when the leaf totals are the
    products of an integer histogram's totals and the scales, as in the
    fused learner's quantized root scan. Below 64 bins the JAX program
    computes each product inside the scan fusion's loop, where LLVM
    contracts it into the subtraction that follows (sum_g - x as one
    FMA, sum_h + 2·eps as another); from 64 bins a differently shaped
    fusion hoists the product out of the loop, rounded (ROADMAP §C,
    C10). The record's right totals, taken after the scan, contract the
    product at every bin count (C12). Returns a dict of [..., F]
    tensors.
    """
    loop_levels = sum_levels if hist.shape[-2] < _SCAN_FUSION_BINS \
        else None
    b_dim = hist.shape[-2]
    dev = hist.device

    def e2(x):   # leaf scalar [...] -> [..., 1, 1]
        # tpulint: sync-ok(device scalars on the card paths: as_tensor copies nothing)
        return torch.as_tensor(x, device=dev)[..., None, None]

    sum_g2, num2 = e2(sum_g), e2(num_data)
    sh2 = e2(sum_h) + 2 * K_EPSILON
    if loop_levels is None:
        def g_less(x):          # sum_g - x
            return sum_g2 - x
    else:
        lg_tot, g_scale, lh_tot, h_scale = (e2(v) for v in loop_levels)

        def g_less(x):
            return fma_f32(g_scale, lg_tot, -x)
        sh2 = fma_f32(h_scale, lh_tot, 2 * K_EPSILON)
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
        # tpulint: capture-ok(extra_trees runs on the host loop, never captured)
        thr_ok = thr_ok & (bin_ar == rand_thresholds.to(dev)[:, None])

    gain_shift = leaf_gain(sum_g2, sh2, num2, cfg, po2)
    min_gain_shift = gain_shift + cfg.min_gain_to_split          # [...,1,1]

    def eval_dir(lg, lh, lcnt, thr_invalid, sites):
        lh_eff = lh + K_EPSILON
        rg = g_less(lg)
        rh = sh2 - lh_eff
        rcnt = num2 - lcnt
        ok = (thr_ok & ~thr_invalid
              & (lcnt >= cfg.min_data_in_leaf)
              & (rcnt >= cfg.min_data_in_leaf)
              & (lh_eff >= cfg.min_sum_hessian_in_leaf)
              & (rh >= cfg.min_sum_hessian_in_leaf))
        out_l = _calc_output(lg, lh_eff, lcnt, cfg, po2, cmin2, cmax2)
        out_r = _calc_output(rg, rh, rcnt, cfg, po2, cmin2, cmax2)
        gain = (_gain_given_output(lg, lh_eff, cfg, out_l, sites[0])
                + _gain_given_output(rg, rh, cfg, out_r, sites[1]))
        if cfg.use_monotone:
            mono = meta.monotone[:, None]
            viol = (((mono > 0) & (out_l > out_r))
                    | ((mono < 0) & (out_l < out_r)))
            gain = torch.where(viol, 0.0, gain)
        ok = ok & (gain > min_gain_shift)
        gain = torch.where(ok, gain, K_MIN_SCORE)
        return gain, out_l, out_r, lg, lh_eff, lcnt

    forward_site, reverse_site = scan_sites(cfg, b_dim, forward_folded,
                                            program, quantized)
    # forward scan: missing -> right; only in two-scan mode
    f_res = eval_dir(cl_g, cl_h, cl_cnt, zero_mode & (bin_ar == miss_bin),
                     forward_site)
    f_gain = torch.where(two_scan, f_res[0], K_MIN_SCORE)

    # reverse scan: right side accumulated from the top (missing -> left)
    r_rg = tot_g - cl_g
    r_rh = tot_h - cl_h + K_EPSILON
    r_rcnt = tot_cnt - cl_cnt
    r_lg = g_less(r_rg)
    r_lh = sh2 - r_rh - K_EPSILON          # eval_dir re-adds K_EPSILON
    r_lcnt = num2 - r_rcnt
    r_res = eval_dir(r_lg, r_lh, r_lcnt, zero_mode & (bin_ar == miss_bin - 1),
                     reverse_site)

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
    # tpulint: sync-ok(device sums on the card paths: as_tensor copies nothing)
    sum_g1 = torch.as_tensor(sum_g, device=dev)[..., None]
    # tpulint: sync-ok(device sums on the card paths: as_tensor copies nothing)
    sum_h1 = torch.as_tensor(sum_h, device=dev)[..., None]
    # tpulint: sync-ok(device counts on the card paths: as_tensor copies nothing)
    num1 = torch.as_tensor(num_data, device=dev)[..., None]
    right_g, right_h = sum_g1 - lg, sum_h1 + K_EPSILON - lh
    if sum_levels is not None:
        # tpulint: sync-ok(root scan: device levels)  # tpulint: capture-ok(root scan only)
        lg_tot, g_scale, lh_tot, h_scale = (torch.as_tensor(
            v, device=dev)[..., None] for v in sum_levels)
        right_g = fma_f32(g_scale, lg_tot, -lg)
        right_h = fma_f32(h_scale, lh_tot, K_EPSILON) - lh
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
        "right_sum_gradient": right_g,
        "right_sum_hessian": right_h,
        "right_count": num1 - lcnt,
        "right_output": out_r,
        "found": found,
    }


def group_thinning(lc: torch.Tensor, lc_ok: torch.Tensor,
                   min_data_per_group: int) -> torch.Tensor:
    """Positions of a sorted categorical scan where the reference's
    stateful group counter fires (feature_histogram.hpp:440-444; the
    JAX package's sequential ``lax.scan``): walking the positions in
    order, the counter adds each position's count; a position whose
    left-side checks pass (``lc_ok``) with the counter at or above
    ``min_data_per_group`` fires and resets it. With ``lc`` the prefix
    counts, position i fires iff lc_ok[i] and lc[i] - lc[p] >=
    min_data_per_group, p the last position that fired before it (lc[p]
    = 0 if none).

    The fired positions form a chain in which each link is the first
    position after the last that qualifies: ``nxt`` gives every link's
    successor at once, and binary lifting over ``nxt`` finds each
    position's last chain link at or before it, in log2(B) steps of
    integer gathers instead of B sequential steps. Exact, like the scan.
    lc / lc_ok: [..., B]; returns [..., B] bool."""
    b = lc.shape[-1]
    dev = lc.device
    # nodes: 0 = the start (count 0), 1..B = positions, B+1 = the end
    base = torch.nn.functional.pad(lc, (1, 0))                # [..., B+1]
    pos = torch.arange(b, device=dev)
    after = pos[None, :] >= torch.arange(b + 1, device=dev)[:, None]
    cand = (after & lc_ok[..., None, :]
            & (lc[..., None, :] - base[..., :, None] >= min_data_per_group))
    nxt = torch.where(cand.any(dim=-1),
                      torch.argmax(cand.to(torch.int8), dim=-1) + 1, b + 1)
    end = torch.full_like(nxt[..., :1], b + 1)
    up = [torch.cat([nxt, end], dim=-1)]                      # [..., B+2]
    for _ in range((b + 1).bit_length() - 1):
        up.append(torch.gather(up[-1], -1, up[-1]))
    q = (pos + 1).expand(lc.shape)
    cur = torch.zeros_like(q)
    for jump in reversed(up):
        to = torch.gather(jump, -1, cur)
        cur = torch.where(to <= q, to, cur)
    return cur == q


def categorical_split_scan(hist: torch.Tensor, meta: FeatureMeta,
                           cfg: SplitConfig, sum_g, sum_h, num_data,
                           parent_output, cmin, cmax, rand_thresholds=None):
    """Best categorical split per feature (reference
    FindBestThresholdCategoricalInner, feature_histogram.hpp:278-515;
    the JAX package's categorical_split_scan).

    One-vs-rest when num_bin <= max_cat_to_onehot (with the original
    l2); else the sorted many-vs-many scan: bins past bin 0 (the unseen
    categories) with a count of at least cat_smooth, sorted by
    g / (h + cat_smooth), scanned as prefixes from both ends up to
    max_cat_threshold categories, with l2 + cat_l2 and the
    min_data_per_group thinning. The shapes are numerical_split_scan's;
    the result adds ``family`` (0 one-vs-rest, 1 forward, 2 backward),
    ``position``, ``sorted_order`` ([..., F, B], the bin at each sorted
    position) and ``used_bin``, which describe the left category set."""
    b_dim = hist.shape[-2]
    dev = hist.device

    def e1(x):   # leaf scalar [...] -> [..., 1]
        # tpulint: sync-ok(device scalars on the card paths: as_tensor copies nothing)
        return torch.as_tensor(x, device=dev)[..., None]

    def e2(x):
        return e1(x)[..., None]

    sum_g2, num2 = e2(sum_g), e2(num_data)
    sh2 = e2(sum_h) + 2 * K_EPSILON
    po2, cmin2, cmax2 = e2(parent_output), e2(cmin), e2(cmax)
    bin_ar = torch.arange(b_dim, dtype=torch.int32, device=dev)[None, :]
    nb = meta.num_bin[:, None]
    valid_bin = (bin_ar < nb) & (bin_ar >= 1)
    g = torch.where(valid_bin, hist[..., 0], 0.0)
    h = torch.where(valid_bin, hist[..., 1], 0.0)
    cnt = _round_int(h * (num2 / sh2))

    cat_cfg = dataclasses.replace(cfg, lambda_l2=cfg.lambda_l2 + cfg.cat_l2)
    if cfg.path_smooth > K_EPSILON:
        gain_shift = _gain_given_output(sum_g2, sh2, cfg, po2,
                                        _fuses_hoo(cfg, "cat_leaf"))
    else:
        gain_shift = leaf_gain(sum_g2, sh2, num2,
                               dataclasses.replace(cfg, path_smooth=0.0), 0.0)
    min_gain_shift = gain_shift + cfg.min_gain_to_split          # [...,1,1]

    def eval_lr(lg, lh, lcnt, ok_extra, ecfg, site):
        lh_eff = lh + K_EPSILON
        rg = sum_g2 - lg
        rh = sh2 - lh_eff
        rcnt = num2 - lcnt
        ok = (ok_extra
              & (lcnt >= cfg.min_data_in_leaf)
              & (rcnt >= cfg.min_data_in_leaf)
              & (lh_eff >= cfg.min_sum_hessian_in_leaf)
              & (rh >= cfg.min_sum_hessian_in_leaf))
        out_l = _calc_output(lg, lh_eff, lcnt, ecfg, po2, cmin2, cmax2)
        out_r = _calc_output(rg, rh, rcnt, ecfg, po2, cmin2, cmax2)
        hoo = _fuses_hoo(cfg, site)
        gain = (_gain_given_output(lg, lh_eff, ecfg, out_l, hoo)
                + _gain_given_output(rg, rh, ecfg, out_r, hoo))
        ok = ok & (gain > min_gain_shift)
        return (torch.where(ok, gain, K_MIN_SCORE), out_l, out_r, lg, lh_eff,
                lcnt)

    use_onehot = nb <= cfg.max_cat_to_onehot
    # extra_trees: one random candidate per feature, the numerical draw
    # reused modulo the categorical bounds (reference USE_RAND)
    rand = cfg.extra_trees and rand_thresholds is not None
    if rand:
        # tpulint: capture-ok(extra_trees runs on the host loop, never captured)
        rt = rand_thresholds.to(dev)[:, None]
        oh_rand_ok = bin_ar == 1 + torch.remainder(
            rt, torch.clamp(nb - 1, min=1))
    else:
        oh_rand_ok = torch.ones_like(valid_bin)

    # ---- one-vs-rest: left = the single category bin, original l2 ----
    oh = eval_lr(g, h, cnt, valid_bin & use_onehot & oh_rand_ok, cfg,
                 "cat_onehot")

    # ---- sorted many-vs-many ---------------------------------------
    usable = valid_bin & (cnt >= cfg.cat_smooth)
    # + 0.0 makes a -0.0 ratio +0.0: the two compare equal, and every
    # stable sort then orders them by bin (a radix sort would not)
    ctr = torch.where(usable, g / (h + cfg.cat_smooth), math.inf) + 0.0
    order = torch.sort(ctr, dim=-1, stable=True).indices       # [..., F, B]
    used_bin = usable.sum(dim=-1).to(torch.int32)               # [..., F]

    # the JAX package permutes by an exact 0/1 product: the sum of x and
    # zeros gives x, but +0.0 for -0.0 (hence + 0.0), and the counts pass
    # through float32
    def permute(x, idx):
        return torch.gather(x, -1, idx) + 0.0
    sg, shh = permute(g, order), permute(h, order)
    scnt = permute(cnt.to(torch.float32), order).to(torch.int32)
    max_num_cat = torch.clamp((used_bin + 1) // 2,
                              max=cfg.max_cat_threshold)[..., None]
    pos_ar = bin_ar
    if rand:
        max_num = torch.clamp(torch.minimum(
            torch.clamp((used_bin + 1) // 2, max=cfg.max_cat_threshold),
            used_bin) - 1, min=1)[..., None]
        sorted_rand_ok = pos_ar == torch.remainder(rt, max_num)
    else:
        sorted_rand_ok = torch.ones_like(valid_bin)
    # both directions at once, stacked on a new leading axis (0 forward,
    # 1 backward): one prefix sum, one thinning, one gain evaluation.
    # Backward: position k reads sorted slot (used_bin - 1 - k) mod B.
    rev = torch.remainder(used_bin[..., None] - 1 - bin_ar,
                          b_dim).to(torch.int64)
    sums = _prefix_sum(torch.stack([sg, shh, permute(sg, rev),
                                    permute(shh, rev)]))
    lg, lh = sums[0::2], sums[1::2]
    lc = torch.cumsum(torch.stack([
        scnt, permute(scnt.to(torch.float32), rev).to(torch.int32)]),
        dim=-1, dtype=torch.int32)
    # the thinning's hessian check reads the FORWARD sorted prefix in
    # both directions, as the JAX package does
    lc_ok = ((lc >= cfg.min_data_in_leaf)
             & (lh[0] + K_EPSILON >= cfg.min_sum_hessian_in_leaf))
    ok = ((pos_ar < torch.minimum(used_bin[..., None], max_num_cat))
          & ~use_onehot & sorted_rand_ok
          & (num2 - lc >= cfg.min_data_per_group)
          & group_thinning(lc, lc_ok, cfg.min_data_per_group))
    srt = eval_lr(lg, lh, lc, ok, cat_cfg, "cat_sorted")

    # candidates in the JAX package's order: one-vs-rest, forward, backward
    def cands(i):
        return torch.cat([oh[i], srt[i][0], srt[i][1]], dim=-1)

    all_gain = cands(0)                                        # [..., F, 3B]
    jk = torch.argmax(all_gain, dim=-1, keepdim=True)
    best_gain = torch.gather(all_gain, -1, jk)[..., 0]

    def pick(i):
        return torch.gather(cands(i), -1, jk)[..., 0]

    j = jk[..., 0]
    found = torch.isfinite(best_gain)
    gain_out = torch.where(found, (best_gain - min_gain_shift[..., 0])
                           * meta.penalty, K_MIN_SCORE)
    lg, lh, lcnt = pick(3), pick(4), pick(5).to(torch.int32)
    return {
        "gain": gain_out,
        "family": (j // b_dim).to(torch.int32),
        "position": (j % b_dim).to(torch.int32),
        "sorted_order": order.to(torch.int32),
        "used_bin": used_bin,
        "left_output": pick(1),
        "right_output": pick(2),
        "left_sum_gradient": lg,
        "left_sum_hessian": lh - K_EPSILON,
        "left_count": lcnt,
        "right_sum_gradient": e1(sum_g) - lg,
        "right_sum_hessian": e1(sum_h) + K_EPSILON - lh,
        "right_count": e1(num_data) - lcnt,
        "found": found,
        "default_left": torch.zeros_like(found),
    }


# the fields the merged scan takes from the categorical result
_MERGED = ("gain", "default_left", "left_sum_gradient", "left_sum_hessian",
           "left_count", "left_output", "right_sum_gradient",
           "right_sum_hessian", "right_count", "right_output", "found")


def merge_categorical(num: dict, hist, meta: FeatureMeta, cfg, sum_g, sum_h,
                       num_data, parent_output, cmin, cmax,
                       rand_thresholds) -> dict:
    """The JAX package's ``any_categorical`` merge: the categorical scan
    runs on the categorical columns only (4 of 28 columns cost the JAX
    package 4.2x per iteration before it made this cut), and its fields
    replace the numerical ones there; ``threshold`` takes the position,
    and the result gains ``cat_family``, ``cat_sorted_order`` and
    ``cat_used_bin`` (zeros on numerical columns)."""
    f_total = hist.shape[-3]
    ci = meta.cat_idx
    # tpulint: capture-ok(cat_index is memoized on the card: .to() copies nothing)
    idx = meta.cat_index().to(hist.device)
    every = len(ci) == f_total
    if every:
        cat = categorical_split_scan(hist, meta, cfg, sum_g, sum_h, num_data,
                                     parent_output, cmin, cmax,
                                     rand_thresholds)
    else:
        cat = categorical_split_scan(
            hist.index_select(-3, idx), meta.subset(idx, ci), cfg, sum_g,
            sum_h, num_data, parent_output, cmin, cmax,
            None if rand_thresholds is None else rand_thresholds[idx])

    def full(v, axis=-1):
        """[..., C] (or [..., C, B]) -> zeros on the other columns."""
        if every:
            return v
        shape = list(v.shape)
        shape[axis] = f_total
        out = torch.zeros(shape, dtype=v.dtype, device=v.device)
        return out.index_copy_(v.dim() + axis, idx, v)

    is_cat = meta.is_categorical
    merged = dict(num)
    for k in _MERGED:
        merged[k] = torch.where(is_cat, full(cat[k]), num[k])
    merged["threshold"] = torch.where(is_cat, full(cat["position"]),
                                      num["threshold"])
    merged["cat_family"] = full(cat["family"])
    merged["cat_used_bin"] = full(cat["used_bin"])
    merged["cat_sorted_order"] = full(cat["sorted_order"], axis=-2)
    return merged


def best_split(hist: torch.Tensor, meta: FeatureMeta, cfg: SplitConfig,
               sum_g, sum_h, num_data, parent_output, cmin, cmax,
               feature_mask=None, rand_thresholds=None, cegb_delta=None,
               gain_scale=None):
    """Per-feature scan + argmax over features. Returns the per-feature
    dict plus ``best_feature`` and ``best_gain`` (shape [...]).
    ``gain_scale`` ([F]) multiplies finite gains (the monotone split
    penalty, reference serial_tree_learner.cpp:728-732); ``cegb_delta``
    ([F]) is then subtracted from them (cost-effective gradient
    boosting, reference cost_effective_gradient_boosting.hpp:66).
    Categorical features (``meta.cat_idx``) take the categorical scan,
    merged in by ``merge_categorical``. This is the host loop's program;
    the fused learner calls the scans itself."""
    res = numerical_split_scan(
        hist, meta, cfg, sum_g, sum_h, num_data, parent_output, cmin, cmax,
        rand_thresholds, not meta.any_two_scan)
    if meta.cat_idx:
        res = merge_categorical(res, hist, meta, cfg, sum_g, sum_h,
                                 num_data, parent_output, cmin, cmax,
                                 rand_thresholds)
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
