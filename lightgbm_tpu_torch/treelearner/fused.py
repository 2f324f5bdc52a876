"""Leaf-wise tree growth over the planar state, on one device.

The port of the JAX package's treelearner/fused.py FusedSerialGrower,
persistent path. Training rows live in the planar ``[P, R]`` int32
state of ops/plane.py (bin-code planes + grad / hess / row-id / label /
score planes). Across iterations the label, score and row id ride
inside the state in leaf-permuted lane order: gradients, tree growth
and the score update all work on the state, and scores go back to row
order only when a host consumer asks (``sync_scores``).

Per split, as in the reference (serial_tree_learner.cpp:152-202): the
best leaf's window is partitioned in place (``plane.partition``, the
CUDA kernel on the card), the smaller child is histogrammed from its
now contiguous window (``histogram.hist_planar``, or
``multival.hist_multival_planar`` on the wide-sparse layout), the
larger child is the parent minus the smaller (histogram pool, reference
feature_histogram.hpp:1061), and both children are scanned in one
batched split scan (ops/split.py).

Where the JAX package runs the whole split loop inside one
``lax.while_loop`` program, the port runs a Python loop over splits.
Each split takes ONE blocking host read: the argmax leaf, its window
start and count (which size the partition and histogram launches), and
whether any leaf still has a positive gain. The smaller child's window
stays on the device; its histogram launch is sized by the parent's
count. Each iteration adds one more read for the finished tree.
``syncs`` counts these reads. Getting to one read per iteration is later
work (ROADMAP).

Quantized-gradient training (``use_quantized_grad``, ops/quantize.py)
quantizes the iteration's gradients with one threefry key per iteration
(the JAX package's keys, so the same levels), writes the packed
(qg << 16) | qh word into the grad plane, and runs the kernels'
quantized modes: the histograms, the pool and the subtraction stay in
exact int32, and ``dequantize_hist`` runs at the split scan. With
``quant_train_renew_leaf`` the leaf values are refit from the float32
gradient sums of each leaf's window.

L1, quantile and MAPE refit each leaf to a percentile of its residuals
label - score before the tree's one read (``_renew_leaf_outputs``):
32-step bisections over the residuals' monotone integer keys, counted
per leaf window by prefix sums, with no read of their own.

Categorical features take the categorical scan (ops/split.py
``merge_categorical``, on the categorical columns only); the left
category set of a categorical split is built on the device as the 8
words of a bin bitset, which ride the split record and route the
partition (B2's categorical route); ``materialize_tree`` turns them
into the tree's inner and raw-category bitset pools.

Objectives without in-state gradients (multiclass and OVA with K trees
per iteration, cross_entropy_lambda, custom objectives) and the boosting
modes with row sampling or score surgery (bagging, GOSS, RF, DART) take
the per-tree path, ``grow_device``: each tree starts from a fresh state
(the cached code planes, the tree's row-order grad / hess, row ids
0..n-1) without label or score planes, and returns each row's leaf,
read off the partitioned windows, for the booster's score update. Under
row sampling the state is bag-ordered instead: once per tree the bin
codes, grad / hess and slot planes are gathered by the [bag | oob]
permutation and packed, the tree grows on the bag's lanes only, and
every row's leaf (out-of-bag rows included) comes from bin-space
traversal of the new tree.

The state is updated IN PLACE (partition, grad/hess and score writes);
the JAX package keeps it immutable and donates it instead.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..config import Config
from ..io.binning import BIN_CATEGORICAL
from ..io.dataset import BinnedDataset
from ..io.efb import per_feature_hist
from ..models.tree import K_CATEGORICAL_MASK, Tree, _to_bitset
from ..ops import histogram as H
from ..ops import multival as MV
from ..ops import plane
from ..ops import quantize as Q
from ..ops import split as S
from ..ops import threefry
from ..ops.xla_float import f32_value, fma_f32

NEG_INF = float("-inf")


def bag_active(config: Config) -> bool:
    """Whether row sampling re-permutes rows away from score order."""
    return ((config.bagging_freq > 0
             and (config.bagging_fraction < 1.0
                  or config.pos_bagging_fraction < 1.0
                  or config.neg_bagging_fraction < 1.0))
            or config.boosting in ("goss", "rf"))


def fused_reject_reason(config: Config, dataset: BinnedDataset,
                        objective) -> Optional[str]:
    """Why a config cannot run the fused path (None = eligible) — the
    JAX package's rule, verbatim. Such configs run on the host-loop
    grower (treelearner/serial.py)."""
    if not config.tpu_fused:
        return "tpu_fused=false"
    if config.tree_learner != "serial":
        return f"tree_learner={config.tree_learner}"
    if max((m.num_bin for m in dataset.bin_mappers
            if m.bin_type == BIN_CATEGORICAL), default=0) > 256:
        return "a categorical feature with > 256 bins (max_bin)"
    if config.forcedsplits_filename:
        pool_mb = config.histogram_pool_size
        need = (max(config.num_leaves, 2) * dataset.num_features
                * max((m.num_bin for m in dataset.bin_mappers), default=2)
                * 2 * 4)
        if not (pool_mb <= 0 or need <= pool_mb * 1024 * 1024):
            return ("forcedsplits_filename with a histogram_pool_size "
                    "too small for the dense pool")
    if config.interaction_constraints:
        return "interaction_constraints"
    if config.extra_trees:
        return "extra_trees"
    if (config.cegb_tradeoff != 1.0 or config.cegb_penalty_split > 0
            or config.cegb_penalty_feature_coupled
            or config.cegb_penalty_feature_lazy):
        return "cegb_* (cost-effective gradient boosting)"
    if config.monotone_constraints and (
            config.monotone_constraints_method != "basic"
            or config.monotone_penalty > 0):
        return ("monotone_constraints_method=intermediate or "
                "monotone_penalty > 0")
    if config.use_quantized_grad:
        persist = (objective is not None
                   and getattr(objective, "persistent_aux", None) is not None
                   and objective.persistent_aux() is not None
                   and objective.num_tree_per_iteration == 1)
        if not persist or config.boosting != "gbdt" or bag_active(config):
            return ("use_quantized_grad outside the persistent path "
                    "(bagging/GOSS/RF/DART or a non-pointwise objective)")
    if objective is not None and objective.is_renew_tree_output:
        if (objective.persistent_renew_spec() is None
                or config.boosting != "gbdt" or bag_active(config)):
            return (f"objective={objective.name} (renew-tree-output leaf "
                    "refit outside the persistent path)")
    if dataset.num_features == 0:
        return "dataset has no usable features"
    return None


def port_reject_reason(config: Config, dataset: BinnedDataset,
                       objective) -> Optional[str]:
    """What the JAX package trains (on either learner) but the port does
    not yet, each with the ROADMAP item that brings it."""
    if config.forcedsplits_filename:
        return "forcedsplits_filename (forced splits, ROADMAP A5)"
    return None


def _leaf_steps_sum(e: torch.Tensor) -> torch.Tensor:
    """Row sums of e [k, L] in the order XLA:CPU (jaxlib 0.9.0) sums the
    fused reduce of the JAX package's ``_score_add_by_pos``: ``xla_sum``,
    but for L in [28, 32], where LLVM vectorizes the reduce: element 0
    peeled, elements 1-24 into two interleaved 4-lane accumulators, a
    pairwise horizontal add, then the rest in order."""
    L = e.shape[-1]
    if not 28 <= L <= 32:
        return S.xla_sum(e)
    b = [e[:, 0] + e[:, 1]] + [e[:, 1 + j] for j in range(1, 4)]
    b = [(b[j] + e[:, 9 + j]) + e[:, 17 + j] for j in range(4)]
    a = [(e[:, 5 + j] + e[:, 13 + j]) + e[:, 21 + j] for j in range(4)]
    r = [a[j] + b[j] for j in range(4)]
    out = (r[0] + r[2]) + (r[1] + r[3])
    for i in range(25, L):
        out = out + e[:, i]
    return out


class FusedSerialGrower:
    """Owns the planar state's layout and grows one tree per iteration
    on ``device``."""

    def __init__(self, dataset: BinnedDataset, config: Config, objective,
                 device) -> None:
        self.dataset = dataset
        self.config = config
        self.objective = objective
        self.device = torch.device(device)
        dev = self.device
        self.num_features = dataset.num_features
        mappers = dataset.bin_mappers
        self.max_num_bin = max((m.num_bin for m in mappers), default=2)
        self.num_leaves = max(config.num_leaves, 2)
        monotone = [dataset.monotone_constraint(i)
                    for i in range(self.num_features)]
        self.use_monotone = any(m != 0 for m in monotone)
        self.any_categorical = any(m.bin_type == BIN_CATEGORICAL
                                   for m in mappers)
        penalty = list(config.feature_contri) + \
            [1.0] * (self.num_features - len(config.feature_contri))
        self.meta = S.FeatureMeta.build(
            num_bin=[m.num_bin for m in mappers],
            missing_type=[m.missing_type for m in mappers],
            default_bin=[m.default_bin for m in mappers],
            is_categorical=[m.bin_type == BIN_CATEGORICAL for m in mappers],
            monotone=monotone,
            penalty=[float(p) for p in penalty[:self.num_features]],
            device=dev)
        self.split_cfg = S.SplitConfig(
            lambda_l1=config.lambda_l1, lambda_l2=config.lambda_l2,
            min_data_in_leaf=config.min_data_in_leaf,
            min_sum_hessian_in_leaf=config.min_sum_hessian_in_leaf,
            min_gain_to_split=config.min_gain_to_split,
            max_delta_step=config.max_delta_step,
            path_smooth=config.path_smooth,
            use_monotone=self.use_monotone,
            max_cat_threshold=config.max_cat_threshold,
            cat_l2=config.cat_l2, cat_smooth=config.cat_smooth,
            max_cat_to_onehot=config.max_cat_to_onehot,
            min_data_per_group=config.min_data_per_group)
        self.miss_bin_np = np.asarray([
            (m.num_bin - 1 if m.missing_type == 2 else
             (m.default_bin if m.missing_type == 1 else -1))
            for m in mappers], dtype=np.int32)
        self.feature_miss_bin = torch.as_tensor(self.miss_bin_np, device=dev)
        # EFB bundle views (None on dense/trivial datasets)
        self._efb_dev = dataset.device_bundle_tables(dev)
        self._efb_hist = dataset.device_hist_tables(dev)
        self.group_max_bin = dataset.group_max_bins
        # the ONE histogram dispatch (ops/histogram.py hist_method): None
        # = the exact float32 plain path on the CPU
        self._hist_method = H.hist_method(config, dataset)
        self._hist_dtype = H.hist_dtype(self._hist_method, config)

        # planar layout: label/score/weight planes for the persistent
        # in-state loop; 4-bit codes when every column fits 16 bins
        self._num_cols = int(dataset.bins.shape[1])
        group_bins = (dataset.group_max_bins if self._efb_hist is not None
                      else self.max_num_bin)
        if group_bins <= 16:
            self._code_bits = 4
        else:
            self._code_bits = 8 * int(np.dtype(dataset.bins.dtype).itemsize)
        self.actual_rows = dataset.num_data
        # the score update reads each row's leaf off the partition only
        # when every row is in the bag; else it traverses the tree
        self._score_from_partition = not bag_active(config)
        self._bins_dev = None
        persist = (objective is not None
                   and objective.persistent_aux() is not None
                   and objective.num_tree_per_iteration == 1)
        has_w = persist and objective.persistent_aux()[1] is not None
        # row-wise multi-value layout (ops/multival.py): the present
        # (group, bin) codes of every row are packed once into K slot
        # planes that ride the planar state, so the partition keeps
        # them row-aligned and the histogram reads K words per row
        # instead of every group's code
        self._mv_codes = None
        self._mv_dev = None
        self._codes_planes = None
        self._mv_total_bins = 0
        self._mv_tables = None
        mv_planes = 0
        if self._hist_method == "multival_pallas":
            occ = dataset.occupancy
            gnb = (dataset.bundles.group_num_bins
                   if dataset.bundles is not None
                   else np.asarray([m.num_bin for m in mappers], np.int32))
            self._mv_codes, mv_layout = MV.build_rowwise_codes(
                dataset.bins, gnb, occ.default_code)
            self._mv_total_bins = mv_layout.total_bins
            self._mv_tables = MV.group_tables(gnb, occ.default_code, dev)
            mv_planes = mv_layout.row_capacity        # a multiple of 8
        self.layout = plane.make_layout(
            self._num_cols, self._code_bits, self.actual_rows,
            with_label=persist, with_score=persist, with_weight=has_w,
            mv_planes=mv_planes)
        self.persistent_capable = persist

        # histogram_pool_size (MB; <= 0 unlimited): pool-less mode
        # computes both children directly, no subtraction
        pool_mb = config.histogram_pool_size
        need = (self.num_leaves * self.num_features
                * self.max_num_bin * 2 * 4)
        self._use_hist_pool = pool_mb <= 0 or need <= pool_mb * 1024 * 1024
        self._col_rng = np.random.RandomState(config.feature_fraction_seed)
        self._mask_ones = None
        # quantized-gradient training: the grad plane carries packed
        # (qg << 16 | qh) words and the histogram pool exact int32 level
        # sums; a host-side iteration counter picks each iteration's
        # stochastic-rounding key (the JAX package's keys)
        self._quant = bool(config.use_quantized_grad)
        self._quant_iter = 0
        self._quant_base_key = (threefry.PRNGKey(config.objective_seed
                                                 ^ 0x51A7)
                                if self._quant else None)
        # blocking host reads (device -> host) taken by the learner
        self.syncs = 0

    # ------------------------------------------------------------------
    def _read(self, t: torch.Tensor) -> list:
        """One blocking device -> host read (counted)."""
        self.syncs += 1
        return t.tolist()

    def _hist_from_groups(self, ghist: torch.Tensor) -> torch.Tensor:
        """Group-level [G, Bg, 2] -> per-feature [F, B, 2] (EFB
        FixHistogram most-frequent-bin reconstruction), or identity."""
        if self._efb_hist is None:
            return ghist
        # the leaf totals from group 0's bins in XLA's reduce order, as
        # the JAX package's program sums them (ROADMAP §C)
        sum_g, sum_h = S.xla_sum(ghist[0].t())
        return per_feature_hist(ghist, self._efb_hist, sum_g, sum_h)

    def _leaf_hist(self, data, start, count, max_count=None):
        """Histogram [F, B, 2] of one lane window straight off the
        planar state: the CUDA kernel on the card, the exact plain path
        on the CPU. ``start``/``count`` may be device scalars, bounded by
        ``max_count``."""
        Ly = self.layout
        if self._hist_method == "multival_pallas":
            return self._leaf_hist_multival(data, start, count, max_count)
        nbins = (self.group_max_bin if self._efb_hist is not None
                 else self.max_num_bin)
        ghist = H.hist_planar(
            data, start, count, num_bins=nbins, num_cols=Ly.num_cols,
            code_bits=Ly.code_bits, grad_plane=Ly.grad,
            dtype=self._hist_dtype, max_count=max_count, quant=self._quant)
        return self._hist_from_groups(ghist)

    def _leaf_hist_multival(self, data, start, count, max_count=None):
        """Leaf histogram off the multi-value slot planes (wide-sparse
        shape): the kernel accumulates a flat [T+1, 2] vector over the
        present codes only; then the group rows are gathered back and
        each group's absent default cell is rebuilt from the sentinel
        leaf totals (flat cell T)."""
        Ly = self.layout
        flat = MV.hist_multival_planar(
            data, start, count, mv_start=Ly.mv_start, mv_planes=Ly.mv_planes,
            total_bins=self._mv_total_bins, grad_plane=Ly.grad,
            dtype=self._hist_dtype, max_count=max_count, quant=self._quant)
        ghist = MV.group_hist_from_flat(flat, self._mv_tables)
        if self._efb_hist is None:
            return ghist
        return per_feature_hist(ghist, self._efb_hist, flat[-1, 0],
                                flat[-1, 1])

    def _scan(self, hist, sum_g, sum_h, count, output, cmin, cmax, mask,
              qscales=None, program="pair"):
        """Best split of K leaves at once (JAX _scan_leaf /
        _scan_two_leaves). All arguments have a leading [K] axis; returns
        (rec_f [7, K] f32: gain, lg, lh, lout, rg, rh, rout;
        rec_i [12, K] i32: feature, threshold bin (a categorical split's
        position), default_left, is_cat, the 8 words of the left
        category bitset). ``qscales``: (grad_scale, hess_scale) when
        ``hist`` holds int32 level sums — the scan itself runs in
        float32. ``program``: the root scan ("root") or the two-leaf scan
        ("pair"), two fusions of the JAX program with their own
        multiply-add sites (``S.scan_sites``)."""
        if qscales is not None:
            hist = S.dequantize_hist(hist, qscales[0], qscales[1])
        res = S.numerical_split_scan(hist, self.meta, self.split_cfg,
                                     sum_g, sum_h, count, output, cmin, cmax,
                                     program=program,
                                     quantized=qscales is not None)
        if self.any_categorical:
            res = S.merge_categorical(res, hist, self.meta, self.split_cfg,
                                      sum_g, sum_h, count, output, cmin,
                                      cmax, None)
        gains = torch.where(mask, res["gain"], S.K_MIN_SCORE)
        f = torch.argmax(gains, dim=-1, keepdim=True)            # [K, 1]

        def at(x):
            return torch.gather(x, -1, f)[:, 0]

        g = at(gains)
        ok = (torch.isfinite(g) & (g > 0.0)
              & (count >= 2 * self.split_cfg.min_data_in_leaf))
        rec_f = torch.stack([
            torch.where(ok, g, NEG_INF),
            at(res["left_sum_gradient"]), at(res["left_sum_hessian"]),
            at(res["left_output"]),
            at(res["right_sum_gradient"]), at(res["right_sum_hessian"]),
            at(res["right_output"])])
        head = torch.stack([f[:, 0].to(torch.int32), at(res["threshold"]),
                            at(res["default_left"]).to(torch.int32)])
        if self.any_categorical:
            cat = self.meta.is_categorical[f[:, 0]].to(torch.int32)
            words = self._cat_bitset_device(res, f)
        else:
            cat = torch.zeros_like(head[0])
            words = torch.zeros((plane.CAT_WORDS, head.shape[1]),
                                dtype=torch.int32, device=head.device)
        return rec_f, torch.cat([head, cat[None], words])

    @staticmethod
    def _cat_bitset_device(res, f) -> torch.Tensor:
        """[8, K] int32 words of the left-category bin bitset of each
        leaf's best feature ``f`` ([K, 1]), built on the device from the
        categorical scan's (family, position, sorted order, used bins)
        (the JAX package's _cat_bitset_device; the host loop's mirror is
        serial.py _cat_bins): family 0 is the single one-vs-rest bin,
        1 / 2 a prefix of the sorted order from its front / from the end
        of its used part."""
        def at(x):
            return torch.gather(x, -1, f)[:, 0].to(torch.int64)[:, None]
        fam, pos, used = (at(res["cat_family"]), at(res["threshold"]),
                          at(res["cat_used_bin"]))
        b_dim = res["cat_sorted_order"].shape[-1]
        order = torch.gather(res["cat_sorted_order"], 1,
                             f[:, :, None].expand(-1, 1, b_dim))[:, 0]
        idx = torch.arange(b_dim, device=f.device)[None, :]
        sel = torch.where(fam == 1, idx <= pos,
                          (idx >= used - 1 - pos) & (idx < used))
        sel = (sel & (fam != 0)) | ((fam == 0) & (idx == 0))
        bins = torch.where(fam == 0, pos, order.to(torch.int64))
        bit = torch.where(sel, torch.ones_like(bins) << (bins & 31), 0)
        word = bins >> 5
        words = torch.stack([torch.where(word == w, bit, 0).sum(dim=1)
                             for w in range(plane.CAT_WORDS)])
        # the unsigned 32-bit words as int32 bit patterns
        return torch.where(words >= 1 << 31, words - (1 << 32),
                           words).to(torch.int32)

    # ------------------------------------------------------------------
    def _grow_tree(self, data: torch.Tensor, n: int,
                   feature_mask: torch.Tensor, qscales=None) -> Dict:
        """Grow one tree over the planar state (partitioned in place).
        Returns the tree arrays as host numpy plus the device leaf
        windows and outputs the score update needs. ``qscales``:
        (grad_scale, hess_scale) 0-d tensors when the grad plane holds
        packed quantized levels: the pool and the subtraction then stay
        in exact int32, dequantized at the scan."""
        L = self.num_leaves
        F, B = self.num_features, self.max_num_bin
        dev = self.device
        f32, i32 = torch.float32, torch.int32
        max_depth = self.config.max_depth
        bynode = feature_mask.dim() == 2
        root_mask = feature_mask[0] if bynode else feature_mask

        root_hist = self._leaf_hist(data, 0, n)
        # leaf totals from feature 0's bins: exact integer sums times the
        # scales, or float32 sums in the JAX package's (XLA's) order —
        # the same bits on the card and the CPU
        if qscales is not None:
            sum_g = root_hist[0, :, 0].sum().to(f32) * qscales[0]
            sum_h = root_hist[0, :, 1].sum().to(f32) * qscales[1]
        else:
            sum_g, sum_h = S.xla_sum(root_hist[0].t())
        one = torch.ones(1, dtype=f32, device=dev)
        rf, ri = self._scan(root_hist[None], sum_g[None], sum_h[None],
                            torch.full((1,), n, dtype=i32, device=dev),
                            0.0 * one, NEG_INF * one, -NEG_INF * one,
                            root_mask[None], qscales, program="root")

        best_f = torch.zeros((7, L), dtype=f32, device=dev)
        best_f[0] = NEG_INF
        best_f[:, 0] = rf[:, 0]
        best_i = torch.zeros((ri.shape[0], L), dtype=i32, device=dev)
        best_i[:, 0] = ri[:, 0]
        # per-leaf rows: sum_g, sum_h, output, cmin, cmax
        leaf_f = torch.zeros((5, L), dtype=f32, device=dev)
        leaf_f[0, 0] = sum_g
        leaf_f[1, 0] = sum_h
        leaf_f[3] = NEG_INF
        leaf_f[4] = -NEG_INF
        # per-leaf rows: window start, window count
        leaf_i = torch.zeros((2, L), dtype=i32, device=dev)
        leaf_i[1, 0] = n
        pool = None
        if self._use_hist_pool:
            pool = torch.zeros((L, F, B, 2), dtype=root_hist.dtype,
                               device=dev)
            pool[0] = root_hist
        depth_ok = (torch.ones(L, dtype=torch.bool, device=dev)
                    if max_depth > 0 else None)
        # internal nodes: rows gain, value, weight / count, then the
        # split record's rows (feature, thr, dl, is_cat, 8 bitset words)
        t_f = torch.zeros((3, max(L - 1, 1)), dtype=f32, device=dev)
        t_i = torch.zeros((1 + ri.shape[0], max(L - 1, 1)), dtype=i32,
                          device=dev)
        # tree STRUCTURE depends only on the leaf ids the host reads, so
        # it is kept on the host (Tree::Split semantics, tree.h:61)
        t_left = np.zeros(max(L - 1, 1), np.int32)
        t_right = np.zeros(max(L - 1, 1), np.int32)
        leaf_parent = np.full(L, -1, np.int32)
        leaf_depth = np.zeros(L, np.int32)

        n_leaves = 1
        while n_leaves < L:
            gains = best_f[0]
            if depth_ok is not None:
                gains = torch.where(depth_ok, gains, NEG_INF)
            best = torch.argmax(gains)
            probe = torch.stack([best, (gains[best] > 0.0).to(torch.int64),
                                 leaf_i[0, best].to(torch.int64),
                                 leaf_i[1, best].to(torch.int64),
                                 best_i[3, best].to(torch.int64)])
            leaf, cont, start, count, is_cat = self._read(probe)
            if not cont:
                break
            node, new = n_leaves - 1, n_leaves

            parent = leaf_parent[leaf]
            if parent >= 0:
                if t_left[parent] == ~leaf:
                    t_left[parent] = node
                else:
                    t_right[parent] = node
            t_left[node] = ~leaf
            t_right[node] = ~new
            t_i[0, node] = leaf_i[1, leaf]
            t_i[1:, node] = best_i[:, leaf]
            t_f[0, node] = best_f[0, leaf]
            t_f[1, node] = leaf_f[2, leaf]
            t_f[2, node] = leaf_f[1, leaf]

            # --- partition the leaf's window in place ---
            feat = best_i[0, leaf]
            cat_route = ({"is_cat": best_i[3, leaf],
                          "cat_bitset": best_i[4:, leaf]}
                         if self.any_categorical else {})
            rscal = plane.route_scalars(
                self.layout, feat, best_i[1, leaf], best_i[2, leaf],
                self.feature_miss_bin[feat], self._efb_dev, device=dev,
                **cat_route)
            data, nleft = plane.partition(data, self.layout, start, count,
                                          rscal, cat=bool(is_cat))
            nright = count - nleft
            left_smaller = nleft <= nright
            s_start = start + torch.where(left_smaller, 0, nleft)
            s_count = torch.where(left_smaller, nleft, nright)
            hist_small = self._leaf_hist(data, s_start, s_count,
                                         max_count=count)

            # --- children bookkeeping ---
            rec = best_f[:, leaf]
            leaf_i[0, new] = start + nleft
            leaf_i[1, leaf] = nleft
            leaf_i[1, new] = nright
            leaf_f[0:3, new] = rec[4:7]
            leaf_f[0:3, leaf] = rec[1:4]
            if self.use_monotone:
                monof = self.meta.monotone[feat]
                mid = (rec[3] + rec[6]) / 2.0
                cmin, cmax = leaf_f[3, leaf].clone(), leaf_f[4, leaf].clone()
                leaf_f[4, leaf] = torch.where(monof > 0,
                                              torch.minimum(cmax, mid), cmax)
                leaf_f[3, new] = torch.where(monof > 0,
                                             torch.maximum(cmin, mid), cmin)
                leaf_f[3, leaf] = torch.where(monof < 0,
                                              torch.maximum(cmin, mid), cmin)
                leaf_f[4, new] = torch.where(monof < 0,
                                             torch.minimum(cmax, mid), cmax)
            else:
                leaf_f[3:5, new] = leaf_f[3:5, leaf]
            depth = int(leaf_depth[leaf]) + 1
            leaf_depth[leaf] = leaf_depth[new] = depth
            leaf_parent[leaf] = leaf_parent[new] = node
            if depth_ok is not None and depth >= max_depth:
                depth_ok[leaf] = False
                depth_ok[new] = False

            # --- larger child: subtraction from the pooled parent ---
            if pool is not None:
                hist_large = pool[leaf] - hist_small
            else:
                hist_large = self._leaf_hist(
                    data, start + torch.where(left_smaller, nleft, 0),
                    torch.where(left_smaller, nright, nleft),
                    max_count=count)
            hist_left = torch.where(left_smaller, hist_small, hist_large)
            hist_right = torch.where(left_smaller, hist_large, hist_small)
            if pool is not None:
                pool[leaf] = hist_left
                pool[new] = hist_right

            # --- best splits of both children (one batched scan) ---
            mask2 = (feature_mask[2 * new - 1:2 * new + 1] if bynode
                     else feature_mask[None].expand(2, F))
            rf, ri = self._scan(
                torch.stack([hist_left, hist_right]),
                torch.stack([leaf_f[0, leaf], leaf_f[0, new]]),
                torch.stack([leaf_f[1, leaf], leaf_f[1, new]]),
                torch.stack([nleft, nright]),
                torch.stack([leaf_f[2, leaf], leaf_f[2, new]]),
                torch.stack([leaf_f[3, leaf], leaf_f[3, new]]),
                torch.stack([leaf_f[4, leaf], leaf_f[4, new]]), mask2,
                qscales)
            best_f[:, leaf] = rf[:, 0]
            best_f[:, new] = rf[:, 1]
            best_i[:, leaf] = ri[:, 0]
            best_i[:, new] = ri[:, 1]
            n_leaves += 1

        k, ni = n_leaves, n_leaves - 1
        renew = (self.objective.persistent_renew_spec()
                 if self.objective is not None else None)
        if renew is not None:
            # the percentile refit of L1, quantile and MAPE, before the
            # tree's one read and before shrinkage (the reference's
            # RenewTreeOutput -> Shrinkage order, gbdt.cpp:379-386); it
            # takes precedence over the quantized refit
            leaf_f[2, :k] = self._renew_leaf_outputs(
                data, n, leaf_i[:, :k], *renew)
        elif qscales is not None and self.config.quant_train_renew_leaf:
            leaf_f[2, :k] = self._renew_quant_leaves(
                data, n, leaf_i[:, :k], leaf_f[:, :k])
        # ONE read for the finished tree: every value array as float64
        # (int32 and float32 values are exact in it)
        flat = torch.cat([t_f[:, :ni].reshape(-1).to(torch.float64),
                          t_i[:, :ni].reshape(-1).to(torch.float64),
                          leaf_f[:3, :k].reshape(-1).to(torch.float64),
                          leaf_i[1, :k].to(torch.float64)])
        host = np.asarray(self._read(flat), dtype=np.float64)
        ri_rows = t_i.shape[0]
        tf = host[:3 * ni].reshape(3, ni)
        ti = host[3 * ni:(3 + ri_rows) * ni].reshape(ri_rows, ni
                                                      ).astype(np.int64)
        lf = host[(3 + ri_rows) * ni:(3 + ri_rows) * ni + 3 * k].reshape(3, k)
        lcnt = host[(3 + ri_rows) * ni + 3 * k:].astype(np.int64)
        ta = dict(
            n_leaves=k, internal_count=ti[0],
            split_feature=ti[1], threshold_bin=ti[2],
            default_left=ti[3].astype(bool), split_cat=ti[4].astype(bool),
            split_bits=(ti[5:].T & 0xFFFFFFFF),
            split_gain=tf[0], internal_value=tf[1], internal_weight=tf[2],
            left_child=t_left[:ni].copy(), right_child=t_right[:ni].copy(),
            leaf_value=lf[2], leaf_weight=lf[1], leaf_count=lcnt,
            leaf_depth=leaf_depth[:k].copy())
        return ta, (leaf_i[:, :k], leaf_f[2, :k])

    def _raw_grads(self, data: torch.Tensor, n: int):
        """float32 gradients / hessians of the objective from the
        state's score, label and weight planes, zero on pad lanes."""
        Ly = self.layout
        score = plane.get_f32(data, Ly.score)
        label = plane.get_f32(data, Ly.label)
        weight = plane.get_f32(data, Ly.weight) if Ly.weight >= 0 else None
        g, h = self.objective.persistent_grads(score, label, weight)
        realm = torch.arange(Ly.num_lanes, device=self.device) < n
        return torch.where(realm, g, 0.0), torch.where(realm, h, 0.0)

    @staticmethod
    def _lane_leaf(win: torch.Tensor, n: int) -> torch.Tensor:
        """[n] int64 leaf of each of the first n lanes, from the leaf
        windows win [2, k] (start, count): the windows tile [0, n) in
        start order, and an empty leaf repeats 0 times (the JAX
        package's _pos_leaf, with no host read)."""
        start, cnt = win[0].long(), win[1].long()
        order = torch.argsort(start, stable=True)
        return torch.repeat_interleave(order, cnt[order], output_size=n)

    def _renew_leaf_outputs(self, data: torch.Tensor, n: int,
                            win: torch.Tensor, alpha: float,
                            weighted: bool) -> torch.Tensor:
        """[k] float32 leaf values: the weighted percentile of each
        leaf's residuals label - score, straight off the planar state
        (the JAX package's _renew_leaf_outputs, the reference's
        RegressionL1loss::RenewTreeOutput and Percentile /
        WeightedPercentileFun, regression_objective.hpp:23-88,249).
        win: [2, k] window start / count. Leaves without rows get 0.

        No sort: each residual maps to a monotone 32-bit key (its
        float bits, sign-flipped), carried as int64 in [0, 2^32), and
        each leaf's order statistic is found by a 32-step bisection
        over key space. A step broadcasts each leaf's candidate key to
        the lanes of its window by a gather (the JAX package sums a
        telescoping [R, L] step matrix for the same exact integers) and
        counts, per leaf, the lanes at or below it: one [R] compare and
        one prefix sum read back at the window ends. Weighted mode sums
        float32 weights instead, in XLA's prefix-sum order
        (``S._prefix_sum``), so the crossing is the JAX package's, and
        then snaps it to a data key with integer rank bisections. As in
        the JAX package, under exact ties the weighted rule counts a
        tie block as one mass, and may pick a neighbouring value where
        the reference walks the sorted rows."""
        Ly = self.layout
        dev = self.device
        i64 = torch.int64
        mask32 = 0xFFFFFFFF
        start, cnt = win[0].long(), win[1].long()
        lanes = Ly.num_lanes
        realm = torch.arange(lanes, device=dev) < n
        resid = plane.get_f32(data, Ly.label) - plane.get_f32(data, Ly.score)
        bits = resid.view(torch.int32).to(i64)
        u = bits & mask32
        ukey = torch.where(bits < 0, ~u & mask32, u | 0x80000000)
        lane_leaf = torch.zeros(lanes, dtype=i64, device=dev)
        lane_leaf[:n] = self._lane_leaf(win, n)
        ends = torch.clamp(start + cnt, min=1) - 1
        sidx = torch.clamp(start, min=1) - 1

        def seg_sums(c):
            """Per-leaf window sums of a [R] (or [T, R]) tensor by one
            prefix sum along the lanes (the last axis): float32 in XLA's
            order, counts exact in int32."""
            if c.dtype == torch.float32:
                cs = S._prefix_sum(c)
            else:
                # one flat scan (a device-wide scan on the card; a
                # row-wise scan of [T, R] is ~10x slower there), then
                # each row less the rows before it
                cs = torch.cumsum(c.reshape(-1), 0,
                                  dtype=torch.int32).view(c.shape)
                if c.dim() == 2:
                    cs = cs - torch.nn.functional.pad(cs[:-1, -1:],
                                                      (0, 0, 1, 0))
            lo = torch.where(start > 0, cs[..., sidx],
                             torch.zeros_like(cs[..., sidx]))
            raw = cs[..., ends] - lo
            raw = torch.where(cnt > 0, raw, torch.zeros_like(raw))
            return raw if raw.dtype == torch.float32 else raw.to(i64)

        def bisect(pred, shape):
            """Smallest key in [0, 2^32) with the monotone pred true."""
            lo = torch.zeros(shape, dtype=i64, device=dev)
            hi = torch.full(shape, mask32, dtype=i64, device=dev)
            for _ in range(32):
                mid = lo + (hi - lo) // 2
                p = pred(mid)
                lo = torch.where(p, lo, (mid + 1) & mask32)
                hi = torch.where(p, mid, hi)
            return lo

        def key_to_f32(k):
            u_orig = torch.where(k < 0x80000000, ~k & mask32,
                                 k & 0x7FFFFFFF)
            return torch.where(u_orig >= 1 << 31, u_orig - (1 << 32),
                               u_orig).to(torch.int32).view(torch.float32)

        def order_stat_keys(targets):
            """Keys at ascending 0-indexed per-leaf ranks ``targets``
            [k, T] (integer-exact counts)."""
            def pred(mid):
                le = (ukey <= mid.t()[:, lane_leaf]) & realm     # [T, R]
                return seg_sums(le.to(torch.int32)).t() >= targets + 1
            return bisect(pred, targets.shape)

        def mass_le(key):
            """Per-leaf weight of the lanes with a key <= ``key`` [k]."""
            return seg_sums(torch.where((ukey <= key[lane_leaf]) & realm,
                                        w, 0.0))

        cnt_m1 = torch.clamp(cnt - 1, min=0)
        if not weighted:
            # PercentileFun: DESCENDING selection at float_pos =
            # (1 - alpha) * cnt; in ascending ranks the two selected
            # order statistics are cnt - pos and cnt - pos - 1
            cf = cnt.to(torch.float32)
            float_pos = cf * f32_value(1.0 - f32_value(alpha))
            pos = torch.floor(float_pos).to(i64)
            bias = float_pos - pos.to(torch.float32)
            edge_max = pos < 1                     # includes cnt <= 1
            edge_min = pos >= cnt
            r_hi = torch.minimum(torch.clamp(cnt - pos, min=0), cnt_m1)
            r_lo = torch.minimum(torch.clamp(cnt - pos - 1, min=0), cnt_m1)
            r_hi = torch.where(edge_max, cnt_m1,
                               torch.where(edge_min, 0, r_hi))
            r_lo = torch.where(edge_max | edge_min, r_hi, r_lo)
            bias = torch.where(edge_max | edge_min, 0.0, bias)
            keys = order_stat_keys(torch.stack([r_hi, r_lo], dim=1))
            v1 = key_to_f32(keys[:, 0])            # d[pos - 1]
            v2 = key_to_f32(keys[:, 1])            # d[pos]
            # XLA contracts v1 - (v1 - v2) * bias into one multiply-add
            # (its negated difference keeps the signed zero of v1 = v2)
            out = fma_f32(-(v1 - v2), bias, v1)
        else:
            # WeightedPercentileFun: ascending weighted CDF, pos =
            # upper_bound(cdf, alpha * total); the value at pos, or the
            # reference's interpolation when the next step's weight is
            # >= 1.0 (with its negative factor, mirrored as is)
            w = torch.where(realm, plane.get_f32(data, Ly.weight), 0.0)
            thresh = seg_sums(w) * f32_value(alpha)
            b = bisect(lambda mid: mass_le(mid) > thresh, cnt.shape)
            c_lt = seg_sums(((ukey < b[lane_leaf]) & realm).to(torch.int32))
            c_lt = torch.minimum(c_lt, cnt_m1)
            keys = order_stat_keys(torch.stack(
                [c_lt, torch.clamp(c_lt - 1, min=0)], dim=1))
            v2k = keys[:, 0]
            v2 = key_to_f32(v2k)                   # value at pos
            v1 = key_to_f32(keys[:, 1])            # value at pos - 1
            wle2 = mass_le(v2k)
            c_le2 = seg_sums(((ukey <= v2k[lane_leaf])
                              & realm).to(torch.int32))
            nxt = order_stat_keys(torch.minimum(c_le2, cnt_m1)[:, None])
            wnext = mass_le(nxt[:, 0]) - wle2
            interp = (c_lt != 0) & (c_le2 < cnt) & (wnext >= 1.0)
            # one multiply-add in XLA: q * (v2 - v1) + v1
            q = (thresh - wle2) / torch.where(wnext == 0, 1.0, wnext)
            out_i = fma_f32(q, v2 - v1, v1)
            out = torch.where(interp, out_i, v2)
        return torch.where(cnt > 0, out, 0.0).to(torch.float32)

    def _renew_quant_leaves(self, data: torch.Tensor, n: int,
                            win: torch.Tensor, leaf_f: torch.Tensor
                            ) -> torch.Tensor:
        """Leaf values from the float32 gradient / hessian sums of each
        leaf after a quantized tree search (the JAX package's
        _renew_quant_leaves, the reference's RenewIntGradTreeOutput):
        the tree keeps the quantized split decisions, its outputs drop
        the rounding error. The raw gradients come from the final
        state's score / label planes (values unchanged by the growth,
        only lane-permuted with the rows); each leaf's window sum is a
        difference of one prefix sum in XLA's order. win: [2, k] window
        start / count; leaf_f: [5, k] sum_g, sum_h, output, cmin,
        cmax."""
        g, h = self._raw_grads(data, n)
        start, count = win[0].long(), win[1].long()
        ends = torch.clamp(start + count, min=1) - 1
        sidx = torch.clamp(start, min=1) - 1

        def seg_sums(c):
            cs = S._prefix_sum(c)
            lo = torch.where(start > 0, cs[sidx], 0.0)
            return torch.where(count > 0, cs[ends] - lo, 0.0)

        sg, sh = seg_sums(g), seg_sums(h)
        cfg = self.split_cfg
        out = -S.threshold_l1(sg, cfg.lambda_l1) \
            / (sh + cfg.lambda_l2 + S.K_EPSILON)
        if cfg.max_delta_step > 0:
            out = torch.clamp(out, -cfg.max_delta_step, cfg.max_delta_step)
        out = torch.minimum(torch.maximum(out, leaf_f[3]), leaf_f[4])
        return torch.where(count > 0, out, leaf_f[2])

    def codes_planes(self) -> torch.Tensor:
        """The bin-code planes of the training rows in row order,
        packed on the device once and cached with the multi-value slot
        planes (``mv_planes``): every unbagged per-tree state starts
        from them (the persistent state drops them once built)."""
        if self._codes_planes is None:
            codes = torch.as_tensor(np.ascontiguousarray(self.dataset.bins),
                                    device=self.device)
            self._codes_planes = plane.build_codes_planes(codes, self.layout)
        self.mv_planes()
        return self._codes_planes

    def mv_planes(self) -> Optional[torch.Tensor]:
        """[K, n] int32 slot-major multi-value codes of the training rows
        on the device (None without the multi-value layout), cached."""
        if self._mv_dev is None and self._mv_codes is not None:
            self._mv_dev = torch.as_tensor(
                np.ascontiguousarray(self._mv_codes.T), device=self.device)
        return self._mv_dev

    def bins_device(self) -> torch.Tensor:
        """The row-major [n, G] bin codes of the training rows on the
        device, uploaded once: the bag branch's gather source and the
        traversal's input."""
        if self._bins_dev is None:
            self._bins_dev = self.dataset.device_bins(self.device)
        return self._bins_dev

    # -- per-tree mode -------------------------------------------------
    def bag_state(self, grad: torch.Tensor, hess: torch.Tensor,
                  perm: torch.Tensor) -> torch.Tensor:
        """The bag-ordered planar state of one tree (the JAX package's
        grow_device bagging branch): the row-major codes, grad / hess
        and slot planes gathered by ``perm`` ([bag | oob]) and packed,
        with ``perm`` as the row ids. One gather per tree, not per
        split."""
        bins = self.bins_device()
        cp = plane.build_codes_planes(bins[perm], self.layout)
        mv = self.mv_planes()
        return plane.build_data(
            self.layout, cp, grad[perm].to(torch.float32),
            hess[perm].to(torch.float32), rowid=perm,
            mv=None if mv is None else mv[:, perm])

    def grow_device(self, grad: torch.Tensor, hess: torch.Tensor,
                    perm: Optional[torch.Tensor] = None,
                    bag_cnt: Optional[int] = None):
        """One tree from row-order gradients (the JAX package's
        grow_device). Returns the tree arrays (host numpy, leaf values
        before shrinkage) and leaf_of_row [n] int64 on the device.

        Unbagged (``_score_from_partition``): a fresh planar state from
        the cached code planes, grad / hess [n] float32 in row order,
        row ids 0..n-1 and the slot planes; each row's leaf is its
        lane's leaf scattered back to row order through the row-id
        plane. Under row sampling: the bag-ordered state of
        ``bag_state``, the tree grown on lanes [0, bag_cnt) (root sums
        from the bag's histogram), and every row's leaf, out-of-bag
        rows included, by bin-space traversal of the new tree over the
        full codes."""
        n = self.actual_rows
        masks = self.feature_masks_for_tree()
        if not self._score_from_partition:
            data = self.bag_state(grad, hess, perm)
            ta, _ = self._grow_tree(data, int(bag_cnt), masks)
            del data
            tree = self.materialize_tree(ta)
            return ta, tree.leaf_index_binned(
                self.bins_device(), self.feature_miss_bin, self._efb_dev)
        cp = self.codes_planes()
        data = plane.build_data(self.layout, cp, grad.to(torch.float32),
                                hess.to(torch.float32), mv=self._mv_dev)
        ta, (win, _) = self._grow_tree(data, n, masks)
        rowids = data[self.layout.rowid, :n].long()
        leaf_of_row = torch.empty(n, dtype=torch.int64, device=self.device)
        leaf_of_row[rowids] = self._lane_leaf(win, n)
        return ta, leaf_of_row

    # -- persistent mode -----------------------------------------------
    def init_persistent_state(self, score_vec: np.ndarray) -> torch.Tensor:
        """Planar state carrying label/score/row-id across iterations.
        score_vec: [n] current raw scores in ORIGINAL row order."""
        assert self.persistent_capable
        dev = self.device
        aux_label, aux_weight = self.objective.persistent_aux()
        n = self.actual_rows
        cp = self.codes_planes()
        zeros = torch.zeros(n, dtype=torch.float32, device=dev)

        def up(a):
            if a is None or torch.is_tensor(a):
                return None if a is None else a.to(dev, torch.float32)
            return torch.as_tensor(np.asarray(a, np.float32), device=dev)
        data = plane.build_data(self.layout, cp, zeros, zeros,
                                label=up(aux_label),
                                score=up(score_vec), weight=up(aux_weight),
                                mv=self._mv_dev)
        # the state is built once: keep no second device copy of it
        self._codes_planes = self._mv_dev = None
        return data

    def train_iter(self, data: torch.Tensor, shrinkage: float,
                   bias: float = 0.0) -> Dict:
        """One boosting iteration on the persistent state, in place:
        gradients from the in-state score, tree growth, score update
        (GBDT::TrainOneIter, gbdt.cpp:337). Returns the tree arrays
        (host numpy, leaf values before shrinkage)."""
        Ly = self.layout
        n = self.actual_rows
        g, h = self._raw_grads(data, n)
        qscales = None
        if self._quant:
            # one quantization pass per iteration, keyed by fold_in of
            # the base key with the iteration counter
            key = threefry.fold_in(self._quant_base_key, self._quant_iter)
            self._quant_iter += 1
            qg, qh, gs, hs = Q.quantize_gradients(
                g, h, self.config.num_grad_quant_bins, key,
                stochastic=self.config.stochastic_rounding, reciprocal=True)
            qscales = (gs, hs)
            plane.set_gh_packed(data, Ly,
                                plane.i32_as_f32(Q.pack_gh(qg, qh)))
        else:
            plane.set_gh(data, Ly, g, h)

        ta, (win, leaf_out) = self._grow_tree(
            data, n, self.feature_masks_for_tree(), qscales)

        vals = leaf_out * torch.tensor(shrinkage, dtype=torch.float32)
        s = plane.get_f32(data, Ly.score, n)
        s.add_(self._score_add(win, vals, ta["leaf_count"], n))
        # always, as the JAX package: adding 0.0 turns a -0.0 score to +0.0
        s.add_(torch.tensor(bias, dtype=torch.float32, device=s.device))
        return ta

    def _score_add(self, win, vals, leaf_count, n: int) -> torch.Tensor:
        """[n] score increment by window (every lane of leaf l's window
        gets leaf l's value; no gather, no scatter) with the bits of the
        JAX package's ``_score_add_by_pos``: over the leaves with rows,
        sorted by window start, the differences of consecutive values
        summed over ``num_leaves`` terms in XLA's reduce order. One
        [leaves, num_leaves] table gives each leaf its value."""
        keep = torch.as_tensor(np.nonzero(np.asarray(leaf_count) > 0)[0],
                               device=self.device)
        idx = keep[torch.argsort(win[0][keep])]
        v = vals[idx]
        d = v - torch.nn.functional.pad(v[:-1], (1, 0))
        L = self.num_leaves
        steps = (torch.arange(v.shape[0], device=v.device)[:, None]
                 >= torch.arange(L, device=v.device)[None, :])
        d = torch.nn.functional.pad(d, (0, L - v.shape[0]))
        table = _leaf_steps_sum(torch.where(steps, d, 0.0))
        return torch.repeat_interleave(table, win[1][idx].long(),
                                       output_size=n)

    def sync_scores(self, data: torch.Tensor) -> torch.Tensor:
        """[n] f32 raw scores in original row order (one scatter)."""
        n = self.actual_rows
        rowids = data[self.layout.rowid, :n].long()
        out = torch.empty(n, dtype=torch.float32, device=self.device)
        out[rowids] = plane.get_f32(data, self.layout.score, n)
        return out

    # ------------------------------------------------------------------
    # ------------------------------------------------------------------
    def _tree_mask_np(self) -> np.ndarray:
        f = self.num_features
        mask = np.ones(f, dtype=bool)
        frac = self.config.feature_fraction
        if frac < 1.0:
            k = max(1, int(np.ceil(frac * f)))
            chosen = self._col_rng.choice(f, size=k, replace=False)
            mask[:] = False
            mask[chosen] = True
        return mask

    def feature_masks_for_tree(self) -> torch.Tensor:
        """[F] per-tree mask, or [2L, F] per-scan-event masks when
        feature_fraction_bynode < 1 (event 0 = root scan, events
        2*new_leaf-1 / 2*new_leaf = the two children of the split that
        created leaf slot new_leaf) — the JAX package's rule and RNG."""
        frac = self.config.feature_fraction_bynode
        if frac >= 1.0:
            if self.config.feature_fraction >= 1.0:
                if self._mask_ones is None:
                    self._mask_ones = torch.ones(
                        self.num_features, dtype=torch.bool,
                        device=self.device)
                return self._mask_ones
            return torch.as_tensor(self._tree_mask_np(), device=self.device)
        tm = self._tree_mask_np()
        idx = np.flatnonzero(tm)
        k = max(1, int(np.ceil(frac * len(idx))))
        E = 2 * self.num_leaves
        masks = np.zeros((E, self.num_features), dtype=bool)
        for e in range(E):
            masks[e, self._col_rng.choice(idx, size=k, replace=False)] = True
        return torch.as_tensor(masks, device=self.device)

    def materialize_tree(self, ta: Dict) -> Tree:
        """Host tree arrays -> Tree (real feature ids, real thresholds,
        decision_type bits)."""
        k = int(ta["n_leaves"])
        tree = Tree(self.num_leaves)
        tree.num_leaves = k
        ni = max(k - 1, 0)
        mappers = self.dataset.bin_mappers
        real_idx = self.dataset.real_feature_index
        inner_feat = ta["split_feature"][:ni]
        tree.split_feature_inner[:ni] = inner_feat
        tree.split_feature[:ni] = [real_idx[f] for f in inner_feat]
        for i, f in enumerate(inner_feat):
            m = mappers[f]
            if ta["split_cat"][i]:
                # the left-category sets from the device bitset
                # (Tree::Split categorical case, tree.cpp:70-91)
                words = ta["split_bits"][i]
                bin_set = [b for b in range(m.num_bin)
                           if (words[b >> 5] >> (b & 31)) & 1]
                cat_vals = sorted(m.bin_2_categorical[b] for b in bin_set
                                  if m.bin_2_categorical[b] >= 0)
                tree.decision_type[i] = K_CATEGORICAL_MASK | (
                    (m.missing_type & 3) << 2)
                tree.threshold_in_bin[i] = tree.num_cat
                tree.threshold[i] = tree.num_cat
                tree.num_cat += 1
                inner, raw = _to_bitset(bin_set), _to_bitset(cat_vals)
                tree.cat_boundaries_inner.append(
                    tree.cat_boundaries_inner[-1] + len(inner))
                tree.cat_threshold_inner.extend(inner)
                tree.cat_boundaries.append(tree.cat_boundaries[-1] + len(raw))
                tree.cat_threshold.extend(raw)
            else:
                tb = int(ta["threshold_bin"][i])
                tree.threshold_in_bin[i] = tb
                tree.threshold[i] = m.bin_to_value(tb)
                tree.decision_type[i] = ((2 if ta["default_left"][i] else 0)
                                         | ((m.missing_type & 3) << 2))
        tree.left_child[:ni] = ta["left_child"][:ni]
        tree.right_child[:ni] = ta["right_child"][:ni]
        tree.split_gain[:ni] = ta["split_gain"][:ni]
        tree.internal_value[:ni] = ta["internal_value"][:ni]
        tree.internal_weight[:ni] = ta["internal_weight"][:ni]
        tree.internal_count[:ni] = ta["internal_count"][:ni]
        tree.leaf_value[:k] = ta["leaf_value"][:k]
        tree.leaf_weight[:k] = ta["leaf_weight"][:k]
        tree.leaf_count[:k] = ta["leaf_count"][:k]
        tree.leaf_depth[:k] = ta["leaf_depth"][:k]
        return tree
