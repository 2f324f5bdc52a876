"""Leaf-wise (best-first) tree grower with a host control loop.

The port of the JAX package's treelearner/serial.py SerialTreeGrower
(re-design of the reference SerialTreeLearner,
serial_tree_learner.cpp:152-202: BeforeTrain, then repeatedly
ConstructHistograms, FindBestSplitsFromHistograms with subtraction for
the larger leaf at :396-404, ArgMax over leaves, Split at :541). It
serves every option the fused grower turns away: ``tpu_fused=false``,
``extra_trees``, interaction constraints, CEGB, and intermediate
monotone constraints or a monotone penalty.

Per split the device runs a partition of the leaf's permutation window
(ops/partition.py, plain PyTorch), the smaller child's histogram (the
row-major kernel ``histogram.hist_radix``, or ``multival.hist_multival``
on the wide-sparse layout, each after a PyTorch gather of the leaf's
rows) and one split scan per child (ops/split.py). The loop itself runs
on the host, as in the JAX package: one blocking read for the left
count of each split and one per child for its best split (``syncs``
counts them). The histogram pool is a per-leaf histogram kept until the
leaf splits; ``histogram_pool_size`` too small for it recomputes leaf
histograms on demand instead of subtracting.

Quantized-gradient training (``use_quantized_grad``) quantizes each
tree's gradients once (ops/quantize.py, the JAX package's threefry keys);
the leaf histograms then run the kernels' int32 modes, the pool and the
subtraction stay exact, and ``dequantize_hist`` runs at the split scan.
With ``quant_train_renew_leaf`` the leaf values are refit from the float
gradient sums.

Telemetry (obs/): the leaf histogram, each leaf's split scan with its
read, and the partition with its left-count read run under the core
phases ``hist``, ``split`` and ``partition`` (wrapped at build time, as
the JAX host loop's dispatchers are), which never nest; every read goes
through utils/device.py ``device_get``.

Forced splits (``forcedsplits_filename``, reference
SerialTreeLearner::ForceSplits) run breadth-first before the best-first
loop: each takes its leaf's pooled histogram of the forced feature to
the host in one read and sums the left side there in float64, as the
JAX package does.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import obs
from ..config import Config
from ..io.binning import BIN_CATEGORICAL
from ..io.dataset import BinnedDataset
from ..io.efb import per_feature_hist
from ..models.tree import Tree
from ..ops import histogram as H
from ..ops import multival as MV
from ..ops import quantize as Q
from ..ops import split as S
from ..ops import threefry
from ..ops.partition import partition_leaf
from ..utils import device as _device
from ..utils import log
from .monotone import MonotoneState, monotone_penalty_factor


class _Leaf:
    __slots__ = ("start", "count", "sum_g", "sum_h", "output", "depth",
                 "hist", "best", "cmin", "cmax")

    def __init__(self, start, count, sum_g, sum_h, output, depth,
                 hist=None, best=None, cmin=-np.inf, cmax=np.inf):
        self.start = start
        self.count = count
        self.sum_g = sum_g
        self.sum_h = sum_h
        self.output = output
        self.depth = depth
        self.hist = hist
        self.best = best
        self.cmin = cmin
        self.cmax = cmax


class SerialTreeGrower:
    """Grows one tree per call on ``device``; owns the device copy of
    the dataset's bin matrix (uploaded at first use)."""

    def __init__(self, dataset: BinnedDataset, config: Config,
                 device) -> None:
        self.dataset = dataset
        self.config = config
        self.device = torch.device(device)
        dev = self.device
        self.num_features = dataset.num_features
        mappers = dataset.bin_mappers
        self.max_num_bin = max((m.num_bin for m in mappers), default=2)
        monotone = [dataset.monotone_constraint(i)
                    for i in range(self.num_features)]
        self.use_monotone = any(m != 0 for m in monotone)
        self.any_categorical = any(m.bin_type == BIN_CATEGORICAL
                                   for m in mappers)
        self._monotone_np = np.asarray(monotone, dtype=np.int32)
        self._mono_state = None
        penalty = list(config.feature_contri) + \
            [1.0] * (self.num_features - len(config.feature_contri))
        # miss bin per feature for bin-space routing (NaN bin = last,
        # Zero mode = default bin; -1 = no routing; categorical routing
        # is bitset membership)
        self.feature_miss_bin = np.asarray([
            -1 if m.bin_type == BIN_CATEGORICAL else
            (m.num_bin - 1 if m.missing_type == 2 else
             (m.default_bin if m.missing_type == 1 else -1))
            for m in mappers], dtype=np.int32)
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
            extra_trees=config.extra_trees,
            max_cat_threshold=config.max_cat_threshold,
            cat_l2=config.cat_l2, cat_smooth=config.cat_smooth,
            max_cat_to_onehot=config.max_cat_to_onehot,
            min_data_per_group=config.min_data_per_group)
        self._efb_dev = dataset.device_bundle_tables(dev)
        self._efb_hist = dataset.device_hist_tables(dev)
        self.group_max_bin = dataset.group_max_bins
        # the ONE histogram dispatch (ops/histogram.py hist_method)
        self.hist_method = H.hist_method(config, dataset)
        self._hist_dtype = H.hist_dtype(self.hist_method, config)
        self._bins = None
        self._mv_state = None

        self._col_rng = np.random.RandomState(config.feature_fraction_seed)
        self._extra_rng = np.random.RandomState(config.extra_seed)
        self._interaction_sets = _parse_interaction_constraints(
            config.interaction_constraints, dataset)
        # CEGB state (reference cost_effective_gradient_boosting.hpp:27
        # IsEnable + the feature-used tracking consumed by DetlaGain :66)
        self._cegb_enabled = (
            config.cegb_tradeoff != 1.0 or config.cegb_penalty_split > 0.0
            or bool(config.cegb_penalty_feature_coupled)
            or bool(config.cegb_penalty_feature_lazy))
        self._cegb_coupled_used = np.zeros(self.num_features, dtype=bool)
        # histogram_pool_size (MB; <= 0 unlimited): when the per-leaf
        # histogram set would not fit, drop leaf histograms after their
        # best-split scan and recompute on demand (no subtraction)
        pool_mb = config.histogram_pool_size
        need = (config.num_leaves * self.num_features
                * self.max_num_bin * 2 * 4)
        self._keep_hists = pool_mb <= 0 or need <= pool_mb * 1024 * 1024
        if not self._keep_hists:
            log.info("histogram pool (%.0f MB) exceeds histogram_pool_size"
                     "=%.0f MB: recomputing leaf histograms on demand",
                     need / 1e6, pool_mb)
        self._cur_perm = None
        self._cur_grad = None
        self._cur_hess = None
        # quantized-gradient training: per-tree scales of the current
        # tree (None on the float32 path) and the tree counter that
        # picks each tree's stochastic-rounding key
        self._quant = bool(config.use_quantized_grad)
        self._qscales = None
        self._quant_tree_idx = 0
        self._quant_prefetch = Q.PrefetchedQuant()
        self._qscales_host = None
        self._forced_splits = _load_forced_splits(
            config.forcedsplits_filename)
        # blocking device -> host reads taken by the learner
        self.syncs = 0

    # ------------------------------------------------------------------
    @property
    def bins(self) -> torch.Tensor:
        """Row-major [N, G] bin matrix on the device (uint8, or int32
        for 16-bit codes), uploaded at first use."""
        if self._bins is None:
            self._bins = self.dataset.device_bins(self.device)
        return self._bins

    def _multival_state(self):
        """The row-wise multi-value view of the dataset (ops/multival.py),
        built at first use: (codes [N, K] int32 on the device, T, group
        tables)."""
        if self._mv_state is None:
            ds = self.dataset
            occ = ds.occupancy
            gnb = (ds.bundles.group_num_bins if ds.bundles is not None
                   else np.asarray([m.num_bin for m in ds.bin_mappers],
                                   np.int32))
            codes, lay = MV.build_rowwise_codes(ds.bins, gnb,
                                                occ.default_code)
            # tpulint: sync-ok(once: cached in _mv_state)
            self._mv_state = (torch.as_tensor(codes, device=self.device),
                              lay.total_bins,
                              MV.group_tables(gnb, occ.default_code,
                                              self.device))
        return self._mv_state

    def _read(self, t: torch.Tensor) -> list:
        """One blocking device -> host read (counted)."""
        self.syncs += 1
        return _device.device_get(t).tolist()

    def _leaf_hist(self, perm, start: int, count: int, grad, hess
                   ) -> torch.Tensor:
        """Per-feature histogram [F, B, 2] of one leaf's rows."""
        if self.hist_method == "multival_pallas":
            codes, total_bins, tables = self._multival_state()
            flat = MV.leaf_histogram_multival(
                codes, perm, start, count, grad, hess, None, total_bins,
                dtype=self._hist_dtype)
            ghist = MV.group_hist_from_flat(flat, tables)
            if self._efb_hist is None:
                return ghist
            return per_feature_hist(ghist, self._efb_hist, flat[-1, 0],
                                    flat[-1, 1])
        return self._efb_expand(self._group_hist(perm, start, count, grad,
                                                 hess))

    # telemetry: the dispatchers run under their phases (obs/spans.py),
    # wrapped once here, on the class, so that no learner holds a
    # reference to itself and each is freed when its last user drops it
    _leaf_hist = obs.instrument_kernel(_leaf_hist, "hist",
                                       name="serial/leaf_histogram")
    _partition = staticmethod(obs.instrument_kernel(
        partition_leaf, "partition", name="serial/partition_leaf"))

    def _group_hist(self, perm, start, count, grad, hess) -> torch.Tensor:
        """One leaf's histogram over the bin matrix's columns: [G, Bg, 2]
        in bundle space under EFB (G << F columns), else [F, B, 2]."""
        nbins = (self.group_max_bin if self._efb_hist is not None
                 else self.max_num_bin)
        # method None: the float32 plain path (CPU)
        return H.leaf_histogram(self._grow_bins, perm, start, count, grad,
                                hess, None, nbins, method=self.hist_method)

    def _efb_expand(self, ghist: torch.Tensor) -> torch.Tensor:
        """Bundle space -> per-feature [F, B, 2] by the FixHistogram
        most-frequent-bin reconstruction (the identity without EFB)."""
        if self._efb_hist is None:
            return ghist
        # every row in one code of group 0: the leaf totals, in XLA's
        # order as the JAX package's programs sum them
        total = S.xla_sum(ghist[0].t())
        return per_feature_hist(ghist, self._efb_hist, total[0], total[1])

    @property
    def _grow_bins(self) -> torch.Tensor:
        """The bin matrix that histograms read: every row here (one
        rank's rows under the data-parallel learner)."""
        return self.bins

    # ------------------------------------------------------------------
    def _feature_mask_tree(self) -> np.ndarray:
        """Per-tree feature_fraction sampling (reference
        col_sampler.hpp:20 ResetByTree)."""
        f = self.num_features
        mask = np.ones(f, dtype=bool)
        frac = self.config.feature_fraction
        if frac < 1.0:
            k = max(1, int(np.ceil(frac * f)))
            chosen = self._col_rng.choice(f, size=k, replace=False)
            mask[:] = False
            mask[chosen] = True
        return mask

    def _feature_mask_node(self, tree_mask: np.ndarray,
                           branch_features: Optional[set]) -> np.ndarray:
        """Per-node sampling + interaction constraints (reference
        col_sampler.hpp GetByNode)."""
        mask = tree_mask
        frac = self.config.feature_fraction_bynode
        if frac < 1.0:
            idx = np.flatnonzero(mask)
            k = max(1, int(np.ceil(frac * len(idx))))
            chosen = self._col_rng.choice(idx, size=k, replace=False)
            mask = np.zeros_like(mask)
            mask[chosen] = True
        if self._interaction_sets and branch_features is not None:
            allowed = np.zeros_like(mask)
            for s in self._interaction_sets:
                if branch_features <= s:
                    for fi in s:
                        if fi < len(allowed):
                            allowed[fi] = True
            mask = mask & allowed
        return mask

    def _cegb_delta(self, leaf: _Leaf) -> Optional[torch.Tensor]:
        """Cost-Effective Gradient Boosting gain penalty per feature
        (reference cost_effective_gradient_boosting.hpp DetlaGain :66:
        tradeoff * (penalty_split * n_leaf + the coupled penalty while
        the feature is unused + the lazy penalty per leaf row))."""
        if not self._cegb_enabled:
            return None
        cfg = self.config
        delta = np.full(self.num_features,
                        cfg.cegb_penalty_split * leaf.count,
                        dtype=np.float64)
        coupled = cfg.cegb_penalty_feature_coupled
        lazy = cfg.cegb_penalty_feature_lazy
        for i, real in enumerate(self.dataset.real_feature_index):
            if coupled and real < len(coupled) \
                    and not self._cegb_coupled_used[i]:
                delta[i] += coupled[real]
            if lazy and real < len(lazy):
                delta[i] += lazy[real] * leaf.count
        return _device.upload((delta * cfg.cegb_tradeoff).astype(np.float32),
                              self.device)

    def _rand_thresholds(self) -> Optional[torch.Tensor]:
        """extra_trees: one random threshold bin per feature and tree,
        drawn from ``np.random.RandomState(extra_seed)`` as in the JAX
        package."""
        if not self.config.extra_trees:
            return None
        nb = np.asarray([m.num_bin for m in self.dataset.bin_mappers])
        hi = np.maximum(nb - 2, 1)
        r = self._extra_rng.randint(0, 1 << 30, size=self.num_features) % hi
        return _device.upload(r.astype(np.int32), self.device)

    # ------------------------------------------------------------------
    def _quant_key(self, idx: int) -> torch.Tensor:
        """The stochastic-rounding key of the idx-th quantized tree."""
        return threefry.fold_in(
            threefry.PRNGKey(self.config.objective_seed ^ 0x51A7), idx)

    def prefetch_quantize(self, grad: torch.Tensor,
                          hess: torch.Tensor) -> None:
        """Enqueue the quantization of an upcoming ``grow`` call now, up
        to two trees ahead (ops/quantize.py ``PrefetchedQuant``). Key
        indices advance as the inline path's would, so the draws are
        the same; a no-op on the float32 path."""
        if not self._quant or self._quant_prefetch.full:
            return
        cfg = self.config
        idx = self._quant_tree_idx + len(self._quant_prefetch)
        self._quant_prefetch.push(idx, grad, hess, Q.quantize_gradients(
            grad, hess, cfg.num_grad_quant_bins, self._quant_key(idx),
            cfg.stochastic_rounding))

    def grow(self, grad: torch.Tensor, hess: torch.Tensor,
             perm: torch.Tensor, num_data: int) -> Tree:
        """Train one tree (reference SerialTreeLearner::Train,
        serial_tree_learner.cpp:152-202). grad/hess: [N] float32 on the
        device (zero outside the bag); perm: [N] int64 permutation with
        the bag's rows in [0, num_data)."""
        cfg = self.config
        tree = Tree(cfg.num_leaves,
                    track_branch_features=bool(self._interaction_sets))
        tree_mask = self._feature_mask_tree()
        rand_thr = self._rand_thresholds()
        if self.use_monotone:
            self._mono_state = MonotoneState(
                cfg.monotone_constraints_method, cfg.num_leaves,
                self._monotone_np)
        raw_grad, raw_hess = grad, hess
        self._qscales = None
        if self._quant:
            # one quantization pass per tree; histograms, the pool and
            # the subtraction then run in exact int32 level space. The
            # pass was usually enqueued ahead (prefetch_quantize); the
            # inline one takes the same key and gives the same bits
            with obs.span("gradient quantization", phase="quantize"):
                Q.note_requantize(cfg.num_grad_quant_bins)
                pre = self._quant_prefetch.pop_match(
                    self._quant_tree_idx, grad, hess)
                if pre is None:
                    pre = Q.quantize_gradients(
                        grad, hess, cfg.num_grad_quant_bins,
                        self._quant_key(self._quant_tree_idx),
                        cfg.stochastic_rounding)
            self._quant_tree_idx += 1
            grad, hess, gs, hs = pre
            self._qscales = (gs, hs)
        self._cur_perm, self._cur_grad, self._cur_hess = perm, grad, hess
        root = _Leaf(0, num_data, 0.0, 0.0, 0.0, 0)
        root.hist = self._leaf_hist(perm, 0, num_data, grad, hess)
        # root sums from the histogram (every row lands in exactly one
        # bin of feature 0): float32 sums in the JAX package's (XLA's)
        # order, or exact integer sums times the scales, taken in
        # float64 on the host as the JAX package does; one read either
        # way, the same bits on the card and the CPU
        with obs.span("serial/root sums (read)", phase="hist"):
            if self._quant:
                # tpulint: sync-ok(host loop: the root sums, one read per tree)
                gsh, hsh, sg, sh = self._read(torch.stack(
                    [gs.to(torch.float64), hs.to(torch.float64),
                     *root.hist[0].sum(dim=0).to(torch.float64)]))
                self._qscales_host = (gsh, hsh)
                root.sum_g, root.sum_h = sg * gsh, sh * hsh
            else:
                # tpulint: sync-ok(host loop: the root sums, one read per tree)
                root.sum_g, root.sum_h = self._read(
                    S.xla_sum(root.hist[0].t()))
        leaves: Dict[int, _Leaf] = {0: root}
        if self._forced_splits is not None:
            perm = self._apply_forced_splits(tree, leaves, perm, grad, hess)
        for leaf in leaves.values():
            leaf.best = self._compute_best(
                leaf, tree_mask, set() if self._interaction_sets else None,
                rand_thr)
            if not self._keep_hists:
                leaf.hist = None

        for _ in range(cfg.num_leaves - 1 - tree.num_nodes):
            # pick the globally-best leaf (reference ArgMax at :188)
            best_leaf, best_gain = -1, 0.0
            for lid, leaf in leaves.items():
                if leaf.best is None:
                    continue
                if cfg.max_depth > 0 and leaf.depth >= cfg.max_depth:
                    continue
                if leaf.best["gain"] > best_gain:
                    best_leaf, best_gain = lid, leaf.best["gain"]
            if best_leaf < 0:
                break
            perm = self._split_leaf(tree, leaves, best_leaf, perm, grad, hess,
                                    tree_mask, rand_thr)
        if self._quant and cfg.quant_train_renew_leaf:
            self._renew_leaf_values(tree, leaves, perm, raw_grad, raw_hess)
        return tree

    def _renew_leaf_values(self, tree: Tree, leaves: Dict[int, "_Leaf"],
                           perm, grad, hess) -> None:
        """Refit the leaf outputs from the float32 grad / hess sums after
        a quantized growth (the JAX package's _renew_leaf_values, the
        reference's RenewIntGradTreeOutput): the tree keeps the
        quantized decisions, the leaf values drop the rounding error.
        Window sums are differences of one prefix sum in XLA's order over
        the final leaf-ordered permutation; one read brings the boundary
        values, and the rest is float64 on the host, as in the JAX
        package."""
        items = [(lid, lf) for lid, lf in leaves.items() if lf.count > 0]
        if not items:
            return
        dev = self.device
        cs = S._prefix_sum(torch.stack([grad[perm], hess[perm]]))
        # tpulint: sync-ok(host loop refit: leaf windows, one per tree)
        ends = torch.as_tensor([lf.start + lf.count - 1 for _, lf in items],
                               dtype=torch.int64, device=dev)
        los = np.asarray([lf.start - 1 for _, lf in items])
        # tpulint: sync-ok(host loop refit: leaf windows, one per tree)
        lo_idx = torch.as_tensor(np.maximum(los, 0), dtype=torch.int64,
                                 device=dev)
        with obs.span("serial/renew leaf values (read)", phase="renew"):
            # tpulint: sync-ok(host loop refit: one read per tree)
            host = np.asarray(self._read(torch.cat(
                [cs[:, ends], cs[:, lo_idx]], dim=1).to(torch.float64)))
        m = len(items)
        has_lo = los >= 0
        sum_g = host[0, :m] - np.where(has_lo, host[0, m:], 0.0)
        sum_h = host[1, :m] - np.where(has_lo, host[1, m:], 0.0)
        cfg = self.config
        for (lid, lf), g, h in zip(items, sum_g, sum_h):
            if cfg.lambda_l1 > 0:
                g = np.sign(g) * max(abs(g) - cfg.lambda_l1, 0.0)
            out = -g / (h + cfg.lambda_l2 + S.K_EPSILON)
            if cfg.max_delta_step > 0:
                out = float(np.clip(out, -cfg.max_delta_step,
                                    cfg.max_delta_step))
            if self.use_monotone:
                out = float(np.clip(out, lf.cmin, lf.cmax))
            tree.leaf_value[lid] = float(out)

    # ------------------------------------------------------------------
    def _compute_best(self, leaf: _Leaf, tree_mask: np.ndarray,
                      branch_features: Optional[set],
                      rand_thr) -> Optional[dict]:
        cfg = self.config
        if leaf.count < 2 * cfg.min_data_in_leaf \
                or leaf.sum_h < 2 * cfg.min_sum_hessian_in_leaf:
            return None
        drop_after = False
        if leaf.hist is None:
            # pool-capped mode: recompute this leaf's histogram from its
            # still-valid permutation window
            leaf.hist = self._leaf_hist(self._cur_perm, leaf.start,
                                        leaf.count, self._cur_grad,
                                        self._cur_hess)
            drop_after = True
        dev = self.device
        mask = self._feature_mask_node(tree_mask, branch_features)
        scale = None
        if self.use_monotone and cfg.monotone_penalty > 0:
            fac = monotone_penalty_factor(leaf.depth, cfg.monotone_penalty)
            scale = _device.upload(
                np.where(self._monotone_np != 0, fac, 1.0)
                .astype(np.float32), dev)

        v = self._scan_leaf(leaf, _device.upload(mask, dev), rand_thr, scale)
        if drop_after:
            leaf.hist = None
        if not v[11] or not np.isfinite(v[0]) or v[0] <= 0.0:
            return None
        best = {
            "feature": int(v[12]), "gain": float(v[0]),
            "threshold": int(v[7]), "default_left": bool(v[8]),
            "left_sum_gradient": v[1], "left_sum_hessian": v[2],
            "left_count": int(v[9]), "left_output": v[3],
            "right_sum_gradient": v[4], "right_sum_hessian": v[5],
            "right_count": int(v[10]), "right_output": v[6],
        }
        if self.any_categorical:
            best["cat_family"] = int(v[13])
            best["cat_used_bin"] = int(v[14])
            best["cat_sorted_order"] = [int(o) for o in v[15:]]
        return best

    def _scan_leaf(self, leaf: _Leaf, mask, rand_thr, scale) -> list:
        """The leaf's best-split record on the host: the scan of its
        histogram (dequantized first under quantized gradients: integer
        level sums meet float arithmetic here and only here; sum_g /
        sum_h are already dequantized leaf totals) and its one read."""
        hist = leaf.hist
        if self._qscales is not None:
            hist = S.dequantize_hist(hist, *self._qscales)
        # tpulint: sync-ok(host loop: one read per leaf scan, as the JAX host loop)
        return self._read(self._best_record(
            hist, self.meta, leaf, mask, rand_thr, self._cegb_delta(leaf),
            scale))

    _scan_leaf = obs.instrument_kernel(_scan_leaf, "split",
                                       name="serial/split_scan")

    def _best_record(self, hist, meta, leaf: _Leaf, mask, rand_thr,
                     cegb_delta, scale, feature_ids=None) -> torch.Tensor:
        """The leaf's best split over the features of ``hist`` as one
        float64 record: gain, the left and right sums and outputs,
        threshold, default_left, the counts, found, the feature (its
        index in ``feature_ids`` when given, the inner feature id
        otherwise), then the categorical block (family, used bins, the
        sorted bin order). Integer fields are exact in float64."""
        dev = self.device

        def f32(x):
            # tpulint: sync-ok(host loop: the leaf's scalars, one per leaf scan)
            return torch.tensor(x, dtype=torch.float32, device=dev)
        res = S.best_split(
            hist, meta, self.split_cfg, f32(leaf.sum_g), f32(leaf.sum_h),
            # tpulint: sync-ok(host loop: the leaf's count, one per leaf scan)
            torch.tensor(leaf.count, dtype=torch.int32, device=dev),
            f32(leaf.output), f32(leaf.cmin), f32(leaf.cmax),
            feature_mask=mask, rand_thresholds=rand_thr,
            cegb_delta=cegb_delta, gain_scale=scale)
        f = res["best_feature"].to(torch.int64)
        feat = f if feature_ids is None else feature_ids[f]
        parts = [torch.stack([
            res["best_gain"].to(torch.float64),
            *(res[k][f].to(torch.float64) for k in (
                "left_sum_gradient", "left_sum_hessian", "left_output",
                "right_sum_gradient", "right_sum_hessian",
                "right_output", "threshold", "default_left",
                "left_count", "right_count", "found")),
            feat.to(torch.float64)])]
        if self.any_categorical:
            parts += [torch.stack([res["cat_family"][f],
                                   res["cat_used_bin"][f]]).to(torch.float64),
                      res["cat_sorted_order"][f].to(torch.float64)]
        return torch.cat(parts)

    @staticmethod
    def _cat_bins(best: dict) -> List[int]:
        """The left category bin set from the scan's (family, position,
        sorted order) description: the one bin of a one-vs-rest split,
        else a prefix of the sorted order from its front (family 1) or
        from the end of its used part (family 2)."""
        fam, pos = best["cat_family"], best["threshold"]
        if fam == 0:
            return [pos]
        order, used = best["cat_sorted_order"], best["cat_used_bin"]
        if fam == 1:
            return [order[i] for i in range(pos + 1)]
        return [order[used - 1 - i] for i in range(pos + 1)]

    def _split_leaf(self, tree: Tree, leaves: Dict[int, _Leaf], lid: int,
                    perm, grad, hess, tree_mask, rand_thr):
        """Apply the stored best split (reference SplitInner,
        serial_tree_learner.cpp:541-660); returns the new permutation."""
        leaf = leaves[lid]
        best = leaf.best
        fi = best["feature"]
        mapper = self.dataset.bin_mappers[fi]
        real_feature = self.dataset.real_feature_index[fi]
        mono = self.dataset.monotone_constraint(fi)
        if self._mono_state is not None:
            self._mono_state.before_split(tree, lid, mono)
        is_cat = mapper.bin_type == BIN_CATEGORICAL
        if is_cat:
            # bitsets of the left bins (inner) and of their raw category
            # values (reference Tree::SplitCategorical, tree.cpp:70-91)
            bin_set = self._cat_bins(best)
            words = np.zeros((self.max_num_bin + 31) // 32, dtype=np.int64)
            for b in bin_set:
                words[b // 32] |= 1 << (b % 32)
            cat_vals = sorted(mapper.bin_2_categorical[b] for b in bin_set
                              if mapper.bin_2_categorical[b] >= 0)
            right_leaf = tree.split_categorical(
                lid, fi, real_feature, sorted(bin_set), cat_vals,
                best["left_output"], best["right_output"],
                best["left_count"], best["right_count"],
                best["left_sum_hessian"], best["right_sum_hessian"],
                best["gain"], mapper.missing_type)
            # tpulint: sync-ok(host loop: a categorical split's bitset)
            route = (0, False, -1, torch.as_tensor(words, device=self.device))
        else:
            right_leaf = tree.split(
                lid, fi, real_feature, best["threshold"],
                mapper.bin_to_value(best["threshold"]),
                best["left_output"], best["right_output"],
                best["left_count"], best["right_count"],
                best["left_sum_hessian"], best["right_sum_hessian"],
                best["gain"], mapper.missing_type, best["default_left"])
            route = (best["threshold"], best["default_left"],
                     int(self.feature_miss_bin[fi]), None)
        thr, dl, mb, bitset = route
        new_perm, lc = self._partition(
            self.bins, perm, leaf.start, leaf.count, fi, thr, dl, mb, is_cat,
            cat_bitset=bitset, efb=self._efb_dev)
        self.syncs += 1          # the left count steers the host loop
        rc = leaf.count - lc

        # monotone constraint propagation (reference
        # monotone_constraints.hpp Basic/IntermediateLeafConstraints)
        lcmin, lcmax, rcmin, rcmax = leaf.cmin, leaf.cmax, leaf.cmin, \
            leaf.cmax
        updated_leaves: List[int] = []
        if self._mono_state is not None:
            ms = self._mono_state
            updated_leaves = ms.update(
                tree, lid, right_leaf, mono, not is_cat, best["left_output"],
                best["right_output"], fi, best["threshold"],
                lambda l: l in leaves and leaves[l].best is not None)
            lcmin, lcmax = ms.cmin[lid], ms.cmax[lid]
            rcmin, rcmax = ms.cmin[right_leaf], ms.cmax[right_leaf]

        left = _Leaf(leaf.start, lc, best["left_sum_gradient"],
                     best["left_sum_hessian"], best["left_output"],
                     leaf.depth + 1, cmin=lcmin, cmax=lcmax)
        right = _Leaf(leaf.start + lc, rc, best["right_sum_gradient"],
                      best["right_sum_hessian"], best["right_output"],
                      leaf.depth + 1, cmin=rcmin, cmax=rcmax)

        # histogram: smaller child directly, larger by subtraction
        # (reference serial_tree_learner.cpp:396-404); the pool-capped
        # mode computes both directly and keeps nothing
        self._cur_perm = new_perm
        smaller, larger = (left, right) if lc <= rc else (right, left)
        smaller.hist = self._leaf_hist(new_perm, smaller.start,
                                       smaller.count, grad, hess)
        if self._keep_hists and leaf.hist is not None:
            larger.hist = leaf.hist - smaller.hist
        else:
            larger.hist = self._leaf_hist(new_perm, larger.start,
                                          larger.count, grad, hess)
        leaf.hist = None

        branches = None
        if self._interaction_sets:
            # branch features are tracked as real ids; constraints are in
            # inner-feature space
            branches = {self.dataset.inner_feature_index[f]
                        for f in tree.branch_features[lid]
                        if f in self.dataset.inner_feature_index}
        left.best = self._compute_best(left, tree_mask, branches, rand_thr)
        right.best = self._compute_best(right, tree_mask, branches, rand_thr)
        if not self._keep_hists:
            left.hist = None
            right.hist = None

        leaves[lid] = left
        leaves[right_leaf] = right
        # intermediate monotone mode: leaves whose bounds tightened must
        # re-search their best split (reference serial_tree_learner.cpp
        # :650-658 consuming leaves_need_update)
        for ul in updated_leaves:
            if ul in (lid, right_leaf):
                continue
            u = leaves[ul]
            u.cmin = self._mono_state.cmin[ul]
            u.cmax = self._mono_state.cmax[ul]
            ub = None
            if self._interaction_sets:
                ub = {self.dataset.inner_feature_index[f]
                      for f in tree.branch_features[ul]
                      if f in self.dataset.inner_feature_index}
            u.best = self._compute_best(u, tree_mask, ub, rand_thr)
        if self._cegb_enabled:
            self._cegb_coupled_used[fi] = True
        return new_perm

    def _apply_forced_splits(self, tree: Tree, leaves: Dict[int, _Leaf],
                             perm, grad, hess):
        """Apply the user's forced splits breadth-first before the
        best-first loop (reference SerialTreeLearner::ForceSplits,
        serial_tree_learner.cpp:427; the sums at a fixed threshold as in
        GatherInfoForThreshold, feature_histogram.hpp:515), as the JAX
        package's ``_apply_forced_splits``: the leaf's histogram of the
        forced feature comes to the host in one read and its left side
        is summed there in float64. Returns the new permutation."""
        cfg = self.config
        eps = S.K_EPSILON
        q = [(self._forced_splits, 0)]
        while q and tree.num_leaves < cfg.num_leaves:
            node, lid = q.pop(0)
            real_f = node.get("feature")
            if real_f is None:
                continue
            inner = self.dataset.inner_feature_index.get(int(real_f))
            if inner is None:
                log.warning("Forced split on unused feature %s ignored",
                            real_f)
                continue
            leaf = leaves[lid]
            mapper = self.dataset.bin_mappers[inner]
            thr_bin = int(mapper.value_to_bin(float(node["threshold"])))
            thr_bin = max(0, min(thr_bin, mapper.num_bin - 2))
            if leaf.hist is None:       # the pool-capped mode dropped it
                leaf.hist = self._leaf_hist(perm, leaf.start, leaf.count,
                                            grad, hess)
            with obs.span("serial/forced split (read)", phase="split"):
                hist = np.asarray(
                    # tpulint: sync-ok(host loop: a forced split reads its leaf histogram)
                    self._read(leaf.hist[inner].to(torch.float64)),
                    dtype=np.float64)                            # [B, 2]
            if self._quant:
                # level sums -> float units, as leaf.sum_g / sum_h
                hist = hist * np.asarray(self._qscales_host, np.float64)
            miss = int(self.feature_miss_bin[inner])
            sel = np.arange(hist.shape[0]) <= thr_bin
            if miss >= 0:
                sel = sel & (np.arange(hist.shape[0]) != miss)
            lg = float(hist[sel, 0].sum())
            lh = float(hist[sel, 1].sum()) + eps
            rg = leaf.sum_g - lg
            rh = leaf.sum_h + 2 * eps - lh
            cnt_factor = leaf.count / (leaf.sum_h + 2 * eps)
            lcnt = int(np.floor(hist[sel, 1].sum() * cnt_factor + 0.5))
            l1, l2 = cfg.lambda_l1, cfg.lambda_l2

            def out(g, h):
                s = np.sign(g) * max(0.0, abs(g) - l1) if l1 > 0 else g
                return -s / (h + l2)

            leaf.best = {
                "feature": inner, "gain": 0.0, "threshold": thr_bin,
                "default_left": False,
                "left_sum_gradient": lg, "left_sum_hessian": lh - eps,
                "left_count": lcnt, "left_output": out(lg, lh),
                "right_sum_gradient": rg, "right_sum_hessian": rh - eps,
                "right_count": leaf.count - lcnt,
                "right_output": out(rg, rh),
            }
            right_leaf = tree.num_leaves    # the id Tree.split assigns
            perm = self._split_leaf(tree, leaves, lid, perm, grad, hess,
                                    np.ones(self.num_features, dtype=bool),
                                    None)
            if isinstance(node.get("left"), dict):
                q.append((node["left"], lid))
            if isinstance(node.get("right"), dict):
                q.append((node["right"], right_leaf))
        return perm


def _load_forced_splits(filename: str):
    """The forcedsplits_filename JSON (reference serial_tree_learner
    constructor, serial_tree_learner.cpp:36-44), or None."""
    if not filename:
        return None
    try:
        with open(filename) as fh:
            return json.load(fh)
    except (OSError, ValueError) as e:
        log.warning("Cannot load forced splits from %s: %s", filename, e)
        return None


def _parse_interaction_constraints(spec, dataset: BinnedDataset):
    """interaction_constraints -> list of allowed inner-feature-id sets
    (reference config.h interaction_constraints + col_sampler
    filtering)."""
    if not spec:
        return []
    groups = spec
    if isinstance(spec, str):
        try:
            groups = json.loads(spec.replace("(", "[").replace(")", "]"))
        except ValueError:
            log.warning("Cannot parse interaction_constraints %r", spec)
            return []
    out = []
    for g in groups:
        inner = set()
        for f in g:
            i = dataset.inner_feature_index.get(int(f))
            if i is not None:
                inner.add(i)
        out.append(inner)
    return out
