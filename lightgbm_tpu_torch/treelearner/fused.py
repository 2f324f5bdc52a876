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

As the JAX package's ``lax.while_loop``, the split loop takes no host
read: the tree lives in fixed [L] / [L-1] device tensors (the port's
``FusedTreeState``, ``_tree_state``), and each split step
(``_split_step``) takes the best leaf by an argmax on the device,
partitions its window through B2's device-window entry
(``plane.partition_dev``) and launches the smaller child's histogram at
a bound the host knows (half the learner's rows). A tree runs
num_leaves - 1 steps; once no leaf can split, a step changes nothing
(its window is empty and its writes go to trash slots). On the card, in
one process, the learner captures one split step as a CUDA graph and
replays it (``_replay_steps``, ``_graph_rule``), on the persistent
path and on the per-tree path alike; the first tree and the
data-parallel learner (its collectives cannot be captured) run the same
step eagerly. Every tree comes back as device tensors, which the
booster keeps as a ``PendingTree`` until a host consumer asks;
``read_trees`` brings any number of them back in one read. ``syncs``
counts the reads: none per tree.

Quantized-gradient training (``use_quantized_grad``, ops/quantize.py)
quantizes the iteration's gradients with one threefry key per iteration
(the JAX package's keys, so the same levels), writes the packed
(qg << 16) | qh word into the grad plane, and runs the kernels'
quantized modes: the histograms, the pool and the subtraction stay in
exact int32, and ``dequantize_hist`` runs at the split scan. With
``quant_train_renew_leaf`` the leaf values are refit from the float32
gradient sums of each leaf's window.

L1, quantile and MAPE refit each leaf to a percentile of its residuals
label - score at the end of the tree (``_renew_leaf_outputs``):
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
the per-tree path, ``grow_device``: each tree's state (the cached code
planes, the tree's row-order grad / hess, row ids 0..n-1, without label
or score planes) is built into one buffer the learner keeps, so the
captured step finds every tree's state at one address, and the tree
returns each row's leaf, read off the partitioned windows, for the
booster's score update. Under row sampling the state is bag-ordered
instead: once per tree the bin codes, grad / hess and slot planes are
gathered by the [bag | oob] permutation and packed into that buffer,
the tree grows on the bag's lanes only, and every row's leaf
(out-of-bag rows included) comes from bin-space traversal of the new
tree. The split steps' launches are bounded by the learner's rows, not
the bag's, so one capture serves every bagging round.

Forced splits (``forcedsplits_filename``) run first in every tree: a
breadth-first schedule of (leaf slot, feature, threshold bin) built on
the host once (``_forced_schedule``), each split's sums taken from its
leaf's pooled histogram (``_forced_phase``), then the same partition,
histogram and scans as a gain-driven split. The first skipped split
ends the phase through a device word (``alive``): it and every later
forced step are no-op steps, with no read.

The state is updated IN PLACE (partition, grad/hess and score writes);
the JAX package keeps it immutable and donates it instead.

Telemetry (obs/): the dispatchers are wrapped at build time as the JAX
host loop's are, under the core phases ``hist`` (``_leaf_hist``),
``split`` (``_scan``, and the replays of the captured step) and
``partition`` (``plane.partition_dev``), which never nest;
``train_iter`` / ``grow_device`` run under phase ``fused``, which the
core sum leaves out. A tree read runs under phase ``fetch``. Every read
goes through utils/device.py ``device_get``.

The data-parallel learner (treelearner/parallel.py
``FusedDataParallelGrower``) runs this class per rank over the rank's
own rows. Its collective seams are ``_psum`` / ``_psum_max``, identities
here: the root histogram and row count, each split's left count and
smaller-child histogram (the larger one too without a histogram pool),
the refit sums and the quantization maxima. Leaf windows stay local;
the leaf counts that the scans, the tree and the smaller-child choice
read are global (row 2 of ``leaf_i``), so every rank picks the same
splits and runs the same steps.
"""
from __future__ import annotations

import time
import types
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import obs
from ..config import Config
from ..io.binning import BIN_CATEGORICAL
from ..io.dataset import BinnedDataset
from ..io.efb import per_feature_hist
from ..models.tree import K_CATEGORICAL_MASK, Tree, _to_bitset
from ..ops import cuda as K
from ..ops import histogram as H
from ..ops import multival as MV
from ..ops import plane
from ..ops import quantize as Q
from ..ops import split as S
from ..ops import threefry
from ..ops.xla_float import f32_value, fma_f32
from ..utils import device as _device
from ..utils import log
from .serial import _load_forced_splits

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
    on ``device``. ``num_rows``: the rows of the state, when it holds
    one rank's share of the dataset (the data-parallel learner)."""

    # no collective in the split step, so it can be captured
    _single_process = True

    def __init__(self, dataset: BinnedDataset, config: Config, objective,
                 device, num_rows: Optional[int] = None) -> None:
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
        self.actual_rows = (dataset.num_data if num_rows is None
                            else int(num_rows))
        # the rows of the persistent state that hold data (the rank's
        # own rows under the data-parallel learner)
        self.n_valid = self.actual_rows
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
        self._forced_sched = self._forced_schedule(config, dataset)
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
        # the fixed device state of one tree, B2's buffers, the per-tree
        # path's planar state buffer, the captured split step and its
        # memory pool (kept here, so they go with the learner), and the
        # trees grown so far
        self._st = None
        self._part_bufs = None
        self._tree_data = None
        self._graph = None
        self._graph_pool = None
        self._trees_grown = 0
        # the stated rule's switch (``_graph_rule``): True runs the eager
        # device loop on the card as well
        self._eager_loop = False
        self._cat_count = (K.device_counter("partition_cat", dev)
                           if dev.type == "cuda" and self.any_categorical
                           else None)

    def _forced_schedule(self, config: Config, dataset: BinnedDataset):
        """The user's forced splits as a breadth-first schedule of (leaf
        slot, inner feature, threshold bin), built on the host (the JAX
        package's, reference ForceSplits, serial_tree_learner.cpp:427):
        the slots replay the learner's slot assignment (the split leaf
        keeps its slot, the right child takes slot n_leaves); the
        threshold bin is ``value_to_bin`` clamped to num_bin - 2. None
        without forced splits."""
        if not config.forcedsplits_filename:
            return None
        forced = _load_forced_splits(config.forcedsplits_filename)
        sched = []
        queue = [(forced, 0)] if forced is not None else []
        nl = 1
        while queue and nl < self.num_leaves:
            node, slot = queue.pop(0)
            rf = node.get("feature")
            if rf is None:
                continue
            inner = dataset.inner_feature_index.get(int(rf))
            if inner is None:
                log.warning("Forced split on unused feature %s ignored", rf)
                continue
            m = dataset.bin_mappers[inner]
            tb = int(m.value_to_bin(float(node["threshold"])))
            sched.append((slot, inner, max(0, min(tb, m.num_bin - 2))))
            right_slot = nl
            nl += 1
            if isinstance(node.get("left"), dict):
                queue.append((node["left"], slot))
            if isinstance(node.get("right"), dict):
                queue.append((node["right"], right_slot))
        return sched or None

    def _forced_phase(self, st, data, feature_mask, qscales, bound: int
                      ) -> None:
        """The forced splits of one tree, before the gain-driven loop
        (the JAX package's ``forced_step`` scan): each scheduled split's
        left sums come from the pooled histogram of its leaf at the
        forced feature, its children's outputs from ``_calc_output``,
        its gain is 0.0 and its default direction right. Its verdict
        stays on the device: ``ok`` (both sides with hessian mass, a
        leaf with rows, fewer than L leaves, and every earlier forced
        split taken: ``st.alive``) is the step's ``cont``, so a skipped
        split and every later one are no-op steps, since the later
        slots assumed it. Every scheduled step runs (a fixed count, no
        read)."""
        dev = self.device
        f32, i32, i64 = torch.float32, torch.int32, torch.int64
        eps = S.K_EPSILON
        cfg = self.split_cfg
        L = self.num_leaves
        leaf_f, leaf_i = st.leaf_f, st.leaf_i
        for leaf, feat, thr in self._forced_sched:
            hist = st.pool[leaf, feat]                             # [B, 2]
            if qscales is not None:
                # the scans' int -> float32 boundary
                hist = S.dequantize_hist(hist, qscales[0], qscales[1])
            bidx = torch.arange(hist.shape[0], device=dev)
            sel = bidx <= thr
            miss = int(self.miss_bin_np[feat])
            if miss >= 0:
                sel = sel & (bidx != miss)
            lg, lh = S.xla_sum((sel.to(f32)[:, None] * hist).t())
            sum_g, sum_h = leaf_f[0, leaf], leaf_f[1, leaf]
            rg, rh = sum_g - lg, sum_h - lh
            cnt = leaf_i[2, leaf]
            cntf = cnt.to(f32) / (sum_h + 2 * eps)
            lcnt = torch.floor(fma_f32(lh, cntf, 0.5)).to(i32)
            out = [S._calc_output(g_, h_ + eps, c_, cfg, leaf_f[2, leaf],
                                  leaf_f[3, leaf], leaf_f[4, leaf])
                   for g_, h_, c_ in ((lg, lh, lcnt), (rg, rh, cnt - lcnt))]
            rec = torch.stack([torch.zeros((), dtype=f32, device=dev),
                               lg, lh, out[0], rg, rh, out[1]])
            rec_i = torch.zeros(4 + plane.CAT_WORDS, dtype=i32, device=dev)
            rec_i[0], rec_i[1] = feat, thr
            ok = (st.alive & (lh > 1e-9) & (rh > 1e-9)
                  & (st.n_leaves < L) & (cnt > 0))
            st.alive.copy_(ok)
            self._split_step(st, data, feature_mask, qscales, bound, forced=(
                torch.full((1,), leaf, dtype=i64, device=dev), rec, rec_i,
                ok))

    # ------------------------------------------------------------------
    def _read(self, t: torch.Tensor) -> list:
        """One blocking device -> host read (counted)."""
        self.syncs += 1
        return _device.device_get(t).tolist()

    def _psum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the ranks of the data-parallel learner (reference
        Network::Allreduce of histogram buffers,
        data_parallel_tree_learner.cpp:169): the identity on one
        device."""
        return x

    def _psum_max(self, x: torch.Tensor) -> torch.Tensor:
        """Maximum over the ranks: the identity on one device."""
        return x

    @property
    def _zero_hist(self) -> torch.Tensor:
        """The [F, B, 2] histogram of an empty window."""
        return torch.zeros((self.num_features, self.max_num_bin, 2),
                           dtype=torch.int32 if self._quant
                           else torch.float32, device=self.device)

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
        # tpulint: capture-ok(captured steps pass max_count, a host int)
        if (count if max_count is None else max_count) == 0:
            # a window no rank row reaches (a data-parallel rank without
            # rows of the leaf): no launch
            return self._zero_hist
        if self._hist_method == "multival_pallas":
            return self._leaf_hist_multival(data, start, count, max_count)
        nbins = (self.group_max_bin if self._efb_hist is not None
                 else self.max_num_bin)
        ghist = H.hist_planar(
            data, start, count, num_bins=nbins, num_cols=Ly.num_cols,
            code_bits=Ly.code_bits, grad_plane=Ly.grad,
            dtype=self._hist_dtype, max_count=max_count, quant=self._quant)
        return self._hist_from_groups(ghist)

    # telemetry: the dispatchers run under their phases (obs/spans.py;
    # one global load and an `is None` check when telemetry is off).
    # They are wrapped once here, on the class, so that no learner holds
    # a reference to itself and each is freed when its last user drops it
    _leaf_hist = obs.instrument_kernel(_leaf_hist, "hist",
                                       name="fused/leaf_histogram")
    _partition_dev = staticmethod(obs.instrument_kernel(
        plane.partition_dev, "partition", name="fused/partition"))

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
              qscales=None, program="pair", sum_levels=None):
        """Best split of K leaves at once (JAX _scan_leaf /
        _scan_two_leaves). All arguments have a leading [K] axis; returns
        (rec_f [7, K] f32: gain, lg, lh, lout, rg, rh, rout;
        rec_i [12, K] i32: feature, threshold bin (a categorical split's
        position), default_left, is_cat, the 8 words of the left
        category bitset). ``qscales``: (grad_scale, hess_scale) when
        ``hist`` holds int32 level sums — the scan itself runs in
        float32. ``program``: the root scan ("root") or the two-leaf scan
        ("pair"), two fusions of the JAX program with their own
        multiply-add sites (``S.scan_sites``). ``sum_levels``: the leaf
        totals as level totals and scales (``S.numerical_split_scan``).
        """
        if qscales is not None:
            hist = S.dequantize_hist(hist, qscales[0], qscales[1])
        res = S.numerical_split_scan(hist, self.meta, self.split_cfg,
                                     sum_g, sum_h, count, output, cmin, cmax,
                                     program=program,
                                     quantized=qscales is not None,
                                     sum_levels=sum_levels)
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

    _scan = obs.instrument_kernel(_scan, "split", name="fused/split_scan")

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
    def _tree_state(self) -> types.SimpleNamespace:
        """The learner's fixed device state of one tree (the JAX
        package's ``FusedTreeState``), allocated once and reset in place
        per tree, so a captured split step always finds it at the same
        addresses. Slot L of every [L + 1] leaf array, and slot L - 1 of
        every [L] node array, is a trash slot: a step after the stop
        writes there, so the real slots keep their bits.

        best_f [7, L+1] f32: gain, lg, lh, lout, rg, rh, rout; best_i
        [12, L+1] i32: feature, threshold bin, default_left, is_cat, 8
        bitset words; leaf_f [5, L+1]: sum_g, sum_h, output, cmin, cmax;
        leaf_i [3, L+1] i32: window start, window count, global count;
        leaf_depth / leaf_parent [L+1]; t_f [3, L]: gain, value, weight;
        t_i [13, L]: count, then best_i's rows; t_left / t_right [L];
        n_leaves / cont [1]; alive [1]: no forced split skipped yet;
        pool [L+1, F, B, 2] (None without a histogram pool)."""
        if self._st is not None:
            return self._st
        L, F, B = self.num_leaves, self.num_features, self.max_num_bin
        dev = self.device
        f32, i32 = torch.float32, torch.int32
        self._st = types.SimpleNamespace(
            best_f=torch.zeros((7, L + 1), dtype=f32, device=dev),
            best_i=torch.zeros((4 + plane.CAT_WORDS, L + 1), dtype=i32,
                               device=dev),
            leaf_f=torch.zeros((5, L + 1), dtype=f32, device=dev),
            leaf_i=torch.zeros((3, L + 1), dtype=i32, device=dev),
            leaf_depth=torch.zeros(L + 1, dtype=i32, device=dev),
            leaf_parent=torch.zeros(L + 1, dtype=i32, device=dev),
            t_f=torch.zeros((3, L), dtype=f32, device=dev),
            t_i=torch.zeros((5 + plane.CAT_WORDS, L), dtype=i32, device=dev),
            t_left=torch.zeros(L, dtype=i32, device=dev),
            t_right=torch.zeros(L, dtype=i32, device=dev),
            n_leaves=torch.zeros(1, dtype=torch.int64, device=dev),
            cont=torch.zeros(1, dtype=torch.bool, device=dev),
            alive=torch.zeros(1, dtype=torch.bool, device=dev),
            pool=(torch.zeros((L + 1, F, B, 2),
                              dtype=i32 if self._quant else f32, device=dev)
                  if self._use_hist_pool else None))
        return self._st

    def _part_buffers(self) -> plane.PartitionBuffers:
        """B2's scratch and status words for windows up to the learner's
        rows (every window lies in them), made once."""
        if self._part_bufs is None:
            self._part_bufs = plane.PartitionBuffers(
                self.layout.num_planes, self.actual_rows, self.device)
        # tpulint: graph-ok(made once before the first capture, never rebound)
        return self._part_bufs

    def _split_step(self, st, data: torch.Tensor, feature_mask, qscales,
                    bound: int, forced=None) -> None:
        """One split step on the device, with no host read (the JAX
        package's ``cond`` + ``body``): take the best leaf (argmax of the
        gains, masked by depth), ``cont`` = fewer than L leaves and a
        positive gain, partition its window in place (B2 on the device
        window), histogram the smaller child (B1 / B5, launched at the
        host's ``bound`` on the tree's rows), subtract for the larger
        one, scan both children and do the bookkeeping. Once ``cont`` is
        false the step changes nothing: its window has count 0 and its
        writes go to the trash slots.
        ``forced``: (leaf [1] int64, rec, rec_i, ok [1] bool) of a
        forced split, applied as is when ``ok`` holds."""
        L = self.num_leaves
        F = self.num_features
        dev = self.device
        i32, i64 = torch.int32, torch.int64
        max_depth = self.config.max_depth
        if forced is None:
            gains = st.best_f[0, :L]
            if max_depth > 0:
                gains = torch.where(st.leaf_depth[:L] >= max_depth, NEG_INF,
                                    gains)
            # gathers, never an index by a 0-d device tensor (an
            # implicit read)
            best = torch.argmax(gains).reshape(1)
            cont = (st.n_leaves < L) & (gains.index_select(0, best) > 0.0)
            rec = st.best_f.index_select(1, best)[:, 0]
            rec_i = st.best_i.index_select(1, best)[:, 0]
        else:
            best, rec, rec_i, cont = forced
        st.cont.copy_(cont)
        trash = torch.full_like(best, L)
        leaf_w = torch.where(cont, best, trash)           # write slots
        new_w = torch.where(cont, st.n_leaves, trash)
        node_w = torch.where(cont, st.n_leaves - 1, trash - 1)
        node_v = (st.n_leaves - 1).to(i32)
        new_v = st.n_leaves.to(i32)

        def at(x):
            return x.index_select(-1, best)[..., 0]

        start, count, count_g = at(st.leaf_i)
        count = torch.where(cont[0], count, 0)
        sum_h_p, out_p = at(st.leaf_f[1]), at(st.leaf_f[2])
        cmin, cmax = at(st.leaf_f[3]), at(st.leaf_f[4])
        parent = st.leaf_parent.index_select(0, best)
        depth = st.leaf_depth.index_select(0, best) + 1

        # --- tree bookkeeping (Tree::Split semantics, tree.h:61) ---
        has_parent = parent >= 0
        pidx = torch.clamp(parent, min=0).to(i64)
        pw = torch.where(cont & has_parent, pidx, trash - 1)
        pl = st.t_left.index_select(0, pidx)
        fix_left = has_parent & (pl == -best.to(i32) - 1)
        st.t_left.index_copy_(0, pw, torch.where(fix_left, node_v, pl))
        pr = st.t_right.index_select(0, pidx)
        st.t_right.index_copy_(0, pw, torch.where(has_parent & ~fix_left,
                                                  node_v, pr))
        st.t_left.index_copy_(0, node_w, -best.to(i32) - 1)
        st.t_right.index_copy_(0, node_w, -new_v - 1)
        st.t_i.index_copy_(1, node_w, torch.cat([count_g.reshape(1),
                                                 rec_i])[:, None])
        st.t_f.index_copy_(1, node_w, torch.stack([rec[0], out_p,
                                                   sum_h_p])[:, None])

        # --- partition the leaf's window in place ---
        feat = rec_i[:1]
        cat_route = ({"is_cat": rec_i[3], "cat_bitset": rec_i[4:]}
                     if self.any_categorical else {})
        rscal = plane.route_scalars(
            self.layout, feat, rec_i[1], rec_i[2],
            self.feature_miss_bin.index_select(0, feat),
            self._efb_dev, device=dev, **cat_route)
        win = torch.stack([start, count])
        data, nleft = self._partition_dev(
            data, self.layout, win, rscal, self._part_buffers(),
            self._cat_count if self.any_categorical else None)
        nright = count - nleft
        # the smaller child by the GLOBAL counts: every rank
        # histograms the same child, so the sums and the subtraction
        # stay coherent
        nleft_g = self._psum(nleft)
        nright_g = torch.where(cont[0], count_g, 0) - nleft_g
        left_smaller = nleft_g <= nright_g
        s_start = start + torch.where(left_smaller, 0, nleft)
        s_count = torch.where(left_smaller, nleft, nright)
        hist_small = self._psum(self._leaf_hist(
            data, s_start, s_count, max_count=self._small_bound(bound)))

        # --- children bookkeeping ---
        if self.use_monotone:
            monof = self.meta.monotone.index_select(0, feat)[0]
            mid = (rec[3] + rec[6]) / 2.0
            lcmax = torch.where(monof > 0, torch.minimum(cmax, mid), cmax)
            rcmin = torch.where(monof > 0, torch.maximum(cmin, mid), cmin)
            lcmin = torch.where(monof < 0, torch.maximum(cmin, mid), cmin)
            rcmax = torch.where(monof < 0, torch.minimum(cmax, mid), cmax)
        else:
            lcmin, lcmax, rcmin, rcmax = cmin, cmax, cmin, cmax
        two = torch.cat([leaf_w, new_w])
        st.leaf_i.index_copy_(1, two, torch.stack([
            torch.stack([start, start + nleft]),
            torch.stack([nleft, nright]),
            torch.stack([nleft_g, nright_g])]))
        st.leaf_f.index_copy_(1, two, torch.stack([
            torch.stack([rec[1], rec[4]]), torch.stack([rec[2], rec[5]]),
            torch.stack([rec[3], rec[6]]), torch.stack([lcmin, rcmin]),
            torch.stack([lcmax, rcmax])]))
        st.leaf_depth.index_copy_(0, two, depth.repeat(2))
        st.leaf_parent.index_copy_(0, two, node_v.repeat(2))

        # --- larger child: subtraction from the pooled parent ---
        if st.pool is not None:
            hist_large = st.pool.index_select(0, best)[0] - hist_small
        else:
            hist_large = self._psum(self._leaf_hist(
                data, start + torch.where(left_smaller, nleft, 0),
                torch.where(left_smaller, nright, nleft), max_count=bound))
        hist_left = torch.where(left_smaller, hist_small, hist_large)
        hist_right = torch.where(left_smaller, hist_large, hist_small)
        hists = torch.stack([hist_left, hist_right])
        if st.pool is not None:
            st.pool.index_copy_(0, two, hists)

        # --- best splits of both children (one batched scan) ---
        if feature_mask.dim() == 2:
            new_m = torch.clamp(st.n_leaves, max=L - 1)
            mask2 = feature_mask.index_select(
                0, torch.cat([2 * new_m - 1, 2 * new_m]))
        else:
            mask2 = feature_mask[None].expand(2, F)
        rf, ri = self._scan(
            hists, torch.stack([rec[1], rec[4]]),
            torch.stack([rec[2], rec[5]]), torch.stack([nleft_g, nright_g]),
            torch.stack([rec[3], rec[6]]), torch.stack([lcmin, rcmin]),
            torch.stack([lcmax, rcmax]), mask2, qscales)
        st.best_f.index_copy_(1, two, rf)
        st.best_i.index_copy_(1, two, ri)
        st.n_leaves.add_(cont.to(i64))

    def _small_bound(self, n: int) -> int:
        """A host bound on the smaller child's window: half the rows (the
        smaller of two children holds at most half of its parent's). The
        data-parallel learner picks the smaller child by the GLOBAL
        counts, so there it bounds by the rank's rows."""
        return n // 2

    def _reset_tree(self, st, n: int, n_g, sum_g, sum_h, root_hist, rf,
                    ri) -> None:
        """The root of a new tree into the fixed state (eager, before the
        split steps)."""
        st.best_f.zero_()
        st.best_f[0].fill_(NEG_INF)
        st.best_f[:, 0] = rf[:, 0]
        st.best_i.zero_()
        st.best_i[:, 0] = ri[:, 0]
        st.leaf_f.zero_()
        st.leaf_f[0, 0] = sum_g
        st.leaf_f[1, 0] = sum_h
        st.leaf_f[3].fill_(NEG_INF)
        st.leaf_f[4].fill_(-NEG_INF)
        st.leaf_i.zero_()
        st.leaf_i[1, :1].fill_(n)        # a fill: no copy to the card
        st.leaf_i[2, 0] = n_g
        st.leaf_depth.zero_()
        st.leaf_parent.fill_(-1)
        st.t_f.zero_()
        st.t_i.zero_()
        st.t_left.zero_()
        st.t_right.zero_()
        st.n_leaves.fill_(1)
        st.alive.fill_(True)
        if st.pool is not None:
            st.pool[0] = root_hist

    def _grow_tree(self, data: torch.Tensor, n: int,
                   feature_mask: torch.Tensor, qscales=None,
                   graph: bool = False):
        """Grow one tree over the planar state (partitioned in place)
        with no host read. Returns (ta, win): the tree arrays as fresh
        DEVICE tensors of fixed size (``tree_to_host`` reads them:
        n_leaves [1]; t_f [3, L-1] gain, value, weight; t_i [13, L-1]
        count, feature, threshold bin, default_left, is_cat, 8 bitset
        words; t_lr [2, L-1] left, right; leaf_f [3, L] sum_g, sum_h,
        value; leaf_i [3, L] global count, local count, depth) and the
        leaf windows [3, L] (start, local count, global count), zero past
        n_leaves. ``qscales``: (grad_scale, hess_scale) 0-d tensors when
        the grad plane holds packed quantized levels: the pool and the
        subtraction then stay in exact int32, dequantized at the scan.
        ``graph``: replay the learner's captured split step
        (``_replay_steps``) instead of the eager device loop."""
        L = self.num_leaves
        dev = self.device
        f32, i32 = torch.float32, torch.int32
        root_mask = feature_mask[0] if feature_mask.dim() == 2 \
            else feature_mask

        root_hist = self._psum(self._leaf_hist(data, 0, n))
        n_g = self._psum(torch.full((), n, dtype=i32, device=dev))
        # leaf totals from feature 0's bins: exact integer sums times the
        # scales, or float32 sums in the JAX package's (XLA's) order —
        # the same bits on the card and the CPU
        levels = None
        if qscales is not None:
            lev_g, lev_h = root_hist[0].sum(dim=0).to(f32)
            sum_g, sum_h = lev_g * qscales[0], lev_h * qscales[1]
            levels = tuple(v[None] for v in (lev_g, qscales[0], lev_h,
                                             qscales[1]))
        else:
            sum_g, sum_h = S.xla_sum(root_hist[0].t())
        one = torch.ones(1, dtype=f32, device=dev)
        rf, ri = self._scan(root_hist[None], sum_g[None], sum_h[None],
                            n_g[None],
                            0.0 * one, NEG_INF * one, -NEG_INF * one,
                            root_mask[None], qscales, program="root",
                            sum_levels=levels)
        st = self._tree_state()
        self._part_buffers()
        self._reset_tree(st, n, n_g, sum_g, sum_h, root_hist, rf, ri)

        # the split steps' launch bound: the learner's rows, which bound
        # every tree's (a bag's included), so one captured step serves
        # every tree and bagging round; it sizes launches only (the
        # kernels read each window's count on the device)
        bound = self.actual_rows
        if self._forced_sched is not None:
            self._forced_phase(st, data, feature_mask, qscales, bound)
        if graph:
            self._replay_steps(st, data, feature_mask, qscales, bound)
        else:
            for _ in range(L - 1):
                self._split_step(st, data, feature_mask, qscales, bound)
                if not data.is_cuda and not bool(st.cont):
                    # on the CPU the flag is a host value (no sync): the
                    # steps after the stop would change nothing
                    break

        leaf_i, leaf_f = st.leaf_i[:, :L], st.leaf_f[:, :L]
        leaf_value = leaf_f[2]
        renew = (self.objective.persistent_renew_spec()
                 if self.objective is not None else None)
        if renew is not None:
            # the percentile refit of L1, quantile and MAPE, before
            # shrinkage (the reference's RenewTreeOutput -> Shrinkage
            # order, gbdt.cpp:379-386), over fixed [L] windows (empty past
            # n_leaves); it takes precedence over the quantized refit
            leaf_value = self._renew_leaf_outputs(data, n, leaf_i, *renew)
        elif qscales is not None and self.config.quant_train_renew_leaf:
            leaf_value = self._renew_quant_leaves(data, n, leaf_i, leaf_f)
        ni = max(L - 1, 1)
        ta = dict(
            n_leaves=st.n_leaves.to(i32),
            t_f=st.t_f[:, :ni].clone(), t_i=st.t_i[:, :ni].clone(),
            t_lr=torch.stack([st.t_left[:ni], st.t_right[:ni]]),
            leaf_f=torch.stack([leaf_f[0], leaf_f[1], leaf_value]),
            leaf_i=torch.stack([leaf_i[2], leaf_i[1], st.leaf_depth[:L]]))
        ta["leaf_value"] = ta["leaf_f"][2]
        return ta, leaf_i.clone()

    # -- the captured split step (CUDA graph) ----------------------------
    def _graph_signature(self, data: torch.Tensor, bound: int,
                         bynode: bool):
        """The key of a captured split step, as the JAX package keys its
        programs (``_compile_signature``): the layout (P, R), F and B, L,
        the option set (quantized, categorical, monotone, bynode,
        max_depth, histogram pool), the launches' row bound (the
        learner's rows: not the tree's, which change per bagging round)
        and the state's address (the graph reads the state where it was
        captured: the persistent state, or the per-tree path's one
        buffer)."""
        P, R = data.shape
        return (P, R, self.num_features, self.max_num_bin, self.num_leaves,
                self._quant, self.any_categorical, self.use_monotone,
                bynode, self.config.max_depth, self._use_hist_pool, bound,
                data.data_ptr())

    def _replay_steps(self, st, data: torch.Tensor, feature_mask, qscales,
                      bound: int) -> None:
        """The tree's L - 1 split steps as replays of one captured step.
        The step is captured once per signature (counted with its seconds
        under ``compile.graph_captures`` / ``graph_capture_s``); its
        inputs that change per tree (the feature mask, the quantization
        scales) are copied into the graph's own buffers first. A step
        after the stop is a no-op, so the replay count is fixed. The
        wrappers' launch counts of the captured step are added once per
        replay. A capture that fails raises."""
        from ..compile import manager
        L = self.num_leaves
        bynode = feature_mask.dim() == 2
        key = self._graph_signature(data, bound, bynode)
        g = self._graph
        if g is None or g["key"] != key:
            self._graph = None
            t0 = time.perf_counter()
            mask_buf = feature_mask.clone()
            qs_buf = (torch.stack([qscales[0], qscales[1]]).to(torch.float32)
                      if qscales is not None else None)
            before = dict(K.LAUNCHES)
            graph = torch.cuda.CUDAGraph()
            if self._graph_pool is None:
                self._graph_pool = torch.cuda.graph_pool_handle()
            with obs.span("fused/split step (graph capture)",
                          phase="split"):
                with torch.cuda.graph(graph, pool=self._graph_pool):
                    self._split_step(
                        st, data, mask_buf,
                        None if qs_buf is None else (qs_buf[0], qs_buf[1]),
                        bound)
            delta = {k: v - before[k] for k, v in K.LAUNCHES.items()}
            K.LAUNCHES.update(before)       # the capture launched nothing
            manager.count("graph_captures")
            manager.add_time("graph_capture", time.perf_counter() - t0)
            g = self._graph = dict(key=key, graph=graph, mask=mask_buf,
                                   qs=qs_buf, launches=delta)
        g["mask"].copy_(feature_mask)
        if qscales is not None:
            g["qs"].copy_(torch.stack([qscales[0], qscales[1]]))
        with obs.span("fused/split steps (graph replays)", phase="split"):
            for _ in range(L - 1):
                g["graph"].replay()
        K.add_launches(g["launches"], L - 1)

    def _graph_rule(self, data: torch.Tensor) -> bool:
        """Whether a tree (persistent or per-tree) replays the captured
        split step: on the card, in one process (a collective of the
        data-parallel learner cannot be captured), once the learner has
        grown one tree eagerly (kernels loaded, allocator warm), and
        unless ``_eager_loop`` is set (the tests and chip_smoke hold the
        graph against the eager device loop with it)."""
        return (data.is_cuda and not self._eager_loop
                and self._single_process and self._trees_grown > 0)

    # -- reading trees back --------------------------------------------
    def tree_to_host(self, flat: np.ndarray) -> Dict:
        """Host tree arrays (the layout ``materialize_tree`` takes) from
        one tree's float64 values in ``_tree_flat`` order."""
        L = self.num_leaves
        ni_all = max(L - 1, 1)
        rows_i = 5 + plane.CAT_WORDS
        at = 0

        def take(size):
            nonlocal at
            out = flat[at:at + size]
            at += size
            return out
        k = int(take(1)[0])
        ni = max(k - 1, 0)
        tf = take(3 * ni_all).reshape(3, ni_all)[:, :ni]
        ti = take(rows_i * ni_all).reshape(rows_i, ni_all)[:, :ni].astype(
            np.int64)
        lr = take(2 * ni_all).reshape(2, ni_all)[:, :ni].astype(np.int32)
        lf = take(3 * L).reshape(3, L)[:, :k]
        li = take(3 * L).reshape(3, L)[:, :k].astype(np.int64)
        return dict(
            n_leaves=k, internal_count=ti[0],
            split_feature=ti[1], threshold_bin=ti[2],
            default_left=ti[3].astype(bool), split_cat=ti[4].astype(bool),
            split_bits=(ti[5:].T & 0xFFFFFFFF),
            split_gain=tf[0], internal_value=tf[1], internal_weight=tf[2],
            left_child=lr[0].copy(), right_child=lr[1].copy(),
            leaf_value=lf[2], leaf_weight=lf[1], leaf_count=li[0],
            leaf_depth=li[2].astype(np.int32), leaf_count_local=li[1])

    @staticmethod
    def _tree_flat(ta: Dict) -> torch.Tensor:
        """One tree's device arrays as one float64 vector (int32 and
        float32 values are exact in it)."""
        return torch.cat([ta[k].reshape(-1).to(torch.float64)
                          for k in ("n_leaves", "t_f", "t_i", "t_lr",
                                    "leaf_f", "leaf_i")])

    def read_trees(self, tas) -> list:
        """Host tree arrays of the device trees ``tas``: ONE counted
        read for all of them."""
        if not tas:
            return []
        flats = [self._tree_flat(ta) for ta in tas]
        with obs.span("fused/trees (read)", phase="fetch"):
            # tpulint: sync-ok(one read of every pending tree when a consumer asks)
            host = np.asarray(self._read(torch.stack(flats)),
                              dtype=np.float64)
        return [self.tree_to_host(h) for h in host]

    def traverse_bins(self, ta: Dict, bins: torch.Tensor) -> torch.Tensor:
        """[N] int64 leaf of every row of ``bins`` ([N, G] bin codes on
        the device) by bin-space traversal of the DEVICE tree arrays
        ``ta`` (the JAX package's traverse_bins): EFB codes decoded per
        row, the missing bin routed by default_left, categorical nodes
        by their bin bitset. L - 1 masked steps (``max_depth`` when
        set), so it reads nothing."""
        nrows = bins.shape[0]
        dev = bins.device
        i64 = torch.int64
        L = self.num_leaves
        steps = min(L - 1, self.config.max_depth) \
            if self.config.max_depth > 0 else L - 1
        t_i, t_lr = ta["t_i"], ta["t_lr"]
        feat_n, thr_n = t_i[1].long(), t_i[2].long()
        dl_n, cat_n = t_i[3] != 0, t_i[4] != 0
        left_n, right_n = t_lr[0].long(), t_lr[1].long()
        miss_n = self.feature_miss_bin.long()[feat_n]
        words_n = t_i[5:].t().long() & 0xFFFFFFFF          # [L-1, 8]
        rows = torch.arange(nrows, device=dev)
        node = torch.where(ta["n_leaves"].to(dev) > 1, 0, -1).to(i64
                                                                  ).expand(
            nrows).clone()
        efb = (None if self._efb_dev is None
               else tuple(x.long() for x in self._efb_dev))
        for _ in range(steps):
            nid = torch.clamp(node, min=0)
            f = feat_n[nid]
            if efb is None:
                b = bins[rows, f].long()
            else:
                group_of, offset_of, nslots_of, skip_of = efb
                rel = bins[rows, group_of[f]].long() - offset_of[f]
                inband = (rel >= 0) & (rel < nslots_of[f])
                b = torch.where(inband, rel + (rel >= skip_of[f]).long(),
                                skip_of[f])
            mb = miss_n[nid]
            go_left = torch.where((b == mb) & (mb >= 0), dl_n[nid],
                                  b <= thr_n[nid])
            if self.any_categorical:
                word = words_n[nid, torch.clamp(b >> 5, max=7)]
                cat_left = ((word >> (b & 31)) & 1) == 1
                cat_left = cat_left & (b < 32 * plane.CAT_WORDS)
                go_left = torch.where(cat_n[nid], cat_left, go_left)
            nxt = torch.where(go_left, left_n[nid], right_n[nid])
            node = torch.where(node < 0, node, nxt)
        return -node - 1

    def _raw_grads(self, data: torch.Tensor, n: int):
        """float32 gradients / hessians of the objective from the
        state's score, label and weight planes, zero on pad lanes."""
        Ly = self.layout
        score = plane.get_f32(data, Ly.score)
        label = plane.get_f32(data, Ly.label)
        weight = plane.get_f32(data, Ly.weight) if Ly.weight >= 0 else None
        grads = (self.objective.quantized_grads if self._quant
                 else self.objective.persistent_grads)
        g, h = grads(score, label, weight)
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
        Leaves without rows get 0.

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
        the reference walks the sorted rows.

        ``win`` [3, k]: each leaf's local window (start, count) and its
        global count ([2, k] on one device: the counts are equal). Under the data-parallel learner every count and
        weight sum is summed over the ranks (``_psum``), each rank's
        empty windows zeroed first, and the ranks are the global
        counts'."""
        Ly = self.layout
        dev = self.device
        i64 = torch.int64
        mask32 = 0xFFFFFFFF
        start, cnt_local = win[0].long(), win[1].long()
        cnt = win[-1].long()
        lanes = Ly.num_lanes
        realm = torch.arange(lanes, device=dev) < n
        resid = plane.get_f32(data, Ly.label) - plane.get_f32(data, Ly.score)
        bits = resid.view(torch.int32).to(i64)
        u = bits & mask32
        ukey = torch.where(bits < 0, ~u & mask32, u | 0x80000000)
        lane_leaf = torch.zeros(lanes, dtype=i64, device=dev)
        lane_leaf[:n] = self._lane_leaf(win, n)
        ends = torch.clamp(start + cnt_local, min=1) - 1
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
            raw = self._psum(torch.where(cnt_local > 0, raw,
                                         torch.zeros_like(raw)))
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
        difference of one prefix sum in XLA's order, summed over the
        ranks under the data-parallel learner. win: [3, k] window start /
        local count / global count; leaf_f: [5, k] sum_g, sum_h, output,
        cmin, cmax."""
        g, h = self._raw_grads(data, n)
        start, count = win[0].long(), win[1].long()
        ends = torch.clamp(start + count, min=1) - 1
        sidx = torch.clamp(start, min=1) - 1

        def seg_sums(c):
            cs = S._prefix_sum(c)
            lo = torch.where(start > 0, cs[sidx], 0.0)
            return self._psum(torch.where(count > 0, cs[ends] - lo, 0.0))

        sg, sh = seg_sums(g), seg_sums(h)
        cfg = self.split_cfg
        out = -S.threshold_l1(sg, cfg.lambda_l1) \
            / (sh + cfg.lambda_l2 + S.K_EPSILON)
        if cfg.max_delta_step > 0:
            out = torch.clamp(out, -cfg.max_delta_step, cfg.max_delta_step)
        out = torch.minimum(torch.maximum(out, leaf_f[3]), leaf_f[4])
        return torch.where(win[-1] > 0, out, leaf_f[2])

    def codes_planes(self) -> torch.Tensor:
        """The bin-code planes of the training rows in row order,
        packed on the device once and cached with the multi-value slot
        planes (``mv_planes``): every unbagged per-tree state starts
        from them (the persistent state drops them once built)."""
        if self._codes_planes is None:
            # tpulint: sync-ok(once: cached in _codes_planes)
            codes = torch.as_tensor(np.ascontiguousarray(self.dataset.bins),
                                    device=self.device)
            self._codes_planes = plane.build_codes_planes(codes, self.layout)
        self.mv_planes()
        return self._codes_planes

    def mv_planes(self) -> Optional[torch.Tensor]:
        """[K, n] int32 slot-major multi-value codes of the training rows
        on the device (None without the multi-value layout), cached."""
        if self._mv_dev is None and self._mv_codes is not None:
            # tpulint: sync-ok(once: cached in _mv_dev)
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
    def _state_buffer(self) -> torch.Tensor:
        """The per-tree path's [P, R] int32 planar state, allocated once:
        each tree's state is built into it (``plane.build_data`` with
        ``out``), so the captured split step reads every tree's state
        at one address."""
        if self._tree_data is None:
            Ly = self.layout
            self._tree_data = torch.empty((Ly.num_planes, Ly.num_lanes),
                                          dtype=torch.int32,
                                          device=self.device)
        return self._tree_data

    def bag_state(self, grad: torch.Tensor, hess: torch.Tensor,
                  perm: torch.Tensor) -> torch.Tensor:
        """The bag-ordered planar state of one tree (the JAX package's
        grow_device bagging branch), in the learner's state buffer: the
        row-major codes, grad / hess and slot planes gathered by
        ``perm`` ([bag | oob]) and packed, with ``perm`` as the row ids.
        One gather per tree, not per split."""
        bins = self.bins_device()
        cp = plane.build_codes_planes(bins[perm], self.layout)
        mv = self.mv_planes()
        return plane.build_data(
            self.layout, cp, grad[perm].to(torch.float32),
            hess[perm].to(torch.float32), rowid=perm,
            mv=None if mv is None else mv[:, perm],
            out=self._state_buffer())

    def grow_device(self, grad: torch.Tensor, hess: torch.Tensor,
                    perm: Optional[torch.Tensor] = None,
                    bag_cnt: Optional[int] = None):
        """One tree from row-order gradients (the JAX package's
        grow_device), with no read. Returns the tree arrays as DEVICE
        tensors (``_grow_tree``'s dict, leaf values before shrinkage;
        the booster keeps them as a ``PendingTree``) and leaf_of_row [n]
        int64 on the device. On the card the tree replays the captured
        split step from the learner's second tree on (``_graph_rule``):
        its state is built into the learner's one state buffer.

        Unbagged (``_score_from_partition``): the state from the cached
        code planes, grad / hess [n] float32 in row order, row ids
        0..n-1 and the slot planes; each row's leaf is its lane's leaf
        scattered back to row order through the row-id plane. Under row
        sampling: the bag-ordered state of ``bag_state``, the tree grown
        on lanes [0, bag_cnt) (root sums from the bag's histogram), and
        every row's leaf, out-of-bag rows included, by bin-space
        traversal of the new tree over the full codes."""
        n = self.actual_rows
        masks = self.feature_masks_for_tree()
        if not self._score_from_partition:
            data = self.bag_state(grad, hess, perm)
            ta, _ = self._grow_tree(data, int(bag_cnt), masks,
                                    graph=self._graph_rule(data))
            self._trees_grown += 1
            return ta, self.traverse_bins(ta, self.bins_device())
        cp = self.codes_planes()
        data = plane.build_data(self.layout, cp, grad.to(torch.float32),
                                hess.to(torch.float32), mv=self._mv_dev,
                                out=self._state_buffer())
        ta, win = self._grow_tree(data, n, masks,
                                  graph=self._graph_rule(data))
        self._trees_grown += 1
        rowids = data[self.layout.rowid, :n].long()
        leaf_of_row = torch.empty(n, dtype=torch.int64, device=self.device)
        leaf_of_row[rowids] = self._lane_leaf(win, n)
        return ta, leaf_of_row

    grow_device = obs.instrument_kernel(grow_device, "fused",
                                        name="fused/grow_device")

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
            # tpulint: sync-ok(once: the persistent state is built at the first iteration)
            return torch.as_tensor(np.asarray(a, np.float32), device=dev)
        data = plane.build_data(self.layout, cp, zeros, zeros,
                                label=up(aux_label),
                                score=up(score_vec), weight=up(aux_weight),
                                mv=self._mv_dev)
        # the state is built once: keep no second device copy of it
        self._codes_planes = self._mv_dev = None
        return data

    def train_iter(self, data: torch.Tensor, shrinkage: float,
                   bias: float = 0.0, mask: Optional[torch.Tensor] = None
                   ) -> Dict:
        """One boosting iteration on the persistent state, in place (the
        JAX package's train_iter_persistent): gradients from the
        in-state score, tree growth, score update (GBDT::TrainOneIter,
        gbdt.cpp:337), with no host read. Returns
        the tree arrays as device tensors (``_grow_tree``; leaf values
        before shrinkage). ``mask``: the tree's feature mask, drawn
        earlier (a queued iteration's), else drawn now."""
        Ly = self.layout
        n = self.n_valid
        g, h = self._raw_grads(data, n)
        qscales = None
        if self._quant:
            # one quantization pass per iteration, keyed by fold_in of
            # the base key with the iteration counter (outside the
            # captured step); the maxima agree over the ranks, so every
            # rank quantizes on one grid and the int32 histogram sums
            # stay coherent
            key = threefry.fold_in(self._quant_base_key, self._quant_iter)
            self._quant_iter += 1
            Q.note_requantize(self.config.num_grad_quant_bins)
            qg, qh, gs, hs = Q.quantize_gradients(
                g, h, self.config.num_grad_quant_bins, key,
                stochastic=self.config.stochastic_rounding,
                grad_max=self._psum_max(torch.max(torch.abs(g))),
                hess_max=self._psum_max(torch.max(h)), reciprocal=True)
            qscales = (gs, hs)
            plane.set_gh_packed(data, Ly,
                                plane.i32_as_f32(Q.pack_gh(qg, qh)))
        else:
            plane.set_gh(data, Ly, g, h)

        if mask is None:
            mask = self.feature_masks_for_tree()
        ta, win = self._grow_tree(data, n, mask, qscales,
                                  graph=self._graph_rule(data))
        self._trees_grown += 1

        vals = ta["leaf_value"] * torch.tensor(shrinkage, dtype=torch.float32)
        s = plane.get_f32(data, Ly.score, n)
        s.add_(self._score_add(win, vals, ta["n_leaves"], n))
        # always, as the JAX package: adding 0.0 turns a -0.0 score to
        # +0.0 (a Python float is added as its float32 value)
        s.add_(float(np.float32(bias)))
        return ta

    train_iter = obs.instrument_kernel(train_iter, "fused",
                                       name="fused/train_iter")

    def train_iters_persistent(self, data: torch.Tensor, shrinkage: float,
                               masks: List[torch.Tensor]
                               ) -> "TreeArrayBatch":
        """K boosting iterations (one per mask, drawn when they were
        queued) with the trees stacked into one batch that one read
        serves (the JAX package's train_iters_persistent)."""
        return TreeArrayBatch(self, [self.train_iter(data, shrinkage,
                                                     mask=m)
                                     for m in masks])

    def _score_add(self, win, vals, n_leaves, n: int) -> torch.Tensor:
        """[n] score increment by window (every lane of leaf l's window
        gets leaf l's value; no gather, no scatter) with the bits of the
        JAX package's ``_score_add_by_pos``, over fixed [L] arrays: the
        leaves with rows here (below ``n_leaves``, a local count > 0)
        sorted by window start, the rest after them; the differences of
        consecutive values summed over ``num_leaves`` terms in XLA's
        reduce order. One [L, L] table gives each leaf its value; a
        leaf without rows repeats 0 times."""
        L = self.num_leaves
        dev = vals.device
        lid = torch.arange(L, device=dev)
        cnt = win[1].long()
        valid = (lid < n_leaves.to(dev)) & (cnt > 0)
        starts = torch.where(valid, win[0].long(), self.layout.num_lanes + 1)
        idx = torch.argsort(starts, stable=True)
        v = vals[idx]
        d = v - torch.nn.functional.pad(v[:-1], (1, 0))
        steps = lid[:, None] >= lid[None, :]
        table = _leaf_steps_sum(torch.where(steps, d, 0.0))
        return torch.repeat_interleave(table, cnt[idx], output_size=n)

    def sync_scores(self, data: torch.Tensor) -> torch.Tensor:
        """[n] f32 raw scores in original row order (one scatter)."""
        n = self.actual_rows
        rowids = data[self.layout.rowid, :n].long()
        out = torch.empty(n, dtype=torch.float32, device=self.device)
        out[rowids] = plane.get_f32(data, self.layout.score, n)
        return out

    # -- checkpoint and resume (robust/checkpoint.py) -------------------
    def persistent_lane_state(self, data: torch.Tensor):
        """(rowid_lanes, score_bits): the two planes of the persistent
        state that evolve irrecoverably, as int32 numpy [R]. The LANE
        ORDER is numeric state (B2 permutes the lanes, B1 sums each
        window in lane order), so row-order scores would not resume
        bit-identically; every other plane is a function of the dataset
        gathered through the rowid plane and is rebuilt on restore."""
        Ly = self.layout
        both = data[[Ly.rowid, Ly.score]].cpu().numpy()
        return both[0], both[1]

    def _restore_planes(self, rid: torch.Tensor, rows: torch.Tensor,
                        score_bits, codes: torch.Tensor, mv) -> torch.Tensor:
        """The planar state of lanes whose dataset rows are ``rows``
        (the first lanes, in lane order), row ids ``rid`` on every lane:
        ``codes`` / ``mv`` gathered for those lanes, label and weight
        through ``rows``, zero grad / hess (``set_gh`` writes them
        before any read), and the score plane's saved words."""
        Ly = self.layout
        dev = self.device
        aux_label, aux_weight = self.objective.persistent_aux()

        def gather(a):
            if a is None:
                return None
            t = a if torch.is_tensor(a) \
                else torch.as_tensor(np.asarray(a, np.float32))
            return t.to(dev, torch.float32)[rows]
        zeros = torch.zeros(rows.shape[0], dtype=torch.float32, device=dev)
        data = plane.build_data(Ly, plane.build_codes_planes(codes, Ly),
                                zeros, zeros, rowid=rid,
                                label=gather(aux_label), score=zeros,
                                weight=gather(aux_weight), mv=mv)
        data[Ly.score] = torch.as_tensor(np.asarray(score_bits, np.int32),
                                         device=dev)
        return data

    def restore_persistent_state(self, rowid_lanes, score_bits
                                 ) -> torch.Tensor:
        """Rebuild the planar state from a checkpoint's lane planes on
        the device. Partitions only permute lanes within [0, n), so the
        codes, label and weight of lane j are the dataset's at row
        rowid[j] (gathered through the ``ops/plane.py`` builders); the
        score plane is written back bit for bit."""
        assert self.persistent_capable
        dev = self.device
        n = self.actual_rows
        rid = torch.as_tensor(np.asarray(rowid_lanes, np.int32), device=dev)
        rows = rid[:n].long()
        codes = self.dataset.device_bins(dev)[rows]
        mv = None
        if self._mv_codes is not None:
            mv = torch.as_tensor(np.ascontiguousarray(self._mv_codes.T),
                                 device=dev)[:, rows]
        # as init_persistent_state: keep no second copy of the codes
        self._codes_planes = self._mv_dev = None
        return self._restore_planes(rid, rows, score_bits, codes, mv)

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
            return _device.upload(self._tree_mask_np(), self.device)
        tm = self._tree_mask_np()
        idx = np.flatnonzero(tm)
        k = max(1, int(np.ceil(frac * len(idx))))
        E = 2 * self.num_leaves
        masks = np.zeros((E, self.num_features), dtype=bool)
        for e in range(E):
            masks[e, self._col_rng.choice(idx, size=k, replace=False)] = True
        return _device.upload(masks, self.device)

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


class TreeArrayBatch:
    """The device tree arrays of K iterations (``train_iters_persistent``
    or ``GBDT._materialize_models``): one read serves all K trees."""

    def __init__(self, grower: FusedSerialGrower, trees: List[Dict]) -> None:
        self.grower = grower
        self.trees = trees
        self._host: Optional[List[Dict]] = None

    def host(self) -> List[Dict]:
        if self._host is None:
            self._host = self.grower.read_trees(self.trees)
        return self._host


class PendingTree:
    """A tree left on the device (the JAX package's PendingTree): the
    training loop never reads it; a host consumer materializes it. Any
    Tree attribute (num_leaves, to_string, leaf_index_raw, ...)
    materializes the host Tree once and delegates to it, so consumers
    that read GBDT.models directly keep working.

    Its arrays come directly (``tree_arrays``: the device dict of
    ``train_iter``), from a batch (``batch`` + ``index`` into a
    TreeArrayBatch), or from a queue (``resolver``: dispatches the
    owning booster's queued iterations, which then sets ``batch``)."""

    def __init__(self, grower: FusedSerialGrower,
                 tree_arrays: Optional[Dict] = None, *,
                 batch: Optional[TreeArrayBatch] = None,
                 index: int = 0, resolver=None) -> None:
        self._tree: Optional[Tree] = None
        self.grower = grower
        self._dev = tree_arrays
        self._ta: Optional[Dict] = None
        self.batch = batch
        self.index = index
        self.resolver = resolver
        self.pending_shrinkage = 1.0
        self.pending_bias = 0.0
        # the leaf count once read (immutable once the tree is grown)
        self._n_leaves_host: Optional[int] = None

    def device_arrays(self) -> Dict:
        """The tree's device arrays (dispatching queued iterations
        first)."""
        if self._dev is None:
            if self.batch is None and self.resolver is not None:
                self.resolver()
            if self._dev is None:
                self._dev = self.batch.trees[self.index]
        return self._dev

    @property
    def tree_arrays(self) -> Dict:
        """The host tree arrays: the batch's one read, or this tree's."""
        if self._ta is None:
            dev = self.device_arrays()
            if self.batch is not None:
                self._ta = self.batch.host()[self.index]
            else:
                self._ta = self.grower.read_trees([dev])[0]
        return self._ta

    @tree_arrays.setter
    def tree_arrays(self, value: Dict) -> None:
        self._ta = value

    def apply_shrinkage(self, rate: float) -> None:
        if self._tree is not None:
            self._tree.apply_shrinkage(rate)
        else:
            self.pending_shrinkage *= rate

    def add_bias(self, val: float) -> None:
        if self._tree is not None:
            self._tree.add_bias(val)
        else:
            self.pending_bias += val

    def leaf_values_device(self) -> torch.Tensor:
        """[L] float32 leaf values with the pending shrinkage and bias,
        on the device."""
        if self._tree is not None:
            t = self._tree
            # tpulint: sync-ok(materialized host trees only: pending trees stay on the card)
            return torch.as_tensor(
                t.leaf_value[:max(t.num_leaves, 1)].astype(np.float32),
                device=self.grower.device)
        return (self.device_arrays()["leaf_value"]
                * torch.tensor(self.pending_shrinkage, dtype=torch.float32)
                + torch.tensor(self.pending_bias, dtype=torch.float32))

    def materialize(self) -> Tree:
        if self._tree is None:
            tree = self.grower.materialize_tree(self.tree_arrays)
            if self.pending_shrinkage != 1.0:
                tree.apply_shrinkage(self.pending_shrinkage)
            if self.pending_bias != 0.0:
                tree.add_bias(self.pending_bias)
            self._tree = tree
        return self._tree

    def __getattr__(self, name: str):
        # reached only when normal lookup fails: a Tree attribute.
        # Materialize once and delegate; guard the recursion of a copy
        # or unpickling before __init__ has run
        if name.startswith("__") or name in (
                "_tree", "grower", "_dev", "_ta", "batch", "index",
                "resolver", "pending_shrinkage", "pending_bias",
                "_n_leaves_host"):
            raise AttributeError(name)
        return getattr(self.materialize(), name)
