"""Tree learners across devices, one process per device.

The port of the JAX package's treelearner/parallel.py (reference
src/treelearner/data_parallel_tree_learner.cpp — local histograms, a
Network::ReduceScatter at :169, SyncUpGlobalBestSplit at :240;
feature_parallel_tree_learner.cpp — every machine holds every row and
scans its share of the features; voting_parallel_tree_learner.cpp —
PV-Tree's top-k votes, then a reduction of the winners' histograms).

The JAX package shards rows over a ``"data"`` mesh axis in one process
and sums histograms with ``jax.lax.psum`` inside ``shard_map``. The port
runs one process per device in a ``torch.distributed`` group (see
network.py): rank r owns the rows that shard r owns there,
``[r·sr, (r+1)·sr)`` with ``sr = ceil(n / D)``, and the collectives are
network.py's ``psum`` / ``pmax`` / ``all_gather``, whose float sums keep
the JAX ``psum``'s rank order, so every rank makes the same split
decisions and grows the same tree. Every rank holds the whole dataset
(as the JAX package's one process does) and the same training scores;
a rank's kernels touch only its own rows.

- ``FusedDataParallelGrower``: the fused learner per rank over the rank's
  planar state; one reduction of the smaller child's histogram (and of
  the left count) per split. The persistent path keeps each rank's
  scores in its state (``sync_scores`` sums the scattered shards, as the
  JAX package does); the per-tree path (bagging, multiclass, custom
  objectives) builds each tree's state from the rank's bag.
- ``DataParallelTreeGrower``: the host loop per rank, the local
  histograms summed (packed int32 words under quantized gradients when
  the leaf's global count allows).
- ``VotingParallelTreeGrower``: local top-k votes, summed, then only the
  2·top_k winners' histograms reduced; no subtraction.
- ``FeatureParallelTreeGrower``: every rank holds every row, scans the
  features it owns (io/distributed.py ``partition_features``), and the
  best records are all-gathered; ties go to the lowest feature index,
  as the one-device argmax.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import network
from .. import obs
from ..config import Config
from ..io.binning import BIN_CATEGORICAL
from ..io.dataset import BinnedDataset
from ..io.distributed import partition_features
from ..io.efb import per_feature_hist
from ..models.tree import Tree
from ..ops import histogram as H
from ..ops import plane
from ..ops import quantize as Q
from ..ops import split as S
from ..ops import threefry
from ..ops.partition import partition_leaf
from ..utils import device as _device
from ..utils import log
from .fused import FusedSerialGrower
from .serial import SerialTreeGrower, _Leaf


def shard_bag_permutation(perm, bag_cnt: int, num_shards: int,
                          rows_per_shard: int):
    """Global bag permutation -> per-shard LOCAL permutations [D, sr]
    (bag rows first, in order, then the rest) and per-shard bag counts
    [D]: the reference's SetBaggingData applied to each machine's own
    rows. Shard d owns global rows [d·sr, (d+1)·sr)."""
    D, sr = num_shards, rows_per_shard
    mask = np.zeros(D * sr, dtype=bool)
    mask[np.asarray(perm[:bag_cnt])] = True
    perm_np = np.empty((D, sr), np.int64)
    counts = np.empty(D, np.int64)
    m2 = mask.reshape(D, sr)
    for d in range(D):
        bag_local = np.flatnonzero(m2[d])
        oob_local = np.flatnonzero(~m2[d])
        perm_np[d] = np.concatenate([bag_local, oob_local])
        counts[d] = len(bag_local)
    return perm_np, counts


def build_mesh(config: Config) -> Tuple[int, int]:
    """(world size, rank) of the default process group, which plays the
    JAX package's "data" mesh axis; ``tpu_mesh_shape``, when given, must
    name that many devices."""
    world, rank = network.world_size(), network.rank()
    if config.tpu_mesh_shape:
        shape = tuple(int(s) for s in config.tpu_mesh_shape)
        need = int(np.prod(shape))
        if need != world:
            log.fatal("tpu_mesh_shape %s needs %d devices, the process "
                      "group has %d ranks (one per device)", shape, need,
                      world)
    return world, rank


def _shard_rows(n: int, world: int, rank: int) -> Tuple[int, int, int]:
    """(rows per shard, first row of this rank, this rank's rows)."""
    sr = -(-n // world)
    lo = rank * sr
    return sr, lo, max(0, min(n - lo, sr))


# ---------------------------------------------------------------------------
# the fused learner
# ---------------------------------------------------------------------------

class FusedDataParallelGrower(FusedSerialGrower):
    """The fused learner per rank (the JAX package's
    FusedDataParallelGrower): each rank partitions and histograms only
    its own rows and keeps its own leaf windows; the histograms and the
    counts that decide the splits are summed over the ranks, so the tree
    is the same on every rank (the reference's SyncUpGlobalBestSplit,
    :240, has nothing to do). It runs the split steps eagerly on every
    device (a collective cannot be captured in a CUDA graph): no read
    per split, the reductions kept."""

    # its reductions are collectives: the split steps run eagerly
    _single_process = False

    def __init__(self, dataset: BinnedDataset, config: Config, objective,
                 device) -> None:
        self.num_shards, self.rank = build_mesh(config)
        self.global_rows = dataset.num_data
        sr, lo, nv = _shard_rows(dataset.num_data, self.num_shards,
                                 self.rank)
        super().__init__(dataset, config, objective, device, num_rows=sr)
        self.shard_rows, self._lo = sr, lo
        self.n_valid = nv
        self._bins_sh = None
        self._bag_key = None

    def _psum(self, x: torch.Tensor) -> torch.Tensor:
        return network.psum(x)

    def _psum_max(self, x: torch.Tensor) -> torch.Tensor:
        return network.pmax(x)

    def _small_bound(self, n: int) -> int:
        # the smaller child by the global counts may hold most of this
        # rank's rows of the leaf
        return n

    def _local_bins(self, edge: bool) -> np.ndarray:
        """This rank's [sr, G] bin rows; the short last shard padded with
        zeros or, with ``edge``, its last row (pad rows never enter a
        window)."""
        sr, lo, nv = self.shard_rows, self._lo, self.n_valid
        b = np.asarray(self.dataset.bins)[lo:lo + nv]
        if nv < sr:
            b = np.pad(b, ((0, sr - nv), (0, 0)),
                       mode="edge" if edge and nv else "constant")
        return np.ascontiguousarray(b)

    def mv_planes(self) -> Optional[torch.Tensor]:
        """[K, sr] slot-major multi-value codes of this rank's rows (pad
        rows carry the no-contribution code -1), cached."""
        if self._mv_dev is None and self._mv_codes is not None:
            sr, lo, nv = self.shard_rows, self._lo, self.n_valid
            mv = np.full((self._mv_codes.shape[1], sr), -1, np.int32)
            mv[:, :nv] = self._mv_codes[lo:lo + nv].T
            # tpulint: sync-ok(once: cached in _mv_dev)
            self._mv_dev = torch.as_tensor(mv, device=self.device)
        return self._mv_dev

    # -- persistent mode -----------------------------------------------
    def init_persistent_state(self, score_vec) -> torch.Tensor:
        """This rank's planar state: its rows' codes, label, weight and
        scores; pad rows (the short last shard's, and the lanes past it)
        carry row id n, which ``sync_scores`` drops."""
        assert self.persistent_capable
        dev, Ly = self.device, self.layout
        n, lo, nv = self.global_rows, self._lo, self.n_valid
        aux_label, aux_weight = self.objective.persistent_aux()
        cp = plane.build_codes_planes(
            # tpulint: sync-ok(once: the persistent state is built at the first iteration)
            torch.as_tensor(self._local_bins(edge=False), device=dev), Ly)

        def shard(a):
            if a is None:
                return None
            t = (a if torch.is_tensor(a)
                 else torch.as_tensor(np.asarray(a, np.float32)))
            return t.to(dev, torch.float32)[lo:lo + nv]
        rowid = torch.full((Ly.num_lanes,), n, dtype=torch.int32, device=dev)
        rowid[:nv] = torch.arange(lo, lo + nv, dtype=torch.int32, device=dev)
        zeros = torch.zeros(nv, dtype=torch.float32, device=dev)
        data = plane.build_data(Ly, cp, zeros, zeros, rowid=rowid,
                                label=shard(aux_label),
                                score=shard(score_vec),
                                weight=shard(aux_weight),
                                mv=self.mv_planes())
        self._mv_dev = None
        return data

    def persistent_lane_state(self, data: torch.Tensor):
        """(rowid_lanes, score_bits) of every rank, [D, R] int32 numpy
        in rank order (one gather), as the JAX package's sharded state
        reads whole: the writer, rank 0, saves every rank's lanes."""
        Ly = self.layout
        both = network.all_gather(data[[Ly.rowid, Ly.score]].contiguous())
        both = both.cpu().numpy()
        return both[:, 0], both[:, 1]

    def restore_persistent_state(self, rowid_lanes, score_bits
                                 ) -> torch.Tensor:
        """This rank's planar state from its row of a checkpoint's
        [D, R] lane planes: its rows' codes, label and weight gathered
        through the global row ids of its first ``n_valid`` lanes (pad
        lanes keep id n and zero codes), the score words as saved."""
        assert self.persistent_capable
        dev = self.device
        nv, lo = self.n_valid, self._lo
        rid = torch.as_tensor(np.asarray(rowid_lanes, np.int32)[self.rank],
                              device=dev)
        rows = rid[:nv].long()
        codes = self.dataset.device_bins(dev)[rows]
        mv = self.mv_planes()
        mv = None if mv is None else mv[:, rows - lo]
        self._mv_dev = None
        return self._restore_planes(rid, rows, np.asarray(
            score_bits, np.int32)[self.rank], codes, mv)

    def sync_scores(self, data: torch.Tensor) -> torch.Tensor:
        """[n] float32 raw scores in row order on every rank: each rank
        scatters its rows' scores into zeros and the shards are summed
        (the JAX package's _sync_scores, so a -0.0 score reads +0.0)."""
        nv = self.n_valid
        rowids = data[self.layout.rowid, :nv].long()
        out = torch.zeros(self.global_rows, dtype=torch.float32,
                          device=self.device)
        out[rowids] = plane.get_f32(data, self.layout.score, nv)
        return network.psum(out)

    # -- per-tree mode -------------------------------------------------
    def _bins_row_sharded(self) -> torch.Tensor:
        """This rank's [sr, G] bin rows on the device (the short last
        shard padded with its last row), cached."""
        if self._bins_sh is None:
            # tpulint: sync-ok(once: cached in _bins_sh)
            self._bins_sh = torch.as_tensor(self._local_bins(edge=True),
                                            device=self.device)
        return self._bins_sh

    def _sharded_bag_views(self, perm, bag_cnt: int):
        """(local permutation [sr] on the device, local bag count) of a
        bag, cached on the permutation object so the class trees of one
        iteration and consecutive unbagged iterations skip the host
        pass."""
        key = (id(perm), int(bag_cnt))
        if self._bag_key == key:
            return self._bag_val
        D, sr, n = self.num_shards, self.shard_rows, self.global_rows
        if bag_cnt >= n:
            perm_l = np.arange(sr, dtype=np.int64)
            cnt = self.n_valid
        else:
            # tpulint: sync-ok(data-parallel bagging: one bag per bagging round)
            p = (perm[:bag_cnt].cpu().numpy() if torch.is_tensor(perm)
                 else np.asarray(perm[:bag_cnt]))
            perm_np, counts = shard_bag_permutation(p, bag_cnt, D, sr)
            perm_l, cnt = perm_np[self.rank], int(counts[self.rank])
        self._bag_key, self._bag_ref = key, perm
        self._bag_val = (_device.upload(perm_l, self.device), cnt)
        return self._bag_val

    def grow_device(self, grad: torch.Tensor, hess: torch.Tensor,
                    perm: Optional[torch.Tensor] = None,
                    bag_cnt: Optional[int] = None):
        """One tree from row-order gradients (the JAX package's sharded
        grow_device): this rank's bag-ordered state (its local
        permutation, bag rows first) in the learner's state buffer, the
        tree grown over the rank's bag lanes with the reductions (the
        eager device loop: ``_graph_rule`` keeps a collective off the
        graph), and every row's leaf by bin-space traversal of the new
        tree (every rank holds every row, so no gather). Returns the
        device tree arrays and leaf_of_row, as the one-device
        learner's."""
        dev = self.device
        sr, lo, nv = self.shard_rows, self._lo, self.n_valid
        n = self.global_rows
        perm_l, cnt = self._sharded_bag_views(
            perm, n if bag_cnt is None else bag_cnt)

        def local(v):
            out = torch.zeros(sr, dtype=torch.float32, device=dev)
            out[:nv] = v[lo:lo + nv].to(torch.float32)
            return out[perm_l]
        cp = plane.build_codes_planes(self._bins_row_sharded()[perm_l],
                                      self.layout)
        mv = self.mv_planes()
        data = plane.build_data(self.layout, cp, local(grad), local(hess),
                                rowid=perm_l,
                                mv=None if mv is None else mv[:, perm_l],
                                out=self._state_buffer())
        ta, _ = self._grow_tree(data, cnt, self.feature_masks_for_tree(),
                                graph=self._graph_rule(data))
        self._trees_grown += 1
        return ta, self.traverse_bins(ta, self.bins_device())

    grow_device = obs.instrument_kernel(grow_device, "fused",
                                        name="fused/grow_device")


# ---------------------------------------------------------------------------
# the host-loop learners
# ---------------------------------------------------------------------------

class DataParallelTreeGrower(SerialTreeGrower):
    """The host loop with rows split over the ranks (reference
    data_parallel_tree_learner.cpp; the JAX package's
    DataParallelTreeGrower): every leaf keeps each rank's window (start,
    count) as [D] vectors on the host, a rank histograms and partitions
    only its own rows, and the histograms, leaf totals and left counts
    are summed over the ranks. The split scan runs on the summed
    histograms, the same on every rank."""

    supports_hist_subtraction = True

    def __init__(self, dataset: BinnedDataset, config: Config,
                 device) -> None:
        super().__init__(dataset, config, device)
        self.num_shards, self.rank = build_mesh(config)
        d = self.num_shards
        n = dataset.num_data
        rps, self._lo, _ = _shard_rows(n, d, self.rank)
        self.rows_per_shard = rps
        self._shard_valid_rows = np.asarray(
            [_shard_rows(n, d, r)[2] for r in range(d)], np.int64)
        # the host-loop parallel learners take the row-major kernels:
        # the multi-value layout is the serial and fused learners' path
        self.hist_method = H.hist_method(config)
        self._hist_dtype = H.hist_dtype(self.hist_method, config)
        self._bins_local = None

    @property
    def _grow_bins(self) -> torch.Tensor:
        """This rank's [rps, G] bin rows on the device (the short last
        shard padded with its last row), uploaded at first use."""
        if self._bins_local is None:
            rps, lo = self.rows_per_shard, self._lo
            nv = self._shard_valid_rows[self.rank]
            b = np.asarray(self.dataset.bins)[lo:lo + nv]
            if nv < rps:
                b = np.pad(b, ((0, rps - nv), (0, 0)),
                           mode="edge" if nv else "constant")
            self._bins_local = torch.as_tensor(np.ascontiguousarray(b),
                                               device=self.device)
        return self._bins_local

    def _reduce(self, hist: torch.Tensor, packed: bool) -> torch.Tensor:
        """Sum a histogram over the ranks: packed (qg << 16 | qh) words,
        half the bytes, when the leaf's global count keeps every 16-bit
        hessian field exact (``Q.packed_rows_ok``), else as it is."""
        if packed:
            return Q.packed_hist_to_pairs(
                network.psum(Q.pairs_to_packed_hist(hist)))
        return network.psum(hist)

    def _local_hist(self, perm, start: int, count: int, grad, hess):
        """This rank's histogram of its window, in the bin matrix's
        columns (bundle space under EFB)."""
        if count == 0:
            nb = (self.group_max_bin if self._efb_hist is not None
                  else self.max_num_bin)
            cols = int(self.dataset.bins.shape[1])
            return torch.zeros((cols, nb, 2), dtype=torch.int32
                               if self._qscales is not None
                               else torch.float32, device=self.device)
        return self._group_hist(perm, start, count, grad, hess)

    def _note_packed(self, packed: bool) -> None:
        """hist.quant_packed_bytes / hist.quant_overflow_escalations
        (obs schema minor 2): under quantized gradients, whether this
        leaf's reduction rode the halved packed words or escalated to
        the unpacked int32 pairs."""
        if self._qscales is None:
            return
        if packed:
            obs.inc("hist.quant_packed_bytes",
                    self.num_features * self.max_num_bin * 4)
        else:
            obs.inc("hist.quant_overflow_escalations")

    def _leaf_sums(self, h: torch.Tensor):
        """The leaf's (grad, hess) totals from column 0 of this rank's
        histogram, summed over the ranks: float32 sums in XLA's order,
        or exact level sums."""
        if self._qscales is not None:
            return network.psum(h[0].sum(dim=0))
        return network.psum(S.xla_sum(h[0].t()))

    def _hist_call(self, total_count: int, perm, start: int, count: int,
                   grad, hess, sums: bool = False):
        """The global per-feature histogram of one leaf: the local
        histogram, summed over the ranks, then the EFB reconstruction
        with global totals (the JAX package's _hist_fn_sharded). With
        ``sums`` (the root; a child's totals come from its split
        record), also the global leaf totals [2]."""
        h = self._local_hist(perm, start, count, grad, hess)
        packed = (self._qscales is not None
                  and Q.packed_rows_ok(int(total_count),
                                       self.config.num_grad_quant_bins))
        self._note_packed(packed)
        hist = self._efb_expand(self._reduce(h, packed))
        return (hist, self._leaf_sums(h)) if sums else hist

    # telemetry: the histogram with its reduction, and the partition
    # with its left-count gather, under their phases (obs/spans.py)
    _hist_call = obs.instrument_kernel(_hist_call, "hist",
                                       name="data_parallel/leaf_histogram")

    # -- grower ---------------------------------------------------------
    def prefetch_quantize(self, grad: torch.Tensor,
                          hess: torch.Tensor) -> None:
        """No prefetch: ``grow`` quantizes the padded global gradients
        inline, which the serial grower's ring could not match."""

    def grow(self, grad: torch.Tensor, hess: torch.Tensor,
             perm: torch.Tensor, num_data: int) -> Tree:
        """One tree (the JAX package's DataParallelTreeGrower.grow):
        grad / hess [N] in row order on every rank, padded with zeros to
        D·rps rows; under bagging the out-of-bag rows' gradients are
        zeroed and each rank's local permutation lists its bag rows
        first."""
        cfg = self.config
        dev = self.device
        d, rps, r = self.num_shards, self.rows_per_shard, self.rank
        n = self.dataset.num_data
        if self._forced_splits is not None:
            log.warning("forcedsplits_filename is not supported by the "
                        "parallel tree learners yet; ignoring")
        pad = rps * d - n
        grad = torch.nn.functional.pad(grad.to(torch.float32), (0, pad))
        hess = torch.nn.functional.pad(hess.to(torch.float32), (0, pad))
        counts0 = self._shard_valid_rows.copy()
        perm_l = np.arange(rps, dtype=np.int64)
        if num_data < n:
            p = perm[:num_data]
            mask = torch.zeros(rps * d, dtype=torch.bool, device=dev)
            mask[p] = True
            grad = torch.where(mask, grad, 0.0)
            hess = torch.where(mask, hess, 0.0)
            perm_np, counts0 = shard_bag_permutation(
                # tpulint: sync-ok(data-parallel host loop: the bag's rows for sharding)
                p.cpu().numpy(), num_data, d, rps)
            perm_l = perm_np[r]
        self._qscales = None
        raw_g = raw_h = None
        lo = self._lo
        if self._quant:
            # one quantization pass per tree over the global (padded)
            # gradients, the same on every rank; the histograms and
            # their sums then run in exact level space
            key = threefry.fold_in(
                threefry.PRNGKey(cfg.objective_seed ^ 0x51A7),
                self._quant_tree_idx)
            self._quant_tree_idx += 1
            with obs.span("gradient quantization", phase="quantize"):
                Q.note_requantize(cfg.num_grad_quant_bins)
                qg, qh, gs, hs = Q.quantize_gradients(
                    grad, hess, cfg.num_grad_quant_bins, key,
                    cfg.stochastic_rounding)
                self._qscales = (gs, hs)
                # tpulint: sync-ok(data-parallel host loop: quantization scales per tree)
                self._qscales_host = tuple(self._read(torch.stack(
                    [gs.to(torch.float64), hs.to(torch.float64)])))
            if cfg.quant_train_renew_leaf:
                raw_g, raw_h = grad[lo:lo + rps], hess[lo:lo + rps]
            g_l, h_l = qg[lo:lo + rps], qh[lo:lo + rps]
        else:
            g_l, h_l = grad[lo:lo + rps], hess[lo:lo + rps]
        perm_t = _device.upload(perm_l, dev)
        self._cur_perm, self._cur_grad, self._cur_hess = perm_t, g_l, h_l

        tree = Tree(cfg.num_leaves,
                    track_branch_features=bool(self._interaction_sets))
        tree_mask = self._feature_mask_tree()
        rand_thr = self._rand_thresholds()
        starts0 = np.zeros(d, dtype=np.int64)
        hist, sums = self._hist_call(int(counts0.sum()), perm_t, 0,
                                     int(counts0[r]), g_l, h_l, sums=True)
        with obs.span("data_parallel/root sums (read)", phase="hist"):
            # tpulint: sync-ok(data-parallel host loop: the root sums, one per tree)
            sg, sh = self._read(sums.to(torch.float64))
        if self._qscales is not None:
            # level sums -> dequantized leaf totals, in float64
            sg *= self._qscales_host[0]
            sh *= self._qscales_host[1]
        root = _Leaf(starts0, counts0, sg, sh, 0.0, 0)
        root.hist = hist
        root.best = self._compute_best_dp(
            root, tree_mask, set() if self._interaction_sets else None,
            rand_thr)
        leaves: Dict[int, _Leaf] = {0: root}
        for _ in range(cfg.num_leaves - 1):
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
            perm_t = self._split_leaf_dp(tree, leaves, best_leaf, perm_t,
                                         g_l, h_l, tree_mask, rand_thr)
        if self._quant and cfg.quant_train_renew_leaf:
            self._renew_leaf_values_dp(tree, leaves, perm_t, raw_g, raw_h)
        return tree

    def _renew_leaf_values_dp(self, tree: Tree, leaves: Dict[int, _Leaf],
                              perm, grad, hess) -> None:
        """The leaf outputs refit from the float32 gradient sums after a
        quantized growth (the JAX package's _renew_leaf_values_dp): per
        rank one prefix sum over its leaf-ordered rows; the [L, D] window
        boundary values are all-gathered and the sums over the ranks and
        the outputs run in float64 on the host."""
        items = [(lid, lf) for lid, lf in leaves.items()
                 if int(np.sum(lf.count)) > 0]
        if not items:
            return
        dev, r = self.device, self.rank
        cs = S._prefix_sum(torch.stack([grad[perm], hess[perm]]))
        starts = np.asarray([lf.start for _, lf in items])     # [L, D]
        counts = np.asarray([lf.count for _, lf in items])     # [L, D]
        ends = starts + counts - 1
        los = starts - 1
        # tpulint: sync-ok(data-parallel host loop: refit indices, one per tree)
        e_idx = torch.as_tensor(np.maximum(ends[:, r], 0), device=dev)
        # tpulint: sync-ok(data-parallel host loop: refit indices, one per tree)
        lo_idx = torch.as_tensor(np.maximum(los[:, r], 0), device=dev)
        mine = torch.cat([cs[:, e_idx], cs[:, lo_idx]])        # [4, L]
        with obs.span("data_parallel/renew leaf values (read)",
                      phase="renew"):
            self.syncs += 1
            # tpulint: sync-ok(data-parallel host loop: refit sums, one read per tree)
            g4 = _device.device_get(network.all_gather(mine))  # [D, 4, L]
        ge, he, gl, hl = (np.ascontiguousarray(g4[:, i].T)
                          for i in range(4))                   # [L, D]
        has = counts > 0
        has_lo = los >= 0
        sum_g = np.sum(np.where(
            has, np.asarray(ge, np.float64) - np.where(has_lo, gl, 0.0),
            0.0), axis=1)
        sum_h = np.sum(np.where(
            has, np.asarray(he, np.float64) - np.where(has_lo, hl, 0.0),
            0.0), axis=1)
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

    def _partition_dp(self, perm, leaf: _Leaf, fi, thr, dl, mb, is_cat,
                      bitset):
        """This rank's partition of its window of ``leaf`` and the left
        counts of every rank ([D] int64 on the host, one all-gather and
        one read: they steer the host loop). Returns (new_perm, lc)."""
        r = self.rank
        new_perm, lc_mine = perm, 0
        if leaf.count[r] > 0:
            new_perm, lc_mine = partition_leaf(
                self._grow_bins, perm, int(leaf.start[r]),
                int(leaf.count[r]), fi, thr, dl, mb, is_cat,
                cat_bitset=bitset, efb=self._efb_dev)
        self.syncs += 1          # the left counts steer the host loop
        # tpulint: sync-ok(data-parallel host loop: per-split counts via the host)
        lc = _device.device_get(network.all_gather(torch.tensor(
            [lc_mine], dtype=torch.int64,
            device=network.comm_device())))[:, 0]
        return new_perm, lc

    _partition_dp = obs.instrument_kernel(
        _partition_dp, "partition", name="data_parallel/partition_leaf")

    def _compute_best_dp(self, leaf: _Leaf, tree_mask, branch_features,
                         rand_thr):
        """The serial scan of a leaf with its global count."""
        total = int(np.sum(leaf.count))
        if total < 2 * self.config.min_data_in_leaf \
                or leaf.sum_h < 2 * self.config.min_sum_hessian_in_leaf:
            return None
        fake = _Leaf(0, total, leaf.sum_g, leaf.sum_h, leaf.output,
                     leaf.depth, hist=leaf.hist, cmin=leaf.cmin,
                     cmax=leaf.cmax)
        return self._compute_best(fake, tree_mask, branch_features,
                                  rand_thr)

    def _split_leaf_dp(self, tree: Tree, leaves: Dict[int, _Leaf], lid: int,
                       perm, grad, hess, tree_mask, rand_thr):
        """Apply a leaf's best split: the tree node, this rank's
        partition, the left counts all-gathered, the smaller child's
        histogram by the global counts, and both children's scans."""
        r = self.rank
        leaf = leaves[lid]
        best = leaf.best
        fi = best["feature"]
        mapper = self.dataset.bin_mappers[fi]
        real_feature = self.dataset.real_feature_index[fi]
        is_cat = mapper.bin_type == BIN_CATEGORICAL
        if is_cat:
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
            thr, dl, mb = 0, False, -1
            # tpulint: sync-ok(data-parallel host loop: a categorical split's bitset)
            bitset = torch.as_tensor(words, device=self.device)
        else:
            right_leaf = tree.split(
                lid, fi, real_feature, best["threshold"],
                mapper.bin_to_value(best["threshold"]),
                best["left_output"], best["right_output"],
                best["left_count"], best["right_count"],
                best["left_sum_hessian"], best["right_sum_hessian"],
                best["gain"], mapper.missing_type, best["default_left"])
            thr, dl, mb = (best["threshold"], best["default_left"],
                           int(self.feature_miss_bin[fi]))
            bitset = None
        new_perm, lc = self._partition_dp(perm, leaf, fi, thr, dl, mb,
                                          is_cat, bitset)
        rc = leaf.count - lc

        lcmin, lcmax, rcmin, rcmax = leaf.cmin, leaf.cmax, leaf.cmin, \
            leaf.cmax
        if self.use_monotone:
            mono = self.dataset.monotone_constraint(fi)
            if mono != 0:
                mid = (best["left_output"] + best["right_output"]) / 2.0
                if mono > 0:
                    lcmax, rcmin = min(lcmax, mid), max(rcmin, mid)
                else:
                    lcmin, rcmax = max(lcmin, mid), min(rcmax, mid)
        left = _Leaf(leaf.start.copy(), lc, best["left_sum_gradient"],
                     best["left_sum_hessian"], best["left_output"],
                     leaf.depth + 1, cmin=lcmin, cmax=lcmax)
        right = _Leaf(leaf.start + lc, rc, best["right_sum_gradient"],
                      best["right_sum_hessian"], best["right_output"],
                      leaf.depth + 1, cmin=rcmin, cmax=rcmax)

        lt, rt = int(lc.sum()), int(rc.sum())
        smaller, larger = (left, right) if lt <= rt else (right, left)
        smaller.hist = self._hist_call(
            min(lt, rt), new_perm, int(smaller.start[r]),
            int(smaller.count[r]), grad, hess)
        if self.supports_hist_subtraction:
            # exact in int32 level space under quantized gradients
            larger.hist = leaf.hist - smaller.hist
        else:
            # each voting round selects its own features: parent and
            # child histograms do not subtract
            larger.hist = self._hist_call(
                max(lt, rt), new_perm, int(larger.start[r]),
                int(larger.count[r]), grad, hess)
        leaf.hist = None

        branches = None
        if self._interaction_sets:
            branches = {self.dataset.inner_feature_index[f]
                        for f in tree.branch_features[lid]
                        if f in self.dataset.inner_feature_index}
        left.best = self._compute_best_dp(left, tree_mask, branches,
                                          rand_thr)
        right.best = self._compute_best_dp(right, tree_mask, branches,
                                           rand_thr)
        leaves[lid] = left
        leaves[right_leaf] = right
        return new_perm


class VotingParallelTreeGrower(DataParallelTreeGrower):
    """PV-Tree voting (reference voting_parallel_tree_learner.cpp; the
    JAX package's VotingParallelTreeGrower): each rank scans its LOCAL
    histograms (min_data_in_leaf and min_sum_hessian_in_leaf divided by
    the ranks, reference :62-64) and votes for its top_k features; the
    votes are summed, and only the 2·top_k most voted features'
    histograms are reduced (CopyLocalHistogram :185 + ReduceScatter of
    the selected buffers :343). The others stay zero, so the scan does
    not pick them. Each round selects its own features, so parent and
    child histograms are not subtracted."""

    supports_hist_subtraction = False

    def _hist_call(self, total_count: int, perm, start: int, count: int,
                   grad, hess, sums: bool = False):
        d = self.num_shards
        cfg = self.split_cfg
        h = self._local_hist(perm, start, count, grad, hess)
        if self._efb_hist is not None:
            # the reconstruction is linear in the group histogram: each
            # rank rebuilds its own per-feature histogram, and the sum of
            # the selected features equals the global reconstruction;
            # the totals in XLA's order, as the JAX program sums them
            tot = S.xla_sum(h[0].t())
            h = per_feature_hist(h, self._efb_hist, tot[0], tot[1])
        local_cfg = S.SplitConfig(
            lambda_l1=cfg.lambda_l1, lambda_l2=cfg.lambda_l2,
            min_data_in_leaf=max(1, cfg.min_data_in_leaf // d),
            min_sum_hessian_in_leaf=cfg.min_sum_hessian_in_leaf / d,
            min_gain_to_split=cfg.min_gain_to_split,
            max_delta_step=cfg.max_delta_step, path_smooth=cfg.path_smooth)
        dev = self.device
        f32 = torch.float32
        if self._qscales is not None:
            # the vote scan runs on the dequantized LOCAL histogram; the
            # reductions stay integer
            gs, hs = self._qscales
            sg, sh = h[0].sum(dim=0)
            h_scan = S.dequantize_hist(h, gs, hs)
            sg_scan, sh_scan = sg.to(f32) * gs, sh.to(f32) * hs
        else:
            sg, sh = S.xla_sum(h[0].t())
            h_scan, sg_scan, sh_scan = h, sg, sh
        res = S.numerical_split_scan(
            h_scan, self.meta, local_cfg, sg_scan, sh_scan,
            torch.tensor(count, dtype=torch.int32, device=dev),
            torch.tensor(0.0, dtype=f32, device=dev),
            torch.tensor(-np.inf, dtype=f32, device=dev),
            torch.tensor(np.inf, dtype=f32, device=dev),
            forward_folded=not self.meta.any_two_scan)
        gains = torch.where(torch.isfinite(res["gain"]), res["gain"],
                            -np.inf)
        f_total = gains.shape[0]
        top_idx = _top_k(gains, min(self.config.top_k, f_total))
        votes = torch.zeros(f_total, dtype=torch.int32, device=dev)
        votes[top_idx] += 1
        votes = network.psum(votes)
        tot = network.psum(torch.stack([sg, sh])) if sums else None
        packed = (self._qscales is not None
                  and Q.packed_rows_ok(int(total_count),
                                       self.config.num_grad_quant_bins))
        self._note_packed(packed)
        k2 = min(2 * self.config.top_k, f_total)
        if k2 >= f_total:
            hist = self._reduce(h, packed)
        else:
            # the tally is the same on every rank after its sum, so
            # every rank selects the same features; only their slab is
            # reduced
            selected = _top_k(votes, k2)
            hist = torch.zeros_like(h)
            hist[selected] = self._reduce(h[selected], packed)
        return (hist, tot) if sums else hist

    _hist_call = obs.instrument_kernel(_hist_call, "hist",
                                       name="data_parallel/leaf_histogram")


def _top_k(x: torch.Tensor, k: int) -> torch.Tensor:
    """The indices of the k largest values, ties to the lower index
    (``jax.lax.top_k``'s order: a stable descending sort)."""
    return torch.sort(x, descending=True, stable=True).indices[:k]


class FeatureParallelTreeGrower(SerialTreeGrower):
    """Every rank holds every row (reference
    feature_parallel_tree_learner.cpp): the histograms and the
    partition are the serial learner's on each rank, while the split
    scan runs on the features this rank owns (``partition_features``)
    and the best records of the ranks are all-gathered; the best gain
    wins, ties going to the lowest feature index, as the one-device
    argmax. The trees are the serial learner's (the JAX package's
    learner is a sharding constraint on the same scan)."""

    def __init__(self, dataset: BinnedDataset, config: Config,
                 device) -> None:
        super().__init__(dataset, config, device)
        self.num_shards, self.rank = build_mesh(config)
        own = partition_features(self.num_features,
                                 self.num_shards)[self.rank]
        self._own = torch.as_tensor(own, dtype=torch.int64, device=device)
        cats = [i for i, f in enumerate(own)
                if self.dataset.bin_mappers[f].bin_type == BIN_CATEGORICAL]
        self._own_meta = self.meta.subset(self._own, tuple(cats))
        self._own_has_cat = bool(cats)

    def _best_record(self, hist, meta, leaf: _Leaf, mask, rand_thr,
                     cegb_delta, scale, feature_ids=None) -> torch.Tensor:
        own = self._own
        width = 13 + ((2 + self.max_num_bin) if self.any_categorical else 0)
        if own.numel() == 0:
            mine = torch.zeros(width, dtype=torch.float64,
                               device=self.device)
            mine[0] = -np.inf
            mine[12] = self.num_features
        else:
            def sub(x):
                return None if x is None else x[own]
            rec = super()._best_record(
                hist[own], self._own_meta, leaf, mask[own], sub(rand_thr),
                sub(cegb_delta), sub(scale), feature_ids=own)
            if self.any_categorical and not self._own_has_cat:
                rec = torch.nn.functional.pad(rec, (0, width - rec.numel()))
            mine = rec
        recs = network.all_gather(mine.to(network.comm_device()))
        recs = recs.to(self.device)
        # the best gain, then the lowest feature index
        gain = torch.nan_to_num(recs[:, 0], nan=-np.inf)
        top = gain == gain.max()
        feat = torch.where(top, recs[:, 12], float(self.num_features))
        return recs[torch.argmin(feat)]


def create_parallel_learner(kind: str, dataset: BinnedDataset,
                            config: Config, device):
    """reference TreeLearner::CreateTreeLearner (tree_learner.h:99)."""
    if kind == "data":
        return DataParallelTreeGrower(dataset, config, device)
    if kind == "voting":
        return VotingParallelTreeGrower(dataset, config, device)
    if kind == "feature":
        return FeatureParallelTreeGrower(dataset, config, device)
    log.fatal("Unknown parallel tree learner %s", kind)
