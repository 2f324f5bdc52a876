"""GBDT boosting loop.

The port of the JAX package's boosting/gbdt.py for plain gradient
boosting: init, boost-from-average (reference gbdt.cpp:312), the
one-tree-per-iteration loop (GBDT::TrainOneIter, gbdt.cpp:337) on the
fused learner's persistent state or, for every config the fused learner
turns away, on the host-loop SerialTreeGrower, metric evaluation,
prediction, and the model text (gbdt_model_text.cpp:306
SaveModelToString / :410 LoadModelFromString). Across the ranks of a
``torch.distributed`` group (network.py), ``tree_learner=data`` takes
the fused learner per rank (``FusedDataParallelGrower``) where the
serial config is eligible for it, and data, voting and feature
otherwise take the host-loop parallel learners
(treelearner/parallel.py); every rank keeps the whole training score.

The fused learner's trees stay on the device as ``PendingTree``s until
a host consumer (save, predict, rollback, refit, checkpoint, DART's
drop) asks, and ``_materialize_models`` then reads all of them at once;
the host loop's are host Trees. Objectives that grow K trees per
iteration (multiclass) or whose gradients come from outside the fused
learner's program (custom objectives, ``cross_entropy_lambda``) take the
per-tree fused path: each class tree's planar state built into the
learner's one state buffer (``FusedSerialGrower.grow_device``) and the
score update through each row's leaf, with no read. Quantized-gradient
training (``use_quantized_grad``) runs on both learners.

Row sampling re-permutes the rows per iteration: bagging (numpy
``RandomState``, the JAX package's draws) and GOSS (its device-side
sampling, ``ops/threefry.py``) hand the learner a ``[bag | oob]``
permutation; the fused learner then grows each tree on a bag-ordered
state and scores every row by traversal (``grow_device``). ``DART``
drops trees from the training score before each iteration and
normalizes them after; ``RF`` grows every tree from the constant
initial score and averages the trees' outputs. Continued training
(``init_model``: the old trees prepended, ``num_init_iteration``
counting them), rollback and refit follow the JAX package.

The loop is pipelined by default (engine.py; ``LGBM_TPU_PIPELINE=0``
restores the synchronous loop): ``begin_eval_at_iter`` reduces the
metrics on the device and starts their one copy to the host without
waiting, ``finish_eval_at_iter`` waits for it one iteration later, and
the fused paths' periodic no-more-splits check decides on the verdict
of the previous check (``_periodic_stop_check``), as the JAX package's
does; the host loop enqueues each class tree's quantization ahead of
its growth (``prefetch_quantize``). The loop counts
``pipeline.inflight_fetches`` (evaluation copies started) and
``pipeline.delayed_stop_iters`` (iterations trained past a stop it saw
late). The JAX package's ``pipeline.donated_bytes`` counts XLA buffer
donation, which the port has no counterpart of (its state is updated in
place), and ``pipeline.overlap_share`` is computed only by the JAX
side's bench script, so neither is set here.

Robustness (robust/): ``checkpoint_state`` / ``restore_checkpoint_state``
carry everything a resumed run needs to finish byte-identical to the
uninterrupted one — every RNG stream, the bag permutation, the float32
scores, and on the persistent fused path the state's lane order (the
rowid and score planes, never row-order scores). With
``numeric_sentinels`` the gradient planes and each new tree's leaf
values are checked for non-finite and overflowed values; the verdicts
ride reads the loop already makes, and a trip quarantines the
iteration's trees (``quarantine_iter``: every score rebuilt from the
surviving trees).
"""
from __future__ import annotations

import copy
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import network
from .. import obs
from ..config import Config
from ..io.binning import BIN_CATEGORICAL
from ..io.dataset import BinnedDataset
from ..metric.metrics import Metric
from ..models.tree import Tree
from ..objective.functions import ObjectiveFunction, create_objective
from ..ops import split as S
from ..ops import threefry
from ..robust.sentinel import NumericSentinel, read_verdicts
from ..robust.watchdog import watch_phase
from ..treelearner.fused import (FusedSerialGrower, PendingTree,
                                 TreeArrayBatch, fused_reject_reason)
from ..treelearner.serial import SerialTreeGrower
from ..utils import device as _device
from ..utils import log
from ..utils.device import resolve_device

K_EPSILON = 1e-15
K_MODEL_VERSION = "v3"


def _pack_rng(rng: np.random.RandomState) -> dict:
    kind, keys, pos, has_gauss, cached = rng.get_state()
    return {"kind": kind, "keys": np.asarray(keys, dtype=np.uint32),
            "pos": int(pos), "has_gauss": int(has_gauss),
            "cached": float(cached)}


def _unpack_rng(rng: np.random.RandomState, state: dict) -> None:
    rng.set_state((state["kind"], np.asarray(state["keys"], np.uint32),
                   int(state["pos"]), int(state["has_gauss"]),
                   float(state["cached"])))


def parse_tree_blocks(text: str) -> List[Tree]:
    """The Tree= blocks of a model text as host Trees."""
    body = text[text.index("tree_sizes="):]
    out = []
    for blk in body.split("Tree=")[1:]:
        blk = blk.split("end of trees")[0]
        out.append(Tree.from_string(blk.partition("\n")[2]))
    return out


class _ScoreState:
    """Per-dataset score accumulator on the device (reference
    score_updater.hpp:21); validation sets also keep their bin codes
    there for the per-tree bin-space traversal."""

    def __init__(self, dataset: BinnedDataset, num_trees_per_iter: int,
                 device, with_bins: bool = False) -> None:
        self.dataset = dataset
        init = np.zeros((num_trees_per_iter, dataset.num_data),
                        dtype=np.float32)
        self.has_init_score = dataset.metadata.init_score is not None
        if self.has_init_score:
            init += np.asarray(dataset.metadata.init_score, np.float32
                               ).reshape(num_trees_per_iter, -1)
        # tpulint: sync-ok(once per score state, as after a quarantine rebuild)
        self.score = torch.as_tensor(init, device=device)
        self.bins = dataset.device_bins(device) if with_bins else None

    def add_constant(self, val: float, class_id: int) -> None:
        self.score[class_id] += torch.tensor(val, dtype=torch.float32)

    def add_tree(self, tree: Tree, class_id: int, bins: torch.Tensor,
                 miss_bin, efb) -> None:
        """score[c] += the tree's float32 leaf values at each row's leaf,
        found by bin-space traversal of ``bins`` (the JAX package's
        _ScoreState.add_tree)."""
        leaf = tree.leaf_index_binned(bins, miss_bin, efb)
        # tpulint: sync-ok(DART's normalize traverses host trees, as the JAX package)
        vals = torch.as_tensor(
            tree.leaf_value[:tree.num_leaves].astype(np.float32),
            device=self.score.device)
        self.score[class_id] += vals[leaf]


class GBDT:
    """The boosting loop (reference gbdt.h:34)."""

    def __init__(self, device=None) -> None:
        # like every entry point: the card unless the caller names a
        # device ("cpu" included); no card raises
        self.device = (torch.device(device) if device is not None
                       else resolve_device(Config()))
        self.models: List[Tree] = []
        self.iter = 0
        # iterations loaded from a model (continued training)
        self.num_init_iteration = 0
        # bumped where trees change in place (rollback, refit): part of
        # the cached forests' key
        self._pred_revision = 0
        self._fused_state = None
        self.config: Optional[Config] = None
        self.train_data: Optional[BinnedDataset] = None
        self.objective: Optional[ObjectiveFunction] = None
        self.metrics: List[Metric] = []
        self.valid_metrics: List[List[Metric]] = []
        self.valid_score: List[_ScoreState] = []
        self.num_tree_per_iteration = 1
        self.loaded_parameter = ""
        self.feature_names_: List[str] = []
        self.label_idx = 0
        self.max_feature_idx = 0
        self._fused = None
        self.tree_learner = None
        self.average_output = False
        # dispatch-ahead pipelining (LGBM_TPU_PIPELINE=0 restores the
        # synchronous loop): the engine resolves each evaluation one
        # iteration late, and the fused paths' periodic stop check
        # decides on the previous check's verdict. The degraded-mode
        # ladder (robust/sentinel.py) clears _pipeline at rung 1 and
        # _device_eval (metrics on a host copy of the scores) at rung 2;
        # the rungs taken, in order
        self._pipeline = os.environ.get("LGBM_TPU_PIPELINE", "1") != "0"
        self._device_eval = True
        # the fused paths' no-more-splits check: its period (the JAX
        # package's), the check in flight (leaf counts, dispatch
        # iteration, dispatch trace iteration) and a drained verdict
        # not consumed yet (True or None)
        self._stop_check_every = 50
        self._stop_fetch = None
        self._stop_pending = None
        self.degraded_rungs: List[str] = []
        # numeric-health sentinels (robust/sentinel.py; made by init
        # under numeric_sentinels) and the train.iteration:nan/overflow
        # drill's pending poison
        self._sentinel: Optional[NumericSentinel] = None
        self._poison_next = None
        # the persistent path's iteration batching (the JAX package's
        # LGBM_TPU_ITER_BATCH, default 1): K iterations are queued and
        # then run together, their K trees read back by one read; valid
        # sets keep the batch at 1 (their scores need each tree). The
        # queued trees, their feature masks, and the sentinel checks
        # waiting for the queue to run
        self._iter_batch = max(1, int(os.environ.get(
            "LGBM_TPU_ITER_BATCH", "1")))
        self._pq_trees: list = []
        self._pq_masks: list = []
        self._sentinel_deferred: list = []

    # ------------------------------------------------------------------
    def init(self, config: Config, train_data: BinnedDataset,
             objective: Optional[ObjectiveFunction],
             metrics: Sequence[Metric]) -> None:
        """reference GBDT::Init (gbdt.cpp:42)."""
        self.config = config
        self.train_data = train_data
        self.objective = objective
        self.num_data = train_data.num_data
        self.num_tree_per_iteration = (
            objective.num_tree_per_iteration if objective is not None
            else max(config.num_class, 1))
        self.shrinkage_rate = config.learning_rate
        self.metrics = list(metrics)
        self.max_feature_idx = train_data.num_total_features - 1
        self.feature_names_ = list(train_data.feature_names)
        if objective is not None:
            objective.init(train_data.metadata, self.num_data)
        for m in self.metrics:
            m.init(train_data.metadata, self.num_data)
        self._fused = None
        self._fused_state = None     # persistent planar state (device)
        self._score_dirty = False    # train_score stale vs _fused_state
        reason = fused_reject_reason(config, train_data, objective)
        if reason is None:
            self._fused = FusedSerialGrower(train_data, config, objective,
                                            self.device)
        elif config.tree_learner == "data" and network.world_size() > 1:
            # the fused learner per rank, its histograms summed over the
            # process group: the persistent path when eligible, else the
            # per-tree path (bagging, multiclass, custom objectives)
            cfg_serial = copy.copy(config)
            cfg_serial.tree_learner = "serial"
            reason = fused_reject_reason(cfg_serial, train_data, objective)
            if reason is None:
                from ..treelearner.parallel import FusedDataParallelGrower
                self._fused = FusedDataParallelGrower(
                    train_data, config, objective, self.device)
        if self._fused is None:
            if self.device.type == "cuda" and reason != "tpu_fused=false" \
                    and config.tree_learner in ("serial", "data"):
                # name the responsible option: the host-loop grower takes
                # several blocking reads and hundreds of small kernels per
                # split
                log.warning(
                    "Config option [%s] is not supported by the fused "
                    "single-dispatch tree grower; falling back to the "
                    "host-loop grower (slower per iteration)", reason)
            self.tree_learner = self._create_tree_learner(config, train_data)
        # one program per iteration over the persistent state: a
        # pointwise objective with one tree per iteration and no row
        # sampling or score surgery (bagging, GOSS, RF, DART); the rest
        # grows each class tree from row-order gradients (grow_device)
        self._fused_persist = (self._fused is not None
                               and self._fused.persistent_capable
                               and self._fused._score_from_partition
                               and self.num_tree_per_iteration == 1
                               and config.boosting == "gbdt"
                               and type(self) is GBDT)
        self.train_score = _ScoreState(train_data,
                                       self.num_tree_per_iteration,
                                       self.device)
        if config.numeric_sentinels:
            self._sentinel = NumericSentinel(
                overflow_limit=config.sentinel_overflow_limit,
                max_trips=config.sentinel_max_trips)
        # bagging state (reference GBDT::ResetBaggingConfig,
        # gbdt.cpp:700): the [bag | oob] row permutation on the device
        self._bag_rng = np.random.RandomState(config.bagging_seed)
        self.bag_data_cnt = self.num_data
        self._full_perm = torch.arange(self.num_data, dtype=torch.int64,
                                       device=self.device)
        self._perm = self._full_perm

    def _create_tree_learner(self, config: Config,
                             train_data: BinnedDataset):
        """The host-loop learner (reference TreeLearner::
        CreateTreeLearner): the serial grower on one device, a parallel
        learner (treelearner/parallel.py) across the ranks of the
        process group, one device per rank."""
        if config.tree_learner not in ("serial", "feature", "data",
                                       "voting"):
            log.fatal("Unknown tree learner type %s", config.tree_learner)
        if config.tree_learner != "serial":
            from ..treelearner.parallel import (build_mesh,
                                                create_parallel_learner)
            world, _ = build_mesh(config)
            if world > 1:
                return create_parallel_learner(config.tree_learner,
                                               train_data, config,
                                               self.device)
            log.warning("Only one machine/chip: using serial tree learner")
        return SerialTreeGrower(train_data, config, self.device)

    def add_valid_data(self, valid_data: BinnedDataset,
                       metrics: Sequence[Metric]) -> None:
        for m in metrics:
            m.init(valid_data.metadata, valid_data.num_data)
        self.valid_metrics.append(list(metrics))
        self.valid_score.append(_ScoreState(
            valid_data, self.num_tree_per_iteration, self.device,
            with_bins=True))

    # ------------------------------------------------------------------
    def _boost_from_average(self, class_id: int) -> float:
        """reference GBDT::BoostFromAverage (gbdt.cpp:312)."""
        if self.models or self.train_score.has_init_score \
                or self.objective is None:
            return 0.0
        if self.config.boost_from_average \
                or self.train_data.num_features == 0:
            init_score = self.objective.boost_from_score(class_id)
            if abs(init_score) > K_EPSILON:
                self.train_score.add_constant(init_score, class_id)
                for vs in self.valid_score:
                    vs.add_constant(init_score, class_id)
                log.info("Start training from score %f", init_score)
                return init_score
        elif self.objective.name in ("regression_l1", "quantile", "mape"):
            log.warning("Disabling boost_from_average in %s may cause the "
                        "slow convergence", self.objective.name)
        return 0.0

    def _invalidate_fused_state(self) -> None:
        """After a direct change of the training score (rollback,
        refit): sync the persistent state's scores back and drop the
        state; the next iteration rebuilds it from the scores."""
        if self._fused_state is not None:
            self.get_training_score()
            self._fused_state = None

    def rollback_one_iter(self) -> None:
        """Drop the last iteration's trees, their leaf values subtracted
        from the training and validation scores (reference
        GBDT::RollbackOneIter, gbdt.cpp:421)."""
        self._materialize_models()
        self._invalidate_fused_state()
        if self.iter <= 0:
            return
        self._pred_revision += 1
        k = self.num_tree_per_iteration
        bins, miss, efb = self._score_tables()
        for c in range(k):
            tree = self.models[len(self.models) - k + c]
            tree.apply_shrinkage(-1.0)
            self.train_score.add_tree(tree, c, bins, miss, efb)
            for vs in self.valid_score:
                vs.add_tree(tree, c, vs.bins, miss, efb)
        del self.models[-k:]
        self.iter -= 1

    def refit_tree(self, tree_leaf_prediction: np.ndarray) -> None:
        """Refit the leaf values of the existing trees to this booster's
        gradients (reference GBDT::RefitTree, gbdt.cpp:266): per tree,
        float64 bincount sums of the rows' gradients by leaf on the
        host, the new output blended into the old by
        ``refit_decay_rate``, then the tree's score update."""
        cfg = self.config
        leaf_pred = np.asarray(tree_leaf_prediction, dtype=np.int64)
        self._pred_revision += 1
        self._materialize_models()
        self._invalidate_fused_state()
        grad, hess = _device.device_get(list(self._boosting()))
        k = self.num_tree_per_iteration
        for i, tree in enumerate(self.models):
            c = i % k
            lp = leaf_pred[:, i]
            nl = tree.num_leaves
            gs = np.bincount(lp, weights=grad[c], minlength=nl)
            hs = np.bincount(lp, weights=hess[c], minlength=nl)
            for leaf in range(nl):
                g, h = gs[leaf], hs[leaf]
                if cfg.lambda_l1 > 0:
                    g = np.sign(g) * max(0.0, abs(g) - cfg.lambda_l1)
                new_out = -g / (h + cfg.lambda_l2)
                tree.set_leaf_value(
                    leaf, cfg.refit_decay_rate * tree.leaf_value[leaf]
                    + (1.0 - cfg.refit_decay_rate) * new_out
                    * self.shrinkage_rate)
            self._update_score(tree, c)

    def _score_tables(self):
        """(bins, miss_bin, efb) of the training rows on the device, for
        bin-space traversal: the learner's own."""
        if self._fused is not None:
            fl = self._fused
            return fl.bins_device(), fl.feature_miss_bin, fl._efb_dev
        tl = self.tree_learner
        return tl.bins, tl.feature_miss_bin, tl._efb_dev

    def _bagging(self, iteration: int) -> None:
        """Per-iteration row subsetting (reference GBDT::Bagging,
        gbdt.cpp:209; pos/neg bagging for binary): the JAX package's
        numpy draws, in its order; the permutation [bag | oob] goes to
        the device once per bagging round and is kept between rounds."""
        cfg = self.config
        need = cfg.bagging_freq > 0 and (
            cfg.bagging_fraction < 1.0 or cfg.pos_bagging_fraction < 1.0
            or cfg.neg_bagging_fraction < 1.0)
        if not need or iteration % cfg.bagging_freq != 0:
            return
        n = self.num_data
        if cfg.pos_bagging_fraction != 1.0 or cfg.neg_bagging_fraction != 1.0:
            is_pos = np.asarray(self.train_data.metadata.label) > 0
            r = self._bag_rng.rand(n)
            bag = np.flatnonzero(np.where(is_pos,
                                          r < cfg.pos_bagging_fraction,
                                          r < cfg.neg_bagging_fraction))
        else:
            cnt = max(1, int(n * cfg.bagging_fraction))
            bag = self._bag_rng.choice(n, size=cnt, replace=False)
            bag.sort()
        oob = np.setdiff1d(np.arange(n, dtype=np.int64), bag,
                           assume_unique=True)
        self._perm = _device.upload(np.concatenate([bag, oob]), self.device,
                                    dtype=torch.int64)
        self.bag_data_cnt = len(bag)

    def _boosting(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """[K, N] float32 gradients and hessians of the objective from
        the row-order training score (reference GBDT::Boosting,
        gbdt.cpp:151)."""
        if self.objective is None:
            log.fatal("No objective function provided")
        score = self.get_training_score()
        if self.num_tree_per_iteration == 1:
            g, h = self.objective.get_gradients(score[0])
            return g[None, :], h[None, :]
        return self.objective.get_gradients(score)

    def _update_score(self, tree: Tree, class_id: int) -> None:
        """reference GBDT::UpdateScore (gbdt.cpp:458): train and valid
        scores of one class by bin-space traversal of the new tree."""
        bins, miss, efb = self._score_tables()
        self.train_score.add_tree(tree, class_id, bins, miss, efb)
        for vs in self.valid_score:
            vs.add_tree(tree, class_id, vs.bins, miss, efb)

    def _renew_tree_output(self, tree: Tree, class_id: int) -> None:
        """The host loop's leaf refit of L1, quantile and MAPE (reference
        SerialTreeLearner::RenewTreeOutput, serial_tree_learner.cpp:661,
        as the JAX package's GBDT._renew_tree_output): each training
        row's leaf by bin-space traversal, the float32 residual label -
        score, and the percentile of each leaf's residuals in numpy
        float64."""
        obj = self.objective
        if obj is None or not obj.is_renew_tree_output:
            return
        with obs.span("renew tree output (leaf refit)", phase="renew"):
            tl = self.tree_learner
            bagged = self.bag_data_cnt < self.num_data
            # tpulint: sync-ok(host-loop refit of L1/quantile/MAPE leaves, one read per tree)
            host = _device.device_get(
                [tree.leaf_index_binned(tl.bins, tl.feature_miss_bin,
                                        tl._efb_dev),
                 self.train_score.score[class_id]]
                + ([self._perm[:self.bag_data_cnt]] if bagged else []))
            leaf_idx = host[0]
            residual = np.asarray(self.train_data.metadata.label) - host[1]
            if bagged:
                # the bag's rows only (the JAX package's
                # _renew_tree_output_impl)
                leaf_idx, residual = leaf_idx[host[2]], residual[host[2]]
            out = obj.renew_tree_output(leaf_idx, residual,
                                        tree.num_leaves)
            if out is not None:
                tree.leaf_value[:tree.num_leaves] = out

    def _no_more_splits(self, k: int) -> bool:
        """The stop of an iteration whose K trees are all single leaves
        (reference gbdt.cpp:389-407): its trees go unless they are the
        model's first. Returns True (training stops), or False when the
        sentinel quarantined the iteration instead."""
        if self._quarantine_degenerate_iter(k):
            return False
        log.warning("Stopped training because there are no more leaves "
                    "that meet the split requirements")
        if len(self.models) > k:
            del self.models[-k:]
        return True

    def _train_one_iter_host_loop(self, init_scores, grad, hess) -> bool:
        """One iteration on the host-loop grower (the JAX package's
        non-fused TrainOneIter branch): per class, one tree from the
        row-order gradients, its refit and score update. Returns True
        when training should stop."""
        k = self.num_tree_per_iteration
        tl = self.tree_learner
        # one view per class, the same objects for the prefetch and the
        # growth (the ring matches them by identity)
        gh = [(grad[c], hess[c]) for c in range(k)]
        if self.train_data.num_features > 0:
            for g, h in gh:
                # every class tree's quantization enqueued up front: the
                # levels of tree c+1 build while tree c grows
                tl.prefetch_quantize(g, h)
        should_continue = False
        for c in range(k):
            if self.train_data.num_features > 0:
                with obs.span("gbdt/grow_tree (host loop)", phase="grow"):
                    tree = tl.grow(gh[c][0], gh[c][1], self._perm,
                                   self.bag_data_cnt)
            else:
                tree = Tree(2)
            if tree.num_leaves > 1:
                should_continue = True
                self._renew_tree_output(tree, c)
                tree.apply_shrinkage(self.shrinkage_rate)
                self._update_score(tree, c)
                if abs(init_scores[c]) > K_EPSILON:
                    tree.add_bias(init_scores[c])
            elif len(self.models) < k:
                # constant-tree path (reference gbdt.cpp:389-407)
                tree.set_leaf_value(0, init_scores[c])
                self.train_score.add_constant(init_scores[c], c)
                for vs in self.valid_score:
                    vs.add_constant(init_scores[c], c)
            self.models.append(tree)
        if not should_continue:
            return self._no_more_splits(k)
        self._sentinel_check_trees(
            [np.asarray(t.leaf_value[:max(t.num_leaves, 1)], np.float32)
             for t in self.models[-k:]])
        self.iter += 1
        return False

    # ------------------------------------------------------------------
    # numeric-health sentinels and quarantine (robust/sentinel.py)
    # ------------------------------------------------------------------
    def _apply_grad_poison(self) -> None:
        """The ``train.iteration:nan``/``overflow`` drill: poison one
        gradient element, so the corruption flows through histograms,
        split finding and leaf values as real divergence would (the
        sentinel must catch it downstream)."""
        mode, self._poison_next = self._poison_next, None
        if mode is None or self._grad is None:
            return
        self._grad = self._grad.clone()
        self._grad[0, 0] = float("nan") if mode == "nan" else 2e30
        log.warning("fault injection: poisoned the gradient plane with %s "
                    "at iteration %d", mode, self.iter)

    def _sentinel_check_grads(self) -> None:
        """Health checks of the gradient and hessian planes, reduced on
        their device; the verdicts ride the next read the loop makes.
        The persistent fused path computes its gradients inside the
        learner and is covered by its leaf-value checks."""
        if self._sentinel is None or self._grad is None:
            return
        with obs.span("sentinel health check (dispatch)", phase="sentinel"):
            self._sentinel.dispatch([self._grad, self._hess], self.iter)

    def _sentinel_check_trees(self, leaf_values, defer: bool = False,
                              iteration: Optional[int] = None) -> None:
        """Health checks of the new trees of ``iteration`` (default this
        one): host leaf values are judged at once (no read); device ones
        (the persistent path's trees) are reduced on the device and
        their verdicts ride the loop's next read. ``defer``: host
        verdicts wait in the queue too, as the JAX package's
        device-resident trees' do, so a trip is acted on at the same
        iteration."""
        if self._sentinel is not None:
            with obs.span("sentinel health check (dispatch)",
                          phase="sentinel"):
                self._sentinel.dispatch(
                    leaf_values,
                    self.iter if iteration is None else iteration,
                    defer=defer)

    def _quarantine_degenerate_iter(self, k: int) -> bool:
        """An iteration of single leaves is also the signature of a
        poisoned gradient plane (NaN gains reject every split). Before
        calling it convergence, resolve the pending verdicts; when THIS
        iteration's check tripped, discard its trees and keep training
        — the next iteration recomputes clean gradients from the
        untouched scores."""
        if self._sentinel is None:
            return False
        self.sentinel_drain()
        trips = self._sentinel.pop_trips()
        mine = [t for t in trips if t[0] == self.iter]
        others = [t for t in trips if t[0] != self.iter]
        if others:
            # earlier iterations' trips go back to the recovery policy
            self._sentinel._trips_out = others + self._sentinel._trips_out
        if not mine:
            return False
        del self.models[-k:]
        if not self.models:
            # iteration 0's boost_from_average constant was folded into
            # the scores before its trees were discarded
            self._rebuild_scores()
        obs.inc("health.quarantined", k)
        log.warning(
            "numeric sentinel: quarantined the tree(s) of iteration %d "
            "(%s gradient plane); training continues", self.iter,
            mine[0][1])
        return True

    def quarantine_iter(self, iteration: int) -> bool:
        """Discard the trees of one (0-based) iteration a sentinel
        flagged, then REBUILD every score from the surviving trees.
        Rolling back by subtraction would re-read the poisoned leaf
        values (NaN - NaN = NaN); the rebuild never reads them."""
        k = self.num_tree_per_iteration
        idx = iteration - self.num_init_iteration
        if idx < 0 or (idx + 1) * k > len(self.models):
            return False
        self._pred_revision += 1
        self._materialize_models()
        self._drain_stop_check()
        del self.models[idx * k:(idx + 1) * k]
        self._on_quarantine(idx)
        self.iter -= 1
        # the persistent state carries the poisoned scores: it is
        # rebuilt from the fresh training score next iteration
        self._fused_state = None
        self._score_dirty = False
        self._rebuild_scores()
        obs.inc("health.quarantined", k)
        return True

    def _on_quarantine(self, idx: int) -> None:
        """Boosting-mode hook: drop per-iteration side state of the
        quarantined (relative) iteration ``idx``."""

    def _rebuild_scores(self) -> None:
        """Every training and validation score afresh from the
        surviving trees (the init scores re-applied by _ScoreState; the
        boost_from_average constant lives in the first trees' bias)."""
        self._materialize_models()
        k = self.num_tree_per_iteration
        self.train_score = _ScoreState(self.train_data, k, self.device)
        fresh = []
        for vs in self.valid_score:
            nvs = _ScoreState(vs.dataset, k, self.device)
            nvs.bins = vs.bins
            fresh.append(nvs)
        self.valid_score = fresh
        bins, miss, efb = self._score_tables()
        for i, tree in enumerate(self.models):
            self.train_score.add_tree(tree, i % k, bins, miss, efb)
            for vs in self.valid_score:
                vs.add_tree(tree, i % k, vs.bins, miss, efb)

    def _sentinel_resolve(self, extra=None):
        """Resolve the pending verdicts in the read of ``extra`` (float64
        tensors the caller reads anyway; see ``read_verdicts``). Returns
        the host values of ``extra``."""
        sent = self._sentinel
        pending = sent.take_pending() if sent is not None else []
        values, host = read_verdicts(pending, extra)
        if pending:
            sent.resolve(pending, values)
        return host

    def sentinel_drain(self) -> None:
        """Force-resolve the pending verdicts (end of training, before
        a quarantine decision); in steady state they ride the loop's
        reads instead."""
        if self._sentinel is not None and self._sentinel.has_pending:
            self._sentinel_resolve()

    def process_sentinel_trips(self) -> bool:
        """Quarantine every iteration a sentinel flagged since the last
        call. Returns True when the trips reached the escalation
        threshold (the engine then rolls back to the last checkpoint
        and steps down the degraded-mode ladder)."""
        sent = self._sentinel
        if sent is None:
            return False
        flagged: Dict[int, str] = {}
        for iteration, kind in sent.pop_trips():
            flagged.setdefault(iteration, kind)
        # highest iteration first: quarantining an iteration shifts
        # every LATER iteration's position in self.models
        for iteration in sorted(flagged, reverse=True):
            if self.quarantine_iter(iteration):
                log.warning(
                    "numeric sentinel: quarantined the tree(s) of "
                    "iteration %d (%s detected in leaf values); "
                    "training continues on the healthy forest",
                    iteration, flagged[iteration])
        sent.poll_quant_tripwire()
        return sent.trips >= sent.max_trips

    def _update_valid_scores_device(self, ta: Dict, vals: torch.Tensor,
                                    class_id: int = 0) -> None:
        """The fused learner's tree of class ``class_id``, still on the
        device, on the validation sets: ``traverse_bins`` of its device
        arrays (no read), plus the leaf values ``vals``."""
        for vs in self.valid_score:
            vs.score[class_id] += vals[self._fused.traverse_bins(ta,
                                                                 vs.bins)]

    def _train_one_iter_fused(self, init_scores, grad, hess) -> bool:
        """The per-tree fused path (the JAX package's
        _train_one_iter_fused), with no read: per class, ``grow_device``
        on the class's row-order gradients and the iteration's
        [bag | oob] permutation, its device tree appended as a
        ``PendingTree``, then score[c] += vals[leaf_of_row] with
        vals = leaf value x shrinkage + 0.0 in float32 (``PendingTree.
        leaf_values_device`` before the bias: a -0.0 leaf value adds
        +0.0, as in the JAX package), and the valid scores by
        ``traverse_bins`` of the device tree. The sentinels take the
        device leaf values, their verdicts deferred. An iteration of
        single leaves does not end training here: as in the JAX package,
        training stops only at the periodic check
        (``_periodic_stop_check``), and the trailing single-leaf
        iterations are trimmed at the end (``trim_degenerate_tail``).
        Under row sampling a later bag may split again, so a single-leaf
        iteration inside the run stays in the model."""
        k = self.num_tree_per_iteration
        fl = self._fused
        leaf_values = []
        for c in range(k):
            ta, leaf_of_row = fl.grow_device(grad[c], hess[c], self._perm,
                                             self.bag_data_cnt)
            pending = PendingTree(fl, ta)
            pending.apply_shrinkage(self.shrinkage_rate)
            vals = pending.leaf_values_device()
            self.train_score.score[c] += vals[leaf_of_row]
            self._update_valid_scores_device(ta, vals, c)
            if abs(init_scores[c]) > K_EPSILON:
                pending.add_bias(init_scores[c])
            self.models.append(pending)
            leaf_values.append(ta["leaf_value"])
        self._sentinel_check_trees(leaf_values, defer=True)
        self.iter += 1
        return (self.iter % self._stop_check_every == 0
                and self._periodic_stop_check(self.models[-k:]))

    def _periodic_stop_check(self, trees) -> bool:
        """The no-more-splits check of the fused paths, every
        ``_stop_check_every`` iterations (the JAX package's). Pipelined
        (default): the verdict of the PREVIOUS check decides, then this
        one starts; ``LGBM_TPU_PIPELINE=0``: this check starts and
        decides at once. A positive verdict (the checked iteration's
        trees all single leaves) trims the trailing single-leaf
        iterations and stops, unless none trail (later iterations split
        again) and the model holds more than one iteration. Returns
        True when training should stop."""
        if self._pipeline:
            stop = self._resolve_stop_check()
            self._begin_stop_check(trees)
        else:
            self._begin_stop_check(trees)
            stop = self._resolve_stop_check()
        if not stop:
            return False
        if self.trim_degenerate_tail() == 0 \
                and len(self.models) > self.num_tree_per_iteration:
            return False
        log.warning("Stopped training because there are no more leaves "
                    "that meet the split requirements")
        return True

    def _begin_stop_check(self, trees) -> None:
        """Start the stop check of ``trees``: the leaf counts of host
        trees (and of pending trees read before), and the device leaf
        counts of the pending ones, which the check's one read brings
        back together with the pending sentinel verdicts."""
        refs, counts = [], []
        for t in trees:
            if isinstance(t, PendingTree) and t._tree is None:
                if t._n_leaves_host is not None:
                    counts.append(int(t._n_leaves_host))
                else:
                    refs.append((t, t.device_arrays()["n_leaves"]))
            else:
                counts.append(int(t.num_leaves))
        tr = obs.active_tracer()
        self._stop_fetch = (refs, counts, self.iter,
                            tr.iteration if tr is not None else -1)

    def _resolve_stop_check(self) -> bool:
        """Verdict of the check started last: True when every tree it
        covered was a single leaf. False when none is in flight (the
        first check of a run, or after a resume). The pending sentinel
        verdicts resolve in the same read, charged to the iteration
        that started the check."""
        if self._stop_pending is not None:
            out, self._stop_pending = self._stop_pending, None
            return bool(out)
        if self._stop_fetch is None:
            return False
        refs, counts, disp_iter, disp_trace_iter = self._stop_fetch
        self._stop_fetch = None
        counts = list(counts)
        if refs or (self._sentinel is not None
                    and self._sentinel.has_pending):
            with obs.span("trailing stop-check (readback)",
                          phase="stop_check"), \
                    obs.sync_attribution(disp_trace_iter), \
                    watch_phase("readback:stop check"):
                host = self._sentinel_resolve(
                    [torch.cat([r for _, r in refs]).to(torch.float64)]
                    if refs else None)
            for (t, _), v in zip(refs, [] if host is None else host):
                t._n_leaves_host = int(v)
                counts.append(int(v))
        stop = bool(counts) and all(v <= 1 for v in counts)
        if stop and self.iter > disp_iter:
            # iterations trained past the detected single-leaf window
            # (trimmed again by trim_degenerate_tail)
            obs.inc("pipeline.delayed_stop_iters", self.iter - disp_iter)
        return stop

    def _drain_stop_check(self) -> None:
        """Resolve the stop check in flight and park a positive verdict
        for the next periodic check. Checkpoint capture and quarantine
        call this, so a checkpoint holds no check in flight and a
        positive verdict survives a resume."""
        if self._stop_fetch is not None:
            self._stop_pending = self._resolve_stop_check() or None

    def telemetry_stats(self) -> Dict[str, float]:
        """Per-iteration model and memory statistics for the obs layer
        (the JAX package's; called only under full telemetry): the
        iteration's leaf count and best split gain from the host trees,
        and as gauges the bin matrix's bytes, the histogram pool's
        bytes and ``mem.planar_state_bytes``, the bytes of the state the
        iteration updates (the planar state on the persistent fused
        path, else the training scores)."""
        k = self.num_tree_per_iteration
        counts, gain_arrays = self._batched_tree_stats(self.models[-k:],
                                                       with_gains=True)
        best_gain = 0.0
        for gains in gain_arrays:
            if gains.size:
                best_gain = max(best_gain, float(np.max(gains)))
        stats: Dict[str, float] = {
            "num_leaves": int(sum(counts)),
            "best_gain": round(best_gain, 6)}
        gauges = {}
        bins = getattr(self.train_data, "bins", None)
        if bins is not None and hasattr(bins, "nbytes"):
            gauges["hbm_bins_bytes"] = int(bins.nbytes)
        tl = self._fused if self._fused is not None else self.tree_learner
        if tl is not None:
            gauges["hbm_hist_pool_bytes"] = int(
                self.config.num_leaves * tl.num_features
                * tl.max_num_bin * 2 * 4)
        state = (self._fused_state if self._fused_state is not None
                 else self.train_score.score)
        gauges["mem.planar_state_bytes"] = int(state.numel()
                                               * state.element_size())
        for name, v in gauges.items():
            obs.set_gauge(name, v)
        return stats

    def trim_degenerate_tail(self) -> int:
        """Delete every trailing iteration whose trees are all single
        leaves, but the first (the JAX package's _trim_degenerate_tail;
        their single leaves added 0 to the scores). Returns the count
        deleted."""
        k = self.num_tree_per_iteration
        removed = 0
        while len(self.models) > k and all(
                v <= 1 for v in self._batched_tree_stats(
                    self.models[-k:])[0]):
            del self.models[-k:]
            self.iter -= 1
            removed += 1
        return removed

    def _batched_tree_stats(self, trees, with_gains: bool = False):
        """(leaf counts, split gain arrays) of ``trees`` with at most ONE
        read across all of them (the JAX package's): the pending trees'
        device values ride one read; a leaf count read is kept on its
        PendingTree."""
        want = []
        for t in trees:
            if isinstance(t, PendingTree) and t._tree is None and (
                    with_gains or t._n_leaves_host is None):
                want.append(t)
        host = {}
        if want:
            parts = [torch.cat([t.device_arrays()["n_leaves"].to(
                torch.float64)] + ([t.device_arrays()["t_f"][0].to(
                    torch.float64)] if with_gains else [])) for t in want]
            with obs.span("batched tree stats (device fetch)",
                          phase="stop_check"):
                # tpulint: sync-ok(one batched read: telemetry, or training's end trim)
                vals = want[0].grower._read(torch.cat(parts))
            at = 0
            for t, p in zip(want, parts):
                v = vals[at:at + p.numel()]
                at += p.numel()
                t._n_leaves_host = int(v[0])
                host[id(t)] = np.asarray(v[1:], np.float64)
        counts, gains = [], []
        for t in trees:
            if isinstance(t, PendingTree) and t._tree is None:
                counts.append(int(t._n_leaves_host))
                if with_gains:
                    gains.append(host[id(t)][:max(counts[-1] - 1, 0)])
            else:
                counts.append(int(t.num_leaves))
                if with_gains:
                    gains.append(np.asarray(
                        t.split_gain[:max(t.num_leaves - 1, 0)]))
        return counts, gains

    def _materialize_models(self) -> None:
        """Swap the pending trees of ``models`` for host Trees: ONE read
        for every pending tree not read yet (the JAX package's)."""
        self._flush_persistent_queue()
        pend = [t for t in self.models
                if isinstance(t, PendingTree) and t._tree is None]
        unread = [t for t in pend if t._ta is None and (
            t.batch is None or t.batch._host is None)]
        if unread:
            batch = TreeArrayBatch(unread[0].grower,
                                   [t.device_arrays() for t in unread])
            for t, ta in zip(unread, batch.host()):
                t.tree_arrays = ta
        for i, t in enumerate(self.models):
            if isinstance(t, PendingTree):
                self.models[i] = t.materialize()

    def _flush_persistent_queue(self) -> None:
        """Run the queued persistent iterations: a full batch as
        ``train_iters_persistent`` (its trees one TreeArrayBatch), a
        partial one iteration by iteration (the JAX package's
        _flush_persistent_queue). The sentinel checks that waited for
        the queue are dispatched after."""
        q = self._pq_trees
        if not q:
            return
        fl = self._fused
        if len(q) == self._iter_batch:
            batch = fl.train_iters_persistent(
                self._fused_state, self.shrinkage_rate, self._pq_masks)
            for i, t in enumerate(q):
                t.batch, t.index = batch, i
        else:
            for t, mask in zip(q, self._pq_masks):
                t._dev = fl.train_iter(self._fused_state,
                                       self.shrinkage_rate, mask=mask)
        for t in q:
            # run: the tree no longer refers back to this booster
            t.resolver = None
        self._pq_trees, self._pq_masks = [], []
        deferred, self._sentinel_deferred = self._sentinel_deferred, []
        for it, t in deferred:
            self._sentinel_check_trees(
                [t.device_arrays()["leaf_value"]], iteration=it,
                defer=True)

    def _train_one_iter_persistent(self, init_score: float) -> bool:
        """One iteration of the persistent fused path: gradients, tree
        growth and the score update on the learner's state, with no
        read. The tree is appended as a PendingTree (the JAX package's
        _train_one_iter_persistent); with ``LGBM_TPU_ITER_BATCH`` K > 1
        and no valid set the iteration is queued, and every K-th runs
        the queue. Valid scores take the tree by ``traverse_bins`` on
        the device."""
        if self._fused_state is None:
            # built AFTER _boost_from_average, so the state's score
            # already carries the init constant
            self._fused_state = self._fused.init_persistent_state(
                self.get_training_score()[0])
        if self._iter_batch > 1 and not self.valid_score:
            pending = PendingTree(self._fused,
                                  resolver=self._flush_persistent_queue)
            self._pq_trees.append(pending)
            self._pq_masks.append(self._fused.feature_masks_for_tree())
            if self._sentinel is not None:
                self._sentinel_deferred.append((self.iter, pending))
            if len(self._pq_trees) >= self._iter_batch:
                self._flush_persistent_queue()
        else:
            ta = self._fused.train_iter(self._fused_state,
                                        self.shrinkage_rate)
            pending = PendingTree(self._fused, ta)
            if self.valid_score:
                self._update_valid_scores_device(
                    ta, ta["leaf_value"] * torch.tensor(
                        self.shrinkage_rate, dtype=torch.float32))
            self._sentinel_check_trees([ta["leaf_value"]], defer=True)
        self._score_dirty = True
        # a single-leaf tree does not end training here: as in the JAX
        # package, training stops only at the periodic check, and the
        # trailing single-leaf iterations are trimmed (their leaf value
        # is 0; the first tree keeps the init score as its bias)
        pending.apply_shrinkage(self.shrinkage_rate)
        if abs(init_score) > K_EPSILON:
            pending.add_bias(init_score)
        self.models.append(pending)
        self.iter += 1
        return (self.iter % self._stop_check_every == 0
                and self._periodic_stop_check(self.models[-1:]))

    def get_training_score(self) -> torch.Tensor:
        """[K, N] raw training scores in row order, on the device."""
        if self._score_dirty and self._fused_state is not None:
            self._flush_persistent_queue()
            self.train_score.score = \
                self._fused.sync_scores(self._fused_state)[None, :]
            self._score_dirty = False
        return self.train_score.score

    def train_one_iter(self, gradients=None, hessians=None) -> bool:
        """One boosting iteration (reference GBDT::TrainOneIter,
        gbdt.cpp:337), with the objective's gradients or, from a custom
        objective, ``gradients`` / ``hessians`` [K, N] (or K * N) in row
        order. Returns True when training should stop."""
        k = self.num_tree_per_iteration
        custom = gradients is not None and hessians is not None
        init_scores = [0.0] * k
        self._grad = self._hess = None
        if custom:
            # tpulint: sync-ok(custom objective: the caller hands host gradients)
            self._grad, self._hess = (torch.as_tensor(
                np.asarray(a, np.float32).reshape(k, self.num_data),
                device=self.device) for a in (gradients, hessians))
        else:
            init_scores = [self._boost_from_average(c) for c in range(k)]
            if not self._fused_persist:
                with obs.span("gbdt/boosting (gradients)", phase="boost"):
                    self._grad, self._hess = self._boosting()
                    self._apply_grad_poison()
        self._sentinel_check_grads()
        # after the gradients, as the JAX package (GOSS reweights them)
        self._bagging(self.iter)
        grad, hess = self._grad, self._hess
        self._grad = self._hess = None
        if self._fused is None:
            return self._train_one_iter_host_loop(init_scores, grad, hess)
        if self._fused_persist and not custom:
            return self._train_one_iter_persistent(init_scores[0])
        if self._fused_state is not None:
            # custom gradients come in row order: leave the persistent
            # state (its scores synced back) for the per-tree path
            self.get_training_score()
            self._fused_state = None
        return self._train_one_iter_fused(init_scores, grad, hess)

    # ------------------------------------------------------------------
    # checkpoint and resume (robust/checkpoint.py)
    # ------------------------------------------------------------------
    def checkpoint_state(self) -> Dict:
        """The loop state beyond the model text that an interrupted run
        needs to continue bit-identically, under the JAX package's keys:
        every host RNG stream, the bag permutation, and the float32
        scores (restored as they are: recomputing them from the trees
        would change the accumulation order). The persistent fused
        path saves its state's rowid and score planes instead of
        row-order scores, since its lane order is numeric state. The
        stop check in flight is drained first, and a positive verdict
        saved as ``stop_pending``. Pending trees are materialized first
        (the model text is saved beside this state)."""
        self._materialize_models()
        self._drain_stop_check()
        k = self.num_tree_per_iteration
        st: Dict = {
            "iter": int(self.iter),
            "num_init_iteration": int(self.num_init_iteration),
            "shrinkage_rate": float(self.shrinkage_rate),
            # the JAX package's keys; every class trains, and its
            # best_iter stays 0
            "class_need_train": [True] * k,
            "bag_data_cnt": int(self.bag_data_cnt),
            "bag_rng": _pack_rng(self._bag_rng),
            "best_iter": 0,
        }
        if self._perm is not self._full_perm:
            st["perm"] = self._perm.to(torch.int32).cpu().numpy()
        tl = self.tree_learner
        if getattr(tl, "_col_rng", None) is not None:
            st["tl_col_rng"] = _pack_rng(tl._col_rng)
        if getattr(tl, "_extra_rng", None) is not None:
            st["tl_extra_rng"] = _pack_rng(tl._extra_rng)
        if self._fused is not None:
            st["fused_col_rng"] = _pack_rng(self._fused._col_rng)
            st["quant_iter"] = int(self._fused._quant_iter)
        if self._fused_state is not None:
            rowid, score_bits = self._fused.persistent_lane_state(
                self._fused_state)
            st["fused_lane_rowid"] = rowid
            st["fused_lane_score"] = score_bits
        else:
            st["train_score"] = self.get_training_score().cpu().numpy()
        st["valid_scores"] = [vs.score.cpu().numpy()
                              for vs in self.valid_score]
        if self._stop_pending:
            st["stop_pending"] = True
        return st

    def restore_checkpoint_state(self, state: Dict, model_text: str) -> None:
        """Inverse of checkpoint_state on a booster built on the same
        dataset and config (freshly, or live: a watchdog auto-resume or
        a sentinel rollback restores mid-run)."""
        self._pred_revision += 1
        # no check crosses a checkpoint in flight; a drained positive
        # verdict resumes through "stop_pending"
        self._stop_fetch = None
        self._stop_pending = True if state.get("stop_pending") else None
        if self._sentinel is not None:
            self._sentinel.drop_pending()
        # queued iterations belong to the timeline being replaced
        self._pq_trees, self._pq_masks = [], []
        self._sentinel_deferred = []
        self.models = parse_tree_blocks(model_text)
        # the text drops the bin-space fields that score surgery (DART,
        # rollback, quarantine) traverses with: re-link every tree
        for t in self.models:
            t.relink_to_dataset(self.train_data)
        self.iter = int(state["iter"])
        self.num_init_iteration = int(state.get("num_init_iteration", 0))
        self.shrinkage_rate = float(
            state.get("shrinkage_rate", self.shrinkage_rate))
        self.bag_data_cnt = int(state.get("bag_data_cnt", self.num_data))
        if "bag_rng" in state:
            _unpack_rng(self._bag_rng, state["bag_rng"])
        self._perm = self._full_perm
        if "perm" in state:
            self._perm = torch.as_tensor(np.asarray(state["perm"]),
                                         dtype=torch.int64,
                                         device=self.device)
        tl = self.tree_learner
        for key, attr in (("tl_col_rng", "_col_rng"),
                          ("tl_extra_rng", "_extra_rng")):
            if key in state and getattr(tl, attr, None) is not None:
                _unpack_rng(getattr(tl, attr), state[key])
        if self._fused is not None:
            if "fused_col_rng" in state:
                _unpack_rng(self._fused._col_rng, state["fused_col_rng"])
            self._fused._quant_iter = int(state.get("quant_iter", 0))
        if "fused_lane_rowid" in state:
            if not self._fused_persist:
                log.fatal(
                    "Checkpoint holds fused persistent-path state but the "
                    "current configuration selected a different tree grower; "
                    "refusing to resume (delete the checkpoint directory or "
                    "restore the original parameters)")
            self._fused_state = self._fused.restore_persistent_state(
                state["fused_lane_rowid"], state["fused_lane_score"])
            self._score_dirty = True
        elif "train_score" in state:
            self.train_score.score = torch.as_tensor(
                np.asarray(state["train_score"], np.float32),
                device=self.device)
            self._fused_state = None
            self._score_dirty = False
        vs_arrays = state.get("valid_scores", [])
        if len(vs_arrays) != len(self.valid_score):
            log.warning(
                "Checkpoint has %d valid-set score arrays but the resumed "
                "train() call wired %d valid sets; resumed eval metrics may "
                "not match the uninterrupted run",
                len(vs_arrays), len(self.valid_score))
        for vs, arr in zip(self.valid_score, vs_arrays):
            vs.score = torch.as_tensor(np.asarray(arr, np.float32),
                                       device=self.device)

    # ------------------------------------------------------------------
    def eval_at_iter(self) -> List[Tuple[str, str, float, bool]]:
        """All metric values: (dataset_name, metric_name, value,
        bigger_is_better). The synchronous form of the begin / finish
        pair below: the two back to back."""
        return self.finish_eval_at_iter(self.begin_eval_at_iter())

    def begin_eval_at_iter(self):
        """Start this iteration's evaluation: every metric is reduced on
        the device (the multiclass metrics' per-row inputs too, which
        ``Metric.finish`` completes on the host), the values joined into
        one float64 tensor, and its copy to the host started without
        waiting (utils/device.py ``start_read``). Returns the handle
        that ``finish_eval_at_iter`` resolves, one iteration later in
        the pipelined loop. The host fallbacks run here, eagerly: the
        degraded ladder's host copy of the scores, and the divide of an
        averaged output."""
        rows, vals, srcs = [], [], []

        def eval_set(ds_name, metrics, score):
            for m in metrics:
                sc = score if m.all_classes else score[0]
                for name, val in m.eval_device(sc, self.objective):
                    # entries that share a tensor (a ranking metric's
                    # k values) read it once
                    if not srcs or val is not srcs[-1]:
                        srcs.append(val)
                        vals.append(val.reshape(-1).to(torch.float64))
                    rows.append((ds_name, name, m, len(vals) - 1))

        div = None
        if self.average_output and self.current_iteration > 0:
            # averaged output: the scores over the iteration count, a
            # true float32 division as the JAX package's host divide
            div = torch.full((), float(self.current_iteration),
                             dtype=torch.float32, device=self.device)

        def averaged(score):
            return score if div is None else score / div.to(score.device)

        def on_eval_device(score):
            # the degraded ladder's device_eval rung: a host copy
            if self._device_eval:
                return score
            obs.inc("eval.host_transfer_rows", int(score.shape[-1]))
            # tpulint: sync-ok(degraded ladder rung only: the host copy it asks for)
            return torch.from_numpy(_device.device_get(score))

        if self.metrics:
            eval_set("training", self.metrics,
                     averaged(on_eval_device(self.get_training_score())))
        for i, ms in enumerate(self.valid_metrics):
            eval_set(f"valid_{i}", ms,
                     averaged(on_eval_device(self.valid_score[i].score)))
        flat = read = None
        if vals:
            flat = torch.cat([v.to(vals[0].device) for v in vals])
            read = _device.start_read(flat)
            obs.inc("pipeline.inflight_fetches")
        tr = obs.active_tracer()
        return (rows, [v.numel() for v in vals], flat, read,
                tr.iteration if tr is not None else -1)

    def finish_eval_at_iter(self, handle) -> List[Tuple[str, str, float,
                                                        bool]]:
        """Resolve a ``begin_eval_at_iter`` handle: wait for its copy
        (one counted read, charged to the iteration that began it) and
        finish each metric. The pending sentinel verdicts ride the same
        read: then the values are read together with them instead of
        from the copy."""
        rows, sizes, flat, read, disp_iter = handle
        with obs.sync_attribution(disp_iter), \
                watch_phase("readback:eval scalars"):
            if self._sentinel is not None and self._sentinel.has_pending:
                host = self._sentinel_resolve(
                    [flat] if flat is not None else None)
            elif read is not None:
                # tpulint: sync-ok(trailing-fetch: waits for the previous iteration's start_read)
                host = _device.device_get(read)
        if not rows:
            return []
        obs.inc("eval.device_scalars", len(rows))
        at = np.cumsum([0] + sizes)
        return [(d, n, m.finish(host[at[i]:at[i + 1]], n),
                 m.bigger_is_better) for d, n, m, i in rows]

    @property
    def current_iteration(self) -> int:
        return len(self.models) // max(self.num_tree_per_iteration, 1)

    # ------------------------------------------------------------------
    # prediction
    # ------------------------------------------------------------------
    def _used_models(self, start_iteration: int, num_iteration: int):
        self._materialize_models()
        k = self.num_tree_per_iteration
        total = len(self.models) // k
        start = max(0, min(start_iteration, total))
        end = min(start + num_iteration, total) if num_iteration > 0 \
            else total
        return self.models[start * k:end * k]

    # rows per prediction pass: bounds the [64, rows] traversal state
    PREDICT_CHUNK = 131072

    def _forest(self, kind: str, start_iteration: int, num_iteration: int):
        """The cached forest of the used models: ``"packed"`` (the
        walker, models/forest.py) or ``"path"`` (models/pathforest.py;
        None when the model is out of its scope)."""
        from ..models.forest import PackedForest
        from ..models.pathforest import PathForest, build_path_tables
        models = self._used_models(start_iteration, num_iteration)
        key = (kind, start_iteration, num_iteration, len(self.models),
               self._pred_revision)
        cache = getattr(self, "_forest_cache", {})
        if key not in cache:
            k = self.num_tree_per_iteration
            if kind == "packed":
                cache[key] = PackedForest(models, k, self.device)
            else:
                tabs = build_path_tables(models)
                cache[key] = (None if tabs is None
                              else PathForest(models, k, self.device, tabs))
            self._forest_cache = cache
        return cache[key]

    def _raw_scores(self, x: np.ndarray, start_iteration: int,
                    num_iteration: int) -> torch.Tensor:
        """[k, N] float32 raw scores on the device, dispatched as the JAX
        package's _raw_scores_device: prediction early stop takes the
        walker's early-stopped sums; else the path forest where it
        covers the model, else the walker. An averaged-output model (RF)
        divides by its iteration count on the device."""
        k = self.num_tree_per_iteration
        xt = torch.as_tensor(np.asarray(x, np.float32), device=self.device)
        models = self._used_models(start_iteration, num_iteration)
        if not models:
            return torch.zeros((k, xt.shape[0]), dtype=torch.float32,
                               device=self.device)
        cfg = self.config
        early = cfg is not None and cfg.pred_early_stop
        path = (None if early
                else self._forest("path", start_iteration, num_iteration))
        parts = []
        for i in range(0, max(xt.shape[0], 1), self.PREDICT_CHUNK):
            xc = xt[i:i + self.PREDICT_CHUNK]
            if early:
                parts.append(self._forest(
                    "packed", start_iteration, num_iteration
                ).raw_scores_early_stop(xc, max(1, cfg.pred_early_stop_freq),
                                        float(cfg.pred_early_stop_margin)))
            elif path is not None:
                parts.append(path.raw_scores(xc))
            else:
                parts.append(self._forest(
                    "packed", start_iteration, num_iteration).raw_scores(xc))
        score = torch.cat(parts, dim=1)
        if self.average_output:
            # a true division by a device scalar (a host scalar divisor
            # is a reciprocal product on the card)
            score = score / torch.tensor(float(len(models) // k),
                                         dtype=torch.float32,
                                         device=self.device)
        return score

    def predict(self, x: np.ndarray, start_iteration: int = 0,
                num_iteration: int = -1, raw_score: bool = False
                ) -> np.ndarray:
        """Scores [N] (or [N, k]) as float64, computed on the device."""
        k = self.num_tree_per_iteration
        score = self._raw_scores(x, start_iteration, num_iteration)
        if not raw_score and self.objective is not None:
            # over [N, K], as the JAX package: softmax takes the last axis
            score = self.objective.convert_output(score.t()).t()
        out = score.to(torch.float64).cpu().numpy()
        return out[0] if k == 1 else out.T

    def predict_contrib(self, x: np.ndarray, start_iteration: int = 0,
                        num_iteration: int = -1) -> np.ndarray:
        """SHAP values (reference Tree::PredictContrib, the TreeSHAP
        recursion of tree.cpp; ``models/shap.py``), per tree on the host
        in float64: [N, F + 1], the last column the expected value; with
        K trees per iteration each class's F + 1 columns side by side."""
        from ..models.shap import tree_shap
        xx = np.asarray(x, dtype=np.float64)
        k = self.num_tree_per_iteration
        out = np.zeros((k, xx.shape[0], self.max_feature_idx + 2))
        for i, tree in enumerate(self._used_models(start_iteration,
                                                   num_iteration)):
            out[i % k] += tree_shap(tree, xx)
        if k == 1:
            return out[0]
        return np.concatenate([out[c] for c in range(k)], axis=1)

    def predict_leaf_index(self, x: np.ndarray, start_iteration: int = 0,
                           num_iteration: int = -1) -> np.ndarray:
        """[N, T] int32 leaf index of every row in every used tree
        (reference PredictLeafIndex), through the walker."""
        n = np.asarray(x).shape[0]
        if not self._used_models(start_iteration, num_iteration):
            return np.empty((n, 0), dtype=np.int32)
        forest = self._forest("packed", start_iteration, num_iteration)
        xt = torch.as_tensor(np.asarray(x, np.float32), device=self.device)
        return np.concatenate(
            [forest.leaf_indices(xt[i:i + self.PREDICT_CHUNK]).cpu().numpy()
             for i in range(0, max(n, 1), self.PREDICT_CHUNK)], axis=0)

    # ------------------------------------------------------------------
    # model IO (reference gbdt_model_text.cpp)
    # ------------------------------------------------------------------
    def _feature_infos(self) -> List[str]:
        ds = self.train_data
        infos = ["none"] * (self.max_feature_idx + 1)
        if ds is None:
            return getattr(self, "_loaded_feature_infos", infos)
        for i, f in enumerate(ds.real_feature_index):
            m = ds.bin_mappers[i]
            if m.bin_type == BIN_CATEGORICAL:
                infos[f] = ":".join(str(c) for c in m.bin_2_categorical)
            else:
                infos[f] = f"[{m.min_val}:{m.max_val}]"
        return infos

    def feature_importance(self, importance_type: int = 0,
                           num_iteration: int = -1) -> np.ndarray:
        """0 = split count, 1 = total gain (reference
        GBDT::FeatureImportance, gbdt.cpp:756)."""
        out = np.zeros(self.max_feature_idx + 1)
        for tree in self._used_models(0, num_iteration):
            for i in range(tree.num_leaves - 1):
                f = int(tree.split_feature[i])
                if importance_type == 0:
                    if tree.split_gain[i] > 0:
                        out[f] += 1.0
                else:
                    out[f] += max(float(tree.split_gain[i]), 0.0)
        return out

    def save_model_to_string(self, start_iteration: int = 0,
                             num_iteration: int = -1,
                             importance_type: int = 0) -> str:
        num_class = (self.config.num_class if self.config
                     else self.num_tree_per_iteration)
        lines = ["tree", f"version={K_MODEL_VERSION}",
                 f"num_class={num_class}",
                 f"num_tree_per_iteration={self.num_tree_per_iteration}",
                 f"label_index={self.label_idx}",
                 f"max_feature_idx={self.max_feature_idx}"]
        if self.objective is not None:
            lines.append(f"objective={self.objective.to_string()}")
        elif getattr(self, "_loaded_objective", ""):
            lines.append(f"objective={self._loaded_objective}")
        if self.average_output:
            lines.append("average_output")
        lines.append("feature_names=" + " ".join(self.feature_names_))
        lines.append("feature_infos=" + " ".join(self._feature_infos()))
        models = self._used_models(start_iteration, num_iteration)
        tree_strs = [f"Tree={i}\n" + t.to_string()
                     for i, t in enumerate(models)]
        lines.append("tree_sizes=" + " ".join(str(len(s) + 1)
                                              for s in tree_strs))
        lines.append("")
        body = "\n".join(tree_strs)
        tail = ["end of trees", ""]
        imp = self.feature_importance(importance_type, num_iteration)
        pairs = [(int(v), self.feature_names_[i])
                 for i, v in enumerate(imp) if v > 0]
        pairs.sort(key=lambda p: -p[0])
        tail.append("feature_importances:")
        tail.extend(f"{nm}={v}" for v, nm in pairs)
        tail.append("")
        tail.append("parameters:")
        tail.append(self.config.to_params_string() if self.config
                    else self.loaded_parameter)
        tail.append("end of parameters")
        return "\n".join(lines) + "\n" + body + "\n" + "\n".join(tail) + "\n"

    def save_model_to_file(self, filename: str, start_iteration: int = 0,
                           num_iteration: int = -1,
                           importance_type: int = 0) -> None:
        with open(filename, "w") as fh:
            fh.write(self.save_model_to_string(start_iteration, num_iteration,
                                               importance_type))

    def load_model_from_string(self, text: str) -> None:
        """reference GBDT::LoadModelFromString (gbdt_model_text.cpp:410)."""
        head, _, _ = text.partition("\ntree_sizes=")
        kv: Dict[str, str] = {}
        for line in head.splitlines():
            if "=" in line:
                key, val = line.split("=", 1)
                kv[key.strip()] = val
            elif line.strip() == "average_output":
                self.average_output = True
        self.num_tree_per_iteration = int(kv.get("num_tree_per_iteration",
                                                 "1"))
        self._loaded_num_class = int(kv.get("num_class", "1"))
        self.label_idx = int(kv.get("label_index", "0"))
        self.max_feature_idx = int(kv.get("max_feature_idx", "0"))
        self.feature_names_ = kv.get("feature_names", "").split()
        self._loaded_feature_infos = kv.get("feature_infos", "").split()
        self._loaded_objective = kv.get("objective", "")
        self.objective = None
        if self._loaded_objective:
            name = self._loaded_objective.split()[0]
            params: Dict[str, object] = {"objective": name, "verbosity": -1,
                                         "device_type": self.device.type}
            for tok in self._loaded_objective.split()[1:]:
                if ":" in tok:
                    pk, pv = tok.split(":", 1)
                    params[pk] = pv
                elif tok == "sqrt":
                    params["reg_sqrt"] = True
            if name in ("multiclass", "multiclassova"):
                params["num_class"] = self._loaded_num_class
            # the objective's output transform for predict() (ranking
            # objectives load too: their scores are raw)
            self.objective = create_objective(Config.from_params(params))
        self.models = parse_tree_blocks(text)
        self.iter = len(self.models) // max(self.num_tree_per_iteration, 1)
        self.num_init_iteration = self.iter
        pstart = text.find("\nparameters:")
        if pstart >= 0:
            self.loaded_parameter = text[pstart + len("\nparameters:"):]\
                .split("end of parameters")[0].strip()


class DART(GBDT):
    """Dropout boosting (reference dart.hpp:23), as the JAX package's
    DART: before each iteration the dropped trees leave the training
    score; after it they are normalized, their leaf values scaled on
    the host in float64 and each step added to the scores in float32.
    Only this run's iterations drop: their indices are offset by
    ``num_init_iteration`` past the trees of an ``init_model``."""

    def init(self, config, train_data, objective, metrics):
        super().init(config, train_data, objective, metrics)
        self._drop_rng = np.random.RandomState(config.drop_seed)
        self.tree_weight: List[float] = []
        self.sum_weight = 0.0
        self.drop_index: List[int] = []
        self.shrinkage_rate = config.learning_rate

    def checkpoint_state(self) -> Dict:
        st = super().checkpoint_state()
        st["dart"] = {"drop_rng": _pack_rng(self._drop_rng),
                      "tree_weight": [float(w) for w in self.tree_weight],
                      "sum_weight": float(self.sum_weight)}
        return st

    def restore_checkpoint_state(self, state: Dict, model_text: str) -> None:
        super().restore_checkpoint_state(state, model_text)
        d = state.get("dart")
        if d:
            _unpack_rng(self._drop_rng, d["drop_rng"])
            self.tree_weight = [float(w) for w in d["tree_weight"]]
            self.sum_weight = float(d["sum_weight"])
            self.drop_index = []

    def _on_quarantine(self, idx: int) -> None:
        # keep the dropout weights aligned with the surviving forest
        if idx < len(self.tree_weight):
            self.sum_weight -= self.tree_weight[idx]
            del self.tree_weight[idx]

    def train_one_iter(self, gradients=None, hessians=None) -> bool:
        if gradients is None or hessians is None:
            self._dropping_trees()
        res = super().train_one_iter(gradients, hessians)
        if not res:
            self._normalize()
            if not self.config.uniform_drop:
                self.tree_weight.append(self.shrinkage_rate)
                self.sum_weight += self.shrinkage_rate
        return res

    def _dropping_trees(self) -> None:
        """Draw the dropped iterations (the drop RNG consumed in loop
        order, up to ``max_drop``), subtract their trees from the
        training score and set this iteration's shrinkage. The pending
        trees are materialized first, where the JAX package does (after
        ``_normalize``'s read, none is left: no read here)."""
        cfg = self.config
        self.drop_index = []
        if self._drop_rng.rand() >= cfg.skip_drop:
            drop_rate = cfg.drop_rate
            if not cfg.uniform_drop:
                if self.tree_weight:
                    inv_avg = len(self.tree_weight) / self.sum_weight
                    if cfg.max_drop > 0:
                        drop_rate = min(drop_rate, cfg.max_drop * inv_avg
                                        / self.sum_weight)
                    for i in range(self.iter):
                        if self._drop_rng.rand() < (drop_rate
                                                    * self.tree_weight[i]
                                                    * inv_avg):
                            self.drop_index.append(
                                self.num_init_iteration + i)
                            if len(self.drop_index) >= cfg.max_drop:
                                break
            else:
                if cfg.max_drop > 0 and self.iter > 0:
                    drop_rate = min(drop_rate, cfg.max_drop / float(self.iter))
                for i in range(self.iter):
                    if self._drop_rng.rand() < drop_rate:
                        self.drop_index.append(self.num_init_iteration + i)
                        if len(self.drop_index) >= cfg.max_drop:
                            break
        k = self.num_tree_per_iteration
        bins, miss, efb = self._score_tables()
        self._materialize_models()
        for i in self.drop_index:
            for c in range(k):
                t = self.models[i * k + c]
                t.apply_shrinkage(-1.0)
                self.train_score.add_tree(t, c, bins, miss, efb)
        lr = cfg.learning_rate
        if not cfg.xgboost_dart_mode:
            self.shrinkage_rate = lr / (1.0 + len(self.drop_index))
        elif not self.drop_index:
            self.shrinkage_rate = lr
        else:
            self.shrinkage_rate = lr / (lr + len(self.drop_index))

    def _normalize(self) -> None:
        """Scale each dropped tree back in: 1/(k+1) of it joins the
        valid scores, then -k times that the training score (the
        xgboost form: the shrinkage, then -k/learning_rate), each factor
        applied to the float64 leaf values in turn; then the tree
        weights. The iteration's pending trees are materialized first,
        as the JAX package does: DART's one read per iteration."""
        cfg = self.config
        k_drop = float(len(self.drop_index))
        k = self.num_tree_per_iteration
        bins, miss, efb = self._score_tables()
        self._materialize_models()
        for i in self.drop_index:
            for c in range(k):
                t = self.models[i * k + c]
                if not cfg.xgboost_dart_mode:
                    t.apply_shrinkage(1.0 / (k_drop + 1.0))
                    for vs in self.valid_score:
                        vs.add_tree(t, c, vs.bins, miss, efb)
                    t.apply_shrinkage(-k_drop)
                else:
                    t.apply_shrinkage(self.shrinkage_rate)
                    for vs in self.valid_score:
                        vs.add_tree(t, c, vs.bins, miss, efb)
                    t.apply_shrinkage(-k_drop / cfg.learning_rate)
                self.train_score.add_tree(t, c, bins, miss, efb)
            if not cfg.uniform_drop:
                # the weights of this run's iterations only
                j = i - self.num_init_iteration
                if not cfg.xgboost_dart_mode:
                    self.sum_weight -= self.tree_weight[j] / (k_drop + 1.0)
                    self.tree_weight[j] *= k_drop / (k_drop + 1.0)
                else:
                    den = k_drop + cfg.learning_rate
                    self.sum_weight -= self.tree_weight[j] / den
                    self.tree_weight[j] *= k_drop / den


def goss_sample(grad: torch.Tensor, hess: torch.Tensor, seed: int,
                top_k: int, other_k: int):
    """One GOSS round on the device (reference goss.hpp:111-147, the JAX
    package's _goss_sample_device): the top_k rows by sum_c |g·h|,
    other_k drawn uniformly from the rest (the largest of
    ``jax.random.uniform``'s draws under PRNGKey(seed), the top rows
    masked to -1) with their gradients and hessians scaled by
    (n - top_k) / other_k in float32, and the stable [bag | oob]
    permutation by destination ranks. Both selections are stable
    descending sorts: ``jax.lax.top_k`` on the CPU takes equal values
    in index order, and ``torch.topk`` promises no order among ties.
    Nothing is read back to the host. grad / hess: [K, n] float32.
    Returns (grad, hess, perm int64)."""
    n = grad.shape[1]
    dev = grad.device
    # index_fill_ / index_copy_ / scatter_ with device indices and
    # Python scalars: no host read and no host-to-device copy
    weight = S.xla_sum(torch.abs(grad * hess).t())              # [n]
    top_rows = torch.sort(weight, descending=True, stable=True)[1][:top_k]
    is_top = torch.zeros(n, dtype=torch.bool, device=dev).index_fill_(
        0, top_rows, True)
    r = threefry.uniform(threefry.PRNGKey(seed), (n,), device=dev)
    keys = torch.where(is_top, -1.0, r)
    sampled = torch.sort(keys, descending=True, stable=True)[1][:other_k]
    # a float32 factor: exact as the Python float the kernels take
    mult = float(np.float32((n - top_k) / other_k))
    grad = grad.index_copy(1, sampled, grad.index_select(1, sampled) * mult)
    hess = hess.index_copy(1, sampled, hess.index_select(1, sampled) * mult)
    in_bag = is_top.index_fill(0, sampled, True)
    bag_rank = torch.cumsum(in_bag.to(torch.int64), 0) - 1
    oob_rank = top_k + other_k + torch.cumsum((~in_bag).to(torch.int64), 0) - 1
    dest = torch.where(in_bag, bag_rank, oob_rank)
    perm = torch.empty(n, dtype=torch.int64, device=dev).scatter_(
        0, dest, torch.arange(n, dtype=torch.int64, device=dev))
    return grad, hess, perm


class GOSS(GBDT):
    """Gradient-based One-Side Sampling (reference goss.hpp:25)."""

    def init(self, config, train_data, objective, metrics):
        super().init(config, train_data, objective, metrics)
        if config.bagging_freq > 0 and config.bagging_fraction != 1.0:
            log.fatal("Cannot use bagging in GOSS")
        if not (config.top_rate > 0 and config.other_rate > 0
                and config.top_rate + config.other_rate <= 1.0):
            log.fatal("Invalid top_rate/other_rate for GOSS")
        log.info("Using GOSS")

    def _bagging(self, iteration: int) -> None:
        """No sampling while iteration < 1 / learning_rate; then one
        device-side GOSS round, seeded from the bagging RNG."""
        cfg = self.config
        n = self.num_data
        if iteration < int(1.0 / cfg.learning_rate):
            self._perm = self._full_perm
            self.bag_data_cnt = n
            return
        top_k = max(1, int(n * cfg.top_rate))
        other_k = max(1, min(int(n * cfg.other_rate), n - top_k))
        seed = int(self._bag_rng.randint(1 << 31))
        self._grad, self._hess, self._perm = goss_sample(
            self._grad, self._hess, seed, top_k, other_k)
        self.bag_data_cnt = top_k + other_k


class RF(GBDT):
    """Random forest (reference rf.hpp:25): every tree from the
    gradients of the constant initial score, no shrinkage, and the
    trees' outputs averaged."""

    def init(self, config, train_data, objective, metrics):
        super().init(config, train_data, objective, metrics)
        self.average_output = True
        self.shrinkage_rate = 1.0
        self._rf_base_score = None
        if not (config.bagging_freq > 0 and config.bagging_fraction < 1.0):
            log.fatal("Random forest needs bagging_freq > 0 and "
                      "bagging_fraction < 1")

    def _boosting(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Gradients from the constant boost_from_score base, not from
        the accumulated score."""
        k = self.num_tree_per_iteration
        if self._rf_base_score is None:
            init = np.zeros((k, self.num_data), dtype=np.float32)
            for c in range(k):
                init[c] = self.objective.boost_from_score(c)
            self._rf_base_score = torch.as_tensor(init, device=self.device)
        if k == 1:
            g, h = self.objective.get_gradients(self._rf_base_score[0])
            return g[None, :], h[None, :]
        return self.objective.get_gradients(self._rf_base_score)

    def _boost_from_average(self, class_id: int) -> float:
        return 0.0


def create_boosting(boosting_type: str, device=None) -> GBDT:
    """reference Boosting::CreateBoosting (boosting.cpp:35)."""
    kinds = {"gbdt": GBDT, "dart": DART, "goss": GOSS, "rf": RF}
    if boosting_type not in kinds:
        log.fatal("Unknown boosting type %s", boosting_type)
    return kinds[boosting_type](device)
