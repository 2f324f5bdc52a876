"""GBDT boosting loop.

The port of the JAX package's boosting/gbdt.py for plain gradient
boosting: init, boost-from-average (reference gbdt.cpp:312), the
one-tree-per-iteration loop (GBDT::TrainOneIter, gbdt.cpp:337) on the
fused learner's persistent state or, for every config the fused learner
turns away, on the host-loop SerialTreeGrower, metric evaluation,
prediction, and the model text (gbdt_model_text.cpp:306
SaveModelToString / :410 LoadModelFromString).

Each iteration hands the learner's tree to the host right away, so
``models`` holds plain host Trees. Objectives that grow K trees per
iteration (multiclass) or whose gradients come from outside the fused
learner's program (custom objectives, ``cross_entropy_lambda``) take the
per-tree fused path: one fresh planar state per class tree
(``FusedSerialGrower.grow_device``) and the score update through each
row's leaf. Quantized-gradient training (``use_quantized_grad``) runs on
both learners.

Row sampling re-permutes the rows per iteration: bagging (numpy
``RandomState``, the JAX package's draws) and GOSS (its device-side
sampling, ``ops/threefry.py``) hand the learner a ``[bag | oob]``
permutation; the fused learner then grows each tree on a bag-ordered
state and scores every row by traversal (``grow_device``). ``DART``
drops trees from the training score before each iteration and
normalizes them after; ``RF`` grows every tree from the constant
initial score and averages the trees' outputs. Rollback, refit,
``init_model`` and the RNGs' checkpoint state are not ported yet
(ROADMAP).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import Config
from ..io.binning import BIN_CATEGORICAL
from ..io.dataset import BinnedDataset
from ..metric.metrics import Metric
from ..models.tree import Tree
from ..objective.functions import ObjectiveFunction, create_objective
from ..ops import split as S
from ..ops import threefry
from ..treelearner.fused import (FusedSerialGrower, fused_reject_reason,
                                 port_reject_reason)
from ..treelearner.serial import SerialTreeGrower
from ..utils import log
from ..utils.device import resolve_device

K_EPSILON = 1e-15
K_MODEL_VERSION = "v3"


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
        port = port_reject_reason(config, train_data, objective)
        if port is not None:
            raise NotImplementedError(f"not ported yet: {port}")
        self._fused = None
        self._fused_state = None     # persistent planar state (device)
        self._score_dirty = False    # train_score stale vs _fused_state
        self._stop_pending = False   # the last periodic stop verdict
        reason = fused_reject_reason(config, train_data, objective)
        if reason is None:
            self._fused = FusedSerialGrower(train_data, config, objective,
                                            self.device)
        else:
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
        CreateTreeLearner): the serial grower on one device."""
        if config.tree_learner not in ("serial", "feature", "data",
                                       "voting"):
            log.fatal("Unknown tree learner type %s", config.tree_learner)
        if config.tree_learner != "serial":
            if config.num_machines > 1 or config.tpu_mesh_shape:
                raise NotImplementedError(
                    f"not ported yet: tree_learner={config.tree_learner} "
                    "across devices (ROADMAP A13)")
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
        self._perm = torch.as_tensor(np.concatenate([bag, oob]),
                                     dtype=torch.int64, device=self.device)
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
        tl = self.tree_learner
        leaf_idx = tree.leaf_index_binned(tl.bins, tl.feature_miss_bin,
                                          tl._efb_dev).cpu().numpy()
        score = self.train_score.score[class_id].cpu().numpy()
        residual = np.asarray(self.train_data.metadata.label) - score
        if self.bag_data_cnt < self.num_data:
            # the bag's rows only (the JAX package's
            # _renew_tree_output_impl)
            bag = self._perm[:self.bag_data_cnt].cpu().numpy()
            leaf_idx, residual = leaf_idx[bag], residual[bag]
        out = obj.renew_tree_output(leaf_idx, residual, tree.num_leaves)
        if out is not None:
            tree.leaf_value[:tree.num_leaves] = out

    def _no_more_splits(self, k: int) -> bool:
        """The stop of an iteration whose K trees are all single leaves
        (reference gbdt.cpp:389-407): its trees go unless they are the
        model's first. Returns True (training stops)."""
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
        should_continue = False
        for c in range(k):
            if self.train_data.num_features > 0:
                tree = self.tree_learner.grow(grad[c], hess[c], self._perm,
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
        self.iter += 1
        return False

    def _update_valid_scores(self, tree: Tree, vals: torch.Tensor,
                             class_id: int) -> None:
        """The fused learner's tree on the validation sets: each row's
        leaf by bin-space traversal, plus the leaf values ``vals``."""
        fl = self._fused
        for vs in self.valid_score:
            leaf = tree.leaf_index_binned(vs.bins, fl.feature_miss_bin,
                                          fl._efb_dev)
            vs.score[class_id] += vals[leaf]

    def _train_one_iter_fused(self, init_scores, grad, hess) -> bool:
        """The per-tree fused path (the JAX package's
        _train_one_iter_fused): per class, ``grow_device`` on the class's
        row-order gradients and the iteration's [bag | oob] permutation,
        then score[c] += vals[leaf_of_row] with
        vals = leaf value x shrinkage in float32 (``PendingTree.
        leaf_values_device``), and the valid scores by bin-space
        traversal. An iteration of single leaves does not end training
        here: as in the JAX package, training stops only at the periodic
        check (``_periodic_stop_check``), and the trailing single-leaf
        iterations are trimmed at the end (``trim_degenerate_tail``).
        Under row sampling a later bag may split again, so a single-leaf
        iteration inside the run stays in the model."""
        k = self.num_tree_per_iteration
        fl = self._fused
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        shrink = torch.tensor(self.shrinkage_rate, dtype=torch.float32)
        for c in range(k):
            ta, leaf_of_row = fl.grow_device(grad[c], hess[c], self._perm,
                                             self.bag_data_cnt)
            tree = fl.materialize_tree(ta)
            # + 0.0, as the JAX package adds its pending bias (a -0.0
            # leaf value adds +0.0)
            vals = torch.as_tensor(np.asarray(ta["leaf_value"], np.float32),
                                   device=self.device) * shrink + zero
            self.train_score.score[c] += vals[leaf_of_row]
            self._update_valid_scores(tree, vals, c)
            tree.apply_shrinkage(self.shrinkage_rate)
            if abs(init_scores[c]) > K_EPSILON:
                tree.add_bias(init_scores[c])
            self.models.append(tree)
        self.iter += 1
        return (self.iter % self.STOP_CHECK_EVERY == 0
                and self._periodic_stop_check(self.models[-k:]))

    # the per-tree fused path's stop-check period (the JAX package's)
    STOP_CHECK_EVERY = 50

    def _periodic_stop_check(self, trees) -> bool:
        """The JAX package's pipelined stop check of the per-tree fused
        path: the verdict of the PREVIOUS check (were its iteration's
        trees all single leaves?) decides; a positive one trims the
        trailing single-leaf iterations and stops, unless none trail
        (later iterations split again) and the model holds more than
        one iteration. Returns True when training should stop."""
        stop = self._stop_pending
        self._stop_pending = all(t.num_leaves <= 1 for t in trees)
        if not stop:
            return False
        if self.trim_degenerate_tail() == 0 \
                and len(self.models) > self.num_tree_per_iteration:
            return False
        log.warning("Stopped training because there are no more leaves "
                    "that meet the split requirements")
        return True

    def trim_degenerate_tail(self) -> int:
        """Delete every trailing iteration whose trees are all single
        leaves, but the first (the JAX package's _trim_degenerate_tail;
        their single leaves added 0 to the scores). Returns the count
        deleted."""
        k = self.num_tree_per_iteration
        removed = 0
        while len(self.models) > k and all(
                t.num_leaves <= 1 for t in self.models[-k:]):
            del self.models[-k:]
            self.iter -= 1
            removed += 1
        return removed

    def _train_one_iter_persistent(self, init_score: float) -> bool:
        """One iteration of the persistent fused path: gradients, tree
        growth and the score update on the learner's state."""
        if self._fused_state is None:
            # built AFTER _boost_from_average, so the state's score
            # already carries the init constant
            self._fused_state = self._fused.init_persistent_state(
                self.get_training_score()[0])
        ta = self._fused.train_iter(self._fused_state, self.shrinkage_rate)
        self._score_dirty = True
        tree = self._fused.materialize_tree(ta)
        if tree.num_leaves <= 1:
            # constant-tree path (reference gbdt.cpp:389-407): the first
            # tree keeps the init score; later ones end training
            if not self.models:
                tree.set_leaf_value(0, init_score)
                self.models.append(tree)
            log.warning("Stopped training because there are no more leaves "
                        "that meet the split requirements")
            return True
        if self.valid_score:
            vals = torch.as_tensor(
                np.asarray(ta["leaf_value"], np.float32),
                device=self.device) * torch.tensor(self.shrinkage_rate,
                                                   dtype=torch.float32)
            self._update_valid_scores(tree, vals, 0)
        tree.apply_shrinkage(self.shrinkage_rate)
        if abs(init_score) > K_EPSILON:
            tree.add_bias(init_score)
        self.models.append(tree)
        self.iter += 1
        return False

    def get_training_score(self) -> torch.Tensor:
        """[K, N] raw training scores in row order, on the device."""
        if self._score_dirty and self._fused_state is not None:
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
            self._grad, self._hess = (torch.as_tensor(
                np.asarray(a, np.float32).reshape(k, self.num_data),
                device=self.device) for a in (gradients, hessians))
        else:
            init_scores = [self._boost_from_average(c) for c in range(k)]
            if not self._fused_persist:
                self._grad, self._hess = self._boosting()
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
    def eval_at_iter(self) -> List[Tuple[str, str, float, bool]]:
        """All metric values: (dataset_name, metric_name, value,
        bigger_is_better), computed on the device and brought to the
        host in ONE read (the multiclass metrics' per-row inputs too,
        which ``Metric.finish`` completes there)."""
        rows, vals = [], []

        def eval_set(ds_name, metrics, score):
            for m in metrics:
                sc = score if m.all_classes else score[0]
                for name, val in m.eval_device(sc, self.objective):
                    rows.append((ds_name, name, m))
                    vals.append(val.reshape(-1).to(torch.float64))

        div = None
        if self.average_output and self.current_iteration > 0:
            # averaged output: the scores over the iteration count, a
            # true float32 division as the JAX package's host divide
            div = torch.tensor(float(self.current_iteration),
                               dtype=torch.float32, device=self.device)

        def averaged(score):
            return score if div is None else score / div

        if self.metrics:
            eval_set("training", self.metrics,
                     averaged(self.get_training_score()))
        for i, ms in enumerate(self.valid_metrics):
            eval_set(f"valid_{i}", ms, averaged(self.valid_score[i].score))
        if not vals:
            return []
        host = torch.cat(vals).cpu().numpy()
        out, at = [], 0
        for (d, n, m), v in zip(rows, vals):
            out.append((d, n, m.finish(host[at:at + v.numel()]),
                        m.bigger_is_better))
            at += v.numel()
        return out

    @property
    def current_iteration(self) -> int:
        return len(self.models) // max(self.num_tree_per_iteration, 1)

    # ------------------------------------------------------------------
    # prediction
    # ------------------------------------------------------------------
    def _used_models(self, start_iteration: int, num_iteration: int):
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
        key = (kind, start_iteration, num_iteration, len(self.models))
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
            # an objective the port does not train raises (ROADMAP A9):
            # predict() would otherwise return untransformed raw scores
            self.objective = create_objective(Config.from_params(params))
        self.models = parse_tree_blocks(text)
        self.iter = len(self.models) // max(self.num_tree_per_iteration, 1)
        pstart = text.find("\nparameters:")
        if pstart >= 0:
            self.loaded_parameter = text[pstart + len("\nparameters:"):]\
                .split("end of parameters")[0].strip()


class DART(GBDT):
    """Dropout boosting (reference dart.hpp:23), as the JAX package's
    DART: before each iteration the dropped trees leave the training
    score; after it they are normalized, their leaf values scaled on
    the host in float64 and each step added to the scores in float32."""

    def init(self, config, train_data, objective, metrics):
        super().init(config, train_data, objective, metrics)
        self._drop_rng = np.random.RandomState(config.drop_seed)
        self.tree_weight: List[float] = []
        self.sum_weight = 0.0
        self.drop_index: List[int] = []
        self.shrinkage_rate = config.learning_rate

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
        training score and set this iteration's shrinkage."""
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
                            self.drop_index.append(i)
                            if len(self.drop_index) >= cfg.max_drop:
                                break
            else:
                if cfg.max_drop > 0 and self.iter > 0:
                    drop_rate = min(drop_rate, cfg.max_drop / float(self.iter))
                for i in range(self.iter):
                    if self._drop_rng.rand() < drop_rate:
                        self.drop_index.append(i)
                        if len(self.drop_index) >= cfg.max_drop:
                            break
        k = self.num_tree_per_iteration
        bins, miss, efb = self._score_tables()
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
        weights."""
        cfg = self.config
        k_drop = float(len(self.drop_index))
        k = self.num_tree_per_iteration
        bins, miss, efb = self._score_tables()
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
                if not cfg.xgboost_dart_mode:
                    self.sum_weight -= self.tree_weight[i] / (k_drop + 1.0)
                    self.tree_weight[i] *= k_drop / (k_drop + 1.0)
                else:
                    den = k_drop + cfg.learning_rate
                    self.sum_weight -= self.tree_weight[i] / den
                    self.tree_weight[i] *= k_drop / den


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
