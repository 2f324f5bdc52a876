"""User-facing Dataset and Booster, main-path subset.

The port of the JAX package's basic.py (itself API-compatible with the
reference python-package basic.py: Dataset at :909 with lazy
construction, Booster at :1930). Dataset wraps BinnedDataset and
Booster wraps the GBDT boosting loop. The device comes from the params'
``device_type`` ("cuda" by default, or "cpu").
"""
from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from .boosting.gbdt import GBDT, create_boosting
from .config import Config
from .io.dataset import BinnedDataset, _is_sparse
from .metric.metrics import create_metric
from .objective.functions import create_objective
from .utils.device import resolve_device
from .utils.log import LightGBMError


def _to_2d_numpy(data):
    """Dense input as a 2-D numpy array; scipy sparse input unchanged
    (the dataset consumes it column-wise without densifying)."""
    if _is_sparse(data):
        return data
    arr = np.asarray(data)
    if arr.ndim == 1:
        arr = arr.reshape(-1, 1)
    if arr.dtype == object:
        arr = arr.astype(np.float64)
    return arr


class Dataset:
    """Training data container (reference basic.py:909): a dense numpy
    matrix or a scipy CSR/CSC matrix."""

    def __init__(self, data, label=None,
                 reference: Optional["Dataset"] = None, weight=None,
                 init_score=None,
                 feature_name: Union[str, List[str]] = "auto",
                 categorical_feature: Union[str, List] = "auto",
                 params: Optional[Dict[str, Any]] = None,
                 free_raw_data: bool = True) -> None:
        self.data = data
        self.label = label
        self.reference = reference
        self.weight = weight
        self.init_score = init_score
        self.feature_name = feature_name
        self.categorical_feature = categorical_feature
        self.params = copy.deepcopy(params) if params else {}
        self.free_raw_data = free_raw_data
        self._handle: Optional[BinnedDataset] = None

    def construct(self) -> "Dataset":
        """Lazy construction (reference basic.py:1274)."""
        if self._handle is not None:
            return self
        ref = self.reference.construct() if self.reference is not None \
            else None
        mat = _to_2d_numpy(self.data)
        cfg = Config.from_params(self.params)
        names = (list(self.feature_name)
                 if isinstance(self.feature_name, list)
                 else [f"Column_{i}" for i in range(mat.shape[1])])
        cat = None
        if self.categorical_feature not in ("auto", None):
            cat = [names.index(c) if isinstance(c, str) else int(c)
                   for c in self.categorical_feature]
        label = None if self.label is None \
            else np.asarray(self.label, np.float64).reshape(-1)
        weight = None if self.weight is None \
            else np.asarray(self.weight).reshape(-1)
        init_score = None if self.init_score is None \
            else np.asarray(self.init_score)
        self._handle = BinnedDataset.from_matrix(
            mat, cfg, label=label, weight=weight, init_score=init_score,
            feature_names=names, categorical_feature=cat,
            reference=None if ref is None else ref._handle)
        if self.free_raw_data:
            self.data = None
        return self

    @property
    def handle(self) -> Optional[BinnedDataset]:
        return self._handle

    def get_label(self):
        """The label (float32 once constructed), as a custom objective
        reads it."""
        if self._handle is not None \
                and self._handle.metadata.label is not None:
            return np.asarray(self._handle.metadata.label)
        return self.label

    def get_weight(self):
        if self._handle is not None \
                and self._handle.metadata.weights is not None:
            return np.asarray(self._handle.metadata.weights)
        return self.weight


class Booster:
    """Gradient-boosting model handle (reference basic.py:1930)."""

    def __init__(self, params: Optional[Dict[str, Any]] = None,
                 train_set: Optional[Dataset] = None,
                 model_file: Optional[str] = None,
                 model_str: Optional[str] = None) -> None:
        self.params = copy.deepcopy(params) if params else {}
        self.best_iteration = -1
        self.best_score: Dict[str, Dict[str, float]] = {}
        self._train_set: Optional[Dataset] = None
        self.name_valid_sets: List[str] = []
        self.config = Config.from_params(self.params)
        self.device = resolve_device(self.config)
        self._gbdt = (create_boosting(self.config.boosting, self.device)
                      if train_set is not None else GBDT(self.device))
        if train_set is not None:
            if not isinstance(train_set, Dataset):
                raise TypeError("Training data should be Dataset instance, "
                                f"met {type(train_set).__name__}")
            if train_set._handle is None:
                # dataset-level params given at train() time shape the
                # construction (max_bin, enable_bundle, ...)
                train_set.params = {**(train_set.params or {}),
                                    **self.params}
            train_set.construct()
            self._train_set = train_set
            metrics = [m for m in (create_metric(nm, self.config)
                                   for nm in self.config.metric)
                       if m is not None]
            self._gbdt.init(self.config, train_set._handle,
                            create_objective(self.config), metrics)
        elif model_file is not None or model_str is not None:
            if model_file is not None:
                with open(model_file) as fh:
                    model_str = fh.read()
            self._gbdt.load_model_from_string(model_str)
        else:
            raise TypeError("Need at least one training dataset or model "
                            "file or model string to create booster "
                            "instance")

    def add_valid(self, data: Dataset, name: str) -> "Booster":
        if not isinstance(data, Dataset):
            raise TypeError("Validation data should be Dataset instance, "
                            f"met {type(data).__name__}")
        data.construct()
        metrics = [m for m in (create_metric(nm, self.config)
                               for nm in self.config.metric) if m is not None]
        self._gbdt.add_valid_data(data._handle, metrics)
        self.name_valid_sets.append(name)
        return self

    def update(self, train_set: Optional[Dataset] = None,
               fobj=None) -> bool:
        """One boosting iteration; returns True if training stopped
        (reference basic.py:2315). ``fobj(preds, train_set)`` returns the
        gradients and hessians of a custom objective: [N], or [N, K]
        (or K * N class-major) for K classes."""
        if train_set is not None and train_set is not self._train_set:
            raise LightGBMError("Replacing train_set is not supported yet")
        if fobj is None:
            return self._gbdt.train_one_iter()
        grad, hess = fobj(self._curr_pred_for_fobj(), self._train_set)
        return self.__boost(grad, hess)

    def _curr_pred_for_fobj(self) -> np.ndarray:
        """Raw training scores for a custom objective: [N] float64, or
        [N, K] with K classes."""
        score = self._gbdt.get_training_score().to(torch.float64)
        score = score.cpu().numpy()
        k = self._gbdt.num_tree_per_iteration
        return score[0] if k == 1 else score.T

    def __boost(self, grad, hess) -> bool:
        grad = np.asarray(grad, dtype=np.float32)
        hess = np.asarray(hess, dtype=np.float32)
        k = self._gbdt.num_tree_per_iteration
        n = self._gbdt.num_data
        if grad.ndim == 2:      # [N, K] sklearn layout -> [K, N]
            grad, hess = grad.T, hess.T
        if grad.size != n * k or hess.size != n * k:
            raise ValueError(
                f"Length of gradient ({grad.size}) doesn't match "
                f"num_data*num_class ({n * k})")
        return self._gbdt.train_one_iter(grad.reshape(k, n),
                                         hess.reshape(k, n))

    def eval_all(self, feval=None) -> list:
        """[(dataset_name, metric_name, value, bigger_is_better)] with
        validation sets under the names given to add_valid; then, per
        dataset, each ``feval(preds, dataset)``'s (name, value,
        is_higher_better) results, with preds the transformed scores
        ([N], or [N, K]) and dataset the training Dataset (None for a
        validation set), as the JAX package calls it."""
        res = self._gbdt.eval_at_iter()
        keys = ["training"] + [f"valid_{i}"
                               for i in range(len(self.name_valid_sets))]
        out = []
        for key in keys:
            ds = key if key == "training" else \
                self.name_valid_sets[int(key.split("_")[1])]
            out += [(ds, name, val, bib)
                    for d, name, val, bib in res if d == key]
            for f in ([] if feval is None
                      else feval if isinstance(feval, list) else [feval]):
                ret = f(self._eval_preds(key), self._train_set
                        if key == "training" else None)
                for name, val, bib in (ret if isinstance(ret, list)
                                       else [ret]):
                    out.append((ds, name, val, bib))
        return out

    def _eval_preds(self, key: str) -> np.ndarray:
        """The scores of one dataset for ``feval``, as the JAX package
        hands them: the objective's float32 transform, or the float64
        raw scores without an objective."""
        gb = self._gbdt
        score = (gb.get_training_score() if key == "training"
                 else gb.valid_score[int(key.split("_")[1])].score).t()
        if gb.objective is not None:
            score = gb.objective.convert_output(score.to(torch.float32))
        else:
            score = score.to(torch.float64)
        out = score.cpu().numpy()
        return out[:, 0] if gb.num_tree_per_iteration == 1 else out

    def predict(self, data, start_iteration: int = 0,
                num_iteration: Optional[int] = -1,
                raw_score: bool = False, pred_leaf: bool = False,
                pred_contrib: bool = False) -> np.ndarray:
        """Scores, raw scores, or with ``pred_leaf`` the [N, T] leaf
        index of every row in every tree."""
        if pred_contrib:
            raise NotImplementedError(
                "pred_contrib is not ported yet (ROADMAP A12: "
                "models/shap.py)")
        if num_iteration is None:
            num_iteration = -1
        mat = _to_2d_numpy(data)

        def run(m):
            if pred_leaf:
                return self._gbdt.predict_leaf_index(m, start_iteration,
                                                     num_iteration)
            return self._gbdt.predict(m, start_iteration, num_iteration,
                                      raw_score=raw_score)
        if _is_sparse(mat):
            # prediction walks raw feature values: densify sparse input
            # in bounded row chunks
            csr = mat.tocsr()
            chunk = 1 << 16
            parts = [run(np.asarray(csr[i:i + chunk].todense(),
                                    dtype=np.float64))
                     for i in range(0, max(csr.shape[0], 1), chunk)]
            return np.concatenate(parts, axis=0)
        return run(mat)

    def model_to_string(self, num_iteration: Optional[int] = None,
                        start_iteration: int = 0,
                        importance_type: str = "split") -> str:
        it = self.best_iteration if num_iteration is None else num_iteration
        return self._gbdt.save_model_to_string(
            start_iteration, it if it and it > 0 else -1,
            0 if importance_type == "split" else 1)


__all__ = ["Booster", "Dataset", "LightGBMError"]
