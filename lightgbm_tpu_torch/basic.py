"""User-facing Dataset and Booster, main-path subset.

The port of the JAX package's basic.py (itself API-compatible with the
reference python-package basic.py: Dataset at :909 with lazy
construction, Booster at :1930). Dataset wraps BinnedDataset and
Booster wraps the GBDT boosting loop. The device comes from the params'
``device_type`` ("cuda" by default, or "cpu").
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from . import network
from .boosting.gbdt import GBDT, create_boosting
from .config import Config
from .io.dataset import BinnedDataset, Metadata, _is_sparse
from .metric.metrics import create_metric
from .objective.functions import create_objective
from .utils.device import resolve_device
from .utils.log import LightGBMError


def _to_2d_numpy(data):
    """Dense input as a 2-D numpy array (a pandas DataFrame through
    ``_pandas_to_numpy``); scipy sparse input unchanged (the dataset
    consumes it column-wise without densifying)."""
    if hasattr(data, "values") and hasattr(data, "dtypes"):   # DataFrame
        return _pandas_to_numpy(data)
    if _is_sparse(data):
        return data
    arr = np.asarray(data)
    if arr.ndim == 1:
        arr = arr.reshape(-1, 1)
    if arr.dtype == object:
        arr = arr.astype(np.float64)
    return arr


def _pandas_to_numpy(df) -> np.ndarray:
    """A DataFrame as float64: categorical columns as their codes (NaN
    for missing), the rest through ``pd.to_numeric``. pandas is imported
    here only, so the package runs without it."""
    import pandas as pd
    out = np.empty(df.shape, dtype=np.float64)
    for i, col in enumerate(df.columns):
        s = df[col]
        if isinstance(s.dtype, pd.CategoricalDtype):
            out[:, i] = s.cat.codes.astype(np.float64)
            out[out[:, i] < 0, i] = np.nan
        else:
            out[:, i] = pd.to_numeric(s, errors="coerce").astype(np.float64)
    return out


def _label_from_pandas(label):
    if hasattr(label, "values"):
        return np.asarray(label.values, dtype=np.float64).reshape(-1)
    return (None if label is None
            else np.asarray(label, dtype=np.float64).reshape(-1))


class Dataset:
    """Training data container (reference basic.py:909): a dense numpy
    matrix, a pandas DataFrame, a scipy CSR/CSC matrix, or the path of a
    CSV / TSV / LibSVM text file or of a ``save_binary`` file."""

    def __init__(self, data, label=None,
                 reference: Optional["Dataset"] = None, weight=None,
                 group=None, init_score=None, silent=False,
                 feature_name: Union[str, List[str]] = "auto",
                 categorical_feature: Union[str, List] = "auto",
                 params: Optional[Dict[str, Any]] = None,
                 free_raw_data: bool = True) -> None:
        self.data = data
        self.label = label
        self.reference = reference
        self.weight = weight
        self.group = group
        self.init_score = init_score
        self.feature_name = feature_name
        self.categorical_feature = categorical_feature
        self.params = copy.deepcopy(params) if params else {}
        self.free_raw_data = free_raw_data
        self._handle: Optional[BinnedDataset] = None
        self.used_indices: Optional[np.ndarray] = None
        self._subset_parent: Optional["Dataset"] = None

    def construct(self) -> "Dataset":
        """Lazy construction (reference basic.py:1274)."""
        if self._handle is not None:
            return self
        if self._subset_parent is not None:
            return self._construct_subset()
        ref = self.reference.construct() if self.reference is not None \
            else None
        if isinstance(self.data, str):
            self._construct_from_file(self.data, ref)
            return self
        mat = _to_2d_numpy(self.data)
        cfg = Config.from_params(self.params)
        names = self._resolve_feature_names(mat.shape[1])
        label = _label_from_pandas(self.label)
        weight = None if self.weight is None \
            else np.asarray(self.weight).reshape(-1)
        group = None if self.group is None \
            else np.asarray(self.group).reshape(-1)
        init_score = None if self.init_score is None \
            else np.asarray(self.init_score)
        self._handle = BinnedDataset.from_matrix(
            mat, cfg, label=label, weight=weight, group=group,
            init_score=init_score, feature_names=names,
            categorical_feature=self._resolve_categorical(names),
            reference=None if ref is None else ref._handle)
        if self.free_raw_data:
            self.data = None
        return self

    def _construct_from_file(self, path: str, ref) -> None:
        """A ``.bin`` file from ``save_binary``, else a text file
        (io/text_loader.py: the label / weight / group columns and the
        ``.query`` / ``.weight`` / ``.init`` sidecar files)."""
        if path.endswith(".bin"):
            self._handle = BinnedDataset.load_binary(path)
            return
        from .io.text_loader import load_text_file
        cfg = Config.from_params(self.params)
        if ref is not None and cfg.initscore_filename:
            # initscore_filename names the TRAINING init file; validation
            # sets keep the <data>.init sidecar (reference metadata.cpp
            # LoadInitialScore)
            cfg = dataclasses.replace(cfg, initscore_filename="")
        mat, label, weight, group, init_score = load_text_file(path, cfg)
        names = [f"Column_{i}" for i in range(mat.shape[1])]
        self._handle = BinnedDataset.from_matrix(
            mat, cfg, label=label, weight=weight, group=group,
            init_score=init_score, feature_names=names,
            categorical_feature=self._resolve_categorical(names),
            reference=None if ref is None else ref._handle)

    def _resolve_feature_names(self, ncol: int) -> List[str]:
        if isinstance(self.feature_name, list):
            return list(self.feature_name)
        if self.feature_name == "auto" and hasattr(self.data, "columns"):
            return [str(c) for c in self.data.columns]
        return [f"Column_{i}" for i in range(ncol)]

    def _resolve_categorical(self, feature_names: List[str]):
        cat = self.categorical_feature
        if cat == "auto" or cat is None:
            if hasattr(self.data, "dtypes"):
                import pandas as pd
                return [i for i, _ in enumerate(self.data.columns)
                        if isinstance(self.data.dtypes.iloc[i],
                                      pd.CategoricalDtype)]
            return None
        out = []
        for c in cat:
            if isinstance(c, str):
                if c in feature_names:
                    out.append(feature_names.index(c))
            else:
                out.append(int(c))
        return out

    @property
    def handle(self) -> Optional[BinnedDataset]:
        return self._handle

    def num_data(self) -> int:
        self.construct()
        return self._handle.num_data

    def num_feature(self) -> int:
        self.construct()
        return self._handle.num_total_features

    def get_feature_name(self) -> List[str]:
        self.construct()
        return list(self._handle.feature_names)

    def get_label(self):
        """The label (float32 once constructed), as a custom objective
        reads it."""
        if self._handle is not None \
                and self._handle.metadata.label is not None:
            return np.asarray(self._handle.metadata.label)
        return _label_from_pandas(self.label)

    def get_weight(self):
        if self._handle is not None \
                and self._handle.metadata.weights is not None:
            return np.asarray(self._handle.metadata.weights)
        return self.weight

    def get_group(self):
        if self._handle is not None \
                and self._handle.metadata.query_boundaries is not None:
            return np.diff(self._handle.metadata.query_boundaries)
        return self.group

    def get_init_score(self):
        return self.init_score

    def set_label(self, label) -> "Dataset":
        self.label = label
        if self._handle is not None:
            self._handle.metadata.set_label(_label_from_pandas(label))
        return self

    def set_weight(self, weight) -> "Dataset":
        self.weight = weight
        if self._handle is not None:
            self._handle.metadata.set_weights(
                None if weight is None else np.asarray(weight).reshape(-1))
        return self

    def set_group(self, group) -> "Dataset":
        self.group = group
        if self._handle is not None:
            self._handle.metadata.set_query(
                None if group is None else np.asarray(group).reshape(-1))
        return self

    def set_init_score(self, init_score) -> "Dataset":
        self.init_score = init_score
        if self._handle is not None:
            self._handle.metadata.set_init_score(
                None if init_score is None else np.asarray(init_score))
        return self

    def set_field(self, field_name: str, data) -> "Dataset":
        return {"label": self.set_label, "weight": self.set_weight,
                "group": self.set_group,
                "init_score": self.set_init_score}[field_name](data)

    def get_field(self, field_name: str):
        return {"label": self.get_label, "weight": self.get_weight,
                "group": self.get_group,
                "init_score": self.get_init_score}[field_name]()

    def create_valid(self, data, label=None, weight=None, group=None,
                     init_score=None, silent=False,
                     params=None) -> "Dataset":
        return Dataset(data, label=label, reference=self, weight=weight,
                       group=group, init_score=init_score, silent=silent,
                       params=params or self.params,
                       free_raw_data=self.free_raw_data)

    def subset(self, used_indices: Sequence[int], params=None) -> "Dataset":
        """A row subset sharing this dataset's bin mappers (reference
        Dataset.subset / LGBM_DatasetGetSubset); constructed from the
        parent's bin codes."""
        if self.data is None and self._handle is None:
            raise LightGBMError("Cannot subset a freed dataset")
        ds = Dataset(self.data, label=self.label, reference=self,
                     weight=self.weight, group=self.group,
                     init_score=self.init_score,
                     feature_name=self.feature_name,
                     categorical_feature=self.categorical_feature,
                     params=params or self.params, free_raw_data=False)
        ds.used_indices = np.asarray(sorted(used_indices), dtype=np.int64)
        ds._subset_parent = self
        return ds

    def _construct_subset(self) -> "Dataset":
        """The subset's BinnedDataset from the parent's bin codes, label,
        weights and init-score columns (one per class), and its own
        ``group``."""
        parent = self._subset_parent.construct()._handle
        idx = self.used_indices
        h = BinnedDataset()
        h.num_data = len(idx)
        h.num_total_features = parent.num_total_features
        h.bins = parent.bins[idx]
        h.bin_mappers = parent.bin_mappers
        h.real_feature_index = parent.real_feature_index
        h.inner_feature_index = parent.inner_feature_index
        h.feature_names = parent.feature_names
        h.max_bin = parent.max_bin
        h.bundles = parent.bundles
        h._monotone_constraints = parent._monotone_constraints
        pm = parent.metadata
        h.metadata = Metadata(len(idx))
        if pm.label is not None:
            h.metadata.label = pm.label[idx]
        if pm.weights is not None:
            h.metadata.weights = pm.weights[idx]
        if self.group is not None:
            h.metadata.set_query(np.asarray(self.group))
        if pm.init_score is not None:
            isc = pm.init_score.reshape(-1, parent.num_data)
            h.metadata.init_score = isc[:, idx].reshape(-1)
        h._measure_occupancy()
        self._handle = h
        return self

    def save_binary(self, filename: str) -> "Dataset":
        self.construct()
        self._handle.save_binary(filename)
        return self

    def add_features_from(self, other: "Dataset") -> "Dataset":
        """The columns of ``other`` (same rows) appended to this
        dataset's (reference Dataset::AddFeaturesFrom, dataset.cpp:1465);
        the merged codes are per feature, unbundled."""
        self.construct()
        other.construct()
        a, b = self._handle, other._handle
        if a.num_data != b.num_data:
            raise LightGBMError(
                "Cannot add features from a different-size dataset")
        abins, bbins = a.feature_bins(), b.feature_bins()
        a.bundles = None
        if abins.dtype == bbins.dtype:
            a.bins = np.concatenate([abins, bbins], axis=1)
        else:
            a.bins = np.concatenate([abins.astype(np.uint16),
                                     bbins.astype(np.uint16)], axis=1)
        a.bin_mappers = list(a.bin_mappers) + list(b.bin_mappers)
        offset = a.num_total_features
        a.real_feature_index = list(a.real_feature_index) + \
            [offset + f for f in b.real_feature_index]
        a.num_total_features += b.num_total_features
        a.inner_feature_index = {f: i for i, f in
                                 enumerate(a.real_feature_index)}
        a.feature_names = list(a.feature_names) + list(b.feature_names)
        a._measure_occupancy()
        return self


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

    # -- pickling: the model text is the state (reference basic.py
    # Booster.__getstate__); the device side is rebuilt on load
    def __getstate__(self):
        return {"model_str": self.model_to_string(num_iteration=-1),
                "params": self.params,
                "best_iteration": self.best_iteration,
                "best_score": self.best_score}

    def __setstate__(self, state):
        self.__init__(params=state.get("params", {}),
                      model_str=state["model_str"])
        self.best_iteration = state.get("best_iteration", -1)
        self.best_score = state.get("best_score", {})

    def set_network(self, machines, local_listen_port: int = 12400,
                    listen_time_out: int = 120,
                    num_machines: int = 1) -> "Booster":
        """Multi-process wiring (reference basic.py:2093 set_network ->
        LGBM_NetworkInit, c_api.cpp:2262): the default
        ``torch.distributed`` group, with the rank found from the machine
        list (network.py ``ensure_distributed``); ``machines`` is a
        "host:port,..." string or a list of such entries."""
        if isinstance(machines, (list, set, tuple)):
            machines = ",".join(str(m) for m in machines)
        network.ensure_distributed(machines, num_machines,
                                   time_out=listen_time_out,
                                   device_type=self.config.device_type)
        return self

    def free_network(self) -> "Booster":
        """A no-op kept for the reference's API (basic.py
        free_network): the process group belongs to the process, and
        other boosters may use it."""
        return self

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

    def rollback_one_iter(self) -> "Booster":
        self._gbdt.rollback_one_iter()
        return self

    @property
    def current_iteration(self) -> int:
        return self._gbdt.current_iteration

    def num_trees(self) -> int:
        return len(self._gbdt.models)

    def num_model_per_iteration(self) -> int:
        return self._gbdt.num_tree_per_iteration

    def num_feature(self) -> int:
        return self._gbdt.max_feature_idx + 1

    def feature_name(self) -> List[str]:
        return list(self._gbdt.feature_names_)

    def eval(self, data: Dataset, name: str, feval=None) -> list:
        """The metrics of ``data``: the training set, or the validation
        set added under ``name``."""
        if data is self._train_set:
            return self.eval_train(feval)
        if name not in self.name_valid_sets:
            raise LightGBMError(f"No validation set named {name}")
        return [r for r in self.eval_all(feval) if r[0] == name]

    def eval_train(self, feval=None) -> list:
        return [r for r in self.eval_all(feval) if r[0] == "training"]

    def eval_valid(self, feval=None) -> list:
        return [r for r in self.eval_all(feval) if r[0] != "training"]

    def eval_all(self, feval=None, res=None) -> list:
        """[(dataset_name, metric_name, value, bigger_is_better)] with
        validation sets under the names given to add_valid; then, per
        dataset, each ``feval(preds, dataset)``'s (name, value,
        is_higher_better) results, with preds the transformed scores
        ([N], or [N, K]) and dataset the training Dataset (None for a
        validation set), as the JAX package calls it. ``res``: the
        metric rows of a resolved ``begin_eval_at_iter`` handle (the
        pipelined loop's), else they are evaluated now."""
        if res is None:
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
        """Scores, raw scores, with ``pred_leaf`` the [N, T] leaf index
        of every row in every tree, or with ``pred_contrib`` the SHAP
        contributions (``GBDT.predict_contrib``)."""
        if num_iteration is None:
            num_iteration = -1
        mat = _to_2d_numpy(data)

        def run(m):
            if pred_leaf:
                return self._gbdt.predict_leaf_index(m, start_iteration,
                                                     num_iteration)
            if pred_contrib:
                return self._gbdt.predict_contrib(m, start_iteration,
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

    def refit(self, data, label, decay_rate: float = 0.9,
              **kwargs) -> "Booster":
        """A new booster with this one's trees, their leaf values refit
        to ``data`` / ``label`` (reference basic.py:2873 Booster.refit;
        ``GBDT.refit_tree``)."""
        mat = _to_2d_numpy(data)
        leaf = self.predict(data, pred_leaf=True)
        new_params = dict(self.params)
        new_params["refit_decay_rate"] = decay_rate
        train = Dataset(mat, label=label, params=new_params,
                        free_raw_data=False)
        nb = Booster(new_params, train)
        nb._gbdt.models = [copy_tree(t) for t in self._gbdt.models]
        nb._gbdt.refit_tree(leaf)
        return nb

    def save_model(self, filename: str, num_iteration: Optional[int] = None,
                   start_iteration: int = 0,
                   importance_type: str = "split") -> "Booster":
        it = self.best_iteration if num_iteration is None else num_iteration
        self._gbdt.save_model_to_file(
            filename, start_iteration, it if it and it > 0 else -1,
            0 if importance_type == "split" else 1)
        return self

    @classmethod
    def model_from_string(cls, model_str: str, verbose: bool = True,
                          params: Optional[Dict[str, Any]] = None
                          ) -> "Booster":
        return cls(params=params, model_str=model_str)

    def dump_model(self, num_iteration: Optional[int] = None,
                   start_iteration: int = 0) -> dict:
        """The model as JSON-ready dicts (reference
        GBDT::DumpModel)."""
        g = self._gbdt
        it = self.best_iteration if num_iteration is None else num_iteration
        models = g._used_models(start_iteration, it if it and it > 0 else -1)
        return {
            "name": "tree",
            "version": "v3",
            "num_class": getattr(g, "_loaded_num_class",
                                 g.config.num_class if g.config else 1),
            "num_tree_per_iteration": g.num_tree_per_iteration,
            "label_index": g.label_idx,
            "max_feature_idx": g.max_feature_idx,
            "objective": g.objective.to_string() if g.objective else "",
            "average_output": g.average_output,
            "feature_names": list(g.feature_names_),
            "feature_infos": g._feature_infos(),
            "tree_info": [dict(tree_index=i, **t.to_json())
                          for i, t in enumerate(models)],
        }

    def feature_importance(self, importance_type: str = "split",
                           iteration: Optional[int] = None) -> np.ndarray:
        imp = self._gbdt.feature_importance(
            0 if importance_type == "split" else 1,
            iteration if iteration else -1)
        if importance_type == "split":
            return imp.astype(np.int32)
        return imp

    def get_split_value_histogram(self, feature, bins=None,
                                  xgboost_style=False):
        """numpy's histogram of the thresholds of every numerical split
        on ``feature`` (reference basic.py:2944)."""
        fidx = (self.feature_name().index(feature)
                if isinstance(feature, str) else int(feature))
        values = np.asarray([
            float(t.threshold[i]) for t in self._gbdt.models
            for i in range(t.num_leaves - 1)
            if int(t.split_feature[i]) == fidx
            and not t.is_categorical_node(i)])
        if bins is None:
            bins = max(min(len(values), 32), 1)
        hist, edges = np.histogram(values, bins=bins)
        if xgboost_style:
            import pandas as pd
            return pd.DataFrame({"SplitValue": edges[1:], "Count": hist})
        return hist, edges

    def trees_to_dataframe(self):
        """One row per node of every tree (reference basic.py:2132);
        needs pandas, imported here only."""
        import pandas as pd
        rows = []
        fn = self.feature_name()

        def child(ti, c):
            return f"{ti}-S{c}" if c >= 0 else f"{ti}-L{~c}"
        for ti, t in enumerate(self._gbdt.models):
            for i in range(t.num_leaves - 1):
                rows.append({
                    "tree_index": ti, "node_depth": None,
                    "node_index": f"{ti}-S{i}",
                    "left_child": child(ti, t.left_child[i]),
                    "right_child": child(ti, t.right_child[i]),
                    "parent_index": None,
                    "split_feature": fn[int(t.split_feature[i])],
                    "split_gain": float(t.split_gain[i]),
                    "threshold": float(t.threshold[i]),
                    "decision_type": ("==" if t.is_categorical_node(i)
                                      else "<="),
                    "missing_direction": ("left" if t.default_left(i)
                                          else "right"),
                    "missing_type": ["None", "Zero", "NaN"][
                        t.missing_type(i)],
                    "value": float(t.internal_value[i]),
                    "weight": float(t.internal_weight[i]),
                    "count": int(t.internal_count[i]),
                })
            for leaf in range(t.num_leaves):
                rows.append({
                    "tree_index": ti, "node_depth": None,
                    "node_index": f"{ti}-L{leaf}",
                    "left_child": None, "right_child": None,
                    "parent_index": None, "split_feature": None,
                    "split_gain": None, "threshold": None,
                    "decision_type": None, "missing_direction": None,
                    "missing_type": None,
                    "value": float(t.leaf_value[leaf]),
                    "weight": float(t.leaf_weight[leaf]),
                    "count": int(t.leaf_count[leaf]),
                })
        return pd.DataFrame(rows)

    def free_dataset(self) -> "Booster":
        self._train_set = None
        return self

    def model_to_string(self, num_iteration: Optional[int] = None,
                        start_iteration: int = 0,
                        importance_type: str = "split") -> str:
        it = self.best_iteration if num_iteration is None else num_iteration
        return self._gbdt.save_model_to_string(
            start_iteration, it if it and it > 0 else -1,
            0 if importance_type == "split" else 1)


def copy_tree(tree):
    """A copy of ``tree`` whose leaf and internal values can change
    without touching the original's."""
    t = copy.copy(tree)
    t.leaf_value = tree.leaf_value.copy()
    t.internal_value = tree.internal_value.copy()
    return t


__all__ = ["Booster", "Dataset", "LightGBMError"]
