"""scikit-learn estimator wrappers.

API-compatible re-implementation of the reference sklearn interface
(reference: python-package/lightgbm/sklearn.py — LGBMModel :172,
LGBMRegressor :752, LGBMClassifier :783, LGBMRanker :941, plus the
_ObjectiveFunctionWrapper :19 / _EvalFunctionWrapper :99 signature
translators), ported from the JAX package. scikit-learn is optional: the
estimators inherit its base classes when it is installed and plain
standalone bases otherwise. Pass ``device_type="cpu"`` to train on the
CPU; the default is the card.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np

from .basic import Booster, Dataset, LightGBMError
from .engine import train


class _ObjectiveFunctionWrapper:
    """sklearn fobj signature -> native (reference sklearn.py:19)."""

    def __init__(self, func: Callable) -> None:
        self.func = func

    def __call__(self, preds, dataset):
        labels = dataset.get_label()
        argc = self.func.__code__.co_argcount
        if argc == 2:
            grad, hess = self.func(labels, preds)
        elif argc == 3:
            grad, hess = self.func(labels, preds, dataset.get_group())
        else:
            raise TypeError(f"Self-defined objective function should have 2 or "
                            f"3 arguments, got {argc}")
        return grad, hess


class _EvalFunctionWrapper:
    """sklearn feval signature -> native (reference sklearn.py:99)."""

    def __init__(self, func: Callable) -> None:
        self.func = func

    def __call__(self, preds, dataset):
        labels = dataset.get_label() if dataset is not None else None
        argc = self.func.__code__.co_argcount
        if argc == 2:
            return self.func(labels, preds)
        if argc == 3:
            if dataset is not None and dataset.get_weight() is not None:
                return self.func(labels, preds, dataset.get_weight())
            return self.func(labels, preds, None)
        if argc == 4:
            return self.func(labels, preds, dataset.get_weight(),
                             dataset.get_group())
        raise TypeError(f"Self-defined eval function should have 2, 3 or 4 "
                        f"arguments, got {argc}")


try:  # inherit scikit-learn's estimator protocol when it is installed
    from sklearn.base import BaseEstimator as _LGBMModelBase
    from sklearn.base import ClassifierMixin as _LGBMClassifierBase
    from sklearn.base import RegressorMixin as _LGBMRegressorBase
except ImportError:  # standalone fallback (reference compat.py pattern)
    class _LGBMModelBase:
        pass

    class _LGBMClassifierBase:
        pass

    class _LGBMRegressorBase:
        pass


class LGBMModel(_LGBMModelBase):
    """Base estimator (reference sklearn.py:172)."""

    def __init__(self, boosting_type: str = "gbdt", num_leaves: int = 31,
                 max_depth: int = -1, learning_rate: float = 0.1,
                 n_estimators: int = 100, subsample_for_bin: int = 200000,
                 objective: Optional[str] = None, class_weight=None,
                 min_split_gain: float = 0.0, min_child_weight: float = 1e-3,
                 min_child_samples: int = 20, subsample: float = 1.0,
                 subsample_freq: int = 0, colsample_bytree: float = 1.0,
                 reg_alpha: float = 0.0, reg_lambda: float = 0.0,
                 random_state=None, n_jobs: int = -1, silent: bool = True,
                 importance_type: str = "split", **kwargs) -> None:
        self.boosting_type = boosting_type
        self.objective = objective
        self.num_leaves = num_leaves
        self.max_depth = max_depth
        self.learning_rate = learning_rate
        self.n_estimators = n_estimators
        self.subsample_for_bin = subsample_for_bin
        self.min_split_gain = min_split_gain
        self.min_child_weight = min_child_weight
        self.min_child_samples = min_child_samples
        self.subsample = subsample
        self.subsample_freq = subsample_freq
        self.colsample_bytree = colsample_bytree
        self.reg_alpha = reg_alpha
        self.reg_lambda = reg_lambda
        self.random_state = random_state
        self.n_jobs = n_jobs
        self.silent = silent
        self.importance_type = importance_type
        self.class_weight = class_weight
        self._Booster: Optional[Booster] = None
        self._evals_result = None
        self._best_score = None
        self._best_iteration = None
        self._n_features = None
        self._classes = None
        self._n_classes = None
        self._objective = objective
        self._other_params: Dict[str, Any] = {}
        self.set_params(**kwargs)

    # -- sklearn plumbing ---------------------------------------------
    def get_params(self, deep: bool = True) -> Dict[str, Any]:
        params = {k: getattr(self, k) for k in (
            "boosting_type", "num_leaves", "max_depth", "learning_rate",
            "n_estimators", "subsample_for_bin", "objective", "class_weight",
            "min_split_gain", "min_child_weight", "min_child_samples",
            "subsample", "subsample_freq", "colsample_bytree", "reg_alpha",
            "reg_lambda", "random_state", "n_jobs", "silent",
            "importance_type")}
        params.update(self._other_params)
        return params

    def set_params(self, **params) -> "LGBMModel":
        for key, value in params.items():
            setattr(self, key, value)
            if not hasattr(type(self), key):
                self._other_params[key] = value
        return self

    # ------------------------------------------------------------------
    def _process_params(self) -> Dict[str, Any]:
        params = self.get_params()
        params.pop("silent", None)
        params.pop("importance_type", None)
        params.pop("n_estimators", None)
        params.pop("class_weight", None)
        if self._n_classes is not None and self._n_classes > 2:
            params["num_class"] = self._n_classes
        if callable(self._objective):
            params["objective"] = "none"
        else:
            params["objective"] = self._objective
        params["verbosity"] = -1 if self.silent else 1
        alias = {"subsample_for_bin": "bin_construct_sample_cnt",
                 "min_split_gain": "min_gain_to_split",
                 "min_child_weight": "min_sum_hessian_in_leaf",
                 "min_child_samples": "min_data_in_leaf",
                 "subsample": "bagging_fraction",
                 "subsample_freq": "bagging_freq",
                 "colsample_bytree": "feature_fraction",
                 "reg_alpha": "lambda_l1", "reg_lambda": "lambda_l2"}
        for old, new in alias.items():
            if old in params:
                params[new] = params.pop(old)
        if params.get("random_state") is not None:
            params["seed"] = params.pop("random_state")
        else:
            params.pop("random_state", None)
        params.pop("n_jobs", None)
        params["boosting"] = params.pop("boosting_type")
        return {k: v for k, v in params.items() if v is not None}

    def fit(self, X, y, sample_weight=None, init_score=None, group=None,
            eval_set=None, eval_names=None, eval_sample_weight=None,
            eval_class_weight=None, eval_init_score=None, eval_group=None,
            eval_metric=None, early_stopping_rounds=None, verbose=False,
            feature_name="auto", categorical_feature="auto", callbacks=None,
            init_model=None) -> "LGBMModel":
        params = self._process_params()
        if eval_metric is not None and not callable(eval_metric):
            params["metric"] = eval_metric

        fobj = _ObjectiveFunctionWrapper(self._objective) \
            if callable(self._objective) else None
        feval = _EvalFunctionWrapper(eval_metric) if callable(eval_metric) else None

        y = np.asarray(_col(y)).reshape(-1)
        if self.class_weight is not None and sample_weight is None:
            sample_weight = self._class_sample_weight(y)
        train_set = Dataset(X, label=y, weight=sample_weight, group=group,
                            init_score=init_score, params=params,
                            feature_name=feature_name,
                            categorical_feature=categorical_feature,
                            free_raw_data=False)
        valid_sets: List[Dataset] = []
        if eval_set is not None:
            if isinstance(eval_set, tuple):
                eval_set = [eval_set]
            for i, (vx, vy) in enumerate(eval_set):
                if vx is X and vy is y:
                    valid_sets.append(train_set)
                    continue
                vw = eval_sample_weight[i] if eval_sample_weight else None
                vg = eval_group[i] if eval_group else None
                vi = eval_init_score[i] if eval_init_score else None
                vy = np.asarray(_col(vy)).reshape(-1)
                if self._classes is not None:
                    vy = self._encode_labels(vy)
                valid_sets.append(train_set.create_valid(
                    vx, label=vy, weight=vw, group=vg, init_score=vi))

        evals_result: Dict = {}
        self._Booster = train(
            params, train_set, num_boost_round=self.n_estimators,
            valid_sets=valid_sets or None, valid_names=eval_names,
            fobj=fobj, feval=feval,
            early_stopping_rounds=early_stopping_rounds,
            evals_result=evals_result, verbose_eval=verbose,
            callbacks=callbacks, init_model=init_model)
        self._evals_result = evals_result
        self._best_iteration = self._Booster.best_iteration
        self._best_score = self._Booster.best_score
        self._n_features = self._Booster.num_feature()
        return self

    def _class_sample_weight(self, y):
        if self.class_weight == "balanced":
            classes, counts = np.unique(y, return_counts=True)
            w = {c: len(y) / (len(classes) * cnt) for c, cnt in zip(classes, counts)}
        else:
            w = self.class_weight
        return np.asarray([w.get(v, 1.0) for v in y], dtype=np.float64)

    def predict(self, X, raw_score: bool = False, start_iteration: int = 0,
                num_iteration: Optional[int] = None, pred_leaf: bool = False,
                pred_contrib: bool = False, **kwargs):
        if self._Booster is None:
            raise LightGBMError("Estimator not fitted, call fit before predict")
        ni = num_iteration if num_iteration is not None else \
            (self._best_iteration if self._best_iteration and self._best_iteration > 0 else -1)
        return self._Booster.predict(X, raw_score=raw_score,
                                     start_iteration=start_iteration,
                                     num_iteration=ni, pred_leaf=pred_leaf,
                                     pred_contrib=pred_contrib, **kwargs)

    # -- attributes -----------------------------------------------------
    @property
    def booster_(self) -> Booster:
        if self._Booster is None:
            raise LightGBMError("No booster found. Need to call fit beforehand.")
        return self._Booster

    @property
    def best_iteration_(self):
        return self._best_iteration

    @property
    def best_score_(self):
        return self._best_score

    @property
    def evals_result_(self):
        return self._evals_result

    @property
    def n_features_(self):
        return self._n_features

    @property
    def feature_importances_(self) -> np.ndarray:
        if self._Booster is None:
            raise LightGBMError("No booster found. Need to call fit beforehand.")
        return self._Booster.feature_importance(importance_type=self.importance_type)

    @property
    def feature_name_(self):
        return self.booster_.feature_name()

    @property
    def objective_(self):
        return self._objective

    def _encode_labels(self, y):
        mapping = {c: i for i, c in enumerate(self._classes)}
        return np.asarray([mapping[v] for v in y], dtype=np.float64)


def _col(y):
    if hasattr(y, "values"):
        return y.values
    return y


class LGBMRegressor(_LGBMRegressorBase, LGBMModel):
    """reference sklearn.py:752."""

    def __init__(self, boosting_type="gbdt", num_leaves=31, max_depth=-1,
                 learning_rate=0.1, n_estimators=100, **kwargs):
        objective = kwargs.pop("objective", "regression")
        super().__init__(boosting_type=boosting_type, num_leaves=num_leaves,
                         max_depth=max_depth, learning_rate=learning_rate,
                         n_estimators=n_estimators, objective=objective,
                         **kwargs)
        self._objective = self.objective or "regression"

    def fit(self, X, y, **kwargs):
        self._objective = self.objective if self.objective is not None \
            else "regression"
        return super().fit(X, y, **kwargs)


class LGBMClassifier(_LGBMClassifierBase, LGBMModel):
    """reference sklearn.py:783."""

    def fit(self, X, y, **kwargs):
        y = np.asarray(_col(y)).reshape(-1)
        self._classes = np.unique(y)
        self._n_classes = len(self._classes)
        if self._n_classes > 2:
            if self.objective is None or self.objective in ("binary",):
                self._objective = "multiclass"
            else:
                self._objective = self.objective
        else:
            self._objective = self.objective if self.objective is not None \
                else "binary"
        y_enc = self._encode_labels(y)
        return super().fit(X, y_enc, **kwargs)

    @property
    def classes_(self):
        return self._classes

    @property
    def n_classes_(self):
        return self._n_classes

    def predict(self, X, raw_score: bool = False, start_iteration: int = 0,
                num_iteration=None, pred_leaf=False, pred_contrib=False,
                **kwargs):
        result = self.predict_proba(X, raw_score, start_iteration,
                                    num_iteration, pred_leaf, pred_contrib,
                                    **kwargs)
        if callable(self._objective) or raw_score or pred_leaf or pred_contrib:
            return result
        if result.ndim == 1:
            idx = (result > 0.5).astype(np.int64)
        else:
            idx = np.argmax(result, axis=1)
        return self._classes[idx]

    def predict_proba(self, X, raw_score: bool = False, start_iteration: int = 0,
                      num_iteration=None, pred_leaf=False, pred_contrib=False,
                      **kwargs):
        result = super().predict(X, raw_score, start_iteration, num_iteration,
                                 pred_leaf, pred_contrib, **kwargs)
        if callable(self._objective) or raw_score or pred_leaf or pred_contrib:
            return result
        if result.ndim == 1:
            return np.vstack([1.0 - result, result]).T
        return result


class LGBMRanker(LGBMModel):
    """reference sklearn.py:941."""

    def __init__(self, boosting_type="gbdt", num_leaves=31, max_depth=-1,
                 learning_rate=0.1, n_estimators=100, **kwargs):
        objective = kwargs.pop("objective", "lambdarank")
        super().__init__(boosting_type=boosting_type, num_leaves=num_leaves,
                         max_depth=max_depth, learning_rate=learning_rate,
                         n_estimators=n_estimators, objective=objective,
                         **kwargs)
        self._objective = self.objective or "lambdarank"

    def fit(self, X, y, group=None, **kwargs):
        if group is None:
            raise ValueError("Should set group for ranking task")
        eval_group = kwargs.get("eval_group")
        if kwargs.get("eval_set") is not None and eval_group is None:
            raise ValueError("Eval_group cannot be None when eval_set is not None")
        return super().fit(X, y, group=group, **kwargs)
