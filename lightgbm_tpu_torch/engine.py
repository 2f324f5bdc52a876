"""``train`` — the training entry point (reference engine.py:18), main-path
subset of the JAX package's engine.py: a synchronous loop over
boosting iterations with validation sets, evaluation callbacks, early
stopping, custom objectives (``fobj``) and custom metrics (``feval``).
``cv``, init_model and checkpointing are not ported yet (ROADMAP
A6/A14)."""
from __future__ import annotations

import copy
from typing import Any, Dict, Optional

from . import callback as callback_mod
from .basic import Booster, Dataset

_NUM_ROUND_KEYS = ("num_iterations", "num_iteration", "n_iter", "num_tree",
                   "num_trees", "num_round", "num_rounds", "num_boost_round",
                   "n_estimators")
_EARLY_STOP_KEYS = ("early_stopping_round", "early_stopping_rounds",
                    "early_stopping", "n_iter_no_change")


def train(params: Dict[str, Any], train_set: Dataset,
          num_boost_round: int = 100, valid_sets=None, valid_names=None,
          fobj=None, feval=None,
          early_stopping_rounds: Optional[int] = None, evals_result=None,
          verbose_eval=True, callbacks=None) -> Booster:
    """Train a booster; params are the JAX package's (and LightGBM's)
    keys and aliases, plus ``device_type`` "cuda" (default) or "cpu".
    ``fobj(preds, train_set) -> (grad, hess)`` replaces the objective
    (``objective`` becomes "none"); ``feval(preds, dataset)`` returns
    (name, value, is_higher_better) or a list of them, appended to each
    dataset's evaluation results."""
    params = copy.deepcopy(params) if params else {}
    if fobj is not None:
        params["objective"] = "none"
    for k in _NUM_ROUND_KEYS:
        if k in params:
            num_boost_round = int(params.pop(k))
            break
    if num_boost_round <= 0:
        raise ValueError("num_boost_round should be greater than zero.")
    for k in _EARLY_STOP_KEYS:
        if k in params:
            early_stopping_rounds = int(params.pop(k))
            break
    first_metric_only = bool(params.get("first_metric_only", False))

    booster = Booster(params=params, train_set=train_set)
    valid_contain_train = False
    train_name = "training"
    if valid_sets is not None:
        if isinstance(valid_sets, Dataset):
            valid_sets = [valid_sets]
        if isinstance(valid_names, str):
            valid_names = [valid_names]
        for i, vs in enumerate(valid_sets):
            if vs is train_set:
                valid_contain_train = True
                if valid_names is not None:
                    train_name = valid_names[i]
                continue
            booster.add_valid(vs, valid_names[i] if valid_names is not None
                              else f"valid_{i}")

    cbs = set(callbacks) if callbacks else set()
    if verbose_eval is True:
        cbs.add(callback_mod.log_evaluation())
    elif isinstance(verbose_eval, int) and verbose_eval is not False:
        cbs.add(callback_mod.log_evaluation(verbose_eval))
    if early_stopping_rounds is not None and early_stopping_rounds > 0:
        cbs.add(callback_mod.early_stopping(early_stopping_rounds,
                                            first_metric_only,
                                            verbose=bool(verbose_eval)))
    if evals_result is not None:
        cbs.add(callback_mod.record_evaluation(evals_result))
    cbs = sorted(cbs, key=lambda cb: getattr(cb, "order", 0))
    want_eval = valid_contain_train or bool(booster.name_valid_sets)

    evals: list = []
    for i in range(num_boost_round):
        finished = booster.update(fobj=fobj)
        evals = []
        if want_eval:
            for ds, name, val, bib in booster.eval_all(feval):
                if ds == "training":
                    if not valid_contain_train:
                        continue
                    ds = train_name
                evals.append((ds, name, val, bib))
        try:
            for cb in cbs:
                cb(callback_mod.CallbackEnv(
                    model=booster, params=params, iteration=i,
                    begin_iteration=0, end_iteration=num_boost_round,
                    evaluation_result_list=evals))
        except callback_mod.EarlyStopException as e:
            booster.best_iteration = e.best_iteration + 1
            evals = e.best_score
            break
        if finished:
            break
    if booster._gbdt._fused is not None:
        # the per-tree fused path trains on between its periodic stop
        # checks: drop the trailing single-leaf iterations, as the JAX
        # package does at the end of training
        booster._gbdt.trim_degenerate_tail()
    booster.best_score = {}
    for ds, name, val, _ in evals or []:
        booster.best_score.setdefault(ds, {})[name] = val
    return booster


__all__ = ["train"]
