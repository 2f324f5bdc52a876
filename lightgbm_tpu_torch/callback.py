"""Training callbacks, the port of the JAX package's callback.py:
``print_evaluation`` (alias ``log_evaluation``), ``record_evaluation``,
``record_metrics``, ``reset_parameter`` and ``early_stopping``, with the
reference package's contract (factories returning callables with
``order``/``before_iteration`` attributes, invoked with a
``CallbackEnv``; ``early_stopping`` signals via ``EarlyStopException``).
``record_evaluation`` and ``early_stopping`` carry a ``checkpoint_key``
and hand their state to a training checkpoint
(``checkpoint_state`` / ``restore_checkpoint_state``, the JAX
package's), so a resumed run records and stops as the uninterrupted
one would.

Evaluation entries are tuples ``(dataset_name, metric_name, value,
is_higher_better[, stdv])``: ``cv`` adds the standard deviation.
"""
from __future__ import annotations

import time
from collections import OrderedDict, namedtuple
from typing import Callable, Dict, List

from .utils import log


class EarlyStopException(Exception):
    """Raised by early_stopping to unwind the training loop."""

    def __init__(self, best_iteration: int, best_score) -> None:
        super().__init__()
        self.best_iteration = best_iteration
        self.best_score = best_score


CallbackEnv = namedtuple(
    "CallbackEnv",
    ["model", "params", "iteration", "begin_iteration", "end_iteration",
     "evaluation_result_list"])


def _entry_text(entry, with_stdv: bool = True) -> str:
    """'<dataset>'s <metric>: <value>[ + <stdv>]' for a 4/5-tuple."""
    if len(entry) not in (4, 5):
        raise ValueError("Wrong metric value")
    head = f"{entry[0]}'s {entry[1]}: {entry[2]:g}"
    if len(entry) == 5 and with_stdv:
        head += f" + {entry[4]:g}"
    return head


def _joined(entries, with_stdv: bool = True) -> str:
    return "\t".join(_entry_text(e, with_stdv) for e in entries)


class _EvalLogger:
    """Periodic metric printer."""

    order = 10

    def __init__(self, period: int, show_stdv: bool) -> None:
        self.period = period
        self.show_stdv = show_stdv

    def __call__(self, env: CallbackEnv) -> None:
        if self.period <= 0 or not env.evaluation_result_list:
            return
        if (env.iteration + 1) % self.period:
            return
        log.info("[%d]\t%s", env.iteration + 1,
                 _joined(env.evaluation_result_list, self.show_stdv))


def print_evaluation(period: int = 1, show_stdv: bool = True) -> Callable:
    return _EvalLogger(period, show_stdv)


log_evaluation = print_evaluation


class _EvalRecorder:
    """Appends every evaluation into a user-owned nested dict:
    result[dataset_name][metric_name] -> list of values per iteration."""

    order = 20
    checkpoint_key = "record_evaluation"

    def __init__(self, store: dict) -> None:
        self.store = store
        self._started = False

    def __call__(self, env: CallbackEnv) -> None:
        if not self._started:
            self.store.clear()
            self._started = True
        for entry in env.evaluation_result_list:
            series = self.store.setdefault(entry[0], OrderedDict())
            series.setdefault(entry[1], []).append(entry[2])

    # -- checkpoint and resume (robust/checkpoint.py) --------------------
    def checkpoint_state(self) -> dict:
        return {"store": {ds: {m: list(v) for m, v in series.items()}
                          for ds, series in self.store.items()},
                "started": self._started}

    def restore_checkpoint_state(self, state: dict) -> None:
        self.store.clear()
        for ds, series in state.get("store", {}).items():
            self.store[ds] = OrderedDict(
                (m, list(v)) for m, v in series.items())
        self._started = bool(state.get("started", True))


def record_evaluation(eval_result: dict) -> Callable:
    if not isinstance(eval_result, dict):
        raise TypeError("eval_result should be a dictionary")
    return _EvalRecorder(eval_result)


class _MetricsRecorder:
    """Appends one telemetry record per iteration into a user-owned
    list (the JAX package's recorder). When training runs with an
    active obs registry (``metrics_file`` / ``trace_file`` /
    ``profile_dir`` set, or an explicitly activated MetricsRegistry),
    the record is the registry's full per-iteration snapshot — the same
    dict the JSONL sink writes; otherwise a minimal record (iteration,
    wall-time delta, eval metrics) keeps the shape usable.

    Runs after the engine snapshots the iteration (order 25: between
    the eval recorder at 20 and early stopping at 30), so the snapshot
    is available even on the early-stopped final round."""

    order = 25

    def __init__(self, store: list) -> None:
        self.store = store
        self._started = False
        self._t_prev = None

    def __call__(self, env: CallbackEnv) -> None:
        from .obs import active
        if not self._started:
            self.store.clear()
            self._started = True
        reg = active()
        rec = reg.last_record if reg is not None else None
        if rec is not None and rec.get("iteration") == env.iteration:
            self.store.append(rec)
            self._t_prev = time.perf_counter()
            return
        now = time.perf_counter()
        dt = 0.0 if self._t_prev is None else now - self._t_prev
        self._t_prev = now
        self.store.append({
            "iteration": env.iteration,
            "t_iter_s": round(dt, 6),
            "metrics": {f"{e[0]}/{e[1]}": float(e[2])
                        for e in env.evaluation_result_list or []},
        })


def record_metrics(metrics_result: list) -> Callable:
    """Callback collecting one telemetry record per iteration into
    ``metrics_result``."""
    if not isinstance(metrics_result, list):
        raise TypeError("metrics_result should be a list")
    return _MetricsRecorder(metrics_result)


class _ParamScheduler:
    """Re-applies parameters before each iteration from per-key
    schedules (a list indexed by round, or a callable of the round
    index); a new learning_rate becomes the booster's shrinkage."""

    order = 10
    before_iteration = True

    def __init__(self, schedules: Dict) -> None:
        self.schedules = schedules

    @staticmethod
    def _value_at(key: str, spec, round_idx: int, total: int):
        if isinstance(spec, list):
            if len(spec) != total:
                raise ValueError(f"Length of list {key!r} has to equal to "
                                 "'num_boost_round'")
            return spec[round_idx]
        if callable(spec):
            return spec(round_idx)
        raise ValueError("Only list and callable values are supported "
                         "as a mapping from boosting round index to new "
                         "parameter value")

    def __call__(self, env: CallbackEnv) -> None:
        round_idx = env.iteration - env.begin_iteration
        total = env.end_iteration - env.begin_iteration
        updates = {k: self._value_at(k, v, round_idx, total)
                   for k, v in self.schedules.items()}
        if not updates:
            return
        if "learning_rate" in updates:
            env.model._gbdt.shrinkage_rate = float(updates["learning_rate"])
        env.model.params.update(updates)


def reset_parameter(**kwargs) -> Callable:
    return _ParamScheduler(kwargs)


class _MetricState:
    """Best-so-far tracker for one (dataset, metric) series."""

    __slots__ = ("best_value", "best_round", "best_entries", "higher_better")

    def __init__(self, higher_better: bool) -> None:
        self.higher_better = higher_better
        self.best_value = float("-inf") if higher_better else float("inf")
        self.best_round = 0
        self.best_entries = None

    def improved(self, value: float) -> bool:
        return value > self.best_value if self.higher_better \
            else value < self.best_value


class _EarlyStopper:
    """Stops when no tracked validation metric improved for
    ``stopping_rounds`` consecutive rounds."""

    order = 30
    checkpoint_key = "early_stopping"

    def __init__(self, stopping_rounds: int, first_metric_only: bool,
                 verbose: bool) -> None:
        self.stopping_rounds = stopping_rounds
        self.first_metric_only = first_metric_only
        self.verbose = verbose
        self.states: List[_MetricState] = []
        self.active = True
        self.first_metric = ""

    # -- checkpoint and resume (robust/checkpoint.py) --------------------
    def checkpoint_state(self) -> dict:
        return {
            "active": self.active,
            "first_metric": self.first_metric,
            "states": [{
                "higher_better": s.higher_better,
                "best_value": s.best_value,
                "best_round": s.best_round,
                "best_entries": (None if s.best_entries is None
                                 else [list(e) for e in s.best_entries]),
            } for s in self.states],
        }

    def restore_checkpoint_state(self, state: dict) -> None:
        self.active = bool(state.get("active", True))
        self.first_metric = state.get("first_metric", "")
        self.states = []
        for sd in state.get("states", []):
            ms = _MetricState(bool(sd["higher_better"]))
            ms.best_value = float(sd["best_value"])
            ms.best_round = int(sd["best_round"])
            if sd["best_entries"] is not None:
                ms.best_entries = [tuple(e) for e in sd["best_entries"]]
            self.states.append(ms)

    def _setup(self, env: CallbackEnv) -> None:
        boosting = [env.params.get(k, "") for k in
                    ("boosting", "boosting_type", "boost")]
        if "dart" in boosting:
            self.active = False
            log.warning("Early stopping is not available in dart mode")
            return
        if not env.evaluation_result_list:
            raise ValueError("For early stopping, at least one dataset and "
                             "eval metric is required for evaluation")
        if self.verbose:
            log.info("Training until validation scores don't improve for "
                     "%d rounds", self.stopping_rounds)
        self.first_metric = self._metric_key(env.evaluation_result_list[0])
        self.states = [_MetricState(bool(e[3]))
                       for e in env.evaluation_result_list]

    @staticmethod
    def _metric_key(entry) -> str:
        return entry[1].split(" ")[-1]

    def _announce_and_stop(self, state: _MetricState, reason: str) -> None:
        if self.verbose:
            log.info("%s, best iteration is:\n[%d]\t%s", reason,
                     state.best_round + 1, _joined(state.best_entries))
        raise EarlyStopException(state.best_round, state.best_entries)

    def __call__(self, env: CallbackEnv) -> None:
        if not self.states and self.active:
            self._setup(env)
        if not self.active:
            return
        is_last = env.iteration == env.end_iteration - 1
        for state, entry in zip(self.states, env.evaluation_result_list):
            if state.best_entries is None or state.improved(entry[2]):
                state.best_value = entry[2]
                state.best_round = env.iteration
                state.best_entries = env.evaluation_result_list
            if self.first_metric_only \
                    and self._metric_key(entry) != self.first_metric:
                continue
            if entry[0] != "training" \
                    and env.iteration - state.best_round >= self.stopping_rounds:
                self._announce_and_stop(state, "Early stopping")
            if is_last:
                self._announce_and_stop(state, "Did not meet early stopping")


def early_stopping(stopping_rounds: int, first_metric_only: bool = False,
                   verbose: bool = True) -> Callable:
    return _EarlyStopper(stopping_rounds, first_metric_only, verbose)
