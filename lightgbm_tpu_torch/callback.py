"""Training callbacks: the subset of the JAX package's callback.py the
main path calls — ``log_evaluation``,
``record_evaluation`` and ``early_stopping`` — with the reference
package's contract (factories returning callables with
``order``/``before_iteration`` attributes, invoked with a
``CallbackEnv``; ``early_stopping`` signals via ``EarlyStopException``).

Evaluation entries are tuples ``(dataset_name, metric_name, value,
is_higher_better)``.
"""
from __future__ import annotations

from collections import OrderedDict, namedtuple
from typing import Callable, List

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


def _joined(entries) -> str:
    return "\t".join(f"{e[0]}'s {e[1]}: {e[2]:g}" for e in entries)


class _EvalLogger:
    """Periodic metric printer."""

    order = 10

    def __init__(self, period: int) -> None:
        self.period = period

    def __call__(self, env: CallbackEnv) -> None:
        if self.period <= 0 or not env.evaluation_result_list:
            return
        if (env.iteration + 1) % self.period:
            return
        log.info("[%d]\t%s", env.iteration + 1,
                 _joined(env.evaluation_result_list))


def log_evaluation(period: int = 1) -> Callable:
    return _EvalLogger(period)


class _EvalRecorder:
    """Appends every evaluation into a user-owned nested dict:
    result[dataset_name][metric_name] -> list of values per iteration."""

    order = 20

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


def record_evaluation(eval_result: dict) -> Callable:
    if not isinstance(eval_result, dict):
        raise TypeError("eval_result should be a dictionary")
    return _EvalRecorder(eval_result)


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

    def __init__(self, stopping_rounds: int, first_metric_only: bool,
                 verbose: bool) -> None:
        self.stopping_rounds = stopping_rounds
        self.first_metric_only = first_metric_only
        self.verbose = verbose
        self.states: List[_MetricState] = []
        self.first_metric = ""

    def _setup(self, env: CallbackEnv) -> None:
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
        if not self.states:
            self._setup(env)
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
