"""Training entry points ``train`` and ``cv`` (reference engine.py:18,
:394), the port of the JAX package's engine.py: a synchronous loop over
boosting iterations with validation sets, callbacks (before and after
each iteration), early stopping, custom objectives (``fobj``) and
metrics (``feval``), continued training from ``init_model``,
``learning_rates``, and ``cv`` over k boosters on subsets of one
dataset; and the JAX package's fault tolerance (robust/): periodic
atomic checkpoints and resume (``checkpoint_dir``), the fault-plan seam
at the top of every iteration (``LGBM_TPU_FAULT_PLAN``), the hang
watchdog (``hang_timeout``, ``auto_resume``) and the numeric sentinels'
recovery policy (``numeric_sentinels``); and the JAX package's
telemetry (obs/): a ``TelemetrySession`` when ``metrics_file``,
``trace_file``, ``profile_dir``, ``obs_port`` or ``flight_dir`` is set,
with one JSONL record per iteration, the runtime trace, the profiler,
the live endpoint and the flight recorder.

The loop is the JAX package's dispatch-ahead one: iteration t's
evaluation read and after-iteration callbacks run after iteration t+1
is dispatched, so early stopping sees iteration t one step late and
trains at most one tree more, which the saved model's truncation to
``best_iteration`` drops. ``LGBM_TPU_PIPELINE=0`` restores the
synchronous loop, and full telemetry (``metrics_file``, ``trace_file``,
``profile_dir``), ``feval`` and the degraded ladder's first rung keep
it synchronous too. ``tpu_warmup`` / ``LGBM_TPU_WARMUP`` (or a training
of ``bucket_min_rows`` rows) build the kernels on a background thread
while the Dataset is binned (compile/warmup.py).
"""
from __future__ import annotations

import collections
import copy
from typing import Any, Dict, List, Optional

import numpy as np

from . import callback as callback_mod
from . import network
from . import obs
from .basic import Booster, Dataset, LightGBMError, copy_tree
from .compile import signature as S
from .compile.warmup import background_warmup, warmup_wanted
from .config import Config
from .robust.checkpoint import CheckpointManager
from .robust.faultinject import check_fault
from .robust.sentinel import apply_degraded_rung
from .robust.watchdog import (HangTimeout, Watchdog, activate_watchdog,
                              deactivate_watchdog, watch_phase)
from .utils import device as _device
from .utils import log
from .utils.timer import global_timer

_NUM_ROUND_KEYS = ("num_iterations", "num_iteration", "n_iter", "num_tree",
                   "num_trees", "num_round", "num_rounds", "num_boost_round",
                   "n_estimators")
_EARLY_STOP_KEYS = ("early_stopping_round", "early_stopping_rounds",
                    "early_stopping", "n_iter_no_change")


def _resolve_num_boost_round(params: Dict[str, Any], default: int) -> int:
    for k in _NUM_ROUND_KEYS:
        if k in params:
            return int(params.pop(k))
    return default


def _resolve_early_stopping(params: Dict[str, Any],
                            explicit: Optional[int]) -> Optional[int]:
    for k in _EARLY_STOP_KEYS:
        if k in params:
            return int(params.pop(k))
    return explicit


def _split_callbacks(cbs):
    """(before-iteration, after-iteration) callbacks, each in order."""
    before = {cb for cb in cbs if getattr(cb, "before_iteration", False)}
    after = set(cbs) - before

    def order(s):
        return sorted(s, key=lambda cb: getattr(cb, "order", 0))
    return order(before), order(after)


def _init_scores_from(model: Booster, data) -> np.ndarray:
    """The raw scores of ``model`` on the raw rows ``data``, class-major
    flat with several classes (a Dataset's init_score layout)."""
    raw = model.predict(data, raw_score=True)
    return raw.T.reshape(-1) if raw.ndim == 2 else raw


def _ensure_network(params: Dict[str, Any]) -> None:
    """The process wiring before any dataset is built, so the bin
    mappers' gather and the learners see the group (reference
    Application::InitTrain calls Network::Init first,
    application.cpp:164-175). The network keys' aliases resolve through
    Config."""
    net = Config.from_params({
        k: v for k, v in params.items()
        if Config.resolve_alias(k) in ("num_machines", "machines",
                                       "time_out", "device_type")})
    if net.num_machines > 1:
        network.ensure_distributed(net.machines, net.num_machines,
                                   time_out=net.time_out,
                                   device_type=net.device_type)


def _rows_of(data: Dataset) -> int:
    """The row count of a Dataset before it is binned (0 for a file
    path, whose rows are not known yet)."""
    if data._handle is not None:
        return data.num_data()
    shape = getattr(data.data, "shape", None)
    return int(shape[0]) if shape else 0


def _telemetry_end_iteration(telemetry, booster: Booster, iteration: int,
                             evals) -> None:
    """Snapshot one iteration into the telemetry session (the JAX
    package's): one stream sync first, so the wall time holds the
    card's work, then the model statistics and the eval metrics."""
    gbdt = booster._gbdt
    extra: Dict[str, Any] = {}
    if not telemetry.record_consumers_active():
        # every record consumer is gone (the sink died on an I/O
        # error, nothing else is on): skip the stream sync and the
        # statistics; the registry keeps its lifecycle and counts the
        # drop
        telemetry.end_iteration(iteration)
        return
    with obs.span("telemetry stream sync", phase="sync"):
        _device.block_until_ready(gbdt.device)
    with obs.span("telemetry stats", phase="telemetry"):
        extra.update(gbdt.telemetry_stats())
    if evals:
        extra["metrics"] = {f"{ds}/{m}": float(v)
                            for ds, m, v, _ in evals}
    telemetry.end_iteration(iteration, extra=extra)


def _checkpoint_capture(booster: Booster, cbs) -> tuple:
    """(state, model_text) snapshot of everything resume needs: the
    boosting loop's state (gbdt.checkpoint_state), each
    checkpoint-aware callback's state (keyed by its checkpoint_key),
    and the running best_iteration. The model travels as the reference
    text format, so a checkpoint is also a valid saved model."""
    state: Dict[str, Any] = {
        "gbdt": booster._gbdt.checkpoint_state(),
        "best_iteration": int(booster.best_iteration),
        "callbacks": {},
    }
    for cb in cbs:
        key = getattr(cb, "checkpoint_key", None)
        if key and hasattr(cb, "checkpoint_state"):
            state["callbacks"][key] = cb.checkpoint_state()
    return state, booster._gbdt.save_model_to_string()


def _checkpoint_restore(booster: Booster, cbs, state: Dict[str, Any],
                        model_text: str) -> None:
    booster._gbdt.restore_checkpoint_state(state["gbdt"], model_text)
    booster.best_iteration = int(state.get("best_iteration", -1))
    cb_states = state.get("callbacks", {})
    for cb in cbs:
        key = getattr(cb, "checkpoint_key", None)
        if key and key in cb_states \
                and hasattr(cb, "restore_checkpoint_state"):
            cb.restore_checkpoint_state(cb_states[key])


def train(params: Dict[str, Any], train_set: Dataset,
          num_boost_round: int = 100, valid_sets=None, valid_names=None,
          fobj=None, feval=None, init_model=None,
          feature_name="auto", categorical_feature="auto",
          early_stopping_rounds: Optional[int] = None, evals_result=None,
          verbose_eval=True, learning_rates=None,
          keep_training_booster: bool = False, callbacks=None,
          checkpoint_dir: Optional[str] = None) -> Booster:
    """Train a booster; params are the JAX package's (and LightGBM's)
    keys and aliases, plus ``device_type`` "cuda" (default) or "cpu".
    ``fobj(preds, train_set) -> (grad, hess)`` replaces the objective
    (``objective`` becomes "none"); ``feval(preds, dataset)`` returns
    (name, value, is_higher_better) or a list of them, appended to each
    dataset's evaluation results. ``init_model`` (a model file's path or
    a Booster) continues training: the training and validation scores
    start from its raw predictions on the raw rows (so their Datasets
    need ``free_raw_data=False``), and its trees lead the new model's.
    ``learning_rates``: a list per round, or a function of the round.
    The training Dataset is released at the end unless
    ``keep_training_booster``. ``timetag`` (or LGBM_TPU_TIMETAG) logs
    the host time of the construction and of the iterations.
    ``num_machines`` > 1 sets up the process group first (network.py
    ``ensure_distributed``, from ``machines`` or the environment).

    ``checkpoint_dir`` (or the ``checkpoint_dir`` param) makes training
    preemption-safe: an atomic checkpoint every ``checkpoint_interval``
    iterations (the newest ``checkpoint_keep`` kept), and a resume from
    the newest valid one when the directory holds one (unless
    ``init_model`` is given), finishing with the uninterrupted run's
    model text byte for byte. A checkpoint of another configuration
    (``device_type`` included) is refused. ``hang_timeout`` > 0 arms
    the hang watchdog (robust/watchdog.py): a stall raises
    ``HangTimeout`` or, with ``auto_resume``, restores the latest
    checkpoint (at most ``auto_resume_attempts`` times).
    ``numeric_sentinels`` quarantines an iteration whose gradients or
    leaf values are non-finite or overflow
    ``sentinel_overflow_limit``; ``sentinel_max_trips`` trips roll back
    to the latest checkpoint and step down the degraded-mode ladder.

    Telemetry (obs/): ``metrics_file`` writes one schema-versioned JSONL
    record per iteration (every ``metrics_interval``-th), ``trace_file``
    a Perfetto trace of the phase spans and host syncs, ``profile_dir``
    a torch.profiler Chrome trace with the card's kernels, ``obs_port``
    serves /metrics /healthz /statusz on 127.0.0.1, and ``flight_dir``
    arms the flight recorder (watchdog, sentinel and ``flight_slo_factor``
    triggers). Telemetry changes no result: trees, predictions and
    metrics equal the run without it (the model text's parameter block
    echoes the telemetry keys)."""
    params = copy.deepcopy(params) if params else {}
    _ensure_network(params)
    num_boost_round = _resolve_num_boost_round(params, num_boost_round)
    if num_boost_round <= 0:
        raise ValueError("num_boost_round should be greater than zero.")
    early_stopping_rounds = _resolve_early_stopping(params,
                                                    early_stopping_rounds)
    first_metric_only = bool(params.get("first_metric_only", False))
    if fobj is not None:
        params["objective"] = "none"
    if feature_name != "auto":
        train_set.feature_name = feature_name
    if categorical_feature != "auto":
        train_set.categorical_feature = categorical_feature

    predictor = None
    if isinstance(init_model, str):
        predictor = Booster(
            params={"device_type": Config.from_params(params).device_type},
            model_file=init_model)
    elif isinstance(init_model, Booster):
        predictor = init_model
    if predictor is not None and train_set.init_score is None:
        # reference basic.py _set_init_score_by_predictor:1019; through
        # set_init_score, so a Dataset constructed already takes it too
        if train_set.data is None:
            raise LightGBMError("Cannot continue training when the raw data "
                                "was freed; pass free_raw_data=False")
        train_set.set_init_score(_init_scores_from(predictor,
                                                   train_set.data))

    if any(Config.resolve_alias(k) == "timetag" for k in params):
        # the phase table of named scopes (utils/timer.py), per train()
        global_timer.set_enabled(Config.from_params(params).timetag)
    cfg0 = Config.from_params(params)
    if warmup_wanted(cfg0, _rows_of(train_set)):
        # the kernels build on a thread while the Dataset is binned; the
        # first launch waits for them instead of building them
        background_warmup(cfg0.device_type)
    with global_timer.scope("dataset construction + learner build"):
        booster = Booster(params=params, train_set=train_set)
    if predictor is not None:
        gb = booster._gbdt
        predictor._gbdt._materialize_models()
        gb.models = [copy_tree(t) for t in predictor._gbdt.models] \
            + gb.models
        gb.num_init_iteration = (len(predictor._gbdt.models)
                                 // predictor._gbdt.num_tree_per_iteration)
        gb.iter = 0

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
            if predictor is not None and vs.init_score is None \
                    and vs.data is not None:
                vs.set_init_score(_init_scores_from(predictor, vs.data))
            booster.add_valid(vs, valid_names[i] if valid_names is not None
                              else f"valid_{i}")

    cbs = set(callbacks) if callbacks else set()
    if verbose_eval is True:
        cbs.add(callback_mod.print_evaluation())
    elif isinstance(verbose_eval, int) and verbose_eval is not False:
        cbs.add(callback_mod.print_evaluation(verbose_eval))
    if early_stopping_rounds is not None and early_stopping_rounds > 0:
        cbs.add(callback_mod.early_stopping(early_stopping_rounds,
                                            first_metric_only,
                                            verbose=bool(verbose_eval)))
    if learning_rates is not None:
        cbs.add(callback_mod.reset_parameter(learning_rate=learning_rates))
    if evals_result is not None:
        cbs.add(callback_mod.record_evaluation(evals_result))
    cbs_before, cbs_after = _split_callbacks(cbs)
    want_eval = valid_contain_train or bool(booster.name_valid_sets)

    def env(i, evals):
        return callback_mod.CallbackEnv(
            model=booster, params=params, iteration=i, begin_iteration=0,
            end_iteration=num_boost_round, evaluation_result_list=evals)

    # preemption safety: periodic atomic checkpoints and the resume,
    # wired after the callbacks so that the checkpoint-aware ones
    # (early stopping, record_evaluation) hand their state back
    gbdt = booster._gbdt
    cfg = gbdt.config
    ckpt_dir = checkpoint_dir if checkpoint_dir else cfg.checkpoint_dir
    ckpt_mgr = None
    start_iteration = 0
    if ckpt_dir:
        ckpt_mgr = CheckpointManager(
            ckpt_dir, interval=cfg.checkpoint_interval,
            keep=cfg.checkpoint_keep,
            params_digest=S._digest(S.config_signature(cfg)))
        if init_model is None:
            resumed = ckpt_mgr.load_latest()
            if resumed is not None:
                it, ck_state, ck_model = resumed
                _checkpoint_restore(booster, cbs, ck_state, ck_model)
                start_iteration = it + 1
                log.info("Resuming from checkpoint %s: %d iterations "
                         "already trained", ckpt_mgr.path_for(it),
                         start_iteration)
        else:
            # the reference's init_model semantics win: an explicit warm
            # start means the caller manages continuation
            log.warning("checkpoint_dir=%s ignored for resume because "
                        "init_model was given (checkpoints will still "
                        "be written)", ckpt_dir)

    def restore_latest() -> bool:
        """Roll the live booster back to the newest checkpoint and set
        the loop's re-entry iteration. The evaluation in flight belongs
        to the abandoned timeline and is dropped."""
        nonlocal start_iteration, pending
        resumed = ckpt_mgr.load_latest() if ckpt_mgr is not None else None
        if resumed is None:
            return False
        pending = None
        it, ck_state, ck_model = resumed
        _checkpoint_restore(booster, cbs, ck_state, ck_model)
        start_iteration = it + 1
        return True

    # self-healing: the hang watchdog's deadman timer over the loop; the
    # sentinels' verdicts ride the loop's reads, and the policy below
    # quarantines bad trees, rolls back to the last checkpoint and steps
    # down the degraded-mode ladder
    telemetry = obs.TelemetrySession.from_config(cfg)
    if telemetry is not None:
        telemetry.start()
        telemetry.registry.set_gauge("train.total_iterations",
                                     float(num_boost_round))
    full_telemetry = telemetry is not None and not telemetry.lightweight
    # dispatch-ahead pipelining (LGBM_TPU_PIPELINE=0 restores the
    # synchronous loop, read by GBDT as _pipeline): iteration t's
    # evaluation read and after-iteration callbacks run after iteration
    # t+1 is dispatched. Full telemetry stays synchronous (its stream
    # sync serializes the loop, and each record carries its own
    # iteration's metrics), as does feval (it reads the live scores);
    # lightweight sessions (obs_port / flight_dir) ride the pipelined
    # loop. The degraded ladder's first rung clears gbdt._pipeline.
    pipeline_ok = not full_telemetry and feval is None
    pending = None    # (iteration, evaluation handle in flight)

    def resolve_evals(handle) -> list:
        out = []
        if handle is None:
            return out
        with obs.span("metric evaluation (resolve)", phase="eval"):
            for ds, name, val, bib in booster.eval_all(
                    feval, res=gbdt.finish_eval_at_iter(handle)):
                if ds == "training":
                    if not valid_contain_train:
                        continue
                    ds = train_name
                out.append((ds, name, val, bib))
        return out

    def after_callbacks(it: int, evals) -> None:
        with watch_phase("host-callback:after"):
            for cb in cbs_after:
                cb(env(it, evals))

    def early_stop(e: callback_mod.EarlyStopException) -> list:
        booster.best_iteration = e.best_iteration + 1
        return e.best_score

    def drain() -> list:
        """Resolve the evaluation in flight and run its callbacks."""
        nonlocal pending
        pit, ph = pending
        pending = None
        out = resolve_evals(ph)
        after_callbacks(pit, out)
        return out

    wd = None
    if cfg.hang_timeout > 0:
        # the first iterations load the kernels: a short timeout must
        # not call that a hang (and there is no checkpoint yet)
        wd = Watchdog(cfg.hang_timeout,
                      warmup_grace_s=max(60.0, 4 * cfg.hang_timeout),
                      trace_path=(cfg.trace_file + ".watchdog.json"
                                  if cfg.trace_file else None))
        activate_watchdog(wd)
        wd.start()
    resume_attempts = 0
    degraded_rung = 0
    evals: list = []
    try:
        while True:
            restart = False
            try:
                for i in range(start_iteration, num_boost_round):
                    if wd is not None:
                        wd.beat(i)
                        wd.check()
                    spec = check_fault("train.iteration", index=i)
                    if spec is not None and spec.mode in ("nan", "overflow"):
                        # the drill: the next gradient plane is poisoned,
                        # and the sentinels must catch it
                        gbdt._poison_next = spec.mode
                    if telemetry is not None:
                        telemetry.begin_iteration(i)
                    with obs.span("before-iteration callbacks",
                                  phase="callbacks"), \
                            watch_phase("host-callback:before"):
                        for cb in cbs_before:
                            cb(env(i, None))
                    with obs.span("boosting iteration (device dispatch)",
                                  phase="update"), \
                            watch_phase("dispatch:update"):
                        finished = booster.update(fobj=fobj)
                    handle = None
                    if want_eval:
                        with obs.span("metric evaluation", phase="eval"):
                            handle = gbdt.begin_eval_at_iter()
                    if full_telemetry:
                        evals = resolve_evals(handle)
                        _telemetry_end_iteration(telemetry, booster, i,
                                                 evals)
                    elif telemetry is not None:
                        # lightweight: the registry's wall clock, the
                        # fleet merge and the SLO check only; the window
                        # ends at dispatch, and the trailing resolve is
                        # charged to the next iteration
                        telemetry.end_iteration(i)
                    drained_it = i
                    try:
                        if full_telemetry:
                            after_callbacks(i, evals)
                        else:
                            # the trailing resolve: the PREVIOUS
                            # iteration's read and callbacks run while
                            # this iteration's work is in flight
                            if pending is not None:
                                drained_it = pending[0]
                                evals = drain()
                            pending = (i, handle)
                            if not (pipeline_ok and gbdt._pipeline) \
                                    or finished:
                                drained_it = i
                                evals = drain()
                    except callback_mod.EarlyStopException as e:
                        evals = early_stop(e)
                        if drained_it < i:
                            # the stop arrived one dispatch late:
                            # iteration i is trained already (and
                            # truncated away through best_iteration)
                            obs.inc("pipeline.delayed_stop_iters")
                        break
                    sent = gbdt._sentinel
                    if sent is not None and gbdt.process_sentinel_trips():
                        # repeated trips: quarantine was not enough; roll
                        # back to the last checkpoint and give up one
                        # rung of the ladder per recovery epoch
                        if apply_degraded_rung(gbdt, degraded_rung) \
                                is not None:
                            degraded_rung += 1
                        if restore_latest():
                            obs.inc("health.rollbacks")
                            sent.drop_pending()
                            sent.reset_trips()
                            log.warning(
                                "sentinel: rolled back to iteration %d after"
                                " %d numeric-health trips", start_iteration,
                                sent.total_trips)
                            restart = True
                            break
                        # no checkpoint to return to: the trees are
                        # quarantined already, train on degraded
                        sent.reset_trips()
                    if finished:
                        break
                    if ckpt_mgr is not None and ckpt_mgr.due(i):
                        # the pipelined loop drains first: the callbacks'
                        # state and the evaluation records cover
                        # iteration i, as the synchronous loop's would
                        if pending is not None:
                            try:
                                evals = drain()
                            except callback_mod.EarlyStopException as e:
                                evals = early_stop(e)
                                break
                        with obs.span("checkpoint save", phase="checkpoint"):
                            ck_state, ck_model = _checkpoint_capture(
                                booster, cbs)
                            ckpt_mgr.save(i, ck_state, ck_model)
                if restart:
                    continue
                # the last iteration's callbacks (the early stopper's
                # announcement among them) when the loop ran to its end
                # with an evaluation in flight
                if pending is not None:
                    try:
                        evals = drain()
                    except callback_mod.EarlyStopException as e:
                        evals = early_stop(e)
                break
            except HangTimeout:
                resume_attempts += 1
                if not cfg.auto_resume \
                        or resume_attempts > cfg.auto_resume_attempts \
                        or not restore_latest():
                    # no checkpoint, or attempts exhausted: surface the
                    # watchdog's classified diagnosis
                    raise
                if gbdt._sentinel is not None:
                    gbdt._sentinel.drop_pending()
                if wd is not None:
                    wd.clear()
                obs.inc("watchdog.auto_resume")
                log.warning(
                    "watchdog: auto-resuming from iteration %d after a "
                    "detected hang (attempt %d/%d)", start_iteration,
                    resume_attempts, cfg.auto_resume_attempts)
        # verdicts still pending: a trip on the last trees still
        # quarantines them before the model is final
        if gbdt._sentinel is not None:
            gbdt.sentinel_drain()
            gbdt.process_sentinel_trips()
    finally:
        if wd is not None:
            deactivate_watchdog(wd)
            wd.stop()
        if telemetry is not None:
            telemetry.close()
    if booster._gbdt._fused is not None:
        # the per-tree fused path trains on between its periodic stop
        # checks: drop the trailing single-leaf iterations, as the JAX
        # package does at the end of training
        booster._gbdt.trim_degenerate_tail()
    booster.best_score = {}
    for ds, name, val, _ in evals or []:
        booster.best_score.setdefault(ds, {})[name] = val
    if global_timer.enabled and global_timer.acc:
        log.info("%s", global_timer.report())
        global_timer.reset()
    if not keep_training_booster:
        booster.free_dataset()
    return booster


class CVBooster:
    """The boosters of a cross-validation, one per fold (reference
    engine.py:280); a method called on it runs on every booster and
    returns their results as a list."""

    def __init__(self) -> None:
        self.boosters: List[Booster] = []
        self.best_iteration = -1

    def _append(self, booster: Booster) -> None:
        self.boosters.append(booster)

    def __getattr__(self, name: str):
        def handler_function(*args, **kwargs):
            return [getattr(b, name)(*args, **kwargs) for b in self.boosters]
        return handler_function


def _make_n_folds(full_data: Dataset, folds, nfold: int, params: Dict,
                  seed: int, fpreproc=None, stratified: bool = True,
                  shuffle: bool = True, eval_train_metric: bool = False
                  ) -> CVBooster:
    """One booster per fold, each on a subset of ``full_data`` with the
    fold's rows as its validation set: ``folds`` given (index pairs or
    a scikit-learn splitter), else whole queries per fold when the data
    has groups, else stratified by label, else plain, all from
    ``RandomState(seed)`` draws in the JAX package's order."""
    full_data = full_data.construct()
    num_data = full_data.num_data()
    group = full_data.get_group()
    if folds is not None:
        if not hasattr(folds, "__iter__") and not hasattr(folds, "split"):
            raise AttributeError(
                "folds should be a generator or iterator of (train_idx, "
                "test_idx) tuples or scikit-learn splitter")
        if hasattr(folds, "split"):
            folds = folds.split(X=np.empty(num_data),
                                y=full_data.get_label(), groups=None)
    elif group is not None:
        ng = len(group)
        rng = np.random.RandomState(seed)
        gidx = rng.permutation(ng) if shuffle else np.arange(ng)
        bounds = np.concatenate([[0], np.cumsum(group)]).astype(np.int64)
        folds = []
        for part in np.array_split(gidx, nfold):
            test_idx = (np.concatenate([np.arange(bounds[g], bounds[g + 1])
                                        for g in sorted(part.tolist())])
                        if len(part) else np.empty(0, np.int64))
            folds.append((np.setdiff1d(np.arange(num_data), test_idx),
                          test_idx))
    elif stratified:
        label = full_data.get_label()
        rng = np.random.RandomState(seed)
        assign = np.empty(num_data, dtype=np.int64)
        for c in np.unique(label):
            rows = np.flatnonzero(label == c)
            if shuffle:
                rng.shuffle(rows)
            assign[rows] = np.arange(len(rows)) % nfold
        folds = [(np.flatnonzero(assign != k), np.flatnonzero(assign == k))
                 for k in range(nfold)]
    else:
        rng = np.random.RandomState(seed)
        idx = rng.permutation(num_data) if shuffle else np.arange(num_data)
        folds = [(np.setdiff1d(np.arange(num_data), p), np.sort(p))
                 for p in np.array_split(idx, nfold)]

    ret = CVBooster()
    for train_idx, test_idx in folds:
        train_sub = full_data.subset(np.sort(train_idx))
        valid_sub = full_data.subset(np.sort(test_idx))
        if group is not None:
            bounds = np.concatenate([[0], np.cumsum(group)]).astype(np.int64)
            qid = np.searchsorted(bounds, np.arange(num_data),
                                  side="right") - 1
            tq, vq = qid[np.sort(train_idx)], qid[np.sort(test_idx)]
            train_sub.group = np.bincount(tq)[np.unique(tq)]
            valid_sub.group = np.bincount(vq)[np.unique(vq)]
        tparams = params
        if fpreproc is not None:
            train_sub, valid_sub, tparams = fpreproc(
                train_sub, valid_sub, copy.deepcopy(params))
        booster = Booster(tparams, train_sub)
        if eval_train_metric:
            booster.add_valid(train_sub, "train")
        booster.add_valid(valid_sub, "valid")
        ret._append(booster)
    return ret


def _agg_cv_result(raw_results, eval_train_metric: bool = False):
    """Per metric across the folds: ("cv_agg", key, mean,
    is_higher_better, stdv)."""
    cvmap = collections.OrderedDict()
    metric_type = {}
    for one_result in raw_results:
        for one_line in one_result:
            key = (f"{one_line[0]} {one_line[1]}" if eval_train_metric
                   else one_line[1])
            metric_type[key] = one_line[3]
            cvmap.setdefault(key, []).append(one_line[2])
    return [("cv_agg", k, float(np.mean(v)), metric_type[k],
             float(np.std(v))) for k, v in cvmap.items()]


def cv(params: Dict[str, Any], train_set: Dataset, num_boost_round: int = 100,
       folds=None, nfold: int = 5, stratified: bool = True,
       shuffle: bool = True, metrics=None, fobj=None, feval=None,
       init_model=None, feature_name="auto", categorical_feature="auto",
       early_stopping_rounds: Optional[int] = None, fpreproc=None,
       verbose_eval=None, show_stdv: bool = True, seed: int = 0,
       callbacks=None, eval_train_metric: bool = False,
       return_cvbooster: bool = False) -> Dict[str, Any]:
    """k-fold cross-validation (reference engine.py:394): one booster
    per fold (``_make_n_folds``), all updated each round; returns
    {"<metric>-mean": [...], "<metric>-stdv": [...]} per round (plus
    "cvbooster" with ``return_cvbooster``). ``init_model``,
    ``feature_name`` and ``categorical_feature`` are accepted and, as
    in the JAX package, not used."""
    params = copy.deepcopy(params) if params else {}
    _ensure_network(params)
    num_boost_round = _resolve_num_boost_round(params, num_boost_round)
    early_stopping_rounds = _resolve_early_stopping(params,
                                                    early_stopping_rounds)
    first_metric_only = params.get("first_metric_only", False)
    if fobj is not None:
        params["objective"] = "none"
    if metrics is not None:
        params["metric"] = metrics
    if params.get("objective") in ("lambdarank", "rank_xendcg"):
        stratified = False

    results = collections.defaultdict(list)
    cvfolds = _make_n_folds(train_set, folds, nfold, params, seed, fpreproc,
                            stratified, shuffle, eval_train_metric)
    cbs = set(callbacks) if callbacks else set()
    if early_stopping_rounds is not None and early_stopping_rounds > 0:
        cbs.add(callback_mod.early_stopping(early_stopping_rounds,
                                            first_metric_only, verbose=False))
    if verbose_eval is True:
        cbs.add(callback_mod.print_evaluation(show_stdv=show_stdv))
    elif isinstance(verbose_eval, int) and verbose_eval is not False:
        cbs.add(callback_mod.print_evaluation(verbose_eval, show_stdv))
    cbs_before, cbs_after = _split_callbacks(cbs)

    def env(i, evals):
        return callback_mod.CallbackEnv(
            model=cvfolds, params=params, iteration=i, begin_iteration=0,
            end_iteration=num_boost_round, evaluation_result_list=evals)

    for i in range(num_boost_round):
        for cb in cbs_before:
            cb(env(i, None))
        for b in cvfolds.boosters:
            b.update(fobj=fobj)
        raw = [b.eval_valid(feval)
               + (b.eval_train(feval) if eval_train_metric else [])
               for b in cvfolds.boosters]
        res = _agg_cv_result(raw, eval_train_metric)
        for _, key, mean, _, std in res:
            results[f"{key}-mean"].append(mean)
            results[f"{key}-stdv"].append(std)
        try:
            for cb in cbs_after:
                cb(env(i, res))
        except callback_mod.EarlyStopException as e:
            cvfolds.best_iteration = e.best_iteration + 1
            for bst in cvfolds.boosters:
                bst.best_iteration = cvfolds.best_iteration
            for k in results:
                results[k] = results[k][:cvfolds.best_iteration]
            break
    out = dict(results)
    if return_cvbooster:
        out["cvbooster"] = cvfolds
    return out


__all__ = ["CVBooster", "cv", "train"]
