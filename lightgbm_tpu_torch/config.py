"""Configuration for lightgbm_tpu_torch.

The port's copy of the JAX package's config system, itself a re-design
of the reference's (reference:
include/LightGBM/config.h — a single flat ``Config`` struct with ~180
documented parameters; src/io/config.cpp for alias resolution / parsing;
config_auto.cpp is generated from config.h comments by
helpers/parameter_generator.py).

Here the single source of truth is the ``Config`` dataclass below plus the
``_ALIASES`` table.  ``Config.from_params`` reproduces the reference's
behaviour: alias resolution (first alias wins with a warning), string→typed
parsing, unknown keys kept (and echoed back) but warned about, and the small
amount of inter-parameter fix-up logic from Config::Set
(src/io/config.cpp:200-360).

Every key of the JAX package is kept under the same name, so params pass
unchanged between the two packages. The one default that differs is
``device_type``: "cuda" (alias "gpu") or "cpu"; the JAX default "tpu" has
no meaning here. Options that only the JAX package implements are
accepted and echoed into saved models; the learner rejects the ones that
change training (treelearner/fused.py fused_reject_reason).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Union

from .utils import log


# ---------------------------------------------------------------------------
# Alias table: alias -> canonical name.
# Mirrors the alias doc-comments in reference include/LightGBM/config.h.
# ---------------------------------------------------------------------------
_ALIASES: Dict[str, str] = {
    # core
    "config_file": "config",
    "task_type": "task",
    "objective_type": "objective",
    "app": "objective",
    "application": "objective",
    "boosting_type": "boosting",
    "boost": "boosting",
    "train": "data",
    "train_data": "data",
    "train_data_file": "data",
    "data_filename": "data",
    "test": "valid",
    "valid_data": "valid",
    "valid_data_file": "valid",
    "test_data": "valid",
    "test_data_file": "valid",
    "valid_filenames": "valid",
    "num_iteration": "num_iterations",
    "n_iter": "num_iterations",
    "num_tree": "num_iterations",
    "num_trees": "num_iterations",
    "num_round": "num_iterations",
    "num_rounds": "num_iterations",
    "num_boost_round": "num_iterations",
    "n_estimators": "num_iterations",
    "shrinkage_rate": "learning_rate",
    "eta": "learning_rate",
    "num_leaf": "num_leaves",
    "max_leaves": "num_leaves",
    "max_leaf": "num_leaves",
    "tree": "tree_learner",
    "tree_type": "tree_learner",
    "tree_learner_type": "tree_learner",
    "num_thread": "num_threads",
    "nthread": "num_threads",
    "nthreads": "num_threads",
    "n_jobs": "num_threads",
    "device": "device_type",
    "random_seed": "seed",
    "random_state": "seed",
    # learning control
    "min_data_per_leaf": "min_data_in_leaf",
    "min_data": "min_data_in_leaf",
    "min_child_samples": "min_data_in_leaf",
    "min_sum_hessian_per_leaf": "min_sum_hessian_in_leaf",
    "min_sum_hessian": "min_sum_hessian_in_leaf",
    "min_hessian": "min_sum_hessian_in_leaf",
    "min_child_weight": "min_sum_hessian_in_leaf",
    "sub_row": "bagging_fraction",
    "subsample": "bagging_fraction",
    "bagging": "bagging_fraction",
    "pos_sub_row": "pos_bagging_fraction",
    "pos_subsample": "pos_bagging_fraction",
    "pos_bagging": "pos_bagging_fraction",
    "neg_sub_row": "neg_bagging_fraction",
    "neg_subsample": "neg_bagging_fraction",
    "neg_bagging": "neg_bagging_fraction",
    "subsample_freq": "bagging_freq",
    "bagging_fraction_seed": "bagging_seed",
    "sub_feature": "feature_fraction",
    "colsample_bytree": "feature_fraction",
    "sub_feature_bynode": "feature_fraction_bynode",
    "colsample_bynode": "feature_fraction_bynode",
    "extra_tree": "extra_trees",
    "early_stopping_rounds": "early_stopping_round",
    "early_stopping": "early_stopping_round",
    "n_iter_no_change": "early_stopping_round",
    "max_tree_output": "max_delta_step",
    "max_leaf_output": "max_delta_step",
    "reg_alpha": "lambda_l1",
    "reg_lambda": "lambda_l2",
    "lambda": "lambda_l2",
    "min_split_gain": "min_gain_to_split",
    "rate_drop": "drop_rate",
    "topk": "top_k",
    "mc": "monotone_constraints",
    "monotone_constraint": "monotone_constraints",
    "monotone_constraining_method": "monotone_constraints_method",
    "mc_method": "monotone_constraints_method",
    "monotone_splits_penalty": "monotone_penalty",
    "ms_penalty": "monotone_penalty",
    "mc_penalty": "monotone_penalty",
    "feature_contrib": "feature_contri",
    "fc": "feature_contri",
    "fp": "feature_contri",
    "feature_penalty": "feature_contri",
    "fs": "forcedsplits_filename",
    "forced_splits_filename": "forcedsplits_filename",
    "forced_splits_file": "forcedsplits_filename",
    "forced_splits": "forcedsplits_filename",
    "verbose": "verbosity",
    # observability
    "metrics_out": "metrics_file",
    "metrics_output_file": "metrics_file",
    "trace_dir": "profile_dir",
    "trace_out": "trace_file",
    "trace_output_file": "trace_file",
    "time_tag": "timetag",
    "obs_http_port": "obs_port",
    "status_port": "obs_port",
    "flight_recorder_dir": "flight_dir",
    "flight_out": "flight_dir",
    "fleet_telemetry": "fleet_metrics",
    # fault tolerance
    "checkpoint_path": "checkpoint_dir",
    "ckpt_dir": "checkpoint_dir",
    "checkpoint_freq": "checkpoint_interval",
    "ckpt_interval": "checkpoint_interval",
    "ckpt_keep": "checkpoint_keep",
    "watchdog_timeout": "hang_timeout",
    "hang_timeout_s": "hang_timeout",
    "auto_restart": "auto_resume",
    "sentinels": "numeric_sentinels",
    "numeric_health_checks": "numeric_sentinels",
    # dataset
    "max_bins": "max_bin",
    "subsample_for_bin": "bin_construct_sample_cnt",
    "data_seed": "data_random_seed",
    "is_sparse": "is_enable_sparse",
    "enable_sparse": "is_enable_sparse",
    "sparse": "is_enable_sparse",
    "is_enable_bundle": "enable_bundle",
    "bundle": "enable_bundle",
    "max_conflict_rate": "efb_max_conflict_rate",
    "is_pre_partition": "pre_partition",
    "two_round_loading": "two_round",
    "use_two_round_loading": "two_round",
    "has_header": "header",
    "label": "label_column",
    "weight": "weight_column",
    "group": "group_column",
    "group_id": "group_column",
    "query_column": "group_column",
    "query": "group_column",
    "query_id": "group_column",
    "ignore_feature": "ignore_column",
    "blacklist": "ignore_column",
    "cat_feature": "categorical_feature",
    "categorical_column": "categorical_feature",
    "cat_column": "categorical_feature",
    "is_save_binary": "save_binary",
    "is_save_binary_file": "save_binary",
    # predict
    "is_predict_raw_score": "predict_raw_score",
    "predict_rawscore": "predict_raw_score",
    "raw_score": "predict_raw_score",
    "is_predict_leaf_index": "predict_leaf_index",
    "leaf_index": "predict_leaf_index",
    "is_predict_contrib": "predict_contrib",
    "contrib": "predict_contrib",
    # objective
    "num_classes": "num_class",
    "unbalance": "is_unbalance",
    "unbalanced_sets": "is_unbalance",
    "metrics": "metric",
    "metric_types": "metric",
    "output_freq": "metric_freq",
    "training_metric": "is_provide_training_metric",
    "is_training_metric": "is_provide_training_metric",
    "train_metric": "is_provide_training_metric",
    "ndcg_eval_at": "eval_at",
    "ndcg_at": "eval_at",
    "map_eval_at": "eval_at",
    "map_at": "eval_at",
    # network
    "num_machine": "num_machines",
    "local_port": "local_listen_port",
    "port": "local_listen_port",
    "machine_list_file": "machine_list_filename",
    "machine_list": "machine_list_filename",
    "mlist": "machine_list_filename",
    "workers": "machines",
    "nodes": "machines",
    # io
    "model_output": "output_model",
    "model_out": "output_model",
    "model_input": "input_model",
    "model_in": "input_model",
    "predict_result": "output_result",
    "prediction_result": "output_result",
    "predict_name": "output_result",
    "prediction_name": "output_result",
    "pred_name": "output_result",
    "name_pred": "output_result",
    "init_score_filename": "initscore_filename",
    "init_score_file": "initscore_filename",
    "init_score": "initscore_filename",
    "input_init_score": "initscore_filename",
}

_OBJECTIVE_ALIASES: Dict[str, str] = {
    "regression": "regression",
    "regression_l2": "regression",
    "l2": "regression",
    "mean_squared_error": "regression",
    "mse": "regression",
    "l2_root": "regression",
    "root_mean_squared_error": "regression",
    "rmse": "regression",
    "regression_l1": "regression_l1",
    "l1": "regression_l1",
    "mean_absolute_error": "regression_l1",
    "mae": "regression_l1",
    "huber": "huber",
    "fair": "fair",
    "poisson": "poisson",
    "quantile": "quantile",
    "mape": "mape",
    "mean_absolute_percentage_error": "mape",
    "gamma": "gamma",
    "tweedie": "tweedie",
    "binary": "binary",
    "multiclass": "multiclass",
    "softmax": "multiclass",
    "multiclassova": "multiclassova",
    "multiclass_ova": "multiclassova",
    "ova": "multiclassova",
    "ovr": "multiclassova",
    "cross_entropy": "cross_entropy",
    "xentropy": "cross_entropy",
    "cross_entropy_lambda": "cross_entropy_lambda",
    "xentlambda": "cross_entropy_lambda",
    "lambdarank": "lambdarank",
    "rank_xendcg": "rank_xendcg",
    "xendcg": "rank_xendcg",
    "xe_ndcg": "rank_xendcg",
    "xe_ndcg_mart": "rank_xendcg",
    "xendcg_mart": "rank_xendcg",
    "none": "custom",
    "null": "custom",
    "custom": "custom",
    "na": "custom",
}

_METRIC_ALIASES: Dict[str, str] = {
    "": "",
    "l1": "l1", "mean_absolute_error": "l1", "mae": "l1", "regression_l1": "l1",
    "l2": "l2", "mean_squared_error": "l2", "mse": "l2", "regression": "l2",
    "regression_l2": "l2",
    "rmse": "rmse", "root_mean_squared_error": "rmse", "l2_root": "rmse",
    "quantile": "quantile",
    "mape": "mape", "mean_absolute_percentage_error": "mape",
    "huber": "huber",
    "fair": "fair",
    "poisson": "poisson",
    "gamma": "gamma",
    "gamma_deviance": "gamma_deviance",
    "tweedie": "tweedie",
    "ndcg": "ndcg", "lambdarank": "ndcg", "rank_xendcg": "ndcg",
    "xendcg": "ndcg", "xe_ndcg": "ndcg", "xe_ndcg_mart": "ndcg",
    "xendcg_mart": "ndcg",
    "map": "map", "mean_average_precision": "map",
    "auc": "auc",
    "auc_mu": "auc_mu",
    "binary_logloss": "binary_logloss", "binary": "binary_logloss",
    "binary_error": "binary_error",
    "multi_logloss": "multi_logloss", "multiclass": "multi_logloss",
    "softmax": "multi_logloss", "multiclassova": "multi_logloss",
    "multiclass_ova": "multi_logloss", "ova": "multi_logloss",
    "ovr": "multi_logloss",
    "multi_error": "multi_error",
    "cross_entropy": "cross_entropy", "xentropy": "cross_entropy",
    "cross_entropy_lambda": "cross_entropy_lambda",
    "xentlambda": "cross_entropy_lambda",
    "kullback_leibler": "kldiv", "kldiv": "kldiv",
    "none": "custom", "null": "custom", "custom": "custom", "na": "custom",
}


def _parse_bool(v: Any) -> bool:
    if isinstance(v, bool):
        return v
    if isinstance(v, (int, float)):
        return bool(v)
    return str(v).strip().lower() in ("true", "1", "yes", "+", "t", "y")


def _parse_int_list(v: Any) -> List[int]:
    if v is None:
        return []
    if isinstance(v, (list, tuple)):
        return [int(x) for x in v]
    s = str(v).strip()
    if not s:
        return []
    return [int(x) for x in s.replace(":", ",").split(",") if x != ""]


def _parse_float_list(v: Any) -> List[float]:
    if v is None:
        return []
    if isinstance(v, (list, tuple)):
        return [float(x) for x in v]
    s = str(v).strip()
    if not s:
        return []
    return [float(x) for x in s.replace(":", ",").split(",") if x != ""]


def _parse_str_list(v: Any) -> List[str]:
    if v is None:
        return []
    if isinstance(v, (list, tuple)):
        return [str(x) for x in v]
    s = str(v).strip()
    if not s:
        return []
    return [x for x in s.split(",") if x != ""]


@dataclass
class Config:
    """Flat parameter set (reference: include/LightGBM/config.h)."""

    # --- core ---
    task: str = "train"
    objective: str = "regression"
    boosting: str = "gbdt"
    data: str = ""
    valid: List[str] = field(default_factory=list)
    num_iterations: int = 100
    learning_rate: float = 0.1
    num_leaves: int = 31
    tree_learner: str = "serial"
    num_threads: int = 0
    device_type: str = "cuda"
    seed: int = 0
    deterministic: bool = False

    # --- learning control ---
    force_col_wise: bool = False
    force_row_wise: bool = False
    histogram_pool_size: float = -1.0
    max_depth: int = -1
    min_data_in_leaf: int = 20
    min_sum_hessian_in_leaf: float = 1e-3
    bagging_fraction: float = 1.0
    pos_bagging_fraction: float = 1.0
    neg_bagging_fraction: float = 1.0
    bagging_freq: int = 0
    bagging_seed: int = 3
    feature_fraction: float = 1.0
    feature_fraction_bynode: float = 1.0
    feature_fraction_seed: int = 2
    extra_trees: bool = False
    extra_seed: int = 6
    early_stopping_round: int = 0
    first_metric_only: bool = False
    max_delta_step: float = 0.0
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    min_gain_to_split: float = 0.0
    drop_rate: float = 0.1
    max_drop: int = 50
    skip_drop: float = 0.5
    xgboost_dart_mode: bool = False
    uniform_drop: bool = False
    drop_seed: int = 4
    top_rate: float = 0.2
    other_rate: float = 0.1
    min_data_per_group: int = 100
    max_cat_threshold: int = 32
    cat_l2: float = 10.0
    cat_smooth: float = 10.0
    max_cat_to_onehot: int = 4
    top_k: int = 20
    monotone_constraints: List[int] = field(default_factory=list)
    monotone_constraints_method: str = "basic"
    monotone_penalty: float = 0.0
    feature_contri: List[float] = field(default_factory=list)
    forcedsplits_filename: str = ""
    refit_decay_rate: float = 0.9
    cegb_tradeoff: float = 1.0
    cegb_penalty_split: float = 0.0
    cegb_penalty_feature_lazy: List[float] = field(default_factory=list)
    cegb_penalty_feature_coupled: List[float] = field(default_factory=list)
    path_smooth: float = 0.0
    interaction_constraints: Union[str, List[List[int]]] = ""
    verbosity: int = 1
    snapshot_freq: int = -1

    # --- observability (docs/OBSERVABILITY.md) ---
    # JSONL sink: one schema-versioned record per boosting iteration
    metrics_file: str = ""
    # profiler trace output dir
    profile_dir: str = ""
    # write every k-th iteration record (1 = all)
    metrics_interval: int = 1
    # runtime trace timeline (obs/trace.py): Perfetto-loadable
    # trace.json written at the end of train(); empty = tracing off
    trace_file: str = ""
    # tracer ring-buffer capacity in events; the newest events win and
    # evictions are counted in the export's otherData.dropped_events
    trace_buffer_events: int = 262144
    # runtime toggle for the utils/timer.py phase table (equivalent to
    # LGBM_TPU_TIMETAG=1, but per-train and without reimport)
    timetag: bool = False
    # start the kernels' background build in train() regardless of the
    # dataset size (compile/warmup.py); LGBM_TPU_WARMUP overrides both
    # ways
    tpu_warmup: bool = False
    # live observability endpoint (/metrics /healthz /statusz) on a
    # localhost daemon thread; 0 = off (no socket, zero overhead).
    # Binds 127.0.0.1 — widen with LGBM_TPU_OBS_BIND, an explicit
    # operator decision (docs/OBSERVABILITY.md "Fleet plane").
    obs_port: int = 0
    # flight recorder: on a watchdog / sentinel / SLO trigger, dump an
    # atomic evidence bundle (trace ring, registry, fleet table, thread
    # stacks) into this directory. Empty = off.
    flight_dir: str = ""
    # SLO trigger threshold: an iteration wall time above
    # flight_slo_factor x the rolling p50 fires the recorder (needs
    # flight_dir); <= 1 disables the SLO trigger
    flight_slo_factor: float = 4.0
    # fleet aggregation: merge per-rank registry deltas over the
    # straggler allgather at iteration boundaries (telemetry mode only;
    # single-process runs never touch the interconnect)
    fleet_metrics: bool = True

    # --- fault tolerance (docs/ROBUSTNESS.md) ---
    # directory for periodic atomic training checkpoints; train()
    # auto-resumes from the latest valid one. Empty = off.
    checkpoint_dir: str = ""
    # write a checkpoint every k-th completed boosting iteration
    checkpoint_interval: int = 50
    # retain the newest k checkpoint files
    checkpoint_keep: int = 2
    # hang watchdog deadline in seconds: if one boosting iteration,
    # collective dispatch, or trailing readback blocks the host longer
    # than this, the watchdog flushes the trace, dumps thread stacks,
    # and classifies the stall. 0 = watchdog off.
    hang_timeout: float = 0.0
    # on a watchdog trip (or exhausted sentinel retries), re-enter
    # training from the last checkpoint instead of aborting
    auto_resume: bool = False
    # maximum automatic re-entries per train() call
    auto_resume_attempts: int = 3
    # device-side numeric-health sentinels on new trees' leaf values;
    # verdicts ride the existing trailing fetches (no extra syncs)
    numeric_sentinels: bool = False
    # |leaf value| above this trips the overflow sentinel
    sentinel_overflow_limit: float = 1e30
    # sentinel trips before escalating from single-tree quarantine to
    # checkpoint rollback + degraded-mode ladder
    sentinel_max_trips: int = 2

    # --- dataset ---
    max_bin: int = 255
    max_bin_by_feature: List[int] = field(default_factory=list)
    min_data_in_bin: int = 3
    bin_construct_sample_cnt: int = 200000
    data_random_seed: int = 1
    is_enable_sparse: bool = True
    enable_bundle: bool = True
    # EFB bundling budgets (io/efb.py). Wider bundles (fewer groups)
    # are what the row-wise multival histogram path wants: the per-row
    # code list shrinks with the group count. Bundle codes widen to
    # uint16 automatically past 256 bins.
    efb_max_bundle_bins: int = 256
    # allowed conflict fraction of the sampled rows per bundle pair
    # (reference max_conflict_rate); 0 = only provably disjoint merges
    efb_max_conflict_rate: float = 1.0 / 10000
    use_missing: bool = True
    zero_as_missing: bool = False
    feature_pre_filter: bool = True
    pre_partition: bool = False
    two_round: bool = False
    header: bool = False
    label_column: str = ""
    weight_column: str = ""
    group_column: str = ""
    ignore_column: str = ""
    categorical_feature: Union[str, List[int]] = ""
    forcedbins_filename: str = ""
    save_binary: bool = False

    # --- predict ---
    start_iteration_predict: int = 0
    num_iteration_predict: int = -1
    predict_raw_score: bool = False
    predict_leaf_index: bool = False
    predict_contrib: bool = False
    predict_disable_shape_check: bool = False
    pred_early_stop: bool = False
    pred_early_stop_freq: int = 10
    pred_early_stop_margin: float = 10.0

    # --- convert ---
    convert_model_language: str = ""
    convert_model: str = "gbdt_prediction.cpp"

    # --- objective params ---
    objective_seed: int = 5
    num_class: int = 1
    is_unbalance: bool = False
    scale_pos_weight: float = 1.0
    sigmoid: float = 1.0
    boost_from_average: bool = True
    reg_sqrt: bool = False
    alpha: float = 0.9
    fair_c: float = 1.0
    poisson_max_delta_step: float = 0.7
    tweedie_variance_power: float = 1.5
    lambdarank_truncation_level: int = 30
    lambdarank_norm: bool = True
    label_gain: List[float] = field(default_factory=list)

    # --- metric ---
    metric: List[str] = field(default_factory=list)
    metric_freq: int = 1
    is_provide_training_metric: bool = False
    eval_at: List[int] = field(default_factory=lambda: [1, 2, 3, 4, 5])
    multi_error_top_k: int = 1
    auc_mu_weights: List[float] = field(default_factory=list)

    # --- network (TPU: mesh geometry instead of machine lists) ---
    num_machines: int = 1
    local_listen_port: int = 12400
    time_out: int = 120
    machine_list_filename: str = ""
    machines: str = ""

    # --- device (the tpu_* names are kept so params pass unchanged
    # between the JAX package and the port) ---
    gpu_platform_id: int = -1
    gpu_device_id: int = -1
    gpu_use_dp: bool = False
    tpu_mesh_shape: List[int] = field(default_factory=list)
    # histogram input precision on the card: "bfloat16" (default;
    # grad/hess rounded to an 8-bit mantissa before an f32 accumulation —
    # the reference GPU learner's gpu_use_dp=false analogue) or
    # "float32" (exact inputs). The CPU path is always exact f32
    # (ops/histogram.py hist_method).
    tpu_hist_dtype: str = "bfloat16"
    # histogram memory layout (ops/histogram.py hist_layout): "auto"
    # picks per dataset from measured occupancy — planar for dense-narrow
    # shapes, row-wise multi-value for wide-sparse shapes (not ported
    # yet on the card); "planar"/"multival" force one side.
    tpu_hist_layout: str = "auto"
    tpu_rows_per_chunk: int = 0  # 0 = auto
    # fused tree growth over the planar state (treelearner/fused.py);
    # False runs the host-loop grower (treelearner/serial.py)
    tpu_fused: bool = True
    num_gpu: int = 1

    # --- quantized-gradient training (docs/QUANTIZED_GRADIENTS.md) ---
    # Quantized Training of Gradient Boosting Decision Trees (Shi et
    # al., NeurIPS 2022; reference use_quantized_grad). Gradients and
    # hessians are stochastically rounded to small integers once per
    # iteration and the histogram kernels accumulate in int32, halving
    # the grad/hess HBM traffic and the parallel-learner collective
    # payloads. Off by default: the f32 path is byte-identical.
    use_quantized_grad: bool = False
    # total signed grad levels / unsigned hess levels. 4..64: the
    # ceiling keeps per-chunk integer partial sums exactly
    # representable in the f32/bf16 MXU accumulation paths
    # (131072-row chunks x qmax 63 < 2^24).
    num_grad_quant_bins: int = 4
    # refit leaf outputs from exact f32 grad/hess sums after the
    # quantized growth (reference quant_train_renew_leaf)
    quant_train_renew_leaf: bool = True
    # stochastic vs nearest rounding of grad/hess to integer levels
    stochastic_rounding: bool = True

    # --- io (train file mode) ---
    input_model: str = ""
    output_model: str = "LightGBM_model.txt"
    output_result: str = "LightGBM_predict_result.txt"
    initscore_filename: str = ""
    valid_data_initscores: List[str] = field(default_factory=list)

    # unknown/extra params kept verbatim (echoed into saved models)
    extra: Dict[str, Any] = field(default_factory=dict)

    # ------------------------------------------------------------------
    @classmethod
    def resolve_alias(cls, name: str) -> str:
        """Canonical parameter name for an alias (identity when not an
        alias) — the one ParameterAlias::KeyAliasTransform lookup."""
        name = str(name).strip()
        return _ALIASES.get(name, name)

    @classmethod
    def from_params(cls, params: Optional[Dict[str, Any]]) -> "Config":
        """Build a Config from a user params dict, resolving aliases.

        Mirrors Config::Set + ParameterAlias::KeyAliasTransform
        (reference src/io/config.cpp / config_auto.cpp).
        """
        cfg = cls()
        if not params:
            cfg._finalize()
            return cfg
        fields = {f.name: f for f in dataclasses.fields(cls)}
        resolved: Dict[str, Any] = {}
        for key, value in params.items():
            name = key.strip()
            canonical = _ALIASES.get(name, name)
            if canonical in resolved and canonical != name:
                log.warning("%s is set with %s=%s, %s=%s will be ignored. "
                            "Current value: %s=%s", canonical, canonical,
                            resolved[canonical], name, value, canonical,
                            resolved[canonical])
                continue
            resolved[canonical] = value
        for name, value in resolved.items():
            if name not in fields:
                cfg.extra[name] = value
                continue
            f = fields[name]
            try:
                cfg._set_field(f, value)
            except (TypeError, ValueError) as e:
                log.fatal("Bad value %r for parameter %s: %s", value, name, e)
        cfg._finalize()
        return cfg

    def _set_field(self, f: dataclasses.Field, value: Any) -> None:
        name, tp = f.name, f.type
        if name == "valid":
            setattr(self, name, _parse_str_list(value))
        elif name == "metric":
            names = [_resolve_metric_name(m) for m in _parse_str_list(value)]
            setattr(self, name, [m for m in names if m])
        elif name in ("monotone_constraints",):
            setattr(self, name, _parse_int_list(value))
        elif name in ("eval_at", "max_bin_by_feature", "tpu_mesh_shape"):
            setattr(self, name, _parse_int_list(value))
        elif name in ("feature_contri", "label_gain", "auc_mu_weights",
                      "cegb_penalty_feature_lazy", "cegb_penalty_feature_coupled",
                      "valid_data_initscores"):
            if name == "valid_data_initscores":
                setattr(self, name, _parse_str_list(value))
            else:
                setattr(self, name, _parse_float_list(value))
        elif name in ("categorical_feature", "interaction_constraints"):
            setattr(self, name, value)
        elif name == "machines":
            # the reference python package accepts machine LISTS and
            # joins them with "," (basic.py set_network plumbing)
            if isinstance(value, (list, tuple, set)):
                value = ",".join(str(m) for m in value)
            setattr(self, name, str(value))
        elif tp == "bool" or isinstance(getattr(self, name), bool):
            setattr(self, name, _parse_bool(value))
        elif isinstance(getattr(self, name), int):
            setattr(self, name, int(float(value)))
        elif isinstance(getattr(self, name), float):
            setattr(self, name, float(value))
        else:
            setattr(self, name, str(value))

    def _finalize(self) -> None:
        """Inter-parameter checks (reference Config::CheckParamConflict)."""
        dev = str(self.device_type).strip().lower()
        dev = {"gpu": "cuda"}.get(dev, dev)
        if dev not in ("cuda", "cpu"):
            log.fatal("device_type must be 'cuda' (alias 'gpu') or 'cpu', "
                      "got %r", self.device_type)
        self.device_type = dev
        if self.tpu_hist_dtype not in ("bfloat16", "float32"):
            log.fatal("tpu_hist_dtype must be 'bfloat16' or 'float32', "
                      "got %r", self.tpu_hist_dtype)
        if not 4 <= self.num_grad_quant_bins <= 64:
            log.fatal("num_grad_quant_bins must be in [4, 64], got %d",
                      self.num_grad_quant_bins)
        if self.tpu_hist_layout not in ("auto", "planar", "multival"):
            log.fatal("tpu_hist_layout must be 'auto', 'planar' or "
                      "'multival', got %r", self.tpu_hist_layout)
        if not 2 <= self.efb_max_bundle_bins <= 65536:
            log.fatal("efb_max_bundle_bins must be in [2, 65536] "
                      "(uint16 code ceiling), got %d",
                      self.efb_max_bundle_bins)
        if not 0.0 <= self.efb_max_conflict_rate < 1.0:
            log.fatal("efb_max_conflict_rate must be in [0, 1), got %g",
                      self.efb_max_conflict_rate)
        self.objective = _resolve_objective_name(self.objective)
        self.boosting = {"gbdt": "gbdt", "gbrt": "gbdt", "dart": "dart",
                         "goss": "goss", "rf": "rf",
                         "random_forest": "rf"}.get(self.boosting, self.boosting)
        if self.boosting not in ("gbdt", "dart", "goss", "rf"):
            log.fatal("Unknown boosting type %s", self.boosting)
        if not self.metric:
            self.metric = _default_metric_for_objective(self.objective)
        if self.objective in ("multiclass", "multiclassova") and self.num_class <= 1:
            log.fatal("Number of classes should be specified and greater than 1 for multiclass training")
        if self.objective not in ("multiclass", "multiclassova", "custom") and self.num_class != 1:
            log.fatal("Number of classes must be 1 for non-multiclass training")
        if self.is_unbalance and self.scale_pos_weight != 1.0:
            log.fatal("Cannot set is_unbalance and scale_pos_weight at the same time")
        if self.boosting == "rf":
            if not (self.bagging_freq > 0 and 0.0 < self.bagging_fraction < 1.0):
                log.fatal("Need bagging_freq > 0 and 0 < bagging_fraction < 1 for random forest")
        if self.bagging_freq > 0 and (self.pos_bagging_fraction != 1.0 or self.neg_bagging_fraction != 1.0):
            if self.objective != "binary":
                log.fatal("pos/neg bagging only supported for binary objective")
        self.num_leaves = max(self.num_leaves, 2)
        self.max_bin = max(self.max_bin, 2)
        self.metrics_interval = max(self.metrics_interval, 1)
        if self.checkpoint_dir:
            self.checkpoint_interval = max(self.checkpoint_interval, 1)
            self.checkpoint_keep = max(self.checkpoint_keep, 1)
        self.hang_timeout = max(self.hang_timeout, 0.0)
        self.auto_resume_attempts = max(self.auto_resume_attempts, 1)
        self.sentinel_max_trips = max(self.sentinel_max_trips, 1)
        if self.sentinel_overflow_limit <= 0:
            self.sentinel_overflow_limit = 1e30
        self.obs_port = max(int(self.obs_port), 0)
        self.flight_slo_factor = max(float(self.flight_slo_factor), 0.0)
        log.set_verbosity(self.verbosity)

    def to_params_string(self) -> str:
        """Serialize `key: value` lines for the saved-model parameters block
        (reference gbdt_model_text.cpp SaveModelToString tail)."""
        out = []
        # checkpoint fields stay OUT of the parameters block: a resumed
        # run and its uninterrupted baseline must serialize identical
        # model texts (the chaos tests compare them byte-for-byte), and
        # where the checkpoint lives is operational, not model, state
        skip = ("extra", "checkpoint_dir", "checkpoint_interval",
                "checkpoint_keep", "hang_timeout", "auto_resume",
                "auto_resume_attempts", "numeric_sentinels",
                "sentinel_overflow_limit", "sentinel_max_trips",
                # the observability plane is operational state too:
                # where metrics flow must not change the model text
                "obs_port", "flight_dir", "flight_slo_factor",
                "fleet_metrics")
        for f in dataclasses.fields(self):
            if f.name in skip:
                continue
            v = getattr(self, f.name)
            if isinstance(v, list):
                v = ",".join(str(x) for x in v)
            out.append(f"[{f.name}: {v}]")
        return "\n".join(out)


def _resolve_objective_name(name: str) -> str:
    key = str(name).strip().lower()
    if key in _OBJECTIVE_ALIASES:
        return _OBJECTIVE_ALIASES[key]
    log.fatal("Unknown objective %s", name)
    return "regression"


def _resolve_metric_name(name: str) -> str:
    key = str(name).strip().lower()
    if key in _METRIC_ALIASES:
        return _METRIC_ALIASES[key]
    log.warning("Unknown metric %s, ignored", name)
    return ""


def _default_metric_for_objective(objective: str) -> List[str]:
    defaults = {
        "regression": ["l2"],
        "regression_l1": ["l1"],
        "huber": ["huber"],
        "fair": ["fair"],
        "poisson": ["poisson"],
        "quantile": ["quantile"],
        "mape": ["mape"],
        "gamma": ["gamma"],
        "tweedie": ["tweedie"],
        "binary": ["binary_logloss"],
        "multiclass": ["multi_logloss"],
        "multiclassova": ["multi_logloss"],
        "cross_entropy": ["cross_entropy"],
        "cross_entropy_lambda": ["cross_entropy_lambda"],
        "lambdarank": ["ndcg"],
        "rank_xendcg": ["ndcg"],
        "custom": [],
    }
    return list(defaults.get(objective, []))
