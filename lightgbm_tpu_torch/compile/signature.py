"""The signature of a training configuration (the JAX package's
compile/signature.py ``config_signature``, ``_digest`` and
``_IGNORED_CONFIG_FIELDS``): every Config field except pure I/O,
logging, observability and fault-tolerance ones, digested to 20 hex
characters. A checkpoint carries the digest of the config that wrote
it (robust/checkpoint.py), and a resume under another digest is
refused. ``device_type`` is part of it, as the JAX package's
``device_type`` is: a checkpoint written on the card is refused by a
resume on the CPU. ``bucket_min_rows`` is the row count from which the
warm-up runs by default (compile/warmup.py ``warmup_wanted``). The row
buckets, environment key and cache keys of that module size and name
XLA executables, which the port does not have."""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Any, Dict

_IGNORED_CONFIG_FIELDS = frozenset({
    # pure I/O, logging, and observability — never part of the program
    "data", "valid", "input_model", "output_model", "output_result",
    "convert_model", "convert_model_language", "initscore_filename",
    "valid_data_initscores", "forcedsplits_filename", "forcedbins_filename",
    "save_binary", "snapshot_freq", "header", "label_column",
    "weight_column", "group_column", "ignore_column", "categorical_feature",
    "two_round", "machines", "machine_list_filename", "time_out",
    "verbosity", "metrics_file", "profile_dir", "metrics_interval",
    "trace_file", "trace_buffer_events",
    "timetag", "tpu_warmup", "extra", "task", "data_random_seed",
    "metric_freq", "is_provide_training_metric",
    "eval_at", "num_machines", "local_listen_port",
    # fault tolerance: where and how often checkpoints land, so a resume
    # with another checkpoint_dir keeps the digest
    "checkpoint_dir", "checkpoint_interval", "checkpoint_keep",
    # self-healing: the watchdog is host-side and the sentinel's limit a
    # runtime operand
    "hang_timeout", "auto_resume", "auto_resume_attempts",
    "numeric_sentinels", "sentinel_overflow_limit", "sentinel_max_trips",
    # the observability plane is host-side
    "obs_port", "flight_dir", "flight_slo_factor", "fleet_metrics",
})


def _jsonable(v: Any) -> Any:
    """Canonical JSON-friendly form of a signature component."""
    if isinstance(v, (str, int, bool)) or v is None:
        return v
    if isinstance(v, float):
        return repr(v)  # exact round-trip, no 0.1 drift
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(v[k]) for k in sorted(v, key=str)}
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return {f.name: _jsonable(getattr(v, f.name))
                for f in dataclasses.fields(v)}
    if hasattr(v, "shape") and hasattr(v, "dtype"):
        return ["aval", list(v.shape), str(v.dtype)]
    return repr(v)


def _digest(obj: Any) -> str:
    payload = json.dumps(_jsonable(obj), sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(payload.encode()).hexdigest()[:20]


def config_signature(config: Any) -> Dict[str, Any]:
    """Every Config field except the ignored ones. Unknown fields stay
    in: over-inclusion only refuses more checkpoints."""
    out = {}
    for f in dataclasses.fields(config):
        if f.name in _IGNORED_CONFIG_FIELDS:
            continue
        out[f.name] = _jsonable(getattr(config, f.name))
    return out


def bucket_min_rows() -> int:
    """``LGBM_TPU_BUCKET_MIN`` (default 2^20 rows): the training size
    from which the warm-up starts without being asked."""
    try:
        return int(os.environ.get("LGBM_TPU_BUCKET_MIN", 1 << 20))
    except ValueError:
        return 1 << 20
