"""Schema-versioned JSONL sink + validators (the JAX package's
obs/sink.py: the same schema, version and minor, so each package's
validator accepts the other's records).

One JSON object per line, one line per (sampled) boosting iteration.
The schema is additive-only within a version: consumers must tolerate
unknown keys; removing or retyping a key bumps SCHEMA_VERSION.

Iteration record (v1.2):

  required: schema_version (int), iteration (int >= 0), t_iter_s,
            t_hist_s, t_split_s, t_partition_s, t_other_s (numbers,
            >= 0; the four phase fields sum to t_iter_s),
            counters (object of numbers), gauges (object of numbers)
  optional: schema_minor (int; additive revision within the version —
            minor 1 adds the AOT compile-manager fields: "compile.*"
            cache hit/miss/store counters and "eval.*" device-reduction
            counters under `counters`, the "compile"/"aot_load"/
            "aot_serialize" phase timers under `phases`, and "aot_*"
            manager gauges under `gauges`; minor 2 adds the
            quantized-gradient pipeline fields: "hist.quant_*"
            counters under `counters` — requantize passes, packed
            collective bytes moved, per-leaf overflow escalations —
            and the "hist.quant_bins" gauge under `gauges`; minor 3
            adds the tpulint static-analysis gauges "lint.findings" /
            "lint.baseline_size" under `gauges` and the
            "hot_loop_syncs" bench summary field; minor 4 adds the
            per-pack meshlint gauges "lint.mesh_findings" /
            "lint.tile_findings" / "lint.dtype_findings" under
            `gauges` — collective-axis, kernel-contract, and
            dtype-flow finding counts; minor 5 adds the runtime trace
            timeline fields (obs/trace.py): "trace.*" ring-buffer
            counters under `counters` — trace.events / trace.dropped —
            "mem.*" gauges under `gauges` — mem.live_bytes /
            mem.live_peak_bytes live-array HBM samples and
            mem.planar_state_bytes planar-state estimate — per-op
            "coll.{op}.ms" latency entries under `hists`, per-axis
            "coll.axis.*" counters, and the "coll.host_skew" /
            "coll.p99_ms" gauges, plus the trace_file /
            mem_peak_bytes / coll_p99_ms bench summary fields),
            phases (object: cumulative seconds per phase),
            hists (object: {count, sum, min, max}),
            lat (object, minor 11: cumulative log-scale latency
            histograms — {count, sum_ms, min_ms, max_ms, p50_ms,
            p90_ms, p99_ms, buckets: [[le_ms | "inf", count], ...]}),
            fleet (object, minor 11: pod-level view merged by
            obs/aggregate.py — ranks, iter_min/mean/max_s, skew,
            skew_trend, slowest_rank, per_rank straggler table;
            minor 12 adds the per-pack lifelint gauges
            "lint.life_findings" / "lint.thread_findings" under
            `gauges` — buffer-lifetime and thread-shared-state
            finding counts),
            metrics (object: "<dataset>/<metric>" -> number),
            num_leaves (int), best_gain (number)

`validate_bench_record` covers a benchmark summary line (artifacts that
wrap it under a "parsed" key are accepted too).

Some fields name subsystems the port does not have (the compile
manager's "compile.*" / "aot_*", the static-analysis "lint.*" gauges,
the pipelined loop's "pipeline.*"): they are part of the shared schema
and simply absent from the port's records.
"""
from __future__ import annotations

import json
import threading
from typing import Any, Dict, List

SCHEMA_VERSION = 1
# additive revision within SCHEMA_VERSION (see module docstring); bumped
# to 1 when the compile-manager counters/timers joined the record, to 2
# when the quantized-gradient hist.quant_* counters/gauges joined, to 3
# when the tpulint lint.* gauges and hot_loop_syncs bench field joined,
# to 4 when the per-pack meshlint lint.{mesh,tile,dtype}_findings
# gauges joined, to 5 when the runtime trace timeline fields joined
# (trace.* counters, mem.* gauges, coll.* latency/axis accounting), to
# 6 when the fault-tolerance counters joined (ckpt.saves / ckpt.bytes /
# ckpt.write_errors / ckpt.resume / ckpt.invalid and fault.fired /
# fault.<seam> from robust/), to 7 when the async-pipeline counters
# joined (pipeline.inflight_fetches / pipeline.delayed_stop_iters /
# pipeline.donated_bytes under `counters`, the "stop_check" phase
# timer, and the overlap_share / blocking_syncs_per_iter bench summary
# fields), to 8 when the self-healing fields joined (watchdog.trips /
# watchdog.stall_<class> / watchdog.auto_resume and health.checks /
# health.sentinel_trips / health.nan / health.overflow /
# health.quarantined / health.rollbacks / health.degraded /
# health.quant_tripwire under `counters`, the "coll.slowest_rank"
# gauge, and the "sentinel" phase timer), to 9 when the compiled-
# program accounting joined (compile.programs distinct-program
# counter, compile.lowering_s cumulative trace+lower seconds, and
# compile.hlo_bytes lowered-module size of the persisted programs
# (sub-LGBM_TPU_AOT_MIN_COMPILE_S compiles skip the stat) under
# `counters`, plus the
# compile_programs / compile_lowering_s / compile_hlo_bytes bench
# summary fields), to 10 when the multi-value histogram layout fields
# joined (hist.multival_rows packed-row counter and the
# hist.layout_planar / hist.layout_multival dispatch counters under
# `counters`, the hist.row_nnz_mean occupancy gauge, plus the
# row_nnz_mean / hist_layout bench summary fields), to 11 when the
# pod-scale observability plane joined (the `lat` latency-histogram
# object with derived "lat.*.p{50,90,99}_ms" gauges, the `fleet`
# per-rank object, the flight.dumps / flight.<trigger> /
# flight.failed / slo.breaches / sink.dropped_payloads counters, plus
# the iter_p99_s / fetch_p99_ms / obs_overhead_pct bench summary
# fields), to 12 when the lifelint packs joined (the per-pack
# lint.life_findings / lint.thread_findings gauges under `gauges` —
# buffer-lifetime and thread-shared-state finding counts, matching the
# minor-4 meshlint per-pack gauges)
SCHEMA_MINOR = 12

_REQUIRED_NUM = ("t_iter_s", "t_hist_s", "t_split_s", "t_partition_s",
                 "t_other_s")
_BENCH_REQUIRED = {"metric": str, "value": (int, float), "unit": str,
                   "vs_baseline": (int, float)}
_BENCH_OPTIONAL_NUM = ("vs_baseline_with_compile", "compile_s", "rows",
                       "iters", "test_auc", "test_auc_bayes_ceiling",
                       "predict_us_per_row", "example_auc",
                       "example_auc_reference_measured",
                       "warm_start", "aot_cache_hits", "aot_cache_misses",
                       "aot_store_loads", "aot_compile_s",
                       # quantized-gradient pipeline (schema minor 2)
                       "quantized", "num_grad_quant_bins",
                       "iter_p50_s", "iter_p90_s", "hist_share",
                       # static hot-loop sync inventory (schema minor 3)
                       "hot_loop_syncs",
                       # runtime trace timeline (schema minor 5)
                       "mem_peak_bytes", "coll_p99_ms",
                       # async pipelined iteration (schema minor 7)
                       "overlap_share", "blocking_syncs_per_iter",
                       # compiled-program accounting (schema minor 9)
                       "compile_programs", "compile_lowering_s",
                       "compile_hlo_bytes",
                       # multival layout occupancy (schema minor 10)
                       "row_nnz_mean",
                       # pod-scale observability plane (schema minor 11)
                       "iter_p99_s", "fetch_p99_ms", "obs_overhead_pct")
# optional string-typed bench keys (minor 2): histogram kernel variant;
# (minor 5): runtime trace output path; (minor 10): histogram layout
# decision ("planar" | "multival")
_BENCH_OPTIONAL_STR = ("hist_method", "trace_file", "hist_layout")


def _num_map_problems(rec: Dict[str, Any], key: str,
                      required: bool) -> List[str]:
    if key not in rec:
        return [f"missing {key!r}"] if required else []
    v = rec[key]
    if not isinstance(v, dict):
        return [f"{key!r} must be an object, got {type(v).__name__}"]
    return [f"{key}[{k!r}] must be a number"
            for k, x in v.items()
            if not isinstance(x, (int, float)) or isinstance(x, bool)]


def validate_record(rec: Any) -> List[str]:
    """Problems with one iteration record ([] = valid)."""
    if not isinstance(rec, dict):
        return ["record must be a JSON object"]
    problems: List[str] = []
    sv = rec.get("schema_version")
    if not isinstance(sv, int):
        problems.append("missing/non-int 'schema_version'")
    elif sv > SCHEMA_VERSION:
        problems.append(f"schema_version {sv} is newer than supported "
                        f"{SCHEMA_VERSION}")
    if "schema_minor" in rec and (not isinstance(rec["schema_minor"], int)
                                  or isinstance(rec["schema_minor"], bool)):
        problems.append("'schema_minor' must be an int")
    it = rec.get("iteration")
    if not isinstance(it, int) or isinstance(it, bool) or it < 0:
        problems.append("'iteration' must be an int >= 0")
    for key in _REQUIRED_NUM:
        v = rec.get(key)
        if not isinstance(v, (int, float)) or isinstance(v, bool):
            problems.append(f"'{key}' must be a number")
        elif v < 0:
            problems.append(f"'{key}' must be >= 0, got {v}")
    if not problems:
        phase_sum = (rec["t_hist_s"] + rec["t_split_s"]
                     + rec["t_partition_s"] + rec["t_other_s"])
        # the residual construction makes these equal; 10% tolerance
        # admits records produced by external tools that measured the
        # phases independently
        if phase_sum > rec["t_iter_s"] * 1.1 + 1e-6:
            problems.append(
                f"phase times sum to {phase_sum:.6f}s > 110% of "
                f"t_iter_s={rec['t_iter_s']:.6f}s")
    problems += _num_map_problems(rec, "counters", required=True)
    problems += _num_map_problems(rec, "gauges", required=True)
    problems += _num_map_problems(rec, "phases", required=False)
    problems += _num_map_problems(rec, "metrics", required=False)
    if "hists" in rec:
        if not isinstance(rec["hists"], dict):
            problems.append("'hists' must be an object")
        else:
            for k, h in rec["hists"].items():
                if not isinstance(h, dict) or \
                        not all(isinstance(h.get(f), (int, float))
                                for f in ("count", "sum", "min", "max")):
                    problems.append(f"hists[{k!r}] must have numeric "
                                    "count/sum/min/max")
    if "lat" in rec:
        if not isinstance(rec["lat"], dict):
            problems.append("'lat' must be an object")
        else:
            for k, h in rec["lat"].items():
                if not isinstance(h, dict) or \
                        not all(isinstance(h.get(f), (int, float))
                                for f in ("count", "sum_ms", "p50_ms",
                                          "p90_ms", "p99_ms")):
                    problems.append(f"lat[{k!r}] must have numeric "
                                    "count/sum_ms/p50_ms/p90_ms/p99_ms")
                    continue
                buckets = h.get("buckets", [])
                if not isinstance(buckets, list) or not all(
                        isinstance(b, list) and len(b) == 2
                        and (isinstance(b[0], (int, float)) or b[0] == "inf")
                        and isinstance(b[1], int)
                        for b in buckets):
                    problems.append(f"lat[{k!r}].buckets must be "
                                    "[le_ms|\"inf\", count] pairs")
    if "fleet" in rec:
        fl = rec["fleet"]
        if not isinstance(fl, dict):
            problems.append("'fleet' must be an object")
        else:
            for f in ("ranks", "iter_min_s", "iter_mean_s", "iter_max_s",
                      "skew", "skew_trend", "slowest_rank"):
                if not isinstance(fl.get(f), (int, float)) or \
                        isinstance(fl.get(f), bool):
                    problems.append(f"fleet.{f} must be a number")
            pr = fl.get("per_rank")
            if not isinstance(pr, list) or not all(
                    isinstance(row, dict)
                    and isinstance(row.get("rank"), int)
                    and isinstance(row.get("iter_s"), (int, float))
                    and isinstance(row.get("slowest_count"), int)
                    for row in pr):
                problems.append("fleet.per_rank must be a list of "
                                "{rank, iter_s, slowest_count, ...} rows")
    return problems


def validate_bench_record(rec: Any) -> List[str]:
    """Problems with one benchmark summary line ([] = valid).
    Artifacts that wrap the line under "parsed" are accepted too."""
    if isinstance(rec, dict) and "parsed" in rec:
        if rec["parsed"] is None:
            # wrapper for a run that produced no summary line (rc/tail
            # describe the failure) — nothing to validate
            return []
        rec = rec["parsed"]
    if not isinstance(rec, dict):
        return ["bench record must be a JSON object"]
    problems = []
    for key, tp in _BENCH_REQUIRED.items():
        if key not in rec:
            # the nothing-completed emergency line carries only
            # metric/value/unit/vs_baseline — all four ARE required
            problems.append(f"missing {key!r}")
        elif not isinstance(rec[key], tp) or isinstance(rec[key], bool):
            problems.append(f"{key!r} must be {tp}")
    for key in _BENCH_OPTIONAL_NUM:
        if key in rec and (not isinstance(rec[key], (int, float))
                           or isinstance(rec[key], bool)):
            problems.append(f"{key!r} must be a number")
    for key in _BENCH_OPTIONAL_STR:
        if key in rec and not isinstance(rec[key], str):
            problems.append(f"{key!r} must be a string")
    for key, v in (rec.items() if isinstance(rec, dict) else ()):
        if key.startswith("phase_") and (not isinstance(v, (int, float))
                                         or isinstance(v, bool)):
            problems.append(f"{key!r} must be a number")
    return problems


class JsonlSink:
    """Append-mode JSONL writer, flushed per line so a killed run keeps
    every completed iteration.

    Telemetry must never take down training: any OSError (disk full,
    permissions, injected fault) disables the sink with ONE warning and
    every later write is a no-op. Callers that assemble expensive
    payloads should consult `disabled` FIRST (TelemetrySession does) —
    a disabled sink still counts the writes it would have taken in
    `dropped`, so silently lost telemetry shows up as the
    `sink.dropped_payloads` counter instead of a mystery gap."""

    def __init__(self, path: str) -> None:
        self.path = path
        self.dropped = 0
        # watchdog trips and flight-recorder dumps write from their own
        # threads; RLock because the write() error path calls _disable()
        self._lock = threading.RLock()
        try:
            self._fh = open(path, "w")
        except OSError as exc:
            self._fh = None
            self._disable(exc)

    @property
    def disabled(self) -> bool:
        return self._fh is None

    def _disable(self, exc: BaseException) -> None:
        from ..utils import log
        log.warning("Metrics sink %s disabled after I/O error (%s); "
                    "training continues without JSONL metrics",
                    self.path, exc)
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None

    def write(self, record: Dict[str, Any]) -> None:
        # the `sink.write` fault seam (robust/faultinject.py) runs
        # before the write, so an injected ENOSPC disables the sink
        # exactly as a full disk does
        with self._lock:
            if self._fh is None:
                self.dropped += 1
                return
            try:
                from ..robust.faultinject import check_fault
                check_fault("sink.write")
                self._fh.write(json.dumps(record) + "\n")
                self._fh.flush()
            except OSError as exc:
                self._disable(exc)

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None


def read_jsonl(path: str) -> List[Dict[str, Any]]:
    out = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out
