"""Unified training telemetry: the port of the JAX package's obs/.

Layers:

- `MetricsRegistry` (obs/registry.py): counters / gauges / histograms
  + per-iteration snapshots; one process-global active registry that
  instrumentation reads with a single `is None` check.
- `span` / `instrument_kernel` / `step_span` (obs/spans.py): scopes
  that feed the utils/timer.py table, the registry,
  `torch.profiler.record_function` ranges, and the runtime tracer at
  once.
- `Tracer` (obs/trace.py): bounded ring buffer of phase/sync/memory/
  collective events, exported as a Perfetto-loadable trace.json;
  `obs/report.py` summarizes one (also `python -m lightgbm_tpu_torch
  trace-report`).
- `JsonlSink` + schema validators (obs/sink.py): the JAX package's
  record schema, so each package's validator accepts the other's
  records.
- The group-level plane: `FleetAggregator` (obs/aggregate.py) merges
  per-rank registry deltas over the straggler all_gather; `ObsServer`
  (obs/httpd.py) serves /metrics /healthz /statusz on a localhost
  daemon thread; `FlightRecorder` (obs/flight.py) dumps an atomic
  evidence bundle on watchdog / sentinel / SLO triggers.
- `TelemetrySession` (below): ties registry + sink + profiler + tracer
  + fleet + endpoint + flight recorder to the engine loop, configured
  from `Config` (`metrics_file`, `profile_dir`, `trace_file`,
  `metrics_interval`, `obs_port`, `flight_dir`, `flight_slo_factor`).

A session is **lightweight** when only the live plane is on
(`obs_port` / `flight_dir`, no metrics/profile/trace file): it rides
the pipelined dispatch-ahead loop (engine.py), skipping the
per-iteration stream sync and the model statistics of full telemetry,
which keeps the loop synchronous. `sync_attribution` charges a
trailing read to the iteration that dispatched it.

Everything is off by default: with no active registry, no timer, no
tracer, and no profile dir, the instrumentation fast paths reduce to a
global load per call.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from .aggregate import (FleetAggregator, activate_aggregator,
                        active_aggregator, deactivate_aggregator)
from .flight import (FlightRecorder, activate_flight, active_flight,
                     deactivate_flight)
from .registry import (LatencyHistogram, MetricsRegistry, activate, active,
                       deactivate, inc, set_gauge)
from .sink import (SCHEMA_MINOR, SCHEMA_VERSION, JsonlSink, read_jsonl,
                   validate_bench_record, validate_record)
from .spans import (instrument_kernel, span, start_profiler, step_span,
                    stop_profiler)
from .trace import (Tracer, activate_tracer, active_tracer,
                    deactivate_tracer, install_sync_tracing,
                    live_array_bytes, merge_trace_events, merge_trace_files,
                    sync_attribution, uninstall_sync_tracing)

__all__ = [
    "MetricsRegistry", "LatencyHistogram", "activate", "active",
    "deactivate", "inc", "set_gauge",
    "SCHEMA_VERSION", "SCHEMA_MINOR", "JsonlSink", "read_jsonl",
    "validate_record",
    "validate_bench_record", "span", "step_span", "instrument_kernel",
    "start_profiler", "stop_profiler", "TelemetrySession",
    "Tracer", "activate_tracer", "active_tracer", "deactivate_tracer",
    "install_sync_tracing", "uninstall_sync_tracing", "sync_attribution",
    "live_array_bytes",
    "merge_trace_events", "merge_trace_files",
    "FleetAggregator", "activate_aggregator", "active_aggregator",
    "deactivate_aggregator",
    "FlightRecorder", "activate_flight", "active_flight",
    "deactivate_flight",
]


class TelemetrySession:
    """Per-train() telemetry: activates a registry, opens the JSONL
    sink, optionally starts a torch.profiler trace and/or the runtime
    tracer, and snapshots every iteration. Built by the engine when the
    Config enables any of it; `from_config` returns None otherwise so
    the disabled path costs nothing. `device` is the training device:
    the `mem.*` gauges sample the card's allocator, and are absent on
    the CPU."""

    def __init__(self, metrics_file: str = "", profile_dir: str = "",
                 interval: int = 1,
                 registry: Optional[MetricsRegistry] = None,
                 trace_file: str = "",
                 trace_capacity: int = 262144,
                 obs_port: int = 0,
                 flight_dir: str = "",
                 flight_slo_factor: float = 0.0,
                 fleet: bool = True,
                 flight_context: Optional[Dict[str, Any]] = None,
                 device: str = "cuda") -> None:
        # an already-active registry (a benchmark may activate one for
        # the whole process) keeps accumulating — the session must not
        # shadow it with a fresh one and silently fork the counters
        if registry is None:
            registry = active()
        self.registry = registry if registry is not None else MetricsRegistry()
        self.sink = JsonlSink(metrics_file) if metrics_file else None
        self.interval = max(1, int(interval))
        self.profile_dir = profile_dir
        self.trace_file = trace_file
        self.tracer = Tracer(trace_capacity) if trace_file else None
        # lightweight = live plane only: no stream sync and no model
        # statistics per iteration
        self.lightweight = not (metrics_file or profile_dir or trace_file)
        self.obs_port = int(obs_port or 0)
        self.server = None          # ObsServer, built in start()
        self.fleet_agg = FleetAggregator() if fleet else None
        self.flight = (FlightRecorder(flight_dir, flight_slo_factor,
                                      context=flight_context)
                       if flight_dir else None)
        self._step = None
        self._started = False
        self._prev_registry: Optional[MetricsRegistry] = None
        self._iter_t0_ns = 0
        self._mem_peak = 0
        self._fleet_last: Optional[Dict[str, Any]] = None
        self.device = device
        self.profile_trace: Optional[str] = None    # written at close

    @classmethod
    def from_config(cls, cfg: Any) -> Optional["TelemetrySession"]:
        metrics_file = getattr(cfg, "metrics_file", "") or ""
        profile_dir = getattr(cfg, "profile_dir", "") or ""
        trace_file = getattr(cfg, "trace_file", "") or ""
        obs_port = int(getattr(cfg, "obs_port", 0) or 0)
        flight_dir = getattr(cfg, "flight_dir", "") or ""
        if not metrics_file and not profile_dir and not trace_file \
                and obs_port <= 0 and not flight_dir:
            return None
        flight_context: Optional[Dict[str, Any]] = None
        if flight_dir:
            flight_context = {}
            try:
                flight_context["config"] = cfg.to_params_string()
            except Exception:
                pass
            try:
                from ..compile.signature import _digest, config_signature
                flight_context["trace_signature"] = _digest(
                    config_signature(cfg))
            except Exception:
                pass
        return cls(metrics_file, profile_dir,
                   getattr(cfg, "metrics_interval", 1),
                   trace_file=trace_file,
                   trace_capacity=getattr(cfg, "trace_buffer_events",
                                          262144),
                   obs_port=obs_port,
                   flight_dir=flight_dir,
                   flight_slo_factor=getattr(cfg, "flight_slo_factor", 0.0),
                   fleet=bool(getattr(cfg, "fleet_metrics", True)),
                   flight_context=flight_context,
                   device="cpu" if getattr(cfg, "device_type", "cuda")
                   == "cpu" else "cuda")

    # -- lifecycle ------------------------------------------------------
    def start(self) -> None:
        if self._started:
            return
        self._prev_registry = active()
        activate(self.registry)
        if self.profile_dir:
            start_profiler(self.profile_dir)
        if self.tracer is not None:
            activate_tracer(self.tracer)
        # the sync patch feeds lat.fetch.* histograms even without a
        # tracer (schema minor 11), so every session installs it
        install_sync_tracing()
        if self.fleet_agg is not None:
            activate_aggregator(self.fleet_agg)
        if self.flight is not None:
            activate_flight(self.flight)
        if self.obs_port > 0:
            from .httpd import ObsServer   # imported only when on
            self.server = ObsServer(self.obs_port)
            try:
                self.server.start()
            except OSError as exc:
                from ..utils import log
                log.warning("obs_port=%d: endpoint failed to start (%s); "
                            "training continues without it",
                            self.obs_port, exc)
                self.server = None
        self._started = True

    def begin_iteration(self, iteration: int) -> None:
        self._exit_step()
        self._step = step_span(iteration)
        self._step.__enter__()
        if self.tracer is not None:
            self.tracer.iteration = int(iteration)
            self._iter_t0_ns = self.tracer.now_ns()
        self.registry.begin_iteration(iteration)

    @property
    def sink_disabled(self) -> bool:
        return self.sink is not None and self.sink.disabled

    def record_consumers_active(self) -> bool:
        """False when every consumer of the expensive record extras is
        gone — a metrics-only session whose sink died on an I/O error.
        The engine then skips the per-iteration stream sync + device
        stat fetches instead of formatting payloads that get dropped."""
        return not (self.sink_disabled and self.tracer is None
                    and self.server is None and self.flight is None
                    and not self.profile_dir)

    def end_iteration(self, iteration: int,
                      extra: Optional[Dict[str, Any]] = None
                      ) -> Dict[str, Any]:
        self._sample_environment()
        if self._fleet_last is not None:
            extra = dict(extra) if extra else {}
            extra.setdefault("fleet", self._fleet_last)
        try:
            rec = self.registry.end_iteration(extra=extra)
        finally:
            # a raising registry must not leak the open step annotation
            self._exit_step()
            if self.tracer is not None:
                tr = self.tracer
                tr.complete(f"iteration {iteration}", "iteration",
                            self._iter_t0_ns, tr.now_ns())
                tr.iteration = -1
        if self.sink is not None and iteration % self.interval == 0:
            if self.sink.disabled:
                # short-circuit: count the drop, skip serialization
                self.sink.dropped += 1
                self.registry.inc("sink.dropped_payloads")
            else:
                self.sink.write(rec)
        if self.flight is not None:
            self.flight.observe_iteration(iteration, rec["t_iter_s"])
        return rec

    def _sample_environment(self) -> None:
        """Per-iteration device-memory + collective-shape samples
        (metrics/trace mode only — the disabled path never runs this).
        Gauges land in the registry (schema minor 5 `mem.*` / `coll.*`)
        and, when tracing, as counter events on the timeline."""
        reg = self.registry
        live = live_array_bytes(self.device)
        if live >= 0:
            self._mem_peak = max(self._mem_peak, live)
            reg.set_gauge("mem.live_bytes", live)
            reg.set_gauge("mem.live_peak_bytes", self._mem_peak)
            if self.tracer is not None:
                self.tracer.counter("mem.live_bytes", live, "bytes")
        p99 = reg.coll_p99_ms()
        if p99 is not None:
            reg.set_gauge("coll.p99_ms", round(p99, 3))
        try:
            if self.tracer is not None:
                dt_s = (self.tracer.now_ns() - self._iter_t0_ns) / 1e9
            else:
                import time as _time
                dt_s = _time.perf_counter() - reg._iter_t0
            if self.fleet_agg is not None:
                # the fleet payload rides the allgather straggler_stats
                # used to own — same single blocking sync, wider
                # payload; sets coll.host_skew / coll.slowest_rank (the
                # watchdog still NAMEs the straggler from the gauges,
                # schema minor 8) and yields the per-rank table
                self._fleet_last = self.fleet_agg.step(reg, dt_s)
            else:
                from ..network import straggler_stats
                skew, slowest = straggler_stats(dt_s)
                reg.set_gauge("coll.host_skew", skew)
                reg.set_gauge("coll.slowest_rank", slowest)
        except Exception:
            pass
        if self.tracer is not None:
            reg.counters["trace.events"] = self.tracer.events_total
            reg.counters["trace.dropped"] = self.tracer.dropped

    def close(self) -> None:
        self._exit_step()
        if self.server is not None:
            self.server.stop()
            self.server = None
        if self.flight is not None:
            deactivate_flight(self.flight)
        if self.fleet_agg is not None:
            deactivate_aggregator(self.fleet_agg)
        uninstall_sync_tracing()
        try:
            if self.tracer is not None:
                deactivate_tracer(self.tracer)
                if self.trace_file:
                    try:
                        from ..robust.faultinject import check_fault
                        check_fault("trace.export")
                        self.tracer.export(self.trace_file)
                    except OSError as exc:
                        from ..utils import log
                        log.warning("trace_file=%s: export failed: %s",
                                    self.trace_file, exc)
            if self.profile_dir:
                self.profile_trace = stop_profiler()
        finally:
            if self.sink is not None:
                self.sink.close()
            deactivate(self.registry)
            if self._prev_registry is not None:
                activate(self._prev_registry)
                self._prev_registry = None
            self._started = False

    def _exit_step(self) -> None:
        if self._step is not None:
            self._step.__exit__(None, None, None)
            self._step = None
