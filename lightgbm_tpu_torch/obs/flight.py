"""Anomaly-triggered flight recorder: dump the evidence, atomically.

When something goes wrong mid-run — the watchdog trips, a numeric
sentinel trips, or an iteration blows its latency SLO — the state that
explains it (the trace ring, the registry, the fleet table, every
thread's stack) is about to be lost to the crash handler or the next
iteration. This module freezes it: one timestamped bundle directory
under `flight_dir`, written tmp-dir-then-rename so a reader (or a
SIGKILL) can never observe a torn bundle.

The port of the JAX package's obs/flight.py. Triggers:

- **watchdog** — `robust/watchdog.py` `_trip` calls the active
  recorder right after building its diagnosis,
- **sentinel** — `robust/sentinel.py` `_judge` calls it on a trip,
- **slo** — `observe_iteration` fires when an iteration's wall time
  exceeds `flight_slo_factor` × the rolling p50 (window 64, armed
  after 8 samples; factor 0 disables). Breaches always count
  (`slo.breaches`), dumps rate-limit under a cooldown so a persistent
  stall costs one bundle, not one per iteration.

Bundle contents: `manifest.json` (trigger, iteration, config text +
trace_signature), `trace.json` (the last-N-iteration ring as Perfetto
JSON — loads in ui.perfetto.dev), `registry.json` (counters / gauges /
phase times / last record), `fleet.json` (per-rank straggler table,
when the fleet plane is on), `stacks.txt` (all thread stacks).
Summarize one with `python -m lightgbm_tpu_torch trace-report --flight
DIR`.

File writes route through the `sink.write` fault seam, so the same
chaos plans that prove the JSONL sink's failure behaviour prove bundle
atomicity: an injected ENOSPC mid-bundle leaves NO bundle (the tmp dir
is removed), never a partial one. Counters: `flight.dumps`,
`flight.<trigger>`, `flight.failed`, `slo.breaches`.
"""
from __future__ import annotations

import json
import os
import shutil
import sys
import threading
import time
import traceback
from collections import deque
from typing import Any, Dict, Optional

from ..utils import log
from . import registry as _registry
from . import trace as _trace

_SLO_WINDOW = 64       # rolling iteration-wall samples for the p50
_SLO_WARMUP = 8        # samples before the SLO trigger arms
_COOLDOWN_S = 30.0     # min seconds between bundles
_KEEP_BUNDLES = 8      # newest bundles retained in flight_dir


class FlightRecorder:
    """All mutable state is guarded by `_lock`: dumps arrive from the
    training thread (SLO), the watchdog thread (trips) and sentinel
    resolution, concurrently."""

    def __init__(self, flight_dir: str, slo_factor: float = 0.0,
                 context: Optional[Dict[str, Any]] = None,
                 cooldown_s: float = _COOLDOWN_S,
                 clock=time.monotonic) -> None:
        self.flight_dir = flight_dir
        self.slo_factor = float(slo_factor)
        self.context = dict(context or {})
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._iter_walls: deque = deque(maxlen=_SLO_WINDOW)
        self._last_dump_t: Optional[float] = None
        self._seq = 0
        self.dumps = 0
        self.last_bundle: Optional[str] = None

    # -- SLO trigger ------------------------------------------------------
    def observe_iteration(self, iteration: int, wall_s: float) -> None:
        """Feed one iteration wall time; may fire the `slo` trigger."""
        if wall_s <= 0:
            return
        with self._lock:
            samples = sorted(self._iter_walls)
            self._iter_walls.append(wall_s)
        if (self.slo_factor <= 0 or len(samples) < _SLO_WARMUP):
            return
        p50 = samples[len(samples) // 2]
        if wall_s <= self.slo_factor * p50:
            return
        reg = _registry.active()
        if reg is not None:
            reg.inc("slo.breaches")
        self.dump("slo", {"iteration": int(iteration),
                          "wall_s": round(wall_s, 6),
                          "rolling_p50_s": round(p50, 6),
                          "slo_factor": self.slo_factor})

    # -- bundle writer ----------------------------------------------------
    def dump(self, trigger: str, info: Optional[Dict[str, Any]] = None
             ) -> Optional[str]:
        """Write one bundle; returns its path, or None when skipped
        (cooldown) or failed (fault/IO — never raises: the recorder
        must not turn an anomaly into a crash)."""
        now = self._clock()
        with self._lock:
            if (self._last_dump_t is not None
                    and now - self._last_dump_t < self.cooldown_s):
                return None
            self._last_dump_t = now
            self._seq += 1
            seq = self._seq
        stamp = time.strftime("%Y%m%d_%H%M%S")
        name = f"flight_{stamp}_{seq:03d}_{trigger}"
        final = os.path.join(self.flight_dir, name)
        tmp = os.path.join(self.flight_dir, f".tmp_{name}")
        reg = _registry.active()
        try:
            os.makedirs(tmp, exist_ok=True)
            self._write_bundle(tmp, trigger, info, reg)
            os.rename(tmp, final)    # atomic: readers never see a torn dir
        except OSError as exc:
            shutil.rmtree(tmp, ignore_errors=True)
            if reg is not None:
                reg.inc("flight.failed")
            log.warning("flight recorder: bundle %s failed: %s", name, exc)
            return None
        with self._lock:
            self.dumps += 1
            self.last_bundle = final
        if reg is not None:
            reg.inc("flight.dumps")
            reg.inc(f"flight.{trigger}")
        log.warning("flight recorder: %s trigger -> %s", trigger, final)
        self._prune()
        return final

    def _write_bundle(self, tmp: str, trigger: str,
                      info: Optional[Dict[str, Any]],
                      reg: Optional[_registry.MetricsRegistry]) -> None:
        manifest: Dict[str, Any] = {
            "trigger": trigger,
            "wall_time": time.strftime("%Y-%m-%dT%H:%M:%S"),
            "info": info or {},
        }
        manifest.update(self.context)
        tr = _trace.active_tracer()
        if tr is not None:
            self._write(os.path.join(tmp, "trace.json"),
                        json.dumps(tr.to_perfetto()))
            manifest["trace_events"] = len(tr)
        if reg is not None:
            snap = {
                "counters": dict(reg.counters),
                "gauges": dict(reg.gauges),
                "phases": dict(reg.times),
                "last_record": reg.last_record,
                "lat": {k: h.snapshot()
                        for k, h in reg.latency_histograms().items()},
            }
            self._write(os.path.join(tmp, "registry.json"),
                        json.dumps(snap, default=str))
        try:
            from .aggregate import active_aggregator
            agg = active_aggregator()
        except Exception:
            agg = None
        if agg is not None and agg.last_fleet is not None:
            self._write(os.path.join(tmp, "fleet.json"),
                        json.dumps(agg.last_fleet))
        self._write(os.path.join(tmp, "stacks.txt"), _thread_stacks())
        self._write(os.path.join(tmp, "manifest.json"),
                    json.dumps(manifest, indent=1, default=str))

    @staticmethod
    def _write(path: str, text: str) -> None:
        # same seam as the JSONL sink (lazy import mirrors sink.write —
        # obs must stay importable without the robust package): one
        # chaos plan proves both writers' failure behaviour
        from ..robust.faultinject import check_fault
        check_fault("sink.write")
        with open(path, "w") as fh:
            fh.write(text)

    def _prune(self) -> None:
        try:
            bundles = sorted(
                d for d in os.listdir(self.flight_dir)
                if d.startswith("flight_")
                and os.path.isdir(os.path.join(self.flight_dir, d)))
            for stale in bundles[:-_KEEP_BUNDLES]:
                shutil.rmtree(os.path.join(self.flight_dir, stale),
                              ignore_errors=True)
        except OSError:
            pass


def _thread_stacks() -> str:
    """Every thread's stack — the same evidence the watchdog logs at
    trip time, preserved in the bundle."""
    frames = sys._current_frames()
    names = {t.ident: t.name for t in threading.enumerate()}
    out = []
    for ident, frame in frames.items():
        out.append(f"--- thread {names.get(ident, '?')} ({ident}) ---")
        out.append("".join(traceback.format_stack(frame)))
    return "\n".join(out)


# -- process-global active recorder ---------------------------------------
_ACTIVE: Optional[FlightRecorder] = None


def activate_flight(fr: FlightRecorder) -> FlightRecorder:
    global _ACTIVE
    _ACTIVE = fr
    return fr


def deactivate_flight(fr: Optional[FlightRecorder] = None) -> None:
    global _ACTIVE
    if fr is None or _ACTIVE is fr:
        _ACTIVE = None


def active_flight() -> Optional[FlightRecorder]:
    return _ACTIVE
