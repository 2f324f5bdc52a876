"""Metrics registry: counters / gauges / histograms + per-iteration
snapshots (the JAX package's obs/registry.py, line for line: both
packages fed the same operations produce the same records).

The registry is the single host-side accumulation point for the
observability layer: the learners' dispatcher wrappers
(`obs.spans.instrument_kernel`), collective accounting
(`network.collective_span`), and the training loop all write here, and
the per-iteration snapshot is what the JSONL sink serializes.

Semantics:

- counters are cumulative over the registry's lifetime (monotone),
- gauges are last-write-wins point samples,
- histograms accumulate per ITERATION (reset at `begin_iteration`) and
  snapshot as {count, sum, min, max},
- latency histograms (`observe_latency`, schema minor 11) are
  CUMULATIVE fixed-bucket log-scale distributions with derived
  p50/p90/p99 gauges — the Prometheus-exposable shape the serving
  path will gate on,
- phase times (`add_time`) are cumulative like counters; the snapshot
  reports the per-iteration DELTA of the three core tree phases
  (hist / split / partition) plus the residual `t_other_s`, so the four
  per-phase fields always sum to the iteration wall time exactly.

There is one process-global "active" registry (`activate` / `active`);
instrumentation call sites read it with a single module-attribute load,
so a disabled run pays one `is None` check per instrumented call.
"""
from __future__ import annotations

import bisect
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

# retained latency samples per collective op for the p99 estimate; a
# bounded deque keeps the registry O(1)-memory over arbitrarily long
# runs (the newest samples are the ones a regression gate cares about)
_COLL_LAT_SAMPLES = 4096

# phases with first-class snapshot fields; everything else shows up in
# the snapshot's "phases" map only
CORE_PHASES = ("hist", "split", "partition")

# shared log-scale bucket upper bounds (milliseconds) for every latency
# histogram: 8 buckets per decade from 1 µs to 100 s, ratio 10^(1/8)
# ≈ 1.33 — relative quantile error is bounded by half a bucket ratio
# (~15%), constant memory, and every histogram is mergeable across
# ranks/processes because the edges are fixed at import time
LATENCY_BUCKET_EDGES_MS: Tuple[float, ...] = tuple(
    10.0 ** (e / 8.0) for e in range(-24, 41))


# tpulint: thread-ok(bucket and min/max updates are GIL-atomic; scrape threads tolerate torn reads)
class LatencyHistogram:
    """Fixed-bucket log-scale latency distribution (milliseconds).

    Cumulative over the registry lifetime (Prometheus-histogram
    semantics: monotone bucket counts). Bucket i counts observations
    `v <= LATENCY_BUCKET_EDGES_MS[i]`; one extra overflow bucket
    (`+Inf`) catches the tail. Percentiles interpolate linearly inside
    the owning bucket and clamp to the observed min/max, so small
    sample sets stay honest at the extremes.
    """

    __slots__ = ("counts", "count", "sum", "min", "max")

    def __init__(self) -> None:
        self.counts = [0] * (len(LATENCY_BUCKET_EDGES_MS) + 1)
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def observe(self, ms: float) -> None:
        ms = float(ms)
        self.counts[bisect.bisect_left(LATENCY_BUCKET_EDGES_MS, ms)] += 1
        self.count += 1
        self.sum += ms
        if ms < self.min:
            self.min = ms
        if ms > self.max:
            self.max = ms

    def percentile(self, q: float) -> Optional[float]:
        """q in [0, 1]; None when empty."""
        if self.count == 0:
            return None
        rank = q * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if cum + c >= rank:
                if i == 0:
                    lo = 0.0
                elif i >= len(LATENCY_BUCKET_EDGES_MS):
                    lo = LATENCY_BUCKET_EDGES_MS[-1]
                else:
                    lo = LATENCY_BUCKET_EDGES_MS[i - 1]
                hi = (LATENCY_BUCKET_EDGES_MS[i]
                      if i < len(LATENCY_BUCKET_EDGES_MS) else self.max)
                frac = (rank - cum) / c
                est = lo + (hi - lo) * max(0.0, min(1.0, frac))
                return min(self.max, max(self.min, est))
            cum += c
        return self.max

    def snapshot(self) -> Dict[str, Any]:
        """JSONL shape (schema minor 11): summary stats, the three
        derived percentiles, and the NONZERO buckets as [le_ms, count]
        pairs (cumulative counts would serialize 66 entries per
        histogram per iteration; sparse non-cumulative is equivalent
        information at a fraction of the bytes)."""
        buckets = []
        for i, c in enumerate(self.counts):
            if c:
                le = (LATENCY_BUCKET_EDGES_MS[i]
                      if i < len(LATENCY_BUCKET_EDGES_MS) else float("inf"))
                buckets.append([round(le, 6) if le != float("inf") else "inf",
                                c])
        return {
            "count": self.count,
            "sum_ms": round(self.sum, 6),
            "min_ms": round(self.min, 6),
            "max_ms": round(self.max, 6),
            "p50_ms": round(self.percentile(0.50) or 0.0, 6),
            "p90_ms": round(self.percentile(0.90) or 0.0, 6),
            "p99_ms": round(self.percentile(0.99) or 0.0, 6),
            "buckets": buckets,
        }


# tpulint: thread-ok(single GIL-atomic dict-slot writes; reset() runs between sessions only)
class MetricsRegistry:
    def __init__(self) -> None:
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self.times: Dict[str, float] = {}       # phase -> cumulative seconds
        self._hist: Dict[str, List[float]] = {}  # name -> [cnt, sum, min, max]
        self.last_record: Optional[Dict[str, Any]] = None
        self._iteration: Optional[int] = None
        self._iter_t0 = 0.0
        self._times_at_begin: Dict[str, float] = {}
        # op -> bounded deque of host-latency seconds (schema minor 5)
        self._coll_lat: Dict[str, deque] = {}
        # name -> cumulative log-scale histogram (schema minor 11)
        self._lat: Dict[str, LatencyHistogram] = {}

    # -- accumulation ---------------------------------------------------
    def inc(self, name: str, value: float = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + value

    def set_gauge(self, name: str, value: float) -> None:
        self.gauges[name] = value

    def observe(self, name: str, value: float) -> None:
        h = self._hist.get(name)
        if h is None:
            self._hist[name] = [1, float(value), float(value), float(value)]
        else:
            h[0] += 1
            h[1] += value
            h[2] = min(h[2], value)
            h[3] = max(h[3], value)

    def add_time(self, phase: str, seconds: float) -> None:
        self.times[phase] = self.times.get(phase, 0.0) + seconds

    def observe_latency(self, name: str, ms: float) -> None:
        """Feed one sample into the cumulative log-scale histogram
        `name` (conventionally `lat.phase.<phase>` / `lat.coll.<op>` /
        `lat.fetch.<kind>`). One bisect over 65 fixed edges — cheap
        enough for every span and every device fetch."""
        h = self._lat.get(name)
        if h is None:
            h = self._lat[name] = LatencyHistogram()
        h.observe(ms)

    def latency_percentile(self, name: str, q: float) -> Optional[float]:
        """Percentile (ms) of latency histogram `name`; None when the
        histogram does not exist or is empty."""
        h = self._lat.get(name)
        return h.percentile(q) if h is not None else None

    def latency_histograms(self) -> Dict[str, LatencyHistogram]:
        """Live view for exporters (Prometheus endpoint, fleet payloads
        ); treat as read-only."""
        return self._lat

    def record_collective(self, op: str, nbytes: int, seconds: float,
                          axis: str = "") -> None:
        """One collective dispatch: call count, payload bytes (the bytes
        this rank contributes, as network.STATS counts them), host
        latency. `axis` is the mesh axis the op rides (schema minor 5:
        per-axis byte accounting + per-op latency histograms)."""
        self.inc(f"collective.{op}.calls")
        self.inc(f"collective.{op}.bytes", int(nbytes))
        self.add_time(f"collective.{op}", seconds)
        # per-iteration latency histogram (snapshots into "hists") +
        # bounded cumulative sample set for the session p99
        self.observe(f"coll.{op}.ms", seconds * 1e3)
        self.observe_latency(f"lat.coll.{op}", seconds * 1e3)
        lat = self._coll_lat.get(op)
        if lat is None:
            lat = self._coll_lat[op] = deque(maxlen=_COLL_LAT_SAMPLES)
        lat.append(seconds)
        if axis:
            self.inc(f"coll.axis.{axis}.calls")
            self.inc(f"coll.axis.{axis}.bytes", int(nbytes))

    def coll_p99_ms(self) -> Optional[float]:
        """p99 host latency (ms) over the retained samples of ALL
        collective ops; None when no collective ran."""
        samples: List[float] = []
        for lat in self._coll_lat.values():
            samples.extend(lat)
        if not samples:
            return None
        samples.sort()
        idx = min(len(samples) - 1, int(0.99 * (len(samples) - 1) + 0.5))
        return samples[idx] * 1e3

    # -- iteration lifecycle --------------------------------------------
    def begin_iteration(self, iteration: int,
                        now: Optional[float] = None) -> None:
        """`now` is injectable for deterministic tests."""
        self._iteration = int(iteration)
        self._iter_t0 = time.perf_counter() if now is None else now
        self._times_at_begin = dict(self.times)
        self._hist.clear()

    def end_iteration(self, now: Optional[float] = None,
                      extra: Optional[Dict[str, Any]] = None
                      ) -> Dict[str, Any]:
        """Snapshot the iteration into a schema-versioned record (see
        obs/sink.py for the schema). Keys are emitted sorted so two
        registries fed identical operations produce identical records."""
        from .sink import SCHEMA_MINOR, SCHEMA_VERSION
        t1 = time.perf_counter() if now is None else now
        t_iter = max(0.0, t1 - self._iter_t0)
        # derived latency percentiles land as gauges BEFORE the gauge
        # map is copied into the record, so JSONL, /metrics and the
        # fleet payload all see the same three numbers per histogram
        for name, h in self._lat.items():
            p50 = h.percentile(0.50)
            if p50 is None:
                continue
            self.gauges[f"{name}.p50_ms"] = round(p50, 6)
            self.gauges[f"{name}.p90_ms"] = round(h.percentile(0.90), 6)
            self.gauges[f"{name}.p99_ms"] = round(h.percentile(0.99), 6)
        deltas = {ph: self.times.get(ph, 0.0)
                  - self._times_at_begin.get(ph, 0.0)
                  for ph in CORE_PHASES}
        core = sum(deltas.values())
        rec: Dict[str, Any] = {
            "schema_version": SCHEMA_VERSION,
            "schema_minor": SCHEMA_MINOR,
            "iteration": self._iteration if self._iteration is not None
            else -1,
            "t_iter_s": round(t_iter, 6),
            "t_hist_s": round(deltas["hist"], 6),
            "t_split_s": round(deltas["split"], 6),
            "t_partition_s": round(deltas["partition"], 6),
            "t_other_s": round(max(0.0, t_iter - core), 6),
            "counters": {k: self.counters[k] for k in sorted(self.counters)},
            "gauges": {k: self.gauges[k] for k in sorted(self.gauges)},
        }
        if self.times:
            rec["phases"] = {k: round(self.times[k], 6)
                             for k in sorted(self.times)}
        if self._hist:
            rec["hists"] = {
                k: {"count": int(h[0]), "sum": round(h[1], 6),
                    "min": round(h[2], 6), "max": round(h[3], 6)}
                for k, h in sorted(self._hist.items())}
        if self._lat:
            rec["lat"] = {k: self._lat[k].snapshot()
                          for k in sorted(self._lat)}
        if extra:
            rec.update(extra)
        self.last_record = rec
        self._iteration = None
        return rec

    # -- exports --------------------------------------------------------
    def bench_fields(self) -> Dict[str, Any]:
        """Per-phase breakdown for a benchmark summary line: the three
        core phase totals always (schema-stable), every other recorded
        phase and collective counter when nonzero. Keys never collide
        with the pre-existing bench keys."""
        out: Dict[str, Any] = {}
        for ph in CORE_PHASES:
            out[f"phase_{ph}_s"] = round(self.times.get(ph, 0.0), 3)
        for ph in sorted(self.times):
            if ph in CORE_PHASES or ph.startswith("collective."):
                continue
            if self.times[ph] > 0:
                out[f"phase_{ph}_s"] = round(self.times[ph], 3)
        for key in sorted(self.counters):
            if key.startswith(("collective.", "kernel.", "compile.",
                               "eval.", "hist.", "coll.", "trace.",
                               "ckpt.", "fault.", "pipeline.",
                               "watchdog.", "health.", "flight.",
                               "slo.", "sink.")):
                v = self.counters[key]
                out[key.replace(".", "_")] = int(v) if v == int(v) else v
        return out

    def reset(self) -> None:
        self.counters.clear()
        self.gauges.clear()
        self.times.clear()
        self._hist.clear()
        self._coll_lat.clear()
        self._lat.clear()
        self.last_record = None
        self._iteration = None


# -- process-global active registry -------------------------------------
_ACTIVE: Optional[MetricsRegistry] = None


def activate(reg: MetricsRegistry) -> MetricsRegistry:
    global _ACTIVE
    _ACTIVE = reg
    return reg


def deactivate(reg: Optional[MetricsRegistry] = None) -> None:
    """Deactivate the active registry (or only `reg`, when given and
    still active — lets nested sessions unwind safely)."""
    global _ACTIVE
    if reg is None or _ACTIVE is reg:
        _ACTIVE = None


def active() -> Optional[MetricsRegistry]:
    return _ACTIVE


def inc(name: str, value: float = 1) -> None:
    """`inc` on the active registry; a no-op when telemetry is off."""
    reg = _ACTIVE
    if reg is not None:
        reg.inc(name, value)


def set_gauge(name: str, value: float) -> None:
    """`set_gauge` on the active registry; a no-op when telemetry is
    off."""
    reg = _ACTIVE
    if reg is not None:
        reg.set_gauge(name, value)
