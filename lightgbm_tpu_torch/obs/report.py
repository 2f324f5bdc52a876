"""Trace-report: summarize a runtime trace.json (obs/trace.py); the
JAX package's obs/report.py, so both print the same report for the same
trace file.

Answers the three questions a timeline is for, without opening the
Perfetto UI:

- where did the time go? — top-N slowest phase spans and per-phase
  totals,
- where did the host block? — top-N slowest sync events, grouped by
  attributed call site so one noisy site reads as one line,
- what did the interconnect do? — per-op collective count / total ms /
  max ms.

Plus the acceptance gauge: per-iteration *phase coverage*, the share of
each iteration window covered by the union of its phase intervals
(union-of-intervals, so nested/overlapping spans don't double-count).

CLI: `python -m lightgbm_tpu_torch trace-report <trace.json> [--top N]`.
Multi-rank extras:

- `trace-report --merge r0.json r1.json ... [--out merged.json]` folds
  per-rank traces into one Perfetto document (rank r => pid r) and then
  summarizes the merge,
- `trace-report --flight <dir>` summarizes a flight-recorder bundle
  (or picks the newest bundle inside a flight_dir): trigger, registry
  headline counters, and the embedded trace's report.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple


def load_trace(path: str) -> List[Dict[str, Any]]:
    """The traceEvents list of a Chrome/Perfetto trace.json (also
    accepts the bare-array form)."""
    with open(path) as fh:
        doc = json.load(fh)
    if isinstance(doc, list):
        return doc
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        raise ValueError(f"{path}: no traceEvents array")
    return events


def _complete(events: Sequence[Dict[str, Any]],
              cat: str) -> List[Dict[str, Any]]:
    return [e for e in events
            if e.get("ph") == "X" and e.get("cat") == cat]


def _union_us(intervals: List[Tuple[float, float]]) -> float:
    """Total length of the union of [t0, t1] intervals (µs)."""
    if not intervals:
        return 0.0
    intervals.sort()
    total = 0.0
    cur0, cur1 = intervals[0]
    for t0, t1 in intervals[1:]:
        if t0 > cur1:
            total += cur1 - cur0
            cur0, cur1 = t0, t1
        else:
            cur1 = max(cur1, t1)
    return total + (cur1 - cur0)


def iteration_coverage(events: Sequence[Dict[str, Any]]
                       ) -> Dict[int, float]:
    """iteration -> fraction of its window covered by the union of the
    phase intervals inside it. This is the acceptance gauge: >= 0.95
    means at most 5% of each iteration is unattributed host time."""
    windows: Dict[int, Tuple[float, float]] = {}
    for e in _complete(events, "iteration"):
        it = (e.get("args") or {}).get("iteration")
        if isinstance(it, int):
            ts = float(e["ts"])
            windows[it] = (ts, ts + float(e.get("dur", 0.0)))
    spans: Dict[int, List[Tuple[float, float]]] = {it: [] for it in windows}
    for e in _complete(events, "phase"):
        it = (e.get("args") or {}).get("iteration")
        if it in spans:
            t0, t1 = windows[it]
            s0 = max(t0, float(e["ts"]))
            s1 = min(t1, float(e["ts"]) + float(e.get("dur", 0.0)))
            if s1 > s0:
                spans[it].append((s0, s1))
    out: Dict[int, float] = {}
    for it, (t0, t1) in windows.items():
        dur = t1 - t0
        out[it] = (_union_us(spans[it]) / dur) if dur > 0 else 1.0
    return out


def _top(events: List[Dict[str, Any]], n: int) -> List[Dict[str, Any]]:
    return sorted(events, key=lambda e: -float(e.get("dur", 0.0)))[:n]


def _group_totals(events: Sequence[Dict[str, Any]]
                  ) -> List[Tuple[str, int, float, float]]:
    """(name, count, total_ms, max_ms) per event name, slowest first."""
    acc: Dict[str, List[float]] = {}
    for e in events:
        dur_ms = float(e.get("dur", 0.0)) / 1e3
        g = acc.setdefault(e.get("name", "?"), [0, 0.0, 0.0])
        g[0] += 1
        g[1] += dur_ms
        g[2] = max(g[2], dur_ms)
    return sorted(((name, int(g[0]), g[1], g[2])
                   for name, g in acc.items()),
                  key=lambda row: -row[2])


def summarize(events: Sequence[Dict[str, Any]],
              top_n: int = 10) -> Dict[str, Any]:
    phases = _complete(events, "phase")
    syncs = _complete(events, "sync")
    colls = _complete(events, "collective")
    cov = iteration_coverage(events)
    return {
        "iterations": len(cov),
        "coverage_min": min(cov.values()) if cov else None,
        "coverage_mean": (sum(cov.values()) / len(cov)) if cov else None,
        "phase_totals": _group_totals(phases)[:top_n],
        "top_phases": _top(phases, top_n),
        "sync_totals": _group_totals(syncs)[:top_n],
        "top_syncs": _top(syncs, top_n),
        "collective_totals": _group_totals(colls)[:top_n],
        "n_events": len(events),
    }


def format_report(summary: Dict[str, Any], path: str = "") -> str:
    lines: List[str] = []
    if path:
        lines.append(f"trace report: {path}")
    lines.append(f"events: {summary['n_events']}  "
                 f"iterations: {summary['iterations']}")
    if summary["coverage_min"] is not None:
        lines.append(f"phase coverage: min {summary['coverage_min']:.1%}  "
                     f"mean {summary['coverage_mean']:.1%}")

    def table(title: str, rows: List[Tuple[str, int, float, float]]) -> None:
        if not rows:
            return
        lines.append("")
        lines.append(title)
        width = max(len(r[0]) for r in rows)
        lines.append(f"  {'name':<{width}}  {'calls':>7} "
                     f"{'total_ms':>10} {'max_ms':>9}")
        for name, cnt, total, mx in rows:
            lines.append(f"  {name:<{width}}  {cnt:>7} "
                         f"{total:>10.3f} {mx:>9.3f}")

    table("slowest phases (by total time):", summary["phase_totals"])
    table("slowest host syncs (by total time, grouped by site):",
          summary["sync_totals"])
    table("collectives:", summary["collective_totals"])
    return "\n".join(lines)


def find_bundle(path: str) -> str:
    """Resolve a flight bundle directory: either ``path`` itself (it
    holds a manifest.json) or the newest ``flight_*`` bundle inside a
    flight_dir."""
    if os.path.isfile(os.path.join(path, "manifest.json")):
        return path
    bundles = sorted(
        d for d in (os.path.join(path, n) for n in os.listdir(path))
        if os.path.basename(d).startswith("flight_")
        and os.path.isfile(os.path.join(d, "manifest.json")))
    if not bundles:
        raise ValueError(f"{path}: no flight bundle (manifest.json) found")
    return bundles[-1]


def format_flight_report(bundle: str, top_n: int = 10) -> str:
    """Human summary of one flight-recorder bundle (obs/flight.py)."""
    def _load(name: str) -> Any:
        p = os.path.join(bundle, name)
        if not os.path.isfile(p):
            return None
        with open(p) as fh:
            return json.load(fh)

    manifest = _load("manifest.json") or {}
    registry = _load("registry.json") or {}
    fleet = _load("fleet.json")
    lines = [f"flight bundle: {bundle}",
             f"trigger: {manifest.get('trigger', '?')}"]
    info = manifest.get("info") or {}
    if info:
        detail = ", ".join(f"{k}={v}" for k, v in sorted(info.items())
                           if not isinstance(v, (dict, list)))
        if detail:
            lines.append(f"info: {detail}")
    counters = registry.get("counters") or {}
    head = [k for k in ("watchdog.trips", "health.sentinel_trips",
                        "slo.breaches", "flight.dumps", "sink.dropped_payloads")
            if k in counters]
    if head:
        lines.append("counters: " + "  ".join(
            f"{k}={counters[k]:g}" for k in head))
    last = registry.get("last_record") or {}
    if last.get("iteration") is not None:
        lines.append(f"last iteration: {last['iteration']}  "
                     f"t_iter_s: {last.get('t_iter_s', float('nan')):.4g}")
    if isinstance(fleet, dict) and fleet.get("ranks"):
        lines.append(
            f"fleet: {fleet['ranks']} rank(s)  skew {fleet['skew']:.3g}  "
            f"slowest rank {fleet['slowest_rank']}")
    trace_path = os.path.join(bundle, "trace.json")
    if os.path.isfile(trace_path):
        try:
            events = load_trace(trace_path)
            lines.append("")
            lines.append(format_report(summarize(events, top_n=top_n),
                                       path=trace_path))
        except (OSError, ValueError, json.JSONDecodeError) as exc:
            lines.append(f"trace.json unreadable: {exc}")
    return "\n".join(lines)


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m lightgbm_tpu_torch trace-report",
        description="Summarize a runtime trace.json "
                    "(train with trace_file=... to produce one).")
    parser.add_argument("trace", nargs="*",
                        help="path to trace.json (several with --merge)")
    parser.add_argument("--top", type=int, default=10,
                        help="rows per table (default 10)")
    parser.add_argument("--merge", action="store_true",
                        help="merge per-rank traces (rank r => pid r), "
                             "write --out, then summarize the merge")
    parser.add_argument("--out", default="merged_trace.json",
                        help="merged trace output path (default "
                             "merged_trace.json)")
    parser.add_argument("--flight", metavar="DIR",
                        help="summarize a flight-recorder bundle (or the "
                             "newest bundle inside a flight_dir)")
    ns = parser.parse_args(argv)
    if ns.flight:
        try:
            print(format_flight_report(find_bundle(ns.flight), top_n=ns.top))
        except (OSError, ValueError, json.JSONDecodeError) as exc:
            print(f"error: {exc}")
            return 2
        return 0
    if ns.merge:
        if len(ns.trace) < 2:
            parser.error("--merge needs two or more per-rank traces")
        from .trace import merge_trace_files
        try:
            doc = merge_trace_files(ns.trace, ns.out)
        except (OSError, ValueError, json.JSONDecodeError) as exc:
            print(f"error: {exc}")
            return 2
        print(f"merged {len(ns.trace)} rank traces -> {ns.out}")
        print(format_report(summarize(doc["traceEvents"], top_n=ns.top),
                            path=ns.out))
        return 0
    if len(ns.trace) != 1:
        parser.error("expected exactly one trace.json "
                     "(or --merge / --flight)")
    try:
        events = load_trace(ns.trace[0])
    except (OSError, ValueError, json.JSONDecodeError) as exc:
        print(f"error: {exc}")
        return 2
    print(format_report(summarize(events, top_n=ns.top), path=ns.trace[0]))
    return 0
