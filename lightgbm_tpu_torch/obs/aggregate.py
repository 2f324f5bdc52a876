"""Fleet aggregation: group-level metrics merged at iteration
boundaries (the JAX package's obs/aggregate.py).

Per-process registries (obs/registry.py) answer "what did MY rank do";
this module answers "what did the GROUP do" — the per-rank visibility
the reference's `Network::Allreduce` stack never had. At each iteration
boundary every rank packs a small float32 payload (iteration wall,
cumulative collective bytes/calls, fetch p99, live device bytes) and
`network.fleet_allgather` merges it — one all_gather over the default
`torch.distributed` group, the same one `straggler_stats` pays for the
`coll.host_skew` gauge, so turning the fleet plane on adds no extra
blocking sync per iteration.

Rank 0's JSONL records gain a `fleet` object (schema minor 11):
iter-time min/mean/max over ranks, the skew trend (EMA-debiased
direction — a growing skew is a straggler developing, a spike is a
transient), per-rank collective-byte deltas, and a PERSISTENT per-rank
straggler table that generalizes the single `coll.slowest_rank` gauge
(which is kept — the watchdog and schema minors ≤10 read it): how
often each rank was slowest, its EMA iteration time, cumulative bytes.

Single-process runs skip the collective entirely and still emit a
1-rank fleet view, so the record shape is testable in one process.
There is one process-global active aggregator (`activate_aggregator` /
`active_aggregator`) so the /statusz endpoint can render the live
table without threading a handle through the engine.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from .registry import MetricsRegistry

# payload slot order — slot 0 MUST stay the iteration wall so the skew
# math is byte-for-byte what straggler_stats computed before the widen
PAYLOAD_FIELDS = ("iter_s", "coll_bytes", "coll_calls",
                  "fetch_p99_ms", "mem_bytes")

_EMA_ALPHA = 0.3    # per-rank iter-time EMA + skew-trend smoothing


class FleetAggregator:
    """Builds per-rank payloads and folds gathered payloads into the
    pod view. All state is host-side and O(nranks)."""

    def __init__(self) -> None:
        self._prev: Optional[np.ndarray] = None   # cumulative snapshot
        self._skew_ema: Optional[float] = None
        # rank -> {"iter_ema_s", "slowest_count", "coll_bytes"}
        self._table: Dict[int, Dict[str, float]] = {}
        self.last_fleet: Optional[Dict[str, Any]] = None

    # -- payload (every rank) -------------------------------------------
    def local_payload(self, reg: MetricsRegistry,
                      iter_s: float) -> List[float]:
        coll_bytes = 0.0
        coll_calls = 0.0
        for key, v in reg.counters.items():
            if key.startswith("collective.") and key.endswith(".bytes"):
                coll_bytes += v
            elif key.startswith("collective.") and key.endswith(".calls"):
                coll_calls += v
        fetch_p99 = reg.latency_percentile("lat.fetch.device_get", 0.99)
        mem = reg.gauges.get("mem.live_bytes", 0.0)
        return [float(iter_s), coll_bytes, coll_calls,
                float(fetch_p99 or 0.0), float(mem)]

    # -- merge (rank 0; every rank on single-process) ---------------------
    def update(self, gathered: np.ndarray) -> Dict[str, Any]:
        """Fold one (nranks, len(PAYLOAD_FIELDS)) gather into the pod
        view and return the `fleet` record object."""
        gathered = np.asarray(gathered, dtype=np.float64)
        nranks = gathered.shape[0]
        iters = gathered[:, 0]
        mean = float(iters.mean())
        skew = (float((iters.max() - iters.min()) / mean)
                if mean > 0 else 0.0)
        if self._skew_ema is None:
            trend = 0.0
            self._skew_ema = skew
        else:
            trend = skew - self._skew_ema
            self._skew_ema += _EMA_ALPHA * (skew - self._skew_ema)
        slowest = int(iters.argmax())
        deltas = (gathered - self._prev if self._prev is not None
                  and self._prev.shape == gathered.shape
                  else np.zeros_like(gathered))
        self._prev = gathered.copy()

        per_rank = []
        for r in range(nranks):
            row = self._table.setdefault(
                r, {"iter_ema_s": float(iters[r]),
                    "slowest_count": 0, "coll_bytes": 0.0})
            row["iter_ema_s"] += _EMA_ALPHA * (float(iters[r])
                                               - row["iter_ema_s"])
            if r == slowest and nranks > 1:
                row["slowest_count"] += 1
            row["coll_bytes"] = float(gathered[r, 1])
            per_rank.append({
                "rank": r,
                "iter_s": round(float(iters[r]), 6),
                "iter_ema_s": round(row["iter_ema_s"], 6),
                "slowest_count": int(row["slowest_count"]),
                "coll_bytes": int(gathered[r, 1]),
                "coll_bytes_delta": int(max(0.0, deltas[r, 1])),
                "fetch_p99_ms": round(float(gathered[r, 3]), 6),
                "mem_bytes": int(gathered[r, 4]),
            })
        fleet = {
            "ranks": nranks,
            "iter_min_s": round(float(iters.min()), 6),
            "iter_mean_s": round(mean, 6),
            "iter_max_s": round(float(iters.max()), 6),
            "skew": round(skew, 6),
            "skew_trend": round(trend, 6),
            "slowest_rank": slowest,
            "per_rank": per_rank,
        }
        self.last_fleet = fleet
        return fleet

    def step(self, reg: MetricsRegistry, iter_s: float,
             _gather=None) -> Optional[Dict[str, Any]]:
        """One iteration boundary: pack, allgather (the piggybacked
        sync — the only one this plane pays), merge, and set the skew /
        slowest-rank gauges `straggler_stats` used to own. Returns the
        fleet object (all ranks hold it; only rank 0's sink writes
        it)."""
        from ..network import fleet_allgather
        payload = self.local_payload(reg, iter_s)
        gathered = fleet_allgather(payload, _gather=_gather)
        if gathered is None:        # single-process: local-only view
            gathered = np.asarray([payload], dtype=np.float64)
        fleet = self.update(gathered)
        reg.set_gauge("coll.host_skew", fleet["skew"])
        reg.set_gauge("coll.slowest_rank", fleet["slowest_rank"])
        return fleet

    def table(self) -> List[Dict[str, Any]]:
        """Live straggler table for /statusz (copy — handler threads
        must not alias mutable state)."""
        fleet = self.last_fleet
        return [dict(row) for row in fleet["per_rank"]] if fleet else []


# -- process-global active aggregator ------------------------------------
_ACTIVE: Optional[FleetAggregator] = None


def activate_aggregator(agg: FleetAggregator) -> FleetAggregator:
    global _ACTIVE
    _ACTIVE = agg
    return agg


def deactivate_aggregator(agg: Optional[FleetAggregator] = None) -> None:
    global _ACTIVE
    if agg is None or _ACTIVE is agg:
        _ACTIVE = None


def active_aggregator() -> Optional[FleetAggregator]:
    return _ACTIVE
