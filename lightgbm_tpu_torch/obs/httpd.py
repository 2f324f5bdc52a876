"""Live observability endpoint: /metrics, /healthz, /statusz (the JAX
package's obs/httpd.py).

A stdlib `http.server` on a daemon thread (`obs_port=` param /
`--obs-port` CLI; off by default — a run without the param never
constructs a socket, imports nothing here, and pays zero overhead).
Three routes:

- `/metrics` — Prometheus text exposition format (version 0.0.4):
  registry counters as `counter`, gauges as `gauge`, and the schema
  minor 11 latency histograms as native `histogram` families with
  cumulative `le` buckets, `_sum` and `_count`.
- `/healthz` — liveness for probes: watchdog heartbeat age + trip
  state (503 once tripped), sentinel trip / quarantine counters, and
  the degraded-ladder rung (robust/sentinel.py).
- `/statusz` — one JSON page for humans: iteration progress, core
  phase coverage, pipeline `overlap_share` (when a pipelined loop sets
  it), the `compile` block (the kernel libraries built and found by
  their hash and the build seconds, compile/manager.py), and the fleet
  straggler table (obs/aggregate.py).

Security: binds 127.0.0.1 by default — the pages expose host names,
file paths and config text, so widening the bind
(`LGBM_TPU_OBS_BIND=0.0.0.0`) is an explicit operator decision, never
a default.

Handlers READ process-global actives (registry / watchdog / fleet
aggregator) at request time and copy what they render — no locks of
their own, no mutation, so a request can never perturb the training
loop beyond the GIL. The server thread only ever blocks in `accept()`
and touches no tensor, so it can never wait on the device.
"""
from __future__ import annotations

import http.server
import json
import os
import socketserver
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from ..utils import log
from . import registry as _registry
from .registry import LATENCY_BUCKET_EDGES_MS, MetricsRegistry

BIND_ENV = "LGBM_TPU_OBS_BIND"
_PROM_PREFIX = "lgbm_tpu_"


def _prom_name(name: str) -> str:
    """Prometheus metric name: [a-zA-Z_:][a-zA-Z0-9_:]* — dots and
    dashes become underscores, anything else is dropped."""
    out = [c if c.isalnum() or c == "_" else "_"
           for c in name.replace(".", "_").replace("-", "_")]
    text = "".join(out)
    if text and text[0].isdigit():
        text = "_" + text
    return _PROM_PREFIX + text


def _fmt(v: float) -> str:
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def render_prometheus(reg: Optional[MetricsRegistry] = None) -> str:
    """Text exposition (0.0.4) of the registry: counters, gauges, and
    latency histograms (cumulative `le` buckets per the spec)."""
    reg = reg if reg is not None else _registry.active()
    lines: List[str] = []
    if reg is None:
        return "# no active metrics registry\n"
    for name in sorted(reg.counters):
        pn = _prom_name(name)
        lines.append(f"# TYPE {pn} counter")
        lines.append(f"{pn} {_fmt(reg.counters[name])}")
    for name in sorted(reg.gauges):
        pn = _prom_name(name)
        lines.append(f"# TYPE {pn} gauge")
        lines.append(f"{pn} {_fmt(reg.gauges[name])}")
    for name in sorted(reg.latency_histograms()):
        h = reg.latency_histograms()[name]
        pn = _prom_name(name + "_ms")
        lines.append(f"# TYPE {pn} histogram")
        cum = 0
        counts = list(h.counts)     # copy: observe() may race the render
        for i, edge in enumerate(LATENCY_BUCKET_EDGES_MS):
            cum += counts[i]
            lines.append(f'{pn}_bucket{{le="{edge:.6g}"}} {cum}')
        cum += counts[len(LATENCY_BUCKET_EDGES_MS)]
        lines.append(f'{pn}_bucket{{le="+Inf"}} {cum}')
        lines.append(f"{pn}_sum {repr(float(h.sum))}")
        lines.append(f"{pn}_count {cum}")
    return "\n".join(lines) + "\n"


def _watchdog_state() -> Dict[str, Any]:
    try:
        from ..robust.watchdog import active_watchdog
        wd = active_watchdog()
    except Exception:
        wd = None
    if wd is None:
        return {"enabled": False}
    out: Dict[str, Any] = {"enabled": True}
    beat_t = getattr(wd, "_beat_t", None)
    if beat_t:
        out["heartbeat_age_s"] = round(time.monotonic() - beat_t, 3)
    out["iteration"] = getattr(wd, "_beat_iteration", -1)
    tripped = getattr(wd, "tripped", None)
    out["tripped"] = bool(tripped)
    if tripped:
        out["diagnosis"] = dict(tripped)
    return out


def render_healthz() -> Tuple[int, Dict[str, Any]]:
    """(http_status, body): 200 while live, 503 once the watchdog
    tripped — the orchestrator-facing kill signal."""
    wd = _watchdog_state()
    reg = _registry.active()
    counters = dict(reg.counters) if reg is not None else {}
    gauges = dict(reg.gauges) if reg is not None else {}
    degraded = int(counters.get("health.degraded", 0))
    try:
        from ..robust.sentinel import DEGRADED_LADDER
        rungs = list(DEGRADED_LADDER[:degraded])
    except Exception:
        rungs = []
    body = {
        "status": "tripped" if wd.get("tripped") else "ok",
        "watchdog": wd,
        "sentinel": {
            "trips": int(counters.get("health.sentinel_trips", 0)),
            "nan": int(counters.get("health.nan", 0)),
            "overflow": int(counters.get("health.overflow", 0)),
            "quarantined": int(counters.get("health.quarantined", 0)),
            "rollbacks": int(counters.get("health.rollbacks", 0)),
        },
        "degraded_rungs": rungs,
        "host_skew": gauges.get("coll.host_skew", 0.0),
        "flight_dumps": int(counters.get("flight.dumps", 0)),
    }
    return (503 if body["status"] == "tripped" else 200), body


def render_statusz() -> Dict[str, Any]:
    reg = _registry.active()
    body: Dict[str, Any] = {"registry_active": reg is not None}
    if reg is not None:
        rec = reg.last_record
        if rec:
            body["iteration"] = rec.get("iteration", -1)
            t_iter = rec.get("t_iter_s", 0.0)
            body["t_iter_s"] = t_iter
            if t_iter:
                core = (rec.get("t_hist_s", 0.0) + rec.get("t_split_s", 0.0)
                        + rec.get("t_partition_s", 0.0))
                body["core_phase_share"] = round(core / t_iter, 4)
        total = reg.gauges.get("train.total_iterations")
        if total:
            body["total_iterations"] = int(total)
        if "pipeline.overlap_share" in reg.gauges:
            body["overlap_share"] = reg.gauges["pipeline.overlap_share"]
        body["latency_ms"] = {
            name: {"p50": h.percentile(0.50), "p99": h.percentile(0.99)}
            for name, h in sorted(reg.latency_histograms().items())}
    from ..compile import manager
    body["compile"] = manager.snapshot()
    try:
        from .aggregate import active_aggregator
        agg = active_aggregator()
        if agg is not None and agg.last_fleet is not None:
            body["fleet"] = dict(agg.last_fleet)
    except Exception:
        pass
    return body


class _Handler(http.server.BaseHTTPRequestHandler):
    server_version = "lgbm-tpu-obs/1"

    def do_GET(self) -> None:          # noqa: N802 (stdlib contract)
        try:
            if self.path == "/metrics":
                reg = getattr(self.server, "obs_registry", None)
                body = render_prometheus(reg).encode()
                ctype = "text/plain; version=0.0.4; charset=utf-8"
                code = 200
            elif self.path == "/healthz":
                code, doc = render_healthz()
                body = json.dumps(doc, indent=1).encode()
                ctype = "application/json"
            elif self.path == "/statusz":
                body = json.dumps(render_statusz(), indent=1).encode()
                ctype = "application/json"
                code = 200
            else:
                body = b"not found: try /metrics /healthz /statusz\n"
                ctype = "text/plain"
                code = 404
        except Exception as exc:       # a render bug must not kill probes
            body = f"render error: {exc}\n".encode()
            ctype = "text/plain"
            code = 500
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt: str, *args: Any) -> None:
        log.trace("obs httpd: " + fmt, *args)


class ObsServer:
    """The daemon-thread HTTP server. `port=0` binds an ephemeral port
    (tests, the CI smoke); `start()` returns the bound port."""

    def __init__(self, port: int, registry: Optional[MetricsRegistry] = None,
                 bind: Optional[str] = None) -> None:
        self.requested_port = int(port)
        self.bind = bind if bind is not None \
            else os.environ.get(BIND_ENV, "127.0.0.1")
        self._registry = registry
        self._httpd: Optional[socketserver.TCPServer] = None
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1] if self._httpd else 0

    def start(self) -> int:
        if self._httpd is not None:
            return self.port
        srv = http.server.ThreadingHTTPServer(
            (self.bind, self.requested_port), _Handler)
        srv.daemon_threads = True
        # explicit registry binding (tests, the CI smoke) beats the
        # process-global active; None falls through to registry.active()
        srv.obs_registry = self._registry
        self._httpd = srv
        self._thread = threading.Thread(
            target=srv.serve_forever, kwargs={"poll_interval": 0.5},
            name="lgbm-tpu-obs-httpd", daemon=True)
        self._thread.start()
        log.info("obs endpoint on http://%s:%d (/metrics /healthz "
                 "/statusz)", self.bind, self.port)
        return self.port

    def stop(self) -> None:
        srv, self._httpd, self._thread = self._httpd, None, None
        if srv is not None:
            try:
                srv.shutdown()
                srv.server_close()
            except Exception:
                pass
