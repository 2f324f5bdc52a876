"""Runtime trace timeline: bounded ring buffer -> Perfetto trace.json
(the JAX package's obs/trace.py).

The registry (obs/registry.py) answers "how much, in total"; this
module answers "WHEN, and in what order" — the per-iteration timeline
that shows where the host actually blocks. Mirrors the reference's
per-phase `Common::Timer` breakdown (common.h:1054), but as structured
events rather than an end-of-run table.

Design constraints, in order:

- **Bounded memory.** Events land in a `collections.deque(maxlen=N)`
  ring: a million-iteration run keeps the LAST N events and counts the
  evictions (`dropped`), so the tracer can stay on for the whole run.
- **Low overhead.** One module-global load + `is None` check on the
  disabled path (same discipline as the active registry); an enabled
  append is two `perf_counter_ns` reads and a tuple append — no dict
  churn, no locks (deque.append is atomic under the GIL).
- **Attribution.** Sync events record the innermost *package* call
  site (`package_site`: the first frame under lightgbm_tpu_torch/
  outside this obs subpackage), so every host block names the line
  that asked for it.

The sync channel. The JAX package patches `jax.device_get` /
`jax.block_until_ready`; PyTorch has no such global channel, so the
port has its own: `utils/device.py` `device_get(t)` (the learners'
counted reads, the eval read, the reads of the host-side refits) and
`block_until_ready(device)` (the telemetry stream sync).
`install_sync_tracing` patches those two module functions; every
caller reaches them through the module attribute, so the patch sees
every call. Implicit reads (`int(t)`, `.item()` outside the channel)
are not seen here; `torch.cuda.set_sync_debug_mode("warn")` finds them.

Event kinds (Chrome/Perfetto trace-event JSON, `ph` field):

- "X" complete events: phases (cat "phase"), iterations (cat
  "iteration"), syncs (cat "sync"), collectives (cat "collective"),
- "C" counter events: memory samples (cat "mem"),
- "i" instant events: markers (cat "mark").

`export()` writes `{"traceEvents": [...]}` — loadable directly in
https://ui.perfetto.dev or chrome://tracing. Timestamps are in
microseconds relative to tracer construction (monotonic clock).
"""
from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

# one row (track) per event family so the Perfetto view groups them
_TID_COUNTER = 0     # counter tracks render separately anyway
_TID_PHASE = 1
_TID_SYNC = 2
_TID_COLLECTIVE = 3
_TID_ITERATION = 4
_TRACK_NAMES = {
    _TID_PHASE: "phases",
    _TID_SYNC: "host syncs",
    _TID_COLLECTIVE: "collectives",
    _TID_ITERATION: "iterations",
}

_CAT_TID = {
    "phase": _TID_PHASE,
    "sync": _TID_SYNC,
    "collective": _TID_COLLECTIVE,
    "iteration": _TID_ITERATION,
}


# tpulint: thread-ok(deque.append with maxlen is atomic; dropped/events_total are loose tallies)
class Tracer:
    """Bounded ring buffer of trace events.

    Events are stored as plain tuples
    ``(ph, name, cat, ts_ns, dur_ns, iteration, args)`` — `ph` is the
    Chrome trace-event phase ("X" complete / "C" counter / "i"
    instant), timestamps are `time.perf_counter_ns()` relative to the
    tracer's `t0_ns`, `args` is a small dict or None.
    """

    def __init__(self, capacity: int = 262144) -> None:
        self.capacity = max(16, int(capacity))
        self.buf: deque = deque(maxlen=self.capacity)
        self.dropped = 0
        self.t0_ns = time.perf_counter_ns()
        self.iteration = -1          # set by TelemetrySession per iter
        # when set, sync events are attributed to THIS iteration instead
        # of the current one: a trailing read of the pipelined loop
        # resolves during iteration t+1 but belongs to the dispatch at t
        self.sync_attr_iteration: Optional[int] = None
        self.events_total = 0

    # -- recording ------------------------------------------------------
    def _append(self, ev: Tuple) -> None:
        if len(self.buf) == self.capacity:
            self.dropped += 1
        self.events_total += 1
        self.buf.append(ev)

    def now_ns(self) -> int:
        return time.perf_counter_ns() - self.t0_ns

    def complete(self, name: str, cat: str, t0_ns: int, t1_ns: int,
                 args: Optional[Dict[str, Any]] = None) -> None:
        """One finished [t0, t1] scope (ph "X"). t0/t1 are `now_ns()`
        values captured by the caller — begin/end pairing happens in
        the caller's locals, so an exception between begin and end can
        drop the event but can never leave an unpaired begin in the
        buffer."""
        self._append(("X", name, cat, t0_ns, max(0, t1_ns - t0_ns),
                      self.iteration, args))

    def counter(self, name: str, value: float,
                series: str = "value") -> None:
        self._append(("C", name, "mem", self.now_ns(), 0,
                      self.iteration, {series: value}))

    def instant(self, name: str, cat: str = "mark",
                args: Optional[Dict[str, Any]] = None) -> None:
        self._append(("i", name, cat, self.now_ns(), 0,
                      self.iteration, args))

    def sync(self, func: str, site: Optional[Tuple[str, int]],
             t0_ns: int, t1_ns: int, nbytes: int = -1) -> None:
        """One host-blocking call (device_get / block_until_ready),
        attributed to its package call site."""
        if site is not None:
            name = f"{func}@{site[0]}:{site[1]}"
            args: Dict[str, Any] = {"site": f"{site[0]}:{site[1]}"}
        else:
            name, args = func, {}
        if nbytes >= 0:
            args["bytes"] = nbytes
        it = self.iteration if self.sync_attr_iteration is None \
            else self.sync_attr_iteration
        self._append(("X", name, "sync", t0_ns, max(0, t1_ns - t0_ns),
                      it, args))

    # -- export ---------------------------------------------------------
    def to_perfetto(self) -> Dict[str, Any]:
        """Chrome trace-event JSON (dict form). Process id 0 is used
        in one process; in a `torch.distributed` group each rank exports
        its own file whose pid is its rank."""
        pid = _process_index()
        events: List[Dict[str, Any]] = [
            {"ph": "M", "pid": pid, "tid": 0, "name": "process_name",
             "args": {"name": f"lightgbm_tpu_torch host {pid}"}},
        ]
        for tid, tname in _TRACK_NAMES.items():
            events.append({"ph": "M", "pid": pid, "tid": tid,
                           "name": "thread_name", "args": {"name": tname}})
        for ph, name, cat, ts_ns, dur_ns, it, args in self.buf:
            ev: Dict[str, Any] = {
                "ph": ph, "name": name, "cat": cat, "pid": pid,
                "tid": _CAT_TID.get(cat, _TID_COUNTER),
                "ts": ts_ns / 1e3,          # Perfetto wants microseconds
            }
            if ph == "X":
                ev["dur"] = dur_ns / 1e3
            if ph == "i":
                ev["s"] = "t"               # thread-scoped instant
            a = dict(args) if args else {}
            if ph != "C" and it >= 0:
                a["iteration"] = it
            if a:
                ev["args"] = a
            events.append(ev)
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.dropped,
                              "events_total": self.events_total}}

    def export(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump(self.to_perfetto(), fh)

    def __len__(self) -> int:
        return len(self.buf)


# -- process-global active tracer (mirrors registry.activate/active) ----
_ACTIVE: Optional[Tracer] = None


def activate_tracer(tr: Tracer) -> Tracer:
    global _ACTIVE
    _ACTIVE = tr
    return tr


def deactivate_tracer(tr: Optional[Tracer] = None) -> None:
    """Deactivate the active tracer (or only `tr`, when given and still
    active — nested sessions unwind safely)."""
    global _ACTIVE
    if tr is None or _ACTIVE is tr:
        _ACTIVE = None


def active_tracer() -> Optional[Tracer]:
    return _ACTIVE


@contextlib.contextmanager
def sync_attribution(iteration: Optional[int]):
    """Attribute sync events recorded in this scope to `iteration`
    (the DISPATCH iteration of a trailing read), not the iteration the
    read happens to resolve in. No-op when no tracer is active or
    `iteration` is None or negative."""
    tr = _ACTIVE
    if tr is None or iteration is None or iteration < 0:
        yield
        return
    prev = tr.sync_attr_iteration
    tr.sync_attr_iteration = int(iteration)
    try:
        yield
    finally:
        tr.sync_attr_iteration = prev


def _process_index() -> int:
    """This process's rank in the default `torch.distributed` group, 0
    without one (export-time only)."""
    try:
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            return int(dist.get_rank())
    except Exception:
        pass
    return 0


# -- call-site attribution ---------------------------------------------
_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# code filename -> its repo-relative path when it counts as a package
# site, else None (memoized: the walk runs on every traced sync)
_SITE_OF: Dict[Tuple[str, Tuple[str, ...]], Optional[str]] = {}


def _site_path(filename: str, skip_dirs: Tuple[str, ...]) -> Optional[str]:
    key = (filename, skip_dirs)
    if key not in _SITE_OF:
        fn = os.path.abspath(filename)
        skips = tuple(os.path.join(_PKG_DIR, d) + os.sep
                      for d in skip_dirs) \
            + (os.path.join(_PKG_DIR, "utils", "device.py"),)
        _SITE_OF[key] = (
            os.path.relpath(fn, os.path.dirname(_PKG_DIR))
            if fn.startswith(_PKG_DIR + os.sep) and not fn.startswith(skips)
            else None)
    return _SITE_OF[key]


def package_site(skip_dirs: Tuple[str, ...] = ("obs",)
                 ) -> Optional[Tuple[str, int]]:
    """(repo-relative path, line) of the innermost stack frame inside
    lightgbm_tpu_torch/, skipping the subpackages named in `skip_dirs`
    (this obs subpackage by default, so its own sync wrappers never
    self-attribute), utils/device.py (the channel itself) and the
    learners' counting wrappers `_read`, so a read names the line that
    asked for it. The port's copy of the JAX package's
    analysis/runtime_check.package_site, walking the frames without
    formatting them (a traced training syncs hundreds of times per
    iteration)."""
    frame = sys._getframe(1)
    while frame is not None:
        code = frame.f_code
        if code.co_name != "_read":
            rel = _site_path(code.co_filename, skip_dirs)
            if rel is not None:
                return rel, frame.f_lineno
        frame = frame.f_back
    return None


# -- runtime sync tracing ------------------------------------------------
# Patches utils/device.py's device_get / block_until_ready for the
# session so every counted host block is timed and attributed.
_SYNC_PATCH: Optional[Tuple[Any, Any]] = None


def _payload_bytes(obj: Any) -> int:
    """Payload size of a device_get argument (a tensor or a sequence of
    tensors), from metadata only; -1 when unknown."""
    from ..utils.device import PendingRead
    items = obj if isinstance(obj, (list, tuple)) else [obj]
    total = 0
    for x in items:
        if isinstance(x, PendingRead):
            total += x.nbytes
            continue
        try:
            total += int(x.numel()) * int(x.element_size())
        except Exception:
            return -1
    return total


def install_sync_tracing() -> bool:
    """Patch the port's explicit sync channel; no-op when already
    installed. Returns True when the patch is active after the call."""
    global _SYNC_PATCH
    if _SYNC_PATCH is not None:
        return True
    from ..utils import device as _device
    real_get, real_block = _device.device_get, _device.block_until_ready
    from . import registry as _registry
    reg_active = _registry.active

    def traced_device_get(*args, **kwargs):
        tr = _ACTIVE
        reg = reg_active()
        if tr is None and reg is None:
            return real_get(*args, **kwargs)
        t0 = time.perf_counter_ns()
        try:
            return real_get(*args, **kwargs)
        finally:
            t1 = time.perf_counter_ns()
            if reg is not None:
                # fetch-latency histogram (schema minor 11) — fed even
                # without a tracer, so `obs_port`-only sessions still
                # expose lat.fetch.* percentiles
                reg.observe_latency("lat.fetch.device_get", (t1 - t0) / 1e6)
            if tr is not None:
                tr.sync("device_get", package_site(),
                        t0 - tr.t0_ns, t1 - tr.t0_ns,
                        _payload_bytes(args[0] if args else None))

    def traced_block_until_ready(*args, **kwargs):
        tr = _ACTIVE
        reg = reg_active()
        if tr is None and reg is None:
            return real_block(*args, **kwargs)
        t0 = time.perf_counter_ns()
        try:
            return real_block(*args, **kwargs)
        finally:
            t1 = time.perf_counter_ns()
            if reg is not None:
                reg.observe_latency("lat.fetch.block_until_ready",
                                    (t1 - t0) / 1e6)
            if tr is not None:
                tr.sync("block_until_ready", package_site(),
                        t0 - tr.t0_ns, t1 - tr.t0_ns)

    _device.device_get = traced_device_get
    _device.block_until_ready = traced_block_until_ready
    _SYNC_PATCH = (real_get, real_block)
    return True


def uninstall_sync_tracing() -> None:
    global _SYNC_PATCH
    if _SYNC_PATCH is None:
        return
    from ..utils import device as _device
    _device.device_get, _device.block_until_ready = _SYNC_PATCH
    _SYNC_PATCH = None


# -- multi-rank trace merge ----------------------------------------------
def merge_trace_events(per_rank_events: List[List[Dict[str, Any]]]
                       ) -> Dict[str, Any]:
    """Merge per-rank trace-event lists into ONE Perfetto timeline with
    per-rank process tracks: input r becomes pid r (whatever pid the
    producing host wrote — files exported on different hosts can all
    carry their own process_index, or all carry 0 when each host thought
    itself alone), and the per-category track machinery (`_TRACK_NAMES`)
    is re-emitted per pid so every rank gets its own named phase / sync /
    collective / iteration rows."""
    merged: List[Dict[str, Any]] = []
    for rank, events in enumerate(per_rank_events):
        merged.append({"ph": "M", "pid": rank, "tid": 0,
                       "name": "process_name",
                       "args": {"name": f"lightgbm_tpu rank {rank}"}})
        merged.append({"ph": "M", "pid": rank, "tid": 0,
                       "name": "process_sort_index",
                       "args": {"sort_index": rank}})
        for tid, tname in _TRACK_NAMES.items():
            merged.append({"ph": "M", "pid": rank, "tid": tid,
                           "name": "thread_name", "args": {"name": tname}})
        for ev in events:
            if ev.get("ph") == "M":
                continue            # replaced by the per-rank metadata
            ev = dict(ev)
            ev["pid"] = rank
            merged.append(ev)
    return {"traceEvents": merged, "displayTimeUnit": "ms",
            "otherData": {"merged_ranks": len(per_rank_events)}}


def merge_trace_files(paths: List[str], out_path: str) -> Dict[str, Any]:
    """`trace-report --merge r0.json r1.json ...`: load each rank's
    exported trace (traceEvents dict or bare event array), merge, write
    `out_path`, return the merged document."""
    per_rank = []
    for path in paths:
        with open(path) as fh:
            doc = json.load(fh)
        per_rank.append(doc["traceEvents"] if isinstance(doc, dict)
                        else doc)
    merged = merge_trace_events(per_rank)
    with open(out_path, "w") as fh:
        json.dump(merged, fh)
    return merged


# -- device memory sampling ----------------------------------------------
def live_array_bytes(device: Any = None) -> int:
    """Bytes the caching allocator holds for live tensors on the CUDA
    device (`torch.cuda.memory_allocated`), the one device-footprint
    measure every consumer shares. -1 when there is no CUDA device or
    `device` is the CPU: torch keeps no allocator statistics for host
    memory, so the `mem.*` gauges are then absent (as the JAX package's
    are when its count is unavailable)."""
    try:
        import torch
        if device is not None and torch.device(device).type != "cuda":
            return -1
        if not torch.cuda.is_available() or not torch.cuda.is_initialized():
            return -1
        return int(torch.cuda.memory_allocated(device))
    except Exception:
        return -1
