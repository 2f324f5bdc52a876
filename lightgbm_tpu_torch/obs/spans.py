"""span(): one scope, four consumers (the JAX package's obs/spans.py).

A `span` feeds (a) the `utils/timer.py` global table — same names, so
the LGBM_TPU_TIMETAG phase table is unchanged, (b) the active
`MetricsRegistry` phase times when a `phase=` is given, (c) a
`torch.profiler.record_function` range, so host scopes line up with the
card's kernels in the profiler trace when `profile_dir` is set, and (d)
a complete event in the active runtime `Tracer` (obs/trace.py), so the
Perfetto timeline shows every instrumented scope in order. When none of
the consumers is enabled, a span is a bare `yield` — no range, no clock
read.

Timing is host wall time, as in the JAX package: CUDA launches are
asynchronous, so a span around a launch measures its enqueue; a span
around a blocking read (utils/device.py `device_get`) also holds the
wait for every kernel queued before it.

Exception safety: the consumer writes in the finally block run inside
their own try/finally chain, so a raising consumer (or a raising body)
can never leak an open profiler range or corrupt the timeline — the
range ALWAYS closes, and a tracer event is only appended as a
fully-formed [t0, t1] tuple. Spans nest re-entrantly: all pairing
state lives in the generator's locals.

`instrument_kernel` wraps a learner's dispatcher once, on its class,
so every call site is timed without editing each call; the disabled
fast path is one global load + one `is None` check.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

from ..utils import timer as _timer
from . import registry as _registry
from . import trace as _trace


def _trace_annotation(name: str):
    try:
        import torch.profiler
        ann = torch.profiler.record_function(name)
        ann.__enter__()
        return ann
    except Exception:
        return None


@contextlib.contextmanager
def span(name: str, phase: Optional[str] = None):
    reg = _registry.active()
    gt = _timer.global_timer
    tr = _trace.active_tracer()
    if reg is None and not gt.enabled and tr is None:
        yield
        return
    ann = _trace_annotation(name)
    tr_t0 = tr.now_ns() if tr is not None else 0
    t0 = time.perf_counter()
    try:
        yield
    finally:
        # the range must close even when a consumer write raises
        try:
            dt = time.perf_counter() - t0
            try:
                if gt.enabled:
                    gt.acc[name] += dt
                    gt.cnt[name] += 1
                if reg is not None and phase is not None:
                    reg.add_time(phase, dt)
                    reg.observe_latency(f"lat.phase.{phase}", dt * 1e3)
            finally:
                if tr is not None:
                    tr.complete(name, "phase", tr_t0, tr.now_ns(),
                                {"phase": phase} if phase else None)
        finally:
            if ann is not None:
                ann.__exit__(None, None, None)


@contextlib.contextmanager
def step_span(iteration: int):
    """Marks one boosting iteration as a profiler step: a
    `record_function("boosting_iteration#<n>")` range, and `step()` of
    the running profiler at its end, so the trace groups the card's
    work per iteration, aligned with the JSONL records."""
    ann = None
    try:
        import torch.profiler
        ann = torch.profiler.record_function(
            f"boosting_iteration#{int(iteration)}")
        ann.__enter__()
    except Exception:
        ann = None
    try:
        yield
    finally:
        if ann is not None:
            ann.__exit__(None, None, None)
        prof = _PROFILER
        if prof is not None:
            try:
                prof.step()
            except Exception:
                pass


def instrument_kernel(fn, phase: str, name: Optional[str] = None):
    """Wrap a dispatcher with per-call phase timing + a call counter.
    Timing is host-side: under asynchronous launches it covers the
    enqueue, on the CPU the compute too. The wrapper is a plain
    function, so on a class it binds as the method it wraps."""
    label = name or f"kernel/{phase}"

    def wrapper(*args, **kwargs):
        reg = _registry.active()
        if reg is None and not _timer.global_timer.enabled \
                and _trace.active_tracer() is None:
            return fn(*args, **kwargs)
        with span(label, phase=phase):
            out = fn(*args, **kwargs)
        if reg is not None:
            reg.inc(f"kernel.{phase}.calls")
        return out

    wrapper.__name__ = getattr(fn, "__name__", label)
    wrapper.__wrapped__ = fn
    return wrapper


# -- torch.profiler trace capture ----------------------------------------
_PROFILER = None        # the running torch.profiler.profile
_PROFILE_DIR = ""


def start_profiler(profile_dir: str) -> bool:
    """Start a `torch.profiler.profile` over the CPU and, with a card,
    CUDA activities; `stop_profiler` writes its Chrome trace into
    `profile_dir`."""
    global _PROFILER, _PROFILE_DIR
    if _PROFILER is not None or not profile_dir:
        return False
    try:
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        os.makedirs(profile_dir, exist_ok=True)
        # no schedule: every step() records on, so the exported trace
        # holds every iteration; the events are never parsed in Python
        # (the export is the C++ trace writer's)
        prof = profile(activities=acts)
        prof.start()
        _PROFILER, _PROFILE_DIR = prof, profile_dir
        return True
    except Exception as exc:
        from ..utils import log
        log.warning("profile_dir=%s: could not start the torch profiler: "
                    "%s", profile_dir, exc)
        return False


def stop_profiler() -> Optional[str]:
    """Stop the running profiler and write its Chrome trace
    (`trace_<pid>_<time>.json`) into the profile directory; returns the
    file's path, or None when nothing ran or the export failed."""
    global _PROFILER
    prof, _PROFILER = _PROFILER, None
    if prof is None:
        return None
    path = os.path.join(_PROFILE_DIR, "trace_%d_%d.json"
                        % (os.getpid(), time.time_ns()))
    try:
        prof.stop()
        prof.export_chrome_trace(path)
        return path
    except Exception as exc:
        from ..utils import log
        log.warning("profile_dir=%s: profiler export failed: %s",
                    _PROFILE_DIR, exc)
        return None
