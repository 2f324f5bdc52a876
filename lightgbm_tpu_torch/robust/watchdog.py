"""Hang watchdog: a deadman timer over the training loop's host-side
progress (the JAX package's robust/watchdog.py).

A hung collective, a wedged kernel or a readback that never resolves
blocks the host forever with no diagnosis. The watchdog turns that
into a bounded, classified, actionable failure:

- the training loop feeds it per-iteration heartbeats (:meth:`beat`)
  and marks the blocking regions it enters (:meth:`phase` — collective
  dispatch, device dispatch, readback, host callbacks);
- a daemon thread polls the heartbeat age; when it exceeds
  ``timeout_s`` it classifies the stall from the innermost open phase,
  flushes the active runtime trace (obs/trace.py) so the last seconds
  before the hang can be inspected in Perfetto, dumps every thread's
  stack, names the straggling rank from the ``coll.host_skew`` /
  ``coll.slowest_rank`` gauges when telemetry runs in a group, bumps
  the ``watchdog.*`` counters and fires the flight recorder
  (obs/flight.py). A blocking CUDA call or collective releases the
  GIL, so the thread runs while the main thread waits;
- the thread never raises into the main thread: the *raise* is
  cooperative, at the next :meth:`check` on the main thread (iteration
  top, phase exit), which raises :class:`HangTimeout`; the engine
  either surfaces it or — with ``auto_resume=true`` — re-enters
  training from the last checkpoint.

Without an active tracer or registry the diagnosis carries
``trace_file`` and ``slowest_rank`` as None, as the JAX package's does.

One process-global active watchdog (``activate_watchdog`` /
``active_watchdog``) lets the network and boosting layers mark phases
without plumbing a handle through every signature; a run without a
watchdog pays one ``is None`` check per mark.
"""
from __future__ import annotations

import contextlib
import sys
import threading
import time
import traceback
from typing import Any, Dict, List, Optional, Tuple

from ..utils import log
from ..utils.log import LightGBMError

# phase-name prefix -> stall class; anything else (or no open phase)
# classifies as a plain "iteration" stall
_STALL_CLASSES = ("collective", "dispatch", "readback", "host-callback")


class HangTimeout(LightGBMError):
    """Raised cooperatively on the training thread after the watchdog
    classified a stall; carries the diagnosis for the recovery policy."""

    def __init__(self, message: str, diagnosis: Optional[Dict] = None) -> None:
        super().__init__(message)
        self.diagnosis = diagnosis or {}


def classify_stall(phase: Optional[str]) -> str:
    """Stall class for the innermost open phase marker ("collective:psum"
    -> "collective"); no open phase means the loop itself stopped
    beating ("iteration")."""
    if not phase:
        return "iteration"
    head = phase.split(":", 1)[0]
    return head if head in _STALL_CLASSES else "iteration"


class Watchdog:
    """Deadman timer with phase-aware stall classification."""

    # a beat this many iterations past the first one ends warm-up: by
    # then every kernel is built and loaded, so the strict timeout can
    # no longer mistake a cold start for a hang
    WARMUP_ITERS = 3

    def __init__(self, timeout_s: float, poll_s: Optional[float] = None,
                 warmup_grace_s: float = 0.0,
                 trace_path: Optional[str] = None) -> None:
        if timeout_s <= 0:
            raise ValueError("watchdog timeout_s must be > 0")
        self.timeout_s = float(timeout_s)
        self.trace_path = trace_path
        self.poll_s = (min(max(timeout_s / 4.0, 0.02), 1.0)
                       if poll_s is None else float(poll_s))
        # during the first iterations the host legitimately blocks on
        # kernel builds and loads; until WARMUP_ITERS beats pass, the
        # effective timeout is max(timeout_s, warmup_grace_s). 0 = no
        # grace (unit tests, bare deadman use)
        self.warmup_grace_s = float(warmup_grace_s)
        self._warm = warmup_grace_s <= 0
        self._first_it: Optional[int] = None
        self._lock = threading.Lock()
        self._beat_t = time.monotonic()
        self._beat_iteration: Optional[int] = None
        self._phases: List[Tuple[str, float]] = []   # (name, t_entered)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.tripped: Optional[Dict[str, Any]] = None
        self.trip_count = 0

    # -- lifecycle ------------------------------------------------------
    def start(self) -> "Watchdog":
        if self._thread is not None:
            return self
        self._stop.clear()
        with self._lock:
            self._beat_t = time.monotonic()
        self._thread = threading.Thread(
            target=self._run, name="lgbm-torch-watchdog", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=max(1.0, 4 * self.poll_s))
        self._thread = None

    # -- feeding --------------------------------------------------------
    def beat(self, iteration: Optional[int] = None) -> None:
        """Heartbeat: the loop made host-side progress."""
        with self._lock:
            self._beat_t = time.monotonic()
            if iteration is not None:
                self._beat_iteration = iteration
                if self._first_it is None:
                    self._first_it = iteration
                elif iteration >= self._first_it + self.WARMUP_ITERS:
                    self._warm = True    # sticky: kernels stay loaded

    @contextlib.contextmanager
    def phase(self, name: str):
        """Mark a potentially-blocking region; exiting is also a
        cooperative check point (and a heartbeat)."""
        with self._lock:
            self._phases.append((name, time.monotonic()))
        try:
            yield self
        finally:
            with self._lock:
                if self._phases and self._phases[-1][0] == name:
                    self._phases.pop()
                self._beat_t = time.monotonic()
            self.check()

    # -- cooperative raise ----------------------------------------------
    def check(self) -> None:
        """Raise :class:`HangTimeout` on the calling thread if the
        watchdog tripped since the last clear."""
        diag = self.tripped
        if diag is not None:
            raise HangTimeout(diag.get("message", "training stalled"), diag)

    def clear(self) -> None:
        """Re-arm after a handled trip (auto_resume path)."""
        with self._lock:
            self.tripped = None
            self._phases.clear()
            self._beat_t = time.monotonic()

    # -- watchdog thread ------------------------------------------------
    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            with self._lock:
                if self.tripped is not None:
                    continue     # wait for clear() before re-arming
                now = time.monotonic()
                age = now - self._beat_t
                top = self._phases[-1][0] if self._phases else None
                if top is not None:
                    age = max(age, now - self._phases[-1][1])
                iteration = self._beat_iteration
                limit = self.timeout_s if self._warm \
                    else max(self.timeout_s, self.warmup_grace_s)
            if age <= limit:
                continue
            self._trip(age, top, iteration)

    def _trip(self, age: float, phase: Optional[str],
              iteration: Optional[int]) -> None:
        stall = classify_stall(phase)
        skew, slowest = self._straggler()
        where = f"in phase {phase!r}" if phase else "between heartbeats"
        straggler = ""
        if slowest is not None:
            straggler = (f"; slowest rank so far: {slowest} "
                         f"(host skew {skew:.2f})")
        message = (
            f"training stalled for {age:.1f}s (> hang_timeout="
            f"{self.timeout_s:g}s) {where} — classified as {stall!r} stall"
            f" at iteration {iteration}{straggler}. Thread stacks and the"
            " runtime trace were dumped; raise hang_timeout if this is"
            " legitimate, or set auto_resume=true to restart from the"
            " last checkpoint.")
        log.warning("watchdog: %s", message)
        self._count(stall)
        self._dump_stacks()
        trace_file = self._flush_trace(stall)
        diagnosis = {"message": message, "stall_class": stall,
                     "phase": phase, "age_s": age, "iteration": iteration,
                     "host_skew": skew, "slowest_rank": slowest,
                     "trace_file": trace_file}
        # flight recorder: snapshot the trace ring, the registry and
        # the fleet table while the hang is still live
        try:
            from ..obs.flight import active_flight
            fr = active_flight()
            if fr is not None:
                fr.dump("watchdog", diagnosis)
        except Exception as exc:   # the trip below must still land
            log.warning("watchdog: flight recorder failed: %s", exc)
        with self._lock:
            self.trip_count += 1
            self.tripped = diagnosis

    # -- diagnostics (best-effort: they run on the watchdog thread) -----
    @staticmethod
    def _straggler() -> Tuple[Optional[float], Optional[int]]:
        """(host skew, slowest rank) from the obs gauges the telemetry
        session samples: no collective can run here (the group may be
        what hangs), so only already-sampled data is used."""
        from ..obs import active as obs_active
        reg = obs_active()
        if reg is None:
            return None, None
        skew = reg.gauges.get("coll.host_skew")
        slowest = reg.gauges.get("coll.slowest_rank")
        return skew, int(slowest) if slowest is not None else None

    def _dump_stacks(self) -> None:
        try:
            names = {t.ident: t.name for t in threading.enumerate()}
            lines = []
            for ident, frame in sys._current_frames().items():
                lines.append(f"--- thread {names.get(ident, ident)} ---")
                lines.extend(
                    ln.rstrip() for ln in traceback.format_stack(frame))
            log.warning("watchdog: thread stacks at trip:\n%s",
                        "\n".join(lines))
        except Exception:
            pass

    def _flush_trace(self, stall: str) -> Optional[str]:
        """Export the active runtime tracer to ``trace_path`` (with an
        instant event marking the trip); returns the path, or None when
        no path was given, no tracer is active or the export failed."""
        from ..obs.trace import active_tracer
        tracer = active_tracer()
        if tracer is None or self.trace_path is None:
            return None
        try:
            tracer.instant(f"watchdog trip ({stall})", cat="watchdog")
            tracer.export(self.trace_path)
        except OSError as exc:
            log.warning("watchdog: trace flush to %s failed: %s",
                        self.trace_path, exc)
            return None
        log.warning("watchdog: flushed runtime trace to %s",
                    self.trace_path)
        return self.trace_path

    @staticmethod
    def _count(stall: str) -> None:
        from .. import obs
        obs.inc("watchdog.trips")
        obs.inc(f"watchdog.stall_{stall.replace('-', '_')}")


# -- process-global active watchdog --------------------------------------
_ACTIVE: Optional[Watchdog] = None


def activate_watchdog(wd: Watchdog) -> Watchdog:
    global _ACTIVE
    _ACTIVE = wd
    return wd


def deactivate_watchdog(wd: Optional[Watchdog] = None) -> None:
    """Deactivate the active watchdog (or only ``wd``, when given and
    still active — lets nested sessions unwind safely)."""
    global _ACTIVE
    if wd is None or _ACTIVE is wd:
        _ACTIVE = None


def active_watchdog() -> Optional[Watchdog]:
    return _ACTIVE


@contextlib.contextmanager
def watch_phase(name: str):
    """Phase marker against the active watchdog; free when none is."""
    wd = _ACTIVE
    if wd is None:
        yield None
        return
    with wd.phase(name):
        yield wd
