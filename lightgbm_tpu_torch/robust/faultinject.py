"""Deterministic fault-injection seams (the JAX package's
robust/faultinject.py, the same grammar and the same environment
variable, so one plan drives both packages the same way).

A fault plan is a semicolon-separated list of entries

    <seam>:<mode>[=<arg>][@<trigger>]

taken from the ``LGBM_TPU_FAULT_PLAN`` environment variable (or
installed programmatically via :func:`install_plan`). Each entry arms
one named seam:

========================  =====================================================
seam                      fires in
========================  =====================================================
``checkpoint.write``      robust/checkpoint.py atomic writer
``train.iteration``       engine.py, at the top of every boosting iteration
                          (the seam index IS the iteration number)
``collective.dispatch``   network.py, around every all_gather / psum / pmax
``sink.write``            obs/sink.py JSONL writer and obs/flight.py bundles
``trace.export``          obs TelemetrySession.close, before the trace dump
``sentinel.check``        robust/sentinel.py, at every sentinel dispatch
========================  =====================================================

(``store.load`` parses too; its owner in the JAX package, the AOT
executable store, has no counterpart in the port, whose kernels are
nvcc libraries found by their hash (compile/manager.py), so no seam
fires it.)

Modes: ``sigkill`` (SIGKILL self — the preemption simulator),
``enospc`` / ``ioerror`` (raise the corresponding ``OSError``),
``delay=S`` (sleep S seconds), ``partial`` / ``torn`` (checkpoint-
writer-interpreted: half-written tmp file, or a truncated file that
still gets renamed), ``corrupt`` / ``truncate`` (bytes filters for
blob-reading seams), ``hang[=S]`` (block the seam for S seconds —
default 60, always bounded so a drill can never wedge a test — and
then DISARM: a hang spec fires at most once per process, so an
``auto_resume`` run that replays the hung iteration does not re-hang),
``nan`` / ``overflow`` (caller-interpreted numeric poison: the seam
owner injects NaN / an overflowing value into the plane it guards —
the sentinel and quarantine drills).

Triggers make plans deterministic: ``@N`` fires on the N-th hit of the
seam (1-based) — except at index-carrying seams (``train.iteration``),
where ``@N`` compares against the index the call site passes, so
``train.iteration:sigkill@3`` kills the process entering iteration 3
exactly. ``@*`` (the default for ``delay``/``corrupt``/``truncate``)
fires on every hit; all other modes default to ``@1``.

Every firing bumps the ``fault.fired`` / ``fault.<seam>`` counters on
the active metrics registry (obs/) and logs one warning, so an injected
fault is never silent.
"""
from __future__ import annotations

import errno
import os
import signal
import time
from typing import List, Optional

from ..utils import log

ENV_VAR = "LGBM_TPU_FAULT_PLAN"

_MODES = ("sigkill", "enospc", "ioerror", "delay", "partial", "torn",
          "corrupt", "truncate", "hang", "nan", "overflow")
# modes that fire on every hit unless pinned explicitly
_EVERY_HIT_MODES = ("delay", "corrupt", "truncate")

# seams where the call site passes an explicit index (the boosting
# iteration): @N matches the index, not the hit count
_INDEXED_SEAMS = ("train.iteration",)


class FaultSpec:
    """One armed seam: seam name, mode, optional arg, trigger."""

    __slots__ = ("seam", "mode", "arg", "trigger", "hits", "disarmed")

    def __init__(self, seam: str, mode: str, arg: float,
                 trigger: Optional[int]) -> None:
        self.seam = seam
        self.mode = mode
        self.arg = arg
        self.trigger = trigger   # None = every hit
        self.hits = 0
        self.disarmed = False    # hang specs disarm after firing

    def matches(self, index: Optional[int]) -> bool:
        if self.disarmed:
            return False
        if self.seam in _INDEXED_SEAMS and index is not None:
            return self.trigger is None or index == self.trigger
        self.hits += 1  # tpulint: thread-ok(test-only trigger tally; a race shifts the firing hit)
        return self.trigger is None or self.hits == self.trigger

    def __repr__(self) -> str:
        t = "*" if self.trigger is None else str(self.trigger)
        return f"{self.seam}:{self.mode}@{t}"


class FaultPlan:
    """Parsed fault plan; ``check``/``filter_bytes`` are the seams."""

    def __init__(self, specs: List[FaultSpec], text: str = "") -> None:
        self.specs = specs
        self.text = text
        self.fired: List[str] = []

    @classmethod
    def parse(cls, text: str) -> "FaultPlan":
        specs = []
        for entry in str(text).replace(",", ";").split(";"):
            entry = entry.strip()
            if not entry:
                continue
            seam, _, rest = entry.partition(":")
            if not rest:
                raise ValueError(
                    f"fault plan entry {entry!r}: expected seam:mode[@N]")
            mode_part, _, trig_part = rest.partition("@")
            mode, _, arg_part = mode_part.partition("=")
            mode = mode.strip()
            if mode not in _MODES:
                raise ValueError(
                    f"fault plan entry {entry!r}: unknown mode {mode!r} "
                    f"(known: {', '.join(_MODES)})")
            arg = float(arg_part) if arg_part else 0.0
            trig_part = trig_part.strip()
            if trig_part in ("", "*"):
                trigger = (None if trig_part == "*"
                           or mode in _EVERY_HIT_MODES else 1)
            else:
                trigger = int(trig_part)
            specs.append(FaultSpec(seam.strip(), mode, arg, trigger))
        return cls(specs, text=str(text))

    # -- firing --------------------------------------------------------
    def _fire(self, spec: FaultSpec, index: Optional[int]) -> None:
        self.fired.append(repr(spec))  # tpulint: thread-ok(test-only log; list.append is atomic)
        from .. import obs
        obs.inc("fault.fired")
        obs.inc(f"fault.{spec.seam}")
        log.warning("fault injection: seam %s firing %s (index=%s)",
                    spec.seam, repr(spec), index)

    def check(self, seam: str, index: Optional[int] = None
              ) -> Optional[FaultSpec]:
        """Run the seam: interpret the universally-interpretable modes
        (sigkill / delay / hang / enospc / ioerror) in place; return the
        spec for caller-interpreted modes (partial/torn/corrupt/
        truncate/nan/overflow), None when the seam stays quiet."""
        for spec in self.specs:
            if spec.seam != seam or not spec.matches(index):
                continue
            self._fire(spec, index)
            if spec.mode == "sigkill":
                os.kill(os.getpid(), signal.SIGKILL)
            elif spec.mode == "delay":
                time.sleep(spec.arg)
                return spec
            elif spec.mode == "hang":
                # one-shot: an auto_resume run replays the hung
                # iteration index, and must not hang again. Bounded, so
                # a drill without a watchdog still ends
                spec.disarmed = True
                time.sleep(spec.arg if spec.arg > 0 else 60.0)
                return spec
            elif spec.mode == "enospc":
                raise OSError(errno.ENOSPC,
                              f"No space left on device (injected: {spec!r})")
            elif spec.mode == "ioerror":
                raise OSError(errno.EIO,
                              f"Input/output error (injected: {spec!r})")
            else:
                return spec
        return None

    def filter_bytes(self, seam: str, payload: bytes,
                     index: Optional[int] = None) -> bytes:
        """Bytes-mutating seam for blob readers: ``truncate`` drops the
        second half, ``corrupt`` flips bytes in the middle."""
        spec = self.check(seam, index)
        if spec is None:
            return payload
        if spec.mode == "truncate":
            return payload[:max(1, len(payload) // 2)]
        if spec.mode == "corrupt":
            mid = len(payload) // 2
            span = max(1, min(16, len(payload) - mid))
            garbage = bytes((b ^ 0xA5) for b in payload[mid:mid + span])
            return payload[:mid] + garbage + payload[mid + span:]
        return payload


# -- process-global active plan -----------------------------------------
_INSTALLED: Optional[FaultPlan] = None
_ENV_CACHE: Optional[tuple] = None   # (env text, plan)


def install_plan(plan) -> Optional[FaultPlan]:
    """Install a plan programmatically (string spec, FaultPlan, or None
    to clear). Overrides the environment variable until cleared."""
    global _INSTALLED
    if isinstance(plan, str):
        plan = FaultPlan.parse(plan)
    _INSTALLED = plan
    return plan


def active_plan() -> Optional[FaultPlan]:
    global _ENV_CACHE
    if _INSTALLED is not None:
        return _INSTALLED
    text = os.environ.get(ENV_VAR, "")
    if not text:
        return None
    if _ENV_CACHE is None or _ENV_CACHE[0] != text:
        _ENV_CACHE = (text, FaultPlan.parse(text))
    return _ENV_CACHE[1]


def check_fault(seam: str, index: Optional[int] = None
                ) -> Optional[FaultSpec]:
    """Module-level seam entry point; near-free when no plan is armed."""
    plan = active_plan()
    if plan is None:
        return None
    return plan.check(seam, index)


def filter_bytes(seam: str, payload: bytes,
                 index: Optional[int] = None) -> bytes:
    plan = active_plan()
    if plan is None:
        return payload
    return plan.filter_bytes(seam, payload, index)
