"""Named-scope timing with an aggregated global table.

Equivalent of the reference's Timer/FunctionTimer + global_timer
(reference: include/LightGBM/utils/common.h:1054-1138 — RAII scopes
around every hot function, aggregated by name, printed at exit when
built with -DUSE_TIMETAG), the port's copy of the JAX package's
utils/timer.py. Here the same scopes also emit
``torch.profiler.record_function`` ranges so profiler traces line up
with the host-side phase table.
"""
from __future__ import annotations

import atexit
import contextlib
import functools
import os
import time
from collections import defaultdict
from typing import Dict, Optional

from . import log


def env_enabled() -> bool:
    """Current LGBM_TPU_TIMETAG state (read per call, not at import —
    tests and late os.environ writes see the live value)."""
    return os.environ.get("LGBM_TPU_TIMETAG", "") not in ("", "0", "false")


class Timer:
    def __init__(self, enabled: Optional[bool] = None) -> None:
        self.acc: Dict[str, float] = defaultdict(float)
        self.cnt: Dict[str, int] = defaultdict(int)
        self.enabled = env_enabled() if enabled is None else bool(enabled)

    def set_enabled(self, on: bool) -> None:
        self.enabled = bool(on)

    @contextlib.contextmanager
    def scope(self, name: str):
        if not self.enabled:
            yield
            return
        import torch.profiler
        ann = torch.profiler.record_function(name)
        ann.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.acc[name] += time.perf_counter() - t0
            self.cnt[name] += 1
            ann.__exit__(None, None, None)

    def report(self) -> str:
        lines = ["LightGBM-Torch timer table:"]
        for name in sorted(self.acc, key=lambda k: -self.acc[k]):
            lines.append(f"  {name}: {self.acc[name]:.3f}s over "
                         f"{self.cnt[name]} calls")
        return "\n".join(lines)

    def reset(self) -> None:
        self.acc.clear()
        self.cnt.clear()

    def print_at_exit(self) -> None:
        if self.enabled and self.acc:
            log.info("%s", self.report())


global_timer = Timer()
atexit.register(global_timer.print_at_exit)


def set_enabled(on: bool) -> None:
    """Toggle the global timer at runtime (the
    `lgb.train(params={"timetag": True})` path — no reimport needed)."""
    global_timer.set_enabled(on)


def function_timer(name: str):
    """Decorator form (reference Common::FunctionTimer)."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with global_timer.scope(name):
                return fn(*args, **kwargs)
        return wrapper
    return deco
