"""The build counters of the port's kernels (the bookkeeping of the JAX
package's compile/manager.py ``count`` / ``add_time`` / ``snapshot``).

The JAX package's manager registers XLA entry points and keeps their
executables; the port's unit of work is an nvcc library of
ops/cuda.py, built once per source and named by a hash of its sources
and flags. ``build_all`` feeds the counters: ``programs`` (libraries
built), ``cache_hits`` (libraries found in the build directory by their
hash), ``cache_misses`` (libraries that had to be built) and the
``compile_s`` seconds of the builds. Each goes to the active telemetry
registry as well (``compile.<name>``, the ``compile`` timer phase), and
``snapshot()`` is the ``compile`` block of the endpoint's /statusz.
The JAX package's ``store_*``, ``aot_*`` and ``jit_compiles`` counters
and its ``lowering_s`` / ``hlo_bytes`` have no counterpart: the port
serializes no executable and traces no program.
"""
from __future__ import annotations

import threading
from typing import Dict

_STATS: Dict[str, float] = {}
_LOCK = threading.Lock()


def count(name: str, value: float = 1) -> None:
    """Add ``value`` to counter ``name`` (and to ``compile.<name>`` of
    the active registry)."""
    with _LOCK:
        _STATS[name] = _STATS.get(name, 0) + value
    from .. import obs
    obs.inc(f"compile.{name}", value)


def add_time(phase: str, seconds: float) -> None:
    """Add ``seconds`` to ``<phase>_s`` (and to the registry's timer of
    ``phase``)."""
    with _LOCK:
        key = f"{phase}_s"
        _STATS[key] = _STATS.get(key, 0.0) + seconds
    from .. import obs
    reg = obs.active()
    if reg is not None:
        reg.add_time(phase, seconds)


def snapshot() -> Dict[str, float]:
    """A copy of the counters, for /statusz and the warm-up summary."""
    with _LOCK:
        return dict(_STATS)


def reset() -> None:
    with _LOCK:
        _STATS.clear()
