"""Logging for lightgbm_tpu_torch.

Equivalent of the reference's ``Log`` utility
(reference: include/LightGBM/utils/log.h:81-110): leveled logging with a
registerable callback (used by the Python-facing API the same way the
reference routes C++ logs through a ctypes callback, python-package
lightgbm/basic.py:24).
"""
from __future__ import annotations

import sys
from typing import Callable, Optional

# config-level verbosity, reference scale (src/io/config.cpp:234-242):
# <0: fatal only, 0: warning+error, 1: info (default), >=2: debug
_verbosity = 1
_callback: Optional[Callable[[str], None]] = None


class LightGBMError(Exception):
    """Error raised by lightgbm_tpu_torch (mirrors the reference's LightGBMError)."""


def set_verbosity(level: int) -> None:
    """<0: fatal only, 0: warning, 1: info, >=2: debug (reference scale)."""
    global _verbosity
    _verbosity = level


def register_log_callback(cb: Optional[Callable[[str], None]]) -> None:
    global _callback
    _callback = cb


def _emit(msg: str) -> None:
    if _callback is not None:
        # a raising user callback must not kill training mid-iteration;
        # fall back to stderr so the line is not lost
        try:
            _callback(msg + "\n")
            return
        except Exception as exc:
            sys.stderr.write(
                f"[LightGBM-Torch] [Warning] log callback raised {exc!r}; "
                "falling back to stderr\n")
    sys.stderr.write(msg + "\n")


def trace(msg: str, *args) -> None:
    """Highest-volume level (verbosity >= 3): per-kernel / per-span
    detail from the obs layer."""
    if _verbosity >= 3:
        _emit("[LightGBM-Torch] [Trace] " + (msg % args if args else msg))


def debug(msg: str, *args) -> None:
    if _verbosity >= 2:
        _emit("[LightGBM-Torch] [Debug] " + (msg % args if args else msg))


def info(msg: str, *args) -> None:
    if _verbosity >= 1:
        _emit("[LightGBM-Torch] [Info] " + (msg % args if args else msg))


def warning(msg: str, *args) -> None:
    if _verbosity >= 0:
        _emit("[LightGBM-Torch] [Warning] " + (msg % args if args else msg))


def fatal(msg: str, *args) -> None:
    text = msg % args if args else msg
    _emit("[LightGBM-Torch] [Fatal] " + text)
    raise LightGBMError(text)
