"""On-demand-built native host kernels (ctypes over a g++-compiled
shared object — no pybind11 dependency).

The device compute path is PyTorch and CUDA; these kernels cover the
host-side dataset-construction work the reference implements in C++
(bin boundary search, column bin conversion — src/io/bin.cpp) where
Python-loop cost is material at load time. The library is built at
first use into the package's build directory (``_build/``, ignored by
git). Without a compiler the pure-Python implementations in
io/binning.py run instead; both return bit-identical results.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "binning.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
_SO = os.path.join(BUILD_DIR, "libbinning.so")

_lib = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    try:
        if (not os.path.exists(_SO)
                or os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{_SO}.{os.getpid()}.tmp"
            try:
                subprocess.run(
                    ["g++", "-O3", "-std=c++17", "-fopenmp", "-shared",
                     "-fPIC", _SRC, "-o", tmp],
                    check=True, capture_output=True, timeout=120)
            except subprocess.CalledProcessError:
                subprocess.run(  # toolchains without libgomp
                    ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", _SRC,
                     "-o", tmp],
                    check=True, capture_output=True, timeout=120)
            os.replace(tmp, _SO)
        # tpulint: build-ok(the host binning library, built and hashed by native/)
        lib = ctypes.CDLL(_SO)
        lib.lgbt_greedy_find_bin.restype = ctypes.c_int
        lib.lgbt_greedy_find_bin.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
            ctypes.POINTER(ctypes.c_double)]
        lib.lgbt_values_to_bins.restype = None
        lib.lgbt_values_to_bins.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint16)]
        _lib = lib
    except (OSError, subprocess.SubprocessError):
        _lib = None   # no compiler / bad toolchain: Python path
    return _lib


def greedy_find_bin_native(distinct_values: np.ndarray, counts: np.ndarray,
                           max_bin: int, total_cnt: int,
                           min_data_in_bin: int):
    """C++ GreedyFindBin; returns a list of bounds or None (no native)."""
    lib = _load()
    if lib is None:
        return None
    dv = np.ascontiguousarray(distinct_values, dtype=np.float64)
    cn = np.ascontiguousarray(counts, dtype=np.int64)
    out = np.empty(max_bin + 2, dtype=np.float64)
    n = lib.lgbt_greedy_find_bin(
        dv.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        cn.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(dv), int(max_bin), int(total_cnt), int(min_data_in_bin),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return out[:n].tolist()


def values_to_bins_native(values: np.ndarray, bounds: np.ndarray):
    """C++ binary-search column conversion; None when no native lib.
    Caller handles NaN masking."""
    lib = _load()
    if lib is None:
        return None
    v = np.ascontiguousarray(values, dtype=np.float64)
    b = np.ascontiguousarray(bounds, dtype=np.float64)
    out = np.empty(len(v), dtype=np.uint16)
    lib.lgbt_values_to_bins(
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(v),
        b.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(b),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)))
    return out
