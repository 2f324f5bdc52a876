"""Build and load the port's CUDA kernels (csrc/*.cu).

Each source under csrc/ is compiled by its own ``nvcc`` process into a
shared library with a plain C interface; all of them start together at
first use, and the libraries land in the package's build directory
(``_build/``, ignored by git), named by a hash of the source, the
headers under csrc/ and the flags, so an edited source or header
rebuilds and an unchanged one is reused. The libraries are loaded with
ctypes: pointers and the CUDA stream are passed as ``c_void_p``.
Nothing here runs at import time — the CPU test suite imports every
module on a machine without ``nvcc``.

Each library found in the build directory counts as a
``compile.cache_hits``, each one built as a ``compile.cache_misses`` and
a ``compile.programs``, and the build's seconds go to the ``compile``
timer (compile/manager.py). compile/warmup.py runs ``build_all`` on a
background thread or as ``task=warmup``; a launch meanwhile waits on
the lock.

``LAUNCHES`` holds one plain integer per kernel wrapper; a wrapper adds
one where it launches its kernel and nowhere else, so a run can show
which kernels the main path went through.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("hist_planar", "partition", "hist_rowmajor", "hist_multival")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# the quantized (int32) mode of a kernel counts under its own name, the
# float name with a "_q" suffix
LAUNCHES: Dict[str, int] = {
    name: 0 for base in ("hist_planar", "hist_radix", "hist_masked",
                         "hist_multival_planar", "hist_multival")
    for name in (base, base + "_q")}
LAUNCHES["partition"] = 0
# B2's launches on the categorical (bitset) route, also in "partition"
LAUNCHES["partition_cat"] = 0
BUILD_INFO: Dict[str, object] = {}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    "hist_planar": {
        "lgbt_hist_tile": ([], _I),
        "lgbt_hist_planar": ([_P, _L, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                              _I, _I, _P, _P, _P], _I),
    },
    "partition": {
        "lgbt_partition_tile": ([], _I),
        "lgbt_partition_small": ([_I, _I], _I),
        "lgbt_partition_status_words": ([_I, _I], _L),
        "lgbt_partition_dev_status_words": ([_I, _I], _L),
        "lgbt_partition": ([_P, _L, _I, _I, _I, _P, _P, _P, _P, _P], _I),
        "lgbt_partition_dev": ([_P, _L, _I, _P, _I, _P, _P, _P, _P, _P],
                               _I),
    },
    "hist_rowmajor": {
        "lgbt_rm_tile": ([_I, _I, _I], _I),
        "lgbt_hist_radix": ([_P, _I, _I, _I, _P, _P, _I, _I, _I, _P, _P,
                             _P], _I),
        "lgbt_hist_masked": ([_P, _I, _I, _I, _P, _P, _I, _I, _P, _P, _P],
                             _I),
    },
    "hist_multival": {
        "lgbt_mv_tile": ([], _I),
        "lgbt_mv_max_slots": ([], _I),
        "lgbt_mv_smem_cells": ([], _I),
        "lgbt_mv_quant_smem_cells": ([], _I),
        "lgbt_hist_multival_planar": ([_P, _L, _P, _P, _I, _I, _I, _I, _I,
                                       _I, _I, _I, _I, _P, _P, _P], _I),
        "lgbt_hist_multival": ([_P, _P, _I, _I, _I, _I, _I, _P, _P, _P],
                               _I),
    },
}


# launches whose kind only the device knows (B2's categorical route
# under a device-side window): per (name, device) an int64 counter on the
# device that the wrapper adds to on the stream; ``launch_counts`` folds
# them into LAUNCHES with one read
_DEVICE_COUNTS: Dict = {}


def device_counter(name: str, device):
    """The device-side launch counter of ``name`` on ``device``."""
    import torch
    key = (name, str(device))
    if key not in _DEVICE_COUNTS:
        _DEVICE_COUNTS[key] = torch.zeros(1, dtype=torch.int64,
                                          device=device)
    return _DEVICE_COUNTS[key]


def add_launches(delta: Dict[str, int], times: int = 1) -> None:
    """Add ``times`` x ``delta`` to LAUNCHES: the wrappers' launches of a
    captured CUDA graph, once per replay (a replay calls no wrapper)."""
    for k, v in delta.items():
        if v:
            LAUNCHES[k] += v * times


def launch_counts() -> Dict[str, int]:
    """LAUNCHES with the device-side counters folded in (a read of each,
    which is then zeroed)."""
    if _DEVICE_COUNTS:
        import torch
        keys = list(_DEVICE_COUNTS)
        vals = torch.cat([_DEVICE_COUNTS[k].cpu() for k in keys]).tolist()
        for k, v in zip(keys, vals):
            LAUNCHES[k[0]] += int(v)
            _DEVICE_COUNTS[k].zero_()
    return dict(LAUNCHES)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    for t in _DEVICE_COUNTS.values():
        t.zero_()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built at "
                           "first use and need the CUDA toolkit")
    return path


def _lib_path(name: str) -> str:
    """The library of ``name``, named by a hash of its source, of every
    header under CSRC (a source may include any of them) and of the
    flags."""
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC)
                     if f.endswith((".cuh", ".h")))
    for fname in [name + ".cu"] + headers:
        with open(os.path.join(CSRC, fname), "rb") as fh:
            h.update(fname.encode() + b"\0" + fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def build_all() -> Dict[str, ctypes.CDLL]:
    """Compile every missing library (one nvcc per source, all started
    together), load all of them, and return them by source name. Build
    seconds and the compiler's resource report land in BUILD_INFO."""
    from ..compile import manager
    with _lock:
        if len(_libs) == len(SOURCES):
            return _libs
        os.makedirs(BUILD_DIR, exist_ok=True)
        t0 = time.perf_counter()
        procs = {}
        for name in SOURCES:
            out = _lib_path(name)
            if os.path.exists(out):
                manager.count("cache_hits")
                continue
            manager.count("cache_misses")
            tmp = f"{out}.{os.getpid()}.tmp"
            procs[name] = (subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp,
                 os.path.join(CSRC, name + ".cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT), tmp, out)
        logs = {}
        failed = []
        for name, (proc, tmp, out) in procs.items():
            text = proc.communicate()[0].decode(errors="replace")
            logs[name] = text
            if proc.returncode != 0:
                failed.append(f"{name}.cu:\n{text}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        if procs:
            manager.count("programs", len(procs))
            manager.add_time("compile", time.perf_counter() - t0)
        BUILD_INFO["seconds"] = time.perf_counter() - t0
        BUILD_INFO["built"] = sorted(procs)
        BUILD_INFO["log"] = logs
        for name in SOURCES:
            lib = ctypes.CDLL(_lib_path(name))
            for fn, (args, res) in _SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = args
                f.restype = res
            _libs[name] = lib
        return _libs


def all_loaded() -> bool:
    """True when every library is built and loaded in this process."""
    return len(_libs) == len(SOURCES)


def lib(name: str) -> ctypes.CDLL:
    if name not in _libs:
        build_all()
    return _libs[name]


def check(err: int, what: str) -> None:
    """Raise when a C entry returned a CUDA error (cudaGetLastError)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
