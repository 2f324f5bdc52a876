"""Warm-up: the kernels' build taken off the critical path (the JAX
package's compile/warmup.py, in torch terms).

The JAX package compiles its XLA executables ahead of time and keeps
them in a store; the port's unit of work is an nvcc library of
ops/cuda.py (``build_all``: one per source under csrc/, all started
together, named by a hash of the sources, headers and flags, so a later
process finds a library by its hash instead of building it). Three
entry points:

- ``warmup_wanted(config, num_data)``: the JAX package's rule. The
  environment ``LGBM_TPU_WARMUP`` "0" / "false" turns it off and "1" /
  "true" on, as does ``tpu_warmup``; otherwise it is on from
  ``bucket_min_rows()`` rows (compile/signature.py).
- ``background_warmup(device_type)``: ``engine.train`` starts it before
  the Dataset is binned. ``build_all`` runs on a tracked daemon thread,
  and the first kernel launch waits on ops/cuda.py's lock instead of
  building the libraries itself. No thread starts for the CPU, which
  runs no kernel.
- ``run_warmup(config, params)``: ``task=warmup``. It builds the Dataset
  and Booster as ``task=train`` would, builds and loads every library
  (on the card; nothing is built for ``device_type=cpu``) and returns a
  summary: ``entries`` (libraries missing from the build directory),
  ``compiled`` (libraries built), ``seconds``, ``num_data`` and
  ``build_dir``, the build directory in place of the JAX package's
  ``store_dir``, plus the counters (``stats``, compile/manager.py).
"""
from __future__ import annotations

import atexit
import os
import threading
import time
from typing import Any, Dict, List, Optional

from ..utils import log
from . import manager
from . import signature as S

# a background build must not be cut mid-compile by the interpreter's
# exit: the atexit hook joins every tracked thread (an nvcc child left
# behind would write into the build directory after its parent is gone)
_bg_threads: List[threading.Thread] = []
_bg_lock = threading.Lock()


def _track(th: threading.Thread) -> threading.Thread:
    with _bg_lock:
        _bg_threads[:] = [t for t in _bg_threads if t.is_alive()]
        _bg_threads.append(th)
    return th


@atexit.register
def _join_background_threads() -> None:
    with _bg_lock:
        threads = list(_bg_threads)
    for th in threads:
        th.join()


def warmup_wanted(config: Any, num_data: int) -> bool:
    env = os.environ.get("LGBM_TPU_WARMUP", "")
    if env in ("0", "false"):
        return False
    if env in ("1", "true") or getattr(config, "tpu_warmup", False):
        return True
    return num_data >= S.bucket_min_rows()


def _build() -> Dict[str, Any]:
    """``ops.cuda.build_all`` with the summary's counts: the libraries
    missing before it and the ones it built."""
    from ..ops import cuda
    before = manager.snapshot()
    t0 = time.perf_counter()
    cuda.build_all()
    after = manager.snapshot()

    def delta(k):
        return int(after.get(k, 0) - before.get(k, 0))
    return {"entries": delta("cache_misses"), "compiled": delta("programs"),
            "seconds": time.perf_counter() - t0}


def background_warmup(device_type: str = "cuda"
                      ) -> Optional[threading.Thread]:
    """Build the kernel libraries on a daemon thread; returns the thread
    (None for the CPU, or when every library is loaded already)."""
    if device_type == "cpu":
        return None
    from ..ops import cuda
    if cuda.all_loaded():
        return None

    def _run() -> None:
        try:
            summary = _build()
            if summary["compiled"]:
                log.debug("Background warm-up built %d kernel libraries "
                          "in %.1fs", summary["compiled"],
                          summary["seconds"])
        except Exception as exc:
            # the first launch builds (and raises) in the foreground
            log.debug("Background warm-up failed: %s", exc)

    th = threading.Thread(target=_run, name="lgbm-cuda-warmup",
                          daemon=True)
    _track(th)
    th.start()
    return th


def run_warmup(config: Any, params: Dict[str, str]) -> Dict[str, Any]:
    """``task=warmup``: the Dataset and Booster as ``task=train`` builds
    them, then every kernel library built and loaded (on the card)."""
    import lightgbm_tpu_torch as lgb
    from ..ops import cuda

    if not config.data:
        raise ValueError("task=warmup requires data= (the dataset file "
                         "whose shapes and params define the training)")
    clean = {k: v for k, v in params.items() if k != "task"}
    train_set = lgb.Dataset(config.data, params=dict(clean))
    booster = lgb.Booster(params=dict(clean), train_set=train_set)
    if booster._gbdt.device.type == "cuda":
        summary = _build()
    else:
        summary = {"entries": 0, "compiled": 0, "seconds": 0.0}
    summary["build_dir"] = cuda.BUILD_DIR
    summary["num_data"] = train_set.num_data()
    summary["stats"] = manager.snapshot()
    del booster
    return summary
