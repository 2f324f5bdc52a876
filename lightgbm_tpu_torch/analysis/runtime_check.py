"""Runtime cross-checks of the static model.

The packs classify statically; these helpers hold what a real run does
against that classification. Each raises when its check cannot be
made (no card for the card's probes); none passes vacuously.

- `record_device_gets(sites)`: patches `utils/device.py`
  `device_get` and `block_until_ready` for the context and records the
  innermost package site of every call (`obs/trace.py`
  `package_site`, skipping `analysis/`, `obs/`, `utils/device.py` and
  the learners' counting `_read` wrappers, so a read names the line
  that asked for it). Compare with `static_inventory` /
  `static_hot_inventory` through `unexplained`.
- `transfer_guard_no_transfers()`: `torch.cuda.set_sync_debug_mode(
  "error")` for the context: any call that synchronizes the card with
  the host raises. Without a card it raises `RuntimeError`.
- `implicit_sync_sites(sites)`: the syncing CUDA calls of the context
  by package site, from the sync debug mode's warnings (`"warn"`), as
  `chip_smoke.py` `steady_sync_sites` counts them. Without a card it
  raises `RuntimeError`.
- `graph_shadow_check(learner, states)`: every CUDA graph a live
  learner holds sits in an attribute the static model knows as the
  holder of a capture (buffer-lifetime's `graph_buffers`), and the
  address in its key is one of `states` (the tensors graph-rebind
  exempts because the key holds their `data_ptr()`).
- `thread_check()`: the live `lgbm-*` threads are a subset of the
  spawn inventory's names (thread-shared-state).

The JAX package's `mesh_axis_check` and `capture_donation_warnings`
have no counterpart: the port has no mesh and donates no buffer.
torch is imported lazily inside the helpers: the linter must import
without it.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Iterable, Iterator, List, Optional, Set, Tuple

from .core import Package
from . import sync_points

_SKIP_DIRS = ("analysis", "obs")


def package_site() -> Optional[Tuple[str, int]]:
    """(repo-relative path, line) of the innermost package frame of
    the caller's stack (obs/trace.py's walk, skipping this subpackage
    and obs/)."""
    from ..obs.trace import package_site as site
    return site(_SKIP_DIRS)


@contextlib.contextmanager
def record_device_gets(sites: List[Tuple[str, int]]) -> Iterator[None]:
    """Patch utils/device.py's device_get / block_until_ready to append
    each caller's package (rel, line) to `sites` (duplicates kept: the
    count matters for budget checks)."""
    from ..utils import device

    real_get, real_block = device.device_get, device.block_until_ready

    def recording(real):
        def call(*args, **kwargs):
            site = package_site()
            if site is not None:
                sites.append(site)
            return real(*args, **kwargs)
        return call

    # install inside the try: a patch leaked past a failing check would
    # corrupt every later call in the process
    try:
        device.device_get = recording(real_get)
        device.block_until_ready = recording(real_block)
        yield
    finally:
        device.device_get = real_get
        device.block_until_ready = real_block


def _need_card(what: str):
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError(f"{what} needs a CUDA card: the sync debug mode "
                           "observes nothing without one")
    return torch


@contextlib.contextmanager
def transfer_guard_no_transfers() -> Iterator[None]:
    """Raise on ANY call that synchronizes the card with the host
    inside the context."""
    torch = _need_card("transfer_guard_no_transfers")
    before = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(before)


@contextlib.contextmanager
def implicit_sync_sites(sites: List[Tuple[str, int]]) -> Iterator[None]:
    """Record the package site of every syncing CUDA call inside the
    context (sync debug mode "warn"; the warning is attributed while
    it is raised, so the stack still holds the package frame)."""
    import warnings
    torch = _need_card("implicit_sync_sites")
    before = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        shown = warnings.showwarning

        def show(message, category, filename, lineno, file=None, line=None):
            text = str(message).lower()
            if "synchroniz" in text and "prototype" not in text:
                site = package_site()
                sites.append(site if site is not None
                             else (str(filename), int(lineno)))
                return
            shown(message, category, filename, lineno, file, line)
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(before)
            warnings.showwarning = shown


def static_inventory(pkg: Optional[Package] = None) -> Dict[str, Set[int]]:
    """rel -> every line a sync site spans (hot and setup)."""
    if pkg is None:
        pkg = Package.load()
    out: Dict[str, Set[int]] = {}
    for s in sync_points.inventory(pkg):
        out.setdefault(s.rel, set()).update(range(s.line, s.end + 1))
    return out


def static_hot_inventory(pkg: Optional[Package] = None
                         ) -> Dict[str, Set[int]]:
    """rel -> hot sync-site lines per the static classification."""
    if pkg is None:
        pkg = Package.load()
    return sync_points.hot_site_lines(pkg)


def unexplained(sites: Iterable[Tuple[str, int]],
                inventory: Dict[str, Set[int]]) -> List[Tuple[str, int]]:
    """The recorded sites no inventory line accounts for."""
    return sorted({(rel, line) for rel, line in sites
                   if line not in inventory.get(rel, ())})


def graph_shadow_check(learner, states: Iterable = (),
                       pkg: Optional[Package] = None) -> Dict[str, object]:
    """The live learner's CUDA graphs against the static model: each
    graph sits in a static holder attribute of a capturing class of
    the learner's MRO, and the address in its key is the data_ptr() of
    one of `states`. `unaccounted` must stay empty; `graphs` counts
    what was checked (0 means nothing was captured)."""
    import torch
    from .lifetime import graph_buffers

    if pkg is None:
        pkg = Package.load()
    static = graph_buffers(pkg)
    mro = {c.__name__ for c in type(learner).__mro__}
    holders: Set[str] = set()
    for (_rel, cls), info in static.items():
        if cls in mro:
            holders |= info["holders"]          # type: ignore[operator]
    ptrs = {int(t.data_ptr()) for t in states if torch.is_tensor(t)}
    live: List[str] = []
    unaccounted: List[str] = []
    for name, value in sorted(vars(learner).items()):
        graph = value.get("graph") if isinstance(value, dict) else value
        if not isinstance(graph, torch.cuda.CUDAGraph):
            continue
        live.append(name)
        if name not in holders:
            unaccounted.append(f"holder:{name}")
        key = value.get("key") if isinstance(value, dict) else None
        if key is None or not any(isinstance(k, int) and k in ptrs
                                  for k in key):
            unaccounted.append(f"key:{name}")
    return {"graphs": len(live), "live": live,
            "static_holders": sorted(holders), "unaccounted": unaccounted}


def thread_check(pkg: Optional[Package] = None) -> Dict[str, object]:
    """Live `lgbm-*` thread names vs the static spawn inventory.

    A thread the package spawned that the thread-shared-state pack
    does not know about means its shared-attr discipline is checking
    the wrong reachability set — `unaccounted` must stay empty."""
    from .threads import thread_names

    if pkg is None:
        pkg = Package.load()
    static = thread_names(pkg)
    live = sorted(t.name for t in threading.enumerate()
                  if t.name.startswith("lgbm-"))
    unaccounted = sorted(n for n in live if n not in static)
    return {"live": live, "static": sorted(static),
            "unaccounted": unaccounted}
