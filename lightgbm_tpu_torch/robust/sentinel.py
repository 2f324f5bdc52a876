"""Numeric-health sentinels (the JAX package's robust/sentinel.py).

Silent numeric corruption — NaN/Inf gradients, divergent leaf values —
trains garbage quietly for hours. The sentinel folds tiny
finiteness/overflow reductions over arrays the boosting loop already
owns and lets the verdicts ride reads the loop already makes:

- :meth:`NumericSentinel.dispatch` runs one torch reduction per checked
  tensor on its device (``_health_device``: an int32 [nonfinite,
  overflow] pair; the overflow limit is a tensor operand, cached per
  device) and queues the verdict unread; host arrays are judged at
  once, or, with ``defer=True``, judged at once and queued like a
  device verdict, so a tree the port holds on the host resolves when
  the JAX package resolves its device-resident twin;
- the boosting loop resolves pending verdicts inside the host reads it
  already performs (the one read of ``eval_at_iter``, the periodic stop
  check), so a sentinel-enabled steady state adds no blocking read per
  iteration;
- a trip quarantines the offending tree (boosting/gbdt.py
  ``quarantine_iter``); repeated trips escalate to checkpoint rollback
  plus the degraded-mode ladder (:func:`apply_degraded_rung`).

The ``sentinel.check`` fault seam makes every trip drillable: ``nan`` /
``overflow`` modes poison the checked plane before the reduction, so
recovery is proven without manufacturing real divergence.
"""
from __future__ import annotations

from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from .. import obs
from ..utils import device as _device
from ..utils import log
from .faultinject import check_fault

# quantized-histogram overflow escalations since training started past
# which `poll_quant_tripwire` trips (the JAX package's limit)
QUANT_ESCALATION_LIMIT = 32


def _health_device(vals: torch.Tensor, limit: torch.Tensor) -> torch.Tensor:
    """[nonfinite_count, overflow_count] int32 over one tensor, on its
    device; ``limit`` is a float32 tensor operand."""
    v = vals.to(torch.float32).reshape(-1)
    finite = torch.isfinite(v)
    nonfinite = (~finite).sum()
    overflow = (finite & (torch.abs(v) > limit)).sum()
    return torch.stack([nonfinite, overflow]).to(torch.int32)


def _poison(arr, mode: str, limit: float):
    """First element of ``arr`` replaced by the drill's poison value
    (NaN or 2x the overflow limit); works for tensors and host arrays."""
    bad = float("nan") if mode == "nan" else 2.0 * limit
    if isinstance(arr, np.ndarray):
        out = arr.astype(np.float64, copy=True).ravel()
        out[0] = bad
        return out.reshape(arr.shape)
    flat = arr.reshape(-1).to(torch.float32).clone()
    flat[0] = bad
    return flat.reshape(arr.shape)


class NumericSentinel:
    """Host-side manager for the per-tree health checks.

    ``dispatch`` is called by the boosting loop right after a new
    tree's arrays (or an iteration's gradients) exist; ``take_pending``
    / ``resolve`` fold the verdicts into the loop's existing reads;
    ``pop_trips`` hands confirmed trips to the recovery policy.
    """

    def __init__(self, overflow_limit: float = 1e30,
                 max_trips: int = 2) -> None:
        self.overflow_limit = float(overflow_limit)
        self.max_trips = int(max_trips)
        self.trips = 0        # confirmed trips since the last rollback
        self.total_trips = 0  # confirmed trips over the sentinel's life
        self._pending: List[Tuple[int, Any]] = []    # (iteration, verdict)
        self._trips_out: List[Tuple[int, str]] = []  # resolved, unprocessed
        self._limits = {}     # device -> float32 limit tensor
        self.checks = 0
        self._quant_base: Optional[float] = None
        self._quant_warned = False

    def _limit_on(self, device) -> torch.Tensor:
        key = str(device)
        if key not in self._limits:
            # tpulint: sync-ok(once per device: cached in _limits)
            self._limits[key] = torch.tensor(self.overflow_limit,
                                             dtype=torch.float32,
                                             device=device)
        return self._limits[key]

    # -- dispatch -------------------------------------------------------
    def dispatch(self, arrays: List[Any], iteration: int,
                 defer: bool = False) -> None:
        """Queue health checks over ``arrays`` (tensors or host arrays)
        for boosting iteration ``iteration``. Tensor verdicts resolve
        later through :meth:`resolve`; host arrays are judged now, and
        with ``defer`` their verdicts queue with the tensor ones."""
        spec = check_fault("sentinel.check")
        mode = spec.mode if spec is not None \
            and spec.mode in ("nan", "overflow") else None
        self.checks += 1
        obs.inc("health.checks")
        for i, arr in enumerate(arrays):
            if mode is not None and i == 0:
                arr = _poison(arr, mode, self.overflow_limit)
            if isinstance(arr, np.ndarray):
                verdict = self._host_verdict(arr)
                if defer:
                    self._pending.append((iteration, verdict))
                else:
                    self._judge(iteration, verdict)
                continue
            self._pending.append((iteration, _health_device(
                arr, self._limit_on(arr.device))))

    def _host_verdict(self, arr: np.ndarray) -> np.ndarray:
        finite = np.isfinite(arr)
        return np.asarray([int((~finite).sum()),
                           int((finite & (np.abs(arr)
                                          > self.overflow_limit)).sum())])

    # -- resolution (folded into the loop's existing reads) -------------
    def take_pending(self) -> List[Tuple[int, Any]]:
        """Hand the unresolved verdicts to the caller's batched read; the
        caller passes the host values to :meth:`resolve` with the same
        list."""
        pending, self._pending = self._pending, []
        return pending

    def resolve(self, pending: List[Tuple[int, Any]],
                host_values: List[Any]) -> None:
        for (iteration, _), value in zip(pending, host_values):
            self._judge(iteration, np.asarray(value))

    def _judge(self, iteration: int, verdict: np.ndarray) -> None:
        nonfinite, overflow = int(verdict[0]), int(verdict[1])
        if nonfinite == 0 and overflow == 0:
            return
        kind = "nan" if nonfinite > 0 else "overflow"
        self.trips += 1
        self.total_trips += 1
        self._trips_out.append((iteration, kind))
        obs.inc("health.sentinel_trips")
        obs.inc(f"health.{kind}")
        # flight recorder: capture the state that produced the bad
        # plane before recovery rewrites it
        from ..obs.flight import active_flight
        fr = active_flight()
        if fr is not None:
            fr.dump("sentinel", {"iteration": iteration, "kind": kind,
                                 "nonfinite": nonfinite,
                                 "overflow": overflow,
                                 "overflow_limit": self.overflow_limit})
        log.warning(
            "sentinel: numeric-health trip at iteration %d — %d non-finite"
            " / %d overflowed (>|%g|) values in the new tree",
            iteration, nonfinite, overflow, self.overflow_limit)

    def pop_trips(self) -> List[Tuple[int, str]]:
        """Resolved-but-unprocessed trips, oldest first (the recovery
        policy quarantines / rolls back from these)."""
        out, self._trips_out = self._trips_out, []
        return out

    @property
    def has_pending(self) -> bool:
        return bool(self._pending)

    def drop_pending(self) -> None:
        """Abandon unresolved verdicts and unprocessed trips — a
        rollback restored state from BEFORE the checked iterations, so
        their verdicts describe a discarded timeline."""
        self._pending = []
        self._trips_out = []

    def reset_trips(self) -> None:
        """Re-arm the escalation threshold after a rollback: trips are
        counted per recovery epoch, ``total_trips`` keeps the life
        total."""
        self.trips = 0

    # -- quantized-path tripwire ----------------------------------------
    def poll_quant_tripwire(self) -> bool:
        """Promote the quantized-histogram overflow-escalation counter
        (``hist.quant_overflow_escalations``, the data-parallel host
        loop's) to a tripwire: sustained escalation past the limit means
        the quantized bins systematically overflow, which per-tree leaf
        checks cannot see. Without an active registry it never trips."""
        reg = obs.active()
        if reg is None:
            return False
        cur = reg.counters.get("hist.quant_overflow_escalations", 0)
        if self._quant_base is None:
            self._quant_base = cur
            return False
        if cur - self._quant_base <= QUANT_ESCALATION_LIMIT \
                or self._quant_warned:
            return False
        self._quant_warned = True
        obs.inc("health.quant_tripwire")
        log.warning(
            "sentinel: quantized-histogram overflow escalated %d times "
            "since training started (limit %d) — consider more "
            "num_grad_quant_bins or disabling gradient quantization",
            int(cur - self._quant_base), QUANT_ESCALATION_LIMIT)
        return True


def read_verdicts(pending: List[Tuple[int, Any]], extra=None):
    """Host values of ``pending``'s verdicts in one read: the tensor
    verdicts joined (on their device) to ``extra`` — a list of float64
    tensors the caller reads anyway — and brought to the host by one
    ``torch.cat(...).cpu()``; host verdicts pass through. Returns
    (verdict values, host float64 array of ``extra``'s part, or None)."""
    extra = list(extra or [])
    n_extra = sum(int(p.numel()) for p in extra)
    dev = [i for i, (_, v) in enumerate(pending) if torch.is_tensor(v)]
    parts = extra + [pending[i][1].to(torch.float64) for i in dev]
    # tpulint: sync-ok(sentinel verdicts ride the evaluation read)
    host = (_device.device_get(torch.cat([p.to(parts[0].device)
                                          for p in parts]))
            if parts else None)
    values: List[Any] = [v for _, v in pending]
    for j, i in enumerate(dev):
        values[i] = host[n_extra + 2 * j:n_extra + 2 * j + 2]
    return values, (host[:n_extra] if extra else None)


# -- degraded-mode ladder -------------------------------------------------
# rung order: cheapest capability lost first
DEGRADED_LADDER = ("pipeline", "device_eval", "aot_store")


def apply_degraded_rung(gbdt, rung_index: int) -> Optional[str]:
    """Apply ladder rung ``rung_index`` (0-based) to a live booster:
    0 = pipelined loop -> synchronous loop (the engine's loop and the
    fused paths' stop check read ``gbdt._pipeline`` each iteration), 1 =
    metrics on the device -> metrics on a host copy of the scores, 2 =
    the AOT executable store, only logged: the port keeps no executable
    store to turn off (its kernels are nvcc libraries loaded once per
    process). Returns the rung name (also appended to the booster's
    ``degraded_rungs``), or None when the ladder is exhausted."""
    if rung_index >= len(DEGRADED_LADDER):
        return None
    rung = DEGRADED_LADDER[rung_index]
    if rung == "pipeline":
        gbdt._pipeline = False
    elif rung == "device_eval":
        gbdt._device_eval = False
    rungs = getattr(gbdt, "degraded_rungs", None)
    if rungs is not None:
        rungs.append(rung)
    obs.inc("health.degraded")
    log.warning("degraded mode: stepping down rung %d (%s) after repeated "
                "numeric-health trips", rung_index, rung)
    return rung
