"""Fault tolerance: checkpoint/resume, fault injection, self-healing
(the JAX package's robust/).

- `checkpoint`: periodic atomic training checkpoints (model text + the
  loop's whole state) and resume — a preempted run continues from the
  last checkpoint and finishes with a model text byte-identical to the
  uninterrupted run. The file format is the JAX package's: each
  package reads the other's checkpoints.
- `faultinject`: named injection seams (checkpoint writes, the boosting
  loop, collective dispatch, the sentinel) driven by the
  `LGBM_TPU_FAULT_PLAN` spec, so every recovery path has a test that
  exercises the failure.
- `watchdog`: deadman timer over the training loop — a hang is
  detected within `hang_timeout`, classified (collective / dispatch /
  readback / host-callback), and either aborted with an actionable
  error or auto-resumed from the last checkpoint.
- `sentinel`: numeric-health checks on new trees and gradient planes,
  with quarantine-and-rollback recovery and a degraded-mode ladder.
"""
from .checkpoint import CheckpointError, CheckpointManager
from .faultinject import (FaultPlan, active_plan, check_fault,
                          filter_bytes, install_plan)
from .sentinel import (DEGRADED_LADDER, NumericSentinel,
                       apply_degraded_rung)
from .watchdog import (HangTimeout, Watchdog, activate_watchdog,
                       active_watchdog, classify_stall,
                       deactivate_watchdog, watch_phase)

__all__ = [
    "CheckpointError", "CheckpointManager",
    "FaultPlan", "active_plan", "check_fault", "filter_bytes",
    "install_plan",
    "DEGRADED_LADDER", "NumericSentinel", "apply_degraded_rung",
    "HangTimeout", "Watchdog", "activate_watchdog", "active_watchdog",
    "classify_stall", "deactivate_watchdog", "watch_phase",
]
