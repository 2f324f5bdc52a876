"""The port's static analysis: project-specific rule packs for
lightgbm_tpu_torch.

Nine rule packs over a plain-`ast` model of the package (core.py),
plus a regex model of `csrc/*.cu` for the kernel contracts. The packs
keep the invariants that make the port fast and correct on the card;
each finding names `path:line` with a stable `code`.

Rule catalogue (pack: codes):

- capture-safety (trace_safety.py): inside every `with
  torch.cuda.graph(...)` body and what it calls, `capture-read:*`
  (`.item()`, `.cpu()`, `.tolist()`, `.numpy()`, `device_get`,
  `int()`/`float()`/`bool()` of a captured tensor), `if-captured` /
  `while-captured` / `assert-captured`, `dynamic-shape:*` (`nonzero`,
  `unique`, `masked_select`, boolean masks), `h2d-copy:*` (host ->
  card copies), `rng-draw:*`. Pragma `capture-ok`.
- sync-point (sync_points.py): un-annotated host syncs reachable from
  the iteration roots (`GBDT.train_one_iter`, `GBDT.eval_at_iter`,
  `engine._telemetry_end_iteration`): `device_get`,
  `block_until_ready`, `torch.cuda.synchronize`, `.synchronize()`,
  `.item()` / `.tolist()` / `.cpu()`, `.numpy()` / `int()` / `float()`
  / `bool()` / `np.asarray` of a device value, `torch.nonzero` /
  `unique` / `masked_select` / `mask-index`, `upload:*` (host -> card
  copies). `hot_sync_count()` is the bench's `hot_loop_syncs`. Pragma
  `sync-ok`.
- recompile-hazard (recompile.py): `build-unmanaged:*` (ctypes / nvcc /
  cpp_extension / torch.compile outside ops/cuda.py),
  `capture-unmanaged` (a capture not counted under `graph_captures`),
  `graph-key:*` (a host value baked into the captured step outside
  its key), `stale-ignored:*`, `build-key:*` (a header the library
  name does not hash). Pragmas `build-ok`, `graph-ok`.
- lock-discipline (locks.py): attributes mutated both under and
  outside a class's `with self._lock`. Pragma `lock-ok`.
- collective-axis (collective_axis.py): `dist-outside-network:*`,
  `unmapped-collective`, `psum-of-unpacked`, `pack-after-psum`; the
  process-group inventory is mesh_inventory.py. Pragma `mesh-ok`.
- kernel-contract (kernel_contract.py): `abi-signature:*` (exports vs
  `ops/cuda.py` `_SIGNATURES`), `abi-call:*` (ctypes calls: arity,
  pointer positions, dtype / contiguity checks), `launch-config:*`
  (block size, `__launch_bounds__`, dynamic shared memory opt-in, the
  stream), `bitcast-width:*` (`Tensor.view(dtype)` across widths).
  Pragma `tile-ok` (`// tpulint: tile-ok(...)` in a `.cu` file).
- dtype-flow (dtype_flow.py): `narrow-sum:*`, `packed-as-float`,
  `dequant-before-subtract`, `accum-downcast:*`. Pragma `dtype-ok`.
- buffer-lifetime (lifetime.py): `graph-rebind:*` (a buffer a kept
  graph reads, rebound), `escape-checkpoint` / `escape-flight` /
  `escape-telemetry`, `fetch-no-drain:*` / `fetch-ckpt-live:*` (parked
  `start_read` handles). Pragma `life-ok`.
- thread-shared-state (threads.py): attributes reachable from more
  than one thread mutated without a lock; `spawn_inventory` /
  `thread_names`. Pragma `thread-ok`.
- pragma: `unknown-kind:*`, `missing-reason:*`.

The JAX package's rules without a counterpart here: `jit-unmanaged`,
`entry-signature`, `config-field` (no XLA programs: the captured step
and the nvcc build take their place), `switch-ladder` (no capacity
ladder), `axis-unknown` (no mesh: one process per card), `memspace`,
`tile-lane` / `tile-sublane` / `block-divisibility` / `out-dtype` (no
Pallas BlockSpecs: launch-config checks the CUDA launches),
`donate-escape-closure` / `use-after-donate` (no donation:
graph-rebind is the captured buffers' counterpart).

Pragmas: `# tpulint: <kind>(<reason>)` on the line or alone on the
line above, the JAX package's syntax. The baseline (baseline.json)
only shrinks.

Run `python -m lightgbm_tpu_torch.analysis` (exit 0 = clean against
the checked-in baseline), or call `run()` programmatically;
runtime_check.py holds the packs against a real run.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional

from .core import (  # noqa: F401  (re-exported API)
    Finding,
    Package,
    PRAGMA_KINDS,
    apply_baseline,
    load_baseline,
    save_baseline,
)
from . import (collective_axis, dtype_flow, kernel_contract, lifetime,
               locks, recompile, sync_points, threads, trace_safety)

DEFAULT_BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "baseline.json")

RULE_PACKS = {
    "capture-safety": trace_safety.check,
    "sync-point": sync_points.check,
    "recompile-hazard": recompile.check,
    "lock-discipline": locks.check,
    "collective-axis": collective_axis.check,
    "kernel-contract": kernel_contract.check,
    "dtype-flow": dtype_flow.check,
    "buffer-lifetime": lifetime.check,
    "thread-shared-state": threads.check,
}

# rule name -> per-pack obs gauge (obs/sink.py's schema)
_PACK_GAUGES = {
    "collective-axis": "lint.mesh_findings",
    "kernel-contract": "lint.tile_findings",
    "dtype-flow": "lint.dtype_findings",
    "buffer-lifetime": "lint.life_findings",
    "thread-shared-state": "lint.thread_findings",
}


def pragma_hygiene(pkg: Package) -> List[Finding]:
    """Malformed pragmas are findings themselves: unknown kind, or a
    suppression with no reason."""
    out: List[Finding] = []
    for rel in sorted(pkg.files):
        sf = pkg.files[rel]
        for line in sorted(sf.pragmas):
            for p in sf.pragmas[line]:
                if p.kind not in PRAGMA_KINDS:
                    out.append(Finding(
                        "pragma", rel, line, "", f"unknown-kind:{p.kind}",
                        f"unknown tpulint pragma kind '{p.kind}' (valid: "
                        f"{', '.join(PRAGMA_KINDS)})"))
                elif not p.reason:
                    out.append(Finding(
                        "pragma", rel, line, "", f"missing-reason:{p.kind}",
                        f"tpulint pragma '{p.kind}' needs a reason: "
                        f"# tpulint: {p.kind}(<why this is deliberate>)"))
    return out


def collect(pkg: Package,
            rules: Optional[List[str]] = None) -> List[Finding]:
    """All findings from the selected rule packs (default: all nine
    plus pragma hygiene), in (path, line) order."""
    findings: List[Finding] = []
    for name, fn in RULE_PACKS.items():
        if rules is None or name in rules:
            findings.extend(fn(pkg))
    if rules is None or "pragma" in (rules or []):
        findings.extend(pragma_hygiene(pkg))
    findings.sort(key=lambda f: (f.path, f.line, f.rule, f.code))
    return findings


@dataclasses.dataclass
class RunResult:
    new: List[Finding]          # findings NOT absorbed by the baseline
    baselined: List[Finding]    # findings the baseline absorbed
    baseline_size: int          # total allowed occurrences in the baseline
    hot_sync_count: int         # classified hot-loop sync sites (incl.
    #                             annotated ones) — the bench's metric

    @property
    def ok(self) -> bool:
        return not self.new


def run(root: Optional[str] = None,
        baseline_path: Optional[str] = None,
        rules: Optional[List[str]] = None,
        pkg: Optional[Package] = None) -> RunResult:
    """Analyze the package and apply the baseline.

    Publishes the `lint.findings` / `lint.baseline_size` gauges and the
    per-pack gauges `lint.mesh_findings` / `lint.tile_findings` /
    `lint.dtype_findings` / `lint.life_findings` /
    `lint.thread_findings` to the active obs registry when one is
    installed.
    """
    if pkg is None:
        pkg = Package.load(root)
    findings = collect(pkg, rules)
    if baseline_path is None:
        baseline_path = DEFAULT_BASELINE
    baseline = load_baseline(baseline_path) if baseline_path else {}
    new, baselined = apply_baseline(findings, baseline)
    result = RunResult(new, baselined, sum(baseline.values()),
                       sync_points.hot_sync_count(pkg))
    try:  # telemetry is optional: a failing registry must not fail lint
        from .. import obs
        reg = obs.active()
        if reg is not None:
            reg.set_gauge("lint.findings", float(len(findings)))
            reg.set_gauge("lint.baseline_size", float(result.baseline_size))
            by_rule: Dict[str, int] = {}
            for f in findings:
                by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
            for rule, gauge in _PACK_GAUGES.items():
                if rules is None or rule in rules:
                    reg.set_gauge(gauge, float(by_rule.get(rule, 0)))
    except Exception:
        pass
    return result


def summary(result: RunResult) -> Dict[str, int]:
    by_rule: Dict[str, int] = {}
    for f in result.new:
        by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
    return by_rule
