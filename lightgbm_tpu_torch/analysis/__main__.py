"""CLI: `python -m lightgbm_tpu_torch.analysis`.

Exit status 0 iff every finding is absorbed by the baseline. Typical
use:

    python -m lightgbm_tpu_torch.analysis                 # lint the repo
    python -m lightgbm_tpu_torch.analysis --format json   # machine-readable
    python -m lightgbm_tpu_torch.analysis --rules sync-point,lock-discipline
    python -m lightgbm_tpu_torch.analysis --write-baseline  # re-audit ONLY:
        # regenerates baseline.json from current findings. The baseline
        # workflow is shrink-only.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from . import (DEFAULT_BASELINE, Package, RULE_PACKS, collect, run,
               save_baseline, summary)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m lightgbm_tpu_torch.analysis",
        description="static analysis of lightgbm_tpu_torch (the port's "
                    "rule packs)")
    ap.add_argument("--root", default=None,
                    help="repo root to analyze (default: this checkout)")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    help="baseline JSON path (default: the checked-in one)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="report every finding, ignoring the baseline")
    ap.add_argument("--write-baseline", action="store_true",
                    help="regenerate the baseline from current findings "
                         "(re-audit only; the baseline never grows in "
                         "normal workflow)")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule subset: "
                         + ",".join(RULE_PACKS) + ",pragma")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--json", action="store_true",
                    help="shorthand for --format json (CI artifacts)")
    args = ap.parse_args(argv)
    if args.json:
        args.format = "json"

    rules = args.rules.split(",") if args.rules else None
    if args.write_baseline:
        pkg = Package.load(args.root)
        findings = collect(pkg, rules)
        entries = save_baseline(args.baseline, findings)
        print(f"wrote {args.baseline}: {sum(entries.values())} occurrences "
              f"across {len(entries)} keys")
        return 0

    result = run(args.root, "" if args.no_baseline else args.baseline,
                 rules)
    if args.no_baseline:
        result.new.extend(result.baselined)
        result.baselined = []
        result.new.sort(key=lambda f: (f.path, f.line, f.rule, f.code))

    if args.format == "json":
        # by_pack: every ENABLED pack with its new-finding count, zero
        # included — the CI artifact must show a pack ran and was
        # clean, not merely omit it
        enabled = [r for r in RULE_PACKS if rules is None or r in rules]
        by_rule = summary(result)
        print(json.dumps({
            "ok": result.ok,
            "by_rule": by_rule,
            "by_pack": {r: by_rule.get(r, 0) for r in enabled},
            "new": [{**vars(f), "location": f"{f.path}:{f.line}"}
                    for f in result.new],
            "baselined": len(result.baselined),
            "baseline_size": result.baseline_size,
            "hot_sync_count": result.hot_sync_count,
        }, indent=1))
    else:
        for f in result.new:
            print(str(f))
        by_rule = summary(result)
        tail = ("  [" + ", ".join(f"{k}: {v}" for k, v in
                                  sorted(by_rule.items())) + "]"
                if by_rule else "")
        print(f"tpulint: {len(result.new)} new finding(s){tail}, "
              f"{len(result.baselined)} baselined "
              f"(baseline budget {result.baseline_size}), "
              f"{result.hot_sync_count} hot-loop sync site(s)")
    return 0 if result.ok else 1


if __name__ == "__main__":
    sys.exit(main())
