"""CLI: ``python -m tidb_tpu_torch.lint [--json] [--rule NAME] [--rules a,b]
[--path GLOB] [--stats] [--allowlist F] [--write-baseline] [--list]
[ROOT]``.

Exit status 0 = clean (no unallowlisted findings, no stale allowlist
entries), 1 = findings / stale entries, 2 = usage or allowlist parse
error.  ``--write-baseline`` appends every current finding to the
allowlist with a TODO reason, so a new rule can land red-free and burn
down incrementally.

Development filters: ``--rule NAME`` (repeatable; merged with
``--rules``) runs a subset — a single-rule run skips every other rule's
analysis, so e.g. ``--rule exception-swallow`` never pays the lock-model
and guard-inference fixpoints.  ``--path GLOB`` (repeatable) keeps only
findings whose package-relative file matches; the stale-allowlist check
is skipped under a path filter (it cannot distinguish stale from
filtered-out).  ``--stats`` appends a per-rule wall-time table.
"""

from __future__ import annotations

import argparse
import json
import sys

from . import rules  # noqa: F401 - populates the registry
from .engine import (Allowlist, RULES, collect, default_allowlist_path,
                     run_rules, write_baseline)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tidb_tpu_torch.lint",
        description="one-pass project static analysis")
    ap.add_argument("root", nargs="?", default=None,
                    help="repo root (default: auto-detected)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable report on stdout")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule subset (default: all)")
    ap.add_argument("--rule", action="append", default=None,
                    dest="rule", metavar="NAME",
                    help="run one rule (repeatable; merged with --rules)")
    ap.add_argument("--path", action="append", default=None,
                    dest="paths", metavar="GLOB",
                    help="only report findings whose package-relative "
                         "file matches GLOB (repeatable; skips the "
                         "stale-allowlist check)")
    ap.add_argument("--stats", action="store_true",
                    help="append a per-rule wall-time table")
    ap.add_argument("--allowlist", default=None,
                    help="allowlist file (default: "
                         "tidb_tpu_torch/lint/allowlist.txt)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="append current findings to the allowlist as "
                         "TODO entries, then exit 0")
    ap.add_argument("--list", action="store_true", dest="list_rules",
                    help="list registered rules and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        for name in sorted(RULES):
            print(f"{name:28s} {RULES[name].title}")
        return 0

    names = None
    if args.rules or args.rule:
        names = [r.strip() for r in (args.rules or "").split(",")
                 if r.strip()]
        for r in (args.rule or []):
            if r not in names:
                names.append(r)
        unknown = [r for r in names if r not in RULES]
        if unknown:
            print(f"unknown rule(s): {', '.join(unknown)} "
                  f"(--list shows the registry)", file=sys.stderr)
            return 2

    al_path = args.allowlist or default_allowlist_path()
    try:
        al = Allowlist.load(al_path)
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return 2

    ctx = collect(args.root)
    report = run_rules(ctx, al, names, paths=args.paths)

    if args.write_baseline:
        write_baseline(report, al_path)
        print(f"wrote {len(report.findings)} baseline entr(ies) to "
              f"{al_path}")
        return 0

    if args.as_json:
        print(json.dumps(report.to_json(), indent=1))
    else:
        print(report.human())
        if args.stats:
            total = sum(report.timings.values())
            for name, secs in sorted(report.timings.items(),
                                     key=lambda kv: -kv[1]):
                print(f"  {secs * 1e3:9.1f}ms  {name}")
            print(f"  {total * 1e3:9.1f}ms  total "
                  f"({len(report.rules_run)} rules)")
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
