"""Failpoint catalog coverage: every ``failpoint.inject("name")`` site in
the package must appear in at least one chaos catalog
(tests/chaos_harness.py READ_FAULTS / WRITE_FAULTS / THREADED_FAULTS /
FLEET_FAULTS / HOST_FAULTS) — an uncataloged failpoint is a fault hook
no chaos seed ever exercises, i.e. a recovery path with zero coverage.
"""

from __future__ import annotations

import ast

from ..engine import Rule, register
from ._util import call_name, const_str

#: the catalog dict names in the chaos harness (FLEET_FAULTS holds the
#: process-level faults bench_serve's --procs mode injects via worker
#: spawn env — in-process seeds cannot SIGKILL themselves; HOST_FAULTS
#: holds the whole-host kills the multi-host failover bench injects)
CATALOG_NAMES = ("READ_FAULTS", "WRITE_FAULTS", "THREADED_FAULTS",
                 "FLEET_FAULTS", "HOST_FAULTS")
HARNESS_REL = "tests/chaos_harness.py"


def catalog_names(harness_tree) -> set:
    names = set()
    for node in ast.walk(harness_tree):
        if not isinstance(node, ast.Assign):
            continue
        for tgt in node.targets:
            if (isinstance(tgt, ast.Name) and tgt.id in CATALOG_NAMES
                    and isinstance(node.value, ast.Dict)):
                for k in node.value.keys:
                    s = const_str(k)
                    if s:
                        names.add(s)
    return names


@register
class FailpointCoverage(Rule):
    name = "failpoint-coverage"
    title = "every inject() name appears in a chaos catalog"

    def run(self, ctx):
        harness = ctx.file(HARNESS_REL)
        known = catalog_names(harness.tree) if harness is not None else None
        out = []
        for sf in ctx.package_files:
            for node in ast.walk(sf.tree):
                if not isinstance(node, ast.Call):
                    continue
                if call_name(node).rsplit(".", 1)[-1] != "inject":
                    continue
                if not node.args:
                    continue
                name = const_str(node.args[0])
                if name is None:
                    out.append(self.finding(
                        sf.rel, node.lineno,
                        f"inject-nonliteral@{sf.qualname(node)}",
                        "failpoint.inject with a non-literal name cannot "
                        "be catalog-checked — use a string literal"))
                    continue
                if known is not None and name not in known:
                    out.append(self.finding(
                        sf.rel, node.lineno, f"uncataloged:{name}",
                        f"failpoint '{name}' appears in no chaos catalog "
                        f"({'/'.join(CATALOG_NAMES)}) — no seed ever "
                        "exercises its recovery path"))
        return out
