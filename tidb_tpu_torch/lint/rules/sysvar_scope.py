"""Sysvar scope registry: process-wide knobs are read at GLOBAL scope,
per-session knobs at SESSION scope — statically enforced.

The recurring bug class: a sysvar that configures a PROCESS-WIDE
resource (the residency budget, the admission queue, the compile pool)
read through the session view lets one connection's session-scoped SET
reconfigure shared state out from under every other session
(`tidb_device_mem_budget` last-dispatcher-wins).  The inverse is as bad:
a per-session identity knob (`tidb_resource_group`) read from GLOBAL
scope makes every tenant the same tenant.

``SYSVAR_SCOPE`` below is the declared registry for the sysvars backing
the device serving stack; every ``tidb_device_*`` / ``tidb_compile_*``
sysvar read anywhere in the package MUST be declared here, and every
read site must request the declared scope:

  * a ``<x>.get_sysvar("name")`` call is a SESSION-scope read;
  * a ``<x>.global_vars.get("name", d)`` call (or through a local alias
    ``gv = dom.global_vars``) is a GLOBAL-scope read;
  * a local dispatcher closing over both (``src = lambda n, d:
    gv.get(n, d)`` in the Domain branch, ``ctx.get_sysvar`` in the bare
    fallback) is DUAL — global-first with the documented bare-context
    fallback, the sanctioned discipline for process knobs.

A session read of a process knob is allowed only in a function that
also performs the global read (the explicit Domain-first/bare-fallback
split, e.g. ``residency.attach``); a global or dual read of a session
knob is always a finding.
"""

from __future__ import annotations

import ast

from ..engine import Rule, register
from ._util import const_str, dotted

PROCESS, SESSION = "process", "session"

#: the declared scope of every sysvar backing the device serving stack.
#: PROCESS = the knob configures a process-wide shared resource (queue,
#: pool, ledger, breaker): reads go through the Domain's global_vars so
#: a session-scoped SET cannot reconfigure what other sessions share.
#: SESSION = the knob is per-connection (identity, per-statement
#: behavior): reads go through the session view.
SYSVAR_SCOPE = {
    # admission scheduler (executor/scheduler.py)
    "tidb_device_sched_queue_depth": PROCESS,
    "tidb_device_admission_timeout": PROCESS,
    "tidb_device_tenant_running_cap": PROCESS,
    "tidb_device_wfq_weights": PROCESS,
    # circuit breaker (executor/circuit.py)
    "tidb_device_circuit_threshold": PROCESS,
    "tidb_device_circuit_cooldown": PROCESS,
    # HBM residency ledger (ops/residency.py)
    "tidb_device_mem_budget": PROCESS,
    # compile service (executor/compile_service.py)
    "tidb_compile_workers": PROCESS,
    "tidb_compile_timeout": PROCESS,
    "tidb_compile_prewarm": PROCESS,
    # per-session knobs of the same stack
    "tidb_resource_group": SESSION,
    "tidb_compile_async": SESSION,
    "tidb_device_call_timeout": SESSION,
    "tidb_device_dispatch_rows": SESSION,
    "tidb_device_stream_rows": SESSION,
    "tidb_device_shape_buckets": SESSION,
    "tidb_device_compact": SESSION,
}

#: names outside the registry that still look like serving-stack knobs
#: must be declared (the registry is forced to stay current)
REQUIRED_PREFIXES = ("tidb_device_", "tidb_compile_")

#: the module that DEFINES the sysvar table (SysVar("name", scope, ...)
#: literals are declarations, not reads) and the SET/SHOW machinery that
#: legitimately touches both scopes of every variable
EXEMPT_FILES = {"session/sysvars.py", "session/session.py",
                "session/show.py", "session/memtables.py"}


def _read_sites(fn):
    """(name, kind, line) for every literal sysvar read in `fn`:
    kind session | global | dual."""
    # pass 1: local aliases of <x>.global_vars (alias collection must
    # finish before lambda classification — walk order is not source
    # order)
    gv_aliases = set()
    assigns = []
    for node in ast.walk(fn):
        if not isinstance(node, ast.Assign):
            continue
        names = [t.id for t in node.targets if isinstance(t, ast.Name)]
        if not names:
            continue
        assigns.append((names, node.value))
        if dotted(node.value).endswith("global_vars"):
            gv_aliases.update(names)
    # pass 2: local dual dispatchers (name -> kinds its lambdas wrap)
    dispatchers: dict = {}
    for names, val in assigns:
        if not isinstance(val, ast.Lambda):
            continue
        kinds = set()
        for sub in ast.walk(val.body):
            if isinstance(sub, ast.Call):
                cn = dotted(sub.func)
                leaf = cn.rsplit(".", 1)[-1]
                if leaf == "get_sysvar":
                    kinds.add("session")
                elif leaf == "get" and (
                        "global_vars" in cn
                        or cn.split(".", 1)[0] in gv_aliases):
                    kinds.add("global")
        if kinds:
            d = dispatchers.setdefault(names[0], set())
            d.update(kinds)

    out = []
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call) or not node.args:
            continue
        name = const_str(node.args[0])
        if name is None:
            continue
        cn = dotted(node.func)
        if not cn:
            continue
        leaf = cn.rsplit(".", 1)[-1]
        if leaf == "get_sysvar":
            out.append((name, "session", node.lineno))
        elif leaf == "get" and ("global_vars" in cn
                                or cn.split(".", 1)[0] in gv_aliases):
            out.append((name, "global", node.lineno))
        elif cn in dispatchers:
            kinds = dispatchers[cn]
            kind = "dual" if len(kinds) > 1 else next(iter(kinds))
            out.append((name, kind, node.lineno))
    return out


@register
class SysvarScope(Rule):
    name = "sysvar-scope"
    title = "sysvar reads request their declared process/session scope"

    def run(self, ctx):
        out = []
        seen: dict = {}

        def ident(base):
            k = seen.get(base, 0)
            seen[base] = k + 1
            return base + (f"#{k}" if k else "")

        for sf in ctx.package_files:
            if sf.rel in EXEMPT_FILES:
                continue
            # cheap text gate: no sysvar-read idiom, no AST walk
            if "get_sysvar" not in sf.text and "global_vars" not in sf.text:
                continue
            for node in ast.walk(sf.tree):
                if not isinstance(node, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                    continue
                sites = _read_sites(node)
                if not sites:
                    continue
                qual = sf.qualname(node)
                global_read_names = {n for n, k, _l in sites
                                     if k in ("global", "dual")}
                for name, kind, line in sites:
                    scope = SYSVAR_SCOPE.get(name)
                    if scope is None:
                        if name.startswith(REQUIRED_PREFIXES):
                            out.append(self.finding(
                                sf.rel, line,
                                ident(f"undeclared:{name}@{qual}"),
                                f"sysvar {name} backs the device serving "
                                "stack but has no declared scope — add "
                                "it to lint/rules/sysvar_scope.py "
                                "SYSVAR_SCOPE as process or session"))
                        continue
                    if scope == PROCESS and kind == "session" \
                            and name not in global_read_names:
                        out.append(self.finding(
                            sf.rel, line,
                            ident(f"session-read:{name}@{qual}"),
                            f"{name} configures a process-wide resource "
                            "but is read through the session view: a "
                            "session-scoped SET would reconfigure "
                            "shared state (read the Domain's "
                            "global_vars, with get_sysvar only as the "
                            "bare-context fallback in the same "
                            "function)"))
                    elif scope == SESSION and kind in ("global", "dual"):
                        out.append(self.finding(
                            sf.rel, line,
                            ident(f"global-read:{name}@{qual}"),
                            f"{name} is per-session but is read at "
                            "GLOBAL scope — every connection would see "
                            "one shared value (read it via "
                            "ctx.get_sysvar)"))
        return out
