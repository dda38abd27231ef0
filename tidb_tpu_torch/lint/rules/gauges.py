"""Gauge consistency: every gauge a subsystem publishes into the observe
registry must also be SURFACED on the two human-facing planes —

  * EXPLAIN ANALYZE annotations (executor/exec_select.py ``annotate``,
    directly or via a splatted ``report_gauges()``), and
  * the HTTP status port (server/http_status.py ``/status`` via the
    module ``snapshot()`` payloads; ``/metrics`` re-exports every observe
    gauge generically, so publishing alone covers it).

A gauge visible in /metrics but absent from EXPLAIN ANALYZE (or vice
versa) is how the observability once drifted name-by-name; this rule
pins the set statically.

Published names are collected from (a) literal first args of
``set_gauge`` calls, (b) literal dict keys / f-string prefixes /
subscript stores inside functions named ``_publish_gauges`` or
``report_gauges``.  Label-style suffixes (``sched_degradations:<group>``)
are normalized to their base name.
"""

from __future__ import annotations

import ast

from ..engine import Rule, register
from ._util import call_name, const_str

PUBLISH_FNS = ("_publish_gauges", "report_gauges")
STATUS_REL = "server/http_status.py"

#: fleet-era observability inventory: counters and
#: perf-store fields that flow through the fabric snapshot()/stats()
#: payloads rather than set_gauge / report_gauges, so the inference
#: below cannot see them.  Each name must appear as a literal BOTH in
#: its publishing module and in server/http_status.py — adding a field
#: to one side without the other is exactly the name-by-name drift this
#: rule exists to stop.
FLEET_INVENTORY = {
    "fabric/state.py": (
        "fabric_workers", "fabric_respawns", "fabric_dedup_hits",
        "fabric_compile_rtt_ms", "fleet_cache_hits",
        "fabric_perf_rows", "fabric_perf_samples",
        # fleet-frontier freshness: bumped by
        # kv/shared_store.fresh_read_ts, surfaced via report_gauges
        # (EXPLAIN ANALYZE) and /metrics
        "freshness_waits", "freshness_timeouts", "freshness_stale_ok"),
    "fabric/perf.py": ("perf_notes", "perf_merged"),
    # the span-ring eviction counter behind trace_ring_dropped_total
    "session/tracing.py": ("ring_dropped",),
}


def _base(name: str) -> str:
    return name.split(":", 1)[0]


def _fn_string_keys(fn: ast.AST) -> set:
    """Gauge-name candidates inside a publish/report function: dict keys,
    f-string key prefixes, literal subscript stores."""
    out = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Dict):
            for k in node.keys:
                s = const_str(k)
                if s:
                    out.add(s)
                elif isinstance(k, ast.JoinedStr) and k.values:
                    first = k.values[0]
                    if (isinstance(first, ast.Constant)
                            and isinstance(first.value, str)):
                        out.add(first.value.rstrip(":"))
        if (isinstance(node, ast.Subscript)
                and isinstance(node.ctx, ast.Store)):
            s = const_str(node.slice)
            if s:
                out.add(s)
    return out


def _module_fn_literals(sf, fn_names) -> set:
    """All string literals inside the named top-level functions of sf."""
    out = set()
    for node in sf.tree.body:
        if (isinstance(node, ast.FunctionDef) and node.name in fn_names):
            for sub in ast.walk(node):
                if (isinstance(sub, ast.Constant)
                        and isinstance(sub.value, str)):
                    out.add(sub.value)
                elif isinstance(sub, ast.JoinedStr):
                    for v in sub.values:
                        if (isinstance(v, ast.Constant)
                                and isinstance(v.value, str)):
                            out.add(v.value.rstrip(":"))
    return out


def _referenced_modules(sf) -> set:
    """Module local-names whose report_gauges()/snapshot() sf calls."""
    mods = set()
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Call):
            name = call_name(node)
            if "." in name and name.rsplit(".", 1)[-1] in (
                    "report_gauges", "snapshot"):
                mods.add(name.rsplit(".", 1)[0].rsplit(".", 1)[-1])
    return mods


@register
class GaugeConsistency(Rule):
    name = "gauge-consistency"
    title = "published gauges surfaced in EXPLAIN ANALYZE and /status"

    def run(self, ctx):
        status_sf = ctx.file(STATUS_REL)
        if status_sf is None:
            return []  # fixture tree without the serving surface

        by_module = {sf.rel.rsplit("/", 1)[-1][:-3]: sf
                     for sf in ctx.package_files}

        # -- published gauge names -----------------------------------------
        published = []  # (name, rel, line)
        for sf in ctx.package_files:
            if sf.rel.startswith("lint/"):
                continue
            for node in ast.walk(sf.tree):
                if (isinstance(node, ast.Call)
                        and call_name(node).rsplit(".", 1)[-1] ==
                        "set_gauge" and node.args):
                    s = const_str(node.args[0])
                    if s:
                        published.append((_base(s), sf.rel, node.lineno))
            for top in sf.tree.body:
                if (isinstance(top, ast.FunctionDef)
                        and top.name in PUBLISH_FNS):
                    # report_gauges() feeds _publish_gauges in several
                    # modules (mpp_exec builds its dict there), so both
                    # are publish sources
                    for s in _fn_string_keys(top):
                        published.append((_base(s), sf.rel, top.lineno))

        # -- surfaced sets --------------------------------------------------
        # /status side: literals in http_status.py + the snapshot()
        # payload keys of every module it reads
        status_names = {s for s in _all_literals(status_sf)}
        for mod in _referenced_modules(status_sf):
            sf = by_module.get(mod)
            if sf is not None:
                status_names |= _module_fn_literals(
                    sf, ("snapshot", "report_gauges"))
        # EXPLAIN ANALYZE side: any file calling .annotate(...) counts as
        # an annotation surface — its literals plus the report_gauges()
        # keys of modules it splats
        explain_names = set()
        for sf in ctx.package_files:
            if sf.rel.startswith("lint/"):
                continue
            annotate_calls = [
                n for n in ast.walk(sf.tree)
                if isinstance(n, ast.Call)
                and call_name(n).rsplit(".", 1)[-1] == "annotate"]
            if not annotate_calls:
                continue
            explain_names |= _all_literals(sf)
            # annotate(gauge_name=value): the KEYWORD is the surfaced key
            for call in annotate_calls:
                for kw in call.keywords:
                    if kw.arg:
                        explain_names.add(kw.arg)
            for mod in _referenced_modules(sf):
                m = by_module.get(mod)
                if m is not None:
                    explain_names |= _module_fn_literals(
                        m, ("report_gauges",))

        out = []
        seen = set()
        for name, rel, line in sorted(published):
            if name in seen:
                continue
            seen.add(name)
            if name not in status_names:
                out.append(self.finding(
                    rel, line, f"unsurfaced-status:{name}",
                    f"gauge '{name}' is published but absent from the "
                    "/status payload (module snapshot())"))
            if name not in explain_names:
                out.append(self.finding(
                    rel, line, f"unsurfaced-explain:{name}",
                    f"gauge '{name}' is published but never annotated "
                    "into EXPLAIN ANALYZE"))
        out += self._check_histograms(ctx)
        out += self._check_fleet_inventory(ctx, status_sf)
        return out

    def _check_fleet_inventory(self, ctx, status_sf):
        """Pin the FLEET_INVENTORY names on both ends: the publishing
        module must still emit each field, and /metrics must still
        surface it."""
        out = []
        status_lits = _all_literals(status_sf)
        for rel, names in sorted(FLEET_INVENTORY.items()):
            sf = ctx.file(rel)
            if sf is None:
                continue  # fixture tree without the fabric modules
            lits = _all_literals(sf)
            for name in names:
                if name not in lits:
                    out.append(self.finding(
                        rel, 1, f"fleet-inventory-source:{name}",
                        f"fleet observability field '{name}' is in the "
                        "lint inventory but its publishing module no "
                        "longer mentions it"))
                if name not in status_lits:
                    out.append(self.finding(
                        status_sf.rel, 1,
                        f"fleet-inventory-status:{name}",
                        f"fleet observability field '{name}' (published "
                        f"by {rel}) is absent from /metrics "
                        "(server/http_status.py)"))
        return out

    def _check_histograms(self, ctx):
        """The histogram analog of the gauge check: every `observe_hist`
        call must name a key of the HIST_BUCKETS registry
        (session/observe.py — the literal dict /metrics renders as
        `_bucket`/`_sum`/`_count` series), and every registry key must
        have a caller — a documented-but-dead histogram name is the same
        drift the gauge rule pins."""
        obs_sf = ctx.file("session/observe.py")
        if obs_sf is None:
            return []
        registry = {}
        for node in obs_sf.tree.body:
            if (isinstance(node, ast.Assign) and node.targets
                    and isinstance(node.targets[0], ast.Name)
                    and node.targets[0].id == "HIST_BUCKETS"
                    and isinstance(node.value, ast.Dict)):
                for k in node.value.keys:
                    s = const_str(k)
                    if s:
                        registry[s] = node.lineno
        observed = []  # (name, rel, line)
        for sf in ctx.package_files:
            if sf.rel.startswith("lint/"):
                continue
            for node in ast.walk(sf.tree):
                if (isinstance(node, ast.Call)
                        and call_name(node).rsplit(".", 1)[-1] in
                        ("observe_hist", "_observe_hist") and node.args):
                    s = const_str(node.args[0])
                    if s:
                        observed.append((s, sf.rel, node.lineno))
        out = []
        seen = set()
        for name, rel, line in sorted(observed):
            if rel == "session/observe.py" or name in seen:
                continue  # the registry's own recorder method
            seen.add(name)
            if name not in registry:
                out.append(self.finding(
                    rel, line, f"unregistered-hist:{name}",
                    f"histogram '{name}' is observed but not a key of "
                    "session/observe.py HIST_BUCKETS (the /metrics "
                    "bucket registry)"))
        for name, line in sorted(registry.items()):
            if name not in seen:
                out.append(self.finding(
                    obs_sf.rel, line, f"unobserved-hist:{name}",
                    f"histogram '{name}' is registered in HIST_BUCKETS "
                    "but nothing ever observes it"))
        return out


def _all_literals(sf) -> set:
    out = set()
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            out.add(node.value)
        elif isinstance(node, ast.JoinedStr):
            for v in node.values:
                if isinstance(v, ast.Constant) and isinstance(
                        v.value, str):
                    out.add(v.value.rstrip(":"))
    return out
