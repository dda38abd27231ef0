"""Trace coverage: every HOST-DEGRADATION site must leave a mark on the
statement's span trace.

The resilience stack converts classified failures into silent host
fallbacks (``raise DeviceUnsupported`` → the caller's host path).  That
is the right serving behavior — and exactly what made the BENCH_TPU_LIVE
post-mortem blind: a query that "worked" slowly left no record of WHICH
layer (admission refusal, open breaker, pending/failed compile, OOM
ladder, classified runtime failure) pushed it off the device.  With the
span tracer (session/tracing.py) every degradation decision must be
observable: each audited ``raise DeviceUnsupported`` site must either

  * sit lexically inside a ``with tracing.span(...)`` block whose span
    records the exception (the wrapped-chokepoint form), or
  * be preceded, in its immediate statement block, by a
    ``tracing.event(...)`` call (the explicit ``host_degraded`` form),

or carry an allowlist entry with a reason.  Audited functions are the
degradation CHOKEPOINTS — feature-gap ``DeviceUnsupported`` raises
("float group keys", "empty input") live in un-audited builders and are
deliberately out of scope: they are capability statements, not runtime
decisions.
"""

from __future__ import annotations

import ast

from ..engine import Rule, register
from ._util import call_name

#: rel-path -> function names whose DeviceUnsupported raises are
#: degradation decisions (the run_device / compile-service chokepoints)
AUDITED = {
    "executor/device_exec.py": ("run_device", "_run_device_admitted"),
    "executor/compile_service.py": ("obtain", "_obtain_impl"),
    # the hybrid hash join's spill/split decisions: every language-gate
    # or partition-shape DeviceUnsupported inside the entry is a
    # degradation decision and must land on the statement's trace (the
    # join.partition span / join.spill_decision event)
    "executor/hybrid_join.py": ("hybrid_join_agg",),
}

#: an exception raise counts as a degradation site when its constructor
#: leaf-name is one of these
DEGRADE_EXCEPTIONS = ("DeviceUnsupported",)


def _is_trace_call(node, leaves) -> bool:
    if not isinstance(node, ast.Call):
        return False
    name = call_name(node)
    leaf = name.rsplit(".", 1)[-1]
    return leaf in leaves and "trac" in name.lower()


def _raise_exc_leaf(node: ast.Raise) -> str:
    exc = node.exc
    if isinstance(exc, ast.Call):
        return call_name(exc).rsplit(".", 1)[-1]
    if exc is not None:
        from ._util import dotted
        return dotted(exc).rsplit(".", 1)[-1]
    return ""


@register
class TraceCoverage(Rule):
    name = "trace-coverage"
    title = "host-degradation sites emit a span event"

    def run(self, ctx):
        out = []
        for rel, fns in AUDITED.items():
            sf = ctx.file(rel)
            if sf is None:
                continue  # fixture tree without this layer
            parents = sf.parents()
            seen: dict[str, int] = {}
            for top in ast.walk(sf.tree):
                if not (isinstance(top, (ast.FunctionDef,
                                         ast.AsyncFunctionDef))
                        and top.name in fns):
                    continue
                for node in ast.walk(top):
                    if not isinstance(node, ast.Raise):
                        continue
                    if _raise_exc_leaf(node) not in DEGRADE_EXCEPTIONS:
                        continue
                    if self._covered(node, top, parents):
                        continue
                    # ordinal, not lineno: finding identities must be
                    # LINE-INDEPENDENT (engine.py contract — an
                    # allowlist entry survives unrelated edits; same
                    # convention as exception-swallow's '#k')
                    qn = sf.qualname(node)
                    k = seen.get(qn, 0)
                    seen[qn] = k + 1
                    ident = f"degrade@{qn}" + (f"#{k}" if k else "")
                    out.append(self.finding(
                        rel, node.lineno, ident,
                        "host-degradation raise without a trace mark: "
                        "wrap the path in tracing.span(...) or emit "
                        "tracing.event('host_degraded', reason=...) "
                        "before raising (or allowlist with a reason)"))
        return out

    def _covered(self, raise_node, fn, parents) -> bool:
        # (a) lexically inside a `with tracing.span(...)` in the SAME
        # function — the span records the exception type on exit
        node = raise_node
        while node is not None and node is not fn:
            node = parents.get(id(node))
            if isinstance(node, ast.With):
                for item in node.items:
                    if _is_trace_call(item.context_expr, ("span",)):
                        return True
        # (b) a tracing.event(...) earlier in the raise's immediate
        # statement block (the explicit host_degraded convention)
        stmt = raise_node
        while True:
            parent = parents.get(id(stmt))
            if parent is None:
                return False
            block = None
            for attr in ("body", "orelse", "finalbody"):
                lst = getattr(parent, attr, None)
                if isinstance(lst, list) and stmt in lst:
                    block = lst
                    break
            if block is not None:
                break
            stmt = parent
        for sibling in block:
            if sibling.lineno > raise_node.lineno:
                break
            for sub in ast.walk(sibling):
                if _is_trace_call(sub, ("event",)):
                    return True
        return False


#: the propagation helpers (session/tracing.py) a codec-RPC chokepoint
#: must touch: wire_ctx/attach_remote on the client side of a frame,
#: begin_remote on the server side
_PROPAGATE_HELPERS = ("wire_ctx", "begin_remote", "attach_remote")


@register
class CodecRpcTrace(Rule):
    """Every fabric function that writes a codec frame is a
    cross-process RPC chokepoint — it must carry trace context:
    attach :func:`tracing.wire_ctx` to outgoing requests /
    graft the response via :func:`tracing.attach_remote` (client side),
    or record the hop with :func:`tracing.begin_remote` (server side).
    A new RPC op added without propagation is a merge-gating finding —
    the exact blind spot the fleet observability plane exists to close.
    ``fabric/codec.py`` itself (the transport, below the op layer) is
    exempt by construction."""

    name = "codec-rpc-trace"
    title = "codec RPC chokepoints propagate trace context"

    def run(self, ctx):
        out = []
        for sf in ctx.package_files:
            if (not sf.rel.startswith("fabric/")
                    or sf.rel == "fabric/codec.py"):
                continue
            for top in ast.walk(sf.tree):
                if not isinstance(top, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                    continue
                writes = propagates = False
                for node in ast.walk(top):
                    if (isinstance(node, ast.Call)
                            and call_name(node).rsplit(".", 1)[-1]
                            == "write_frame"):
                        writes = True
                    if (isinstance(node, ast.Attribute)
                            and node.attr in _PROPAGATE_HELPERS) or \
                            (isinstance(node, ast.Name)
                             and node.id in _PROPAGATE_HELPERS):
                        propagates = True
                if writes and not propagates:
                    qn = sf.qualname(top)
                    out.append(self.finding(
                        sf.rel, top.lineno, f"rpc@{qn}",
                        "codec RPC chokepoint without trace propagation: "
                        "attach tracing.wire_ctx() to the request and "
                        "tracing.attach_remote() the response (client), "
                        "or tracing.begin_remote(req.pop('trace', None), "
                        "...) around the handler (server) — or allowlist "
                        "with a reason"))
        return out
