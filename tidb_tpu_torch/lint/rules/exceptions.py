"""Exception-swallow detection: an ``except Exception`` (or broader)
handler that neither re-raises nor routes the error through the
classified taxonomy / logging spine hides failures the resilience stack
was built to classify (utils/backoff.classify -> breaker/slow-log).

A handler is considered ROUTED when its body (transitively, nested
statements included) does any of:

  * ``raise`` (re-raise or wrap),
  * call ``classify(...)`` / ``is_device_oom(...)`` (taxonomy),
  * call a logging method (``log.warning`` / ``logger.exception`` /
    ``logging.error`` ... — any receiver whose name contains "log"),
  * call ``traceback.print_exc`` / ``format_exc`` (diagnostics surfaced),
  * call ``record(...)`` on a breaker (the error is charged),

Intentionally-silent handlers (gauge publishing, best-effort cleanup)
get an allowlist entry with a one-line reason — the burn-down file is
the complete inventory of every swallowed error in the package.
"""

from __future__ import annotations

import ast

from ..engine import Rule, register
from ._util import call_name

#: function/method names whose CALL inside a handler counts as routing
#: the error into the taxonomy / observability spine
ROUTING_CALLS = {"classify", "is_device_oom", "record", "record_failure",
                 "print_exc", "format_exc"}

#: logging method names (receiver must look like a logger: name contains
#: "log" — log, _log, logger, logging, self.log ...)
LOG_METHODS = {"debug", "info", "warning", "warn", "error", "exception",
               "critical"}


def _is_broad(handler: ast.ExceptHandler) -> str | None:
    """'Exception' / 'BaseException' / 'bare' when the handler catches
    broadly, else None (typed handlers are deliberate matches)."""
    t = handler.type
    if t is None:
        return "bare"
    names = []
    if isinstance(t, ast.Tuple):
        names = [e.id for e in t.elts if isinstance(e, ast.Name)]
    elif isinstance(t, ast.Name):
        names = [t.id]
    elif isinstance(t, ast.Attribute):
        names = [t.attr]
    for n in names:
        if n in ("Exception", "BaseException"):
            return n
    return None


def _refs_name(node, name: str) -> bool:
    return name and any(
        isinstance(n, ast.Name) and n.id == name for n in ast.walk(node))


def _routes(handler: ast.ExceptHandler) -> bool:
    exc_name = handler.name or ""
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise):
            return True
        if isinstance(node, ast.Call):
            name = call_name(node)
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ROUTING_CALLS:
                return True
            if leaf in LOG_METHODS and "." in name:
                recv = name.rsplit(".", 1)[0]
                if "log" in recv.lower():
                    return True
            # the bound exception handed to ANY call is captured, not
            # dropped (job.fail(str(e)), self._signal(error=e), ...)
            if exc_name and (any(_refs_name(a, exc_name)
                                 for a in node.args)
                             or any(_refs_name(kw.value, exc_name)
                                    for kw in node.keywords)):
                return True
        # ... likewise stored for later surfacing (job.error = e)
        if isinstance(node, ast.Assign) and _refs_name(node.value,
                                                       exc_name):
            return True
        if isinstance(node, ast.Return) and node.value is not None \
                and _refs_name(node.value, exc_name):
            return True
    return False


@register
class ExceptionSwallow(Rule):
    name = "exception-swallow"
    title = "broad except handlers route through taxonomy/logging"

    def run(self, ctx):
        out = []
        for sf in ctx.package_files:
            seen: dict[str, int] = {}
            for node in ast.walk(sf.tree):
                if not isinstance(node, ast.ExceptHandler):
                    continue
                broad = _is_broad(node)
                if broad is None or _routes(node):
                    continue
                qn = sf.qualname(node)
                # ordinal disambiguates multiple swallowing handlers in
                # one function while staying line-independent
                k = seen.get(qn, 0)
                seen[qn] = k + 1
                ident = f"swallow@{qn}" + (f"#{k}" if k else "")
                what = ("bare except:" if broad == "bare"
                        else f"except {broad}")
                out.append(self.finding(
                    sf.rel, node.lineno, ident,
                    f"{what} swallows the error silently (re-raise, "
                    "classify, or log — or allowlist with a reason)"))
        return out
