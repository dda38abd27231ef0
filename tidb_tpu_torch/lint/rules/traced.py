"""Host synchronisations inside pipeline bodies — the port's counterpart
of the reference's ``traced-value-hazard``.

The port has no trace: a pipeline (``executor/device_exec.py``
``_timed_jit`` / ``_Pipeline``) is plain Python over the kernels, run
once per dispatch.  A Python decision on a device tensor's VALUE inside
one is not an error but a host synchronisation: the host waits for the
card to finish every kernel queued before it, reads the value back, and
only then queues the next launch — the card idles for the round trip.
Each such site is either repaired or inventoried in the allowlist with
what the value is (a Python int by contract costs nothing; a count read
from the card costs one sync a call).

A pipeline body is a function handed to ``_timed_jit`` or ``_Pipeline``,
or to a helper of the same module that hands its own parameter on to
one (``parallel/mpp.py _built``).  Flagged inside a body, for ``p`` any
of its parameters or a local computed from one (``m = x.sum()``, ``for
v in p``; to a fixpoint over the body's assignments):

  * ``if p`` / ``while p`` / ``assert p`` / ternary tests referencing
    ``p``'s value (``p.shape``/``p.ndim``/``p.dtype``/``p.device`` and
    ``len(p)`` are host metadata and fine),
  * ``int(p)`` / ``float(p)`` / ``bool(p)`` / ``p.item()`` /
    ``p.tolist()`` reads,
  * ``range(p)`` / ``for ... in p`` Python iteration,
  * ``np.asarray(p)`` / ``np.array(p)`` host materialization.

The rule reads no types: a parameter that is a Python int, or a local
that is a host list of tensors, is flagged the same as a device value,
and its allowlist entry says so.
"""

from __future__ import annotations

import ast

from ..engine import Rule, register
from ._util import call_name

PIPELINE_WRAPPERS = {"_timed_jit", "_Pipeline"}
STATIC_ATTRS = {"shape", "ndim", "dtype", "size", "device", "is_cuda",
                "layout"}
NUMPY_ALIASES = {"np", "numpy", "onp"}


def _wrappers(sf) -> set:
    """PIPELINE_WRAPPERS plus the module's helpers that hand a parameter
    of their own to one as its first argument (to a fixpoint)."""
    out = set(PIPELINE_WRAPPERS)
    fns = [n for n in sf.tree.body if isinstance(n, ast.FunctionDef)]
    changed = True
    while changed:
        changed = False
        for fn in fns:
            if fn.name in out:
                continue
            params = {a.arg for a in fn.args.posonlyargs + fn.args.args}
            for node in ast.walk(fn):
                if (isinstance(node, ast.Call) and node.args
                        and call_name(node).rsplit(".", 1)[-1] in out
                        and isinstance(node.args[0], ast.Name)
                        and node.args[0].id in params):
                    out.add(fn.name)
                    changed = True
                    break
    return out


def _pipeline_targets(sf) -> list:
    """Every pipeline body in the file: a def whose name is the first
    argument of a wrapper call in the same scope chain."""
    wrappers = _wrappers(sf)
    defs_by_name: dict[str, list] = {}
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.FunctionDef):
            defs_by_name.setdefault(node.name, []).append(node)
    out, seen = [], set()
    for node in ast.walk(sf.tree):
        if (isinstance(node, ast.Call) and node.args
                and call_name(node).rsplit(".", 1)[-1] in wrappers
                and isinstance(node.args[0], ast.Name)):
            for fn in defs_by_name.get(node.args[0].id, []):
                if id(fn) not in seen and fn.name not in wrappers:
                    seen.add(id(fn))
                    out.append(fn)
    return out


def _refs_value(node, params: set) -> bool:
    """Does this expression depend on a parameter's VALUE (shape/dtype/
    device/len derivations are host metadata and do not count)?"""
    if isinstance(node, ast.Name):
        return node.id in params
    if isinstance(node, ast.Attribute):
        if node.attr in STATIC_ATTRS:
            return False
        return _refs_value(node.value, params)
    if isinstance(node, ast.Call):
        leaf = call_name(node).rsplit(".", 1)[-1]
        if leaf == "len":
            return False
        return _refs_value(node.func, params) or \
            any(_refs_value(a, params) for a in node.args) or \
            any(_refs_value(kw.value, params) for kw in node.keywords)
    return any(_refs_value(c, params)
               for c in ast.iter_child_nodes(node))


def _bound_names(target):
    if isinstance(target, ast.Name):
        yield target.id
    elif isinstance(target, (ast.Tuple, ast.List)):
        for e in target.elts:
            yield from _bound_names(e)
    elif isinstance(target, ast.Starred):
        yield from _bound_names(target.value)


_SCOPES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda, ast.ClassDef)


def _own_nodes(fn):
    """The nodes of `fn`'s body outside its nested scopes."""
    stack = [n for n in fn.body if not isinstance(n, _SCOPES)]
    while stack:
        node = stack.pop()
        yield node
        stack += [c for c in ast.iter_child_nodes(node)
                  if not isinstance(c, _SCOPES)]


def _derived(fn, params: set) -> set:
    """`params` plus every name of `fn`'s own scope bound from an
    expression that depends on their values (an assignment, an augmented
    or annotated one, a ``for`` target, a walrus), to a fixpoint."""
    out = set(params)
    changed = True
    while changed:
        changed = False
        for node in _own_nodes(fn):
            if isinstance(node, ast.Assign):
                pairs = [(t, node.value) for t in node.targets]
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign,
                                   ast.NamedExpr)) and \
                    node.value is not None:
                pairs = [(node.target, node.value)]
            elif isinstance(node, ast.For):
                pairs = [(node.target, node.iter)]
            else:
                continue
            for target, value in pairs:
                if _refs_value(value, out):
                    new = set(_bound_names(target)) - out
                    out |= new
                    changed |= bool(new)
    return out


@register
class PipelineHostSync(Rule):
    name = "pipeline-host-sync"
    title = "host synchronisations inside pipeline bodies inventoried"

    def run(self, ctx):
        out = []
        for sf in ctx.package_files:
            for fn in _pipeline_targets(sf):
                params = {a.arg for a in (fn.args.posonlyargs
                                          + fn.args.args
                                          + fn.args.kwonlyargs)}
                params.discard("self")
                params = _derived(fn, params)
                if params:
                    out.extend(self._scan(sf, fn, params))
        return out

    def _scan(self, sf, fn, params):
        out = []
        seen: dict[str, int] = {}

        def emit(node, kind, msg):
            base = f"{kind}@{sf.qualname(fn)}"
            k = seen.get(base, 0)
            seen[base] = k + 1
            ident = base + (f"#{k}" if k else "")
            out.append(self.finding(sf.rel, node.lineno, ident, msg))

        def visit(node, params):
            if isinstance(node, ast.FunctionDef) and node is not fn:
                # nested def: shadowed names are its own params; its
                # locals carry what it reads of the enclosing values
                inner = _derived(node, params - {a.arg for a in (
                    node.args.posonlyargs + node.args.args
                    + node.args.kwonlyargs)})
                for c in node.body:
                    visit(c, inner)
                return
            if isinstance(node, (ast.If, ast.While)) and _refs_value(
                    node.test, params):
                emit(node, "branch",
                     "host sync: Python control flow on a pipeline "
                     "argument's value (a device value is read back "
                     "before the next launch)")
            if isinstance(node, ast.IfExp) and _refs_value(
                    node.test, params):
                emit(node, "branch",
                     "host sync: ternary on a pipeline argument's value")
            if isinstance(node, ast.Assert) and _refs_value(
                    node.test, params):
                emit(node, "branch",
                     "host sync: assert on a pipeline argument's value")
            if isinstance(node, ast.Call):
                leaf = call_name(node).rsplit(".", 1)[-1]
                head = call_name(node).split(".", 1)[0]
                if leaf in ("int", "float", "bool") and "." not in \
                        call_name(node) and any(
                            _refs_value(a, params) for a in node.args):
                    emit(node, leaf,
                         f"host sync: {leaf}() of a pipeline argument's "
                         "value")
                meth = (node.func.attr
                        if isinstance(node.func, ast.Attribute) else "")
                if meth in ("item", "tolist") and _refs_value(
                        node.func.value, params):
                    emit(node, meth,
                         f"host sync: .{meth}() of a pipeline argument's "
                         "value")
                if leaf == "range" and any(
                        _refs_value(a, params) for a in node.args):
                    emit(node, "iterate",
                         "host sync: range() over a pipeline argument's "
                         "value")
                if leaf in ("asarray", "array") and head in \
                        NUMPY_ALIASES and any(
                            _refs_value(a, params) for a in node.args):
                    emit(node, "asarray",
                         "host sync: numpy copy of a pipeline argument")
            if isinstance(node, ast.For) and _refs_value(
                    node.iter, params) and not (
                    isinstance(node.iter, ast.Call)
                    and call_name(node.iter).rsplit(".", 1)[-1] ==
                    "range"):
                # (a range() bound is the Call check's finding)
                emit(node, "iterate",
                     "host sync: Python iteration over a pipeline "
                     "argument")
            for c in ast.iter_child_nodes(node):
                visit(c, params)

        for stmt in fn.body:
            visit(stmt, params)
        return out
