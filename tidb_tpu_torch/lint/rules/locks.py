"""Static lock-acquisition analysis over the whole package:

  * ``lock-order``: build the lock-acquisition graph from nested
    ``with <lock>:`` scopes plus one level of best-effort call resolution
    (a function called while a lock is held contributes every lock it —
    transitively — acquires), and fail on cycles: two threads taking the
    same pair of locks in opposite orders is the deadlock class the
    threaded chaos harness can only catch probabilistically.  A nested
    ``with`` on the SAME plain (non-reentrant) lock is reported as a
    guaranteed self-deadlock.

  * ``blocking-while-locked``: a blocking operation (device dispatch,
    supervised calls, ``time.sleep``, backoff sleeps, URL fetches)
    performed while holding a MODULE-LEVEL lock serializes every other
    thread in the process behind one slow call — the scheduler/residency
    /compile-service mutexes are meant to guard STATE transitions, not
    I/O.

Lock identity is ``<rel>::<NAME>`` for module-level locks and
``<rel>::<Class>.<attr>`` for ``self.<attr> = threading.Lock()``
instance locks.  ``threading.Condition(existing_lock)`` aliases to the
lock it wraps; a bare ``Condition()`` is reentrant (RLock-backed).
Receivers other than ``self`` resolve only when the attribute name maps
to exactly one known lock package-wide; unresolvable expressions are
skipped (this analysis under-approximates — it must never guess).
"""

from __future__ import annotations

import ast

from ..engine import Rule, register
from ._util import call_name, dotted, import_map

LOCK_CTORS = {"Lock": False, "RLock": True, "Condition": True,
              "Semaphore": False, "BoundedSemaphore": False}

#: call leaf-names that BLOCK (wall-clock waits / device work) — checked
#: while a module-level lock is held.  ``sleep`` must be ``time.sleep``
#: to dodge same-named params; the rest are project-specific enough to
#: match by leaf.
BLOCKING_LEAVES = {"call_supervised", "supervised_call", "run_device",
                   "block_until_ready", "urlopen", "backoff",
                   "to_device_col"}


class _Lock:
    __slots__ = ("ident", "reentrant", "module_level", "rel", "line")

    def __init__(self, ident, reentrant, module_level, rel, line):
        self.ident = ident
        self.reentrant = reentrant
        self.module_level = module_level
        self.rel = rel
        self.line = line


def _lock_ctor(value: ast.AST):
    """(ctor_name, first_arg) when value is threading.<ctor>(...)."""
    if not isinstance(value, ast.Call):
        return None
    name = call_name(value)
    leaf = name.rsplit(".", 1)[-1]
    if leaf in LOCK_CTORS and (name == leaf or
                               name.startswith("threading.")):
        return leaf, (value.args[0] if value.args else None)
    return None


class _Model:
    """Package-wide lock + function-summary tables."""

    def __init__(self, ctx):
        self.ctx = ctx
        self.locks: dict[str, _Lock] = {}
        # per-file: local name -> lock ident (module-level + aliases)
        self.mod_locks: dict[str, dict] = {}
        # instance-lock attr name -> [idents] (for unique-match fallback)
        self.attr_locks: dict[str, list] = {}
        # per-file import map
        self.imports: dict[str, dict] = {}
        # function summaries keyed "rel::qualname"
        self.direct: dict[str, set] = {}
        self.calls_all: dict[str, set] = {}
        self.calls_under: dict[str, list] = {}  # (held, callee, line, name)
        # EVERY resolved call with the locks held at the site (held may be
        # empty) — the guard-inference layer (rules/guards.py) derives
        # entry-held lock sets and the *_locked call contract from this
        self.call_records: dict[str, list] = {}  # (held, callee, line)
        self.blocking: list = []  # findings raw (rel, line, qn, call, lock)
        self.nest_edges: list = []  # (a, b, rel, line, note)
        # name -> [fn keys] for unique-method resolution
        self.fn_by_leaf: dict[str, list] = {}
        self.class_names: dict[str, set] = {}

    # -- phase 1: inventory ---------------------------------------------

    def inventory(self):
        for sf in self.ctx.package_files:
            self.imports[sf.rel] = import_map(sf.tree, sf.rel,
                                             self.ctx.package)
            locals_ = self.mod_locks.setdefault(sf.rel, {})
            classes = self.class_names.setdefault(sf.rel, set())
            for node in sf.tree.body:
                if isinstance(node, ast.Assign):
                    ctor = _lock_ctor(node.value)
                    if ctor:
                        leaf, arg = ctor
                        for tgt in node.targets:
                            if not isinstance(tgt, ast.Name):
                                continue
                            # Condition(existing) aliases the wrapped lock
                            if (leaf == "Condition" and arg is not None
                                    and isinstance(arg, ast.Name)
                                    and arg.id in locals_):
                                locals_[tgt.id] = locals_[arg.id]
                                continue
                            ident = f"{sf.rel}::{tgt.id}"
                            self.locks[ident] = _Lock(
                                ident, LOCK_CTORS[leaf], True, sf.rel,
                                node.lineno)
                            locals_[tgt.id] = ident
                if isinstance(node, ast.ClassDef):
                    classes.add(node.name)
            # ONE full walk: instance locks, nested classes, and the
            # function index for unique-leaf call resolution
            for node in ast.walk(sf.tree):
                if isinstance(node, ast.ClassDef):
                    classes.add(node.name)
                    continue
                if isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    key = f"{sf.rel}::{self._defqual(sf, node)}"
                    self.fn_by_leaf.setdefault(node.name, []).append(key)
                    continue
                if not isinstance(node, ast.Assign):
                    continue
                ctor = _lock_ctor(node.value)
                if not ctor:
                    continue
                leaf, arg = ctor
                for tgt in node.targets:
                    if (isinstance(tgt, ast.Attribute)
                            and isinstance(tgt.value, ast.Name)
                            and tgt.value.id == "self"):
                        cls = self._enclosing_class(sf, node)
                        if not cls:
                            continue
                        ident = f"{sf.rel}::{cls}.{tgt.attr}"
                        if ident not in self.locks:
                            self.locks[ident] = _Lock(
                                ident, LOCK_CTORS[leaf], False, sf.rel,
                                node.lineno)
                            self.attr_locks.setdefault(
                                tgt.attr, []).append(ident)

    def _defqual(self, sf, node):
        # a def node's engine qualname already includes its own name
        return sf.qualname(node)

    def _enclosing_class(self, sf, node) -> str:
        qn = sf.qualname(node)
        classes = self.class_names.get(sf.rel, set())
        for part in qn.split("."):
            if part in classes:
                return part
        return ""

    # -- lock-expression resolution --------------------------------------

    def resolve_lock(self, sf, expr) -> str | None:
        name = dotted(expr)
        if not name:
            return None
        locals_ = self.mod_locks.get(sf.rel, {})
        if name in locals_:
            return locals_[name]
        if "." in name:
            head, attr = name.split(".", 1)
            if "." in attr:
                # deep chain (self.domain.table_locks_mu): the receiver is
                # some OTHER object, so the class-local rules below do not
                # apply — a unique package-wide attr match is the only
                # safe resolution (ambiguity stays unresolved, never
                # guessed)
                cands = self.attr_locks.get(name.rsplit(".", 1)[-1], [])
                if len(cands) == 1:
                    return cands[0]
                return None
            if head == "self":
                cls = self._enclosing_class(sf, expr)
                ident = f"{sf.rel}::{cls}.{attr}"
                if ident in self.locks:
                    return ident
                # self.<attr> of a class whose lock we did not inventory
                # (assigned via helper): do NOT fall through to the
                # unique-attr match — binding it to ANOTHER class's lock
                # would fabricate self-deadlock/cycle findings
                return None
            # module.NAME via imports
            imp = self.imports.get(sf.rel, {})
            if head in imp:
                mod_rel = imp[head] + ".py"
                target = self.mod_locks.get(mod_rel, {})
                if attr in target:
                    return target[attr]
            # unique instance-attr match package-wide
            cands = self.attr_locks.get(attr, [])
            if len(cands) == 1:
                return cands[0]
        else:
            # bare name imported from another module
            sym = self.imports.get(sf.rel, {}).get(name + "::sym")
            if sym and "::" in sym:
                mod, leaf = sym.split("::", 1)
                target = self.mod_locks.get(mod + ".py", {})
                if leaf in target:
                    return target[leaf]
        return None

    # -- callee resolution ------------------------------------------------

    def resolve_call(self, sf, call: ast.Call) -> str | None:
        name = call_name(call)
        if not name:
            return None
        if "." not in name:
            key = f"{sf.rel}::{name}"
            if key in self.direct:
                return key
            sym = self.imports.get(sf.rel, {}).get(name + "::sym")
            if sym and "::" in sym:
                mod, leaf = sym.split("::", 1)
                key = f"{mod}.py::{leaf}"
                if key in self.direct:
                    return key
            return None
        head, rest = name.split(".", 1)
        if "." in rest:
            return None
        if head == "self":
            cls = self._enclosing_class(sf, call)
            key = f"{sf.rel}::{cls}.{rest}"
            if key in self.direct:
                return key
            return None
        imp = self.imports.get(sf.rel, {})
        if head in imp:
            key = f"{imp[head]}.py::{rest}"
            if key in self.direct:
                return key
        # unique method/function leaf package-wide (obs.set_gauge style)
        cands = self.fn_by_leaf.get(rest, [])
        if len(cands) == 1:
            return cands[0]
        return None

    # -- phase 2: per-function walk ---------------------------------------

    def summarize(self):
        for sf in self.ctx.package_files:
            for node in ast.walk(sf.tree):
                if isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    key = f"{sf.rel}::{self._defqual(sf, node)}"
                    self.direct.setdefault(key, set())
                    self.calls_all.setdefault(key, set())
                    self.calls_under.setdefault(key, [])
                    self.call_records.setdefault(key, [])
        for sf in self.ctx.package_files:
            for node in ast.walk(sf.tree):
                if isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    key = f"{sf.rel}::{self._defqual(sf, node)}"
                    self._walk_fn(sf, key, node)

    def _walk_fn(self, sf, key, fn):
        def visit(node, held):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node is not fn:
                # nested defs get their own summary pass; the closure does
                # not RUN at definition time, so held locks do not apply
                return
            if isinstance(node, ast.With):
                acquired = []
                for item in node.items:
                    lock = self.resolve_lock(sf, item.context_expr)
                    if lock is not None:
                        # earlier items of the SAME `with A, B:` are
                        # already held when B is taken — they order too
                        for h in held + acquired:
                            self.nest_edges.append(
                                (h, lock, sf.rel, node.lineno, "nested"))
                        self.direct[key].add(lock)
                        acquired.append(lock)
                for child in node.body:
                    visit(child, held + acquired)
                return
            if isinstance(node, ast.Call):
                callee = self.resolve_call(sf, node)
                if callee is not None:
                    self.calls_all[key].add(callee)
                    self.call_records[key].append(
                        (tuple(held), callee, node.lineno))
                    if held:
                        self.calls_under[key].append(
                            (tuple(held), callee, node.lineno,
                             call_name(node)))
                mod_held = [h for h in held
                            if h in self.locks
                            and self.locks[h].module_level]
                if mod_held:
                    cname = call_name(node)
                    leaf = cname.rsplit(".", 1)[-1]
                    if (leaf in BLOCKING_LEAVES
                            or cname in ("time.sleep",)):
                        self.blocking.append(
                            (sf.rel, node.lineno, sf.qualname(node),
                             cname, mod_held[0]))
            for child in ast.iter_child_nodes(node):
                visit(child, held)

        for stmt in fn.body:
            visit(stmt, [])

    # -- phase 3: closure + edges -----------------------------------------

    def entry_held(self) -> dict:
        """Lock set statically held at ENTRY of every function: the meet
        (intersection) over each resolved call site of (locks held at the
        site ∪ the caller's own entry set), iterated to a fixpoint — the
        call-propagation that makes a ``*_locked`` helper's body count as
        guarded when every caller takes the lock first.  A function with
        no resolved call sites (an entry point, a thread target, anything
        reached only through unresolvable indirection) gets the empty
        set: this analysis under-approximates, it must never guess."""
        # call sites grouped per callee
        sites: dict[str, list] = {}
        for caller, recs in self.call_records.items():
            for held, callee, _line in recs:
                if callee in self.direct:
                    sites.setdefault(callee, []).append((caller, held))
        # no resolved callers = entry point: nothing held.  Called
        # functions start at TOP (None — "every lock", the identity of
        # the meet) and shrink monotonically; a distinct sentinel, not
        # frozenset(all locks), so a function legitimately entered with
        # every lock of a small module held is never mistaken for TOP.
        entry: dict = {k: (None if k in sites else frozenset())
                       for k in self.direct}
        changed = True
        iters = 0
        while changed and iters < 50:
            changed = False
            iters += 1
            for callee, recs in sites.items():
                acc = None
                for caller, held in recs:
                    ce = entry.get(caller, frozenset())
                    if ce is None:
                        continue  # TOP caller: identity for the meet
                    eff = ce | frozenset(held)
                    acc = eff if acc is None else (acc & eff)
                if acc is not None and acc != entry[callee]:
                    entry[callee] = acc
                    changed = True
        # anything still TOP is reachable only from a closed call cycle
        # with no outside entry — assume nothing held
        return {k: (frozenset() if v is None else v)
                for k, v in entry.items()}

    def effective(self) -> dict:
        eff = {k: set(v) for k, v in self.direct.items()}
        changed = True
        iters = 0
        while changed and iters < 50:
            changed = False
            iters += 1
            for k, callees in self.calls_all.items():
                for g in callees:
                    extra = eff.get(g, ())
                    if not eff[k].issuperset(extra):
                        eff[k] |= extra
                        changed = True
        return eff

    def edges(self):
        eff = self.effective()
        out = list(self.nest_edges)
        for k, recs in self.calls_under.items():
            for held, callee, line, cname in recs:
                rel = k.split("::", 1)[0]
                for b in eff.get(callee, ()):
                    for a in held:
                        out.append((a, b, rel, line, f"via {cname}()"))
        return out


def _sccs(nodes, adj):
    """Tarjan strongly-connected components."""
    index = {}
    low = {}
    stack, on_stack = [], set()
    sccs = []
    counter = [0]

    def strong(v):
        work = [(v, 0)]
        while work:
            node, pi = work[-1]
            if pi == 0:
                index[node] = low[node] = counter[0]
                counter[0] += 1
                stack.append(node)
                on_stack.add(node)
            recurse = False
            succs = adj.get(node, [])
            for i in range(pi, len(succs)):
                w = succs[i]
                if w not in index:
                    work[-1] = (node, i + 1)
                    work.append((w, 0))
                    recurse = True
                    break
                elif w in on_stack:
                    low[node] = min(low[node], index[w])
            if recurse:
                continue
            if low[node] == index[node]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.append(w)
                    if w == node:
                        break
                sccs.append(comp)
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])

    for v in nodes:
        if v not in index:
            strong(v)
    return sccs


def _model_for(ctx) -> _Model:
    """One inventory+summary pass per Context, shared by both lock rules
    (the model walk is the most expensive analysis in the registry)."""
    model = getattr(ctx, "_lock_model", None)
    if model is None:
        model = _Model(ctx)
        model.inventory()
        model.summarize()
        ctx._lock_model = model
    return model


@register
class LockOrder(Rule):
    name = "lock-order"
    title = "no cycles in the static lock-acquisition graph"

    def prepare(self, ctx):
        _model_for(ctx)

    def run(self, ctx):
        model = _model_for(ctx)
        edges = model.edges()
        out = []

        adj: dict[str, list] = {}
        witness: dict[tuple, tuple] = {}
        self_edges = []
        for a, b, rel, line, note in edges:
            if a == b:
                lk = model.locks.get(a)
                if lk is not None and not lk.reentrant \
                        and note == "nested":
                    # only DIRECT nesting is a guaranteed deadlock; a
                    # call-derived self-edge may be conditional
                    self_edges.append((a, rel, line))
                continue
            adj.setdefault(a, []).append(b)
            adj.setdefault(b, [])
            witness.setdefault((a, b), (rel, line, note))

        for a, rel, line in sorted(set(self_edges)):
            out.append(self.finding(
                rel, line, f"self-deadlock:{_short(a)}",
                f"nested acquisition of non-reentrant lock {a} — "
                "guaranteed self-deadlock"))

        for comp in _sccs(sorted(adj), adj):
            if len(comp) < 2:
                continue
            comp = sorted(comp)
            pairs = [(a, b) for a in comp for b in comp
                     if (a, b) in witness]
            wrel, wline, wnote = witness[pairs[0]] if pairs else ("", 0, "")
            cyc = "->".join(_short(c) for c in comp)
            detail = "; ".join(
                f"{_short(a)}->{_short(b)} at "
                f"{witness[(a, b)][0]}:{witness[(a, b)][1]} "
                f"({witness[(a, b)][2]})" for a, b in pairs[:6])
            out.append(self.finding(
                wrel, wline, f"cycle:{cyc}",
                f"lock-order cycle between {cyc}: {detail}"))
        return out


@register
class BlockingWhileLocked(Rule):
    name = "blocking-while-locked"
    title = "no blocking ops while holding a module-level lock"

    def prepare(self, ctx):
        _model_for(ctx)

    def run(self, ctx):
        model = _model_for(ctx)
        out = []
        seen: dict[str, int] = {}
        for rel, line, qn, cname, lock in sorted(model.blocking):
            base = f"{cname.rsplit('.', 1)[-1]}@{qn}"
            k = seen.get(base, 0)
            seen[base] = k + 1
            ident = f"blocking:{base}" + (f"#{k}" if k else "")
            out.append(self.finding(
                rel, line, ident,
                f"blocking call {cname}() while holding module-level "
                f"lock {_short(lock)} — serializes every thread behind "
                "one slow operation"))
        return out


def _short(ident: str) -> str:
    rel, name = ident.split("::", 1)
    mod = rel.rsplit("/", 1)[-1][:-3]
    return f"{mod}.{name}"
