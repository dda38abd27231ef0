"""Guard-inference layer + the static race rules (the role the Go race
detector plays for the reference codebase's CI, approximated statically).

The serving stack's review history is one bug class three ways: shared
state touched outside its lock (`_MPP_PLACE_CACHE` check/popitem), check-then-
act splits across lock releases (`obtain()` double-submit, fence-check vs
executable-install under separate `_PIPE_LOCK` holds), and `*_locked`
helpers whose calling contract nothing enforced.  This module turns the
lock model of ``rules/locks.py`` into a guard INFERENCE: for every shared
mutable object in the audited service modules, the lock held at the
MAJORITY of its access sites is inferred to be its guard, and the
minority sites are the findings.

  * ``guarded-state`` — inventory shared mutable state (module-level
    dicts/lists/counters of the audited modules, plus instance attrs of
    classes that own an instance lock), infer each object's guard from
    the majority of its access sites — including call-propagated holds:
    a helper whose every resolved call site takes lock L counts as
    running under L (``locks._Model.entry_held``) — and flag minority
    unguarded reads/writes.  Deliberate GIL-atomic fast paths (e.g.
    ``compile_service.note_hit``) carry reason-mandatory allowlist
    entries, which doubles as the inventory of every lock-free access in
    the repo (README "Concurrency conventions").

  * ``check-then-act`` — a guarded object CHECKED under one ``with
    <lock>`` hold (membership / truth / ``len`` / ``.get``) and then
    MUTATED in a LATER hold of the same lock (or unguarded) in the same
    function, with no re-check before the mutation: the exact shape of
    the ``obtain()`` double-submit and fence/install bugs.  A hold that
    both checks and mutates is one atomic section (clean); an act-hold
    that re-checks any same-lock state first is the sanctioned
    double-check pattern (clean).

  * ``locked-suffix-contract`` — the ``*_locked`` naming convention
    becomes enforced: a ``*_locked`` function may only be called with a
    lock statically held (directly or call-propagated), and a function
    that ACQUIRES the very guard its callers hold must not be named
    ``*_locked``.

Like the lock model underneath, everything here under-approximates:
unresolvable receivers, aliased state smuggled through parameters and
calls through indirection are skipped, never guessed — a finding is
meant to be worth reading.
"""

from __future__ import annotations

import ast

from ..engine import Rule, register
from ._util import call_name
from .locks import _model_for

#: the modules whose shared mutable state is audited: the singleton
#: service layers of the serving stack plus the compiled-fragment caches
#: the historical bugs lived in, the port's kernel layer (the library
#: build and the launcher caches and workspaces its modules fill under a
#: lock), plus the lint package itself (self-coverage)
AUDITED = (
    "executor/scheduler.py",
    "executor/supervisor.py",
    "executor/compile_service.py",
    "executor/circuit.py",
    "executor/device_exec.py",
    "executor/hybrid_join.py",
    "executor/mpp_exec.py",
    "ops/residency.py",
    "ops/kernels/build.py",
    "ops/kernels/join_expand.py",
    "ops/kernels/merge_states.py",
    "ops/kernels/radix_exchange.py",
    "ops/kernels/shuffle_join.py",
    "ops/kernels/window_scan.py",
    "session/tracing.py",
    "session/observe.py",
    "lint/engine.py",
    "lint/__main__.py",
)

#: constructors whose result is shared-mutable when bound at module level
MUTABLE_CTORS = {"dict", "list", "set", "OrderedDict", "Counter",
                 "deque", "defaultdict", "WeakSet",
                 "WeakValueDictionary"}

#: method calls that mutate their receiver in place
MUTATORS = {"append", "appendleft", "add", "insert", "extend", "update",
            "clear", "pop", "popitem", "popleft", "remove", "discard",
            "setdefault", "move_to_end", "sort", "reverse"}

#: receiver methods that count as CHECKS for check-then-act (probe
#: without structural commitment; setdefault is check+act in one call)
CHECK_CALLS = {"get", "setdefault", "keys", "values", "items", "count",
               "index"}


class _GState:
    """One audited shared-mutable object."""

    __slots__ = ("ident", "rel", "name", "cls", "attr")

    def __init__(self, rel, name, cls=None, attr=None):
        self.rel = rel
        self.name = name          # "NAME" or "Class.attr"
        self.cls = cls
        self.attr = attr
        self.ident = f"{rel}::{name}"


class _Access:
    __slots__ = ("state", "write", "held", "rel", "line", "qual",
                 "exempt", "check", "holds")

    def __init__(self, state, write, held, rel, line, qual, exempt,
                 check, holds):
        self.state = state        # _GState
        self.write = write
        self.held = held          # frozenset of lock idents (effective)
        self.rel = rel
        self.line = line
        self.qual = qual
        self.exempt = exempt      # module scope / owning __init__
        self.check = check        # participates in a test-ish expression
        self.holds = holds        # ((with_id, (locks...)), ...) innermost last


def _local_bound(fn) -> set:
    """Names the function BINDS locally (assignments make them locals, so
    a same-named module state is shadowed) minus explicit globals.
    Nested defs are NOT descended into — their locals are their own."""
    out = set()
    args = fn.args
    for a in (args.args + args.posonlyargs + args.kwonlyargs
              + ([args.vararg] if args.vararg else [])
              + ([args.kwarg] if args.kwarg else [])):
        out.add(a.arg)
    globs = set()

    def scan(node):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                out.add(getattr(child, "name", ""))
                continue
            if isinstance(child, ast.Global):
                globs.update(child.names)
            elif isinstance(child, ast.Name) and isinstance(
                    child.ctx, (ast.Store, ast.Del)):
                out.add(child.id)
            elif isinstance(child, ast.ExceptHandler) and child.name:
                out.add(child.name)
            elif isinstance(child, (ast.Import, ast.ImportFrom)):
                for a in child.names:
                    out.add(a.asname or a.name.split(".")[0])
            scan(child)

    scan(fn)
    out.discard("")
    return out - globs


class _GuardModel:
    """State inventory + access sites + per-state inferred guards, built
    once per Context and shared by the three rules."""

    def __init__(self, ctx):
        self.ctx = ctx
        self.model = _model_for(ctx)
        self.entry = self.model.entry_held()
        # (rel, name) -> _GState for module states;
        # (rel, cls, attr) -> _GState for instance states
        self.mod_states: dict = {}
        self.inst_states: dict = {}
        self.accesses: list[_Access] = []
        # functions defined with the *_locked suffix: key -> (rel, line)
        self.locked_defs: dict = {}
        self._inventory()
        self._collect()
        self.guards = self._infer()

    # -- inventory ------------------------------------------------------

    def _audited(self, rel) -> bool:
        return rel in AUDITED

    def _inventory(self):
        for sf in self.ctx.package_files:
            if not self._audited(sf.rel):
                continue
            for node in sf.tree.body:
                targets = ()
                value = None
                if isinstance(node, ast.Assign):
                    targets, value = node.targets, node.value
                elif isinstance(node, ast.AnnAssign) and node.value is not None:
                    targets, value = (node.target,), node.value
                if not self._mutable_value(value):
                    continue
                for tgt in targets:
                    if isinstance(tgt, ast.Name):
                        self.mod_states[(sf.rel, tgt.id)] = _GState(
                            sf.rel, tgt.id)
            # instance attrs of classes that own an inventoried lock
            for node in ast.walk(sf.tree):
                if not isinstance(node, ast.ClassDef):
                    continue
                cls = node.name
                owns_lock = any(
                    ident.startswith(f"{sf.rel}::{cls}.")
                    for ident in self.model.locks
                    if not self.model.locks[ident].module_level)
                if not owns_lock:
                    continue
                for sub in ast.walk(node):
                    tgt = None
                    if isinstance(sub, ast.Assign):
                        for t in sub.targets:
                            if (isinstance(t, ast.Attribute)
                                    and isinstance(t.value, ast.Name)
                                    and t.value.id == "self"):
                                tgt = t
                    elif isinstance(sub, ast.AnnAssign) and isinstance(
                            sub.target, ast.Attribute) and isinstance(
                            sub.target.value, ast.Name) \
                            and sub.target.value.id == "self":
                        tgt = sub.target
                    if tgt is None:
                        continue
                    ident = f"{sf.rel}::{cls}.{tgt.attr}"
                    if ident in self.model.locks:
                        continue  # the lock itself is not guarded state
                    key = (sf.rel, cls, tgt.attr)
                    if key not in self.inst_states:
                        self.inst_states[key] = _GState(
                            sf.rel, f"{cls}.{tgt.attr}", cls, tgt.attr)

    @staticmethod
    def _mutable_value(value) -> bool:
        if isinstance(value, (ast.Dict, ast.List, ast.Set)):
            return True
        if isinstance(value, ast.Call):
            leaf = call_name(value).rsplit(".", 1)[-1]
            return leaf in MUTABLE_CTORS
        return False

    # -- access collection ----------------------------------------------

    def _collect(self):
        for sf in self.ctx.package_files:
            imports = self.model.imports.get(sf.rel, {})
            # a file that is not audited and imports no audited module
            # cannot reference audited state: only its *_locked defs
            # matter (the full access walk is the expensive part)
            relevant = self._audited(sf.rel) or any(
                isinstance(v, str) and v + ".py" in AUDITED
                for v in imports.values())
            for node in ast.walk(sf.tree):
                if isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    if node.name.endswith("_locked"):
                        key = f"{sf.rel}::{sf.qualname(node)}"
                        self.locked_defs[key] = (sf.rel, node.lineno)
                    if relevant:
                        self._walk_fn(sf, imports, node)
            # module-scope accesses are skipped entirely: import time is
            # single-threaded (publication before sharing)

    def _walk_fn(self, sf, imports, fn):
        key = f"{sf.rel}::{sf.qualname(fn)}"
        entry = self.entry.get(key, frozenset())
        localbound = _local_bound(fn)
        qual = sf.qualname(fn)
        parents = sf.parents()
        in_cls = self.model._enclosing_class(sf, fn)
        is_init = qual.endswith(".__init__")

        def visit(node, held, holds):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node is not fn:
                return  # nested defs run later, not under these holds
            if isinstance(node, ast.Lambda):
                return  # deferred execution: holds do not apply
            if isinstance(node, ast.With):
                acquired = []
                for item in node.items:
                    lock = self.model.resolve_lock(sf, item.context_expr)
                    if lock is not None:
                        acquired.append(lock)
                    visit(item.context_expr, held, holds)
                    if item.optional_vars is not None:
                        visit(item.optional_vars, held, holds)
                sub_holds = holds
                if acquired:
                    sub_holds = holds + ((id(node), tuple(acquired)),)
                for child in node.body:
                    visit(child, held + acquired, sub_holds)
                return
            st = self._match(sf, imports, node, localbound, in_cls)
            if st is not None:
                write = self._classify(parents, node)
                check = self._is_check(parents, node)
                exempt = (qual == "<module>"
                          or (st.cls is not None and is_init
                              and in_cls == st.cls))
                self.accesses.append(_Access(
                    st, write == "write",
                    frozenset(held) | entry, sf.rel, node.lineno, qual,
                    exempt, check, holds))
            for child in ast.iter_child_nodes(node):
                visit(child, held, holds)

        for stmt in fn.body:
            visit(stmt, [], ())

    def _match(self, sf, imports, node, localbound, in_cls):
        """The _GState a node refers to, or None.  Matches exactly the
        base reference (bare NAME / module.NAME / self.attr) so each
        textual occurrence is counted once."""
        if isinstance(node, ast.Name):
            if node.id in localbound:
                return None
            return self.mod_states.get((sf.rel, node.id))
        if isinstance(node, ast.Attribute) and isinstance(
                node.value, ast.Name):
            head = node.value.id
            if head == "self":
                return self.inst_states.get((sf.rel, in_cls, node.attr))
            mod = imports.get(head)
            if mod:
                return self.mod_states.get((mod + ".py", node.attr))
        return None

    @staticmethod
    def _classify(parents, base) -> str:
        node = base
        p = parents.get(id(node))
        while isinstance(p, ast.Subscript) and p.value is node:
            node, p = p, parents.get(id(p))
        ctx = getattr(node, "ctx", None)
        if isinstance(ctx, (ast.Store, ast.Del)):
            return "write"
        if isinstance(p, ast.Attribute) and p.value is node:
            gp = parents.get(id(p))
            if isinstance(gp, ast.Call) and gp.func is p \
                    and p.attr in MUTATORS:
                return "write"
        return "read"

    @staticmethod
    def _is_check(parents, base) -> bool:
        cur = base
        p = parents.get(id(cur))
        while p is not None and not isinstance(p, ast.stmt):
            if isinstance(p, (ast.Compare, ast.BoolOp)):
                return True
            if isinstance(p, ast.UnaryOp) and isinstance(p.op, ast.Not):
                return True
            if isinstance(p, ast.IfExp) and p.test is cur:
                return True
            if isinstance(p, ast.Call) and isinstance(
                    p.func, ast.Attribute) and p.func.attr in CHECK_CALLS:
                return True
            cur, p = p, parents.get(id(p))
        if isinstance(p, (ast.If, ast.While)) and p.test is cur:
            return True
        return isinstance(p, ast.Assert)

    # -- inference ------------------------------------------------------

    def _infer(self) -> dict:
        """state ident -> (guard lock ident, guarded_n, total_n) for
        states where a strict majority of non-exempt access sites hold
        one lock (and at least two sites do — one site is no pattern)."""
        per_state: dict = {}
        for a in self.accesses:
            if a.exempt:
                continue
            per_state.setdefault(a.state.ident, []).append(a)
        # an instance attr only written during __init__ is configuration,
        # not shared-mutable state: reads of it need no guard
        written = {a.state.ident for a in self.accesses
                   if a.write and not a.exempt}
        out = {}
        for ident, sites in per_state.items():
            st = sites[0].state
            if st.cls is not None and ident not in written:
                continue
            votes: dict = {}
            for a in sites:
                for lock in a.held:
                    votes[lock] = votes.get(lock, 0) + 1
            if not votes:
                continue
            guard = max(sorted(votes), key=lambda k: votes[k])
            n = votes[guard]
            if n >= 2 and 2 * n > len(sites):
                out[ident] = (guard, n, len(sites))
        return out


def _guard_model(ctx) -> _GuardModel:
    gm = getattr(ctx, "_guard_model", None)
    if gm is None:
        gm = _GuardModel(ctx)
        ctx._guard_model = gm
    return gm


def _short(ident: str) -> str:
    rel, name = ident.split("::", 1)
    return f"{rel.rsplit('/', 1)[-1][:-3]}.{name}"


class _Deduper:
    def __init__(self):
        self.seen: dict = {}

    def ident(self, base: str) -> str:
        k = self.seen.get(base, 0)
        self.seen[base] = k + 1
        return base + (f"#{k}" if k else "")


@register
class GuardedState(Rule):
    name = "guarded-state"
    title = "shared mutable state is accessed under its inferred guard"

    def prepare(self, ctx):
        _guard_model(ctx)

    def run(self, ctx):
        gm = _guard_model(ctx)
        out = []
        dedup = _Deduper()
        for a in sorted(gm.accesses, key=lambda a: (a.rel, a.line)):
            if a.exempt:
                continue
            info = gm.guards.get(a.state.ident)
            if info is None:
                continue
            guard, n, total = info
            if guard in a.held:
                continue
            kind = "write to" if a.write else "read of"
            out.append(self.finding(
                a.rel, a.line,
                dedup.ident(f"unguarded:{a.state.name}@{a.qual}"),
                f"{kind} {_short(a.state.ident)} without its inferred "
                f"guard {_short(guard)} (held at {n}/{total} access "
                f"sites) — lock it or allowlist the site with the reason "
                "the lock-free access is safe"))
        return out


@register
class CheckThenAct(Rule):
    name = "check-then-act"
    title = "no check under one lock hold acted on in a later hold"

    def prepare(self, ctx):
        _guard_model(ctx)

    def run(self, ctx):
        gm = _guard_model(ctx)
        out = []
        dedup = _Deduper()
        # group accesses per (function, guard lock)
        per_fn: dict = {}
        for a in gm.accesses:
            if a.exempt:
                continue
            info = gm.guards.get(a.state.ident)
            if info is None:
                continue
            per_fn.setdefault((a.rel, a.qual), []).append((a, info[0]))

        for (rel, qual), recs in sorted(per_fn.items()):
            by_lock: dict = {}
            for a, guard in recs:
                by_lock.setdefault(guard, []).append(a)
            for guard, accs in by_lock.items():
                out.extend(self._scan(rel, qual, guard, accs, dedup))
        return out

    def _hold_of(self, a, guard):
        """Innermost explicit with-hold of `guard` the access sits in
        (None = not inside an explicit hold of it)."""
        for wid, locks in reversed(a.holds):
            if guard in locks:
                return wid
        return None

    def _scan(self, rel, qual, guard, accs, dedup):
        # per explicit hold: checks / mutations of each state, in line
        # order; plus each hold's line span
        holds: dict = {}
        loose = []  # accesses under no explicit hold of the guard
        for a in accs:
            wid = self._hold_of(a, guard)
            if wid is None:
                loose.append(a)
                continue
            h = holds.setdefault(wid, {"lines": [], "accs": []})
            h["lines"].append(a.line)
            h["accs"].append(a)
        out = []
        ordered = sorted(holds.values(), key=lambda h: min(h["lines"]))
        for i, h1 in enumerate(ordered):
            # a candidate CHECK hold: checks some state, mutates nothing
            # of it in the same hold
            checked = {a.state.ident for a in h1["accs"] if a.check}
            muted1 = {a.state.ident for a in h1["accs"] if a.write}
            cands = checked - muted1
            if not cands:
                continue
            h1_end = max(h1["lines"])
            for sid in sorted(cands):
                # later hold mutating sid without ANY same-lock re-check
                # before the mutation
                for h2 in ordered[i + 1:]:
                    if min(h2["lines"]) <= h1_end:
                        continue
                    muts = [a for a in h2["accs"]
                            if a.write and a.state.ident == sid]
                    if not muts:
                        continue
                    first_mut = min(a.line for a in muts)
                    rechecked = any(a.check and a.line <= first_mut
                                    for a in h2["accs"])
                    if rechecked:
                        continue
                    st = muts[0].state
                    out.append(self.finding(
                        rel, first_mut,
                        dedup.ident(f"check-then-act:{st.name}@{qual}"),
                        f"{_short(sid)} is checked under one "
                        f"{_short(guard)} hold and mutated in a later "
                        "hold with no re-check — the decision can go "
                        "stale between the two critical sections "
                        "(re-check under the acting hold, or merge the "
                        "sections)"))
                    break
                else:
                    # ... or mutated with the guard not held at all
                    later_unguarded = [
                        a for a in loose
                        if a.write and a.state.ident == sid
                        and a.line > h1_end and guard not in a.held]
                    if later_unguarded:
                        a = later_unguarded[0]
                        out.append(self.finding(
                            rel, a.line,
                            dedup.ident(
                                f"check-then-act:{a.state.name}@{qual}"),
                            f"{_short(sid)} is checked under a "
                            f"{_short(guard)} hold and mutated later "
                            "with no lock held — the check cannot "
                            "protect the mutation"))
        return out


@register
class LockedSuffixContract(Rule):
    name = "locked-suffix-contract"
    title = "*_locked functions are called with their guard held"

    def prepare(self, ctx):
        _guard_model(ctx)

    def run(self, ctx):
        gm = _guard_model(ctx)
        model = gm.model
        out = []
        dedup = _Deduper()
        # call sites grouped per callee
        sites: dict = {}
        for caller, recs in model.call_records.items():
            for held, callee, line in recs:
                if callee in gm.locked_defs:
                    eff = frozenset(held) | gm.entry.get(
                        caller, frozenset())
                    sites.setdefault(callee, []).append(
                        (caller, eff, line))
        for callee, recs in sorted(sites.items()):
            leaf = callee.split("::", 1)[1].rsplit(".", 1)[-1]
            votes: dict = {}
            for _caller, eff, _line in recs:
                for lock in eff:
                    votes[lock] = votes.get(lock, 0) + 1
            for caller, eff, line in recs:
                if eff:
                    continue
                caller_rel, caller_qual = caller.split("::", 1)
                out.append(self.finding(
                    caller_rel, line,
                    dedup.ident(f"unlocked-call:{leaf}@{caller_qual}"),
                    f"{leaf}() is called with no lock statically held — "
                    "the _locked suffix is a contract: every caller "
                    "must hold the guard (or the function is misnamed)"))
            if votes:
                guard = max(sorted(votes), key=lambda k: votes[k])
                drel, dline = gm.locked_defs[callee]
                if guard in model.direct.get(callee, ()):
                    out.append(self.finding(
                        drel, dline, f"acquires-guard:{leaf}",
                        f"{leaf}() itself acquires {_short(guard)}, the "
                        "guard its callers hold — a *_locked function "
                        "must expect the lock held, not take it (rename "
                        "it or drop the acquisition)"))
        return out
