"""Single-pass project lint engine (reference: the role `go vet` + custom
vet analyzers play for the upstream ~760k-LoC codebase).

The engine parses every source file under ``tidb_tpu_torch/`` exactly ONCE
and hands the shared ASTs to a registry of project-specific rules
(``tidb_tpu_torch/lint/rules/``) — the confinement rules (kernel
launches, device slots, supervised dispatch, shared memory, sockets,
snapshots) plus the structural rules the threaded serving stack
actually needs: lock-order cycles, blocking-while-locked, swallowed
classified errors, host synchronisations inside pipeline bodies,
errno/taxonomy consistency, failpoint catalog coverage and gauge
surfacing.  The engine and every rule but two are the reference's
(``tidb_tpu/lint``); ``collect(package="tidb_tpu")`` runs them over the
reference's tree as well.

Findings carry a LINE-INDEPENDENT identity (``rel-path:ident``) so the
allowlist file survives unrelated edits: an allowlist entry names a rule,
a glob over identities, and a REQUIRED one-line reason —

    exception-swallow session/observe.py:* -- observability must never fail a statement

Unmatched (stale) allowlist entries are themselves findings: when a fix
removes the last finding an entry covered, CI fails until the entry is
deleted, so the burn-down file can only shrink honestly.

Entry points: ``python -m tidb_tpu_torch.lint`` (CLI, JSON + human output) and
:func:`run_repo` / :func:`run_rule` for tests.
"""

from __future__ import annotations

import ast
import fnmatch
import json
import os

# -- source model ------------------------------------------------------------


class SourceFile:
    """One parsed source file shared by every rule (parse-once is the
    engine's whole point: the four legacy lints re-walked the tree from
    disk independently)."""

    __slots__ = ("rel", "path", "text", "tree", "aux", "_qualnames",
                 "_parents")

    def __init__(self, rel: str, path: str, text: str, tree: ast.AST,
                 aux: bool = False):
        self.rel = rel          # path relative to the package root, "/"-sep
        self.path = path
        self.text = text
        self.tree = tree
        self.aux = aux          # context-only (e.g. tests/chaos_harness.py):
        #                         rules read it but never report INTO it
        self._qualnames = None
        self._parents = None

    # qualname of the innermost enclosing function/class per node — the
    # stable half of every finding identity (line numbers shift; the
    # enclosing def rarely does)
    def qualnames(self) -> dict:
        if self._qualnames is None:
            qn: dict[int, str] = {}

            def walk(node, prefix):
                for child in ast.iter_child_nodes(node):
                    here = prefix
                    if isinstance(child, (ast.FunctionDef,
                                          ast.AsyncFunctionDef,
                                          ast.ClassDef)):
                        here = (prefix + "." + child.name) if prefix \
                            else child.name
                    qn[id(child)] = here or "<module>"
                    walk(child, here)

            qn[id(self.tree)] = "<module>"
            walk(self.tree, "")
            self._qualnames = qn
        return self._qualnames

    def qualname(self, node) -> str:
        return self.qualnames().get(id(node), "<module>")

    def parents(self) -> dict:
        if self._parents is None:
            p: dict[int, ast.AST] = {}
            for node in ast.walk(self.tree):
                for child in ast.iter_child_nodes(node):
                    p[id(child)] = node
            self._parents = p
        return self._parents


class Finding:
    __slots__ = ("rule", "rel", "line", "ident", "msg")

    def __init__(self, rule: str, rel: str, line: int, ident: str, msg: str):
        self.rule = rule
        self.rel = rel
        self.line = line
        self.ident = ident
        self.msg = msg

    @property
    def key(self) -> str:
        """Line-independent identity the allowlist matches on."""
        return f"{self.rel}:{self.ident}"

    def to_json(self) -> dict:
        return {"rule": self.rule, "file": self.rel, "line": self.line,
                "ident": self.ident, "key": self.key, "msg": self.msg}

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"<{self.rule} {self.rel}:{self.line} {self.ident}>"


# -- allowlist ---------------------------------------------------------------


class AllowEntry:
    __slots__ = ("rule", "pattern", "reason", "lineno", "used")

    def __init__(self, rule, pattern, reason, lineno):
        self.rule = rule
        self.pattern = pattern
        self.reason = reason
        self.lineno = lineno
        self.used = False


class Allowlist:
    """``<rule> <key-glob> -- <reason>`` per line; '#' comments.  The
    reason is REQUIRED — an entry without one is a parse error, not a
    suppression (the burn-down convention: silence must be explained)."""

    def __init__(self, entries=None, path=""):
        self.entries: list[AllowEntry] = entries or []
        self.path = path

    @classmethod
    def load(cls, path: str) -> "Allowlist":
        entries = []
        if os.path.exists(path):
            with open(path) as f:
                for i, raw in enumerate(f, 1):
                    line = raw.strip()
                    if not line or line.startswith("#"):
                        continue
                    if " -- " not in line:
                        raise ValueError(
                            f"{path}:{i}: allowlist entry missing "
                            f"' -- <reason>': {line!r}")
                    head, reason = line.split(" -- ", 1)
                    parts = head.split(None, 1)
                    if len(parts) != 2 or not reason.strip():
                        raise ValueError(
                            f"{path}:{i}: expected '<rule> <key-glob> -- "
                            f"<reason>': {line!r}")
                    entries.append(AllowEntry(parts[0], parts[1].strip(),
                                              reason.strip(), i))
        return cls(entries, path)

    def match(self, finding: Finding):
        """First matching entry (marking it used), else None."""
        for e in self.entries:
            if e.rule == finding.rule and fnmatch.fnmatchcase(
                    finding.key, e.pattern):
                e.used = True
                return e
        return None

    def stale(self) -> list:
        return [e for e in self.entries if not e.used]


# -- rule registry -----------------------------------------------------------

RULES: "dict[str, Rule]" = {}


class Rule:
    """One analysis over the shared ASTs.  Subclasses set ``name`` and
    ``title`` and implement :meth:`run`, returning a list of Findings.

    ``allowlistable = False`` marks a rule whose findings the allowlist
    must NOT suppress — the architectural gates (confinement rules)
    whose sanctioned-layer sets are rule config: an allowlist line can
    never quietly neutralize them (it would just go stale and fail)."""

    name = ""
    title = ""
    allowlistable = True

    def prepare(self, ctx: "Context") -> None:
        """Build (and memoize on ctx) any shared analysis model this
        rule needs.  Timed separately by run_rules so --stats charges
        the model fixpoints to a dedicated ``shared-models`` row instead
        of whichever model-using rule happens to run first."""

    def run(self, ctx: "Context") -> list:  # pragma: no cover - interface
        raise NotImplementedError

    def finding(self, rel, line, ident, msg) -> Finding:
        return Finding(self.name, rel, line, ident, msg)


def register(cls):
    """Class decorator adding a rule to the registry (imported once by
    tidb_tpu_torch.lint.rules.__init__ so `run_repo` sees every rule)."""
    inst = cls()
    assert inst.name and inst.name not in RULES, inst.name
    RULES[inst.name] = inst
    return cls


# -- context + collection ----------------------------------------------------


class Context:
    """The parsed files of one package.  `package` is the import name
    the files' absolute imports start with (the cross-module rules
    resolve those through ``rules/_util.import_map``)."""

    def __init__(self, files: list, repo_root: str = "",
                 package: str = "tidb_tpu_torch"):
        self.files = files
        self.repo_root = repo_root
        self.package = package
        self._by_rel = {f.rel: f for f in files}

    @property
    def package_files(self) -> list:
        """The files rules report into (aux context files excluded)."""
        return [f for f in self.files if not f.aux]

    def file(self, rel: str):
        return self._by_rel.get(rel)


#: context-only files parsed alongside the package (rules read them —
#: e.g. the chaos catalogs — but never report findings into them)
AUX_FILES = ("tests/chaos_harness.py",)


def default_repo_root() -> str:
    return os.path.abspath(
        os.path.join(os.path.dirname(__file__), "..", ".."))


def collect(repo_root: str | None = None, package: str = "tidb_tpu_torch",
            aux=AUX_FILES) -> Context:
    """Parse every package source file once, plus the aux context files."""
    root = os.path.abspath(repo_root or default_repo_root())
    pkg_root = os.path.join(root, package)
    files = []
    for dirpath, dirs, names in os.walk(pkg_root):
        dirs[:] = sorted(d for d in dirs if d != "__pycache__")
        for fname in sorted(names):
            if not fname.endswith(".py"):
                continue
            path = os.path.join(dirpath, fname)
            rel = os.path.relpath(path, pkg_root).replace(os.sep, "/")
            with open(path) as f:
                text = f.read()
            files.append(SourceFile(rel, path, text,
                                    ast.parse(text, filename=path)))
    for rel in aux:
        path = os.path.join(root, rel)
        if not os.path.exists(path):
            continue
        with open(path) as f:
            text = f.read()
        files.append(SourceFile(rel, path, text,
                                ast.parse(text, filename=path), aux=True))
    return Context(files, root, package)


# -- reports -----------------------------------------------------------------


class Report:
    def __init__(self, findings, allowlisted, stale, rules_run,
                 timings=None):
        self.findings = findings          # list[Finding] (unallowlisted)
        self.allowlisted = allowlisted    # list[(Finding, AllowEntry)]
        self.stale = stale                # list[AllowEntry]
        self.rules_run = rules_run        # list[str]
        self.timings = timings or {}      # rule -> seconds

    @property
    def ok(self) -> bool:
        return not self.findings and not self.stale

    def to_json(self) -> dict:
        return {
            "ok": self.ok,
            "rules": self.rules_run,
            "timings_s": {k: round(v, 4)
                          for k, v in sorted(self.timings.items())},
            "findings": [f.to_json() for f in self.findings],
            "allowlisted": [
                {**f.to_json(), "reason": e.reason}
                for f, e in self.allowlisted],
            "stale_allowlist": [
                {"rule": e.rule, "pattern": e.pattern, "reason": e.reason,
                 "line": e.lineno} for e in self.stale],
            "counts": {"findings": len(self.findings),
                       "allowlisted": len(self.allowlisted),
                       "stale_allowlist": len(self.stale)},
        }

    def human(self) -> str:
        lines = []
        for f in sorted(self.findings,
                        key=lambda f: (f.rule, f.rel, f.line)):
            lines.append(f"{f.rel}:{f.line}: [{f.rule}] {f.msg}")
            lines.append(f"    id: {f.key}")
        for e in self.stale:
            lines.append(
                f"allowlist:{e.lineno}: [stale-allowlist] entry matched "
                f"no finding — delete it: {e.rule} {e.pattern}")
        lines.append(
            f"{len(self.findings)} finding(s), "
            f"{len(self.allowlisted)} allowlisted, "
            f"{len(self.stale)} stale allowlist entr(ies) "
            f"[{len(self.rules_run)} rules]")
        return "\n".join(lines)


def default_allowlist_path() -> str:
    return os.path.join(os.path.dirname(__file__), "allowlist.txt")


def run_rules(ctx: Context, allowlist: Allowlist,
              rules: list | None = None,
              paths: list | None = None) -> Report:
    """Run `rules` (default: all) over `ctx`.  `paths` is an optional
    list of globs over the finding's package-relative file: findings
    outside it are dropped BEFORE allowlist matching, and the stale-
    entry check is skipped (a filtered run cannot tell a stale entry
    from one whose findings were filtered out)."""
    import time as _time
    names = sorted(RULES) if rules is None else list(rules)
    findings, allowlisted = [], []
    timings = {}
    for name in names:
        rule = RULES[name]
        t0 = _time.perf_counter()
        rule.prepare(ctx)
        t1 = _time.perf_counter()
        if t1 - t0 >= 0.0005:  # model actually built (not a cache hit)
            timings["shared-models"] = timings.get(
                "shared-models", 0.0) + (t1 - t0)
        found = rule.run(ctx)
        timings[name] = _time.perf_counter() - t1
        for f in found:
            assert f.rule == name, (f.rule, name)
            if paths and not any(fnmatch.fnmatchcase(f.rel, p)
                                 for p in paths):
                continue
            e = allowlist.match(f) if rule.allowlistable else None
            if e is None:
                findings.append(f)
            else:
                allowlisted.append((f, e))
    # stale entries only meaningful for rules that actually ran, and
    # only when no path filter hid their findings
    ran = set(names)
    stale = ([] if paths
             else [e for e in allowlist.stale() if e.rule in ran])
    return Report(findings, allowlisted, stale, names, timings)


#: collected Contexts memoized per repo root — the migrated test-file
#: lints each call run_rule(), and re-parsing the whole package per call
#: would recreate the repeated-I/O pattern this engine replaced
_CTX_CACHE: dict = {}


def run_repo(repo_root=None, allowlist_path=None, rules=None) -> Report:
    """One-call entry: collect + all rules + default allowlist."""
    from . import rules as _rules  # noqa: F401 - registers the registry
    root = os.path.abspath(repo_root or default_repo_root())
    ctx = _CTX_CACHE.get(root)
    if ctx is None:
        ctx = _CTX_CACHE[root] = collect(root)
    al = Allowlist.load(allowlist_path or default_allowlist_path())
    return run_rules(ctx, al, rules)


def run_rule(name: str, repo_root=None, allowlist_path=None) -> list:
    """Unallowlisted findings of ONE rule over the repo (the tier-1 test
    entry point the migrated confinement lints call)."""
    return run_repo(repo_root, allowlist_path, rules=[name]).findings


def write_baseline(report: Report, path: str, reason="TODO: burn down"):
    """Append every current finding as an allowlist entry — the
    incremental-adoption path: freeze today's debt, fail only on NEW
    findings, then delete entries as fixes land."""
    with open(path, "a") as f:
        for fd in sorted(report.findings,
                         key=lambda fd: (fd.rule, fd.rel, fd.line)):
            f.write(f"{fd.rule} {fd.key} -- {reason}\n")
