"""errno / taxonomy consistency:

  * engine-owned error codes (>= 9000, the 9005-9010+ band the engine grew)
    must be UNIQUE across ErrCode constants and inline ``code = NNNN``
    class attributes — two errors sharing a code would be
    indistinguishable to tests and the wire protocol;
  * every code >= 9005 must be referenced by at least one error class
    (a reserved-but-orphaned code is a taxonomy hole);
  * every ``CLASS_*`` constant in utils/backoff.py must be RETURNED by
    ``classify`` (a class no error can ever get is dead taxonomy);
  * every ``Device*Error`` class in errors.py must appear inside
    ``classify`` (a device-path error the classifier does not know falls
    through to 'other' and skips its breaker/retry ladder).
"""

from __future__ import annotations

import ast

from ..engine import Rule, register

ERRORS_REL = "errors.py"
BACKOFF_REL = "utils/backoff.py"
ENGINE_CODE_MIN = 9000
REFERENCED_MIN = 9005


def _errcode_constants(errors_tree):
    """(name, value, lineno) of ErrCode integer class attributes."""
    out = []
    for node in ast.walk(errors_tree):
        if isinstance(node, ast.ClassDef) and node.name == "ErrCode":
            for stmt in node.body:
                if (isinstance(stmt, ast.Assign)
                        and isinstance(stmt.value, ast.Constant)
                        and isinstance(stmt.value.value, int)):
                    for tgt in stmt.targets:
                        if isinstance(tgt, ast.Name):
                            out.append((tgt.id, stmt.value.value,
                                        stmt.lineno))
    return out


def _inline_codes(sf):
    """(class_name, value, lineno) for ``code = <int>`` class attrs."""
    out = []
    for node in ast.walk(sf.tree):
        if not isinstance(node, ast.ClassDef):
            continue
        for stmt in node.body:
            if (isinstance(stmt, ast.Assign)
                    and isinstance(stmt.value, ast.Constant)
                    and isinstance(stmt.value.value, int)):
                for tgt in stmt.targets:
                    if isinstance(tgt, ast.Name) and tgt.id == "code":
                        out.append((node.name, stmt.value.value,
                                    stmt.lineno))
    return out


@register
class TaxonomyConsistency(Rule):
    name = "taxonomy-consistency"
    title = "errno uniqueness + backoff taxonomy completeness"

    def run(self, ctx):
        out = []
        errors_sf = ctx.file(ERRORS_REL)
        backoff_sf = ctx.file(BACKOFF_REL)
        if errors_sf is None or backoff_sf is None:
            return out  # fixture tree without the taxonomy spine

        # -- engine-code uniqueness across the whole package ----------------
        by_code: dict[int, list] = {}
        for name, val, line in _errcode_constants(errors_sf.tree):
            if val >= ENGINE_CODE_MIN:
                by_code.setdefault(val, []).append(
                    (errors_sf.rel, f"ErrCode.{name}", line))
        for sf in ctx.package_files:
            for cls, val, line in _inline_codes(sf):
                if val >= ENGINE_CODE_MIN:
                    by_code.setdefault(val, []).append(
                        (sf.rel, cls, line))
        referenced_names = set()
        for sf in ctx.package_files:
            for node in ast.walk(sf.tree):
                if (isinstance(node, ast.Attribute)
                        and isinstance(node.value, ast.Name)
                        and node.value.id == "ErrCode"):
                    referenced_names.add(node.attr)
        for val, owners in sorted(by_code.items()):
            # an ErrCode constant plus the ONE class that binds it via
            # ``code = ErrCode.X`` is the normal pairing; duplicates are
            # two *distinct* names/classes on one code
            distinct = {o[1] for o in owners}
            if len(distinct) > 1:
                rel, ident_owner, line = owners[0]
                out.append(self.finding(
                    rel, line, f"dup-code:{val}",
                    f"engine error code {val} bound by multiple owners: "
                    f"{sorted(distinct)}"))
        for name, val, line in _errcode_constants(errors_sf.tree):
            if val >= REFERENCED_MIN and name not in referenced_names:
                out.append(self.finding(
                    errors_sf.rel, line, f"orphan-code:{name}",
                    f"ErrCode.{name} ({val}) is reserved but no error "
                    "class or raise site references it"))

        # -- backoff CLASS_* completeness -----------------------------------
        classes, classify_fn = {}, None
        for node in backoff_sf.tree.body:
            if isinstance(node, ast.Assign):
                for tgt in node.targets:
                    if (isinstance(tgt, ast.Name)
                            and tgt.id.startswith("CLASS_")):
                        classes[tgt.id] = node.lineno
            if (isinstance(node, ast.FunctionDef)
                    and node.name == "classify"):
                classify_fn = node
        returned = set()
        classify_names = set()
        if classify_fn is not None:
            for node in ast.walk(classify_fn):
                if isinstance(node, ast.Return) and isinstance(
                        node.value, ast.Name):
                    returned.add(node.value.id)
                if isinstance(node, ast.Name):
                    classify_names.add(node.id)
        for cname, line in sorted(classes.items()):
            if cname not in returned:
                out.append(self.finding(
                    backoff_sf.rel, line, f"dead-class:{cname}",
                    f"taxonomy constant {cname} is never returned by "
                    "classify() — no error can ever carry it"))

        # -- Device*Error classes known to classify -------------------------
        for node in ast.walk(errors_sf.tree):
            if (isinstance(node, ast.ClassDef)
                    and node.name.startswith("Device")
                    and node.name.endswith("Error")
                    and node.name not in classify_names):
                out.append(self.finding(
                    errors_sf.rel, node.lineno,
                    f"unclassified:{node.name}",
                    f"{node.name} is not referenced by backoff.classify() "
                    "— it would fall through to 'other' and skip its "
                    "breaker/retry ladder"))
        return out
